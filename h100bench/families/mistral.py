"""Mistral-7B (``model_type`` "mistral"): the Llama block with a sliding
window, served by the port's llama path.

Written from the published description (``config.json`` and the
Mistral paper, arXiv:2310.06825): RMSNorm before each sublayer,
grouped-query attention with rotary embeddings and a causal mask in
which a query sees itself and the ``sliding_window - 1`` positions
before it (every earlier position where the key is null), and the
SwiGLU MLP. ``mixtral.py`` keeps the attention and swaps the MLP.
"""

from __future__ import annotations

from h100bench.reference import model

BF16 = 2
DECODE_KERNEL = "paged_decode_kernel"


def shape(config: dict) -> dict:
    heads = int(config["num_attention_heads"])
    d = int(config["hidden_size"])
    return {
        "family": config["model_type"],
        "vocab": int(config["vocab_size"]),
        "d": d,
        "layers": int(config["num_hidden_layers"]),
        "heads": heads,
        "kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config.get("head_dim") or d // heads),
        "d_ff": int(config["intermediate_size"]),
        "window": int(config.get("sliding_window") or 0),
        "rope_theta": float(config["rope_theta"]),
        "eps": float(config["rms_norm_eps"]),
        "max_context": int(config["max_position_embeddings"]),
        "dtype": config.get("torch_dtype", "bfloat16"),
    }


def port_fields(s: dict, config: dict) -> dict:
    return {"family": "llama", "vocab_size": s["vocab"], "d_model": s["d"],
            "n_layers": s["layers"], "n_heads": s["heads"],
            "n_kv_heads": s["kv_heads"], "d_ff": s["d_ff"],
            "max_seq_len": s["max_context"], "rope_theta": s["rope_theta"],
            "norm_eps": s["eps"], "sliding_window": s["window"]}


def attn_leaves(s: dict) -> list:
    d, hd = s["d"], s["head_dim"]
    q, kv = s["heads"] * hd, s["kv_heads"] * hd
    return [("attn_norm", (d,), False), ("wq", (d, q), True),
            ("wk", (d, kv), True), ("wv", (d, kv), True),
            ("wo", (q, d), True), ("ffn_norm", (d,), False)]


def layer_leaves(s: dict, layer: int) -> list:
    d, f = s["d"], s["d_ff"]
    return attn_leaves(s) + [("w_gate", (d, f), True),
                             ("w_up", (d, f), True),
                             ("w_down", (f, d), True)]


def top_leaves(s: dict) -> list:
    d, v = s["d"], s["vocab"]
    return [("embed", (v, d), True), ("final_norm", (d,), False),
            ("lm_head", (d, v), True)]


def port_groups(s: dict) -> list:
    """models/llama.py's tree: every layer under ``blocks``."""
    return [("blocks", list(range(s["layers"])))]


class Layer:
    """One decoder layer in float32 (or rounded to ``precision``); a
    subclass gives ``ffn``."""

    def __init__(self, s: dict, w: dict, precision: str):
        self.s, self.precision = s, precision
        self.attn_norm, self.ffn_norm = w["attn_norm"], w["ffn_norm"]
        self.wq, self.wk, self.wv, self.wo = (
            model.Linear(w[n], precision) for n in ("wq", "wk", "wv", "wo"))
        self.init_ffn(w)

    def init_ffn(self, w: dict) -> None:
        self.mlp = tuple(model.Linear(w[n], self.precision)
                         for n in ("w_gate", "w_up", "w_down"))

    def ffn(self, x):
        return model.swiglu(x, *self.mlp)

    def __call__(self, x):
        s = self.s
        t, hd = x.shape[0], s["head_dim"]
        h = model.rms_norm(x, self.attn_norm, s["eps"])
        q = model.rope(self.wq(h).view(t, s["heads"], hd), s["rope_theta"])
        k = model.rope(self.wk(h).view(t, s["kv_heads"], hd),
                       s["rope_theta"])
        v = self.wv(h).view(t, s["kv_heads"], hd)
        a = model.attention(q, k, v, s["window"]).reshape(t, -1)
        x = model.residual(x + self.wo(a), self.precision)
        return model.residual(
            x + self.ffn(model.rms_norm(x, self.ffn_norm, s["eps"])),
            self.precision)


def reference_layer(s: dict, layer: int, w: dict, precision: str):
    return Layer(s, w, precision)


def attn_costs(s: dict) -> dict:
    """The attention's share of one layer's costs: the four projections,
    QK^T and PV over every head, each cached key and value in bf16."""
    d, hd = s["d"], s["head_dim"]
    return {"matmul_params": d * s["heads"] * hd * 2
            + d * s["kv_heads"] * hd * 2,
            "pair_flops": 4 * s["heads"] * hd,
            "kv_bytes": BF16 * 2 * s["kv_heads"] * hd,
            "window": s["window"],
            "qo_bytes": BF16 * 2 * s["heads"] * hd}


def costs(s: dict) -> list:
    c = attn_costs(s)
    c["matmul_params"] += 3 * s["d"] * s["d_ff"]
    return [c] * s["layers"]
