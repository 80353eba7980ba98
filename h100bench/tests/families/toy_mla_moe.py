"""A toy family at test size, loaded through the same lookup as the
benchmark's own families (the tests put this directory first in
``families.DIRS``): DeepSeek-V3's block in miniature, to show that a
family with layers unlike each other is new files only.

- Latent attention with no query LoRA: the keys and values of all heads
  come up from one cached latent of ``kv_lora_rank`` values (RMS-normed)
  and one rotary key of ``qk_rope_head_dim`` shared by every head; each
  head's query and key are a non-rotary part and a rotary part.
- The first ``first_k_dense_replace`` layers have a dense SwiGLU MLP;
  the rest route each token to ``num_experts_per_tok`` of
  ``n_routed_experts`` experts by sigmoid scores plus a selection-only
  bias, weigh them by the chosen scores normalized to sum to 1 times
  ``routed_scaling_factor``, and add ``n_shared_experts`` shared
  experts that every token passes through.

The port has no such path: ``port_fields`` raises.
"""

from __future__ import annotations

import torch

from h100bench import families
from h100bench.reference import model

BF16 = 2
DECODE_KERNEL = "mla_decode_kernel"
moe = families.load("mixtral").moe


def shape(config: dict) -> dict:
    return {
        "family": config["model_type"],
        "vocab": int(config["vocab_size"]),
        "d": int(config["hidden_size"]),
        "layers": int(config["num_hidden_layers"]),
        "heads": int(config["num_attention_heads"]),
        "kv_rank": int(config["kv_lora_rank"]),
        "nope": int(config["qk_nope_head_dim"]),
        "rope": int(config["qk_rope_head_dim"]),
        "v_dim": int(config["v_head_dim"]),
        "d_ff": int(config["intermediate_size"]),
        "moe_ff": int(config["moe_intermediate_size"]),
        "experts": int(config["n_routed_experts"]),
        "top_k": int(config["num_experts_per_tok"]),
        "shared": int(config["n_shared_experts"]),
        "dense_layers": int(config["first_k_dense_replace"]),
        "route_scale": float(config["routed_scaling_factor"]),
        "rope_theta": float(config["rope_theta"]),
        "eps": float(config["rms_norm_eps"]),
        "max_context": int(config["max_position_embeddings"]),
        "dtype": config.get("torch_dtype", "bfloat16"),
    }


def port_fields(s: dict, config: dict) -> dict:
    raise NotImplementedError("the port has no latent-attention path")


def _dense(s: dict, layer: int) -> bool:
    return layer < s["dense_layers"]


def layer_leaves(s: dict, layer: int) -> list:
    d, h, r = s["d"], s["heads"], s["kv_rank"]
    qk, v = s["nope"] + s["rope"], s["v_dim"]
    leaves = [("attn_norm", (d,), False), ("wq", (d, h * qk), True),
              ("wkv_a", (d, r + s["rope"]), True), ("kv_norm", (r,), False),
              ("wkv_b", (r, h * (s["nope"] + v)), True),
              ("wo", (h * v, d), True), ("ffn_norm", (d,), False)]
    if _dense(s, layer):
        f = s["d_ff"]
        return leaves + [("w_gate", (d, f), True), ("w_up", (d, f), True),
                         ("w_down", (f, d), True)]
    e, f, sf = s["experts"], s["moe_ff"], s["shared"] * s["moe_ff"]
    return leaves + [
        ("w_router", (d, e), True), ("router_bias", (e,), True),
        ("w_gate", (e, d, f), True), ("w_up", (e, d, f), True),
        ("w_down", (e, f, d), True), ("shared_gate", (d, sf), True),
        ("shared_up", (d, sf), True), ("shared_down", (sf, d), True)]


def top_leaves(s: dict) -> list:
    d, v = s["d"], s["vocab"]
    return [("embed", (v, d), True), ("final_norm", (d,), False),
            ("lm_head", (d, v), True)]


def port_groups(s: dict) -> list:
    k = s["dense_layers"]
    return [("dense_blocks", list(range(k))),
            ("blocks", list(range(k, s["layers"])))]


def route(x, w_router, bias, top_k: int, scale: float):
    scores = torch.sigmoid(x @ w_router.float())
    idx = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    wts = scores.gather(1, idx)
    return idx, wts / wts.sum(-1, keepdim=True) * scale


class Layer:
    def __init__(self, s: dict, layer: int, w: dict, precision: str):
        self.s, self.precision = s, precision
        self.attn_norm, self.kv_norm = w["attn_norm"], w["kv_norm"]
        self.ffn_norm = w["ffn_norm"]
        self.wq, self.wkv_a, self.wkv_b, self.wo = (
            model.Linear(w[n], precision)
            for n in ("wq", "wkv_a", "wkv_b", "wo"))
        lin = lambda n: model.Linear(w[n], precision)  # noqa: E731
        if _dense(s, layer):
            self.mlp = (lin("w_gate"), lin("w_up"), lin("w_down"))
            self.experts = None
            return
        self.w_router, self.bias = w["w_router"], w["router_bias"]
        self.experts = [tuple(model.Linear(w[n][e], precision)
                              for n in ("w_gate", "w_up", "w_down"))
                        for e in range(s["experts"])]
        self.mlp = (lin("shared_gate"), lin("shared_up"), lin("shared_down"))

    def ffn(self, x):
        out = model.swiglu(x, *self.mlp)
        if self.experts is None:
            return out
        s = self.s
        idx, wts = route(x, self.w_router, self.bias, s["top_k"],
                         s["route_scale"])
        return out + moe(x, idx, wts, self.experts)

    def __call__(self, x):
        s = self.s
        t, h, nope, rp = x.shape[0], s["heads"], s["nope"], s["rope"]
        a_in = model.rms_norm(x, self.attn_norm, s["eps"])
        q = self.wq(a_in).view(t, h, nope + rp)
        q = torch.cat([q[..., :nope],
                       model.rope(q[..., nope:], s["rope_theta"])], -1)
        kv_a = self.wkv_a(a_in)
        latent = model.rms_norm(kv_a[:, :s["kv_rank"]], self.kv_norm,
                                s["eps"])
        k_rope = model.rope(kv_a[:, None, s["kv_rank"]:], s["rope_theta"])
        kv = self.wkv_b(latent).view(t, h, nope + s["v_dim"])
        k = torch.cat([kv[..., :nope], k_rope.expand(t, h, rp)], -1)
        a = model.attention(q, k, kv[..., nope:], 0).reshape(t, -1)
        x = model.residual(x + self.wo(a), self.precision)
        return model.residual(
            x + self.ffn(model.rms_norm(x, self.ffn_norm, s["eps"])),
            self.precision)


def reference_layer(s: dict, layer: int, w: dict, precision: str):
    return Layer(s, layer, w, precision)


def costs(s: dict) -> list:
    """Per layer: the projections, QK^T over nope + rope and PV over
    v_dim for every head, one cached latent and rotary key a token; the
    dense MLP, or the router, top-k and shared experts."""
    d, h, r = s["d"], s["heads"], s["kv_rank"]
    qk, v = s["nope"] + s["rope"], s["v_dim"]
    attn = (d * h * qk + d * (r + s["rope"]) + r * h * (s["nope"] + v)
            + h * v * d)
    out = []
    for layer in range(s["layers"]):
        ffn = (3 * d * s["d_ff"] if _dense(s, layer) else
               3 * d * s["moe_ff"] * (s["top_k"] + s["shared"])
               + d * s["experts"])
        out.append({"matmul_params": attn + ffn,
                    "pair_flops": 2 * h * qk + 2 * h * v,
                    "kv_bytes": BF16 * (r + s["rope"]), "window": 0,
                    "qo_bytes": BF16 * h * (qk + v)})
    return out
