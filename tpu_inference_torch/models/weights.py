"""Parameter transport into the port: numpy trees, HF state dicts and
local HF safetensors checkpoints.

Twin of ``tpu_inference/models/weights.py``:

- ``params_from_numpy`` takes the reference package's parameter tree as
  nested dicts of numpy arrays (blocks stacked ``[L, ...]``, matrices
  ``[in, out]``) and returns the port's parameter dict on ``device``.
  Float leaves take ``cfg.dtype``; a quantized leaf (any object with
  ``q`` and ``scale`` arrays, as the reference's ``QuantizedArray`` is)
  becomes a port ``QuantizedArray`` with its codes in their own integer
  dtype and float32 scales. The caller produces the tree; this module
  never touches the reference package.
- ``convert_state_dict(cfg, sd)``: an HF state dict (torch tensors or
  numpy arrays, HF names) -> the same tree. HF linear weights are
  ``[out, in]`` and are transposed; GPT-2's Conv1D weights are already
  ``[in, out]`` and are not.
- ``config_from_hf(path)``: a ModelConfig from a checkpoint directory's
  ``config.json`` (llama, mistral, qwen2, gemma, phi3, mixtral, gpt2).
- ``load_checkpoint(cfg, path, quant, device)``: stream a safetensors
  directory (``model.safetensors.index.json`` or single files) onto the
  card. Every leaf is described by a plan (which HF tensors it stacks,
  whether they transpose, an optional row range of a fused tensor) and
  filled one ``[in, out]`` slab at a time from memory-mapped files:
  host memory holds one slab, device memory the model plus one slab.
  With ``quant`` each matmul slab is quantized as it lands; with
  ``mesh`` (tp > 1) each slab is cut and copied onto every tp shard.
- ``save_native(params, path)`` / ``load_native(path, template)``: the
  restart-after-failure tier, the twin of the reference's Orbax pair. A
  params tree (quantized leaves included, or a tp ``ShardedParams``
  saved whole) goes to ``path/params.safetensors`` as stored, and comes
  back into a template's structure and placement: onto one device, or
  cut straight into a tp layout. The reference's own Orbax directories
  are not read.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Any, Dict

import numpy as np
import torch

from tpu_inference_torch.config import ModelConfig, RopeScaling
from tpu_inference_torch.models.quant import (QUANT_KEYS, QuantizedArray,
                                              quantize_array, quantize_slabs)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors (copies)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            codes = np.asarray(node.q)
            if codes.dtype not in (np.int8, np.uint8):
                raise TypeError(f"quantized leaf with {codes.dtype} codes; "
                                "expected int8 or uint8")
            scale = np.asarray(node.scale, dtype=np.float32)
            return QuantizedArray(
                torch.from_numpy(codes.copy()).to(device),
                torch.from_numpy(scale.copy()).to(device))
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=device, dtype=cfg.dtype)

    return conv(tree)


# ---------------------------------------------------------------------------
# HF state dict -> parameter tree
# ---------------------------------------------------------------------------

def _np(x: Any) -> np.ndarray:
    """torch tensor (bf16 included) | numpy array -> numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _stack(sd: Dict[str, Any], fmt: str, n_layers: int,
           transpose: bool = False) -> np.ndarray:
    mats = [_np(sd[fmt.format(i)]) for i in range(n_layers)]
    return np.stack([m.T for m in mats] if transpose else mats)


# Phi-3 stores q/k/v (and gate/up) fused along the out dim; the serving
# layout keeps them split. One span definition feeds the converter and
# the streaming planner, so they split at the same rows.
_FUSED_QKV_KEY = "self_attn.qkv_proj.weight"
_FUSED_GATE_UP_KEY = "mlp.gate_up_proj.weight"


def _fused_qkv_spans(cfg: ModelConfig) -> tuple:
    """(q_end, k_end, v_end) row offsets inside the fused qkv tensor."""
    q_end = cfg.n_heads * cfg.head_dim
    k_end = q_end + cfg.n_kv_heads * cfg.head_dim
    return q_end, k_end, k_end + cfg.n_kv_heads * cfg.head_dim


def convert_llama(cfg: ModelConfig, sd: Dict[str, Any]) -> dict:
    L = cfg.n_layers
    p = "model.layers.{}."
    if p.format(0) + _FUSED_QKV_KEY in sd:
        f = cfg.d_ff
        q_end, k_end, _ = _fused_qkv_spans(cfg)
        qkv = _stack(sd, p + _FUSED_QKV_KEY, L, transpose=True)
        gu = _stack(sd, p + _FUSED_GATE_UP_KEY, L, transpose=True)
        attn_ffn = {
            "wq": qkv[..., :q_end], "wk": qkv[..., q_end:k_end],
            "wv": qkv[..., k_end:],
            "w_gate": gu[..., :f], "w_up": gu[..., f:],
        }
    else:
        attn_ffn = {
            "wq": _stack(sd, p + "self_attn.q_proj.weight", L, True),
            "wk": _stack(sd, p + "self_attn.k_proj.weight", L, True),
            "wv": _stack(sd, p + "self_attn.v_proj.weight", L, True),
            "w_gate": _stack(sd, p + "mlp.gate_proj.weight", L, True),
            "w_up": _stack(sd, p + "mlp.up_proj.weight", L, True),
        }
    params = {
        "embed": _np(sd["model.embed_tokens.weight"]),
        "blocks": {
            "attn_norm": _stack(sd, p + "input_layernorm.weight", L),
            "wo": _stack(sd, p + "self_attn.o_proj.weight", L, True),
            "ffn_norm": _stack(sd, p + "post_attention_layernorm.weight", L),
            "w_down": _stack(sd, p + "mlp.down_proj.weight", L, True),
            **attn_ffn,
        },
        "final_norm": _np(sd["model.norm.weight"]),
    }
    if cfg.qkv_bias:
        for b, w in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            params["blocks"][b] = _stack(sd, p + f"self_attn.{w}_proj.bias",
                                         L)
    if not cfg.tie_embeddings:
        head = sd.get("lm_head.weight", sd["model.embed_tokens.weight"])
        params["lm_head"] = _np(head).T
    return params


def _gpt2_prefix(keys) -> str:
    """HF prefixes GPT2LMHeadModel's keys with "transformer."."""
    return ("transformer." if any(k.startswith("transformer.") for k in keys)
            else "")


# GPT-2 leaf -> HF name: per layer under "h.{i}." (GPT2_BLOCK_KEYS), the
# others at the top (GPT2_TOP_KEYS). Conv1D weights are [in, out] already.
GPT2_BLOCK_KEYS = {
    "ln1_w": "ln_1.weight", "ln1_b": "ln_1.bias",
    "w_qkv": "attn.c_attn.weight", "b_qkv": "attn.c_attn.bias",
    "w_proj": "attn.c_proj.weight", "b_proj": "attn.c_proj.bias",
    "ln2_w": "ln_2.weight", "ln2_b": "ln_2.bias",
    "w_fc": "mlp.c_fc.weight", "b_fc": "mlp.c_fc.bias",
    "w_out": "mlp.c_proj.weight", "b_out": "mlp.c_proj.bias",
}
GPT2_TOP_KEYS = {"embed": "wte.weight", "pos_embed": "wpe.weight",
                 "ln_f_w": "ln_f.weight", "ln_f_b": "ln_f.bias"}


def convert_gpt2(cfg: ModelConfig, sd: Dict[str, Any]) -> dict:
    pre = _gpt2_prefix(sd)
    out = {k: _np(sd[pre + v]) for k, v in GPT2_TOP_KEYS.items()}
    out["blocks"] = {k: _stack(sd, pre + "h.{}." + v, cfg.n_layers)
                     for k, v in GPT2_BLOCK_KEYS.items()}
    return out


# HF Mixtral experts: w1 = gate, w3 = up, w2 = down.
_MIXTRAL_EXPERTS = {"w_gate": "w1", "w_up": "w3", "w_down": "w2"}


def _expert_key(i: int, e: int, w: str) -> str:
    return f"model.layers.{i}.block_sparse_moe.experts.{e}.{w}.weight"


def convert_mixtral(cfg: ModelConfig, sd: Dict[str, Any]) -> dict:
    L, E = cfg.n_layers, cfg.n_experts
    p = "model.layers.{}."
    blocks = {
        "attn_norm": _stack(sd, p + "input_layernorm.weight", L),
        "wq": _stack(sd, p + "self_attn.q_proj.weight", L, True),
        "wk": _stack(sd, p + "self_attn.k_proj.weight", L, True),
        "wv": _stack(sd, p + "self_attn.v_proj.weight", L, True),
        "wo": _stack(sd, p + "self_attn.o_proj.weight", L, True),
        "ffn_norm": _stack(sd, p + "post_attention_layernorm.weight", L),
        "w_router": _stack(sd, p + "block_sparse_moe.gate.weight", L, True),
    }
    for name, w in _MIXTRAL_EXPERTS.items():
        blocks[name] = np.stack([
            np.stack([_np(sd[_expert_key(i, e, w)]).T for e in range(E)])
            for i in range(L)])                             # [L, E, in, out]
    return {"embed": _np(sd["model.embed_tokens.weight"]), "blocks": blocks,
            "final_norm": _np(sd["model.norm.weight"]),
            "lm_head": _np(sd["lm_head.weight"]).T}


_CONVERTERS = {"llama": convert_llama, "gpt2": convert_gpt2,
               "mixtral": convert_mixtral}


def convert_state_dict(cfg: ModelConfig, sd: Dict[str, Any],
                       device="cuda") -> dict:
    """HF state dict -> the port's parameter dict on ``device`` in
    ``cfg.dtype``."""
    return params_from_numpy(_CONVERTERS[cfg.family](cfg, sd), cfg, device)


# ---------------------------------------------------------------------------
# config.json -> ModelConfig
# ---------------------------------------------------------------------------

def config_from_hf(path: str) -> ModelConfig:
    """A ModelConfig from a HF checkpoint directory's config.json: the
    architecture comes from the checkpoint, not from a preset. Supports
    llama, mistral, qwen2, gemma, phi3 (the llama module), mixtral and
    gpt2; raises ValueError on anything it would serve wrongly."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "llama")
    name = os.path.basename(os.path.normpath(path))
    torch_dtype = hf.get("torch_dtype", "bfloat16")
    dtype = torch.float32 if torch_dtype == "float32" else torch.bfloat16
    if torch_dtype not in ("bfloat16", "float32"):
        print(f"[config_from_hf] {name}: torch_dtype={torch_dtype!r} served "
              "as bfloat16 (fp16 loses 2 mantissa bits; pass an explicit "
              "ModelConfig with dtype=float32 for a lossless load)",
              file=sys.stderr)
    if model_type == "gpt2":
        d = hf["n_embd"]
        return ModelConfig(
            name=name, family="gpt2", vocab_size=hf["vocab_size"],
            d_model=d, n_layers=hf["n_layer"], n_heads=hf["n_head"],
            n_kv_heads=hf["n_head"], d_ff=hf.get("n_inner") or 4 * d,
            max_seq_len=hf.get("n_positions", 1024),
            norm_eps=hf.get("layer_norm_epsilon", 1e-5),
            use_learned_pos=True, use_bias=True, tie_embeddings=True,
            dtype=dtype)
    if model_type not in ("llama", "mixtral", "mistral", "qwen2", "gemma",
                          "phi3"):
        raise ValueError(f"unsupported model_type {model_type!r} in "
                         f"{path}/config.json")
    if model_type == "phi3" and hf.get("rope_scaling"):
        # Long-context Phi-3 (LongRoPE) switches between two rescaled
        # frequency tables by context length: not served.
        raise ValueError(
            f"phi3 checkpoint {name!r} uses rope_scaling="
            f"{hf['rope_scaling'].get('type', hf['rope_scaling'])!r} "
            "(LongRoPE); only rope_scaling: null Phi-3 checkpoints (4k "
            "context) are supported")
    heads = hf["num_attention_heads"]
    gemma = model_type == "gemma"
    # Llama-3.1's "llama3" rescale is parsed; other schemes (yarn,
    # linear, dynamic) would serve a different model and raise.
    rope_scaling = None
    rs = hf.get("rope_scaling")
    if rs:
        kind = rs.get("rope_type", rs.get("type", "default"))
        if kind == "llama3":
            rope_scaling = RopeScaling(
                factor=float(rs["factor"]),
                low_freq_factor=float(rs["low_freq_factor"]),
                high_freq_factor=float(rs["high_freq_factor"]),
                original_max_len=int(rs["original_max_position_embeddings"]))
        elif kind != "default":
            raise ValueError(
                f"checkpoint {name!r} uses rope_scaling type {kind!r}; "
                "only 'llama3' (and null/'default') are supported")
    # Mistral and Phi-3 window every layer; Qwen2 only behind
    # use_sliding_window, and then only layers >= max_window_layers (HF's
    # default for an absent key is 28): the engine's window is global, so
    # only the all-or-nothing cases map.
    window = 0
    if model_type in ("mistral", "phi3"):
        window = int(hf.get("sliding_window") or 0)
    elif model_type == "qwen2" and hf.get("use_sliding_window"):
        window = int(hf.get("sliding_window") or 0)
        mwl = hf.get("max_window_layers")
        mwl = 28 if mwl is None else int(mwl)
        if mwl >= int(hf["num_hidden_layers"]):
            window = 0
        elif mwl != 0 and window:
            raise ValueError(
                f"qwen2 checkpoint {name!r} uses per-layer sliding window "
                f"(max_window_layers={mwl} of {hf['num_hidden_layers']}); "
                "mixed full/SWA layers are unsupported - set "
                "use_sliding_window=false to serve with full attention")
    return ModelConfig(
        name=name, family="mixtral" if model_type == "mixtral" else "llama",
        vocab_size=hf["vocab_size"], d_model=hf["hidden_size"],
        n_layers=hf["num_hidden_layers"], n_heads=heads,
        n_kv_heads=hf.get("num_key_value_heads", heads),
        d_ff=hf["intermediate_size"],
        max_seq_len=hf.get("max_position_embeddings", 8192),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_scaling=rope_scaling,
        norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_embeddings=bool(hf.get("tie_word_embeddings", gemma)),
        n_experts=hf.get("num_local_experts", 0),
        n_experts_per_tok=hf.get("num_experts_per_tok", 2),
        sliding_window=window,
        qkv_bias=model_type == "qwen2",
        norm_offset=1.0 if gemma else 0.0,
        hidden_act="gelu_tanh" if gemma else "silu",
        embed_scale=gemma,
        head_dim_override=int(hf.get("head_dim") or 0),
        dtype=dtype)


# ---------------------------------------------------------------------------
# Streaming safetensors loader
# ---------------------------------------------------------------------------


class _CheckpointFiles:
    """Key -> memory-mapped safetensors file over a HF directory."""

    def __init__(self, path: str):
        from safetensors import safe_open

        self._safe_open = safe_open
        self.path = path
        self._handles: Dict[str, Any] = {}
        self.key_to_file: Dict[str, str] = {}
        index_path = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_path):
            with open(index_path) as f:
                self.key_to_file = json.load(f)["weight_map"]
        else:
            for fname in sorted(os.listdir(path)):
                if fname.endswith(".safetensors"):
                    for k in self._open(fname).keys():
                        self.key_to_file[k] = fname

    def _open(self, fname: str):
        h = self._handles.get(fname)
        if h is None:
            h = self._safe_open(os.path.join(self.path, fname),
                                framework="pt")
            self._handles[fname] = h
        return h

    def keys(self):
        return self.key_to_file.keys()

    def get_slice(self, key: str):
        return self._open(self.key_to_file[key]).get_slice(key)


# A leaf plan is (keys, transpose[, rows]): ``keys`` is one HF tensor
# name or a (nested) list of names stacked along leading axes (layers,
# then experts); ``transpose`` turns HF's [out, in] into [in, out];
# ``rows = (start, stop)`` restricts the leaf to a row range of the HF
# tensor (dim 0 before the transpose): Phi-3's fused tensors split
# without the fused tensor ever being read whole.


def _plan_llama(cfg: ModelConfig, have) -> dict:
    p = "model.layers.{}."

    def lk(s):
        return [p.format(i) + s for i in range(cfg.n_layers)]

    if p.format(0) + _FUSED_QKV_KEY in have:
        f = cfg.d_ff
        q_end, k_end, v_end = _fused_qkv_spans(cfg)
        qkv, gu = lk(_FUSED_QKV_KEY), lk(_FUSED_GATE_UP_KEY)
        attn_ffn = {
            "wq": (qkv, True, (0, q_end)),
            "wk": (qkv, True, (q_end, k_end)),
            "wv": (qkv, True, (k_end, v_end)),
            "w_gate": (gu, True, (0, f)),
            "w_up": (gu, True, (f, 2 * f)),
        }
    else:
        attn_ffn = {
            "wq": (lk("self_attn.q_proj.weight"), True),
            "wk": (lk("self_attn.k_proj.weight"), True),
            "wv": (lk("self_attn.v_proj.weight"), True),
            "w_gate": (lk("mlp.gate_proj.weight"), True),
            "w_up": (lk("mlp.up_proj.weight"), True),
        }
    plan = {
        "embed": ("model.embed_tokens.weight", False),
        "blocks": {
            "attn_norm": (lk("input_layernorm.weight"), False),
            "wo": (lk("self_attn.o_proj.weight"), True),
            "ffn_norm": (lk("post_attention_layernorm.weight"), False),
            "w_down": (lk("mlp.down_proj.weight"), True),
            **attn_ffn,
        },
        "final_norm": ("model.norm.weight", False),
    }
    if cfg.qkv_bias:
        for b, w in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            plan["blocks"][b] = (lk(f"self_attn.{w}_proj.bias"), False)
    if not cfg.tie_embeddings:
        head = ("lm_head.weight" if "lm_head.weight" in have
                else "model.embed_tokens.weight")
        plan["lm_head"] = (head, True)
    return plan


def _plan_gpt2(cfg: ModelConfig, have) -> dict:
    pre = _gpt2_prefix(have)
    plan = {k: (pre + v, False) for k, v in GPT2_TOP_KEYS.items()}
    plan["blocks"] = {
        k: ([f"{pre}h.{i}.{v}" for i in range(cfg.n_layers)], False)
        for k, v in GPT2_BLOCK_KEYS.items()}
    return plan


def _plan_mixtral(cfg: ModelConfig, have) -> dict:
    p = "model.layers.{}."

    def lk(s):
        return [p.format(i) + s for i in range(cfg.n_layers)]

    blocks = {
        "attn_norm": (lk("input_layernorm.weight"), False),
        "wq": (lk("self_attn.q_proj.weight"), True),
        "wk": (lk("self_attn.k_proj.weight"), True),
        "wv": (lk("self_attn.v_proj.weight"), True),
        "wo": (lk("self_attn.o_proj.weight"), True),
        "ffn_norm": (lk("post_attention_layernorm.weight"), False),
        "w_router": (lk("block_sparse_moe.gate.weight"), True),
    }
    for name, w in _MIXTRAL_EXPERTS.items():
        blocks[name] = ([[_expert_key(i, e, w) for e in range(cfg.n_experts)]
                         for i in range(cfg.n_layers)], True)
    return {"embed": ("model.embed_tokens.weight", False), "blocks": blocks,
            "final_norm": ("model.norm.weight", False),
            "lm_head": ("lm_head.weight", True)}


_PLANNERS = {"llama": _plan_llama, "gpt2": _plan_gpt2,
             "mixtral": _plan_mixtral}


def _flatten(keys) -> tuple:
    """(leading stack dims, HF names in row-major order over them)."""
    if not isinstance(keys, list):
        return (), [keys]
    lead, names = (), []
    for k in keys:
        lead, sub = _flatten(k)
        names += sub
    return (len(keys),) + lead, names


def load_checkpoint(cfg: ModelConfig, path: str, quant: str = "none",
                    device="cuda", mesh=None):
    """Load a HF safetensors directory into the port's parameter dict on
    ``device`` in ``cfg.dtype``. Each leaf fills one HF tensor (one
    ``[in, out]`` slab after the transpose) at a time; with ``quant``
    "int8"/"int4" every QUANT_KEYS leaf is quantized slab by slab as it
    lands, so a model that only fits quantized loads without its
    full-precision copy ever existing. The result equals
    ``convert_state_dict`` of the same tensors (then ``quantize_params``
    with ``quant``).

    With ``mesh`` (parallel/mesh.py, tp > 1) each slab is cut along
    parallel/shardings.py's specs as it lands and each piece copied onto
    its shard's device (the twin of the reference's ``shardings=``): a
    ShardedParams equal to ``shard_params`` of the unsharded load, with
    no unsharded copy of the model on any device. A quantized slab is
    quantized whole, then cut (an int8 scale reduces over the whole
    contraction dim). ``device`` is then unused."""
    files = _CheckpointFiles(path)
    plan = _PLANNERS[cfg.family](cfg, set(files.keys()))
    if mesh is not None and mesh.shape["tp"] > 1:
        return _load_sharded(cfg, files, plan, quant, mesh)

    def slab(key: str, transpose: bool, rows) -> torch.Tensor:
        sl = files.get_slice(key)
        t = sl[rows[0]:rows[1]] if rows is not None else sl[:]
        t = t.to(device=device, dtype=cfg.dtype)
        return t.t() if transpose else t

    def build(name: str, leaf_plan: tuple):
        keys, transpose, *rest = leaf_plan
        rows = rest[0] if rest else None
        lead, names = _flatten(keys)
        slabs = (slab(k, transpose, rows) for k in names)
        if quant != "none" and name in QUANT_KEYS:
            if lead:
                return quantize_slabs(lead, slabs, quant)
            return quantize_slabs((1,), slabs, quant)[0]
        first = next(slabs)
        out = torch.empty((math.prod(lead), *first.shape), dtype=cfg.dtype,
                          device=device)
        out[0].copy_(first)
        for i, t in enumerate(slabs, start=1):
            out[i].copy_(t)
        return out.reshape(*lead, *first.shape)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else build(k, v)
                for k, v in tree.items()}

    return walk(plan)


def _load_sharded(cfg: ModelConfig, files: _CheckpointFiles, plan: dict,
                  quant: str, mesh):
    """load_checkpoint's mesh path: every slab read once, onto the first
    shard's device, (quantized,) cut and copied into each shard's
    preallocated leaf."""
    from tpu_inference_torch.parallel import shardings as shd

    shd.validate_tp(cfg, mesh.shape["tp"])
    devices = mesh.tp_devices()
    n = len(devices)
    home = devices[0]

    def build(name: str, leaf_plan: tuple, spec):
        keys, transpose, *rest = leaf_plan
        rows = rest[0] if rest else None
        lead, names = _flatten(keys)
        nl = len(lead)
        lead_dim = shd.shard_dim(spec)
        if lead_dim is not None and lead_dim >= nl:
            lead_dim = None                  # split inside each slab
        quantized = quant != "none" and name in QUANT_KEYS
        outs, sharding = [None] * n, None
        for i, key in enumerate(names):
            sl = files.get_slice(key)
            t = sl[rows[0]:rows[1]] if rows is not None else sl[:]
            t = t.to(device=home, dtype=cfg.dtype)
            t = t.t() if transpose else t
            part = quantize_array(t, quant) if quantized else t
            if sharding is None:
                skeleton = (QuantizedArray(
                    torch.empty(lead + tuple(part.q.shape), device="meta"),
                    torch.empty(lead + tuple(part.scale.shape),
                                device="meta"))
                            if quantized else
                            torch.empty(lead + tuple(t.shape), device="meta"))
                sharding = shd.leaf_sharding(spec, skeleton, mesh)
            idx = list(np.unravel_index(i, lead)) if lead else []
            for j in range(n):
                at = idx
                if lead_dim is not None:
                    per = lead[lead_dim] // n
                    if idx[lead_dim] // per != j:
                        continue
                    at = idx[:lead_dim] + [idx[lead_dim] % per] \
                        + idx[lead_dim + 1:]
                pieces = ([(part.q, sharding.q.spec),
                           (part.scale, sharding.scale.spec)] if quantized
                          else [(part, sharding.spec)])
                cut = [shd.narrow(x, shd.P(*sp[nl:], packed=sp.packed), j, n)
                       for x, sp in pieces]
                if outs[j] is None:
                    local = [lead[d] // n if d == lead_dim else lead[d]
                             for d in range(nl)]
                    outs[j] = [torch.empty(local + list(c.shape),
                                           dtype=c.dtype, device=devices[j])
                               for c in cut]
                for buf, c in zip(outs[j], cut):
                    buf[tuple(at)].copy_(c)
        leaves = [QuantizedArray(*o) if quantized else o[0]
                  for o in outs]
        return leaves, sharding

    specs = shd.param_specs(cfg)
    shards = [{} for _ in range(n)]
    shardings = {}

    def walk(tree, spec_tree, outs, sh_out):
        for k, v in tree.items():
            if isinstance(v, dict):
                sub = [o.setdefault(k, {}) for o in outs]
                walk(v, spec_tree[k], sub, sh_out.setdefault(k, {}))
            else:
                leaves, sh_out[k] = build(k, v, spec_tree[k])
                for o, leaf in zip(outs, leaves):
                    o[k] = leaf

    walk(plan, specs, shards, shardings)
    return shd.ShardedParams(shards, shardings)


# ---------------------------------------------------------------------------
# Native checkpoint tier (save_native / load_native)
# ---------------------------------------------------------------------------
#
# One safetensors file: each tensor under its path in the tree
# ("blocks/wq"; a quantized leaf as "blocks/wq.q" and "blocks/wq.scale"),
# and in the header's metadata the tree itself: every leaf's path, node
# kind, dtypes and shapes, and for a quantized leaf its scale groups
# (more than one: grouped int4, codes nibble-packed; all ``dequantize``
# needs). safetensors rather than ``torch.save``: no pickle, a header any
# tool reads, and safe_open's memory-mapped slices read one slab of a
# leaf without the rest of the file. The writer is this module's own, so
# each slab streams from its device to the file: host memory holds one
# slab, as on load.

NATIVE_FILE = "params.safetensors"
NATIVE_FORMAT = "tpu_inference_torch.native/1"

_ST_DTYPES = {torch.float32: "F32", torch.bfloat16: "BF16",
              torch.float16: "F16", torch.float64: "F64",
              torch.int8: "I8", torch.uint8: "U8", torch.int16: "I16",
              torch.int32: "I32", torch.int64: "I64", torch.bool: "BOOL"}


def _tree_leaves(tree: dict, prefix: str = "") -> list:
    """(path, node) of every leaf (a tensor, a QuantizedArray or a
    NamedSharding), in the tree's order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _tree_leaves(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def _tree_rebuild(tree: dict, values: dict, prefix: str = "") -> dict:
    """``tree``'s structure with the leaf at each path from ``values``."""
    return {k: (_tree_rebuild(v, values, f"{prefix}{k}/")
                if isinstance(v, dict) else values[prefix + k])
            for k, v in tree.items()}


def _fields(node) -> tuple:
    """The tensors of a leaf: a QuantizedArray's codes and scale, or the
    tensor itself (field None)."""
    return ("q", "scale") if isinstance(node, QuantizedArray) else (None,)


def _field(node, field):
    return getattr(node, field) if field else node


def _key(path: str, field) -> str:
    return f"{path}.{field}" if field else path


def _by_slab(path: str, spec) -> bool:
    """Leaves under "blocks" stack their layers along dim 0 and move a
    layer (one slab) at a time; a top-level leaf is one slab."""
    from tpu_inference_torch.parallel import shardings as shd
    return path.startswith("blocks/") and shd.shard_dim(spec) != 0


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save_native(params, path: str) -> None:
    """Write a params tree to ``path/params.safetensors`` (the directory
    is made; the file is written beside it and renamed over it once
    whole, so a crash mid-save leaves the previous checkpoint).

    ``params`` is a params dict (tensors and QuantizedArray nodes) or a
    tp ``ShardedParams``, which is saved in the full-head layout: each
    sharded leaf put back together from its shards, a replicated one
    written once, so any tp restores it. Bytes are written as stored: no
    float leaf goes through another dtype, codes stay codes. Each slab (a
    layer of a stacked leaf, or a top-level leaf) is copied to the host,
    written and dropped before the next."""
    from tpu_inference_torch.parallel import shardings as shd

    if isinstance(params, shd.ShardedParams):
        shards = [dict(_tree_leaves(t)) for t in params.shards]
        specs = dict(_tree_leaves(params.shardings))
        top = params.shards[0]
    else:
        shards, specs, top = [dict(_tree_leaves(params))], None, params
    n = len(shards)
    tree, tensors = {}, []      # tensors: (key, leaf path, spec, pieces)
    header, offset = {}, 0
    for path_, node in _tree_leaves(top):
        shapes = {}
        for field in _fields(node):
            spec = (_field(specs[path_], field).spec if specs is not None
                    else shd.P())
            pieces = [_field(s[path_], field) for s in shards]
            shape = list(pieces[0].shape)
            dim = shd.shard_dim(spec)
            if dim is not None:
                shape[dim] *= n
            shapes[field] = shape
            key, dtype = _key(path_, field), pieces[0].dtype
            size = math.prod(shape) * pieces[0].element_size()
            header[key] = {"dtype": _ST_DTYPES[dtype], "shape": shape,
                           "data_offsets": [offset, offset + size]}
            offset += size
            tensors.append((key, path_, spec, pieces))
        if isinstance(node, QuantizedArray):
            tree[path_] = {
                "kind": "quantized", "groups": int(node.scale.shape[-2]),
                **{f: {"dtype": _dtype_name(_field(node, f).dtype),
                       "shape": shapes[f]} for f in ("q", "scale")}}
        else:
            tree[path_] = {"kind": "tensor", "dtype": _dtype_name(node.dtype),
                           "shape": shapes[None]}
    header["__metadata__"] = {"format": NATIVE_FORMAT,
                              "tree": json.dumps(tree)}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)

    def host_slabs(path_, spec, pieces):
        """The full tensor's slabs on the host (a sharded one put back
        together from its shards' slabs)."""
        sharded = shd.shard_dim(spec) is not None

        def whole(parts, sp):
            return (shd.unnarrow([p.cpu() for p in parts], sp) if sharded
                    else parts[0].cpu())

        if not _by_slab(path_, spec):
            yield whole(pieces, spec)
            return
        inner = shd.P(*spec[1:], packed=spec.packed)
        for i in range(pieces[0].shape[0]):
            yield whole([p[i] for p in pieces], inner)

    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, NATIVE_FILE)
    with open(target + ".partial", "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for key, path_, spec, pieces in tensors:
            wrote = 0
            for slab in host_slabs(path_, spec, pieces):
                wrote += f.write(memoryview(
                    slab.contiguous().reshape(-1).view(torch.uint8).numpy()))
            start, end = header[key]["data_offsets"]
            if wrote != end - start:
                raise RuntimeError(f"save_native: {key} wrote {wrote} "
                                   f"bytes, expected {end - start}")
    os.replace(target + ".partial", target)


def _native_tree(path: str):
    """(open safetensors handle, the saved tree)."""
    from safetensors import safe_open

    f = safe_open(os.path.join(path, NATIVE_FILE), framework="pt",
                  device="cpu")
    meta = f.metadata() or {}
    if meta.get("format") != NATIVE_FORMAT:
        raise ValueError(f"{path}: not a native checkpoint (format "
                         f"{meta.get('format')!r}, expected "
                         f"{NATIVE_FORMAT!r})")
    return f, json.loads(meta["tree"])


def _saved(entry: dict, field) -> dict:
    return entry[field] if field else entry


def _check_paths(saved: dict, leaves: list) -> None:
    have = {p for p, _ in leaves}
    missing, extra = sorted(set(saved) - have), sorted(have - set(saved))
    if missing or extra:
        raise ValueError(f"load_native: the template and the checkpoint "
                         f"differ in leaves: only in the checkpoint "
                         f"{missing}, only in the template {extra}")


def _check_leaf(path: str, entry: dict, node, shape_of) -> None:
    """Raise ValueError naming ``path`` when the template's node kind,
    dtype or shape (``shape_of(saved shape, field)``: a shard's cut of
    it) differs from the checkpoint's."""
    kind = "quantized" if isinstance(node, QuantizedArray) else "tensor"
    if entry["kind"] != kind:
        raise ValueError(f"load_native: leaf {path!r} is a {entry['kind']} "
                         f"in the checkpoint, a {kind} in the template")
    for field in _fields(node):
        t, saved = _field(node, field), _saved(entry, field)
        name = _key(path, field)
        if _dtype_name(t.dtype) != saved["dtype"]:
            raise ValueError(f"load_native: leaf {name!r} has dtype "
                             f"{saved['dtype']} in the checkpoint, "
                             f"{_dtype_name(t.dtype)} in the template")
        want = tuple(shape_of(tuple(saved["shape"]), field))
        if tuple(t.shape) != want:
            raise ValueError(f"load_native: leaf {name!r} has shape "
                             f"{want} in the checkpoint, {tuple(t.shape)} "
                             f"in the template")


def _empty(saved: dict, device, shape=None) -> torch.Tensor:
    return torch.empty(shape if shape is not None else saved["shape"],
                       dtype=getattr(torch, saved["dtype"]), device=device)


def _restore_plain(f, saved: dict, template: dict, device) -> dict:
    """Every leaf of ``template`` onto ``device``, a slab at a time."""
    from tpu_inference_torch.parallel import shardings as shd

    values = {}
    for path_, node in _tree_leaves(template):
        parts = []
        for field in _fields(node):
            entry = _saved(saved[path_], field)
            out = _empty(entry, device)
            sl = f.get_slice(_key(path_, field))
            if _by_slab(path_, shd.P()):
                for i in range(out.shape[0]):
                    out[i].copy_(sl[i])
            else:
                out.copy_(sl[:])
            parts.append(out)
        values[path_] = (QuantizedArray(*parts)
                         if isinstance(node, QuantizedArray) else parts[0])
    return _tree_rebuild(template, values)


def load_native(path: str, template, device="cuda", mesh=None):
    """Restore a ``save_native`` checkpoint into ``template``'s structure.

    ``template`` is a params tree of tensors, or of meta stand-ins
    (``torch.empty(shape, dtype=..., device="meta")``, the twin of
    ``jax.ShapeDtypeStruct``), with QuantizedArray nodes where the tree
    has them; a leaf whose path, node kind, shape or dtype differs from
    the checkpoint raises ValueError naming it. Each leaf lands on
    ``device``, read slab by slab.

    A ``ShardedParams`` template (``shard_params(template, cfg, mesh)``;
    meta leaves stay meta, the reference's sharded abstract leaves)
    restores straight into its tp layout on ``mesh``'s tp devices
    (default: the mesh its shardings name): a ShardedParams equal to
    ``shard_params(load_native(path, template), cfg, mesh)``. Where the
    shards share one device it is exactly that, one copy with the shards
    views of it. Otherwise each slab is read once on the host, cut along
    the leaf's spec and each piece copied to its shard's device: no
    device holds an unsharded copy of a sharded leaf, the host one
    slab."""
    from tpu_inference_torch.parallel import shardings as shd

    f, saved = _native_tree(path)
    if not isinstance(template, shd.ShardedParams):
        if mesh is not None and mesh.shape.get("tp", 1) > 1:
            raise ValueError("load_native: a tp > 1 restore takes its "
                             "specs from a sharded template; pass "
                             "shard_params(template, cfg, mesh)")
        leaves = _tree_leaves(template)
        _check_paths(saved, leaves)
        for path_, node in leaves:
            _check_leaf(path_, saved[path_], node, lambda shape, _: shape)
        return _restore_plain(f, saved, template, device)

    specs = dict(_tree_leaves(template.shardings))
    if mesh is None:
        first = next(iter(specs.values()))
        mesh = _field(first, "q" if isinstance(first, QuantizedArray)
                      else None).mesh
    devices = mesh.tp_devices()
    n = len(devices)
    if n != len(template):
        raise ValueError(f"load_native: template cut into {len(template)} "
                         f"shards, mesh tp {n}")

    def spec_of(path_, field):
        return _field(specs[path_], field).spec

    _check_paths(saved, _tree_leaves(template.shards[0]))
    for shard in template.shards:
        for path_, node in _tree_leaves(shard):
            _check_leaf(path_, saved[path_], node,
                        lambda shape, field, p=path_: shd.shard_shape(
                            shape, spec_of(p, field), n))
    top = template.shards[0]
    if _shards_share_a_device(devices):
        full = {p: (QuantizedArray(*(_empty(saved[p][x], "meta")
                                     for x in ("q", "scale")))
                    if saved[p]["kind"] == "quantized"
                    else _empty(saved[p], "meta"))
                for p, _ in _tree_leaves(top)}
        plain = _restore_plain(f, saved, _tree_rebuild(top, full),
                               devices[0])
        return shd.cut_params(plain, template.shardings, devices)
    return _restore_per_shard(f, saved, template, devices, spec_of)


def _shards_share_a_device(devices: list) -> bool:
    return len({torch.device(d) for d in devices}) == 1


def _restore_per_shard(f, saved: dict, template, devices: list, spec_of):
    """load_native's path for shards on distinct devices: each slab read
    once on the host, cut, each piece copied into its shard's leaf."""
    from tpu_inference_torch.parallel import shardings as shd

    n = len(devices)
    top = template.shards[0]
    values = [{} for _ in range(n)]
    for path_, node in _tree_leaves(top):
        parts = [[] for _ in range(n)]
        for field in _fields(node):
            entry = _saved(saved[path_], field)
            spec = spec_of(path_, field)
            outs = [_empty(entry, d, shd.shard_shape(entry["shape"], spec, n))
                    for d in devices]
            sl = f.get_slice(_key(path_, field))
            if _by_slab(path_, spec):
                inner = shd.P(*spec[1:], packed=spec.packed)
                for i in range(entry["shape"][0]):
                    slab = sl[i]
                    for j in range(n):
                        outs[j][i].copy_(shd.narrow(slab, inner, j, n))
            else:
                whole = sl[:]
                for j in range(n):
                    outs[j].copy_(shd.narrow(whole, spec, j, n))
            for j in range(n):
                parts[j].append(outs[j])
        for j in range(n):
            values[j][path_] = (QuantizedArray(*parts[j])
                                if isinstance(node, QuantizedArray)
                                else parts[j][0])
    return shd.ShardedParams([_tree_rebuild(top, v) for v in values],
                             template.shardings)
