"""Shared transformer building blocks (PyTorch twin of
``tpu_inference/models/common.py``).

Conventions match the reference:
- Activations flow in ``cfg.dtype``; normalization statistics and the
  attention softmax accumulate in float32.
- Attention is *injected*: forward passes take an ``AttentionFn``
  ``attn(layer_idx, q, k, v, kv) -> (out, kv)`` with q [B,S,Hq,D] and
  k/v [B,S,Hkv,D]; the engine's paged attention (kernels or the dense
  gather path) and the cache-free test path all fit it.
- Weight matrices keep the reference's ``[in, out]`` layout.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_inference_torch.models import quant

# attn(layer_idx, q, k, v, kv_state) -> (attn_out, kv_state)
AttentionFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor, Any],
                       Tuple[torch.Tensor, Any]]

NEG_INF = -1e30

# Gated-FFN activations; a KeyError fails loudly on an unknown hidden_act.
_GATE_ACTS = {
    "silu": F.silu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def init_stacked(shapes: dict, dtype: torch.dtype,
                 generator: torch.Generator, device,
                 fill: Callable[[str], Optional[float]]) -> dict:
    """Random init of the parameter tree ``shapes`` (leaf name -> shape).
    ``fill(name)`` gives a constant leaf's value (norm weights 1, biases
    0) or None for a drawn one: normal with 0.02 std, drawn in float32
    one trailing ``[in, out]`` slab at a time (so the float32 draw never
    holds more than one slab) and stored in ``dtype``."""
    device = generator.device if device is None else torch.device(device)

    def leaf(name, shape):
        value = fill(name)
        if value is not None:
            return torch.full(shape, value, dtype=dtype, device=device)
        out = torch.empty(shape, dtype=dtype, device=device)
        for slab in out.reshape(-1, *shape[-2:]):
            slab.copy_(0.02 * torch.randn(slab.shape, generator=generator,
                                          dtype=torch.float32, device=device))
        return out

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else leaf(k, v)
                for k, v in tree.items()}

    return build(shapes)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with float32 statistics, output in x.dtype. ``offset``
    serves Gemma's stored-as-delta weights, added in float32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight.float() + offset)).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm (GPT-2 family) with float32 statistics (the population
    variance), output in x.dtype."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, scaling=None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for rotary embeddings, [head_dim // 2] f32,
    with the optional Llama-3.1 "llama3" per-channel rescale."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    if scaling is not None:
        wavelen = 2.0 * math.pi / inv_freq
        smooth = ((scaling.original_max_len / wavelen
                   - scaling.low_freq_factor)
                  / (scaling.high_freq_factor - scaling.low_freq_factor))
        interp = ((1.0 - smooth) * inv_freq / scaling.factor
                  + smooth * inv_freq)
        inv_freq = torch.where(
            wavelen > scaling.original_max_len / scaling.low_freq_factor,
            inv_freq / scaling.factor,
            torch.where(
                wavelen < scaling.original_max_len / scaling.high_freq_factor,
                inv_freq, interp))
    return inv_freq


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [B, S, 1, head_dim // 2] f32, for ``positions``
    [B, S]. Computed once per forward and shared by every layer."""
    inv_freq = rope_frequencies(head_dim, theta, scaling,
                                device=positions.device)
    angles = positions[..., None].float() * inv_freq          # [B,S,half]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               scaling=None) -> torch.Tensor:
    """Rotary position embedding, half-split pairing (HF rotate_half).
    x: [B, S, H, D]; positions: [B, S] integer."""
    cos, sin = rope_tables(positions, x.shape[-1], theta, scaling)
    return apply_rope_tables(x, cos, sin)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for GQA: [B, S, Hkv, D] -> [B, S, Hkv*n_rep, D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def dense_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_offset=0, kv_len=None,
                           sliding_window: int = 0) -> torch.Tensor:
    """Dense causal attention; the correctness reference for the kernels.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]. ``q_offset`` (int or [B])
    is the absolute position of q's first token; ``kv_len`` (int or [B])
    masks cache slots at or beyond the valid length; ``sliding_window``
    > 0 also masks keys more than window-1 positions behind the query.
    Softmax in float32.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dev = q.device
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    offs = torch.as_tensor(q_offset, device=dev).expand(b)         # [B]
    q_pos = offs[:, None] + torch.arange(sq, device=dev)[None, :]  # [B,Sq]
    k_pos = torch.arange(skv, device=dev)                          # [Skv]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]               # [B,Sq,Skv]
    if sliding_window:
        mask &= k_pos[None, None, :] > q_pos[:, :, None] - sliding_window
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, device=dev).expand(b)
        mask &= k_pos[None, None, :] < lens[:, None, None]
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def make_dense_attn(sliding_window: int = 0) -> AttentionFn:
    """AttentionFn for cache-free full-sequence forward (tests, parity)."""

    def attn(layer_idx: int, q, k, v, kv):
        del layer_idx
        return dense_causal_attention(q, k, v,
                                      sliding_window=sliding_window), kv

    return attn


def qdot(x: torch.Tensor, w, f32_product: bool = False) -> torch.Tensor:
    """``x @ w`` returned in float32; w: [in, out], or a
    ``QuantizedArray`` (models/quant.py qdot). Float32 operands multiply
    in float32; bf16 operands multiply on the tensor cores with float32
    accumulation and a bf16-rounded product, or with ``f32_product`` a
    float32 one (a tp shard's row-parallel partial)."""
    return quant.qdot(x, w, f32_product)


def swiglu_partial(x: torch.Tensor, w_gate, w_up, w_down,
                   act: str = "silu", f32_product: bool = False
                   ) -> torch.Tensor:
    """Gated FFN ``down( act(x @ gate) * (x @ up) )`` in float32, before
    the cast: a tp shard's partial sum (parallel/tp.py reduces the
    shards' partials, then casts; ``f32_product`` for ``w_down``)."""
    fn = _GATE_ACTS[act]
    gate = fn(qdot(x, w_gate))
    up = qdot(x, w_up)
    return qdot((gate * up).to(x.dtype), w_down, f32_product)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated FFN: down( act(x @ gate) * (x @ up) )."""
    return swiglu_partial(x, w_gate, w_up, w_down, act).to(x.dtype)


def residual(x: torch.Tensor, total: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` plus a block's float32 output ``total`` (the sum of the tp
    shards' partials; the one partial at tp 1), plus a bias applied once
    after the sum, cast to x's dtype before the add."""
    if bias is not None:
        total = total + bias.float()
    return x + total.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    out = qdot(x, w)
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)
