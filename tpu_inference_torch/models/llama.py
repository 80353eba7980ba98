"""Llama-family decoder (RMSNorm + RoPE + GQA + SwiGLU) in PyTorch.

Twin of ``tpu_inference/models/llama.py``: one module serves vanilla
Llama, Mistral (sliding_window, masked in the attention backend), Qwen2
(qkv_bias) and Gemma (norm_offset, gelu_tanh gate, embed_scale,
decoupled head_dim). Parameters are a plain dict in the reference's
layout: per-layer weights stacked along a leading layer axis, matrices
``[in, out]``. The reference's ``lax.scan`` over layers is a Python loop
here; each layer reads a view of the stacked tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models.common import (
    AttentionFn,
    apply_rope_tables,
    init_stacked,
    qdot,
    residual,
    rms_norm,
    rope_tables,
    swiglu_partial,
)


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's layout: leaf name -> shape, per-layer
    weights stacked along a leading layer axis, matrices ``[in, out]``."""
    cfg.validate()
    d, f, hd, L = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_layers
    blocks = {
        "attn_norm": (L, d),
        "wq": (L, d, cfg.n_heads * hd),
        "wk": (L, d, cfg.n_kv_heads * hd),
        "wv": (L, d, cfg.n_kv_heads * hd),
        "wo": (L, cfg.n_heads * hd, d),
        "ffn_norm": (L, d),
        "w_gate": (L, d, f),
        "w_up": (L, d, f),
        "w_down": (L, f, d),
    }
    if cfg.qkv_bias:
        blocks.update(bq=(L, cfg.n_heads * hd), bk=(L, cfg.n_kv_heads * hd),
                      bv=(L, cfg.n_kv_heads * hd))
    shapes = {"embed": (cfg.vocab_size, d), "blocks": blocks,
              "final_norm": (d,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random init (normal, 0.02 std; norms ones, biases zeros) with
    stacked layer weights (models/common.py init_stacked)."""
    return init_stacked(
        param_shapes(cfg), cfg.dtype, generator, device,
        lambda name: (1.0 if "norm" in name
                      else 0.0 if name in ("bq", "bk", "bv") else None))


def layer_params(params: dict, layer_idx: int) -> dict:
    """One layer's weights as views of the stacked tensors (quantized
    leaves slice their codes and scales alike)."""
    return {k: v[layer_idx] for k, v in params["blocks"].items()}


# The block's halves, shared with parallel/tp.py: each half's matmul
# output comes back as a float32 partial, which the block (or, at tp > 1,
# the sum over the shards) casts and adds to the residual stream. Head
# counts come from the (possibly head-sharded) weights, never from cfg.
USES_ROPE = True
ATTN_BIAS = FFN_BIAS = None      # biases applied after the reduction


def attn_norm(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, lp["attn_norm"], cfg.norm_eps, cfg.norm_offset)


def attn_partial(cfg: ModelConfig, layer_idx: int, lp: dict,
                 h: torch.Tensor, kv: Any, attn: AttentionFn,
                 rope: Tuple[torch.Tensor, torch.Tensor],
                 f32_product: bool = False):
    """Projections, RoPE, attention and ``wo`` of the normed input
    ``h`` [B, S, D] -> (float32 [B, S, D], kv). ``f32_product``: ``wo``'s
    product unrounded (a tp shard's partial, models/quant.py qdot)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q, k, v = qdot(h, lp["wq"]), qdot(h, lp["wk"]), qdot(h, lp["wv"])
    if cfg.qkv_bias:
        q = q + lp["bq"].float()
        k = k + lp["bk"].float()
        v = v + lp["bv"].float()
    q = q.to(h.dtype).reshape(b, s, -1, hd)
    k = k.to(h.dtype).reshape(b, s, -1, hd)
    v = v.to(h.dtype).reshape(b, s, -1, hd)
    q = apply_rope_tables(q, *rope)
    k = apply_rope_tables(k, *rope)
    attn_out, kv = attn(layer_idx, q, k, v, kv)
    return qdot(attn_out.reshape(b, s, -1), lp["wo"], f32_product), kv


def ffn_norm(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, lp["ffn_norm"], cfg.norm_eps, cfg.norm_offset)


def ffn_partial(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                f32_product: bool = False) -> torch.Tensor:
    return swiglu_partial(h, lp["w_gate"], lp["w_up"], lp["w_down"],
                          act=cfg.hidden_act, f32_product=f32_product)


def decoder_block(cfg: ModelConfig, layer_idx: int, lp: dict,
                  x: torch.Tensor, positions: torch.Tensor, kv: Any,
                  attn: AttentionFn,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One transformer block. x: [B, S, D]. ``rope`` = precomputed
    (cos, sin) tables for ``positions`` (models/common.py rope_tables);
    computed here when omitted."""
    if rope is None:
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
    part, kv = attn_partial(cfg, layer_idx, lp, attn_norm(cfg, lp, x), kv,
                            attn, rope)
    x = residual(x, part)
    return residual(x, ffn_partial(cfg, lp, ffn_norm(cfg, lp, x))), kv


def embed_rows(params: dict, cfg: ModelConfig, rows: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding-table rows of the tokens -> the first layer's input."""
    x = rows.to(cfg.dtype)
    if cfg.embed_scale:
        # Gemma: the sqrt(d) normalizer rounds to the activation dtype.
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)
    return x


def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> input embeddings. Ids clamp into the table, as the
    reference's XLA gather does (an out-of-range index would fault on the
    card instead)."""
    ids = tokens.clamp(0, cfg.vocab_size - 1)
    return embed_rows(params, cfg, params["embed"][ids])


def final_norm(params: dict, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Any, attn: AttentionFn,
                   on_layer: Optional[Callable[[int, torch.Tensor], None]]
                   = None) -> Tuple[torch.Tensor, Any]:
    """Token ids -> final hidden states. tokens, positions: [B, S].
    ``on_layer(i, x)`` sees each layer's output (check_numerics)."""
    x = embed_tokens(params, cfg, tokens)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_scaling)
    for i in range(cfg.n_layers):
        x, kv = decoder_block(cfg, i, layer_params(params, i), x, positions,
                              kv, attn, rope=rope)
        if on_layer is not None:
            on_layer(i, x)
    return final_norm(params, cfg, x), kv


def unembed(params: dict, cfg: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """Hidden states -> f32 logits (``lm_head`` may be quantized; a
    tied embedding table never is)."""
    if cfg.tie_embeddings:
        return qdot(hidden, params["embed"].t())
    return qdot(hidden, params["lm_head"])


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: Any,
            attn: AttentionFn) -> Tuple[torch.Tensor, Any]:
    """Convenience: full-sequence logits (tests / tiny models)."""
    hidden, kv = forward_hidden(params, cfg, tokens, positions, kv, attn)
    return unembed(params, cfg, hidden), kv
