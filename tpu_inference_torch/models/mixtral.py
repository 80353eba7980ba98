"""Mixtral family: Llama-style attention + a sparse mixture-of-experts
FFN, in PyTorch.

Twin of ``tpu_inference/models/mixtral.py``. The reference writes the
token-choice top-k dispatch as dense one-hot einsums over a [T, E, C]
tensor, a device for XLA's static shapes; here it is gather and scatter
by index, computing the same function:

- router logits in float32, top-k experts per token, softmax over the k
  selected logits only (Mixtral's normalisation);
- every expert takes at most C = max(ceil(k * T / E * factor), k)
  tokens of the call (T = all B * S tokens, padding included). A token's
  slot in expert e is the number of tokens at or before it, in row-major
  order over [B, S], that chose e, minus one; a token past C loses that
  expert's contribution (capacity dropping), so earlier rows win;
- the kept tokens gather into [E, C, D] buffers, the experts run as
  batched matmuls over E (``quant.qeinsum``: int8/int4 weights too), and
  each token sums its experts' outputs times its routing weights in
  float32.

So a token's output depends on the other tokens of the call: the engine
must hand ``moe_ffn`` the reference's padded shapes in the reference's
row order for tokens to agree when tokens drop.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models import llama
from tpu_inference_torch.models.common import (AttentionFn, apply_rope_tables,
                                               init_stacked, qdot, rms_norm,
                                               rope_tables)
from tpu_inference_torch.models.quant import qeinsum


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's layout: leaf name -> shape (experts stacked
    ``[L, E, in, out]``)."""
    cfg.validate()
    d, f, L, E = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_experts
    hd = cfg.head_dim
    return {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "attn_norm": (L, d),
            "wq": (L, d, cfg.n_heads * hd),
            "wk": (L, d, cfg.n_kv_heads * hd),
            "wv": (L, d, cfg.n_kv_heads * hd),
            "wo": (L, cfg.n_heads * hd, d),
            "ffn_norm": (L, d),
            "w_router": (L, d, E),
            "w_gate": (L, E, d, f),
            "w_up": (L, E, d, f),
            "w_down": (L, E, f, d),
        },
        "final_norm": (d,),
        "lm_head": (d, cfg.vocab_size),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random init (normal, 0.02 std; norms ones), one ``[in, out]``
    slab at a time."""
    return init_stacked(param_shapes(cfg), cfg.dtype, generator, device,
                        lambda name: 1.0 if "norm" in name else None)


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Per-expert capacity of a call processing ``n_tokens`` tokens."""
    c = math.ceil(cfg.n_experts_per_tok * n_tokens / cfg.n_experts
                  * cfg.expert_capacity_factor)
    return max(c, cfg.n_experts_per_tok)


def route(cfg: ModelConfig, w_router: torch.Tensor, x2: torch.Tensor):
    """Top-k routing of tokens x2 [T, D]: (expert ids [T, k], routing
    weights [T, k] float32, buffer slot [T, k], kept [T, k] bool)."""
    t, e, k = x2.shape[0], cfg.n_experts, cfg.n_experts_per_tok
    cap = expert_capacity(cfg, t)
    # float32 logits: a bf16-rounded product can flip a top-k choice.
    logits = torch.matmul(x2.float(), w_router.float())        # [T, E]
    top_vals, top_idx = torch.topk(logits, k, dim=-1)           # [T, k]
    top_w = torch.softmax(top_vals, dim=-1)
    mask = torch.zeros((t, e), dtype=torch.int32, device=x2.device)
    mask.scatter_(1, top_idx, 1)
    pos = torch.cumsum(mask, dim=0) * mask - 1                  # [T, E]
    slot = pos.gather(1, top_idx)                               # [T, k]
    return top_idx, top_w, slot, slot < cap


def moe_ffn(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    """Sparse MoE FFN. x: [B, S, D] -> [B, S, D].

    Shapes stay static (no host sync): a dropped (token, expert) pair
    writes to and reads from one spare row past the E * C buffer rows,
    which holds zeros on the way back."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.n_experts_per_tok
    cap = expert_capacity(cfg, t)
    x2 = x.reshape(t, d)
    top_idx, top_w, slot, keep = route(cfg, lp["w_router"], x2)
    dest = torch.where(keep, top_idx * cap + slot, e * cap)     # [T, k]
    buf = x2.new_zeros((e * cap + 1, d))
    buf[dest.reshape(-1)] = x2.repeat_interleave(k, dim=0)
    expert_in = buf[:-1].reshape(e, cap, d)
    gate = F.silu(qeinsum("ecd,edf->ecf", expert_in, lp["w_gate"]))
    up = qeinsum("ecd,edf->ecf", expert_in, lp["w_up"])
    expert_out = qeinsum("ecf,efd->ecd", (gate * up).to(x.dtype),
                         lp["w_down"])                          # float32
    rows = torch.cat([expert_out.reshape(e * cap, d),
                      expert_out.new_zeros((1, d))])
    out = (rows[dest] * top_w[..., None]).sum(dim=1)            # [T, D]
    return out.to(x.dtype).reshape(b, s, d)


def decoder_block(cfg: ModelConfig, layer_idx: int, lp: dict,
                  x: torch.Tensor, kv: Any, attn: AttentionFn,
                  rope: Tuple[torch.Tensor, torch.Tensor]):
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = qdot(h, lp["wq"]).to(x.dtype).reshape(b, s, cfg.n_heads, hd)
    k = qdot(h, lp["wk"]).to(x.dtype).reshape(b, s, cfg.n_kv_heads, hd)
    v = qdot(h, lp["wv"]).to(x.dtype).reshape(b, s, cfg.n_kv_heads, hd)
    attn_out, kv = attn(layer_idx, apply_rope_tables(q, *rope),
                        apply_rope_tables(k, *rope), v, kv)
    attn_out = attn_out.reshape(b, s, cfg.n_heads * hd)
    x = x + qdot(attn_out, lp["wo"]).to(x.dtype)
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    return x + moe_ffn(cfg, lp, h), kv


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Any, attn: AttentionFn,
                   on_layer: Optional[Callable[[int, torch.Tensor], None]]
                   = None) -> Tuple[torch.Tensor, Any]:
    """Token ids -> final hidden states. tokens, positions: [B, S].
    ``on_layer(i, x)`` sees each layer's output (check_numerics)."""
    x = llama.embed_tokens(params, cfg, tokens)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_scaling)
    for i in range(cfg.n_layers):
        x, kv = decoder_block(cfg, i, llama.layer_params(params, i), x, kv,
                              attn, rope)
        if on_layer is not None:
            on_layer(i, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), kv


def unembed(params: dict, cfg: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    return qdot(hidden, params["lm_head"])


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: Any,
            attn: AttentionFn) -> Tuple[torch.Tensor, Any]:
    hidden, kv = forward_hidden(params, cfg, tokens, positions, kv, attn)
    return unembed(params, cfg, hidden), kv
