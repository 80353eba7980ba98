"""GPT-2 family (LayerNorm + learned positions + GELU, fused QKV) in
PyTorch.

Twin of ``tpu_inference/models/gpt2.py``, with the llama module's
conventions: a plain parameter dict, per-layer weights stacked along a
leading layer axis, matrices ``[in, out]`` (HF's Conv1D layout already),
and a Python loop over layers. Heads are multi-head (Hkv = Hq); the
embedding table is tied to the output projection.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models import llama
from tpu_inference_torch.models.common import (AttentionFn, init_stacked,
                                               layer_norm, linear, qdot,
                                               residual)

def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree's layout: leaf name -> shape."""
    cfg.validate()
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    return {
        "embed": (cfg.vocab_size, d),
        "pos_embed": (cfg.max_seq_len, d),
        "blocks": {
            "ln1_w": (L, d), "ln1_b": (L, d),
            "w_qkv": (L, d, 3 * d), "b_qkv": (L, 3 * d),
            "w_proj": (L, d, d), "b_proj": (L, d),
            "ln2_w": (L, d), "ln2_b": (L, d),
            "w_fc": (L, d, f), "b_fc": (L, f),
            "w_out": (L, f, d), "b_out": (L, d),
        },
        "ln_f_w": (d,), "ln_f_b": (d,),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random init as the reference's: matrices and tables normal with
    0.02 std, LayerNorm weights ones, biases zeros."""

    def fill(name):
        if name in ("ln1_w", "ln2_w", "ln_f_w"):
            return 1.0
        return 0.0 if name.startswith(("b_", "ln")) else None

    return init_stacked(param_shapes(cfg), cfg.dtype, generator, device,
                        fill)


# The block's halves, as models/llama.py's (parallel/tp.py drives them
# per shard). ``b_proj``/``b_out`` are added once, after the reduction.
USES_ROPE = False
ATTN_BIAS, FFN_BIAS = "b_proj", "b_out"


def attn_norm(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)


def attn_partial(cfg: ModelConfig, layer_idx: int, lp: dict,
                 h: torch.Tensor, kv: Any, attn: AttentionFn, rope=None,
                 f32_product: bool = False):
    """Fused QKV (a shard's ``w_qkv`` packs its own q|k|v heads),
    attention and ``w_proj`` without its bias -> (float32, kv)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q, k, v = linear(h, lp["w_qkv"], lp["b_qkv"]).chunk(3, dim=-1)
    attn_out, kv = attn(layer_idx, q.reshape(b, s, -1, hd),
                        k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd), kv)
    return qdot(attn_out.reshape(b, s, -1), lp["w_proj"], f32_product), kv


def ffn_norm(cfg: ModelConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)


def ffn_partial(cfg: ModelConfig, lp: dict, h: torch.Tensor,
                f32_product: bool = False) -> torch.Tensor:
    h = F.gelu(linear(h, lp["w_fc"], lp["b_fc"]), approximate="tanh")
    return qdot(h, lp["w_out"], f32_product)


def decoder_block(cfg: ModelConfig, layer_idx: int, lp: dict,
                  x: torch.Tensor, kv: Any, attn: AttentionFn):
    part, kv = attn_partial(cfg, layer_idx, lp, attn_norm(cfg, lp, x), kv,
                            attn)
    x = residual(x, part, lp[ATTN_BIAS])
    return residual(x, ffn_partial(cfg, lp, ffn_norm(cfg, lp, x)),
                    lp[FFN_BIAS]), kv


def embed_rows(params: dict, cfg: ModelConfig, rows: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Token-table rows plus learned position embeddings. Positions
    clamp into their table, as the reference's XLA gather does: a
    position at or past ``max_seq_len`` reads the table's last row."""
    pos = positions.clamp(0, cfg.max_seq_len - 1)
    return (rows + params["pos_embed"][pos]).to(cfg.dtype)


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Token plus learned position embeddings. Ids clamp into the table
    (an out-of-range index would fault on the card)."""
    ids = tokens.clamp(0, cfg.vocab_size - 1)
    return embed_rows(params, cfg, params["embed"][ids], positions)


def final_norm(params: dict, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, params["ln_f_w"], params["ln_f_b"], cfg.norm_eps)


def forward_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor, kv: Any, attn: AttentionFn,
                   on_layer: Optional[Callable[[int, torch.Tensor], None]]
                   = None) -> Tuple[torch.Tensor, Any]:
    """Token ids -> final hidden states. tokens, positions: [B, S].
    ``on_layer(i, x)`` sees each layer's output (check_numerics)."""
    x = embed_tokens(params, cfg, tokens, positions)
    for i in range(cfg.n_layers):
        x, kv = decoder_block(cfg, i, llama.layer_params(params, i), x, kv,
                              attn)
        if on_layer is not None:
            on_layer(i, x)
    return final_norm(params, cfg, x), kv


def unembed(params: dict, cfg: ModelConfig,
            hidden: torch.Tensor) -> torch.Tensor:
    """Tied output projection: ``hidden @ embed.T`` as float32 logits
    (bf16 operands: float32 accumulation, a bf16-rounded product, as
    models/common.py qdot)."""
    return torch.matmul(hidden, params["embed"].t()).float()


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, kv: Any,
            attn: AttentionFn) -> Tuple[torch.Tensor, Any]:
    hidden, kv = forward_hidden(params, cfg, tokens, positions, kv, attn)
    return unembed(params, cfg, hidden), kv
