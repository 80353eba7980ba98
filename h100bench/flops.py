"""Operations and bytes that the inputs need: the yardstick of the mfu
and roofline metrics.

Counted from the model's shape (spec.model_shape) and the tokens the
requests carried, never from what a kernel pads or reads twice: no
expert capacity padding, no ladder rung or prefill bucket padding, each
cached key and value read once per query step, and the logits only where
a token is sampled (a prompt's last position, each decode step).

A multiply-add is 2 operations. Bytes are bf16 (2 each) for q, k, v and
the attention output.
"""

from __future__ import annotations

BF16 = 2


def layer_matmul_params(s: dict) -> int:
    """Parameters one position multiplies through in one layer: the
    attention projections, the router, and the active FFN (top-k experts
    of a sparse layer)."""
    d, hd = s["d"], s["head_dim"]
    attn = d * s["heads"] * hd * 2 + d * s["kv_heads"] * hd * 2
    ffn = 3 * d * s["d_ff"] * (s["top_k"] if s["experts"] else 1)
    return attn + ffn + d * s["experts"]


def kv_span(s: dict, kv_len: int) -> int:
    """Keys a query at context length ``kv_len`` attends over."""
    return min(kv_len, s["window"]) if s["window"] else kv_len


def prefill_pairs(s: dict, prompt: int, cached: int = 0) -> int:
    """(query, key) pairs of the uncached prompt positions cached..prompt-1
    under the causal (and window) mask."""
    w = s["window"]
    if not w:
        return sum(range(cached + 1, prompt + 1))
    return sum(min(q + 1, w) for q in range(cached, prompt))


def attn_flops(s: dict, pairs: int) -> int:
    """QK^T and PV over ``pairs`` (query, key) pairs in every layer."""
    return 4 * s["heads"] * s["head_dim"] * pairs * s["layers"]


def prefill_flops(s: dict, prompt: int, cached: int = 0) -> int:
    """A prompt's prefill: the matrix products of its uncached positions,
    their attention, and the logits of its last position."""
    n = prompt - cached
    return (2 * n * layer_matmul_params(s) * s["layers"]
            + attn_flops(s, prefill_pairs(s, prompt, cached))
            + 2 * s["d"] * s["vocab"])


def decode_flops(s: dict, kv_len: int) -> int:
    """One decode step of one sequence whose new token sits at position
    kv_len - 1 (it attends over kv_len keys)."""
    return (2 * (layer_matmul_params(s) * s["layers"] + s["d"] * s["vocab"])
            + attn_flops(s, kv_span(s, kv_len)))


def decode_attn_bytes(s: dict, kv_len: int) -> int:
    """One decode step's attention, all layers: the keys and values it
    reads once, its query and its output."""
    hd, L = s["head_dim"], s["layers"]
    kv = 2 * s["kv_heads"] * hd * kv_span(s, kv_len)
    return BF16 * L * (kv + 2 * s["heads"] * hd)


def decode_attn_flops(s: dict, kv_len: int) -> int:
    return attn_flops(s, kv_span(s, kv_len))
