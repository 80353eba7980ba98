"""Operations and bytes that the inputs need: the yardstick of the mfu
and roofline metrics.

Counted from the model's shape (spec.model_shape), layer by layer from
its family's ``costs`` (families/), and from the tokens the requests
carried, never from what a kernel pads or reads twice: no expert
capacity padding, no ladder rung or prefill bucket padding, each cached
token's bytes read once per query step, and the logits only where a
token is sampled (a prompt's last position, each decode step).

A multiply-add is 2 operations.
"""

from __future__ import annotations

from h100bench import families


def layer_costs(s: dict) -> list:
    """The family's costs, one dict a layer (families/__init__.py)."""
    return families.of(s).costs(s)


def matmul_params(s: dict) -> int:
    """Parameters one position multiplies through in every layer: the
    attention projections, any router, and the active FFN."""
    return sum(c["matmul_params"] for c in layer_costs(s))


def kv_span(window: int, kv_len: int) -> int:
    """Keys a query at context length ``kv_len`` attends over (``window``
    0: every one)."""
    return min(kv_len, window or kv_len)


def prefill_pairs(window: int, prompt: int, cached: int = 0) -> int:
    """(query, key) pairs of the uncached prompt positions cached..prompt-1
    under the causal (and window) mask: query q sees kv_span(window,
    q + 1) keys."""
    lo, hi = cached + 1, prompt          # keys seen: v = lo..hi, one each
    w = min(hi, window or hi)            # v > w sees w keys
    below = (w * (w + 1) - (lo - 1) * lo) // 2 if w >= lo else 0
    return below + max(0, hi - max(lo - 1, w)) * w


def prefill_flops(s: dict, prompt: int, cached: int = 0) -> int:
    """A prompt's prefill: the matrix products of its uncached positions,
    their attention, and the logits of its last position."""
    n = prompt - cached
    total = 2 * s["d"] * s["vocab"]
    for c in layer_costs(s):
        total += (2 * n * c["matmul_params"]
                  + c["pair_flops"] * prefill_pairs(c["window"], prompt,
                                                    cached))
    return total


def decode_attn_flops(s: dict, kv_len: int) -> int:
    """One decode step's QK^T and PV, all layers, for a new token at
    position kv_len - 1 (it attends over kv_len keys, each layer's window
    allowing)."""
    return sum(c["pair_flops"] * kv_span(c["window"], kv_len)
               for c in layer_costs(s))


def decode_flops(s: dict, kv_len: int) -> int:
    """One decode step of one sequence whose new token sits at position
    kv_len - 1."""
    return (2 * (matmul_params(s) + s["d"] * s["vocab"])
            + decode_attn_flops(s, kv_len))


def decode_attn_bytes(s: dict, kv_len: int) -> int:
    """One decode step's attention, all layers: the cached bytes of every
    token it reads, once, and its query and output."""
    return sum(c["kv_bytes"] * kv_span(c["window"], kv_len) + c["qo_bytes"]
               for c in layer_costs(s))
