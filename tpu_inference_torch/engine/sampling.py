"""Token sampling, batched (twin of ``tpu_inference/engine/sampling.py``).

One call serves any mix of greedy / temperature / top-k / top-p /
seeded rows in a batch. top_k is a per-row value: the row is sorted once
and thresholded at its k-th largest logit, which also serves the top-p
filter — one sort, both filters.

Which path runs is decided on the host from the staging arrays, not by
reading device values: an all-greedy batch takes the argmax and never
sorts (the reference's ``lax.cond`` fast path), and the repetition
penalty runs only when some row has one.

Randomness: sampled rows take a Gumbel-max draw over their filtered
logits. A row with ``seed >= 0`` draws its uniforms from a generator
keyed only on (seed, absolute token position), so it reproduces across
batch placement and scheduling within the port; other rows draw from
the engine's generator. The draws cannot match the reference's jax
threefry streams bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

# Ring width for repetition-penalty windows (Ollama repeat_last_n
# defaults to 64; per-request values clamp to this).
PENALTY_WINDOW = 64


class SamplingParams(NamedTuple):
    """Per-slot sampling parameters: device tensors for the math, the
    seeds on the host (they key per-row generators)."""

    temperature: torch.Tensor   # [B] f32; <= 0 means greedy
    top_p: torch.Tensor         # [B] f32 in (0, 1]; 1 disables
    top_k: torch.Tensor         # [B] int; <= 0 disables
    seed: np.ndarray            # [B] int; < 0 = engine generator


def apply_repeat_penalty(logits: torch.Tensor, window: torch.Tensor,
                         penalty: torch.Tensor,
                         last_n: torch.Tensor) -> torch.Tensor:
    """Ollama/llama.cpp repetition penalty, batched.

    logits: [B, V]; window: [B, W] chronological recent token ids (-1 =
    empty); penalty: [B] f32 (1.0 disables); last_n: [B] int — only the
    newest ``last_n`` window entries count (0 disables). Positive logits
    divide by the penalty, negative multiply."""
    b, v = logits.shape
    w = window.shape[1]
    rank = torch.arange(w, device=logits.device)[None, :]
    in_n = rank >= (w - torch.clamp(last_n.long(), max=w))[:, None]
    valid = (window >= 0) & in_n
    idx = torch.where(valid, window.long(), torch.zeros_like(window.long()))
    hits = torch.zeros((b, v), dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, idx, valid.int())
    p = penalty.float()[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where((hits > 0) & (p != 1.0), penalized, logits)


def roll_window(window: torch.Tensor, tokens: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """Append this step's tokens to active rows' windows."""
    rolled = torch.roll(window, -1, dims=1)
    rolled[:, -1] = tokens.to(window.dtype)
    return torch.where(active[:, None], rolled, window)


def apply_filters(logits: torch.Tensor, top_k, top_p: torch.Tensor
                  ) -> torch.Tensor:
    """Sequential top-k then top-p (nucleus) filtering, ONE [B, V] sort.

    ``top_k``: int or [B]; <= 0 disables that row's k filter. ``top_p``:
    [B]; mass is measured over the top-k survivors (renormalized). Always
    keeps >= 1 token per row."""
    b, v = logits.shape
    k = torch.as_tensor(top_k, device=logits.device).long().expand(b)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    rank = torch.arange(v, device=logits.device)[None, :]
    keep_k = (k[:, None] <= 0) | (rank < k[:, None])
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    sorted_f = torch.where(keep_k, sorted_desc, neg_inf)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Sorted token i is kept if the mass *before* it is < top_p.
    keep = keep_k & ((cum - probs) < top_p.float()[:, None])
    thresh = torch.where(keep, sorted_f, -neg_inf).amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, neg_inf, logits)


def _seeded_key(seed: int, ctx: int) -> int:
    """64-bit generator seed from (seed, position) — splitmix64 of the
    pair, so nearby pairs give unrelated streams."""
    z = ((seed & 0xFFFFFFFF) << 32 | (ctx & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def _uniforms(shape, generator: torch.Generator, seeds: np.ndarray,
              ctx: Sequence[int], device) -> torch.Tensor:
    """[B, V] uniforms: engine generator rows, then seeded rows redrawn
    from their own (seed, ctx) generators."""
    b, v = shape
    u = torch.rand((b, v), generator=generator, device=device)
    for i in np.flatnonzero(seeds >= 0):
        g = torch.Generator(device=device)
        g.manual_seed(_seeded_key(int(seeds[i]), int(ctx[i])))
        u[i] = torch.rand((v,), generator=g, device=device)
    return u


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: torch.Generator, ctx: Sequence[int],
           all_greedy: bool,
           penalty_window: Optional[torch.Tensor] = None,
           repeat_penalty: Optional[torch.Tensor] = None,
           repeat_last_n: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: [B, V] f32 -> token ids [B] int32.

    ``ctx``: host ints, the absolute position of the token being sampled
    per row (keys seeded rows). ``all_greedy``: the host's view of
    ``params.temperature <= 0`` for every row. The repetition penalty
    (when ``penalty_window`` is given) applies before temperature and
    before the greedy argmax, as in Ollama."""
    if penalty_window is not None:
        logits = apply_repeat_penalty(logits, penalty_window,
                                      repeat_penalty, repeat_last_n)
    greedy_tok = torch.argmax(logits, dim=-1).int()
    if all_greedy:
        return greedy_tok
    temp = params.temperature.clamp_min(1e-6)[:, None]
    scaled = apply_filters(logits / temp, params.top_k, params.top_p)
    u = _uniforms(scaled.shape, generator, params.seed, ctx, logits.device)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).int()
    return torch.where(params.temperature <= 0.0, greedy_tok, sampled)
