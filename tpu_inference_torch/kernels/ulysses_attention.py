"""Ulysses sequence parallelism: head-scatter attention (PyTorch twin of
``tpu_inference/kernels/ulysses_attention.py``).

The reference's two ``all_to_all``s move activations between layouts:

    [B, S/n, H,   D]   (sequence slices, the layer's layout)
        -- regroup: split heads, concatenate the sequence -->
    [B, S,   H/n, D]   (head slices: each sees the FULL sequence for its
                        head group)
        -- plain causal attention, no cross-shard bookkeeping --
        -- regroup: split the sequence, concatenate heads -->
    [B, S/n, H,   D]

Here one process drives the shards: the regroupings build each head
slice from every sequence slice's heads (and back), moving the pieces
with ``Tensor.to`` (a no-op when the shards share the one card, where
they run back to back). The head-sliced attention is the port's
``dense_causal_attention``, the correctness reference itself, so the
arithmetic cannot drift from it; the pieces move in their own dtype
(the upcast happens inside the attention).

Against the ring (kernels/ring_attention.py; ``EngineConfig.sp_attn``
picks): two regroupings whatever the axis size, every shard the same
work (the ring's causal skips leave early shards idle), but the scores
of a full sequence per head group (O(S^2 H/n)), and Hq and Hkv must
divide by the axis size (after the tp head split).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from tpu_inference_torch.kernels.ring_attention import (Shard,
                                                        seq_sharded_call)
from tpu_inference_torch.models.common import dense_causal_attention


def _seq_to_heads(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Sequence slices [B, S/n, H, D] -> head slices [B, S, H/n, D],
    head slice g on ``devices[g]``."""
    n = len(parts)
    h = parts[0].shape[2] // n
    return [torch.cat([p[:, :, g * h:(g + 1) * h].to(devices[g])
                       for p in parts], dim=1) for g in range(n)]


def _heads_to_seq(parts: List[torch.Tensor], devices) -> List[torch.Tensor]:
    """Head slices [B, S, H/n, D] -> sequence slices [B, S/n, H, D],
    sequence slice j on ``devices[j]``."""
    n = len(parts)
    c = parts[0].shape[1] // n
    return [torch.cat([p[:, j * c:(j + 1) * c].to(devices[j])
                       for p in parts], dim=2) for j in range(n)]


def ulysses_attention_local(shards: Sequence[Shard],
                            sliding_window: int = 0) -> List[torch.Tensor]:
    """Ulysses over ``shards`` (sequence slices, as ring_attention_local
    takes them). The local Hq and Hkv must divide by the shard count.
    Returns each shard's output [B, S_loc, Hq, D] in q's dtype."""
    n = len(shards)
    hq, hkv = shards[0][0].shape[2], shards[0][1].shape[2]
    if n == 1:
        q, k, v = shards[0]
        return [dense_causal_attention(q, k, v,
                                       sliding_window=sliding_window)]
    if hq % n or hkv % n:
        raise ValueError(f"ulysses needs head counts divisible by the sp "
                         f"axis: Hq={hq}, Hkv={hkv}, sp={n}")
    devs = [q.device for q, _, _ in shards]
    qg, kg, vg = (_seq_to_heads([s[i] for s in shards], devs)
                  for i in range(3))
    outs = [dense_causal_attention(qg[g], kg[g], vg[g],
                                   sliding_window=sliding_window)
            for g in range(n)]
    return _heads_to_seq(outs, devs)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      mesh, axis_name: str = "sp",
                      sliding_window: int = 0) -> torch.Tensor:
    """Full-sequence causal attention, the sequence split over
    ``axis_name`` of ``mesh`` (the call surface of ring_attention)."""
    return seq_sharded_call(ulysses_attention_local, q, k, v,
                            mesh.axis_devices(axis_name), sliding_window)
