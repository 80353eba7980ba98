"""Ring attention: causal attention with the sequence split over sp
shards (PyTorch twin of ``tpu_inference/kernels/ring_attention.py``).

The reference runs one program per device under ``shard_map``: each
device holds one contiguous sequence slice of Q, K and V, the K/V slices
rotate around the ring (``lax.ppermute``), and every device folds each
visiting chunk into flash-style online-softmax state for its local Q.

Here one process drives the shards (as parallel/tp.py drives the tp
shards): the sp slices are a list of ``(q_j, k_j, v_j)`` tuples, each on
its own device. At step i shard j holds chunk ``(j - i) mod sp``, which
reached it from shard j - 1 with ``Tensor.to`` (a no-op when both sit on
the one card, where the shards run back to back). A chunk wholly in the
causal future of a shard's queries, or wholly behind every one of their
windows, is skipped by a Python ``if`` on host-known positions: its
update would leave the state as it is.

This is plain PyTorch, as the reference is plain JAX: the TPU kernels of
the repo are the paged decode and prefill kernels (csrc/), which the
engine runs for every other prefill chunk and every decode step.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from tpu_inference_torch.models.common import repeat_kv

NEG_INF = -1e30

Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _block_attend(q, k, v, q_pos, k_pos, scale, n_rep, sliding_window=0):
    """One (local Q) x (visiting K/V chunk) block: masked scores and
    partial softmax stats. q: [B, Sq, Hq, D] float32; k/v: [B, Sk, Hkv, D]
    in their own dtype (the GQA expansion and the float32 upcast happen
    here, per block, so what moves between shards is the raw chunk).
    ``sliding_window`` > 0 also masks keys more than window-1 positions
    behind the query. Returns (m [B, H, Sq], l [B, H, Sq],
    o [B, Sq, H, D])."""
    k = repeat_kv(k, n_rep).float()
    v = repeat_kv(v, n_rep).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = k_pos[None, None, None, :] <= q_pos[None, None, :, None]
    if sliding_window:
        mask &= (k_pos[None, None, None, :]
                 > q_pos[None, None, :, None] - sliding_window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                   # [B, H, Sq]
    # exp(NEG_INF - NEG_INF) = 1 on fully masked rows; zero them by mask.
    pr = torch.exp(s - m[..., None]) * mask
    l = pr.sum(dim=-1)                                   # [B, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v)
    return m, l, o


def _skippable(src: int, j: int, s_loc: int, sliding_window: int) -> bool:
    """Whether chunk ``src`` adds nothing to shard ``j``'s queries: it
    lies wholly in their causal future, or wholly behind every one of
    their windows (its last key at or before the first query's position
    less the window)."""
    if src * s_loc > j * s_loc + s_loc - 1:
        return True
    return bool(sliding_window) and (
        src * s_loc + s_loc - 1 <= j * s_loc - sliding_window)


def ring_attention_local(shards: Sequence[Shard],
                         sliding_window: int = 0) -> List[torch.Tensor]:
    """The ring over ``shards``: shard j's ``(q_j, k_j, v_j)`` are the
    sequence slice ``[j * S_loc, (j + 1) * S_loc)``, q [B, S_loc, Hq, D],
    k/v [B, S_loc, Hkv, D], all on shard j's device. Returns each shard's
    output [B, S_loc, Hq, D] in q's dtype, on its device."""
    n = len(shards)
    b, s_loc, hq, d = shards[0][0].shape
    n_rep = hq // shards[0][1].shape[2]
    scale = 1.0 / (d ** 0.5)
    devs = [q.device for q, _, _ in shards]
    qf = [q.float() for q, _, _ in shards]
    local = [torch.arange(s_loc, dtype=torch.int32, device=dv) for dv in devs]
    q_pos = [j * s_loc + local[j] for j in range(n)]
    m = [torch.full((b, hq, s_loc), NEG_INF, dtype=torch.float32, device=dv)
         for dv in devs]
    l = [torch.zeros((b, hq, s_loc), dtype=torch.float32, device=dv)
         for dv in devs]
    acc = [torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=dv)
           for dv in devs]
    cur = [(k, v) for _, k, v in shards]     # raw dtype, Hkv heads
    for step in range(n):
        for j in range(n):
            src = (j - step) % n             # the chunk shard j now holds
            if _skippable(src, j, s_loc, sliding_window):
                continue
            k_pos = src * s_loc + local[j]
            m_blk, l_blk, o_blk = _block_attend(
                qf[j], cur[j][0], cur[j][1], q_pos[j], k_pos, scale, n_rep,
                sliding_window)
            m_new = torch.maximum(m[j], m_blk)
            a_prev = torch.exp(m[j] - m_new)
            a_blk = torch.exp(m_blk - m_new)
            l[j] = l[j] * a_prev + l_blk * a_blk
            acc[j] = (acc[j] * a_prev.transpose(1, 2)[..., None]
                      + o_blk * a_blk.transpose(1, 2)[..., None])
            m[j] = m_new
        if step != n - 1:
            # The rotation: shard j receives shard j - 1's chunk.
            cur = [(cur[(j - 1) % n][0].to(devs[j]),
                    cur[(j - 1) % n][1].to(devs[j])) for j in range(n)]
    return [(acc[j] / l[j].transpose(1, 2)[..., None].clamp_min(1e-20))
            .to(shards[j][0].dtype) for j in range(n)]


def seq_sharded_call(body: Callable, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, devices: Sequence,
                     sliding_window: int = 0) -> torch.Tensor:
    """Split q/k/v [B, S, H, D] into ``len(devices)`` sequence slices,
    slice j on ``devices[j]``, run ``body`` over the shard list, and
    concatenate its outputs on q's device. Used by ring and Ulysses."""
    n = len(devices)
    s = q.shape[1]
    if s % n:
        raise ValueError(f"sequence length {s} is not divisible by the sp "
                         f"axis size {n}")
    c = s // n
    shards = [tuple(t[:, j * c:(j + 1) * c].to(devices[j])
                    for t in (q, k, v)) for j in range(n)]
    outs = body(shards, sliding_window=sliding_window)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh, axis_name: str = "sp",
                   sliding_window: int = 0) -> torch.Tensor:
    """Full-sequence causal attention, the sequence split over
    ``axis_name`` of ``mesh`` (parallel/mesh.py). q: [B, S, Hq, D];
    k/v: [B, S, Hkv, D] with S divisible by the axis size.
    ``sliding_window`` > 0 applies the SWA mask (Mistral-style)."""
    return seq_sharded_call(ring_attention_local, q, k, v,
                            mesh.axis_devices(axis_name), sliding_window)
