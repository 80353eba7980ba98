"""Paged decode attention: the Hopper kernel, its plain version, and its
launch counts.

Replaces ``tpu_inference/kernels/paged_attention.py`` (``_decode_kernel``
via ``paged_attention``): one query token per sequence attends over its
KV pages in the pool, followed through ``block_tables`` (page 0 = trash
page), online softmax in float32, positions ``>= kv_len`` masked, GQA
folded in, optional sliding window. The pool holds q's float dtype, or
int8 codes, or uint8 nibble-packed int4 codes, the last two with
per-(token, head) float32 scales that the kernel applies as it converts
the codes (kernels/_pool.py has the operand rules). The CUDA source
is ``csrc/paged_attention.cu``; its header comment says what bounds it
on the H100 and how its split-KV design answers that.

``paged_attention`` launches the kernel for CUDA tensors (building it on
first use) and raises if it cannot; for CPU tensors it runs
``paged_attention_plain``, the same function written out step by step in
PyTorch. ``split_plan`` is the host's split of each sequence's pages
across blocks, from the table width, page size and window alone. ``launches`` counts kernel launches
(one per layer per decode step; the merge of a call's splits happens
inside that launch) and nothing else; ``launches_by_variant`` splits
them by pool kind (``f32``, ``bf16``, ``int8``, ``int4``) and
``launches_by_batch`` by batch width (the decode ladder's rungs) and
``launches_by_heads`` by ``"Hq/Hkv"`` (a tp shard's head counts).
Inside ``recording()`` (a CUDA graph's capture) launches are listed,
not counted; ``count_launches`` counts such a list once per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Iterator, List, Optional, Tuple

import torch

from tpu_inference_torch.engine.kv_cache import gather_pages
from tpu_inference_torch.kernels import _build, _pool

NEG_INF = -1e30
launches = 0
launches_by_variant = dict.fromkeys(_pool.VARIANTS, 0)
launches_by_batch: dict = {}
launches_by_heads: dict = {}

# Tokens per split: the split plan cuts the readable pages into
# MIN_SPLIT_TOKENS-token pieces (the last may be shorter).
MIN_SPLIT_TOKENS = 256

_lib = None
# (device index, stream) -> int32 split counters. They must start at 0;
# every launch leaves them at 0 (the last block of each (sequence,
# kv-head) resets its own), so one zeroed buffer serves every launch on
# that stream, and a CUDA graph can capture the call.
_counters: dict = {}
# The launches of the capture under way: (variant, batch, "Hq/Hkv").
_recording: Optional[List[tuple]] = None


def reset_counts() -> None:
    """Set ``launches`` and every per-variant and per-batch count to 0."""
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0
    launches_by_batch.clear()
    launches_by_heads.clear()


@contextlib.contextmanager
def recording() -> Iterator[List[tuple]]:
    """List the launches made inside the block (a graph capture, whose
    launches run only when it is replayed) instead of counting them."""
    global _recording
    _recording = listed = []
    try:
        yield listed
    finally:
        _recording = None


def count_launches(times: dict) -> None:
    """Count launches by key (variant, batch, "Hq/Hkv"): ``times`` maps
    each to its number (one replay: the Counter of a ``recording``)."""
    global launches
    for (variant, b, heads), n in times.items():
        launches += n
        launches_by_variant[variant] += n
        launches_by_batch[b] = launches_by_batch.get(b, 0) + n
        launches_by_heads[heads] = launches_by_heads.get(heads, 0) + n


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("paged_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
            i, i, i, i, ctypes.c_float, i, i, vp]
        lib.paged_decode_attention.restype = i
        _lib = lib
    return _lib


def split_plan(max_pages: int, page_size: int,
               sliding_window: int = 0) -> Tuple[int, int]:
    """``(num_splits, pages_per_split)`` of the decode kernel's grid,
    from the table width, the page size and the window alone: never from
    the batch (a lane's split boundaries, and so the order in which its
    partials merge, are the same at every batch width, so its output row
    is bit-identical at every ladder rung) and never from ``kv_len``
    (which lives on the device).

    Split s of a sequence owns pages ``[first + s * pps, first + (s + 1)
    * pps)``, where ``first`` is 0, or the window's first page under a
    sliding window. The splits cover the pages a call can read: all
    ``max_pages``, or at most ``ceil(window / page_size) + 1`` under a
    window, in ``MIN_SPLIT_TOKENS``-token pieces; no split is empty of
    pages (the last may be shorter). The grid grows with the batch. A
    split past a sequence's ``kv_len`` reads nothing: the kernel counts
    the non-empty splits from ``kv_len`` on the device.
    """
    span = max_pages
    if sliding_window > 0:
        span = min(span, -(-sliding_window // page_size) + 1)
    span = max(span, 1)
    pps = min(span, max(1, -(-MIN_SPLIT_TOKENS // page_size)))
    return -(-span // pps), pps


def _split_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros kept for (device, stream)."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          kv_len: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          sliding_window: int = 0) -> torch.Tensor:
    """Gather each sequence's pages (dequantized after the gather, as
    engine/kv_cache.py gather_kv does), mask, softmax in float32. Same
    contract as ``paged_attention``; rows with no valid key output 0."""
    b, hq, d = q.shape
    pg, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = block_tables.shape[1]
    n_rep = hq // hkv
    # Gather: page ids clamp into the pool (the kernel's bounds check).
    k = gather_pages(k_pages, k_scale, block_tables).float()
    v = gather_pages(v_pages, v_scale, block_tables).float()
    qg = q.float().reshape(b, hkv, n_rep, d)
    scores = torch.einsum("bhrd,bthd->bhrt", qg, k) / math.sqrt(d)
    pos = torch.arange(mp * pg, device=q.device)[None, :]
    lens = kv_len.long()[:, None]
    valid = pos < lens
    if sliding_window:
        valid &= pos >= lens - sliding_window
    valid = valid[:, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhrt,bthd->bhrd", p, v) / denom
    return out.reshape(b, hq, d).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    kv_len: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    sliding_window: int = 0) -> torch.Tensor:
    """Decode attention over one layer's paged pool.

    q:            [B, Hq, D]   (one query token per sequence)
    k/v_pages:    [P, page_size, Hkv, D] in q's dtype (float32 or
                  bfloat16), or int8 codes, or uint8 packed int4 codes
                  [P, page_size, Hkv, D/2]
    block_tables: [B, MP] int32 physical page ids (0 = trash page)
    kv_len:       [B] int32 valid tokens per sequence (incl. current)
    k/v_scale:    [P, page_size, Hkv] float32, given exactly when the
                  pool is int8 or packed int4
    sliding_window > 0: only the last ``sliding_window`` positions count,
    and only their pages are read.
    Returns [B, Hq, D] in q.dtype.
    """
    variant = _pool.check_pool("paged_attention", q, k_pages, v_pages,
                               k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     kv_len, k_scale, v_scale,
                                     sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    num_pages, pg, hkv, _ = k_pages.shape
    if (block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or kv_len.shape != (b,)):
        raise ValueError("paged_attention: block_tables [B, MP] and kv_len "
                         "[B] must be int32")
    _pool.check_kernel_alignment("paged_attention", variant, k_pages,
                                 v_pages)
    tensors = [q, k_pages, v_pages, block_tables, kv_len]
    tensors += [t for t in (k_scale, v_scale) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous")
    out = torch.empty_like(q)
    if b == 0:
        return out
    mp = block_tables.shape[1]
    ns, pps = split_plan(mp, pg, int(sliding_window))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = counters = None
    if ns > 1:   # per-split partials, merged by each slot's last block
        part_acc = torch.empty((b, hq, ns, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hq, ns, 2), dtype=torch.float32,
                              device=q.device)
        # One counter per (sequence, kv-head, row group); b * hq bounds
        # that for any grouping of a kv-head's query rows.
        counters = _split_counters(q.device, stream, b * hq)
    lib = _library()
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        counters.data_ptr() if counters is not None else None,
        _pool.Q_DTYPE_CODES[q.dtype], _pool.KV_KINDS[variant], b, hq, hkv,
        d, num_pages, pg, mp, int(sliding_window), 1.0 / math.sqrt(d), ns,
        pps, stream)
    _build.check(lib, err, "paged_attention")
    key = (variant, b, f"{hq}/{hkv}")
    if _recording is not None:
        _recording.append(key)
    else:
        count_launches({key: 1})
    return out
