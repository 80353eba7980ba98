"""Paged decode attention: the Hopper kernel, its plain version, and its
launch count.

Replaces ``tpu_inference/kernels/paged_attention.py`` (``_decode_kernel``
via ``paged_attention``): one query token per sequence attends over its
KV pages in the pool, followed through ``block_tables`` (page 0 = trash
page), online softmax in float32, positions ``>= kv_len`` masked, GQA
folded in, optional sliding window. The CUDA source is
``csrc/paged_attention.cu``; its header comment says what bounds it on
the H100 and how its design answers that.

``paged_attention`` launches the kernel for CUDA tensors (building it on
first use) and raises if it cannot; for CPU tensors it runs
``paged_attention_plain``, the same function written out step by step in
PyTorch. ``launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_inference_torch.kernels import _build

NEG_INF = -1e30
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("paged_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_decode_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
            ctypes.c_float, vp]
        lib.paged_decode_attention.restype = i
        _lib = lib
    return _lib


def paged_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_tables: torch.Tensor,
                          kv_len: torch.Tensor,
                          sliding_window: int = 0) -> torch.Tensor:
    """Gather each sequence's pages, mask, softmax in float32. Same
    contract as ``paged_attention``; rows with no valid key output 0."""
    b, hq, d = q.shape
    num_pages, pg, hkv, _ = k_pages.shape
    mp = block_tables.shape[1]
    n_rep = hq // hkv
    # Gather: page ids clamp into the pool (the kernel's bounds check).
    idx = block_tables.long().clamp(0, num_pages - 1)
    k = k_pages[idx].reshape(b, mp * pg, hkv, d).float()
    v = v_pages[idx].reshape(b, mp * pg, hkv, d).float()
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
                    sliding_window: int = 0) -> torch.Tensor:
    """Decode attention over one layer's paged pool.

    q:            [B, Hq, D]   (one query token per sequence)
    k/v_pages:    [P, page_size, Hkv, D], q's dtype (float32 or bfloat16)
    block_tables: [B, MP] int32 physical page ids (0 = trash page)
    kv_len:       [B] int32 valid tokens per sequence (incl. current)
    sliding_window > 0: only the last ``sliding_window`` positions count,
    and only their pages are read.
    Returns [B, Hq, D] in q.dtype.
    """
    global launches
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     kv_len, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, hq, d = q.shape
    num_pages, pg, hkv, dk = k_pages.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_attention: dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q and the pools must share a dtype")
    if v_pages.shape != k_pages.shape or dk != d or hq % hkv:
        raise ValueError(f"paged_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, v {tuple(v_pages.shape)}")
    if (block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or kv_len.shape != (b,)):
        raise ValueError("paged_attention: block_tables [B, MP] and kv_len "
                         "[B] must be int32")
    vec = 16 // q.element_size()
    if d % vec:
        raise ValueError(f"paged_attention: head_dim {d} must be a "
                         f"multiple of {vec} for 16-byte page loads")
    tensors = (q, k_pages, v_pages, block_tables, kv_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all operands on one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_attention: pools must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0:
        return out
    lib = _library()
    err = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, hq, hkv, d, num_pages, pg,
        block_tables.shape[1], int(sliding_window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "paged_attention")
    launches += 1
    return out
