"""Paged prefill attention: the Hopper kernel, its plain version, and its
launch counts.

Replaces ``tpu_inference/kernels/prefill_attention.py``
(``_prefill_kernel`` via ``paged_prefill_attention``): a chunk of S
queries at absolute positions ``q_offset[b] + i`` attends over pool pages
holding the cached prefix plus the chunk's own KV (written before the
call). One fused mask: causal, ``< kv_len``, and the sliding window;
rows with no valid key output 0. The pool holds q's float dtype, int8
codes, or uint8 nibble-packed int4 codes, the last two with
per-(token, head) float32 scales (kernels/_pool.py). The CUDA source is
``csrc/prefill_attention.cu``; its header comment says what bounds it on
the H100 and how its design answers that. ``prefill_plan`` picks one
of its four paths from the shapes: bf16 q at head_dim 64 or 128 runs
the warp-specialized wgmma kernel ("wgmma") when its rows fill a
128-row tile on a bf16 pool, and always on a quantized pool; other bf16
calls (short chunks and verify rounds on a bf16 pool, other head dims)
run the mma.sync kernel ("mma"), float32 q a
register-tiled CUDA-core kernel ("simt"), head dims above 256 a per-page
CUDA-core kernel ("wide").

``paged_prefill_attention`` launches the planned kernel for CUDA tensors
(building it on first use) and raises if it cannot; for CPU tensors it
runs ``paged_prefill_attention_plain``. ``launches`` counts kernel
launches and nothing else; ``launches_by_variant`` splits them by pool
kind, ``launches_by_path`` by pool kind and path (``"bf16/wgmma"``) and
``launches_by_len`` by query length S (prompt chunks at the prefill
buckets, speculative verify rounds at S = γ+1 and the 2-wide probe), and
``launches_by_heads`` by ``"Hq/Hkv"`` (a tp shard's head counts).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from tpu_inference_torch.engine.kv_cache import gather_pages
from tpu_inference_torch.kernels import _build, _pool

NEG_INF = -1e30
# The kernels' paths and their codes (csrc/prefill_attention.cu Path).
PATHS = {"simt": 0, "mma": 1, "wgmma": 2, "wide": 3}
# Rows (S x n_rep) from which bf16 q takes the wgmma path, by pool kind
# (chip_smoke.py threshold_cases times both paths; PERF.md section 6):
# on a bf16 pool one full 128-row tile, below which verify rounds at
# B 32 run faster on the 64-row mma kernel; on quantized pools every
# call, the wgmma path being faster at every shape measured but int8's
# B 32 verify rounds, where the two are within 3%.
WGMMA_MIN_ROWS = {"bf16": 128, "int8": 1, "int4": 1}
WGMMA_HEAD_DIMS = (64, 128)
# Tile rows of each path (the wide path's are 64 // n_rep queries).
TILE_ROWS = {"simt": 64, "mma": 64, "wgmma": 128}

launches = 0
launches_by_variant = dict.fromkeys(_pool.VARIANTS, 0)
launches_by_path: dict = {}
launches_by_len: dict = {}
launches_by_heads: dict = {}

_lib = None


def reset_counts() -> None:
    """Set ``launches`` and every per-variant and per-length count to
    0."""
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0
    launches_by_path.clear()
    launches_by_len.clear()
    launches_by_heads.clear()


def prefill_plan(s: int, n_rep: int, d: int, variant: str,
                 q_dtype: torch.dtype) -> dict:
    """The kernel path for a call, from its shapes alone: S, n_rep, the
    head dim, the pool kind (``_pool.VARIANTS``) and q's dtype. Never the
    batch or ``kv_len``, so a lane's rows come out the same whichever
    batch it rides in; never the page size either, since every path
    follows the block table one key row at a time. Returns ``{"path",
    "code", "tile_rows"}``; the C entry point refuses a path that does
    not fit its operands and never picks another."""
    # A float pool is q's type.
    f32 = q_dtype == torch.float32
    if (variant not in _pool.KV_KINDS or q_dtype not in _pool.Q_DTYPE_CODES
            or variant in ("f32", "bf16") and (variant == "f32") != f32):
        raise ValueError(f"prefill_plan: pool kind {variant!r} with q "
                         f"{q_dtype}")
    if d > 256:
        path = "wide"
    elif f32:
        path = "simt"
    elif d in WGMMA_HEAD_DIMS and s * n_rep >= WGMMA_MIN_ROWS[variant]:
        path = "wgmma"
    else:
        path = "mma"
    rows = TILE_ROWS.get(path, max(1, 64 // n_rep) * n_rep)
    return {"path": path, "code": PATHS[path], "tile_rows": rows}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("prefill_attention")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_prefill_attention.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i,
            i, i, i, ctypes.c_float, vp]
        lib.paged_prefill_attention.restype = i
        _lib = lib
    return _lib


def paged_prefill_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  kv_len: torch.Tensor,
                                  q_offset: torch.Tensor,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None,
                                  sliding_window: int = 0) -> torch.Tensor:
    """Gather each sequence's pages (dequantized after the gather, as
    engine/kv_cache.py gather_kv does), apply the fused mask, softmax in
    float32. Same contract as ``paged_prefill_attention``."""
    b, s, hq, d = q.shape
    pg, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = block_tables.shape[1]
    n_rep = hq // hkv
    k = gather_pages(k_pages, k_scale, block_tables).float()
    v = gather_pages(v_pages, v_scale, block_tables).float()
    qg = q.float().reshape(b, s, hkv, n_rep, d)
    scores = torch.einsum("bshrd,bthd->bhrst", qg, k) / math.sqrt(d)
    dev = q.device
    q_pos = q_offset.long()[:, None] + torch.arange(s, device=dev)[None]
    k_pos = torch.arange(mp * pg, device=dev)[None, None, :]
    q_pos = q_pos[:, :, None]                                 # [B, S, 1]
    valid = (k_pos <= q_pos) & (k_pos < kv_len.long()[:, None, None])
    if sliding_window:
        valid &= k_pos > q_pos - sliding_window
    valid = valid[:, None, None]                              # [B,1,1,S,T]
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("bhrst,bthd->bshrd", p / denom, v)
    return out.reshape(b, s, hq, d).to(q.dtype)


def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            kv_len: torch.Tensor, q_offset: torch.Tensor,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            sliding_window: int = 0) -> torch.Tensor:
    """Prefill attention over one layer's paged pool.

    q:            [B, S, Hq, D]  (the current chunk's queries)
    k/v_pages:    [P, page_size, Hkv, D] in q's dtype (float32 or
                  bfloat16), or int8 codes, or uint8 packed int4 codes
                  [P, page_size, Hkv, D/2]; the chunk's own KV is
                  already written
    block_tables: [B, MP] int32 physical page ids (0 = trash page)
    kv_len:       [B] int32 total valid tokens (cached prefix + chunk)
    q_offset:     [B] int32 absolute position of q[:, 0]
    k/v_scale:    [P, page_size, Hkv] float32, given exactly when the
                  pool is int8 or packed int4
    Returns [B, S, Hq, D] in q.dtype.
    """
    variant = _pool.check_pool("paged_prefill_attention", q, k_pages,
                               v_pages, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pages, v_pages,
                                             block_tables, kv_len, q_offset,
                                             k_scale, v_scale,
                                             sliding_window)
    b, s, hq, d = q.shape
    plan = prefill_plan(s, hq // k_pages.shape[2], d, variant, q.dtype)
    return _launch(plan, q, k_pages, v_pages, block_tables, kv_len,
                   q_offset, k_scale, v_scale, sliding_window)


def _launch(plan: dict, q: torch.Tensor, k_pages: torch.Tensor,
            v_pages: torch.Tensor, block_tables: torch.Tensor,
            kv_len: torch.Tensor, q_offset: torch.Tensor,
            k_scale: Optional[torch.Tensor], v_scale: Optional[torch.Tensor],
            sliding_window: int) -> torch.Tensor:
    """Launch ``plan``'s kernel on CUDA operands (checked here; chip_smoke
    also calls it with another path forced to time both sides of the
    plan's threshold)."""
    global launches
    variant = _pool.check_pool("paged_prefill_attention", q, k_pages,
                               v_pages, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    b, s, hq, d = q.shape
    num_pages, pg, hkv, _ = k_pages.shape
    if (any(t.dtype != torch.int32 for t in (block_tables, kv_len, q_offset))
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or kv_len.shape != (b,) or q_offset.shape != (b,)):
        raise ValueError("paged_prefill_attention: block_tables [B, MP], "
                         "kv_len [B] and q_offset [B] must be int32")
    if b > 65535:
        raise ValueError("paged_prefill_attention: batch above 65535")
    _pool.check_kernel_alignment("paged_prefill_attention", variant, k_pages,
                                 v_pages)
    tensors = [q, k_pages, v_pages, block_tables, kv_len, q_offset]
    tensors += [t for t in (k_scale, v_scale) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_prefill_attention: all operands on one "
                         "device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_prefill_attention: operands must be "
                         "contiguous")
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    if q.data_ptr() % 16:   # the kernel copies q rows 16 bytes at a time
        q = q.clone()
    lib = _library()
    err = lib.paged_prefill_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        block_tables.data_ptr(), kv_len.data_ptr(), q_offset.data_ptr(),
        out.data_ptr(), _pool.Q_DTYPE_CODES[q.dtype],
        _pool.KV_KINDS[variant], plan["code"], b, s, hq, hkv, d, num_pages,
        pg, block_tables.shape[1], int(sliding_window), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, f"paged_prefill_attention ({plan['path']})")
    launches += 1
    launches_by_variant[variant] += 1
    key = f"{variant}/{plan['path']}"
    launches_by_path[key] = launches_by_path.get(key, 0) + 1
    launches_by_len[s] = launches_by_len.get(s, 0) + 1
    heads = f"{q.shape[2]}/{k_pages.shape[2]}"
    launches_by_heads[heads] = launches_by_heads.get(heads, 0) + 1
    return out
