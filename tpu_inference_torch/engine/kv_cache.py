"""Paged KV cache: a device block pool with per-sequence block tables.

Twin of the device half of ``tpu_inference/engine/kv_cache.py`` plus its
``PageAllocator``:

- Device side: one pool per K and V, ``[L, P, page, Hkv, D]``. Page 0 is
  the reserved **trash page**: padded / inactive token slots write there,
  so every write has a valid target and no branching.
- Sequences address the pool through **block tables** ``[B, max_pages]``
  (int32 page ids, 0-filled), rebuilt on the host per dispatch.
- Writes go through flat slots (token -> page*page_size + offset). The
  reference donates the pool buffers to each jitted step so XLA updates
  them in place; here ``write_kv`` updates the pool tensors in place
  directly (one ``index_copy_`` per pool on a flattened view), which is
  what the donation achieved.
- Reads gather a sequence's pages into a contiguous view for the dense
  path; the Hopper kernels (kernels/) read pages where they lie.
- Quantized pools (int8 codes, or uint8 nibble-packed int4, with
  per-(token, head) float32 scales) quantize on write in plain PyTorch,
  as the reference does in XLA outside its kernels; codes and scales
  are byte-identical to the reference's (tests/test_torch_kv_quant.py).

Host side, ``PageAllocator`` is a free-list with refcounts so shared
prompt prefixes map the same physical pages.

Tensor parallelism: ``ShardedKVPages`` splits the pool over its kv heads,
one ``KVPages`` per tp shard; page ids, block tables and slots are the
same for every shard, and its host copies (``offload_pages``) keep the
full-head layout, so the host tier and the wire format below do not
change with tp.

Host tier (the tiered KV cache): ``offload_pages`` copies pool pages
into pinned host memory and ``restore_pages`` scatters host copies back
into freshly allocated pool pages, both as non-blocking copies on the
current stream; ``HostPagePool`` does the tier's capacity accounting.
The copies move the pool's stored bytes (float elements, int8 codes or
packed int4 codes, with their float32 scales), so every pool kind
round-trips bit-identically.

Migration wire format (the process fleet's drain-time KV migration):
``serialize_host_pages`` packs host pages into the reference's blob,
byte for byte (``[u32 header_len][json header][raw k|v|k_scale|v_scale
per page]``, the header's ``crc32c`` over the page bytes), and
``deserialize_host_pages`` / ``verify_host_pages_blob`` read and check
it. bfloat16 has no numpy dtype: its bytes are written through a byte
view and the header still names it ``"bfloat16"``.
"""

from __future__ import annotations

import json
import struct
import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

import torch

from tpu_inference_torch import integrity
from tpu_inference_torch.config import EngineConfig, ModelConfig


class KVPages(NamedTuple):
    """Device-side KV pool. k, v: [L, num_pages, page_size, Hkv, head_dim].

    With KV quantization (EngineConfig.kv_quant) k/v hold int8 codes and
    ``k_scale``/``v_scale`` per-(token, kv-head) float32 scales
    ``[L, num_pages, page_size, Hkv]``: symmetric quantization over
    head_dim. With "int4" k/v hold **uint8 nibble-packed** codes
    ``[..., head_dim // 2]``: byte i carries code i (low nibble) and code
    i + head_dim/2 (high nibble), so unpacking is a concat. The mode is
    carried by the pool dtype (uint8 = packed int4, int8 = int8), as in
    the reference. ``None`` scales = unquantized pool. Dequantization
    happens where the pool is read: in the kernels' page loads, and after
    the gather on the dense path.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def packed_int4(self) -> bool:
        return self.k.dtype == torch.uint8


class ShardedKVPages:
    """A pool split over its kv heads: one KVPages per tp shard, shard i
    holding heads ``[i * Hkv/tp, (i + 1) * Hkv/tp)`` on its shard's
    device. Page ids, block tables and slot maps are the same for every
    shard (one PageAllocator serves them all); host copies of its pages
    (``offload_pages``) keep the full-head layout."""

    def __init__(self, shards):
        self.shards = tuple(shards)

    @property
    def quantized(self) -> bool:
        return self.shards[0].quantized


def alloc_kv_pages(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                   dtype=None, device="cuda", sharding=None):
    """The zeroed pool ``[L, P, page, Hkv, D]``. With ``sharding`` (a
    parallel/shardings.py ``kv_sharding`` of a tp > 1 mesh) one pool per
    tp shard with ``Hkv / tp`` heads on that shard's device, bundled in a
    ShardedKVPages; ``device`` is then unused."""
    if sharding is not None and sharding.mesh.shape["tp"] > 1:
        devices = sharding.mesh.tp_devices()
        n = len(devices)
        if model_cfg.n_kv_heads % n:
            raise ValueError(f"tp={n} does not divide n_kv_heads="
                             f"{model_cfg.n_kv_heads}")
        return ShardedKVPages(
            _alloc_pool(model_cfg, engine_cfg, model_cfg.n_kv_heads // n,
                        dtype, d) for d in devices)
    return _alloc_pool(model_cfg, engine_cfg, model_cfg.n_kv_heads, dtype,
                       device)


def _alloc_pool(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                n_kv_heads: int, dtype, device) -> KVPages:
    shape = (model_cfg.n_layers, engine_cfg.num_pages, engine_cfg.page_size,
             n_kv_heads, model_cfg.head_dim)
    dtype = dtype or model_cfg.dtype
    mode = engine_cfg.kv_quant
    if mode not in ("none", "int8", "int4"):
        raise ValueError(f"unknown kv_quant mode {mode!r}; "
                         "one of ('none', 'int8', 'int4')")
    if mode == "int4" and model_cfg.head_dim % 2:
        raise ValueError("kv_quant='int4' needs an even head_dim to "
                         f"nibble-pack, got {model_cfg.head_dim}")
    if mode == "none":
        return KVPages(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))
    code_dtype = torch.uint8 if mode == "int4" else torch.int8
    code_shape = shape[:-1] + (
        shape[-1] // 2 if mode == "int4" else shape[-1],)

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    return KVPages(k=zeros(code_shape, code_dtype),
                   v=zeros(code_shape, code_dtype),
                   k_scale=zeros(shape[:-1], torch.float32),
                   v_scale=zeros(shape[:-1], torch.float32))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 over head_dim.

    x: [B, S, Hkv, D] -> (codes int8 [B,S,Hkv,D], scale f32 [B,S,Hkv]).
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_kv_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int4 over head_dim, nibble-packed.

    x: [B, S, Hkv, D] -> (packed uint8 [B,S,Hkv,D//2], scale f32
    [B,S,Hkv]). Codes live in [-7, 7]; byte i = code i (low nibble) |
    code i+D/2 (high nibble), so unpacking is a concat along D.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 7.0
    q = torch.round(xf / scale[..., None]).clamp(-7, 7).to(torch.int32)
    half = x.shape[-1] // 2
    lo, hi = q[..., :half], q[..., half:]
    packed = ((hi << 4) | (lo & 0xF)) & 0xFF
    return packed.to(torch.uint8), scale


def unpack_int4_kv(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibble-packed codes [..., D//2] -> int32 codes [..., D], by
    compare/select sign extension (the reference's contract)."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.cat([lo, hi], dim=-1)


def slot_mapping(block_tables: torch.Tensor, positions: torch.Tensor,
                 valid: torch.Tensor, page_size: int) -> torch.Tensor:
    """Map absolute token positions to flat pool slots.

    block_tables: [B, max_pages]; positions: [B, S]; valid: [B, S] bool.
    Invalid tokens map to slot 0 (the trash page). Returns [B, S] int64.
    Callers clamp positions below max_context, so the page column is in
    range; it is clamped here as well, as the reference's gather clamps.
    """
    page_of_pos = (positions // page_size).clamp(0, block_tables.shape[1] - 1)
    page_ids = torch.gather(block_tables.long(), 1, page_of_pos.long())
    slots = page_ids * page_size + positions % page_size
    return torch.where(valid, slots, torch.zeros_like(slots)).long()


def write_kv(kv: KVPages, layer_idx: int, k_new: torch.Tensor,
             v_new: torch.Tensor, slots: torch.Tensor) -> KVPages:
    """Write new K/V ([B, S, Hkv, D]) into the pool at flat ``slots``
    [B, S], in place. Quantized pools quantize on the way in (codes and
    per-token-head scales to the same flat slots). Several invalid
    tokens may share slot 0; the trash page's contents (codes and scales
    alike) are unspecified and only ever read under a mask, as in the
    reference."""
    L, P, pg, H, Dp = kv.k.shape
    flat = slots.reshape(-1)
    if kv.quantized:
        qfn = quantize_kv_int4 if kv.packed_int4 else quantize_kv
        k_new, ks = qfn(k_new)
        v_new, vs = qfn(v_new)
        for pool, s in ((kv.k_scale, ks), (kv.v_scale, vs)):
            pool[layer_idx].view(P * pg, H).index_copy_(
                0, flat, s.reshape(-1, H))
    for pool, new in ((kv.k, k_new), (kv.v, v_new)):
        pool[layer_idx].view(P * pg, H, Dp).index_copy_(
            0, flat, new.reshape(-1, H, Dp).to(pool.dtype))
    return kv


def gather_pages(pages: torch.Tensor, scale: Optional[torch.Tensor],
                 block_tables: torch.Tensor) -> torch.Tensor:
    """One layer's pool ``[P, pg, Hkv, d_pool]`` gathered by
    ``block_tables`` [B, MP] into [B, MP*pg, Hkv, D]. Page ids clamp into
    the pool (the kernels' bounds check). A quantized pool (``scale``
    [P, pg, Hkv] given) unpacks int4 and dequantizes to float32 after the
    gather; a float pool keeps its dtype."""
    b, mp = block_tables.shape
    num_pages, pg, hkv, d_pool = pages.shape
    idx = block_tables.long().clamp(0, num_pages - 1)
    x = pages[idx].reshape(b, mp * pg, hkv, d_pool)
    if pages.dtype == torch.uint8:
        x = unpack_int4_kv(x)
    if scale is not None:
        x = x.float() * scale[idx].reshape(b, mp * pg, hkv)[..., None]
    return x


def gather_kv(kv: KVPages, layer_idx: int, block_tables: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each sequence's pages into contiguous [B, max_pages*pg, H,
    head_dim]; quantized pools come back dequantized in float32."""
    ks = kv.k_scale[layer_idx] if kv.quantized else None
    vs = kv.v_scale[layer_idx] if kv.quantized else None
    return (gather_pages(kv.k[layer_idx], ks, block_tables),
            gather_pages(kv.v[layer_idx], vs, block_tables))


class PageAllocator:
    """Host-side free-list allocator with refcounts (prefix sharing).

    Page 0 is reserved as the trash page and never allocated."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs = [0] * num_pages
        self._cached = [False] * num_pages
        # Pages held ONLY by the prefix cache (refs == 1 and cached).
        self.evictable_count = 0
        # Observer fired on every evictability flip: (page, became).
        self.on_evictable = None
        self.pages_allocated_total = 0
        self.pages_freed_total = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    def _flip_evictable(self, page: int, up: bool) -> None:
        self.evictable_count += 1 if up else -1
        if self.on_evictable is not None:
            self.on_evictable(page, up)

    def mark_cached(self, page: int) -> None:
        """Flag a page as prefix-cache-held (cache owns one of its refs)."""
        assert self._refs[page] > 0 and not self._cached[page]
        self._cached[page] = True
        if self._refs[page] == 1:
            self._flip_evictable(page, True)

    def unmark_cached(self, page: int) -> None:
        assert self._cached[page]
        self._cached[page] = False
        if self._refs[page] == 1:
            self._flip_evictable(page, False)

    def allocate(self, n: int = 1) -> List[int]:
        if len(self._free) < n:
            raise MemoryError(f"KV pool exhausted: need {n}, "
                              f"have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.pages_allocated_total += n
        return pages

    def share(self, page: int) -> int:
        """Increment refcount for a prefix-shared page."""
        assert self._refs[page] > 0
        self._refs[page] += 1
        if self._cached[page] and self._refs[page] == 2:
            self._flip_evictable(page, False)
        return page

    def refcount(self, page: int) -> int:
        return self._refs[page]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p == 0:
                continue
            assert self._refs[p] > 0, f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self.pages_freed_total += 1
            elif self._refs[p] == 1 and self._cached[p]:
                self._flip_evictable(p, True)


def pages_needed(n_tokens: int, page_size: int, already: int = 0) -> int:
    """Pages to add so a sequence of ``already`` tokens can hold n_tokens
    more."""
    total = -(-(already + n_tokens) // page_size)
    have = -(-already // page_size)
    return max(0, total - have)


# ---------------------------------------------------------------------------
# Host tier: device <-> host page copies.
# ---------------------------------------------------------------------------


class HostKVPage(NamedTuple):
    """Host copy of ONE pool page in the pool's stored layout: k/v
    ``[L, page_size, Hkv, d_pool]`` in the pool dtype, scales ``[L,
    page_size, Hkv]`` float32 or None. Copied from a CUDA pool the
    tensors are pinned and own their bytes."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        n = sum(t.numel() * t.element_size() for t in (self.k, self.v))
        if self.k_scale is not None:
            n += sum(t.numel() * t.element_size()
                     for t in (self.k_scale, self.v_scale))
        return n


# Pages per swap batch: demotes evict at least this many pages at once,
# so steady churn shares one round of copies (the reference's gather
# width; here copies take any width).
SWAP_CHUNK = 8


def _index(pages: List[int], device) -> torch.Tensor:
    """Page ids as an int64 tensor on ``device``; for a CUDA pool the
    ids go through pinned memory and a non-blocking copy, so staging
    them never waits for the work already queued on the stream."""
    idx = torch.from_numpy(np.asarray(pages, np.int64))
    if torch.device(device).type != "cuda":
        return idx
    return idx.pin_memory().to(device, non_blocking=True)


def _pool_arrays(kv: KVPages) -> List[torch.Tensor]:
    out = [kv.k, kv.v]
    if kv.quantized:
        out += [kv.k_scale, kv.v_scale]
    return out


# The head dim of every pool array ([L, P, page, Hkv, ...]) and of the
# gathered batch ([L, n, page, Hkv, ...]).
_HEAD_DIM = 3


def _gather_pages(kv, pages: List[int]) -> List[torch.Tensor]:
    """Each pool array's ``pages`` as [L, n, page, Hkv, ...] on the
    (first shard's) device; a sharded pool's shards concatenate along
    the head dim, so the result has the full-head layout."""
    if not isinstance(kv, ShardedKVPages):
        idx = _index(pages, kv.k.device)
        return [pool.index_select(1, idx) for pool in _pool_arrays(kv)]
    home = kv.shards[0].k.device
    idx = {}
    per_shard = []
    for shard in kv.shards:
        dev = shard.k.device
        if dev not in idx:
            idx[dev] = _index(pages, dev)
        per_shard.append([pool.index_select(1, idx[dev]).to(home)
                          for pool in _pool_arrays(shard)])
    return [torch.cat(parts, dim=_HEAD_DIM) for parts in zip(*per_shard)]


def _scatter_pages(kv, pages: List[int], data: List[torch.Tensor]) -> None:
    """Write full-head [L, n, page, Hkv, ...] arrays into the pool at
    ``pages``; a sharded pool takes each shard's head range."""
    if not isinstance(kv, ShardedKVPages):
        idx = _index(pages, kv.k.device)
        for pool, arr in zip(_pool_arrays(kv), data):
            pool.index_copy_(1, idx, arr)
        return
    idx = {}
    for i, shard in enumerate(kv.shards):
        dev = shard.k.device
        if dev not in idx:
            idx[dev] = _index(pages, dev)
        for pool, arr in zip(_pool_arrays(shard), data):
            h = pool.shape[_HEAD_DIM]
            pool.index_copy_(1, idx[dev],
                             arr.narrow(_HEAD_DIM, i * h, h).to(dev))


def offload_pages(kv: KVPages, pages: List[int]) -> List[HostKVPage]:
    """Copy ``pages`` out of the pool into host memory, one HostKVPage
    each. For a CUDA pool: one gather per pool array on the device, then
    a non-blocking copy per page into its own pinned buffer, queued on
    the current stream. Every later write to those pages (the page ids
    are handed out again once the caller frees them) is queued behind
    these copies on the same stream, and every host read of the copies
    (restore_pages) is a copy queued behind them too; so the host never
    waits here."""
    n = len(pages)
    if n == 0:
        return []
    per_array = []
    for gathered in _gather_pages(kv, pages):
        # [L, n, ...] -> [n, L, ...]: one contiguous block per page.
        g = gathered.transpose(0, 1).contiguous()
        dev = g.device
        if dev.type == "cuda":
            host = [torch.empty(g.shape[1:], dtype=g.dtype, pin_memory=True)
                    for _ in range(n)]
            for i in range(n):
                host[i].copy_(g[i], non_blocking=True)
        else:
            host = [g[i].clone() for i in range(n)]
        per_array.append(host)
    if kv.quantized:
        return [HostKVPage(*arrs) for arrs in zip(*per_array)]
    return [HostKVPage(k, v) for k, v in zip(*per_array)]


def restore_pages(kv: KVPages, pages: List[int],
                  host_pages: List[HostKVPage]) -> KVPages:
    """Scatter host page copies into the pool at ``pages`` (freshly
    allocated ids), in place. For a CUDA pool each host page is copied
    to a device staging buffer without blocking, then one index_copy_
    per pool array scatters the batch, all queued on the current stream:
    behind the offload copies that filled the host pages (the host never
    reads them, so it never waits for them) and ahead of the prefill
    that reads the restored pages."""
    n = len(pages)
    if n == 0:
        return kv
    assert n == len(host_pages)
    dev = (kv.shards[0] if isinstance(kv, ShardedKVPages) else kv).k.device
    fields = ("k", "v", "k_scale", "v_scale")[:4 if kv.quantized else 2]
    staged = []
    for field in fields:
        first = getattr(host_pages[0], field)
        data = torch.empty((n,) + tuple(first.shape), dtype=first.dtype,
                           device=dev)
        for i, hp in enumerate(host_pages):
            data[i].copy_(getattr(hp, field), non_blocking=True)
        staged.append(data.transpose(0, 1))
    _scatter_pages(kv, pages, staged)
    return kv


class HostPagePool:
    """Capacity accounting for the host-RAM KV tier (the page bytes live
    in the prefix cache's host table) and its lifetime churn counters.
    Host side only."""

    def __init__(self, capacity_pages: int):
        self.capacity = max(0, int(capacity_pages))
        self.used = 0
        self.bytes_resident = 0
        self.offloaded_total = 0          # pages demoted device -> host
        self.restored_total = 0           # pages promoted host -> device
        self.evicted_total = 0            # second-tier (host LRU) drops
        self.imported_total = 0           # pages migrated in (fleet)
        self.offload_bytes_total = 0
        self.restore_bytes_total = 0
        self.import_bytes_total = 0
        # Host wall spent in swap batches, per direction.
        self.swap_out_s_total = 0.0
        self.swap_in_s_total = 0.0

    def note_swap_wall(self, direction: str, seconds: float) -> None:
        """One swap batch's host wall ("out" = demote, "in" = promote)."""
        if direction == "out":
            self.swap_out_s_total += seconds
        else:
            self.swap_in_s_total += seconds

    def can_hold(self, n: int = 1) -> bool:
        return self.used + n <= self.capacity

    @property
    def free(self) -> int:
        return self.capacity - self.used

    def note_offload(self, nbytes: int) -> None:
        self.used += 1
        self.bytes_resident += nbytes
        self.offloaded_total += 1
        self.offload_bytes_total += nbytes

    def note_restore(self, nbytes: int) -> None:
        self.used -= 1
        self.bytes_resident -= nbytes
        self.restored_total += 1
        self.restore_bytes_total += nbytes

    def note_evict(self, nbytes: int) -> None:
        self.used -= 1
        self.bytes_resident -= nbytes
        self.evicted_total += 1

    def note_import(self, nbytes: int) -> None:
        """A page migrated in from another replica's drain export: it
        takes capacity like a demote and is counted apart (warmth
        received, not local churn)."""
        self.used += 1
        self.bytes_resident += nbytes
        self.imported_total += 1
        self.import_bytes_total += nbytes

    def readmit(self, nbytes: int) -> bool:
        """Undo one note_restore for an entry a failed swap-in returns;
        False when an intervening demote took the room (the caller then
        drops the entry: the capacity always wins)."""
        self.restored_total -= 1
        self.restore_bytes_total -= nbytes
        if not self.can_hold(1):
            self.evicted_total += 1
            return False
        self.used += 1
        self.bytes_resident += nbytes
        return True


# ---------------------------------------------------------------------------
# Migration wire format: host pages serialized for the fleet's drain-time
# KV migration, the reference's bytes exactly.
# ---------------------------------------------------------------------------

# Header dtype names (numpy's, as the reference writes them).
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8",
                torch.uint8: "uint8"}
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _raw_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in row-major order (any dtype, bfloat16
    included, through a byte view)."""
    return t.detach().contiguous().view(torch.uint8).numpy().tobytes()


def serialize_host_pages_parts(pages: List[HostKVPage]) -> List[bytes]:
    """The blob of :func:`serialize_host_pages` as its constituent
    buffers, ``[u32 header_len + json header, page buffers...]`` in
    stream order; the embedded digest is chained across the parts.
    Pages copied off a CUDA pool must have landed (the caller
    synchronizes the stream the offload copies were queued on)."""
    if not pages:
        return [struct.pack(">I", 2) + b"{}"]
    first = pages[0]
    meta = {
        "n": len(pages),
        "k_dtype": _WIRE_DTYPES[first.k.dtype],
        "k_shape": list(first.k.shape),
        "scaled": first.k_scale is not None,
    }
    if meta["scaled"]:
        meta["scale_dtype"] = _WIRE_DTYPES[first.k_scale.dtype]
        meta["scale_shape"] = list(first.k_scale.shape)
    parts = []
    for hp in pages:
        parts.append(_raw_bytes(hp.k))
        parts.append(_raw_bytes(hp.v))
        if meta["scaled"]:
            parts.append(_raw_bytes(hp.k_scale))
            parts.append(_raw_bytes(hp.v_scale))
    # Per-blob digest over the raw page bytes, inside the header, so every
    # import path verifies end to end independent of the frame checksum.
    # One pass over the joined pages (the reference chains it part by
    # part: the same value, but a call per page).
    meta["crc32c"] = integrity.crc32c(b"".join(parts))
    header = json.dumps(meta).encode()
    return [struct.pack(">I", len(header)) + header] + parts


def serialize_host_pages(pages: List[HostKVPage]) -> bytes:
    """Pack host page copies into one blob: ``[u32 header_len][json
    header][raw k|v|k_scale|v_scale per page]``. The pages of a batch come
    from one pool, so shapes and dtypes live once in the header."""
    return b"".join(serialize_host_pages_parts(pages))


def _check_header(blob: bytes):
    """(header dict, payload offset) or the rejection reason."""
    if len(blob) < 4:
        return f"KV blob truncated ({len(blob)} bytes)"
    (hlen,) = struct.unpack(">I", blob[:4])
    if 4 + hlen > len(blob):
        return f"KV blob header overruns blob ({hlen} > {len(blob) - 4})"
    try:
        meta = json.loads(blob[4:4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        return f"KV blob header unparseable: {e}"
    want = meta.get("crc32c") if meta else None
    if want is not None:
        got = integrity.crc32c(blob[4 + hlen:])
        if got != want:
            return ("KV blob digest mismatch "
                    f"(want 0x{want:08x} got 0x{got:08x})")
    return meta, 4 + hlen


def deserialize_host_pages(blob: bytes,
                           copy: bool = True) -> List[HostKVPage]:
    """Inverse of :func:`serialize_host_pages` (CPU tensors). Raises
    ``integrity.KVIntegrityError`` on a truncated, unparseable or
    digest-failing blob. Each page owns its bytes; ``copy=False``
    returns read-only views over the blob instead (the blob stays alive
    through them)."""
    checked = _check_header(blob)
    if isinstance(checked, str):
        raise integrity.KVIntegrityError(checked)
    meta, at = checked
    if not meta:
        return []
    k_dtype = _WIRE_NAMES[meta["k_dtype"]]
    k_shape = tuple(meta["k_shape"])
    scaled = meta.get("scaled", False)
    if scaled:
        s_dtype = _WIRE_NAMES[meta["scale_dtype"]]
        s_shape = tuple(meta["scale_shape"])
    elem = {dt: torch.empty((), dtype=dt).element_size()
            for dt in (k_dtype, s_dtype if scaled else k_dtype)}
    need = meta["n"] * (2 * int(np.prod(k_shape)) * elem[k_dtype]
                        + (2 * int(np.prod(s_shape)) * elem[s_dtype]
                           if scaled else 0))
    if at + need > len(blob):
        raise integrity.KVIntegrityError(
            f"KV blob payload truncated ({len(blob) - at} < {need} bytes)")
    raw = np.frombuffer(blob, dtype=np.uint8)

    def take(dtype, shape):
        nonlocal at
        n = int(np.prod(shape)) * elem[dtype]
        arr = raw[at:at + n]
        at += n
        with warnings.catch_warnings():
            # A view over immutable bytes: the caller only reads it.
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(arr.copy() if copy else arr)
        return t.view(dtype).reshape(shape)

    out: List[HostKVPage] = []
    for _ in range(meta["n"]):
        k = take(k_dtype, k_shape)
        v = take(k_dtype, k_shape)
        ks = vs = None
        if scaled:
            ks = take(s_dtype, s_shape)
            vs = take(s_dtype, s_shape)
        out.append(HostKVPage(k, v, ks, vs))
    return out


def verify_host_pages_blob(blob: bytes) -> Optional[str]:
    """Structure and digest check without building pages (the router's
    gate before forwarding a blob). None when sound, else the reason; a
    blob without a ``crc32c`` passes the structure check only."""
    if not blob:
        return None
    checked = _check_header(blob)
    return checked if isinstance(checked, str) else None
