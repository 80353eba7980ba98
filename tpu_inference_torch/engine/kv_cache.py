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

Host side, ``PageAllocator`` is a free-list with refcounts so shared
prompt prefixes map the same physical pages. The host KV tier and its
serialization are ROADMAP item 1.13.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from tpu_inference_torch.config import EngineConfig, ModelConfig


class KVPages(NamedTuple):
    """Device-side KV pool. k, v: [L, num_pages, page_size, Hkv, head_dim]."""

    k: torch.Tensor
    v: torch.Tensor


def alloc_kv_pages(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                   dtype=None, device="cuda") -> KVPages:
    if engine_cfg.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={engine_cfg.kv_quant!r} is not ported yet (ROADMAP "
            "2.1/2.2: the int8 and int4 variants of both kernels)")
    shape = (model_cfg.n_layers, engine_cfg.num_pages, engine_cfg.page_size,
             model_cfg.n_kv_heads, model_cfg.head_dim)
    dtype = dtype or model_cfg.dtype
    return KVPages(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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
    [B, S], in place. Several invalid tokens may share slot 0; the trash
    page's contents are unspecified, as in the reference."""
    L, P, pg, H, D = kv.k.shape
    flat = slots.reshape(-1)
    for pool, new in ((kv.k, k_new), (kv.v, v_new)):
        pool[layer_idx].view(P * pg, H, D).index_copy_(
            0, flat, new.reshape(-1, H, D).to(pool.dtype))
    return kv


def gather_kv(kv: KVPages, layer_idx: int, block_tables: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather each sequence's pages into contiguous [B, max_pages*pg, H, D]."""
    b, mp = block_tables.shape
    _, P, pg, H, D = kv.k.shape
    idx = block_tables.long().clamp(0, P - 1)
    k = kv.k[layer_idx][idx].reshape(b, mp * pg, H, D)
    v = kv.v[layer_idx][idx].reshape(b, mp * pg, H, D)
    return k, v


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
