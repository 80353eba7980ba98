"""Prefix cache: shared-prefix KV page reuse across requests.

Twin of ``tpu_inference/engine/prefix_cache.py`` at its device tier (the
host-RAM tier is ROADMAP item 1.13). Multi-turn conversations resend the
whole history each turn, so consecutive requests share long token
prefixes; full pages are immutable once written, so page-granular
sharing with plain refcounts is safe.

- Key = rolling blake2b chain hash over page-sized token blocks, so a
  hit guarantees the entire prefix up to that page matches. The digests
  are byte-identical to the reference's.
- The cache holds its own allocator reference on every inserted page;
  eviction drops that reference, oldest evictable entry first.
- Victim selection is O(evicted) through the allocator's
  ``on_evictable`` hook (digests whose page only the cache holds).
"""

from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_inference_torch import telemetry
from tpu_inference_torch.engine.kv_cache import PageAllocator


def _chain_hashes(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """One digest per *full* page, each folding in all prior pages
    (fixed-width packed int32 blocks, so the encoding is injective)."""
    return extend_chain_hashes(tokens, page_size, [])


def extend_chain_hashes(tokens: Sequence[int], page_size: int,
                        prefix_digests: Sequence[bytes]) -> List[bytes]:
    """Chain digests for every full page of ``tokens``, reusing
    ``prefix_digests`` for the leading pages and hashing the rest."""
    n_pages = len(tokens) // page_size
    if n_pages == 0:
        return []
    start = min(len(prefix_digests), n_pages)
    out: List[bytes] = list(prefix_digests[:start])
    if start == n_pages:
        return out
    blocks = np.asarray(tokens[start * page_size:n_pages * page_size],
                        dtype=np.int32).reshape(n_pages - start, page_size)
    h = out[-1] if out else b""
    for i in range(n_pages - start):
        d = hashlib.blake2b(digest_size=16)
        d.update(h)
        d.update(blocks[i].tobytes())
        h = d.digest()
        out.append(h)
    return out


class PrefixCache:
    """Maps prefix chain-hashes to physical KV pages."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        self.allocator = allocator
        self.page_size = page_size
        # digest -> page id, LRU order (oldest first).
        self._table: "OrderedDict[bytes, int]" = OrderedDict()
        # Evictable-ordered view of _table (cache-only references).
        self._evict_order: "OrderedDict[bytes, None]" = OrderedDict()
        self._page_digest: Dict[int, bytes] = {}
        allocator.on_evictable = self._note_evictable
        self.hits = telemetry.Counter("tpu_inf_prefix_cache_hits_total")
        self.misses = telemetry.Counter("tpu_inf_prefix_cache_misses_total")

    def bind_telemetry(self, tel) -> None:
        """Registry-backed counters, so /metrics exposes them."""
        r = tel.registry
        self.hits = r.counter(
            "tpu_inf_prefix_cache_hits_total",
            "Prefix-cache lookups served (by tier that contributed pages)",
            tier="hbm")
        self.misses = r.counter(
            "tpu_inf_prefix_cache_misses_total",
            "Prefix-cache lookups with no cached prefix in either tier")

    def __len__(self) -> int:
        return len(self._table)

    @property
    def evictable(self) -> int:
        """Pages reclaimable right now (cache holds the only reference)."""
        return self.allocator.evictable_count

    def _note_evictable(self, page: int, up: bool) -> None:
        digest = self._page_digest.get(page)
        if digest is None:
            return
        if up:
            self._evict_order[digest] = None
            self._evict_order.move_to_end(digest)
        else:
            self._evict_order.pop(digest, None)

    def lookup(self, tokens: Sequence[int],
               max_tokens: Optional[int] = None,
               digests: Optional[Sequence[bytes]] = None
               ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: (pages, n_cached_tokens).
        Each returned page carries a fresh reference the caller owns.
        ``max_tokens`` caps the match (the engine always recomputes the
        prompt's final token for its logits)."""
        limit = len(tokens) if max_tokens is None else max_tokens
        if digests is None:
            digests = _chain_hashes(tokens, self.page_size)
        pages: List[int] = []
        for i, digest in enumerate(digests):
            if (i + 1) * self.page_size > limit:
                break
            page = self._table.get(digest)
            if page is None:
                break
            self._table.move_to_end(digest)
            pages.append(page)
        for p in pages:
            self.allocator.share(p)
        (self.hits if pages else self.misses).inc()
        return pages, len(pages) * self.page_size

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               digests: Optional[Sequence[bytes]] = None) -> int:
        """Publish a sequence's full pages; ``pages[i]`` holds tokens
        ``[i*page, (i+1)*page)``. Returns the number newly published."""
        digests = extend_chain_hashes(tokens, self.page_size, digests or [])
        added = 0
        for i, digest in enumerate(digests):
            if i >= len(pages):
                break
            if digest in self._table:
                self._table.move_to_end(digest)
                continue
            self._table[digest] = self.allocator.share(pages[i])
            self._page_digest[pages[i]] = digest
            self.allocator.mark_cached(pages[i])
            added += 1
        return added

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages, oldest evictable entries first
        (entries share-pinned by a running sequence are never touched)."""
        victims = list(itertools.islice(self._evict_order, n_pages))
        for digest in victims:
            page = self._table.pop(digest)
            self._evict_order.pop(digest, None)
            del self._page_digest[page]
            self.allocator.unmark_cached(page)
            self.allocator.free([page])
        return len(victims)

    def clear(self) -> None:
        for page in self._table.values():
            self.allocator.unmark_cached(page)
            self.allocator.free([page])
        self._table.clear()
        self._evict_order.clear()
        self._page_digest.clear()

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._table), "evictable": self.evictable}
