"""Prefix cache: shared-prefix KV page reuse across requests.

Twin of ``tpu_inference/engine/prefix_cache.py`` with its two tiers.
Multi-turn conversations resend the whole history each turn, so
consecutive requests share long token prefixes; full pages are immutable
once written, so page-granular sharing with plain refcounts is safe.

- Key = rolling blake2b chain hash over page-sized token blocks, so a
  hit guarantees the entire prefix up to that page matches. The digests
  are byte-identical to the reference's.
- The cache holds its own allocator reference on every inserted page;
  eviction drops that reference, oldest evictable entry first.
- Victim selection is O(evicted) through the allocator's
  ``on_evictable`` hook (digests whose page only the cache holds).
- Two tiers: with a ``HostPagePool`` attached, eviction DEMOTES pages to
  host RAM (the engine's ``offload_fn`` copies them) instead of dropping
  their KV, and a lookup that meets a host-tier digest hands the copy
  back for restore into a fresh device page (``promote``). The host tier
  has its own LRU and capacity. A digest lives in one tier at a time.
- Fleet import (``import_host``): another replica's drain export lands
  in the host tier, so a resubmitted request's admission restores it.
"""

from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpu_inference_torch import telemetry
from tpu_inference_torch.engine.kv_cache import (HostKVPage, HostPagePool,
                                                 PageAllocator)


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
    """Maps prefix chain-hashes to physical KV pages (device tier) and
    host-RAM page copies (host tier)."""

    def __init__(self, allocator: PageAllocator, page_size: int,
                 host_pool: Optional[HostPagePool] = None,
                 offload_fn=None):
        self.allocator = allocator
        self.page_size = page_size
        # digest -> page id, LRU order (oldest first).
        self._table: "OrderedDict[bytes, int]" = OrderedDict()
        # Host tier: digest -> HostKVPage, LRU order (oldest first);
        # host_pool does the accounting, offload_fn (pages ->
        # List[HostKVPage], from the engine) the device->host copy.
        self._host: "OrderedDict[bytes, HostKVPage]" = OrderedDict()
        self.host_pool = host_pool
        self._offload_fn = offload_fn
        # Evictable-ordered view of _table (cache-only references).
        self._evict_order: "OrderedDict[bytes, None]" = OrderedDict()
        self._page_digest: Dict[int, bytes] = {}
        allocator.on_evictable = self._note_evictable
        self.hits_hbm = telemetry.Counter("tpu_inf_prefix_cache_hits_total")
        self.hits_host = telemetry.Counter("tpu_inf_prefix_cache_hits_total")
        self.misses = telemetry.Counter("tpu_inf_prefix_cache_misses_total")
        self.peeks = telemetry.Counter("tpu_inf_prefix_cache_peeks_total")

    def bind_telemetry(self, tel) -> None:
        """Registry-backed counters, so /metrics exposes them (kept
        standalone when telemetry is off)."""
        if not tel.enabled:
            return
        r = tel.registry
        help_hits = ("Prefix-cache lookups served (by tier that contributed "
                     "pages)")
        self.hits_hbm = r.counter("tpu_inf_prefix_cache_hits_total",
                                  help_hits, tier="hbm")
        self.hits_host = r.counter("tpu_inf_prefix_cache_hits_total",
                                   help_hits, tier="host")
        self.misses = r.counter(
            "tpu_inf_prefix_cache_misses_total",
            "Prefix-cache lookups with no cached prefix in either tier")
        self.peeks = r.counter(
            "tpu_inf_prefix_cache_peeks_total",
            "Side-effect-free prefix probes")

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

    # ------------------------------------------------------------- peek

    def peek(self, tokens: Sequence[int],
             max_tokens: Optional[int] = None) -> int:
        """Full pages of the longest cached prefix of ``tokens`` across
        both tiers; side-effect-free (no LRU move, no share, no hit
        count)."""
        limit = len(tokens) if max_tokens is None else max_tokens
        digests = _chain_hashes(tokens, self.page_size)
        return self.peek_digests(digests[:limit // self.page_size])

    def peek_digests(self, digests: Sequence[bytes]) -> int:
        """peek() over precomputed chain digests (both tiers summed)."""
        hbm, host = self.peek_digests_tiered(digests)
        return hbm + host

    def peek_digests_tiered(self, digests: Sequence[bytes]
                            ) -> Tuple[int, int]:
        """(device_hit_pages, host_hit_pages) over the longest contiguous
        cached prefix. Side-effect-free."""
        hbm = host = 0
        for digest in digests:
            if digest in self._table:
                hbm += 1
            elif digest in self._host:
                host += 1
            else:
                break
        self.peeks.inc()
        return hbm, host

    # ------------------------------------------------------------- lookup

    def lookup(self, tokens: Sequence[int],
               max_tokens: Optional[int] = None,
               digests: Optional[Sequence[bytes]] = None
               ) -> Tuple[List[Optional[int]],
                          List[Tuple[int, bytes, HostKVPage]], int]:
        """Longest cached prefix of ``tokens`` across both tiers.

        Returns ``(pages, host_entries, n_cached_tokens)``: ``pages[i]``
        is the device page of matched page ``i`` (a fresh reference the
        caller owns) or None where the host tier served it;
        ``host_entries`` lists ``(i, digest, HostKVPage)`` for those. Host
        entries leave the host tier here: the caller restores them into
        fresh device pages and publishes them with :meth:`promote`, or
        hands them back with :meth:`readmit_host`. ``max_tokens`` caps the
        match (the engine always recomputes the prompt's final token)."""
        limit = len(tokens) if max_tokens is None else max_tokens
        if digests is None:
            digests = _chain_hashes(tokens, self.page_size)
        pages: List[Optional[int]] = []
        host_entries: List[Tuple[int, bytes, HostKVPage]] = []
        for i, digest in enumerate(digests):
            if (i + 1) * self.page_size > limit:
                break
            page = self._table.get(digest)
            if page is not None:
                self._table.move_to_end(digest)
                pages.append(page)
                continue
            entry = self._host.pop(digest, None)
            if entry is None:
                break
            self.host_pool.note_restore(entry.nbytes)
            host_entries.append((i, digest, entry))
            pages.append(None)
        for p in pages:
            if p is not None:
                self.allocator.share(p)
        if pages:
            if any(p is not None for p in pages):
                self.hits_hbm.inc()
            if host_entries:
                self.hits_host.inc()
        else:
            self.misses.inc()
        return pages, host_entries, len(pages) * self.page_size

    def promote(self, digest: bytes, page: int) -> None:
        """Publish a just-restored host entry's device ``page`` (owned by
        the caller) in the device tier; the cache takes its own
        reference."""
        if digest in self._table:
            return
        self._table[digest] = self.allocator.share(page)
        self._page_digest[page] = digest
        self.allocator.mark_cached(page)

    def adopt(self, digest: bytes, page: int) -> None:
        """Queue-wait prefetch: take over a fresh ``page`` (refcount 1,
        from the caller) holding a restored host entry and publish it in
        the device tier, where it is evictable at once."""
        assert digest not in self._table
        self._table[digest] = page
        self._page_digest[page] = digest
        self.allocator.mark_cached(page)

    def take_host_matches(self, digests: Sequence[bytes], max_pages: int
                          ) -> List[Tuple[bytes, HostKVPage]]:
        """Pop the host entries inside the longest contiguous cached
        prefix of ``digests`` (device hits are skipped, not touched), for
        the queue-wait restore; the caller hands the pages back with
        :meth:`adopt`, or the entries with :meth:`readmit_host`."""
        out: List[Tuple[bytes, HostKVPage]] = []
        for i, digest in enumerate(digests):
            if i >= max_pages:
                break
            if digest in self._table:
                continue
            entry = self._host.pop(digest, None)
            if entry is None:
                break
            self.host_pool.note_restore(entry.nbytes)
            out.append((digest, entry))
        return out

    def readmit_host(self, taken: Sequence[Tuple[bytes, HostKVPage]]
                     ) -> None:
        """Return host entries a failed restore could not place; entries
        that no longer fit the capacity are dropped (they are copies:
        losing one costs recompute, never correctness)."""
        for digest, entry in taken:
            if digest in self._table or digest in self._host:
                continue
            if self.host_pool.readmit(entry.nbytes):
                self._host[digest] = entry

    def import_host(self, entries: Sequence[Tuple[bytes, HostKVPage]]
                    ) -> int:
        """Adopt migrated host page copies (another replica's drain
        export) into the host tier, newest in LRU order. Digests resident
        in either tier are skipped (the local copy is at least as fresh);
        room is made by dropping the host tier's own oldest entries (the
        migrated pages are about to be used); when the tier cannot hold
        more the rest is dropped (a lost page costs recompute, never
        correctness). Engine thread only. Returns the pages adopted."""
        if self.host_pool is None or self.host_pool.capacity <= 0:
            return 0
        added = 0
        for digest, entry in entries:
            if digest in self._table or digest in self._host:
                continue
            while not self.host_pool.can_hold(1) and self._host:
                _, old = self._host.popitem(last=False)
                self.host_pool.note_evict(old.nbytes)
            if not self.host_pool.can_hold(1):
                break
            self._host[digest] = entry
            self.host_pool.note_import(entry.nbytes)
            added += 1
        return added

    # ------------------------------------------------------------- insert

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               digests: Optional[Sequence[bytes]] = None) -> int:
        """Publish a sequence's full pages; ``pages[i]`` holds tokens
        ``[i*page, (i+1)*page)``. A device publish supersedes any host
        copy of the digest. Returns the number newly published."""
        digests = extend_chain_hashes(tokens, self.page_size, digests or [])
        added = 0
        for i, digest in enumerate(digests):
            if i >= len(pages):
                break
            if digest in self._table:
                self._table.move_to_end(digest)
                continue
            self._drop_host(digest)
            self._table[digest] = self.allocator.share(pages[i])
            self._page_digest[pages[i]] = digest
            self.allocator.mark_cached(pages[i])
            added += 1
        return added

    def _drop_host(self, digest: bytes) -> None:
        entry = self._host.pop(digest, None)
        if entry is not None:
            self.host_pool.note_evict(entry.nbytes)

    # ------------------------------------------------------------- evict

    def _forget(self, digest: bytes) -> int:
        """Remove one evictable device entry and free its page."""
        page = self._table.pop(digest)
        self._evict_order.pop(digest, None)
        del self._page_digest[page]
        self.allocator.unmark_cached(page)
        self.allocator.free([page])
        return page

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` device pages, oldest evictable entries
        first (entries share-pinned by a running sequence are never
        touched). With a host tier the victims DEMOTE: one offload batch
        copies them to host memory before their pages are freed, room
        being made by dropping the host tier's oldest entries (never more
        than the batch can use); the newest victims demote when not all
        fit. Returns the pages freed."""
        victims = list(itertools.islice(self._evict_order, n_pages))
        if not victims:
            return 0
        demote = (self.host_pool is not None
                  and self._offload_fn is not None
                  and self.host_pool.capacity > 0)
        copies: List[Optional[HostKVPage]] = [None] * len(victims)
        if demote:
            target = min(len(victims), self.host_pool.capacity)
            while self.host_pool.free < target and self._host:
                _, old = self._host.popitem(last=False)
                self.host_pool.note_evict(old.nbytes)
            fit = min(self.host_pool.free, len(victims))
            if fit > 0:
                pages = [self._table[d] for d in victims[-fit:]]
                for j, hp in enumerate(self._offload_fn(pages)):
                    copies[len(victims) - fit + j] = hp
        for digest, hp in zip(victims, copies):
            self._forget(digest)
            if hp is not None:
                self._drop_host(digest)
                self._host[digest] = hp
                self.host_pool.note_offload(hp.nbytes)
        return len(victims)

    def clear(self) -> None:
        for page in self._table.values():
            self.allocator.unmark_cached(page)
            self.allocator.free([page])
        self._table.clear()
        self._evict_order.clear()
        self._page_digest.clear()
        for entry in self._host.values():
            self.host_pool.note_evict(entry.nbytes)
        self._host.clear()

    def stats(self) -> Dict[str, int]:
        out = {"entries": len(self._table), "evictable": self.evictable,
               "host_entries": len(self._host)}
        if self.host_pool is not None:
            hp = self.host_pool
            out.update({
                "host_capacity_pages": hp.capacity,
                "host_pages_used": hp.used,
                "host_bytes_resident": hp.bytes_resident,
                "offloaded_pages": hp.offloaded_total,
                "restored_pages": hp.restored_total,
                "host_evictions": hp.evicted_total,
                "imported_pages": hp.imported_total,
                "swap_out_s_total": round(hp.swap_out_s_total, 6),
                "swap_in_s_total": round(hp.swap_in_s_total, 6),
            })
        return out
