"""Fleet KV fabric: a router-side, digest-keyed pool of serialized KV
prefix pages shared by every replica.

Twin of ``tpu_inference/server/kv_fabric.py``. A prefix prefilled on
one replica warms every replica, byte-identically:

- ``FabricPool``: a capacity-bounded (in pages) LRU of per-page
  ``serialize_host_pages`` blobs in the ROUTER process, the same under
  ``--fleet in-process`` and ``subprocess``. Engines publish settled
  prefix pages after prefill (in-process a direct call, in the process
  fleet ``fabric_put`` event frames); a dispatch pulls the pages the
  pool holds beyond the routed replica's own warm depth into its host
  tier (``request_import_host``, over ``import-kv`` in the process
  fleet) before the request's prefill.
- The shm plane (``server/shm_arena.py``): an entry holds the arena
  descriptor of the page's slab instead of its blob (``put_desc``); the
  payload never enters the router. ``get_descs`` and ``hot_set_descs``
  hand descriptors to the adopting worker, which reads and verifies
  the slab itself; ``drop_region`` forgets a dead incarnation's slabs,
  and ``on_release`` gives every descriptor the pool stops holding back
  to the router's slab books.
- Integrity: every ``get`` re-verifies the blob's CRC-32C before
  adoption; a corrupt entry is dropped, counted and ends the run as a
  miss, never adopted (a descriptor's slab is verified by its reader,
  which reports rejects back: ``reject``).
- The routing formulas both fleet backends share, with the fourth
  temperature: fabric-warm scores between host-warm and cold, from the
  router's own index (no extra RPC).

One lock guards the OrderedDict (puts from event threads, gets from
submit threads, peeks from pickers); counter reads are GIL-atomic, as
in the rest of the telemetry layer.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_inference_torch.engine import kv_cache as kvc
from tpu_inference_torch.integrity import KVIntegrityError


class _Entry:
    """One pooled page: its serialized blob (relay plane) or the arena
    descriptor of the slab that holds it (shm plane; ``nbytes`` is then
    the slab's length)."""

    __slots__ = ("blob", "desc", "nbytes")

    def __init__(self, blob: Optional[bytes] = None,
                 desc: Optional[dict] = None):
        self.blob = blob
        self.desc = desc
        self.nbytes = len(blob) if blob is not None else int(desc["len"])


class FabricPool:
    """Digest-keyed LRU pool of individually serialized KV pages.

    One entry = one page = one ``serialize_host_pages([page])`` blob, so
    entries evict independently and every ``get`` re-verifies its own
    CRC-32C. Digests are the prefix chain hashes (``_chain_hashes``):
    self-contained keys, so any contiguous-from-page-0 run resident
    here still matches.
    """

    def __init__(self, capacity_pages: int):
        self.capacity = max(0, int(capacity_pages))
        self._entries: "collections.OrderedDict[bytes, _Entry]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._bytes = 0
        # Monotone counters (telemetry.register_fabric reads them).
        self.hits = 0                  # pages served by get_pages
        self.misses = 0                # lookups that ended short
        self.puts = 0                  # pages accepted (supersedes too)
        self.superseded = 0            # puts that replaced a live entry
        self.evictions = 0             # LRU capacity drops
        self.kv_rejections = 0         # corrupt entries dropped
        # Called with the descriptor of every entry the pool stops
        # holding (evict, supersede, reject, clear, region drop): the
        # process fleet releases the slab back to its owner.
        self.on_release = None

    # ------------------------------------------------------------- put

    def _release_entry(self, e: _Entry) -> None:
        if e.desc is not None and self.on_release is not None:
            try:
                self.on_release(e.desc)
            except Exception:  # noqa: BLE001 — a release is best effort
                pass

    def _drop_entry(self, e: _Entry) -> None:
        """Caller holds the lock; ``e`` was resident."""
        self._bytes -= e.nbytes
        self._release_entry(e)

    def _put_entry(self, digest: bytes, e: _Entry) -> None:
        if self.capacity <= 0:
            # Never resident, but a descriptor's slab is still released.
            self._release_entry(e)
            return
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._drop_entry(old)
                self.superseded += 1
            while len(self._entries) >= self.capacity:
                _, ev = self._entries.popitem(last=False)
                self._drop_entry(ev)
                self.evictions += 1
            self._entries[digest] = e
            self._bytes += e.nbytes
            self.puts += 1

    def put_blob(self, digest: bytes, blob: bytes) -> None:
        """Insert or supersede one page's blob under its chain digest. A
        second replica publishing the same prefix stores once (the fresh
        blob supersedes), and the entry moves to MRU either way."""
        self._put_entry(digest, _Entry(blob=blob))

    def put_desc(self, digest: bytes, desc: dict) -> None:
        """Pool the arena descriptor of one page's slab: the payload
        stays in the worker-written slab, and its reader verifies it."""
        self._put_entry(digest, _Entry(desc=dict(desc)))

    def put_pages(self, pairs: Sequence[Tuple[bytes, "kvc.HostKVPage"]]
                  ) -> int:
        """Publish (digest, HostKVPage) pairs, each serialized on its
        own: the in-process backend's direct path and the router's
        salvage path. Returns the pages stored."""
        n = 0
        for digest, page in pairs:
            self.put_blob(digest, kvc.serialize_host_pages([page]))
            n += 1
        return n

    # ------------------------------------------------------------- get

    def match_depth(self, digests: Sequence[bytes]) -> int:
        """Pages resident contiguously from page 0 of this chain.
        Side-effect free (no counters, no LRU touch): the router's
        scoring peek, once per candidate scan."""
        if self.capacity <= 0 or not digests:
            return 0
        with self._lock:
            n = 0
            for d in digests:
                if d not in self._entries:
                    break
                n += 1
            return n

    def get_pages(self, digests: Sequence[bytes]
                  ) -> List[Tuple[bytes, "kvc.HostKVPage"]]:
        """The contiguous run of pages for ``digests``, each blob's
        CRC-32C verified before adoption. A corrupt entry is dropped,
        counted under kv_rejections and ends the run (a miss, never
        adopted). Served entries move to MRU."""
        out: List[Tuple[bytes, "kvc.HostKVPage"]] = []
        for d in digests:
            with self._lock:
                e = self._entries.get(d)
                if e is not None:
                    self._entries.move_to_end(d)
            if e is None or e.blob is None:
                # Absent, or a descriptor: its bytes are in the arena,
                # pulled with get_descs by the adopting worker.
                self.misses += 1
                break
            try:
                page = kvc.deserialize_host_pages(e.blob)[0]
            except KVIntegrityError:
                self._drop(d)
                self.kv_rejections += 1
                self.misses += 1
                break
            self.hits += 1
            out.append((d, page))
        return out

    def get_descs(self, digests: Sequence[bytes]
                  ) -> List[Tuple[bytes, dict]]:
        """The contiguous run of descriptor entries for ``digests``,
        counted like get_pages; no bytes move here (the adopting worker
        reads and verifies each slab, and reports rejects back). A blob
        entry ends the run."""
        out: List[Tuple[bytes, dict]] = []
        for d in digests:
            with self._lock:
                e = self._entries.get(d)
                if e is not None and e.desc is not None:
                    self._entries.move_to_end(d)
            if e is None or e.desc is None:
                self.misses += 1
                break
            self.hits += 1
            out.append((d, dict(e.desc)))
        return out

    def _drop(self, digest: bytes) -> None:
        with self._lock:
            live = self._entries.pop(digest, None)
            if live is not None:
                self._drop_entry(live)

    def reject(self, digest: bytes) -> None:
        """Drop a corrupt entry found outside get_pages (the warm boot's
        re-verify, or a worker's arena read that failed its CRC),
        counted like a get-time rejection."""
        self._drop(digest)
        self.kv_rejections += 1

    def drop_region(self, rg: int) -> int:
        """Forget every descriptor entry whose slab is in arena region
        ``rg`` (its worker incarnation died; the epoch bump already
        made the descriptors fail closed). Neither an eviction nor a
        rejection. Returns the entries dropped."""
        with self._lock:
            dead = [d for d, e in self._entries.items()
                    if e.desc is not None
                    and int(e.desc.get("rg", -1)) == int(rg)]
            for d in dead:
                self._drop_entry(self._entries.pop(d))
            return len(dead)

    def hot_set(self, max_pages: int) -> List[Tuple[bytes, bytes]]:
        """The MRU-first (digest, blob) list of blob entries for a warm
        worker boot. Puts land in chain order, so MRU slices keep chains
        roughly whole. No counter moves (the import's adoption is what
        counts)."""
        if max_pages <= 0:
            return []
        with self._lock:
            ds = [d for d, e in self._entries.items()
                  if e.blob is not None][-max_pages:]
            ds.reverse()
            return [(d, self._entries[d].blob) for d in ds]

    def hot_set_descs(self, max_pages: int) -> List[Tuple[bytes, dict]]:
        """The MRU-first (digest, descriptor) list: the shm plane's warm
        boot, which the fresh worker adopts from the arena."""
        if max_pages <= 0:
            return []
        with self._lock:
            ds = [d for d, e in self._entries.items()
                  if e.desc is not None][-max_pages:]
            ds.reverse()
            return [(d, dict(self._entries[d].desc)) for d in ds]

    # ------------------------------------------------------ accounting

    @property
    def used(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    @property
    def free_pages(self) -> int:
        """The watermark the router advertises to workers (publish
        back-pressure): a publish larger than this would evict on
        arrival, so the worker skips it at the source."""
        return max(0, self.capacity - self.used)

    def snapshot(self) -> Dict[str, int]:
        """The /healthz ``fabric`` block (both backends, one shape)."""
        return {
            "capacity_pages": self.capacity,
            "pages_used": self.used,
            "bytes_used": self.bytes_used,
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "superseded": self.superseded,
            "evictions": self.evictions,
            "kv_rejections": self.kv_rejections,
        }

    def clear(self) -> None:
        with self._lock:
            for e in self._entries.values():
                self._drop_entry(e)
            self._entries.clear()
            self._bytes = 0


# --- The routing formulas both fleet backends call (README "Cache-aware
# routing"): four temperatures, HBM-warm > host-warm > fabric-warm > cold.


def fabric_extra_pages(fabric_depth: int, warm_depth: int,
                       prompt_pages: int) -> int:
    """Pages the fabric covers beyond a candidate's own warm depth (HBM
    and host): only those earn the fabric discount."""
    return max(0, min(int(fabric_depth), int(prompt_pages))
               - int(warm_depth))


def prefill_route_score(cfg, *, prompt_pages: int, hbm: float, host: float,
                        fabric: float, load: float,
                        pressured: bool) -> float:
    """Expected prefill cost in pages, load-blended: prompt pages minus
    the warmth discounts (HBM at ``route_hit_weight``, host at
    ``route_host_hit_weight``, the fabric-covered rest at
    ``route_fabric_hit_weight``) plus queue depth; a pressured candidate
    is shifted behind every unpressured one, relative order kept."""
    score = (prompt_pages
             - cfg.route_hit_weight * hbm
             - cfg.route_host_hit_weight * host
             - cfg.route_fabric_hit_weight * fabric
             + cfg.route_load_pages * load)
    if pressured:
        score += prompt_pages + 1
    return score


def decode_route_score(cfg, *, hbm: float, host: float, fabric: float,
                       load: float, occupancy: float,
                       pressured: bool) -> float:
    """Cost of a decode destination (a P/D handoff or a resume): load
    plus lane occupancy (``route_occupancy_pages`` for a full ladder)
    minus the same three warmth discounts, pressure-shifted like the
    prefill score."""
    score = (cfg.route_load_pages * load
             + cfg.route_occupancy_pages * occupancy
             - cfg.route_hit_weight * hbm
             - cfg.route_host_hit_weight * host
             - cfg.route_fabric_hit_weight * fabric)
    if pressured:
        score += cfg.route_occupancy_pages + 1
    return score


def cold_route_key(pressured: bool, load: float) -> Tuple[bool, float]:
    """The cold key: unpressured first, then least loaded (ties rotate
    in the caller)."""
    return (bool(pressured), load)
