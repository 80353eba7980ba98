"""Zero-copy KV data plane: the shared-memory page arena.

Twin of ``tpu_inference/server/shm_arena.py``, with the same bytes in
its slabs and the same descriptors on its frames. On the relay plane
every KV movement of the process fleet (P/D handoff, drain migration,
fabric publish and pull, warm boot) serializes pages into a blob that
crosses the router in RPC frames. On the shm plane the owning worker
writes the serialized blob into a shared-memory slab once, and frames
carry a descriptor ``{seg, rg, off, len, crc, gen, ep}`` instead; the
adopting worker reads the slab itself.

Layout
------
One ``multiprocessing.shared_memory`` segment, created and unlinked by
the ROUTER (workers attach, never create or unlink), split into equal
regions, one per worker replica. Only region ``rg``'s worker allocates
or frees slabs in region ``rg``; the router writes nothing but each
region's epoch word.

* Region header: one big-endian u32 EPOCH word at the region base. The
  router bumps it when the region's worker is respawned or quarantined,
  so every descriptor the dead incarnation minted fails closed
  (``ArenaStale``): that is how a ``kill -9``'d worker's slabs are
  reclaimed without its cooperation.
* Slab: an 8-byte header ``[u32 gen][u32 len]`` and the payload, on
  16-byte aligned extents. ``gen`` is a per-incarnation nonzero counter;
  ``free()`` zeroes it, so a stale descriptor fails closed instead of
  returning recycled bytes.

Integrity
---------
A read checks the epoch word, then the slab's gen and len, then the
payload's CRC-32C (carried in the descriptor), copies the payload out,
and checks epoch and gen again, so a slab freed and recycled during the
copy is never adopted. Failures are typed: ``ArenaStale`` (epoch or gen
moved: recompute, or a miss) and ``ArenaCorrupt`` (length, bounds or
CRC: a counted integrity rejection). ``ArenaFull`` (no extent fits)
sends that one payload over the relay instead.

Lifecycle
---------
The router tracks outstanding slabs in a ``SlabDirectory``, releases
each when its pool entry or handoff drops it, and hands the frees back
to the owning worker in batches on its stats tick. When a worker dies
the router reclaims the region at respawn or quarantine: it drops the
region's registered slabs and bumps the epoch.

One check the reference does not make: ``/dev/shm`` is tmpfs, where
``ftruncate`` past the free space succeeds and the first write past it
kills the writer with SIGBUS, so ``ArenaSegment`` refuses a segment
larger than the free space it finds (the fleet then rides the relay
plane and logs ``shm_arena_unavailable``).
"""

from __future__ import annotations

import os
import shutil
import struct
import sys
import threading
from typing import Dict, List, Optional, Tuple

from tpu_inference_torch.integrity import crc32c


def effective_kv_plane(server_cfg) -> str:
    """``kv_plane`` against what the fleet can do: shm only for worker
    processes (``--fleet subprocess``) on Linux, where POSIX shared
    memory is; every other combination rides the relay plane."""
    if getattr(server_cfg, "kv_plane", "relay") != "shm":
        return "relay"
    if getattr(server_cfg, "fleet", "in-process") != "subprocess":
        return "relay"
    if not sys.platform.startswith("linux"):
        return "relay"
    return "shm"


_EPOCH = struct.Struct(">I")
_SLAB = struct.Struct(">II")          # gen, payload length
_ALIGN = 16
# First allocatable byte of a region: the epoch word, padded to one
# alignment unit so slab extents never straddle it.
_REGION_HDR = _ALIGN
_SHM_DIR = "/dev/shm"


class ArenaError(Exception):
    """Base of the arena's read and allocation failures; ``reason`` is
    a short tag, ``detail`` the rest."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason
        self.detail = detail


class ArenaStale(ArenaError):
    """Epoch or generation moved under the descriptor (a free, a reuse
    or a reclaim): not corruption; the caller recomputes or misses."""


class ArenaCorrupt(ArenaError):
    """Length, bounds or CRC-32C mismatch: rejected and counted like a
    corrupt KV blob, never adopted."""


class ArenaFull(ArenaError):
    """No free extent fits the payload; the caller relays it instead."""

    def __init__(self, detail: str = ""):
        super().__init__("full", detail)


# Segments this process created (ArenaSegment) or already detached from
# the resource tracker: attach() unregisters a mapping of another
# process's segment exactly once, and never the owner's own
# registration (a same-process attach, as in tests).
_OWNED: set = set()
_DETACHED: set = set()


def attach(name: str):
    """Map an existing segment without taking ownership. Python
    registers every mapping with the process's resource tracker, which
    unlinks what is registered when the process exits, a ``kill -9``
    included: a worker's tracker would unlink the router's segment
    under the respawn. So the mapping is unregistered at once."""
    from multiprocessing import shared_memory
    shm = shared_memory.SharedMemory(name=name)
    if name not in _OWNED and name not in _DETACHED:
        _DETACHED.add(name)
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker internals; best effort
            pass
    return shm


def _validate_header(buf, desc, region_bytes: int) -> None:
    off, length = int(desc["off"]), int(desc["len"])
    rg = int(desc["rg"])
    base = rg * region_bytes
    if not (base + _REGION_HDR <= off - _SLAB.size
            and off + length <= base + region_bytes
            and off + length <= len(buf)):
        raise ArenaCorrupt("bounds", f"off={off} len={length} rg={rg}")
    (epoch,) = _EPOCH.unpack_from(buf, base)
    if epoch != int(desc["ep"]):
        raise ArenaStale("epoch", f"region {rg}: {epoch} != {desc['ep']}")
    gen, slab_len = _SLAB.unpack_from(buf, off - _SLAB.size)
    if gen != int(desc["gen"]):
        raise ArenaStale("gen", f"slab@{off}: {gen} != {desc['gen']}")
    if slab_len != length:
        raise ArenaCorrupt("len", f"slab@{off}: {slab_len} != {length}")


def read_slab(buf, desc: dict, region_bytes: int) -> bytes:
    """Validate a slab and copy its payload out. The check after the
    copy closes the torn-read window: the owner may free the slab (gen
    to 0) or the router reclaim its region (epoch bump) during the
    copy, and recycled bytes are never returned as the payload."""
    _validate_header(buf, desc, region_bytes)
    off, length = int(desc["off"]), int(desc["len"])
    payload = bytes(buf[off:off + length])
    if crc32c(payload) != int(desc["crc"]):
        raise ArenaCorrupt("crc", f"slab@{off}")
    _validate_header(buf, desc, region_bytes)
    return payload


class RegionWriter:
    """The owner's slab allocator for ONE region (one writer: the
    region's worker). First fit over a free list whose adjacent extents
    coalesce; per-slab books, so a leak shows as ``slabs_used`` that
    never returns to zero."""

    def __init__(self, buf, region: int, region_bytes: int, epoch: int,
                 seg: str):
        self._buf = buf
        self.region = int(region)
        self.region_bytes = int(region_bytes)
        self.epoch = int(epoch)
        self.seg = seg
        base = self.region * self.region_bytes
        self._free: List[Tuple[int, int]] = [
            (base + _REGION_HDR, self.region_bytes - _REGION_HDR)]
        # payload offset -> (gen, extent offset, extent length)
        self._slabs: Dict[int, Tuple[int, int, int]] = {}
        self._gen = 0
        self._lock = threading.Lock()
        self.alloc_failures = 0

    @property
    def slabs_used(self) -> int:
        return len(self._slabs)

    @property
    def bytes_used(self) -> int:
        return sum(ext_len for _, _, ext_len in self._slabs.values())

    def alloc(self, payload: bytes) -> dict:
        """Write one slab and return its descriptor; ArenaFull when no
        extent fits."""
        return self.alloc_parts((payload,))

    def alloc_parts(self, parts) -> dict:
        """Write one slab from a sequence of buffers (a serialized
        blob's parts, ``kv_cache.serialize_host_pages_parts``): each is
        copied once, straight into the slab, and the descriptor's CRC
        is chained across them on the way."""
        length = sum(len(p) for p in parts)
        need = _SLAB.size + length
        need += (-need) % _ALIGN
        with self._lock:
            for i, (off, size) in enumerate(self._free):
                if size >= need:
                    if size == need:
                        self._free.pop(i)
                    else:
                        self._free[i] = (off + need, size - need)
                    self._gen = (self._gen % 0xFFFFFFFE) + 1
                    gen = self._gen
                    _SLAB.pack_into(self._buf, off, gen, length)
                    pay_off = off + _SLAB.size
                    at, crc = pay_off, 0
                    for p in parts:
                        self._buf[at:at + len(p)] = p
                        crc = crc32c(p, crc)
                        at += len(p)
                    self._slabs[pay_off] = (gen, off, need)
                    return {"seg": self.seg, "rg": self.region,
                            "off": pay_off, "len": length,
                            "crc": crc, "gen": gen,
                            "ep": self.epoch}
            self.alloc_failures += 1
            raise ArenaFull(f"{length}B, region {self.region}")

    def free(self, pay_off: int) -> bool:
        """Release a slab by payload offset. Idempotent (the router may
        free twice across a reconnect). The gen word is zeroed first,
        so a concurrent reader fails closed."""
        with self._lock:
            slab = self._slabs.pop(int(pay_off), None)
            if slab is None:
                return False
            _, ext_off, ext_len = slab
            _SLAB.pack_into(self._buf, ext_off, 0, 0)
            self._free.append((ext_off, ext_len))
            self._free.sort()
            merged: List[Tuple[int, int]] = []
            for off, size in self._free:
                if merged and merged[-1][0] + merged[-1][1] == off:
                    merged[-1] = (merged[-1][0], merged[-1][1] + size)
                else:
                    merged.append((off, size))
            self._free = merged
            return True


class WorkerArena:
    """A worker's side: the router's segment attached once, writes into
    this worker's region, reads of any region's slabs, and the counts of
    the ``tpu_inf_kv_plane_shm_*`` series."""

    def __init__(self, spec: dict):
        self.seg = spec["seg"]
        self.region = int(spec["region"])
        self.region_bytes = int(spec["region_bytes"])
        self.shm = attach(self.seg)
        self.writer = RegionWriter(self.shm.buf, self.region,
                                   self.region_bytes, int(spec["epoch"]),
                                   self.seg)
        self.puts = 0
        self.gets = 0
        self.put_bytes = 0
        self.get_bytes = 0

    def publish(self, payload: bytes) -> dict:
        return self.publish_parts((payload,))

    def publish_parts(self, parts) -> dict:
        desc = self.writer.alloc_parts(parts)
        self.puts += 1
        self.put_bytes += desc["len"]
        return desc

    def read(self, desc: dict) -> bytes:
        if desc.get("seg") != self.seg:
            raise ArenaStale("seg", f"{desc.get('seg')} != {self.seg}")
        payload = read_slab(self.shm.buf, desc, self.region_bytes)
        self.gets += 1
        self.get_bytes += len(payload)
        return payload

    def free(self, pay_off: int) -> bool:
        return self.writer.free(pay_off)

    def close(self) -> None:
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass


class ArenaSegment:
    """The router's side: creates the segment, hands out regions, bumps
    epochs at reclaim and unlinks at teardown. It never allocates a
    slab: it reads descriptors and writes epoch words."""

    def __init__(self, total_bytes: int, regions: int):
        from multiprocessing import shared_memory
        regions = max(1, int(regions))
        region_bytes = max(_REGION_HDR + _ALIGN,
                           (int(total_bytes) // regions) & ~(_ALIGN - 1))
        size = region_bytes * regions
        if os.path.isdir(_SHM_DIR):
            free = shutil.disk_usage(_SHM_DIR).free
            if size > free:
                raise ArenaError(
                    "space", f"{size} B arena > {free} B free in {_SHM_DIR}")
        self.region_bytes = region_bytes
        self.regions = regions
        self.shm = shared_memory.SharedMemory(create=True, size=size)
        self.name = self.shm.name
        _OWNED.add(self.name)
        for rg in range(regions):
            _EPOCH.pack_into(self.shm.buf, rg * region_bytes, 1)
        self._closed = False

    def region_spec(self, rg: int) -> Optional[dict]:
        """One worker's entry of the boot envelope, or None past the
        region count (a worker added later, by a scale-up or a rollout,
        rides the relay plane)."""
        if not (0 <= rg < self.regions) or self._closed:
            return None
        return {"seg": self.name, "region": rg,
                "region_bytes": self.region_bytes,
                "epoch": self.epoch(rg)}

    def epoch(self, rg: int) -> int:
        (ep,) = _EPOCH.unpack_from(self.shm.buf, rg * self.region_bytes)
        return ep

    def bump_epoch(self, rg: int) -> int:
        """Invalidate every outstanding descriptor of region ``rg``; the
        fresh incarnation mints under the returned epoch."""
        ep = (self.epoch(rg) % 0xFFFFFFFE) + 1
        _EPOCH.pack_into(self.shm.buf, rg * self.region_bytes, ep)
        return ep

    def read(self, desc: dict) -> bytes:
        return read_slab(self.shm.buf, desc, self.region_bytes)

    def close(self, unlink: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass
        if unlink:
            try:
                self.shm.unlink()
            except (OSError, FileNotFoundError):
                pass
        _OWNED.discard(self.name)
        _DETACHED.discard(self.name)


class SlabDirectory:
    """The router's books of outstanding slabs: registered when a
    descriptor arrives (fabric put, handoff, migrate), released when its
    last consumer drops it, drained as per-region free batches for the
    stats tick, and reclaimed, with a count, when the owning incarnation
    dies."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: Dict[Tuple[int, int], dict] = {}
        self._pending: Dict[int, List[int]] = {}
        self.reclaims = 0
        self.released = 0

    @property
    def slabs_live(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def slabs_tracked(self) -> int:
        """Live plus released but not yet freed (the owner applies the
        frees on its next stats tick)."""
        with self._lock:
            return len(self._live) + sum(
                len(v) for v in self._pending.values())

    def register(self, desc: dict) -> None:
        with self._lock:
            self._live[(int(desc["rg"]), int(desc["off"]))] = desc

    def release(self, desc: dict) -> None:
        """Idempotent: only a tracked slab moves to its region's
        pending frees (a second release, or one after a reclaim, does
        nothing)."""
        key = (int(desc["rg"]), int(desc["off"]))
        with self._lock:
            if self._live.pop(key, None) is None:
                return
            self._pending.setdefault(key[0], []).append(key[1])
            self.released += 1

    def drain_free(self, rg: int) -> List[int]:
        with self._lock:
            return self._pending.pop(int(rg), [])

    def requeue_free(self, rg: int, offs: List[int]) -> None:
        """Put a drained batch back: the stats call that carried it
        failed, the next tick retries."""
        if not offs:
            return
        with self._lock:
            self._pending.setdefault(int(rg), []).extend(offs)

    def reclaim(self, rg: int) -> int:
        """Drop everything the dead incarnation owned and count it. The
        epoch bump (``ArenaSegment.bump_epoch``) makes the dropped
        descriptors fail closed; this settles the books."""
        rg = int(rg)
        with self._lock:
            dead = [k for k in self._live if k[0] == rg]
            for k in dead:
                del self._live[k]
            n = len(dead) + len(self._pending.pop(rg, []))
            self.reclaims += n
            return n
