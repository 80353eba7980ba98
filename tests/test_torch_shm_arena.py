"""The port's shared-memory KV plane on the CPU against the reference
(twin of tests/test_shm_arena.py).

- The decision table of ``effective_kv_plane`` against the reference's.
- Arena units: the same operation sequences through the reference's
  ``RegionWriter``/``SlabDirectory`` and the port's, each on a segment
  of its own, give equal descriptors (the segment name aside), equal
  segment bytes after every operation, and the same error types and
  reasons: alloc/read/free with coalescing, a freed slab failing
  closed, ``ArenaFull``, CRC and bounds rejection typed apart from
  staleness, the dead-incarnation reclaim, the batched frees, a
  concurrent reader never adopting recycled bytes.
- Cross-package slabs: the reference's writer into the port's segment
  read by the port, and the other way round; a descriptor per KV
  quantization read back and deserialized by the reference.
- Real fleets from a checkpoint the test writes, tokens against the
  reference dp-1 engine: a 1 prefill + 1 decode fleet on the shm plane
  with no handoff or fabric-publish byte through the router, a region
  reclaim that stales every descriptor and serves the same tokens, the
  leak invariants (``tests._leak.assert_arena_clean``); a mixed dp-2
  fleet through a kill -9 with a warm boot read from the arena, a
  SIGTERM drain that migrates by descriptor, and a corrupt slab
  rejected and counted.
"""

import pathlib
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tests._leak import assert_arena_clean, assert_fabric_clean
from tests.test_torch_kv_fabric import (PROMPT, TIMEOUT, _cfg, _finish,
                                        _hold_respawn, _submit, _wait)
from tests.test_torch_kv_fabric import ckpt, oracle  # noqa: F401 — fixtures
from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as rkvc
from tpu_inference.server import shm_arena as ref
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.server import shm_arena as port

pytestmark = pytest.mark.skipif(
    not sys.platform.startswith("linux"),
    reason="the shm arena needs POSIX shared memory (Linux)")

PKGS = (ref, port)


@pytest.fixture()
def segs():
    """One segment per package, the same geometry."""
    out = [m.ArenaSegment(64 * 1024, regions=4) for m in PKGS]
    yield out
    for s in out:
        s.close()


def _strip(desc):
    return {k: v for k, v in desc.items() if k != "seg"}


def _same_bytes(segs):
    a, b = (bytes(s.shm.buf[:s.region_bytes * s.regions]) for s in segs)
    assert a == b


def _both(segs, fn):
    """fn(module, segment) on each package; the results, or the type and
    reason of what each raised, must be equal."""
    out = []
    for m, s in zip(PKGS, segs):
        try:
            r = fn(m, s)
            out.append(("ok", _strip(r) if isinstance(r, dict) else r))
        except m.ArenaError as e:
            out.append((type(e).__name__, e.reason))
    assert out[0] == out[1], out
    return out[1]


# ------------------------------------------------------------ resolution


def test_effective_kv_plane_decision_table(monkeypatch):
    """shm only for the process fleet on Linux; every other combination
    rides the relay plane, as the reference decides."""
    table = {}
    for platform in ("linux", "darwin"):
        monkeypatch.setattr(sys, "platform", platform)
        for plane in ("relay", "shm"):
            for fleet in ("in-process", "subprocess"):
                scfg = jcfg.ServerConfig(model_name="t", tokenizer="byte",
                                         kv_plane=plane, fleet=fleet)
                got = port.effective_kv_plane(scfg)
                assert got == ref.effective_kv_plane(scfg)
                table[(platform, plane, fleet)] = got
    assert [k for k, v in table.items() if v == "shm"] == [
        ("linux", "shm", "subprocess")]


# ----------------------------------------------------------- slab units


def test_slab_alloc_read_free_roundtrip(segs):
    ws = [m.WorkerArena(s.region_spec(0)) for m, s in zip(PKGS, segs)]
    payloads = [bytes([i]) * (17 + 13 * i) for i in range(5)]
    descs = []
    for p in payloads:
        d = [w.publish(p) for w in ws]
        assert _strip(d[0]) == _strip(d[1])
        assert d[1]["len"] == len(p) and d[1]["gen"] > 0 and d[1]["ep"] == 1
        descs.append(d)
        _same_bytes(segs)
    for d, p in zip(descs, payloads):
        for w, s, dd in zip(ws, segs, d):
            assert w.read(dd) == p and s.read(dd) == p
    for a in ("puts", "gets", "put_bytes", "get_bytes"):
        assert getattr(ws[0], a) == getattr(ws[1], a)
    for d in descs:
        assert [w.free(dd["off"]) for w, dd in zip(ws, d)] == [True, True]
        assert [w.free(dd["off"]) for w, dd in zip(ws, d)] == [False, False]
        _same_bytes(segs)
    for w in ws:
        assert w.writer.slabs_used == 0 and w.writer.bytes_used == 0
        assert len(w.writer._free) == 1
        w.close()


def test_free_slab_read_fails_closed(segs):
    ws = [m.WorkerArena(s.region_spec(0)) for m, s in zip(PKGS, segs)]
    d = [w.publish(b"x" * 100) for w in ws]
    for w, dd in zip(ws, d):
        w.free(dd["off"])
    assert _both(segs, lambda m, s: s.read(d[PKGS.index(m)])) == (
        "ArenaStale", "gen")
    d2 = [w.publish(b"y" * 100) for w in ws]
    assert _strip(d2[0]) == _strip(d2[1])
    assert d2[1]["off"] == d[1]["off"] and d2[1]["gen"] != d[1]["gen"]
    assert _both(segs, lambda m, s: s.read(d[PKGS.index(m)]))[0] == \
        "ArenaStale"
    assert _both(segs, lambda m, s: s.read(d2[PKGS.index(m)])) == (
        "ok", b"y" * 100)
    _same_bytes(segs)
    for w in ws:
        w.close()


def test_arena_full_signals_relay_fallback(segs):
    ws = [m.WorkerArena(s.region_spec(0)) for m, s in zip(PKGS, segs)]
    big = b"z" * (segs[1].region_bytes // 2)
    for w in ws:
        w.publish(big)
    assert _both(segs, lambda m, s: ws[PKGS.index(m)].publish(big)) == (
        "ArenaFull", "full")
    assert [w.writer.alloc_failures for w in ws] == [1, 1]
    # One writer per region: region 1's writer is unaffected.
    w1 = [m.WorkerArena(s.region_spec(1)) for m, s in zip(PKGS, segs)]
    d = [w.publish(big) for w in w1]
    assert _strip(d[0]) == _strip(d[1]) and d[1]["rg"] == 1
    _same_bytes(segs)
    for w in ws + w1:
        w.close()


def test_crc_rejection_typed_apart_from_stale(segs):
    """Corruption (payload bytes, length word, bounds) is ArenaCorrupt;
    staleness (epoch, gen) is ArenaStale; both packages agree on each
    type and reason."""
    ws = [m.WorkerArena(s.region_spec(0)) for m, s in zip(PKGS, segs)]
    d = [w.publish(b"payload" * 40) for w in ws]
    pick = lambda m: d[PKGS.index(m)]
    for s, dd in zip(segs, d):
        s.shm.buf[dd["off"] + 3] ^= 0xFF
    assert _both(segs, lambda m, s: s.read(pick(m))) == ("ArenaCorrupt",
                                                         "crc")
    for s, dd in zip(segs, d):
        s.shm.buf[dd["off"] + 3] ^= 0xFF
    assert _both(segs, lambda m, s: s.read(pick(m))) == ("ok",
                                                         b"payload" * 40)
    assert _both(segs, lambda m, s: s.read(
        dict(pick(m), len=pick(m)["len"] - 1, crc=0))) == (
        "ArenaCorrupt", "len")
    assert _both(segs, lambda m, s: s.read(
        dict(pick(m), off=s.region_bytes * s.regions + 64))) == (
        "ArenaCorrupt", "bounds")
    assert _both(segs, lambda m, s: s.read(
        dict(pick(m), ep=pick(m)["ep"] + 1))) == ("ArenaStale", "epoch")
    assert _both(segs, lambda m, s: ws[PKGS.index(m)].read(
        dict(pick(m), seg="elsewhere"))) == ("ArenaStale", "seg")
    for w in ws:
        w.close()


def test_generation_reclaim_after_owner_death(segs):
    """The kill -9 story on both packages: the owner dies holding slabs,
    the supervisor reclaims the region (books and epoch), every
    outstanding descriptor fails closed, and the respawned incarnation's
    spec mints readable slabs."""
    got = []
    for m, s in zip(PKGS, segs):
        w = m.WorkerArena(s.region_spec(0))
        adir = m.SlabDirectory()
        descs = [w.publish(bytes([i]) * 64) for i in range(3)]
        for d in descs:
            adir.register(d)
        adir.release(descs[2])
        row = [adir.slabs_live, adir.slabs_tracked]
        w.close()
        row += [adir.reclaim(0), adir.reclaims, adir.slabs_tracked,
                s.bump_epoch(0)]
        for d in descs:
            with pytest.raises(m.ArenaStale):
                s.read(d)
        adir.release(descs[0])
        row.append(adir.slabs_tracked)
        w2 = m.WorkerArena(s.region_spec(0))
        d2 = w2.publish(b"fresh" * 10)
        row += [d2["ep"], s.read(d2), _strip(d2)]
        w2.close()
        got.append(row)
    assert got[0] == got[1]
    assert got[1][:8] == [2, 3, 3, 3, 0, 2, 0, 2]
    _same_bytes(segs)


def test_slab_directory_free_batching(segs):
    """Release, drain, the stats call, the owner's free, and the requeue
    of a batch whose call failed: the same on both packages."""
    got = []
    for m, s in zip(PKGS, segs):
        w = m.WorkerArena(s.region_spec(0))
        adir = m.SlabDirectory()
        d = w.publish(b"a" * 32)
        adir.register(d)
        adir.release(d)
        offs = adir.drain_free(0)
        row = [offs, adir.drain_free(0)]
        adir.requeue_free(0, offs)
        adir.requeue_free(0, [])
        offs = adir.drain_free(0)
        row += [offs, [w.free(o) for o in offs], w.writer.slabs_used,
                adir.released]
        w.close()
        got.append(row)
    assert got[0] == got[1]
    assert got[1][1:] == [[], got[1][0], [True], 0, 1]
    _same_bytes(segs)


def test_concurrent_reader_never_adopts_recycled_bytes(segs):
    """Readers of both packages hammer one descriptor of the port's
    writer while it frees and recycles the extent with other bytes:
    every read returns the original payload or raises."""
    seg = segs[1]
    w = port.WorkerArena(seg.region_spec(0))
    payload = b"\xAA" * 4096
    d = w.publish(payload)
    stop = threading.Event()
    bad = []

    def reader(read_slab, errors):
        while not stop.is_set():
            try:
                got = read_slab(seg.shm.buf, d, seg.region_bytes)
            except errors:
                continue
            if got != payload:
                bad.append(got[:8])
                return

    threads = [threading.Thread(target=reader, args=(
        m.read_slab, (m.ArenaStale, m.ArenaCorrupt))) for m in PKGS * 2]
    for t in threads:
        t.start()
    time.sleep(0.02)
    w.free(d["off"])
    for i in range(50):
        dn = w.publish(bytes([i % 251]) * 4096)
        w.free(dn["off"])
    stop.set()
    for t in threads:
        t.join(timeout=5.0)
    assert not bad, f"a reader adopted recycled bytes: {bad[0]!r}"
    w.close()


def test_cross_package_slabs_read_both_ways(segs):
    """The reference's writer in the port's segment, read by the port,
    and the port's writer in the reference's segment, read by the
    reference: the same payloads; a freed slab fails closed on either
    side with the other's error type."""
    for wm, rm, s in ((ref, port, segs[1]), (port, ref, segs[0])):
        w = wm.WorkerArena(s.region_spec(2))
        r = rm.WorkerArena(s.region_spec(3))
        payloads = [bytes([7 * i % 256]) * (40 + 33 * i) for i in range(4)]
        descs = [w.publish_parts((p[:9], p[9:])) for p in payloads]
        for d, p in zip(descs, payloads):
            assert r.read(d) == p
            assert rm.read_slab(s.shm.buf, d, s.region_bytes) == p
        w.free(descs[1]["off"])
        with pytest.raises(rm.ArenaStale):
            r.read(descs[1])
        assert r.gets == 4 and r.get_bytes == sum(len(p) for p in payloads)
        w.close()
        r.close()


def _pages(quant: str, tag: int):
    """(port HostKVPage, reference HostKVPage) pairs on the same numpy
    arrays, in the layout of each KV quantization."""
    rng = np.random.default_rng(100 + tag)
    if quant == "none":
        arrs = [rng.standard_normal((2, 8, 2, 16)).astype(np.float32)
                for _ in range(2)]
    else:
        code_dt = np.uint8 if quant == "int4" else np.int8
        d = 8 if quant == "int4" else 16
        arrs = [rng.integers(0, 255, (2, 8, 2, d)).astype(code_dt)
                for _ in range(2)]
        arrs += [rng.standard_normal((2, 8, 2)).astype(np.float32)
                 for _ in range(2)]
    return (tkvc.HostKVPage(*[torch.from_numpy(a.copy()) for a in arrs]),
            rkvc.HostKVPage(*arrs))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_descriptor_roundtrip_per_kv_quant(quant, segs):
    """The port's serialized pages through a slab (gather-written from
    their parts) read back by the owner, the router's segment, a second
    worker and the reference's reader, and deserialized by the
    reference: its own serialization's bytes and pages exactly."""
    seg = segs[1]
    src = port.WorkerArena(seg.region_spec(0))
    dst = port.WorkerArena(seg.region_spec(1))
    pairs = [_pages(quant, i) for i in range(3)]
    parts = tkvc.serialize_host_pages_parts([t for t, _ in pairs])
    blob = rkvc.serialize_host_pages([r for _, r in pairs])
    desc = src.publish_parts(parts)
    assert desc["len"] == len(blob)
    for read in (lambda: src.read(desc), lambda: seg.read(desc),
                 lambda: dst.read(desc),
                 lambda: ref.read_slab(seg.shm.buf, desc, seg.region_bytes)):
        got = read()
        assert got == blob
        pages = rkvc.deserialize_host_pages(got)
        for g, (_, r) in zip(pages, pairs):
            for f in ("k", "v", "k_scale", "v_scale"):
                x, y = getattr(g, f), getattr(r, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
    assert dst.gets == 1 and dst.get_bytes == len(blob)
    assert src.puts == 1 and src.put_bytes == len(blob)
    src.close()
    dst.close()


def test_arena_larger_than_dev_shm_is_refused(monkeypatch):
    """The port's one check the reference does not make: a segment past
    /dev/shm's free space would map and then kill its first writer past
    the space with SIGBUS, so it is refused (the fleet rides the relay
    plane), and no segment is created."""
    from multiprocessing import shared_memory
    made = []
    monkeypatch.setattr(shared_memory, "SharedMemory",
                        lambda *a, **kw: made.append((a, kw)))
    free = 1 << 20
    monkeypatch.setattr(port.shutil, "disk_usage",
                        lambda p: type("U", (), {"free": free})())
    with pytest.raises(port.ArenaError) as ei:
        port.ArenaSegment(4 * free, regions=4)
    assert ei.value.reason == "space"
    assert made == []


def test_metric_names_are_the_references_but_one():
    """Every ``tpu_inf_*`` series the reference constructs, the port
    constructs too, except the TPU int4 Mosaic gate, and the port's own
    names are exactly ``telemetry.PORT_SERIES`` (the metric catalog's
    literal grep)."""
    from tpu_inference_torch import telemetry

    root = pathlib.Path(__file__).resolve().parent.parent
    lit = re.compile(r'"(tpu_inf_[a-z0-9_]+)"')

    def names(pkg):
        return {n for p in (root / pkg).rglob("*.py")
                for n in lit.findall(p.read_text())}

    r, t = names("tpu_inference"), names("tpu_inference_torch")
    assert r - t == {"tpu_inf_degraded_mode"}
    assert t - r == set(telemetry.PORT_SERIES)


# ------------------------------------------------------ fleets end to end

SHM_KW = dict(kv_plane="shm", shm_arena_bytes=8 * 1024 * 1024,
              fabric_cache_pages=64, fabric_publish_min_pages=1)
# Prompts of several full pages (PROMPT is 4 and a straggler) and short
# ones (a handoff of a partial page).
PROMPTS = [list(PROMPT), [1, 2, 3, 4, 5], [9, 8, 7] * 6]


def _want(oracle, prompt, n):
    return oracle.generate([list(prompt)], max_new_tokens=n)[0]


@pytest.fixture(scope="module")
def shm_pd_fleet(ckpt):
    """1 prefill + 1 decode worker on the shm plane with the fabric pool
    armed: the handoff and the fabric publish each have a descriptor
    path here."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(
        _cfg(ckpt, worker_roles=("prefill", "decode"), **SHM_KW),
        device="cpu")
    group.start()
    yield group
    group.stop(drain=False)
    assert group.arena is None


def test_shm_plane_handoff_zero_blob_bytes(shm_pd_fleet, oracle):
    """The P/D handoff and the fabric publishes move only descriptors
    through the router (their rpc_blob_bytes rows stay 0), the decode
    worker adopts out of the arena, and the tokens are the reference
    dp-1 engine's."""
    group = shm_pd_fleet
    _wait(lambda: all(h.state == "up" for h in group.workers),
          what="the fleet up")
    assert group.arena is not None
    pend = [_submit(group, 8100 + i, p, 16) for i, p in enumerate(PROMPTS)]
    for (toks, done, box), p in zip(pend, PROMPTS):
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, p, 16)
    assert group.pd_handoffs >= len(PROMPTS)
    assert group.rpc_blob_bytes["handoff"] == 0
    assert group.rpc_blob_bytes["fabric_put"] == 0
    assert group.fabric.used >= 4 and group.fabric.bytes_used > 0
    assert all(e.desc is not None for e in group.fabric._entries.values())
    hs = group.health_snapshot()
    assert hs["replicas"][1]["pd_adoptions"] >= len(PROMPTS)
    assert hs["replicas"][1]["pd_adopt_fallbacks"] == 0
    stats = [h.client.rpc("stats") for h in group.workers]
    assert stats[0]["arena"]["puts"] >= len(PROMPTS) + 4
    assert stats[1]["arena"]["gets"] >= len(PROMPTS)
    assert [s["arena"]["alloc_failures"] for s in stats] == [0, 0]
    assert [s["arena"]["region"] for s in stats] == [0, 1]
    pt = group.prometheus_text()
    assert 'tpu_inf_rpc_blob_bytes_total{verb="handoff"} 0' in pt
    assert "tpu_inf_shm_slabs_total" in pt
    assert "tpu_inf_kv_plane_shm_puts_total" in pt
    gets = [float(v) for v in re.findall(
        r'tpu_inf_kv_plane_shm_gets_total\{replica="1"\} (\S+)', pt)]
    assert gets and gets[0] >= len(PROMPTS)


def test_shm_reclaim_staleness_falls_back_byte_identical(
        shm_pd_fleet, oracle):
    """Reclaim the prefill worker's region (what the supervisor does
    after a kill -9): every descriptor it minted is stale, the pool's
    entries of that region are gone, and the same prompt is served again
    with the same tokens through the recompute fallbacks."""
    group = shm_pd_fleet
    prompt = [7, 7, 1, 2] * 5
    toks1, done, box = _submit(group, 8200, prompt, 12)
    _finish(done, box)
    assert toks1 == _want(oracle, prompt, 12)
    pooled = [e.desc for e in group.fabric._entries.values()]
    in_region = sum(int(d["rg"]) == 0 for d in pooled)
    assert in_region > 0
    reclaims0 = group.shm_reclaims
    n = group._reclaim_region(0)
    assert n >= in_region
    assert group.shm_reclaims == reclaims0 + n
    assert group.arena.epoch(0) == 2
    for d in pooled:
        with pytest.raises(port.ArenaStale):
            group.arena.read(d)
    assert not any(int(e.desc["rg"]) == 0
                   for e in group.fabric._entries.values())
    toks2, done, box = _submit(group, 8201, prompt, 12)
    fin = _finish(done, box)
    assert fin.finish_reason == "length"
    assert toks2 == toks1


def test_shm_fleet_leak_invariants(shm_pd_fleet):
    """Once the mixes above settled, the pool's descriptors are the only
    live slabs, and clearing the pool releases every one."""
    group = shm_pd_fleet
    _wait(lambda: not group._tracked, timeout=30.0, what="requests settled")
    assert_fabric_clean(group.fabric)
    assert_arena_clean(group)
    assert group._arena_dir.slabs_live == 0


def test_shm_mixed_fleet_kill9_warmboot_drain_and_corrupt_slab(
        ckpt, oracle):
    """A mixed dp-2 fleet on the shm plane:
    - kill -9 of the worker that does not hold the pooled prefix, with a
      request routed there: the tokens are the reference's, and the
      respawn's warm boot reads every pooled page out of the arena (no
      relayed byte);
    - a flipped byte in a pooled slab: the next warm boot rejects that
      page, the pool drops it, and both sides count the rejection;
    - SIGTERM of the worker decoding a long request: the drain migrates
      it by descriptor (no migrate or import byte through the router),
      and the tokens are the reference's."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, **SHM_KW), device="cpu")
    group.start()
    try:
        assert group.arena is not None
        toks, done, box = _submit(group, 9500, PROMPT, 8)
        fin = _finish(done, box)
        assert toks == _want(oracle, PROMPT, 8)
        a, b = fin.routed_replica, 1 - fin.routed_replica
        hb = group.workers[b]
        _wait(lambda: group.fabric.used == 4, what="the prefix pooled")
        assert {int(e.desc["rg"]) for e in group.fabric._entries.values()} \
            == {a}

        # kill -9 of b under a request routed there (the pool's pages
        # are in a's region, which b's reclaim leaves alone).
        prompt_b = [11, 12, 13] * 3
        routable = group._routable
        group._routable = lambda: [hb]
        toks, done, box = _submit(group, 9501, prompt_b, 40)
        group._routable = routable
        _wait(lambda: len(toks) >= 2, what="decode under way")
        group.apply_chaos({"replica": b, "kill": "kill9"})
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, prompt_b, 40)
        _wait(lambda: hb.state == "up" and hb.incarnation == 2,
              timeout=TIMEOUT, what="the respawn")
        wb = hb.warmboots[-1]
        assert wb["incarnation"] == 2
        assert wb["desc_pages"] >= 4 and wb["adopted"] == wb["desc_pages"]
        assert wb["relay_bytes"] == 0
        assert group.arena.epoch(b) == 2 and group.arena.epoch(a) == 1

        # A corrupt slab in a's region, read by b's next warm boot.
        entries = [(d, e.desc) for d, e in group.fabric._entries.items()
                   if int(e.desc["rg"]) == a]
        digest, desc = entries[0]
        group.arena.shm.buf[int(desc["off"]) + 5] ^= 0xFF
        rej0 = group._kv_rejections_total()
        group.apply_chaos({"replica": b, "kill": "kill9"})
        _wait(lambda: hb.state == "up" and hb.incarnation == 3,
              timeout=TIMEOUT, what="the second respawn")
        wb = hb.warmboots[-1]
        assert wb["adopted"] == wb["desc_pages"] - 1
        assert digest not in group.fabric._entries
        assert group.fabric.kv_rejections == 1
        _wait(lambda: group._kv_rejections_total() == rej0 + 2,
              timeout=30.0, what="the worker's rejection in its health")
        assert group.health_snapshot()["replicas"][b][
            "kv_integrity_rejections"] == 1

        # SIGTERM drain mid-decode: migrate by descriptor.
        long_prompt = [(5 * i + 2) % 500 for i in range(27)]
        toks, done, box = _submit(group, 9502, long_prompt, 28)
        _wait(lambda: len(toks) >= 4, what="decode under way")
        src = group._tracked[9502].worker
        migrated0 = group.migrated_bytes
        group.apply_chaos({"replica": src.replica, "kill": "sigterm"})
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, long_prompt, 28)
        assert group.migrations == 1
        assert group.migrated_bytes > migrated0
        assert group.rpc_blob_bytes["migrate"] == 0
        assert group.rpc_blob_bytes["import-kv"] == 0
        _wait(lambda: src.state == "up", timeout=TIMEOUT,
              what="the drained worker back")
        assert group.shm_reclaims >= 1
        assert re.search(r"^tpu_inf_shm_reclaims_total [1-9]",
                         group.prometheus_text(), re.M)
    finally:
        group.stop(drain=False)
    assert all(h.proc.poll() is not None for h in group.workers)


def test_shm_migrate_salvage_with_no_other_worker(ckpt, oracle):
    """The shm twin of the fabric suite's salvage, at the default
    re-route grace, where the drained worker's own respawn is the only
    destination: SIGTERM mid-decode while the sibling is down (its
    respawn held until the request ends). The salvage copies the drain's
    export out of the arena and lets its slab go before the retry waits
    for a routable worker, so the drained worker's respawn, whose region
    reclaim waits for reads of that region, is not held behind the
    retry (and the monitor with it) until the grace runs out. The
    retry's dispatch pulls the parked prefix back; tokens equal the
    oracle's."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(
        _cfg(ckpt, fabric_warmboot_pages=0, **SHM_KW), device="cpu")
    group.start()
    try:
        assert group.arena is not None
        parked, reads_at_salvage = [], []
        orig = group._fabric_salvage
        release = _hold_respawn(group, 1)

        def salvage(digests, blob, rid, path):
            reads_at_salvage.append(dict(group._arena_reads))
            parked.append((path, orig(digests, blob, rid, path)))
            return parked[-1][1]

        group._fabric_salvage = salvage
        group.apply_chaos({"replica": 1, "kill": "kill9"})
        _wait(lambda: group.workers[1].state != "up",
              what="the sibling down")
        toks, done, box = _submit(group, 9600, PROMPT, 28)
        _wait(lambda: len(toks) >= 4, what="decode under way")
        group.apply_chaos({"replica": 0, "kill": "sigterm"})
        fin = _finish(done, box)
        release()
        assert parked and parked[0][0] == "migrate" and parked[0][1] >= 4
        assert reads_at_salvage == [{0: 0}]
        assert fin.finish_reason == "length"
        assert fin.routed_replica == 0
        assert group.workers[0].incarnation == 2
        assert toks == _want(oracle, PROMPT, 28)
        assert fin.route_fabric_hit_pages == 4
        assert group.rpc_blob_bytes["migrate"] == 0
    finally:
        group.stop(drain=False)
