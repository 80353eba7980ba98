"""The port's fleet KV fabric on the CPU against the reference (twin of
tests/test_kv_fabric.py, and of the fabric paths the reference drives
only through its harness).

- Pool units: one operation sequence through the reference's
  ``FabricPool`` and the port's, pages from a numpy seed in every pool
  layout: LRU and byte accounting, dedup and supersede, contiguous
  ``match_depth``, capacity 0, the MRU hot set, a corrupt blob rejected
  on ``get``. Snapshots, orders and blobs must be equal.
- The routing formulas (four temperatures) equal to the reference's on
  a grid of inputs.
- The engine publish hook: the reference engine and the port engine on
  the same tiny float32 weights publish the same digests in the same
  order, once each, under the min-pages rule.
- The warm-once flow through both port backends: tokens equal to the
  reference dp-1 engine's, the reference's /healthz and /metrics keys.
- Warm boot after ``kill -9``, handoff and migrate salvage, the
  publish watermark gate, a malformed ``fabric_put`` frame and the four
  CLI flags, each against the reference's function where one exists.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from tests import _prom
from tests._leak import assert_fabric_clean
from tests.test_torch_transport import _page_arrays, _to_torch
from tests.test_torch_weights import _tiny_llama_checkpoint
from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as rkvc
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import weights as jw
from tpu_inference.server import kv_fabric as rfab
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.server import kv_fabric as tfab

# tests/test_kv_fabric.py's geometry: the raised preempt watermark makes
# chaos page pressure (every free page held) put a replica under
# pressure while its own prefix cache stays resident.
ENGINE_KW = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
                 max_batch_size=2, prefill_buckets=(16,),
                 host_cache_pages=32, preempt_watermark_pages=40)
FABRIC_KW = dict(fabric_cache_pages=64, fabric_publish_min_pages=1)
# 33 tokens: 4 full pages of shared prefix and a straggler.
PROMPT = [(3 * i + 1) % 500 for i in range(33)]
TIMEOUT = 180.0
KINDS = ["f32", "int8", "int4"]


# ------------------------------------------------------------ pool units


def _pair_pages(kind: str, n: int, seed: int = 7):
    """n pages as (reference HostKVPage, port HostKVPage) pairs."""
    out = []
    for a in _page_arrays(kind, n=n, seed=seed):
        out.append((rkvc.HostKVPage(*a),
                    tkvc.HostKVPage(*(_to_torch(x) for x in a))))
    return out


def _digests(n: int):
    return [bytes([i]) * 16 for i in range(n)]


def _both(cap: int):
    return rfab.FabricPool(cap), tfab.FabricPool(cap)


def _blob(mod, page):
    return mod.serialize_host_pages([page])


def _same(ref, port):
    assert port.snapshot() == ref.snapshot()
    assert list(port._entries) == list(ref._entries)
    assert [e.blob for e in port._entries.values()] == \
        [e.blob for e in ref._entries.values()]
    assert port.free_pages == ref.free_pages


@pytest.mark.parametrize("kind", KINDS)
def test_pool_lru_and_accounting_equal_reference(kind):
    ref, port = _both(4)
    pages = _pair_pages(kind, 6)
    d = _digests(6)
    for i in range(4):
        ref.put_blob(d[i], _blob(rkvc, pages[i][0]))
        port.put_blob(d[i], _blob(tkvc, pages[i][1]))
    _same(ref, port)
    # A get refreshes recency: the next overflow evicts d[1].
    gr, gp = ref.get_pages([d[0]]), port.get_pages([d[0]])
    assert [g[0] for g in gp] == [g[0] for g in gr] == [d[0]]
    assert tkvc.serialize_host_pages([gp[0][1]]) == \
        rkvc.serialize_host_pages([gr[0][1]])
    ref.put_blob(d[4], _blob(rkvc, pages[4][0]))
    port.put_blob(d[4], _blob(tkvc, pages[4][1]))
    _same(ref, port)
    assert port.evictions == 1 and port.match_depth([d[1]]) == 0
    for n in (0, 2, 9):
        assert port.hot_set(n) == ref.hot_set(n)
    assert [h[0] for h in port.hot_set(2)] == [d[4], d[0]]
    assert_fabric_clean(port)
    assert_fabric_clean(ref)


def test_pool_dedup_and_supersede_equal_reference():
    ref, port = _both(8)
    d = _digests(1)[0]
    (ra, pa), (rb, pb) = _pair_pages("f32", 2)
    for _ in range(2):
        ref.put_blob(d, _blob(rkvc, ra))
        port.put_blob(d, _blob(tkvc, pa))
    _same(ref, port)
    assert port.used == 1 and port.superseded == 1
    ref.put_blob(d, _blob(rkvc, rb))
    port.put_blob(d, _blob(tkvc, pb))
    _same(ref, port)
    got = port.get_pages([d])
    assert torch.equal(got[0][1].k, pb.k) and torch.equal(got[0][1].v, pb.v)
    assert_fabric_clean(port)


def test_pool_match_depth_contiguous_and_side_effect_free():
    ref, port = _both(8)
    pages = _pair_pages("int8", 4)
    d = _digests(4)
    for i in (0, 2):
        ref.put_blob(d[i], _blob(rkvc, pages[i][0]))
        port.put_blob(d[i], _blob(tkvc, pages[i][1]))
    for chain in (d[:3], [d[0]], [d[3]], [], d):
        assert port.match_depth(chain) == ref.match_depth(chain)
    assert port.match_depth(d[:3]) == 1
    assert (port.hits, port.misses) == (0, 0)
    _same(ref, port)


def test_pool_capacity_zero_noop():
    ref, port = _both(0)
    d = _digests(1)[0]
    (rp, pp), = _pair_pages("int4", 1)
    ref.put_blob(d, _blob(rkvc, rp))
    port.put_blob(d, _blob(tkvc, pp))
    assert port.put_pages([(d, pp)]) == ref.put_pages([(d, rp)]) == 1
    _same(ref, port)
    assert port.match_depth([d]) == 0 and port.get_pages([]) == []
    assert port.hot_set(4) == [] and port.free_pages == 0
    assert_fabric_clean(port)


@pytest.mark.parametrize("kind", KINDS)
def test_pool_get_rejects_corrupt_blob_equal_reference(kind):
    """One payload byte flipped in the middle entry: both pools serve
    the clean head only, drop the corrupt entry and count it; the clean
    entries round-trip bit-exactly, their scale rows included."""
    ref, port = _both(8)
    pages = _pair_pages(kind, 3)
    d = _digests(3)
    assert port.put_pages([(d[i], p) for i, (_, p) in enumerate(pages)]) \
        == ref.put_pages([(d[i], r) for i, (r, _) in enumerate(pages)]) == 3
    _same(ref, port)
    for pool in (ref, port):
        e = pool._entries[d[1]]
        raw = bytearray(e.blob)
        raw[len(raw) // 2] ^= 0xFF
        e.blob = bytes(raw)
    gr, gp = ref.get_pages(d), port.get_pages(d)
    assert [g[0] for g in gp] == [g[0] for g in gr] == [d[0]]
    _same(ref, port)
    assert port.kv_rejections == 1 and port.misses == 1 and port.used == 2
    want = pages[0][1]
    for a, b in zip(gp[0][1], want):
        assert (a is None and b is None) or torch.equal(a, b)
    ref.reject(d[2])
    port.reject(d[2])
    _same(ref, port)
    assert_fabric_clean(port)


# ------------------------------------------------------ routing formulas


def test_routing_formulas_equal_reference():
    """THE shared formulas on a grid, with the four temperatures
    ordered HBM < host < fabric < cold at the defaults."""
    import itertools

    for hw, fw in ((1.0, 0.25), (2.0, 0.0), (0.5, 0.75)):
        rc = jcfg.ServerConfig(route_hit_weight=hw,
                               route_fabric_hit_weight=fw)
        tc = tcfg.ServerConfig(route_hit_weight=hw,
                               route_fabric_hit_weight=fw)
        for pp, hbm, host, fab, load, pr in itertools.product(
                (1, 8), (0, 3), (0, 2), (0, 5), (0.0, 2.0), (False, True)):
            kw = dict(hbm=hbm, host=host, fabric=fab, load=load,
                      pressured=pr)
            assert tfab.prefill_route_score(tc, prompt_pages=pp, **kw) \
                == rfab.prefill_route_score(rc, prompt_pages=pp, **kw)
            for occ in (0.0, 0.5):
                assert tfab.decode_route_score(tc, occupancy=occ, **kw) \
                    == rfab.decode_route_score(rc, occupancy=occ, **kw)
            assert tfab.cold_route_key(pr, load) == \
                rfab.cold_route_key(pr, load)
    for f, w, p in itertools.product((0, 2, 10, 50), (0, 3, 5), (0, 8)):
        assert tfab.fabric_extra_pages(f, w, p) == \
            rfab.fabric_extra_pages(f, w, p)
    cfg = tcfg.ServerConfig()
    s = lambda **kw: tfab.prefill_route_score(
        cfg, prompt_pages=8, **{"hbm": 0, "host": 0, "fabric": 0,
                                "load": 0.0, "pressured": False, **kw})
    assert s(hbm=8) < s(host=8) < s(fabric=8) < s()
    assert s(hbm=8, pressured=True) > s()


# -------------------------------------------------- engine publish hook


def test_engine_publish_hook_equal_reference():
    """Both engines on the same weights publish the same digests in the
    same order, once each: a second pass over the prompt publishes
    nothing, a prompt under fabric_publish_min_pages never publishes.
    Page values agree within float32 tolerance (the two packages'
    matmuls round differently) and the blob headers but for the digest;
    the wire bytes of one page are the same in both (test_torch_transport)."""
    import json
    import struct

    from tests.test_torch_ladder import pair

    jm, params, tm, tp = pair()
    engines = {"ref": JEngine(jm, jcfg.EngineConfig(**ENGINE_KW),
                              params=params, attn_backend="dense"),
               "port": InferenceEngine(tm, tcfg.EngineConfig(**ENGINE_KW),
                                       params=tp, device="cpu")}
    published, outs = {}, {}
    prompt = [p % 256 for p in PROMPT]
    for name, eng in engines.items():
        published[name] = []
        eng.fabric_publish = published[name].extend
        eng.fabric_publish_min_pages = 2
        outs[name] = [eng.generate([list(prompt)], max_new_tokens=8)[0]]
        n1 = len(published[name])
        assert eng.fabric_published_pages == n1 == 4
        outs[name].append(eng.generate([list(prompt)], max_new_tokens=8)[0])
        eng.generate([[5, 6, 7]], max_new_tokens=4)
        assert len(published[name]) == n1
    assert outs["port"] == outs["ref"]
    assert [d for d, _ in published["port"]] == \
        [d for d, _ in published["ref"]]
    for (_, p), (_, q) in zip(published["port"], published["ref"]):
        assert isinstance(p, tkvc.HostKVPage)
        for a, b in ((p.k, q.k), (p.v, q.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=0, atol=1e-4)
        hdr = [json.loads(b[4:4 + struct.unpack(">I", b[:4])[0]])
               for b in (tkvc.serialize_host_pages([p]),
                         rkvc.serialize_host_pages([q]))]
        for h in hdr:
            h.pop("crc32c")
        assert hdr[0] == hdr[1]


# ---------------------------------------------- both backends end-to-end


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = _tiny_llama_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield path
    if old is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = old


def _cfg(ckpt, dp=2, **server_kw):
    server_kw.setdefault("fleet", "subprocess")
    server_kw.setdefault("worker_restart_max", 10)
    server_kw.setdefault("worker_restart_backoff_s", 0.1)
    server_kw.setdefault("drain_timeout_s", 8.0)
    return tcfg.FrameworkConfig(
        model=tcfg.tiny_llama(vocab_size=512),
        engine=tcfg.EngineConfig(**ENGINE_KW),
        parallel=tcfg.ParallelConfig(dp=dp),
        server=tcfg.ServerConfig(model_name="t", tokenizer="byte",
                                 warmup=False, **server_kw),
        checkpoint_path=ckpt)


@pytest.fixture(scope="module")
def oracle(ckpt):
    jm = jcfg.tiny_llama(vocab_size=512)
    return JEngine(jm, jcfg.EngineConfig(**ENGINE_KW),
                   params=jw.load_checkpoint(jm, ckpt), attn_backend="dense")


@pytest.fixture(scope="module")
def want(oracle):
    """The reference dp-1 engine's greedy tokens for PROMPT."""
    return oracle.generate([list(PROMPT)], max_new_tokens=8)[0]


@pytest.fixture(scope="module")
def fabric_fleet(ckpt):
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, **FABRIC_KW), device="cpu")
    group.start()
    yield group
    group.stop(drain=False)
    assert all(h.proc.poll() is not None for h in group.workers)


def _submit(group, rid, prompt, max_new):
    toks, done, box = [], threading.Event(), {}
    seq = Sequence(request_id=rid, prompt_tokens=list(prompt),
                   max_new_tokens=max_new)
    group.submit(seq, lambda s, t: toks.append(t),
                 lambda s: (box.update(seq=s), done.set()))
    return toks, done, box


def _finish(done, box, timeout=TIMEOUT):
    assert done.wait(timeout), "request did not finish"
    return box["seq"]


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _fabric_flow(group, want, *, pressure, unpressure, is_pressured):
    """tests/test_kv_fabric.py's warm-once flow: prefill the prefix on
    the replica the router picks, pressure that replica, and the same
    prompt served by the other one adopts pooled pages, with the dp-1
    reference engine's tokens."""
    toks1, done, box = _submit(group, 9100, PROMPT, 8)
    fin1 = _finish(done, box)
    assert fin1.finish_reason == "length" and toks1 == want
    seed = fin1.routed_replica
    assert seed in (0, 1)
    _wait(lambda: group.fabric.used >= 4, what="the fabric publish")
    pressure(seed)
    _wait(lambda: is_pressured(seed), what="the pressured replica")
    try:
        toks2, done, box = _submit(group, 9101, PROMPT, 8)
        fin2 = _finish(done, box)
    finally:
        unpressure(seed)
    assert fin2.routed_replica == 1 - seed
    assert fin2.route_fabric_hit_pages == 4
    assert fin2.route_hit_pages >= fin2.route_fabric_hit_pages
    assert toks2 == want
    sup = group.supervision_counters()
    assert sup["route_fabric_hits"] >= 1
    assert sup["fabric_puts"] >= 4 and sup["fabric_hits"] >= 4
    hs = group.health_snapshot()
    assert set(hs["fabric"]) == set(rfab.FabricPool(1).snapshot())
    assert hs["fabric"]["capacity_pages"] == 64
    assert hs["fabric"]["pages_used"] >= 4
    assert hs["fabric"]["kv_rejections"] == 0
    assert sum(r["routing"]["fabric_hit_pages"]
               for r in hs["replicas"]) >= 4
    return seed, fin2


def _fabric_meta_reference() -> dict:
    """The reference router's fabric series (names, types, help)."""
    from tpu_inference import telemetry as jtel
    from tpu_inference.server.fleet import ProcessEngineGroup as JGroup

    ref = JGroup(jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(vocab_size=512),
        engine=jcfg.EngineConfig(**ENGINE_KW),
        parallel=jcfg.ParallelConfig(dp=2),
        server=jcfg.ServerConfig(model_name="t", tokenizer="byte",
                                 warmup=False, **FABRIC_KW)))
    try:
        meta, _ = _prom.parse(
            jtel.render_prometheus([({}, ref._fleet_registry)]))
    finally:
        ref.stop(drain=False)
    return {n: m for n, m in meta.items() if "fabric" in n}


def _scrape(group) -> tuple:
    meta, samples = _prom.parse(group.prometheus_text())
    seen = set()
    for name, labels, _ in samples:
        key = (name, tuple(sorted(labels.items())))
        assert key not in seen, f"duplicate series {key}"
        seen.add(key)
    return meta, samples


def test_fabric_warm_once_subprocess(fabric_fleet, want):
    group = fabric_fleet
    _wait(lambda: all(h.state == "up" for h in group.workers),
          what="the fleet up")

    def is_pressured(i):
        return bool(group.health_snapshot()["replicas"][i]
                    .get("under_pressure"))

    seed, fin = _fabric_flow(
        group, want,
        pressure=lambda i: group.apply_chaos(
            {"replica": i, "page_pressure": 64}),
        unpressure=lambda i: group.apply_chaos(
            {"replica": i, "page_pressure": 0}),
        is_pressured=is_pressured)
    # The pulled pages reach the worker's timeline (/debug/requests) and
    # the router's route span.
    tl = [t for t in group.recent_snapshot(16)
          if t["trace_id"] == fin.trace_id]
    assert [(t["routed_replica"], t["route_fabric_hit_pages"])
            for t in tl] == [(1 - seed, 4)]
    route = [sp for sp in group.trace_snapshot(fin.trace_id)["spans"]
             if sp["name"] == "route"]
    assert [sp["attrs"]["fabric_hit"] for sp in route] == [4]
    reps = group.health_snapshot()["replicas"]
    assert reps[seed].get("fabric_published_pages", 0) >= 4
    assert group.rpc_blob_bytes["fabric_put"] > 0
    pull = group.fabric_pulls[-1]
    assert (pull["replica"], pull["pages"]) == (1 - seed, 4)
    meta, samples = _scrape(group)
    ref_meta = _fabric_meta_reference()
    assert {n: m for n, m in meta.items() if "fabric" in n
            and n != "tpu_inf_fabric_publish_skipped_total"} == ref_meta
    names = {n for n, _, _ in samples}
    for name in ("tpu_inf_fabric_pages_used", "tpu_inf_fabric_bytes_used",
                 "tpu_inf_fabric_puts_total", "tpu_inf_fabric_hits_total",
                 "tpu_inf_fabric_misses_total",
                 "tpu_inf_fabric_evictions_total",
                 "tpu_inf_route_fabric_hits_total"):
        assert name in names, name
    skipped = {lab.get("replica") for n, lab, _ in samples
               if n == "tpu_inf_fabric_publish_skipped_total"}
    assert skipped == {"0", "1"}
    assert meta["tpu_inf_fabric_publish_skipped_total"] == {
        "type": "counter",
        "help": "fabric publishes skipped by the pool-watermark gate"}


def test_warm_boot_after_kill9(fabric_fleet, want):
    """kill -9 of a worker that holds the prefix: the respawn adopts the
    pool's hot set before it is UP, and its first request with the
    prefix (the sibling pressured) is host-warm with no fabric pull."""
    group = fabric_fleet
    _wait(lambda: all(h.state == "up" for h in group.workers),
          what="the fleet up")
    if group.fabric.used < 4:               # this test alone
        toks, done, box = _submit(group, 9200, PROMPT, 8)
        _finish(done, box)
        _wait(lambda: group.fabric.used >= 4, what="the fabric publish")
    seen = []
    orig = group._fabric_warmboot

    def spy(h, client):
        seen.append((h.replica, h.incarnation, h.state))
        return orig(h, client)

    group._fabric_warmboot = spy
    try:
        victim = group.workers[0]
        inc = victim.incarnation
        group.apply_chaos({"replica": 0, "kill": "kill9"})
        _wait(lambda: victim.incarnation > inc and victim.state == "up",
              timeout=120.0, what="the respawn")
    finally:
        group._fabric_warmboot = orig
    assert seen and seen[-1][:2] == (0, victim.incarnation)
    assert seen[-1][2] != "up", "adopted only after the UP flip"
    boot = victim.warmboots[-1]
    assert boot["incarnation"] == victim.incarnation
    assert boot["offered"] >= 4 and boot["adopted"] >= 4
    hz = victim.client.rpc("healthz")
    assert hz["host_cache"]["imported"] >= 4
    group.apply_chaos({"replica": 1, "page_pressure": 64})
    try:
        _wait(lambda: bool(group.health_snapshot()["replicas"][1]
                           .get("under_pressure")),
              what="the pressured sibling")
        toks, done, box = _submit(group, 9201, PROMPT, 8)
        fin = _finish(done, box)
    finally:
        group.apply_chaos({"replica": 1, "page_pressure": 0})
    assert fin.routed_replica == 0
    assert fin.route_host_hit_pages >= 4
    assert fin.route_fabric_hit_pages == 0
    assert toks == want


def test_fabric_warm_once_in_process(ckpt, want):
    from tpu_inference_torch.server.http import build_engine_group

    group = build_engine_group(
        _cfg(ckpt, fleet="in-process", **FABRIC_KW), device="cpu").start()
    try:
        _fabric_flow(
            group, want,
            pressure=lambda i: group.engines[i].request_page_pressure(64),
            unpressure=lambda i: group.engines[i].request_page_pressure(0),
            is_pressured=lambda i: group.engines[i].under_pressure)
        assert sum(e.fabric_published_pages for e in group.engines) >= 4
        meta, _ = _scrape(group)
        assert {n: m for n, m in meta.items() if "fabric" in n} == \
            _fabric_meta_reference()
        assert_fabric_clean(group.fabric)
    finally:
        group.stop(drain=False)


def test_handoff_salvage_parks_the_prefix_and_the_retry_pulls_it(
        ckpt, want):
    """A P/D pair: the handoff finds no destination (the decode worker
    gone, the prefill worker draining, held here for one routing pass),
    so its full prefix pages are parked in the pool. The export then
    goes stale, so the retry on the decode worker is a recompute-resume
    whose dispatch pulls the parked pages; the tokens are the dp-1
    reference's."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(
        _cfg(ckpt, worker_roles=("prefill", "decode"), **FABRIC_KW),
        device="cpu")
    group.start()
    try:
        parked = []
        orig_routable, orig_salvage = group._routable, group._fabric_salvage
        orig_on_handoff = group._on_handoff

        def on_handoff(h, client, obj, blob):
            group._routable = lambda: []
            orig_on_handoff(h, client, obj, blob)

        def salvage(digests, blob, rid, path):
            n = orig_salvage(digests, blob, rid, path)
            parked.append((path, n))
            group._tracked[rid].handoff_blob = None
            group._routable = orig_routable
            return n

        group._on_handoff = on_handoff
        group._fabric_salvage = salvage
        toks, done, box = _submit(group, 9300, PROMPT, 8)
        fin = _finish(done, box)
        assert parked == [("handoff", 4)]
        assert fin.finish_reason == "length" and toks == want
        assert fin.routed_replica == 1
        assert fin.route_fabric_hit_pages == 4
        assert group.supervision_counters()["route_fabric_hits"] == 1
    finally:
        group.stop(drain=False)


def _hold_respawn(group, replica):
    """Keep ``replica``'s respawn from starting until the returned
    function runs (the backoff is set before the state flips, so the
    monitor never sees a due restart in between)."""
    held = threading.Event()
    orig = group._schedule_restart

    def schedule_restart(h):
        if h.replica != replica or held.is_set():
            return orig(h)
        h.restart_at = float("inf")
        h.state = "restarting"

    def release():
        held.set()
        group.workers[replica].restart_at = time.monotonic()

    group._schedule_restart = schedule_restart
    return release


def test_migrate_salvage_with_no_other_worker(ckpt, oracle, monkeypatch):
    """SIGTERM mid-decode while the only sibling is down: the drain's
    export has no destination, so its pages are parked in the pool, and
    the retry's dispatch (on a respawn, which boots with no warm boot
    here) pulls the prefix back. Tokens equal the oracle's. The
    sibling's respawn is held until the export has been salvaged, so a
    quick respawn cannot take the export by import-kv first."""
    from tpu_inference_torch.server import fleet
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    monkeypatch.setattr(fleet, "_REROUTE_GRACE_S", 120.0)
    group = ProcessEngineGroup(
        _cfg(ckpt, fabric_warmboot_pages=0, **FABRIC_KW), device="cpu")
    group.start()
    try:
        parked = []
        orig = group._fabric_salvage
        release = _hold_respawn(group, 1)

        def salvage(digests, blob, rid, path):
            parked.append((path, orig(digests, blob, rid, path)))
            release()
            return parked[-1][1]

        group._fabric_salvage = salvage
        group.apply_chaos({"replica": 1, "kill": "kill9"})
        _wait(lambda: group.workers[1].state != "up",
              what="the sibling down")
        toks, done, box = _submit(group, 9400, PROMPT, 28)
        _wait(lambda: len(toks) >= 4, what="decode under way")
        group.apply_chaos({"replica": 0, "kill": "sigterm"})
        fin = _finish(done, box)
        assert parked and parked[0][0] == "migrate" and parked[0][1] >= 4
        assert fin.finish_reason == "length"
        assert toks == oracle.generate([list(PROMPT)],
                                       max_new_tokens=28)[0]
        assert fin.route_fabric_hit_pages == 4
    finally:
        group.stop(drain=False)


def test_salvage_retry_waits_for_a_respawn_not_the_draining_source(
        ckpt, oracle, monkeypatch):
    """The drained event trails a worker's migrate exports on its
    connection. The router marks the worker draining at its first
    export, so a salvage retry routed before the drained event waits for
    a respawn instead of landing on the draining source, which refuses
    it and exits: the failover then found no survivor and finished the
    request "unavailable". Here the drained event is held until the
    salvage has run, which opens that window every time."""
    from tpu_inference_torch.server import fleet
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    monkeypatch.setattr(fleet, "_REROUTE_GRACE_S", 120.0)
    group = ProcessEngineGroup(
        _cfg(ckpt, fabric_warmboot_pages=0, **FABRIC_KW), device="cpu")
    group.start()
    try:
        routable_at_salvage = []
        salvaged = threading.Event()
        orig_salvage, orig_drained = group._fabric_salvage, group._on_drained
        release = _hold_respawn(group, 1)

        def salvage(digests, blob, rid, path):
            routable_at_salvage.append(
                [w.replica for w in group._routable()])
            n = orig_salvage(digests, blob, rid, path)
            salvaged.set()
            release()
            return n

        def on_drained(h, client, obj):
            salvaged.wait(TIMEOUT)
            orig_drained(h, client, obj)

        group._fabric_salvage = salvage
        group._on_drained = on_drained
        group.apply_chaos({"replica": 1, "kill": "kill9"})
        _wait(lambda: group.workers[1].state != "up",
              what="the sibling down")
        toks, done, box = _submit(group, 9401, PROMPT, 28)
        _wait(lambda: len(toks) >= 4, what="decode under way")
        group.apply_chaos({"replica": 0, "kill": "sigterm"})
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert routable_at_salvage == [[]]
        assert toks == oracle.generate([list(PROMPT)],
                                       max_new_tokens=28)[0]
        assert fin.route_fabric_hit_pages == 4
    finally:
        group.stop(drain=False)


# ------------------------------------------------ worker and router units


class _FakeConn:
    def __init__(self):
        self.frames = []

    def send(self, obj, blob=b"", verb=""):
        self.frames.append((obj, blob, verb))


def test_publish_watermark_gate_equal_reference(tmp_path):
    """The worker's gate: a publish larger than the pool's advertised
    free pages is skipped and counted; one that fits goes out as one
    fabric_put frame whose JSON and blob equal the reference worker's,
    and the watermark drops by its pages."""
    from tpu_inference.server.worker import EngineWorker as JWorker
    from tpu_inference_torch.server.worker import EngineWorker

    ref = JWorker(jcfg.FrameworkConfig(), replica=1,
                  socket_path=str(tmp_path / "r.sock"))
    port = EngineWorker(tcfg.FrameworkConfig(), replica=1,
                        socket_path=str(tmp_path / "p.sock"), device="cpu")
    pages = _pair_pages("int8", 3)
    d = _digests(3)
    for w, i in ((ref, 0), (port, 1)):
        w._conns.append(_FakeConn())
        w._fabric_free = 2
        w._publish_fabric([(d[j], pages[j][i]) for j in range(3)])
        assert w.fabric_publish_skipped == 3 and not w._conns[0].frames
        w._fabric_free = 5
        w._publish_fabric([(d[j], pages[j][i]) for j in range(3)])
        assert w._fabric_free == 2
        w._fabric_free = None           # no watermark yet: publish
        w._publish_fabric([(d[0], pages[0][i])])
    assert port._conns[0].frames == ref._conns[0].frames
    assert len(port._conns[0].frames) == 2


def test_router_fabric_put_and_watermark_equal_reference():
    """The router's side: a malformed fabric_put frame (lengths that
    disagree with its blob) is dropped whole and counted in
    frame_errors; a sound one pools every page and counts its bytes;
    the boot envelope and the stats tick carry the pool's free pages.
    The reference router does the same on the same frames."""
    from tpu_inference.server.fleet import ProcessEngineGroup as JGroup
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    def jc():
        return jcfg.FrameworkConfig(
            model=jcfg.tiny_llama(vocab_size=512),
            engine=jcfg.EngineConfig(**ENGINE_KW),
            server=jcfg.ServerConfig(fabric_cache_pages=8))

    tc = tcfg.FrameworkConfig(model=tcfg.tiny_llama(vocab_size=512),
                              engine=tcfg.EngineConfig(**ENGINE_KW),
                              server=tcfg.ServerConfig(fabric_cache_pages=8))
    ref, port = JGroup(jc()), ProcessEngineGroup(tc, device="cpu")
    try:
        pages = _pair_pages("int4", 3)
        d = [x.hex() for x in _digests(3)]
        blobs = [rkvc.serialize_host_pages([r]) for r, _ in pages]
        assert blobs == [tkvc.serialize_host_pages([p]) for _, p in pages]
        blob = b"".join(blobs)
        lens = [len(b) for b in blobs]
        frames = [({"digests": d, "lens": lens[:2]}, blob),
                  ({"digests": d, "lens": lens}, blob[:-1]),
                  ({"digests": d, "lens": lens}, blob)]
        for g in (ref, port):
            for obj, b in frames:
                g._on_fabric_put(g.workers[0], dict(obj), b)
            assert g.frame_errors == 2
            assert g.rpc_blob_bytes["fabric_put"] == len(blob)
            assert g.fabric.used == 3
            assert g._envelope(0)["fabric_free"] == 5
        _same(ref.fabric, port.fabric)
    finally:
        ref.stop(drain=False)
        port.stop(drain=False)


@pytest.mark.parametrize("argv", [
    [],
    ["--fabric-cache-pages", "256", "--fabric-publish-min-pages", "2",
     "--fabric-warmboot-pages", "16", "--route-fabric-hit-weight", "0.5"],
])
def test_fabric_flags_match_reference(argv, monkeypatch):
    """The four flags: the reference's defaults, values and help text,
    carried into ServerConfig under the reference's field names."""
    from tests.test_torch_server import _reference_parser
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    server_overrides)
    names = ("fabric_cache_pages", "fabric_publish_min_pages",
             "fabric_warmboot_pages", "route_fabric_hit_weight")
    ref = _reference_parser(monkeypatch)
    want, got = ref.parse_args(argv), build_parser().parse_args(argv)
    helps = lambda p: {a.dest: a.help for a in p._actions
                       if a.dest in names}
    assert helps(build_parser()) == helps(ref)
    scfg = tcfg.ServerConfig(**server_overrides(got))
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
        assert getattr(scfg, name) == getattr(want, name), name
