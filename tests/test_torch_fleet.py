"""The port's process fleet on the CPU against the reference engine
(twins of tests/test_fleet.py's fleet cases): a router and two port
worker processes boot from a local HF checkpoint the test writes (the
workers build their own weights, and a checkpoint is how they share
them with the JAX engine, the oracle). Greedy tokens must equal the
oracle's through ``kill -9`` failover, SIGTERM drain with KV migration,
transport corruption and a wedged connection; the in-process and the
subprocess backends give the same ``outputs_sha256``; the metrics keep
their replica labels and never fall across restarts; the HTTP layer
serves dp=2 on both backends; ``kv_plane="shm"`` builds on both (an
arena on the process fleet, the relay plane in-process).
"""

import dataclasses
import hashlib
import http.client
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from tests import _prom
from tests.test_torch_weights import _tiny_llama_checkpoint
from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as rkvc
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import weights as jw
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence

ENGINE_KW = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
                 max_batch_size=2, prefill_buckets=(16,),
                 host_cache_pages=32)
TIMEOUT = 120.0


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = _tiny_llama_checkpoint(str(tmp_path_factory.mktemp("ckpt")))
    # One interpreter thread per worker: six test processes must not
    # oversubscribe the machine.
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
    """The reference engine on the checkpoint's weights."""
    jm = jcfg.tiny_llama(vocab_size=512)
    return JEngine(jm, jcfg.EngineConfig(**ENGINE_KW),
                   params=jw.load_checkpoint(jm, ckpt), attn_backend="dense")


@pytest.fixture(scope="module")
def fleet(ckpt):
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt), device="cpu")
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


def _wait_states(group, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(h.state == "up" for h in group.workers):
            return
        time.sleep(0.1)
    raise AssertionError(
        f"fleet never healed: {[h.state for h in group.workers]}")


def _want(oracle, prompt, n):
    return oracle.generate([list(prompt)], max_new_tokens=n)[0]


# ------------------------------------------------------------- units


def test_config_json_envelope_roundtrip(ckpt):
    """The router->worker envelope survives JSON (dtypes by name,
    tuples, the fleet knobs) and reads back the reference's dicts."""
    cfg = _cfg(ckpt, dp=3, chaos_rpc_verbs=("token",))
    back = tcfg.framework_config_from_dict(
        json.loads(json.dumps(tcfg.framework_config_to_dict(cfg))))
    assert (back.model, back.engine, back.parallel, back.server) == \
        (cfg.model, cfg.engine, cfg.parallel, cfg.server)
    jsrv = jcfg.framework_config_to_dict(jcfg.FrameworkConfig())["server"]
    assert set(tcfg.framework_config_to_dict(cfg)["server"]) <= set(jsrv)


def test_import_host_capacity_and_tier_invariant():
    """tests/test_fleet.py's import case on both engines: the same
    adoption counts, the oldest host entry evicted, overflow dropped,
    the apply queue, the pool clean after."""
    from tests._leak import assert_pool_clean

    def run(kind):
        if kind == "ref":
            eng = JEngine(jcfg.tiny_llama(vocab_size=512),
                          jcfg.EngineConfig(**{**ENGINE_KW,
                                               "host_cache_pages": 4}))
            mk = lambda tag: rkvc.HostKVPage(
                np.full((2, 8, 2, 16), tag, np.float32),
                np.full((2, 8, 2, 16), tag, np.float32))
        else:
            import torch
            eng = InferenceEngine(tcfg.tiny_llama(vocab_size=512),
                                  tcfg.EngineConfig(**{**ENGINE_KW,
                                                       "host_cache_pages": 4}),
                                  device="cpu")
            mk = lambda tag: tkvc.HostKVPage(
                torch.full((2, 8, 2, 16), float(tag)),
                torch.full((2, 8, 2, 16), float(tag)))
        cache, pool = eng.prefix_cache, eng.host_pool
        d = [bytes([i]) * 16 for i in range(8)]
        out = [cache.import_host([(d[0], mk(0)), (d[1], mk(1))]),
               cache.import_host([(d[0], mk(9))]),
               cache.import_host([(d[2], mk(2)), (d[3], mk(3))]),
               cache.import_host([(d[4], mk(4))]),
               pool.used, d[0] in cache._host, d[4] in cache._host,
               cache.import_host([(d[i], mk(i)) for i in range(5, 8)]),
               pool.used, pool.imported_total]
        done = eng.request_import_host([(b"z" * 16, mk(42))])
        eng.apply_pending_imports()
        out += [done.is_set(), eng.migrate_in_pages,
                eng.migrate_in_bytes == mk(42).nbytes]
        assert_pool_clean(eng)
        return out

    assert run("port") == run("ref")


def test_export_sequence_kv_matches_reference():
    """The drain export of a live sequence on both engines (same
    weights, the same decode step): the same chain digests and page
    count, page values within float32 tolerance, and blob headers that
    agree but for the digest."""
    import torch

    from tests.test_torch_ladder import pair
    from tpu_inference.engine.engine import Sequence as JSequence
    from tpu_inference.engine.scheduler import EngineScheduler as JSched
    from tpu_inference_torch.engine.scheduler import EngineScheduler

    jm, params, tm, tp = pair()
    kw = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              max_batch_size=2, prefill_buckets=(16, 32),
              decode_steps_per_call=1, host_cache_pages=16)
    prompt = list(range(3, 30))

    def run(eng, sched_cls, seq_cls):
        out, done = {}, threading.Event()

        def on_token(s, t):
            if len(s.generated) >= 12 and "pages" not in out:
                out["digests"], out["pages"] = eng.export_sequence_kv(s)
                out["ctx_len"] = s.ctx_len

        sched = sched_cls(eng)
        sched.submit(seq_cls(request_id=1, prompt_tokens=prompt,
                             max_new_tokens=20), on_token,
                     lambda s: done.set())
        sched.start()
        assert done.wait(120)
        sched.stop(drain=True, timeout=10)
        return out

    got = run(InferenceEngine(tm, tcfg.EngineConfig(**kw), params=tp,
                              device="cpu"), EngineScheduler, Sequence)
    want = run(JEngine(jm, jcfg.EngineConfig(**kw), params=params,
                       attn_backend="dense"), JSched, JSequence)
    assert got["ctx_len"] == want["ctx_len"]
    assert got["digests"] == want["digests"] and len(got["pages"]) == 4
    for p, q in zip(got["pages"], want["pages"]):
        for a, b in ((p.k, q.k), (p.v, q.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=0, atol=1e-4)
    hdr = [json.loads(b[4:4 + struct.unpack(">I", b[:4])[0]])
           for b in (tkvc.serialize_host_pages(got["pages"]),
                     rkvc.serialize_host_pages(want["pages"]))]
    for h in hdr:
        h.pop("crc32c")
    assert hdr[0] == hdr[1]
    assert isinstance(got["pages"][0].k, torch.Tensor)


def test_imports_applied_together_report_their_own_pages():
    """Two imports queued before one engine-loop pass (the router imports
    a drain's exports side by side) each report the pages they added,
    not the counter's total delta."""
    import torch

    eng = InferenceEngine(tcfg.tiny_llama(vocab_size=512),
                          tcfg.EngineConfig(**ENGINE_KW), device="cpu")
    mk = lambda tag: tkvc.HostKVPage(torch.full((2, 8, 2, 16), float(tag)),
                                     torch.full((2, 8, 2, 16), float(tag)))
    a = eng.request_import_host([(b"a" * 16, mk(1))])
    b = eng.request_import_host([(bytes([i]) * 16, mk(i))
                                 for i in range(2, 5)])
    eng.apply_pending_imports()
    assert a.is_set() and b.is_set()
    assert (a.adopted, b.adopted, eng.migrate_in_pages) == (1, 3, 4)


def test_unported_fleet_features_raise_naming_1_15b(ckpt):
    """Nothing of 1.15b is refused any more: ``kv_plane="shm"`` builds on
    both backends (the process fleet creates its arena, the in-process
    fleet rides the relay plane, as the reference's decision table
    says), and the one refusal left (sp > 1) names 1.16b."""
    from tpu_inference.server.shm_arena import effective_kv_plane as ref
    from tpu_inference_torch.server.http import build_engine_group
    from tpu_inference_torch.server.shm_arena import effective_kv_plane

    for fleet in ("subprocess", "in-process"):
        cfg = _cfg(ckpt, fleet=fleet, kv_plane="shm",
                   shm_arena_bytes=1 << 20)
        assert effective_kv_plane(cfg.server) == ref(cfg.server)
        group = build_engine_group(cfg, device="cpu")
        try:
            arena = getattr(group, "arena", None)
            if fleet == "subprocess":
                assert arena is not None and arena.regions == 4
                assert arena.region_spec(0)["region_bytes"] == (1 << 20) // 4
            else:
                assert arena is None
        finally:
            group.stop(drain=False)
        assert getattr(group, "arena", None) is None
    # The KV fabric is served on both backends: each router holds a pool.
    for fleet in ("subprocess", "in-process"):
        group = build_engine_group(
            _cfg(ckpt, fleet=fleet, fabric_cache_pages=64), device="cpu")
        try:
            assert group.fabric.capacity == 64
            assert group.health_snapshot()["fabric"]["capacity_pages"] == 64
        finally:
            group.stop(drain=False)
    cfg = _cfg(ckpt)
    cfg.parallel = tcfg.ParallelConfig(dp=2, sp=2)
    with pytest.raises(NotImplementedError, match="ROADMAP 1.16b"):
        build_engine_group(cfg, device="cpu")
    # P/D roles are served by the process fleet only.
    cfg = _cfg(ckpt, fleet="in-process")
    cfg.engine = tcfg.EngineConfig(**ENGINE_KW, role="decode")
    with pytest.raises(ValueError, match="need --fleet subprocess"):
        build_engine_group(cfg, device="cpu")
    cfg.server = dataclasses.replace(cfg.server, fleet="subprocess")
    group = build_engine_group(cfg, device="cpu")
    assert group.roles == ["decode", "decode"]
    group.stop(drain=False)
    cfg = _cfg(ckpt)
    with pytest.raises(ValueError, match="draft-model"):
        build_engine_group(cfg, device="cpu",
                           draft_cfg=tcfg.tiny_llama(vocab_size=512))


def test_fleet_flags_match_reference(monkeypatch):
    """The fleet flags parse to the reference's defaults and values and
    reach ServerConfig; auto sizing at dp > 1 and a P/D split at dp 1
    are usage errors."""
    from tests.test_torch_server import _reference_parser
    from tpu_inference_torch.server.__main__ import (boot_server,
                                                    build_parser,
                                                    server_overrides)
    names = ("dp", "fleet", "worker_restart_max", "drain_timeout_s",
             "no_fleet_migrate", "rpc_deadline_fast_s",
             "rpc_deadline_slow_s", "poison_max_workers", "chaos_rpc_seed",
             "chaos_rpc_corrupt_rate", "chaos_rpc_drop_rate",
             "chaos_rpc_delay_rate", "chaos_rpc_delay_s",
             "chaos_rpc_truncate_rate", "chaos_rpc_wedge_after",
             "chaos_rpc_wedge_replica", "chaos_rpc_verbs",
             "chaos_rpc_direction", "role", "roles", "pd_ratio")
    ref = _reference_parser(monkeypatch)
    flags = ["--dp", "2", "--fleet", "subprocess", "--worker-restart-max",
             "5", "--drain-timeout-s", "3", "--no-fleet-migrate",
             "--chaos-rpc-corrupt-rate", "0.1", "--chaos-rpc-verbs",
             "token,finish", "--chaos-rpc-direction", "recv",
             "--poison-max-workers", "2", "--rpc-deadline-slow-s", "9"]
    for argv in ([], flags):
        want, got = ref.parse_args(argv), build_parser().parse_args(argv)
        for name in names:
            assert getattr(got, name) == getattr(want, name), name
    got = build_parser().parse_args(flags)
    scfg = tcfg.ServerConfig(**server_overrides(got))
    assert (scfg.fleet, scfg.worker_restart_max, scfg.drain_timeout_s,
            scfg.fleet_migrate, scfg.chaos_rpc_verbs,
            scfg.chaos_rpc_direction, scfg.poison_max_workers,
            scfg.rpc_deadline_slow_s) == ("subprocess", 5, 3.0, False,
                                          ("token", "finish"), "recv", 2,
                                          9.0)
    assert tcfg.ServerConfig().worker_restart_backoff_s == \
        jcfg.ServerConfig().worker_restart_backoff_s == \
        build_parser().parse_args([]).worker_restart_backoff_s
    p = build_parser()
    for argv in (["--dp", "2", "--num-pages", "auto"],
                 ["--dp", "2", "--max-batch-size", "auto"]):
        with pytest.raises(SystemExit):
            boot_server(p.parse_args(["--device", "cpu", *argv]), p)
    with pytest.raises(SystemExit):
        boot_server(p.parse_args(["--device", "cpu", "--pd-ratio", "1:1"]),
                    p)


def test_cuda_worker_without_a_card_fails_and_no_process_stays(ckpt):
    """A worker asked for cuda on a machine without one fails its boot:
    the router raises instead of serving, and leaves no worker."""
    import torch

    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    group = ProcessEngineGroup(_cfg(ckpt), device="cuda")
    with pytest.raises(Exception, match="exited|CUDA|cuda"):
        group.start()
    assert all(h.proc is None or h.proc.poll() is not None
               for h in group.workers)
    assert group.engine is None


# ------------------------------------------------- real process fleet


def test_fleet_basic_and_surfaces(fleet, oracle):
    toks, done, box = _submit(fleet, 0, [1, 2, 3, 4, 5], 12)
    fin = _finish(done, box)
    assert fin.finish_reason == "length"
    assert toks == _want(oracle, [1, 2, 3, 4, 5], 12)
    assert fin.routed_replica in (0, 1)
    hs = fleet.health_snapshot()
    assert hs["status"] == "ok" and hs["fleet"] == "subprocess"
    assert len(hs["replicas"]) == 2
    for r in hs["replicas"]:
        assert r["pid"] and "restarts" in r and "routing" in r
        assert "pool_pressure" in r and "host_cache" in r
        assert r["device"] == "cpu"
    ss = fleet.stats_snapshot()
    assert ss["dp"] == 2 and ss["tokens_generated"] >= 12
    assert "phases" in ss and "supervision" in ss
    pt = fleet.prometheus_text()
    assert 'replica="0"' in pt and 'replica="1"' in pt
    assert "tpu_inf_worker_up" in pt
    assert "tpu_inf_fleet_migrations_total" in pt
    recent = fleet.recent_snapshot(10)
    assert recent and recent[-1]["finish_reason"] == "length"
    # What only the worker process sees: its device and kernel counts.
    for w in fleet.worker_stats():
        assert w["device"] == "cpu"
        assert set(w["kernels"]) == {"decode", "prefill", "decode_by_batch",
                                     "prefill_by_len", "prefill_by_path"}
        assert w["boot_walls_s"] and w["boot_walls_s"][0] > 0
    tr = fleet.trace_snapshot(fin.trace_id)
    assert tr is not None and tr["trace_id"] == fin.trace_id


def _sha(outs):
    h = hashlib.sha256()
    for o in outs:
        h.update(np.asarray(o, np.int32).tobytes() + b"|")
    return h.hexdigest()


def test_backend_equivalence_pinned_mix(fleet, oracle, ckpt):
    """The same pinned greedy mix through the in-process group at dp 2,
    the subprocess fleet at dp 2 and the reference engine at dp 1: the
    same outputs_sha256 and finish reasons, and the same counter
    shapes between the backends."""
    from tpu_inference_torch.server.http import build_engine_group

    prompts = [[1, 2, 3], [9, 8, 7, 6], [5, 5, 5, 5, 5], [2, 4, 6]]
    budgets = [10, 14, 8, 200]          # 200 hits the context cap

    def run(group):
        pend = [_submit(group, 1000 + i, p, b)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs, reasons = [], []
        for toks, done, box in pend:
            reasons.append(_finish(done, box).finish_reason)
            outs.append(list(toks))
        return _sha(outs), reasons, group.stats_snapshot()

    inproc = build_engine_group(_cfg(ckpt, fleet="in-process"),
                                device="cpu").start()
    try:
        sha_in, reasons_in, stats_in = run(inproc)
        h_in = inproc.health_snapshot()["replicas"][0]["routing"]
    finally:
        inproc.stop(drain=False)
    sha_sub, reasons_sub, stats_sub = run(fleet)
    want = [_want(oracle, p, b) for p, b in zip(prompts, budgets)]
    assert sha_sub == sha_in == _sha(want)
    assert reasons_sub == reasons_in == ["length"] * 4
    assert set(stats_in["supervision"]) <= set(stats_sub["supervision"])
    core = {"steps", "prefills", "tokens_generated", "requests_finished",
            "preemptions", "recompute_resumes", "swap_in_resumes",
            "migrate_out_pages", "migrate_in_pages", "kv_pages_total",
            "decode_ladder", "phases", "replicas", "dp", "supervision"}
    assert core <= set(stats_in) and core <= set(stats_sub)
    h_sub = fleet.health_snapshot()["replicas"][0]["routing"]
    assert set(h_in) == set(h_sub)


def test_kill9_chaos_failover(fleet, oracle):
    """kill -9 of the worker holding a mid-decode stream: both requests
    complete token-identical to the oracle, the worker comes back under
    its replica label, and the survivors' pools are clean."""
    _wait_states(fleet)
    failovers0 = fleet.failovers
    a = _submit(fleet, 2000, [7, 8, 9], 40)
    b = _submit(fleet, 2001, [3, 1, 4, 1, 5], 40)
    deadline = time.monotonic() + 60
    while (len(a[0]) < 4 or len(b[0]) < 4) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(a[0]) >= 4 and len(b[0]) >= 4
    with fleet._lock:
        victim = fleet._tracked[2000].worker.replica
    assert fleet.apply_chaos({"replica": victim,
                              "kill": "sigkill"})["killed"] == "sigkill"
    assert _finish(a[1], a[2]).finish_reason == "length"
    assert _finish(b[1], b[2]).finish_reason == "length"
    assert a[0] == _want(oracle, [7, 8, 9], 40)
    assert b[0] == _want(oracle, [3, 1, 4, 1, 5], 40)
    assert fleet.failovers > failovers0
    _wait_states(fleet)
    hs = fleet.health_snapshot()
    assert hs["replicas"][victim]["restarts"] >= 1
    assert hs["supervision"]["worker_restarts"] >= 1
    for h in fleet.workers:
        snap = h.client.rpc("debug", clear=True)
        assert not snap["pipeline_pending"]
        assert snap["preempted_uncollected"] == 0
        assert snap["slots_bound"] == 0
        assert snap["num_free"] == snap["num_pages"] - 1, snap
        assert snap["refs_held"] == 0 and snap["evictable_count"] == 0
        assert snap["host_used"] == 0 and snap.get("tier_overlap", 0) == 0


def test_sigterm_drain_migrates_kv(fleet, oracle):
    """SIGTERM mid-decode: the draining worker exports the sequence's
    pages, the router imports them into the sibling's host tier and
    resubmits, so admission there is a swap-in-resume; tokens equal the
    oracle's. The swap-in count reaches the supervision view with the
    next stats refresh (the router caches worker stats once a second),
    so it is polled for, not read at once."""
    _wait_states(fleet)
    migrations0, pages0 = fleet.migrations, fleet.migrated_pages
    prompt = [11, 12, 13, 14, 15, 16, 17]
    toks, done, box = _submit(fleet, 3000, prompt, 48)
    deadline = time.monotonic() + 60
    while len(toks) < 18 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(toks) >= 18
    with fleet._lock:
        src = fleet._tracked[3000].worker.replica
    fleet.apply_chaos({"replica": src, "kill": "sigterm"})
    assert _finish(done, box).finish_reason == "length"
    assert toks == _want(oracle, prompt, 48)
    assert fleet.migrations > migrations0
    assert fleet.migrated_pages > pages0
    assert fleet.resume_reused_tokens > 0
    deadline = time.monotonic() + 10
    sup = fleet.supervision_counters()
    while sup["swap_in_resumes"] < 1 and time.monotonic() < deadline:
        time.sleep(0.1)
        sup = fleet.supervision_counters()
    assert sup["swap_in_resumes"] >= 1
    assert sup["migrated_bytes"] > 0
    _wait_states(fleet)


def test_metrics_label_stable_across_restart(fleet):
    """Stable replica="i" labels across a restart, no counter falls (the
    carry), no series reported twice."""
    _wait_states(fleet)
    toks, done, box = _submit(fleet, 4000, [2, 7, 1, 8], 10)
    _finish(done, box)
    fleet._refresh_caches()

    def scrape():
        _, samples = _prom.parse(fleet.prometheus_text())
        out = {}
        for name, labels, value in samples:
            key = (name, tuple(sorted(labels.items())))
            assert key not in out, f"duplicate series {key}"
            out[key] = value
        return out

    def series(samples, name):
        return {labels: v for (n, labels), v in samples.items()
                if n == name}

    before = scrape()
    tok_before = series(before, "tpu_inf_tokens_generated_total")
    assert {dict(l).get("replica") for l in tok_before} == {"0", "1"}
    binfo_before = series(before, "tpu_inf_build_info")
    assert len(binfo_before) == 3
    fleet.apply_chaos({"replica": 0, "kill": "sigterm"})
    deadline = time.monotonic() + 60
    while fleet.workers[0].state == "up" and time.monotonic() < deadline:
        time.sleep(0.05)
    _wait_states(fleet)
    after = scrape()
    tok_after = series(after, "tpu_inf_tokens_generated_total")
    assert set(tok_after) == set(tok_before)
    for labels, v in tok_before.items():
        assert tok_after[labels] >= v, (labels, v, tok_after[labels])
    assert series(after, "tpu_inf_worker_restarts_total")[
        (("replica", "0"),)] >= 1
    assert set(series(after, "tpu_inf_build_info")) == set(binfo_before)


def test_draining_worker_refuses_submit_routes_to_sibling(fleet, oracle):
    _wait_states(fleet)
    fleet.apply_chaos({"replica": 1, "kill": "sigterm"})
    toks, done, box = _submit(fleet, 5000, [6, 6, 6], 8)
    assert _finish(done, box).finish_reason == "length"
    assert toks == _want(oracle, [6, 6, 6], 8)
    _wait_states(fleet)


def test_chaos_rpc_corruption_byte_identity(fleet, oracle):
    """Seeded corruption of worker->router token frames: each is
    rejected by its CRC and counted, the router reconnects without a
    restart and resyncs, completions equal the oracle's."""
    _wait_states(fleet)
    frame_errors0, reconnects0 = fleet.frame_errors, fleet.reconnects
    restarts0 = sum(h.restarts for h in fleet.workers)
    r = fleet.apply_chaos({"rpc": {"seed": 42, "corrupt_rate": 0.1,
                                   "verbs": ["token"], "direction": "recv"}})
    assert r["rpc"]["corrupt_rate"] == 0.1
    try:
        a = _submit(fleet, 7000, [7, 1, 7], 48)
        b = _submit(fleet, 7001, [2, 7, 2, 7], 48)
        fin_a, fin_b = _finish(a[1], a[2]), _finish(b[1], b[2])
    finally:
        fleet.apply_chaos({"rpc": {"corrupt_rate": 0.0}})
    assert fin_a.finish_reason == fin_b.finish_reason == "length"
    assert a[0] == _want(oracle, [7, 1, 7], 48)
    assert b[0] == _want(oracle, [2, 7, 2, 7], 48)
    assert fleet.frame_errors > frame_errors0
    assert fleet.reconnects > reconnects0
    assert sum(h.restarts for h in fleet.workers) == restarts0
    _wait_states(fleet)


def test_corrupt_kv_blob_rejected_and_counted(fleet):
    """A KV blob with one flipped payload byte is rejected and counted
    by the router's gate and by a worker's import (never adopted); a
    sound one is adopted into the host tier."""
    import torch

    _wait_states(fleet)
    page = tkvc.HostKVPage(torch.full((2, 8, 2, 16), 0.5),
                           torch.full((2, 8, 2, 16), -0.5))
    blob = tkvc.serialize_host_pages([page])
    bad = bytearray(blob)
    bad[-1] ^= 0x01
    bad = bytes(bad)
    rejections0 = fleet.kv_rejections
    assert fleet._checked_blob(bad, "migrate", 1) == b""
    assert fleet._checked_blob(blob, "migrate", 1) == blob
    assert fleet.kv_rejections == rejections0 + 1
    h = fleet.workers[0]
    before = h.client.rpc("healthz")["kv_integrity_rejections"]
    r = h.client.rpc("import-kv", blob=bad, digests=["ab" * 16],
                     idem="corrupt-1")
    assert r["adopted"] == 0 and not r["applied"] and r["rejected"]
    assert h.client.rpc("healthz")["kv_integrity_rejections"] == before + 1
    r = h.client.rpc("import-kv", blob=blob, digests=["cd" * 16],
                     idem="sound-1")
    assert r["applied"] and r["adopted"] == 1
    h.client.rpc("debug", clear=True)


def test_worker_survives_garbage_bytes(fleet, oracle):
    """A rogue connection spewing garbage is dropped with a typed error;
    the worker keeps serving its router without a restart."""
    _wait_states(fleet)
    h = fleet.workers[0]
    restarts0 = h.restarts
    for payload in (b"GARBAGE" * 64,
                    struct.pack(">IIII", 0x54504631, 0xFFFFFF, 0xFFFFFFFF,
                                0) + b"x" * 32,
                    struct.pack(">IIII", 0x54504631, 8, 0, 0)):
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(10.0)
        s.connect(h.socket_path)
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                if not s.recv(4096):
                    break
            except OSError:
                break
        s.close()
    assert h.client.rpc("healthz")["ok"]
    assert h.restarts == restarts0
    toks, done, box = _submit(fleet, 7100, [9, 9, 9], 8)
    _finish(done, box)
    assert toks == _want(oracle, [9, 9, 9], 8)


@pytest.fixture(scope="module")
def byz_fleet(ckpt, tmp_path_factory):
    """Fast RPC deadlines (the wedge detector), a two-worker poison
    budget and a blackbox directory for the router's flight recorder."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    root = str(tmp_path_factory.mktemp("byz-blackbox"))
    group = ProcessEngineGroup(_cfg(ckpt, rpc_deadline_fast_s=2.0,
                                    rpc_deadline_slow_s=4.0,
                                    poison_max_workers=2,
                                    blackbox_dir=root), device="cpu")
    group.start()
    yield group
    group.stop(drain=False)


def test_wedged_connection_recycled_not_restarted(byz_fleet, oracle):
    _wait_states(byz_fleet)
    timeouts0 = byz_fleet.rpc_timeouts
    restarts0 = sum(h.restarts for h in byz_fleet.workers)
    byz_fleet.apply_chaos({"rpc": {"seed": 9, "wedge_after": 1,
                                   "wedge_replica": 0, "direction": "send"}})
    try:
        pend = [_submit(byz_fleet, 7200 + i, [3, 3, 3 + i], 10)
                for i in range(3)]
        fins = [_finish(done, box) for _, done, box in pend]
    finally:
        byz_fleet.apply_chaos({"rpc": {"wedge_after": 0}})
    for i, (fin, (toks, _, _)) in enumerate(zip(fins, pend)):
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, [3, 3, 3 + i], 10)
    assert byz_fleet.rpc_timeouts > timeouts0
    assert sum(h.restarts for h in byz_fleet.workers) == restarts0
    _wait_states(byz_fleet)


def test_poison_request_quarantined(byz_fleet):
    """A request whose attempts crash two distinct workers finishes
    "poison", is counted, leaves a router flight-recorder capture, and
    the fleet heals."""
    _wait_states(byz_fleet)
    poison0 = byz_fleet.poison_requests
    rid = 7300
    toks, done, box = _submit(byz_fleet, rid, [8, 4, 8, 4], 200)
    deadline = time.monotonic() + 60
    while len(toks) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    with byz_fleet._lock:
        first = byz_fleet._tracked[rid].worker.replica
    byz_fleet.apply_chaos({"replica": first, "kill": "kill9"})
    deadline = time.monotonic() + 60
    second = None
    while time.monotonic() < deadline:
        with byz_fleet._lock:
            e = byz_fleet._tracked.get(rid)
            w = e.worker if e is not None else None
            second = w.replica if w is not None else None
        if second is not None and second != first:
            break
        time.sleep(0.05)
    assert second is not None and second != first
    byz_fleet.apply_chaos({"replica": second, "kill": "kill9"})
    assert _finish(done, box).finish_reason == "poison"
    assert byz_fleet.poison_requests == poison0 + 1
    assert byz_fleet.supervision_counters()["poison_requests"] >= 1
    idx = byz_fleet.blackbox_index()
    assert any(c.get("trigger") == "poison_request"
               for r in idx.get("replicas", {}).values()
               for c in r) or "poison_request" in json.dumps(idx)
    _wait_states(byz_fleet)


def test_poison_gate_counts_a_slowly_reaped_worker(byz_fleet,
                                                   monkeypatch):
    """The failover's submit dies with its target, whose exit is reaped
    slowly (the lost connection misses _exits_soon's grace and its redial
    takes two seconds to fail): the death still counts toward the poison
    gate, so the request ends "poison", not re-routed to a restarted
    worker or "unavailable"."""
    import signal

    from tpu_inference_torch.server import fleet as tfleet

    _wait_states(byz_fleet)
    poison0 = byz_fleet.poison_requests
    rpc = tfleet.WorkerClient.rpc
    armed = {"on": False}

    def dying_submit(self, verb, *a, **kw):
        if verb == "submit" and armed["on"]:
            armed["on"] = False
            os.kill(self.proc.pid, signal.SIGKILL)
            time.sleep(0.05)
        return rpc(self, verb, *a, **kw)

    reconnect = tfleet.ProcessEngineGroup._reconnect_worker

    def slow_reconnect(self, h, old):
        time.sleep(2.0)
        return reconnect(self, h, old)

    monkeypatch.setattr(tfleet.WorkerClient, "rpc", dying_submit)
    monkeypatch.setattr(tfleet.ProcessEngineGroup, "_exits_soon",
                        staticmethod(lambda proc, grace_s=0.25: False))
    monkeypatch.setattr(tfleet.ProcessEngineGroup, "_reconnect_worker",
                        slow_reconnect)
    toks, done, box = _submit(byz_fleet, 7310, [8, 4, 8, 4], 200)
    deadline = time.monotonic() + 60
    while len(toks) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    with byz_fleet._lock:
        first = byz_fleet._tracked[7310].worker.replica
    armed["on"] = True
    byz_fleet.apply_chaos({"replica": first, "kill": "kill9"})
    assert _finish(done, box).finish_reason == "poison"
    assert byz_fleet.poison_requests == poison0 + 1
    monkeypatch.undo()
    _wait_states(byz_fleet)


# -------------------------------------------------------- HTTP layer


def _post(port, body, path="/api/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_serves_dp2_on_both_backends(ckpt):
    """/api/generate through the HTTP layer at dp=2 gives the same text
    in-process and as a process fleet; /healthz names the fleet;
    /debug/chaos kills a worker, which comes back under its label."""
    from tpu_inference_torch.server.http import InferenceServer

    body = {"model": "t", "prompt": "Hello fleet", "temperature": 0.0,
            "max_tokens": 12, "stream": False}
    texts = {}
    for fleet_kind in ("in-process", "subprocess"):
        cfg = _cfg(ckpt, fleet=fleet_kind, enable_debug=True)
        server = InferenceServer(cfg, device="cpu")
        port = server.start(host="127.0.0.1", port=0)
        try:
            status, raw = _post(port, body)
            assert status == 200
            texts[fleet_kind] = json.loads(raw)["response"]
            status, raw = _get(port, "/healthz")
            hz = json.loads(raw)
            assert status == 200 and hz["fleet"] == fleet_kind
            assert len(hz["replicas"]) == 2
            if fleet_kind == "subprocess":
                status, raw = _post(port, {"replica": 1, "kill": "sigkill"},
                                    "/debug/chaos")
                assert status == 200 and json.loads(raw)["killed"] == \
                    "sigkill"
                deadline = time.monotonic() + 60
                while (server.group.workers[1].restarts < 1
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                _wait_states(server.group)
                hz = json.loads(_get(port, "/healthz")[1])
                assert hz["replicas"][1]["restarts"] >= 1
                status, raw = _post(port, {"rpc": {"delay_rate": 0.0}},
                                    "/debug/chaos")
                assert status == 200 and "rpc" in json.loads(raw)
                status, _ = _post(port, {"replica": 0, "kill": "nope"},
                                  "/debug/chaos")
                assert status == 400
            else:
                status, _ = _post(port, {"replica": 0, "kill": "sigterm"},
                                  "/debug/chaos")
                assert status == 400
        finally:
            server.shutdown(timeout=30.0)
    assert texts["in-process"] == texts["subprocess"]
