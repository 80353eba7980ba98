"""The port's elastic fleet on the CPU against the reference (twins of
tests/test_elastic.py): priority classes and their plumbing; the
autoscaler's sensor against hand-fed windows, and the same window
sequence through the reference's ``_autoscale_tick`` and the port's,
which must decide alike; the retirement pick; a cancel that frees its
pages mid-prefill and mid-decode on both schedulers; and, with real
worker processes booted from a checkpoint the test writes (the JAX
engine on the same weights is the oracle), crash-loop quarantine and
per-class admission (batch defers at the cap, an interactive arrival
preempts the running batch request, which resumes byte-identically).
The scale-up, scale-down and rollout twins are in
tests/test_torch_elastic_fleet.py.
"""

import dataclasses
import re
import threading
import time

import pytest

from tests import _prom
from tests.test_torch_fleet import ENGINE_KW, _cfg as _fleet_cfg
from tests.test_torch_fleet import ckpt, oracle  # noqa: F401 — fixtures
from tpu_inference import config as jcfg
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import Sequence


def _cfg(ckpt, dp=2, engine_kw=None, **server_kw):
    cfg = _fleet_cfg(ckpt, dp=dp, **server_kw)
    cfg.engine = tcfg.EngineConfig(**{**ENGINE_KW, **(engine_kw or {})})
    return cfg


def _ref_cfg(dp=2, engine_kw=None, **server_kw):
    server_kw.setdefault("fleet", "subprocess")
    return jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(vocab_size=512),
        engine=jcfg.EngineConfig(**{**ENGINE_KW, **(engine_kw or {})}),
        parallel=jcfg.ParallelConfig(dp=dp),
        server=jcfg.ServerConfig(model_name="t", tokenizer="byte",
                                 warmup=False, **server_kw))


def _submit(group, rid, prompt, max_new, cls="interactive"):
    toks, done, box = [], threading.Event(), {}
    seq = Sequence(request_id=rid, prompt_tokens=list(prompt),
                   max_new_tokens=max_new, priority_class=cls)
    group.submit(seq, lambda s, t: toks.append(t),
                 lambda s: (box.update(seq=s), done.set()))
    return toks, done, box


def _finish(done, box, timeout=180.0):
    assert done.wait(timeout), "request did not finish"
    return box["seq"]


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _want(oracle, prompt, n):
    return oracle.generate([list(prompt)], max_new_tokens=n)[0]


# ------------------------------------------------------------- units


@pytest.mark.parametrize("name", ["interactive", "batch", "background",
                                  "tyop", ""])
def test_class_rank_and_plumbing(name):
    """interactive < batch < background, an unknown name ranks
    interactive (never starved), as the reference ranks them; the class
    rides request clones; a request without one is interactive."""
    from tpu_inference_torch.server.replicas import _clone_request

    assert tcfg.class_rank(name) == jcfg.class_rank(name)
    assert tcfg.PRIORITY_CLASSES == jcfg.PRIORITY_CLASSES
    seq = Sequence(request_id=7, prompt_tokens=[1, 2], max_new_tokens=4,
                   priority_class=name)
    assert _clone_request(seq).priority_class == name
    assert Sequence(request_id=8, prompt_tokens=[1],
                    max_new_tokens=1).priority_class == "interactive"


def _stub_scaling(g, calls, clock):
    g._scale_up = lambda reason: (calls.append(("up", reason)),
                                  setattr(g, "_breach_since", 0.0),
                                  setattr(g, "_last_scale_t", clock[0]))
    g._scale_down = lambda reason: (calls.append(("down", reason)),
                                    setattr(g, "_idle_since", 0.0),
                                    setattr(g, "_last_scale_t", clock[0]))


def test_autoscale_sensor_hysteresis_and_guards(ckpt):
    """The sensor against hand-fed windows: a breach must be sustained
    before a scale-up, a lull before a scale-down; the bounds and a
    parked backlog gate both; nothing fires while a worker is
    mid-transition (the restart/scale-up double-spawn guard)."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    g = ProcessEngineGroup(_cfg(
        ckpt, dp=2, autoscale=True, autoscale_breach_window_s=1.0,
        autoscale_idle_window_s=1.0, autoscale_cooldown_s=5.0,
        autoscale_max_replicas=3, autoscale_low_watermark=0.25,
        engine_kw={"slo_ttft_ms": 100}), device="cpu")
    try:
        calls = []
        g._scale_up = lambda reason: (calls.append(("up", reason)),
                                      setattr(g, "_breach_since", 0.0))
        g._scale_down = lambda reason: (calls.append(("down", reason)),
                                        setattr(g, "_idle_since", 0.0))
        for h in g.workers:
            h.state = "up"
            h.last_health = {"ladder_occupancy": 0.8}
        # p95 TTFT 0.5 s over the 100 ms target, as the router saw it.
        g._ttft_obs.extend((time.perf_counter(), 0.5) for _ in range(20))
        t = 100.0
        g._autoscale_tick(t)            # arms the breach window
        g._autoscale_tick(t + 0.5)      # not sustained yet
        assert calls == []
        g._autoscale_tick(t + 1.2)
        assert calls == [("up", "slo_breach")]
        # The cooldown: a second breach at once does nothing.
        g._last_scale_t = t + 1.2
        g._autoscale_tick(t + 1.5)
        g._autoscale_tick(t + 3.0)
        assert len(calls) == 1
        # A restarting worker freezes every decision and disarms the
        # breach window.
        g.workers[1].state = "restarting"
        g._autoscale_tick(t + 50.0)
        g._autoscale_tick(t + 60.0)
        assert len(calls) == 1 and g._breach_since == 0.0
        g.workers[1].state = "up"
        # At the max: no actuation.
        g.server_cfg = dataclasses.replace(g.server_cfg,
                                           autoscale_max_replicas=2)
        g._autoscale_tick(t + 70.0)
        g._autoscale_tick(t + 72.0)
        assert len(calls) == 1
        g.server_cfg = dataclasses.replace(g.server_cfg,
                                           autoscale_max_replicas=3)
        # The burst's samples age out of the horizon; occupancy under
        # the low watermark, sustained: the coldest replica drains.
        g._ttft_obs.clear()
        g._ttft_obs.extend((time.perf_counter() - 60.0, 0.5)
                           for _ in range(20))
        for h in g.workers:
            h.last_health = {"ladder_occupancy": 0.0}
        g._autoscale_tick(t + 100.0)
        assert not g._ttft_obs
        g._autoscale_tick(t + 101.2)
        assert calls[-1] == ("down", "idle")
        # A parked backlog blocks the scale-down.
        g._deferred["batch"].append(object())
        g._autoscale_tick(t + 200.0)
        g._autoscale_tick(t + 202.0)
        assert len(calls) == 2
        g._deferred["batch"].clear()
        # At the min: one live worker never drains away.
        g.workers[1].state = "retired"
        g._autoscale_tick(t + 300.0)
        g._autoscale_tick(t + 302.0)
        assert len(calls) == 2
    finally:
        g.stop(drain=False)


def _script():
    """(tick time, mutation) steps over a process-less group: breach
    by TTFT, the cooldown, a second scale-up, the transition guard, a
    TPOT breach with and without work in flight, a rollout in progress,
    the max bound, a lull, a backlog, the min bound, a sub-target TTFT
    over a busy fleet."""
    def occ(v):
        def f(g, now):
            for h in g.workers:
                h.last_health = {"ladder_occupancy": v}
        return f

    def ttft(vals, age=0.0):
        def f(g, now):
            g._ttft_obs.clear()
            g._ttft_obs.extend((now - age, v) for v in vals)
        return f

    def state(i, s):
        return lambda g, now: setattr(g.workers[i], "state", s)

    def tpot(vals, tracked):
        def f(g, now):
            for h in g.workers:
                h.last_stats = {"slo": {"tpot_window": list(vals)}}
            g._tracked.clear()
            if tracked:
                g._tracked[1] = object()
        return f

    def cfg(**kw):
        return lambda g, now: setattr(
            g, "server_cfg", dataclasses.replace(g.server_cfg, **kw))

    def backlog(on):
        def f(g, now):
            g._deferred["batch"].clear()
            if on:
                g._deferred["batch"].append(object())
        return f

    def rollout(on):
        def f(g, now):
            (g._rollout_lock.acquire if on else g._rollout_lock.release)()
        return f

    burst = [0.05] * 19 + [0.5]
    return [
        (100.0, [occ(0.8), ttft(burst)]), (100.5, []), (101.2, []),
        (101.5, []), (103.0, []), (106.5, []), (107.6, []),
        (108.0, [state(1, "restarting")]), (110.0, []),
        (111.0, [state(1, "up")]),
        (120.0, [ttft(burst, age=60.0), tpot([0.2] * 8, True)]),
        (121.5, []),
        (130.0, [tpot([0.2] * 8, False)]), (131.5, []),
        (140.0, [rollout(True), tpot([0.2] * 8, True)]), (142.0, []),
        (143.0, [rollout(False), cfg(autoscale_max_replicas=2)]),
        (145.0, []), (150.0, [cfg(autoscale_max_replicas=3)]),
        (151.5, []),
        (160.0, [tpot([], False), ttft([]), occ(0.0)]), (160.7, []),
        (161.5, []), (170.0, [backlog(True)]), (172.0, []),
        (173.0, [backlog(False)]), (174.5, []),
        (180.0, [state(1, "retired")]), (182.0, []),
        (183.0, [state(1, "up"), ttft([0.05] * 20), occ(0.3)]),
        (185.0, []), (190.0, [occ(0.1)]), (191.5, []),
    ]


def test_autoscale_tick_matches_reference(ckpt):
    """One hand-fed window sequence through the reference's
    ProcessEngineGroup._autoscale_tick and the port's, each process-less
    with _scale_up and _scale_down stubbed: the same calls in the same
    order, and the same breach and lull windows after every tick."""
    from tpu_inference.server.fleet import ProcessEngineGroup as JGroup
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    kw = dict(dp=2, autoscale=True, autoscale_breach_window_s=1.0,
              autoscale_idle_window_s=1.0, autoscale_cooldown_s=5.0,
              autoscale_max_replicas=3, autoscale_low_watermark=0.25,
              engine_kw={"slo_ttft_ms": 100, "slo_tpot_ms": 50})
    groups = {"ref": JGroup(_ref_cfg(**kw)),
              "port": ProcessEngineGroup(_cfg(ckpt, **kw), device="cpu")}
    traces = {}
    try:
        for name, g in groups.items():
            calls, clock, trace = [], [0.0], []
            _stub_scaling(g, calls, clock)
            for h in g.workers:
                h.state = "up"
            for t, steps in _script():
                clock[0] = t
                for step in steps:
                    step(g, time.perf_counter())
                g._autoscale_tick(t)
                trace.append((t, list(calls), g._breach_since,
                              g._idle_since))
            traces[name] = trace
    finally:
        for g in groups.values():
            g._tracked.clear()
            g.stop(drain=False)
    assert traces["port"] == traces["ref"]
    calls = traces["port"][-1][1]
    assert calls.count(("up", "slo_breach")) >= 3
    assert calls.count(("down", "idle")) >= 2


@pytest.mark.parametrize("occ,roles,retired,expect", [
    ((0.9, 0.1, 0.5), None, (), 1),
    ((0.2, 0.2, 0.2), None, (), 2),
    ((0.9, 0.1, 0.5), ("prefill", "decode", "decode"), (), 1),
    ((0.0, 0.5, 0.5), ("prefill", "decode", "decode"), (2,), None),
    ((0.3, 0.1, 0.3), ("prefill", "decode", "mixed"), (1,), 0),
    ((0.3, 0.1, 0.3), None, (0, 2), None),
])
def test_retire_candidate_prefers_cold_and_respects_pd(ckpt, occ, roles,
                                                       retired, expect):
    """The scale-down pick on both routers for the same fleet: the
    least-loaded, lowest-occupancy worker (ties: the newest index),
    never the last worker of a P/D phase, none from a single worker."""
    from tpu_inference.server.fleet import ProcessEngineGroup as JGroup
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    picks = []
    for g in (JGroup(_ref_cfg(dp=3)),
              ProcessEngineGroup(_cfg(ckpt, dp=3), device="cpu")):
        try:
            for i, h in enumerate(g.workers):
                h.state = "retired" if i in retired else "up"
                h.last_health = {"ladder_occupancy": occ[i]}
            if roles is not None:
                g.roles[:] = list(roles)
                g.pd_enabled = True
            cand = g._retire_candidate()
            picks.append(None if cand is None else cand.replica)
        finally:
            g.stop(drain=False)
    assert picks == [expect, expect]


def test_supervision_keys_match_reference(ckpt):
    """The process routers' supervision view and /healthz have the
    reference's keys, the elastic and KV-fabric ones included, and the
    same zeroed elastic and fabric values at boot."""
    from tpu_inference.server.fleet import ProcessEngineGroup as JGroup
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    ref = JGroup(_ref_cfg(class_queue_depth=4))
    port = ProcessEngineGroup(_cfg(ckpt, class_queue_depth=4), device="cpu")
    try:
        sr, sp = ref.supervision_counters(), port.supervision_counters()
        assert set(sp) == set(sr)
        for k in ("scale_ups", "scale_downs", "rollouts",
                  "class_preemptions", "class_shed", "class_deferred",
                  "route_fabric_hits", "fabric_puts", "fabric_hits"):
            assert sp[k] == sr[k], k
        hp, hr = port.health_snapshot(), ref.health_snapshot()
        assert set(hp) == set(hr)
        assert hp["fabric"] == hr["fabric"]
    finally:
        ref.stop(drain=False)
        port.stop(drain=False)


@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_cancel_frees_pages_like_reference(when):
    """A cancel landing while the engine thread is inside a dispatch (a
    prefill held by the chaos wedge) or mid-decode: the request ends
    "cancelled" on both schedulers and both pools come back clean, the
    worker's cancel verb being exactly this scheduler call."""
    from tests._leak import assert_pool_clean
    from tpu_inference.engine.engine import InferenceEngine as JEngine
    from tpu_inference.engine.engine import Sequence as JSequence
    from tpu_inference.engine.scheduler import EngineScheduler as JSched
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.engine.scheduler import EngineScheduler

    wedge = 0.6 if when == "prefill" else 0.0
    out = {}
    for impl in ("ref", "port"):
        if impl == "ref":
            eng = JEngine(jcfg.tiny_llama(vocab_size=512),
                          jcfg.EngineConfig(**ENGINE_KW,
                                            chaos_step_wedge_s=wedge),
                          attn_backend="dense")
            sched, seq_cls = JSched(eng), JSequence
        else:
            eng = InferenceEngine(tcfg.tiny_llama(vocab_size=512),
                                  tcfg.EngineConfig(
                                      **ENGINE_KW,
                                      chaos_step_wedge_s=wedge),
                                  device="cpu")
            sched, seq_cls = EngineScheduler(eng), Sequence
        sched.start()
        try:
            toks, done, box = [], threading.Event(), {}
            sched.submit(seq_cls(request_id=1,
                                 prompt_tokens=list(range(3, 40)),
                                 max_new_tokens=60),
                         lambda s, t: toks.append(t),
                         lambda s: (box.update(seq=s), done.set()))
            if when == "prefill":
                _wait(lambda: sched.step_inflight_since is not None,
                      what="the prefill dispatch")
            else:
                _wait(lambda: len(toks) >= 5, what="decode")
            sched.cancel(1)
            assert done.wait(60.0)
            eng.chaos_step_wedge_s = 0.0
            _wait(lambda: not any(s is not None for s in eng.slots),
                  what="the slot freed")
            out[impl] = (box["seq"].finish_reason,
                         (len(toks) == 0) if when == "prefill"
                         else len(toks) < 60)
            assert_pool_clean(eng)
        finally:
            sched.stop(drain=False, timeout=10.0)
    assert out["port"] == out["ref"] == ("cancelled", True)


def test_lanes_pump_preempt_and_cancel_under_contention(ckpt):
    """The lanes' one consumer (the pump) against preemptions and
    cancels on other threads, with a short switch interval: a request is
    dispatched once per generation, never sits in a lane while bound to a
    worker, and every one not cancelled ends bound, the lanes empty."""
    import random
    import sys

    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    class _Client:
        alive = True

        def rpc(self, verb, **kw):
            return {}

        def close(self):
            pass

    g = ProcessEngineGroup(_cfg(ckpt, dp=2, admission_queue_depth=1,
                                class_queue_depth=1000), device="cpu")
    for h in g.workers:
        h.state, h.client = "up", _Client()
    dispatched, bad = [], []

    def dispatch(entry, h, hit):
        with g._lock:
            key = (entry.template.request_id, entry.generation)
            if key in dispatched or entry.worker is not None:
                bad.append(key)
            dispatched.append(key)
            entry.worker, entry.client = h, h.client
        return True

    g._dispatch = dispatch
    g._pick = lambda pool, seq=None, phase=None: (pool[0], (0, 0), 0)
    stop = threading.Event()
    rids = list(range(1, 301))
    produced, cancelled = [], set()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def producer():
            for rid in rids:
                cls = ("batch", "background")[rid % 2]
                assert g._defer(Sequence(request_id=rid,
                                         prompt_tokens=[1, rid % 50],
                                         max_new_tokens=4,
                                         priority_class=cls),
                                lambda s, t: None, lambda s: None, cls)
                produced.append(rid)

        def preempter():
            while not stop.is_set():
                g._preempt_for_interactive()

        def canceller():
            rng = random.Random(0)
            for _ in range(60):
                while not produced:
                    time.sleep(0.001)
                rid = rng.choice(produced)
                cancelled.add(rid)
                g.cancel(rid)

        def pump():
            while not stop.is_set():
                g._pump_deferred()

        threads = [threading.Thread(target=f) for f in
                   (producer, preempter, preempter, canceller, pump, pump)]
        # Two pumps here: the monitor is the one consumer in the fleet,
        # and a second must not break the once-per-generation rule
        # either (each pop is re-checked under the lock).
        for t in threads:
            t.start()
        threads[0].join(timeout=60)
        threads[3].join(timeout=60)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    g._pump_deferred()
    try:
        assert bad == []
        assert not any(g._deferred.values())
        with g._lock:
            assert set(g._tracked) == set(rids) - cancelled
            assert all(e.worker is not None for e in g._tracked.values())
        assert sum(g.class_preemptions.values()) > 0
    finally:
        with g._lock:
            g._tracked.clear()
        g.stop(drain=False)


# ------------------------------------------------- real process fleets


def test_crash_loop_quarantine(ckpt, oracle):
    """The restart budget spent: the replica lands quarantined, visible
    in /healthz (degraded, not absent), pinned by
    tpu_inf_worker_quarantined and out of tpu_inf_replicas, and the
    survivor keeps serving byte-identically."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=2, worker_restart_max=0),
                               device="cpu")
    group.start()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        group.apply_chaos({"replica": 1, "kill": "kill9"})
        _wait(lambda: group.workers[1].state == "quarantined",
              what="quarantine")
        hs = group.health_snapshot()
        assert hs["status"] == "degraded"
        assert hs["replicas"][1]["worker_state"] == "quarantined"
        assert "quarantined" in hs["supervision"]["states"]
        text = group.prometheus_text()
        assert re.search(
            r'tpu_inf_worker_quarantined\{replica="1"\} 1(\.0)?\b', text)
        assert re.search(
            r'tpu_inf_worker_quarantined\{replica="0"\} 0(\.0)?\b', text)
        m = re.search(r"^tpu_inf_replicas (\S+)$", text, re.M)
        assert m and float(m.group(1)) == 1.0
        toks, done, box = _submit(group, 1, [5, 6, 7], 8)
        fin = _finish(done, box)
        assert fin.finish_reason == "length" and fin.routed_replica == 0
        assert toks == _want(oracle, [5, 6, 7], 8)
    finally:
        group.stop(drain=False)


def test_priority_classes_defer_and_preempt(ckpt, oracle):
    """Per-class admission on one saturated worker: batch work parks in
    its lane instead of a 429, an interactive arrival preempts the
    running batch request (which resumes byte-identically from the
    router's token record), every class drains to completion, the pool
    is clean after, and the six elastic series render."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=1, admission_queue_depth=1,
                                    class_queue_depth=4), device="cpu")
    group.start()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        p1, p2, p3 = [1, 2, 3, 4, 5], [9, 8, 7], [3, 3, 3, 3]
        t1, d1, b1 = _submit(group, 1, p1, 48, cls="batch")
        t2, d2, b2 = _submit(group, 2, p2, 12, cls="batch")   # defers
        assert group.supervision_counters()["class_deferred"] == \
            {"batch": 1, "background": 0}
        t3, d3, b3 = _submit(group, 3, p3, 12, cls="interactive")
        fin3 = _finish(d3, b3)
        assert fin3.finish_reason == "length"
        assert t3 == _want(oracle, p3, 12)
        fin1, fin2 = _finish(d1, b1), _finish(d2, b2)
        assert fin1.finish_reason == fin2.finish_reason == "length"
        assert t1 == _want(oracle, p1, 48)
        assert t2 == _want(oracle, p2, 12)
        sup = group.supervision_counters()
        assert sup["class_preemptions"].get("batch", 0) >= 1
        assert sup["requests_shed"] == 0 and sup["class_shed"] == {}
        assert sup["class_deferred"] == {"batch": 0, "background": 0}
        # The background lane is bounded: past its depth the shed fires
        # with the single-cap message, counted by class.
        held = _submit(group, 10, p1, 48, cls="batch")
        parked = [_submit(group, 11 + i, [2, i], 4, cls="background")
                  for i in range(4)]
        from tpu_inference_torch.server.replicas import FleetSaturated
        with pytest.raises(FleetSaturated,
                           match=r"admission queue cap reached \(1 >= 1 on "
                                 r"the least-loaded worker\)"):
            _submit(group, 20, [2, 9], 4, cls="background")
        for pend in (held, *parked):
            assert _finish(pend[1], pend[2]).finish_reason == "length"
        text = group.prometheus_text()
        meta, samples = _prom.parse(text)
        got = {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples
               if n.startswith(("tpu_inf_class_", "tpu_inf_fleet_scale",
                                "tpu_inf_fleet_rollouts"))}
        assert got[("tpu_inf_class_preempted_total",
                    (("class", "batch"),))] >= 1
        assert got[("tpu_inf_class_shed_total",
                    (("class", "background"),))] == 1
        assert got[("tpu_inf_class_shed_total",
                    (("class", "interactive"),))] == 0
        assert got[("tpu_inf_class_deferred", (("class", "batch"),))] == 0
        assert len(got) == 3 + 3 + 2 + 2
        for h in group.workers:
            snap = h.client.rpc("debug", clear=True)
            assert snap["slots_bound"] == 0 and snap["refs_held"] == 0
            assert snap["num_free"] == snap["num_pages"] - 1, snap
    finally:
        group.stop(drain=False)
