"""The port's request tracing and rolling SLO gauges against the
reference's (tests/test_tracing.py case by case, port beside reference):
SpanRecorder units and its caps, eviction and disabled behaviour with
the reference's counters, ``assemble_trace``, ``spans_to_chrome``,
``pooled_quantile``, ``SLOTracker`` and ``pooled_slo`` equal to the
reference's on inputs made from a seed, the span vocabulary, the
scheduler's spans and timelines beside the reference scheduler's on the
same request mix (timestamps aside), and the dp=1 EngineGroup's trace
assembly, SLO blocks and Prometheus series."""

import math
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import _prom
from tests.test_torch_ladder import (VOCAB, ecfg, port_engine, ref_engine,
                                     sched_run)
from tpu_inference import telemetry as jtel
from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.telemetry import (RollingWindow, SLOTracker,
                                           SpanRecorder, assemble_trace,
                                           pooled_quantile, pooled_slo,
                                           spans_to_chrome)

ROOT = Path(__file__).resolve().parent.parent
ENGINE_KW = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
                 max_batch_size=2, prefill_buckets=(16,))

# ------------------------------------------------------------- units


def test_span_recorder_add_seal_export():
    rec = SpanRecorder(enabled=True, replica=3)
    t0 = time.perf_counter()
    rec.add("prefill", "t1", t0, t0 + 0.5, cached_tokens=4)
    rec.add("decode", "t1", t0 + 0.5, t0 + 1.0)
    assert rec.export_open("t1") and rec.export_recent("t1") == []
    rec.seal("t1")
    spans = rec.export_recent("t1")
    assert [s["name"] for s in spans] == ["prefill", "decode"]
    assert all(s["replica"] == 3 and s["trace"] == "t1" for s in spans)
    assert spans[0]["attrs"]["cached_tokens"] == 4
    # A perf_counter start maps to about now in unix seconds.
    assert abs(spans[0]["ts"] - time.time()) < 5.0
    assert spans[0]["dur"] == pytest.approx(0.5, abs=1e-6)
    assert rec.get_trace("t1") is not None
    assert rec.recent_traces(10) == {"t1": spans}
    assert rec.recent_traces(0) == {}


def _drive_recorder(mod, enabled=True):
    """The same sequence of recorder calls on either package's class;
    returns (recorder, per-call observations without timestamps)."""
    rec = mod.SpanRecorder(enabled=enabled, replica=1)
    t = 100.0
    seen = []
    cap, traces = mod.SpanRecorder.MAX_SPANS_PER_TRACE, \
        mod.SpanRecorder.MAX_TRACES
    for _ in range(cap + 10):
        rec.add("prefill_chunk", "big", t, t + 0.001, parent="prefill")
    seen.append(len(rec.export_open("big")))
    for i in range(traces + 5):
        rec.add("prefill", f"open-{i}", t, t + 0.001)
    seen.append(len(rec.export_open("big")))
    for i in range(traces + 3):
        rec.seal(f"open-{i}")
    rec.add("decode", "late", t, t + 1)
    rec.seal("late")
    rec.add_maintenance("kv_swap_out", t, t + 1, pages=2)
    rec.ingest("late", [{"name": "route", "trace": "late", "parent":
                         "request", "ts": 1.0, "dur": 0.1, "replica": -1}])
    seen.append([(s["name"], s["parent"], s.get("attrs"))
                 for s in rec.get_trace("late") or ()])
    seen.append(sorted(rec.recent_traces(1000)))
    seen.append([(s["name"], s.get("attrs"))
                 for s in rec.maintenance_spans()])
    return rec, seen


@pytest.mark.parametrize("enabled", [True, False])
def test_span_recorder_caps_and_disabled(enabled):
    """Caps, eviction order and the kill switch give the reference's
    counters and contents on the same calls."""
    rec, seen = _drive_recorder(telemetry, enabled)
    jrec, jseen = _drive_recorder(jtel, enabled)
    assert SpanRecorder.MAX_TRACES == jtel.SpanRecorder.MAX_TRACES == 256
    assert (SpanRecorder.MAX_SPANS_PER_TRACE
            == jtel.SpanRecorder.MAX_SPANS_PER_TRACE == 96)
    assert seen == jseen
    assert (rec.spans_dropped, rec.traces_evicted) == \
        (jrec.spans_dropped, jrec.traces_evicted)
    if enabled:
        assert seen[0] == rec.MAX_SPANS_PER_TRACE and seen[1] == 0
        assert rec.spans_dropped == 10 and rec.traces_evicted > 0
    else:
        assert seen == [0, 0, [], [], []]
        assert rec.get_trace("late") is None


def test_span_recorder_ingest_after_seal():
    rec = SpanRecorder(enabled=True, replica=-1)
    t = time.perf_counter()
    rec.add("request", "h1", t, t + 1.0, parent="")
    rec.seal("h1")
    rec.ingest("h1", [{"name": "prefill", "trace": "h1", "parent":
                       "request", "ts": time.time(), "dur": 0.2,
                       "replica": 0}])
    assert {s["name"] for s in rec.get_trace("h1")} == {"request", "prefill"}


def _random_spans(rng, trace_id="t", n=12) -> list:
    """Spans of a plausible tree (parents by name, a few orphans and
    self-parents, several replicas, ties in ts) made from ``rng``."""
    names = ["route", "queue_wait", "prefill", "prefill_chunk", "decode",
             "kv_swap_in", "orphan"]
    base = 1.7e9 + float(rng.integers(0, 1000))
    out = []
    if rng.random() < 0.7:
        out.append({"name": "request", "trace": trace_id, "parent": "",
                    "ts": base, "dur": 3.0, "replica": -1})
    for _ in range(n):
        name = names[int(rng.integers(0, len(names)))]
        parent = {"prefill_chunk": "prefill", "orphan": "nope"}.get(
            name, "request")
        if rng.random() < 0.1:
            parent = name
        span = {"name": name, "trace": trace_id, "parent": parent,
                "ts": round(base + float(rng.integers(0, 20)) * 0.1, 6),
                "dur": round(float(rng.random()), 6),
                "replica": int(rng.integers(-1, 3))}
        if rng.random() < 0.5:
            span["attrs"] = {"pages": int(rng.integers(0, 9))}
        out.append(span)
    return out


def test_assemble_trace_parent_rules():
    now = time.time()

    def span(name, parent, ts, dur, replica=0):
        return {"name": name, "trace": "t", "parent": parent,
                "ts": ts, "dur": dur, "replica": replica}

    spans = [
        span("request", "", now, 2.0, replica=-1),
        span("queue_wait", "request", now + 0.0, 0.1),
        span("prefill", "request", now + 0.1, 0.5),
        span("prefill_chunk", "prefill", now + 0.1, 0.2),
        span("prefill_chunk", "prefill", now + 0.3, 0.2),
        span("decode", "request", now + 0.6, 1.0, replica=1),
        span("orphan_name", "no_such_parent", now + 0.2, 0.1),
    ]
    tree = assemble_trace("t", spans)
    assert tree == jtel.assemble_trace("t", spans)
    assert tree["trace_id"] == "t" and tree["n_spans"] == 7
    assert tree["replicas"] == [-1, 0, 1]
    root = tree["tree"]
    assert root["name"] == "request" and "synthetic" not in root
    assert [c["name"] for c in root["children"]] == \
        ["queue_wait", "prefill", "orphan_name", "decode"]
    prefill = next(c for c in root["children"] if c["name"] == "prefill")
    assert [c["name"] for c in prefill["children"]] == \
        ["prefill_chunk", "prefill_chunk"]
    tree2 = assemble_trace("t", spans[1:3])
    assert tree2["tree"]["synthetic"] is True
    assert len(tree2["tree"]["children"]) == 2


@pytest.mark.parametrize("seed", range(4))
def test_assemble_trace_equals_reference(seed):
    rng = np.random.default_rng(seed)
    spans = _random_spans(rng, n=int(rng.integers(0, 20)))
    assert assemble_trace("t", spans) == jtel.assemble_trace("t", spans)


def test_spans_to_chrome_shape():
    now = time.time()
    traces = {"tA": [
        {"name": "request", "trace": "tA", "parent": "", "ts": now,
         "dur": 1.0, "replica": -1},
        {"name": "prefill", "trace": "tA", "parent": "request",
         "ts": now + 0.1, "dur": 0.4, "replica": 0,
         "attrs": {"cached_tokens": 2}},
    ]}
    maint = [{"name": "kv_swap_out", "trace": "-maintenance-",
              "parent": "", "ts": now, "dur": 0.01, "replica": 0,
              "attrs": {"pages": 3}}]
    chrome = spans_to_chrome(traces, {0: "router", 1: "replica 0"},
                             maintenance=maint, other_data={"note": 1})
    assert chrome == jtel.spans_to_chrome(
        traces, {0: "router", 1: "replica 0"}, maintenance=maint,
        other_data={"note": 1})
    evs = chrome["traceEvents"]
    assert chrome["displayTimeUnit"] == "ms"
    assert chrome["otherData"] == {"note": 1}
    x = [e for e in evs if e["ph"] == "X"]
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["pid"] for e in x} == {0, 1}
    req = next(e for e in x if e["name"] == "request")
    pf = next(e for e in x if e["name"] == "prefill")
    assert req["pid"] == 0 and pf["pid"] == 1
    assert pf["args"]["trace_id"] == "tA"
    assert pf["args"]["cached_tokens"] == 2
    assert pf["ts"] == pytest.approx((now + 0.1) * 1e6, abs=1.0)
    assert pf["dur"] == pytest.approx(0.4e6, abs=1.0)
    m = next(e for e in x if e["name"] == "kv_swap_out")
    assert m["tid"] == 0 and m["cat"] == "maintenance"
    assert {e["name"] for e in meta} >= {"process_name", "thread_name"}


@pytest.mark.parametrize("seed", range(3))
def test_spans_to_chrome_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    traces = {f"t{i}": _random_spans(rng, f"t{i}") for i in range(3)}
    maint = [dict(s, trace="-maintenance-", parent="")
             for s in _random_spans(rng, "m", n=3)]
    names = {0: "router", 2: "replica 1"} if seed else None
    assert spans_to_chrome(traces, names, maintenance=maint,
                           other_data={"seed": seed}) == \
        jtel.spans_to_chrome(traces, names, maintenance=maint,
                             other_data={"seed": seed})


def test_rolling_window_and_pooled_quantiles():
    w = RollingWindow(size=4)
    assert w.quantile(0.95) is None
    for v in (1.0, 2.0, 3.0, 4.0):
        w.observe(v)
    assert w.quantile(0.5) == 3.0 and w.quantile(0.95) == 4.0
    w.observe(10.0)
    assert sorted(w.values()) == [2.0, 3.0, 4.0, 10.0]
    assert pooled_quantile([[1.0, 1.0, 1.0], [100.0]], 0.5) == 1.0
    assert pooled_quantile([[], []], 0.5) is None
    assert (telemetry.SLO_WINDOW, telemetry.SLO_QUANTILES) == \
        (jtel.SLO_WINDOW, jtel.SLO_QUANTILES)


@pytest.mark.parametrize("seed", range(3))
def test_pooled_quantile_equals_reference(seed):
    rng = np.random.default_rng(seed)
    windows = [rng.exponential(0.05, size=int(rng.integers(0, 700)))
               .tolist() for _ in range(int(rng.integers(1, 4)))]
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert pooled_quantile(windows, q) == \
            jtel.pooled_quantile(windows, q)
    w, jw = RollingWindow(), jtel.RollingWindow()
    for v in windows[0]:
        w.observe(v)
        jw.observe(v)
    assert w.values() == jw.values() and w.count == jw.count
    assert w.quantile(0.95) == jw.quantile(0.95)


def test_slo_tracker_breaches_and_pooling():
    slo = SLOTracker(ttft_target_s=0.1, tpot_target_s=0.01)
    slo.observe(0.05, 0.005)
    slo.observe(0.5, 0.05)
    slo.observe(None, 0.005)
    assert slo.ttft_breaches == 1 and slo.tpot_breaches == 1
    snap = slo.snapshot()
    assert snap["ttft_target_s"] == 0.1
    assert snap["ttft_p95_s"] == 0.5
    assert len(snap["tpot_window"]) == 3
    free = SLOTracker()
    free.observe(100.0, 100.0)
    assert free.ttft_breaches == 0
    assert free.snapshot()["ttft_target_s"] is None
    pooled = pooled_slo([snap, free.snapshot()])
    assert pooled["ttft_breaches"] == 1
    assert pooled["ttft_p95_s"] == 100.0
    assert math.isnan(SLOTracker().gauge_value("ttft", 0.95))


@pytest.mark.parametrize("seed", range(3))
def test_slo_tracker_and_pooled_slo_equal_reference(seed):
    """The same observations (None gaps included, past the window) give
    the reference's snapshots, gauge values and pooled view."""
    rng = np.random.default_rng(seed)
    targets = [(0.05, 0.01), (0.0, 0.02), (0.1, 0.0)]
    trackers = [(SLOTracker(*t), jtel.SLOTracker(*t)) for t in targets]
    for mine, ref in trackers:
        for _ in range(int(rng.integers(0, 600))):
            ttft = (None if rng.random() < 0.1
                    else float(rng.exponential(0.05)))
            tpot = (None if rng.random() < 0.2
                    else float(rng.exponential(0.01)))
            mine.observe(ttft, tpot)
            ref.observe(ttft, tpot)
        for inc in (True, False):
            assert mine.snapshot(inc) == ref.snapshot(inc)
        for which in ("ttft", "tpot"):
            for q in telemetry.SLO_QUANTILES:
                a, b = mine.gauge_value(which, q), ref.gauge_value(which, q)
                assert a == b or (math.isnan(a) and math.isnan(b))
    snaps = [m.snapshot() for m, _ in trackers]
    jsnaps = [r.snapshot() for _, r in trackers]
    assert pooled_slo(snaps + [None]) == jtel.pooled_slo(jsnaps + [None])


def test_emit_build_info_stable_series():
    r = telemetry.Registry()
    for _ in range(2):
        telemetry.emit_build_info(r, backend="cuda", fleet="in-process",
                                  kv_quant="int8", spec_mode="ngram",
                                  routing="prefix_affinity")
    meta, samples = _prom.parse(
        telemetry.render_prometheus([({"replica": "0"}, r)]))
    rows = [(labels, v) for name, labels, v in samples
            if name == "tpu_inf_build_info"]
    assert len(rows) == 1
    labels, value = rows[0]
    from tpu_inference_torch import __version__
    assert value == 1.0 and labels["version"] == __version__
    assert labels["kv_quant"] == "int8" and labels["fleet"] == "in-process"
    assert meta["tpu_inf_build_info"]["type"] == "gauge"


_SPAN_ADD_RE = re.compile(r'\.add(?:_maintenance)?\(\s*\n?\s*"([a-z_0-9]+)"')


def test_span_vocabulary_matches_code():
    """Every span the port's code records is in its SPAN_NAMES, every
    entry is recorded somewhere, and all are the reference's names."""
    code = set()
    for path in (ROOT / "tpu_inference_torch").rglob("*.py"):
        code |= set(_SPAN_ADD_RE.findall(path.read_text()))
    vocab = set(telemetry.SPAN_NAMES)
    assert code == vocab
    assert vocab <= set(jtel.SPAN_NAMES)


def test_span_ring_series_render():
    r = telemetry.Registry()
    rec = SpanRecorder(enabled=True)
    telemetry.register_span_ring(r, rec)
    t = time.perf_counter()
    for i in range(rec.MAX_SPANS_PER_TRACE + 2):
        rec.add("prefill_chunk", "x", t, t + 0.001)
    _, samples = _prom.parse(telemetry.render_prometheus([({}, r)]))
    by = {n: v for n, _, v in samples}
    assert by["tpu_inf_trace_ring_open"] == 1
    assert by["tpu_inf_trace_ring_traces"] == 0
    assert by["tpu_inf_trace_spans_dropped_total"] == 2
    assert by["tpu_inf_trace_evictions_total"] == 0


# ------------------------------------- scheduler/engine span emission


def _run_one(engine, seq, timeout=120.0):
    from tpu_inference_torch.engine.scheduler import EngineScheduler

    sched = EngineScheduler(engine)
    sched.start()
    done = threading.Event()
    try:
        sched.submit(seq, lambda s, t: None, lambda s: done.set())
        assert done.wait(timeout)
    finally:
        sched.stop(drain=False)
    return sched


def test_scheduler_emits_phase_spans_and_slo():
    from tpu_inference_torch.engine.engine import Sequence

    engine = port_engine(**ENGINE_KW, slo_ttft_ms=10_000.0,
                         slo_tpot_ms=0.000001)
    seq = Sequence(request_id=7, prompt_tokens=[1, 2, 3, 4, 5],
                   max_new_tokens=6, trace_id="trace-abc")
    sched = _run_one(engine, seq)
    spans = engine.telemetry.recorder.export_recent("trace-abc")
    names = [s["name"] for s in spans]
    assert names.count("queue_wait") == 1
    assert names.count("prefill") == 1
    assert names.count("decode") == 1
    decode = next(s for s in spans if s["name"] == "decode")
    assert decode["attrs"]["output_tokens"] == 6
    assert decode["attrs"]["reason"] == "length"
    prefill = next(s for s in spans if s["name"] == "prefill")
    assert (prefill["ts"] + prefill["dur"]
            == pytest.approx(decode["ts"], abs=1e-5))
    slo = engine.telemetry.slo
    assert slo.ttft.count == 1 and slo.tpot.count == 1
    assert slo.ttft_breaches == 0 and slo.tpot_breaches == 1
    assert slo.ttft_target_s == 10.0
    _, samples = _prom.parse(telemetry.render_prometheus(
        [({"replica": "0"}, engine.telemetry.registry)]))
    by = {(n, tuple(sorted(l.items()))): v for n, l, v in samples}
    assert by[("tpu_inf_slo_breaches_total",
               (("replica", "0"), ("slo", "tpot")))] == 1
    assert by[("tpu_inf_slo_ttft_seconds",
               (("q", "0.95"), ("replica", "0")))] > 0
    # The timeline's phases sum to e2e; the engine thread named itself.
    (tl,) = sched.recent_snapshot(5)
    assert tl["trace_id"] == "trace-abc" and tl["output_tokens"] == 6
    assert abs(tl["queue_wait_s"] + tl["prefill_s"] + tl["decode_s"]
               - tl["e2e_s"]) < 1e-3
    assert tl["dispatch_wall_s"] > 0 and tl["bubble_s"] >= 0
    assert sched.thread_native_id not in (None, threading.get_native_id())
    assert "slo" in sched.stats.snapshot(engine)


def test_disabled_telemetry_disables_spans(monkeypatch):
    monkeypatch.setenv("TPU_INF_TELEMETRY", "0")
    from tpu_inference_torch.engine.engine import Sequence

    engine = port_engine(**ENGINE_KW)
    assert engine.telemetry.slo is None
    seq = Sequence(request_id=8, prompt_tokens=[2, 4, 6],
                   max_new_tokens=4, trace_id="t-off")
    sched = _run_one(engine, seq)
    assert engine.telemetry.recorder.get_trace("t-off") is None
    assert "slo" not in sched.stats.snapshot(engine)
    # The timeline ring is not telemetry: it still records the request.
    assert sched.recent_snapshot(1)[0]["trace_id"] == "t-off"


# ---------------- the same request mix through both schedulers


def _prompts(n, seed, lo, hi, shared=0):
    """``n`` prompts of random lengths in [lo, hi), the first ``shared``
    tokens common to all (prefix-cache hits)."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, size=shared).tolist()
    return [head + rng.integers(0, VOCAB, size=int(rng.integers(lo, hi)))
            .tolist() for _ in range(n)]


# (engine config, prompts, max new tokens): the ladder at depth 2 with
# chunked prefill and prefix hits; a pool small enough for preemption
# and the host tier (swap-in spans, maintenance swap-outs).
MIXES = {
    "ladder-depth2-chunked": (
        ecfg(num_pages=256, max_pages_per_seq=16, decode_ladder=(2, 4, 8),
             max_batch_size=8, chunked_prefill_size=16,
             decode_pipeline_depth=2),
        _prompts(8, 11, 4, 60, shared=16), 12),
    "host-tier": (
        dict(page_size=8, num_pages=16, max_pages_per_seq=8,
             max_batch_size=8, decode_ladder=(2, 4, 8),
             prefill_buckets=(16, 32, 64), admission="optimistic",
             optimistic_headroom_pages=1, preempt_watermark_pages=4,
             host_cache_pages=64),
        _prompts(12, 3, 8, 9), 16),
    "host-tier-depth2-chunked": (
        dict(page_size=8, num_pages=14, max_pages_per_seq=8,
             max_batch_size=8, decode_ladder=(2, 4, 8),
             prefill_buckets=(16, 32), chunked_prefill_size=16,
             admission="optimistic", optimistic_headroom_pages=1,
             preempt_watermark_pages=4, host_cache_pages=64,
             decode_pipeline_depth=2),
        _prompts(10, 5, 20, 40, shared=16), 16),
}
# The timeline values that depend on no clock.
DETERMINISTIC = ("request_id", "trace_id", "attempt", "routed_replica",
                 "route_hit_pages", "route_host_hit_pages",
                 "route_fabric_hit_pages", "prompt_tokens", "cached_tokens",
                 "host_restored_pages", "output_tokens", "preemptions",
                 "finish_reason")


def _span_shape(spans) -> list:
    return [(s["name"], s["parent"], s.get("attrs"), s["replica"])
            for s in spans]


@pytest.mark.parametrize("mix", list(MIXES))
def test_scheduler_spans_and_timelines_match_reference(mix):
    """Per trace the same span names, parents and attrs in the same
    order; the same maintenance spans; timelines with the reference's
    keys and deterministic values; the same SLO observations."""
    cfg, prompts, max_new = MIXES[mix]
    jeng = ref_engine(**cfg)
    want, jseqs = sched_run(jeng, prompts, max_new, ref=True)
    eng = port_engine(**cfg)
    got, seqs = sched_run(eng, prompts, max_new)
    assert got == want
    rec, jrec = eng.telemetry.recorder, jeng.telemetry.recorder
    names = set()
    for i in range(len(prompts)):
        mine, ref = rec.get_trace(str(i)), jrec.get_trace(str(i))
        assert _span_shape(mine) == _span_shape(ref), i
        names |= {s["name"] for s in mine}
    assert {"queue_wait", "prefill", "decode"} <= names
    assert _span_shape(rec.maintenance_spans()) == \
        _span_shape(jrec.maintenance_spans())
    if mix.startswith("host-tier"):
        assert sum(s.preemptions for s in seqs) > 0
        assert "kv_swap_in" in names
    if "chunked" in mix:
        assert "prefill_chunk" in names
    # Timelines: the scheduler object is gone, the seqs are not.
    from tpu_inference.engine.scheduler import EngineScheduler as JSched
    from tpu_inference_torch.engine.scheduler import EngineScheduler
    for s, js in zip(seqs, jseqs):
        tl, jtl = EngineScheduler._timeline(s), JSched._timeline(js)
        assert list(tl) == list(jtl)
        assert {k: tl[k] for k in DETERMINISTIC} == \
            {k: jtl[k] for k in DETERMINISTIC}
        if not s.preemptions:
            # (A resume moves prefill_start past the first token.)
            assert abs(tl["queue_wait_s"] + tl["prefill_s"]
                       + tl["decode_s"] - tl["e2e_s"]) < 1e-3
    slo, jslo = eng.telemetry.slo, jeng.telemetry.slo
    assert (slo.ttft.count, slo.tpot.count) == \
        (jslo.ttft.count, jslo.tpot.count)
    eng.check_pool_clean()


# ------------------------------------------- EngineGroup (dp=1)


@pytest.fixture(scope="module")
def group():
    from tpu_inference_torch.server.replicas import EngineGroup

    g = EngineGroup([port_engine(**ENGINE_KW, slo_ttft_ms=10_000.0)],
                    tcfg.ServerConfig(model_name="t", tokenizer="byte"))
    g.start()
    yield g
    g.stop(drain=False)


def _group_run(group, rid, prompt, trace_id="", max_new=6):
    from tpu_inference_torch.engine.engine import Sequence

    done = threading.Event()
    seq = Sequence(request_id=rid, prompt_tokens=list(prompt),
                   max_new_tokens=max_new, trace_id=trace_id)
    group.submit(seq, lambda s, t: None, lambda s: done.set())
    assert done.wait(120)
    return seq


def test_group_assembles_cross_replica_trace(group):
    seq = _group_run(group, 100, list(range(1, 20)), trace_id="grp-1")
    snap = group.trace_snapshot("grp-1")
    assert snap is not None
    names = {s["name"] for s in snap["spans"]}
    assert {"request", "route", "queue_wait", "prefill",
            "decode"} <= names
    root = snap["tree"]
    assert root["name"] == "request" and root["replica"] == -1
    assert root["attrs"] == {"reason": "length", "attempts": 0,
                             "output_tokens": 6}
    assert {c["name"] for c in root["children"]} >= {
        "route", "queue_wait", "prefill", "decode"}
    decode = next(s for s in snap["spans"] if s["name"] == "decode")
    assert decode["replica"] == seq.routed_replica == 0
    route = next(s for s in snap["spans"] if s["name"] == "route")
    assert route["attrs"] == {"dest": 0, "hbm_hit": 0, "host_hit": 0,
                              "fabric_hit": 0}
    # The same prompt again: the route peeks two cached pages.
    again = _group_run(group, 99, list(range(1, 20)), trace_id="grp-2")
    assert again.route_hit_pages == 2 and again.cached_tokens == 16
    route = next(s for s in group.trace_snapshot("grp-2")["spans"]
                 if s["name"] == "route")
    assert route["attrs"]["hbm_hit"] == 2
    chrome = group.trace_chrome()
    x = [e for e in chrome["traceEvents"] if e.get("ph") == "X"
         and e["args"].get("trace_id") == "grp-1"]
    assert {e["pid"] for e in x} == {0, 1}
    assert len(x) == len(snap["spans"])


def test_group_mints_trace_id_when_absent(group):
    seq = _group_run(group, 101, [9, 8, 7])
    assert seq.trace_id
    assert group.trace_snapshot(seq.trace_id) is not None
    assert group.trace_snapshot("no-such-trace") is None
    tl = group.recent_snapshot(1)[0]
    assert tl["trace_id"] == seq.trace_id and tl["routed_replica"] == 0


def test_group_health_and_stats_carry_slo(group):
    _group_run(group, 102, [5, 5, 5])
    hz = group.health_snapshot()
    assert hz["slo"]["window_requests"] >= 1
    assert hz["slo"]["ttft_p95_s"] is not None
    assert hz["slo"]["ttft_target_s"] == 10.0
    assert all("slo" in r and "ttft_window" not in r["slo"]
               for r in hz["replicas"])
    ss = group.stats_snapshot()
    assert ss["slo"]["ttft_p95_s"] is not None
    assert "ttft_window" not in ss["slo"]
    _, samples = _prom.parse(group.prometheus_text())
    seen = set()
    for name, labels, _ in samples:
        key = (name, tuple(sorted(labels.items())))
        assert key not in seen, key
        seen.add(key)
    slo_rows = [l for n, l, v in samples if n == "tpu_inf_slo_ttft_seconds"]
    assert len([l for l in slo_rows if "replica" in l]) == 2
    fleet = {l["q"]: v for n, l, v in samples
             if n == "tpu_inf_slo_ttft_seconds" and "replica" not in l}
    ttfts = group.engine.telemetry.slo.ttft.values()
    assert fleet == {"0.5": pooled_quantile([ttfts], 0.5),
                     "0.95": pooled_quantile([ttfts], 0.95)}
    binfo = [l for n, l, v in samples if n == "tpu_inf_build_info"]
    assert len(binfo) == 2                                   # rep+fleet
    ring = {n for n, l, v in samples if n.startswith("tpu_inf_trace_")}
    assert ring == {"tpu_inf_trace_ring_traces", "tpu_inf_trace_ring_open",
                    "tpu_inf_trace_spans_dropped_total",
                    "tpu_inf_trace_evictions_total"}


def test_group_sheds_and_seals_route_span():
    """A request shed at the admission cap leaves a sealed trace holding
    only its route span."""
    from tpu_inference_torch.engine.engine import Sequence
    from tpu_inference_torch.server.replicas import (EngineGroup,
                                                     FleetSaturated)

    g = EngineGroup([port_engine(**ENGINE_KW)],
                    tcfg.ServerConfig(admission_queue_depth=1))
    g.schedulers[0].submit(Sequence(request_id=0, prompt_tokens=[1, 2],
                                    max_new_tokens=2),
                           lambda s, t: None, lambda s: None)
    with pytest.raises(FleetSaturated):
        g.submit(Sequence(request_id=1, prompt_tokens=[3, 4],
                          max_new_tokens=2, trace_id="shed"),
                 lambda s, t: None, lambda s: None)
    assert [s["name"] for s in g._recorder.export_recent("shed")] == \
        ["route"]
    assert g._recorder._open == {}
