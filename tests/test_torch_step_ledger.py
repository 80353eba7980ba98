"""The port's step ledger against the reference's (tests/test_step_ledger.py
cases, port beside reference): ring semantics, the null ledger, pinned
verdicts, attention FLOPs, the MFU EWMA replay, the merge, the telemetry
kill switch; ``roofline_report`` and ``merge_steps_reports`` equal to the
reference's on identical records; the same scheduler run in both packages
pushing the same records in every field but the four walls; and over
HTTP, /debug/steps, /debug/profile and their absence without
``enable_debug``."""

import http.client
import json
import math
import os
import time

import numpy as np
import pytest

from tests.test_torch_ladder import (VOCAB, ecfg, port_engine, ref_engine,
                                     sched_run)
from tpu_inference import telemetry as jtel
from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.server.http import InferenceServer
from tpu_inference_torch.telemetry import (NULL_LEDGER, STEP_FIELDS,
                                           EngineTelemetry, StepCostModel,
                                           StepLedger, merge_steps_reports,
                                           roofline_report)

TIMEOUT = 60
CHUNKED = dict(page_size=8, num_pages=128, max_pages_per_seq=16,
               max_batch_size=4, prefill_buckets=(16, 32),
               chunked_prefill_size=16, enable_prefix_cache=False)

# ------------------------------------------------------------- ring


def test_ledger_ring_semantics_and_overflow():
    led = StepLedger(depth=2)
    assert led.depth == 8, "depth must floor at 8"
    led = StepLedger(depth=8)
    for i in range(5):
        led.push("decode", rung=4, slots=2, tokens=i, chunk_tokens=0,
                 steps=1, device_s=0.01, staging_s=0.0, bubble_s=0.0,
                 kv_read_tokens=10, kv_swap_bytes=0.0, spec_accepted=0,
                 compile_event=False)
    assert led.count == 5 and not led.overflowed
    assert [r[4] for r in led.records()] == [0, 1, 2, 3, 4], "oldest first"
    for i in range(5, 20):
        led.push("decode", 4, 2, i, 0, 1, 0.01, 0.0, 0.0, 10, 0.0, 0,
                 False)
    assert led.count == 20 and led.overflowed
    recs = led.records()
    assert len(recs) == 8
    assert [r[4] for r in recs] == list(range(12, 20))
    snap = led.snapshot()
    assert len(snap) == 8 and set(snap[0]) == set(STEP_FIELDS)
    assert snap[-1]["tokens"] == 19 and snap[-1]["kind"] == "decode"
    assert STEP_FIELDS == jtel.STEP_FIELDS
    assert telemetry.STEP_KINDS == jtel.STEP_KINDS


def test_null_ledger_is_inert():
    NULL_LEDGER.push("decode", 4, 2, 1, 0, 1, 0.01, 0.0, 0.0, 0, 0.0, 0,
                     False)
    assert NULL_LEDGER.records() == []
    assert NULL_LEDGER.snapshot() == []
    assert NULL_LEDGER.count == 0 and not NULL_LEDGER.overflowed


# ------------------------------------------------------- roofline


def _model(mod=telemetry, **kw):
    base = dict(n_params=1000, n_layers=1, n_heads=1, head_dim=1,
                weight_bytes=1000, kv_token_bytes=0, peak_flops=1e6,
                peak_hbm_bw=1e6)
    base.update(kw)
    return mod.StepCostModel(**base)


def test_roofline_pinned_verdicts():
    """One synthetic record per regime, graded by a hand-sized model."""
    model = _model()
    led = StepLedger(depth=16)
    # compute-bound: 2 * 1000 * 500 FLOPs in 1 s (compute_frac 1.0).
    led.push("decode", rung=4, slots=4, tokens=500, chunk_tokens=0,
             steps=1, device_s=1.0, staging_s=0.0, bubble_s=0.0,
             kv_read_tokens=0, kv_swap_bytes=0.0, spec_accepted=0,
             compile_event=False)
    # hbm-bound: 1000 loop iterations stream the weights 1000 times.
    led.push("prefill_chunk", rung=0, slots=1, tokens=1, chunk_tokens=1,
             steps=1000, device_s=1.0, staging_s=0.0, bubble_s=0.0,
             kv_read_tokens=0, kv_swap_bytes=0.0, spec_accepted=0,
             compile_event=True)
    # host-bound: staging + bubble (0.5 s) over a 0.1 s device wall.
    led.push("hybrid", rung=2, slots=2, tokens=10, chunk_tokens=16,
             steps=2, device_s=0.1, staging_s=0.3, bubble_s=0.2,
             kv_read_tokens=50, kv_swap_bytes=0.0, spec_accepted=0,
             compile_event=False)
    rep = roofline_report(led, model)
    assert rep["enabled"] and rep["records_window"] == 3
    assert not rep["truncated"]
    kinds = rep["kinds"]
    assert kinds["decode"]["verdict"] == "compute-bound"
    assert kinds["prefill_chunk"]["verdict"] == "hbm-bound"
    assert kinds["hybrid"]["verdict"] == "host-bound"
    assert kinds["decode"]["achieved_flops_per_s"] == pytest.approx(1e6)
    assert kinds["prefill_chunk"]["achieved_bytes_per_s"] == (
        pytest.approx(1e6, rel=1e-3))
    assert kinds["hybrid"]["host_frac"] == pytest.approx(0.5 / 0.6,
                                                         rel=1e-3)
    assert set(rep["rung_occupancy"]) == {"4", "2"}
    assert rep["rung_occupancy"]["4"] == {"dispatches": 1,
                                          "mean_slots": 4.0}
    assert rep["top_sinks"][0]["sink"] == "decode.device"
    secs = [s["seconds"] for s in rep["top_sinks"]]
    assert secs == sorted(secs, reverse=True) and len(secs) == 3
    assert rep["compile_events"] == 1
    empty = roofline_report(led, model, now=time.time() + 3600)
    assert empty["records_window"] == 0 and empty["kinds"] == {}


def test_kv_read_attention_flops_counted():
    model = _model(n_layers=2, n_heads=4, head_dim=8)
    rec = (time.time(), "decode", 4, 4, 10, 0, 1, 0.5, 0.0, 0.0,
           1000, 0.0, 0, 0)
    assert model.flops(rec) == pytest.approx(
        2.0 * 1000 * 10 + 4.0 * 2 * 4 * 8 * 1000)
    assert model.hbm_bytes(rec) == pytest.approx(1000 * 1 + 0 + 0.0)
    jmodel = _model(jtel, n_layers=2, n_heads=4, head_dim=8)
    assert model.flops(rec) == jmodel.flops(rec)
    assert model.hbm_bytes(rec) == jmodel.hbm_bytes(rec)


def _mfu_rec(ts, tokens):
    return (ts, "decode", 4, 1, tokens, 0, 1, 0.01, 0.0, 0.0, 0, 0.0,
            0, 0)


def test_ledger_mfu_ewma_replay_converges():
    """A steady 10 tokens/s converges to 10 * 2 * n_params / peak, the
    idle tail decays as the gauge's, and both equal the reference's."""
    t0 = 1_000_000.0
    recs = [_mfu_rec(t0 + i, 10.0) for i in range(1, 201)]
    args = dict(n_params=10**6, peak_flops=1e9, bind_unix=t0)
    mfu = telemetry._ledger_mfu_ewma(recs, now=t0 + 200, **args)
    assert mfu == pytest.approx(10 * 2 * 10**6 / 1e9, rel=0.05)
    idle = telemetry._ledger_mfu_ewma(recs, now=t0 + 230, **args)
    assert idle == pytest.approx(mfu * math.exp(-1.0), rel=0.05)
    assert telemetry._ledger_mfu_ewma([], 1, 1.0, None, 0.0) is None
    for now in (t0 + 200, t0 + 230):
        assert telemetry._ledger_mfu_ewma(recs, now=now, **args) == \
            jtel._ledger_mfu_ewma(recs, now=now, **args)


def test_merge_steps_reports_pools_and_refinalizes():
    model = _model()
    led = StepLedger(depth=16)
    led.push("decode", 4, 4, 500, 0, 1, 1.0, 0.0, 0.0, 0, 0.0, 0, False)
    rep = roofline_report(led, model)
    merged = merge_steps_reports([rep, rep, None, {"enabled": False}])
    assert merged["enabled"] and merged["replicas_merged"] == 2
    assert merged["records_window"] == 2
    k = merged["kinds"]["decode"]
    assert k["records"] == 2 and k["tokens"] == 1000
    assert k["achieved_flops_per_s"] == pytest.approx(1e6)
    assert k["verdict"] == "compute-bound"
    assert merged["rung_occupancy"]["4"] == {"dispatches": 2,
                                             "mean_slots": 4.0}
    assert merge_steps_reports([]) == {"enabled": False}
    assert merge_steps_reports([None, {"enabled": False}]) == {
        "enabled": False}


def _random_records(n: int, t0: float, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = telemetry.STEP_KINDS[int(rng.integers(4))]
        out.append((t0 + float(rng.uniform(-90, 0)), kind,
                    0 if kind == "prefill_chunk" else int(rng.choice([4, 8])),
                    int(rng.integers(1, 9)), int(rng.integers(0, 64)),
                    int(rng.integers(0, 512)), int(rng.integers(1, 9)),
                    float(rng.uniform(1e-4, 0.1)),
                    float(rng.uniform(0, 0.02)), float(rng.uniform(0, 0.05)),
                    int(rng.integers(0, 10**5)),
                    float(rng.choice([0.0, 4096.0])),
                    int(rng.integers(0, 5)), int(rng.integers(0, 2))))
    return sorted(out)


@pytest.mark.parametrize("depth,n", [(256, 40), (16, 40)],
                         ids=["in-ring", "overflowed"])
def test_roofline_and_merge_equal_reference(depth, n):
    """Identical records, peaks and ``now`` give the reference's report
    dict and the reference's merge of two reports."""
    now = 2_000_000.0
    led, jled = StepLedger(depth), jtel.StepLedger(depth)
    for r in _random_records(n, now):
        led._ring[led._n % led.depth] = r
        led._n += 1
    jled._ring, jled._n = list(led._ring), led._n
    kw = dict(n_params=8_030_000_000, n_layers=32, n_heads=32,
              head_dim=128, weight_bytes=16_060_000_000,
              kv_token_bytes=131072, peak_flops=989.4e12,
              peak_hbm_bw=3.35e12)
    model, jmodel = StepCostModel(**kw), jtel.StepCostModel(**kw)
    args = dict(mfu_gauge=0.00123, bind_unix=now - 100, window_s=60.0,
                now=now)
    rep = roofline_report(led, model, **args)
    jrep = jtel.roofline_report(jled, jmodel, **args)
    assert rep == jrep
    assert rep["records_window"] > 0 and rep["mfu"]["agreement"] is not None
    other = roofline_report(led, model, **dict(args, mfu_gauge=None))
    jother = jtel.roofline_report(jled, jmodel, **dict(args,
                                                       mfu_gauge=None))
    assert merge_steps_reports([rep, other]) == \
        jtel.merge_steps_reports([jrep, jother])


# -------------------------------------------------- kill switch


def test_telemetry_disabled_kills_ledger(monkeypatch):
    """``enabled=False`` (and TPU_INF_TELEMETRY=0 for an engine): the
    null ledger, an empty phase snapshot, no self-metrics group, a
    disabled /debug/steps report, and serving unaffected."""
    tel = EngineTelemetry(enabled=False)
    assert tel.step_ledger is NULL_LEDGER
    tel.step_ledger.push("decode", 4, 1, 1, 0, 1, 0.01, 0.0, 0.0, 0,
                         0.0, 0, False)
    assert tel.steps_report() == {"enabled": False}
    assert tel.phase_snapshot() == {}
    assert tel.mfu_estimate() is None
    monkeypatch.setenv("TPU_INF_TELEMETRY", "0")
    eng = port_engine(**CHUNKED)
    jeng = ref_engine(**CHUNKED)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    assert eng.generate(prompts, 6) == jeng.generate(prompts, 6)
    assert eng.telemetry.step_ledger is NULL_LEDGER
    assert eng.telemetry.phase_snapshot() == jeng.telemetry.phase_snapshot()
    assert eng.telemetry.phase_snapshot() == {}
    from tpu_inference_torch.server.replicas import EngineGroup
    group = EngineGroup([eng])
    assert group.steps_snapshot() == {"replicas": {"0": {"enabled": False}},
                                      "fleet": {"enabled": False}}
    snap = group.stats_snapshot()
    assert snap["mfu_estimate"] is None and snap["phases"] == {}
    assert "tpu_inf_metrics_render_seconds" not in group.prometheus_text()


# ------------------------------------- engine ledger vs the reference


def _strip(recs) -> list:
    """Every field but ts, device_s, staging_s and bubble_s."""
    return [r[1:7] + r[10:] for r in recs]


def _prompts(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


NGRAM = dict(page_size=8, num_pages=512, max_pages_per_seq=16,
             max_batch_size=4, prefill_buckets=(16, 32, 64),
             spec_mode="ngram", num_speculative_tokens=4)
# (mode, engine config, prompts, max new tokens)
LEDGER_MODES = {
    "plain": (CHUNKED, _prompts(6, 7, 4, 60), 12),
    "ladder": (ecfg(), _prompts(12, 7, 6, 7), 16),
    "depth2": (dict(CHUNKED, decode_pipeline_depth=2),
               _prompts(6, 7, 4, 60), 12),
    "hybrid": (dict(CHUNKED, hybrid_prefill=True, decode_pipeline_depth=2,
                    step_token_budget=20), _prompts(6, 7, 4, 60), 12),
    "host-tier": (dict(page_size=8, num_pages=16, max_pages_per_seq=8,
                       max_batch_size=8, decode_ladder=(2, 4, 8),
                       prefill_buckets=(16, 32, 64), admission="optimistic",
                       optimistic_headroom_pages=1,
                       preempt_watermark_pages=4, host_cache_pages=64),
                  _prompts(12, 3, 8, 9), 16),
    "ngram": (dict(NGRAM, decode_pipeline_depth=2,
                   latency_decode_threshold=0), _prompts(6, 9, 8, 9), 32),
    "ngram-sync": (NGRAM, _prompts(4, 0, 5, 41), 32),
}


@pytest.mark.parametrize("mode", list(LEDGER_MODES))
def test_engine_ledger_matches_reference(mode):
    """The same scheduler run in both packages: the same tokens and the
    same ledger records, in order, in every field but the four walls;
    one record per prefill and decode dispatch."""
    cfg, prompts, max_new = LEDGER_MODES[mode]
    cfg = dict(cfg, step_ledger_depth=4096)
    jeng = ref_engine(**cfg)
    want, _ = sched_run(jeng, prompts, max_new, ref=True)
    eng = port_engine(**cfg)
    got, _ = sched_run(eng, prompts, max_new)
    assert got == want
    recs = eng.telemetry.step_ledger.records()
    assert _strip(recs) == _strip(jeng.telemetry.step_ledger.records())
    tel = eng.telemetry
    assert len(recs) == (tel.prefill_dispatches.value
                         + tel.decode_dispatches.value)
    kinds = {r[1] for r in recs}
    assert "prefill_chunk" in kinds
    if mode.startswith("hybrid"):
        assert "hybrid" in kinds
    if mode.startswith("ngram"):
        assert "spec_verify" in kinds and sum(r[12] for r in recs) > 0
    if mode == "host-tier":
        assert sum(r[11] for r in recs) > 0, "no swap bytes recorded"
    assert sum(r[13] for r in recs) >= 2       # first prefill and decode
    eng.check_pool_clean()


def test_chained_decode_pushes_one_record():
    """decode_steps_chained: one record for the whole run, as the
    reference's."""
    cfg = dict(CHUNKED, step_ledger_depth=64)
    eng, jeng = port_engine(**cfg), ref_engine(**cfg)
    prompts = _prompts(3, 5, 4, 20)
    from tpu_inference.engine.engine import Sequence as JSequence
    from tpu_inference_torch.engine.engine import Sequence
    for e, cls in ((eng, Sequence), (jeng, JSequence)):
        seqs = [cls(request_id=i, prompt_tokens=p, max_new_tokens=40)
                for i, p in enumerate(prompts)]
        e.prefill_many(seqs)
        e.decode_steps_chained(2)
    recs = eng.telemetry.step_ledger.records()
    assert _strip(recs) == _strip(jeng.telemetry.step_ledger.records())
    assert recs[-1][1] == "decode" and recs[-1][6] == 16


# ------------------------------------------------ HTTP observability


def _server(**server_kw):
    mcfg = tcfg.tiny_llama(vocab_size=512)
    cfg = tcfg.FrameworkConfig(
        model=mcfg,
        engine=tcfg.EngineConfig(page_size=8, num_pages=128,
                                 max_pages_per_seq=8, max_batch_size=4,
                                 prefill_buckets=(16, 32, 64)),
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte",
                                 warmup=False, **server_kw))
    srv = InferenceServer(cfg, device="cpu")
    return srv, srv.start(host="127.0.0.1", port=0)


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_debug_steps_and_profile(tmp_path):
    """/debug/steps after traffic: every record kind known, verdicts
    given, records_total equal to the dispatches, the replayed MFU within
    20% of the gauge; /debug/profile captures (CPU activities) and the
    started/stopped trace, only under profile_dir; bad bodies 400, a
    second trace 409."""
    profile_dir = str(tmp_path / "trace")
    srv, port = _server(enable_debug=True, profile_dir=profile_dir)
    try:
        for i in range(3):
            status, _ = _call(port, "POST", "/api/generate", {
                "prompt": f"roofline probe {i}", "temperature": 0,
                "max_tokens": 12, "stream": False})
            assert status == 200
            # A scrape updates the gauge's EWMA, as a collector would.
            assert _call(port, "GET", "/metrics")[0] == 200
        status, raw = _call(port, "GET", "/debug/steps")
        assert status == 200
        snap = json.loads(raw)
        rep = snap["replicas"]["0"]
        assert rep["enabled"] and rep["kinds"]
        for kind, agg in rep["kinds"].items():
            assert kind in telemetry.STEP_KINDS
            assert agg["verdict"] in ("compute-bound", "hbm-bound",
                                      "host-bound")
        assert {"prefill_chunk", "decode"} <= set(rep["kinds"])
        _, raw = _call(port, "GET", "/metrics?format=json")
        stats = json.loads(raw)
        ph = stats["phases"]
        assert rep["records_total"] == (ph["prefill_dispatch_s"]["count"]
                                        + ph["decode_dispatch_s"]["count"])
        assert stats["approx_flops_per_token"] == 2 * stats["model_params"]
        assert stats["mfu_estimate"] > 0
        mfu = rep["mfu"]
        assert mfu["gauge"] and mfu["ledger"] is not None
        assert 0.8 <= mfu["agreement"] <= 1.2, mfu
        fleet = snap["fleet"]
        assert fleet["enabled"] and fleet["replicas_merged"] == 1
        assert fleet["kinds"].keys() == rep["kinds"].keys()
        _, raw = _call(port, "GET", "/metrics")
        assert b"tpu_inf_mfu_estimate" in raw
        assert b"tpu_inf_metrics_render_seconds" in raw

        status, raw = _call(port, "POST", "/debug/profile",
                            {"seconds": 0.2, "replica": 0, "dir": "/etc"})
        assert status == 200, raw
        got = json.loads(raw)
        assert got["status"] == "captured" and got["replica"] == 0
        assert got["dir"] == os.path.join(profile_dir, "replica0")
        traces = os.listdir(got["dir"])
        assert traces and json.load(open(os.path.join(
            got["dir"], traces[0])))["traceEvents"] is not None
        for bad in ({"seconds": 0}, {"seconds": 61}, {"seconds": "x"},
                    {"seconds": 1, "replica": 3}, {"action": "bogus"}):
            assert _call(port, "POST", "/debug/profile", bad)[0] == 400
        status, raw = _call(port, "POST", "/debug/profile",
                            {"action": "start", "dir": "/etc"})
        assert status == 200 and json.loads(raw)["dir"] == profile_dir
        assert _call(port, "POST", "/debug/profile",
                     {"action": "start"})[0] == 409
        assert _call(port, "POST", "/debug/profile",
                     {"seconds": 0.1})[0] == 409
        status, raw = _call(port, "POST", "/debug/profile",
                            {"action": "stop"})
        assert status == 200 and json.loads(raw)["status"] == "stopped"
        assert any(f.endswith(".json") for f in os.listdir(profile_dir))
        assert _call(port, "POST", "/debug/profile",
                     {"action": "stop"})[0] == 409
        for path, want in (("/debug/requests", 200), ("/debug/trace", 400),
                           ("/debug/blackbox", 200)):
            status, raw = _call(port, "GET", path)
            assert status == want, path
            # Not the old "not ported" stub: its words, not the digits
            # 501, which a timeline's float may hold.
            assert b"not ported" not in raw and b"ROADMAP" not in raw
    finally:
        srv.shutdown(timeout=10)


def test_debug_disabled_by_default():
    """Without enable_debug, /debug/steps and /debug/profile are 404."""
    srv, port = _server()
    try:
        assert _call(port, "GET", "/debug/steps")[0] == 404
        assert _call(port, "POST", "/debug/profile",
                     {"action": "start"})[0] == 404
        assert _call(port, "POST", "/debug/profile",
                     {"seconds": 1})[0] == 404
        assert _call(port, "GET", "/healthz")[0] == 200
    finally:
        srv.shutdown(timeout=10)


def test_cli_step_ledger_depth_and_profile_dir(tmp_path):
    """--step-ledger-depth sizes the ring; --profile-dir reaches
    ServerConfig."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    args = p.parse_args(["--device", "cpu", "--model", "tiny-llama",
                         "--no-warmup", "--num-pages", "64",
                         "--max-batch-size", "2", "--host-cache-pages", "0",
                         "--step-ledger-depth", "40",
                         "--profile-dir", str(tmp_path)])
    srv, engine_args = boot_server(args, p)
    assert engine_args["step_ledger_depth"] == 40
    assert srv.engine.telemetry.step_ledger.depth == 40
    assert srv.cfg.server.profile_dir == str(tmp_path)
    assert build_parser().parse_args([]).step_ledger_depth == 256
