"""The port's fault injection and step watchdog against the reference's
(tests/test_failover.py cases at dp=1, port beside reference): the chaos
gate at every dispatch entry where the reference runs it, page pressure
(held real pages, armed from another thread, applied on the engine
thread), ``EngineGroup.apply_chaos``, the scheduler's failure path with
dispatch-ahead verify rounds in flight (requests fail with an error
record, health degrades then quarantines, recovers after the cooldown,
the next requests give the tokens of before the fault, the pool is
clean), the step watchdog at dp=1 (a wedged dispatch trips it: 503 with
Retry-After, /healthz unavailable, the wedge counted), ``POST
/debug/chaos``, the HTTP chaos gate, and the CLI's flags. Every wait has
a timeout and every server or scheduler is stopped in ``finally``."""

import json
import time

import pytest

from tests.test_torch_ladder import VOCAB, port_engine, ref_engine
from tests.test_torch_scheduler import _submit
from tests.test_torch_server import TIMEOUT, _get, _post
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import ChaosStepError as JChaosStepError
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.server.http import build_engine_group
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import ChaosStepError, Sequence
from tpu_inference_torch.server.http import InferenceServer
from tpu_inference_torch.server.replicas import (DEGRADED, HEALTHY,
                                                 QUARANTINED, EngineGroup)

ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)


def _wait(pred, timeout=TIMEOUT, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(f"{what} never held")


# ------------------------------------------------------------ the gate

def _entry(eng, seq_cls, entry):
    """Drive one dispatch entry with failure rate 1.0; the prompt of the
    chunked entries spans two 16-token chunks."""
    long = entry in ("prefill_step", "hybrid_step_pipelined")
    seq = seq_cls(request_id=0, prompt_tokens=list(range(1, 30 if long
                                                         else 9)),
                  max_new_tokens=8)
    if entry == "prefill_many":
        eng.chaos_step_failure_rate = 1.0
        return lambda: eng.prefill_many([seq])
    if long:
        eng.prefill_begin(seq)
        eng.chaos_step_failure_rate = 1.0
        if entry == "prefill_step":
            return lambda: eng.prefill_step(seq)
        return lambda: eng.hybrid_step_pipelined(seq)
    eng.prefill(seq)
    eng.chaos_step_failure_rate = 1.0
    return getattr(eng, entry)


@pytest.mark.parametrize("entry", ["prefill_many", "prefill_step",
                                   "decode_steps", "decode_steps_pipelined",
                                   "hybrid_step_pipelined"])
def test_chaos_gate_at_every_dispatch_entry(entry):
    """Each entry where the reference runs _chaos_step_gate raises the
    injected error in both packages, and nothing was dispatched."""
    cfg = dict(ENGINE, decode_pipeline_depth=2, chunked_prefill_size=16,
               hybrid_prefill=True)
    for eng, seq_cls, err in ((port_engine(**cfg), Sequence,
                               ChaosStepError),
                              (ref_engine(**cfg), JSequence,
                               JChaosStepError)):
        fn = _entry(eng, seq_cls, entry)
        with pytest.raises(err, match="chaos: injected engine step"):
            fn()
    assert not eng.pipeline_pending


def test_wedge_sleeps_before_the_failure_roll():
    eng = port_engine(**ENGINE)
    eng.prefill(Sequence(request_id=0, prompt_tokens=[1, 2, 3],
                         max_new_tokens=4))
    eng.chaos_step_wedge_s, eng.chaos_step_failure_rate = 0.1, 1.0
    t0 = time.monotonic()
    with pytest.raises(ChaosStepError):
        eng.decode_steps()
    assert time.monotonic() - t0 >= 0.1
    eng.chaos_step_wedge_s = eng.chaos_step_failure_rate = 0.0
    assert eng.decode_steps()


def test_page_pressure_matches_reference():
    """Boot-time pressure holds real pages; arming clamps to the free
    list; a cross-thread request applies only on the engine thread's
    call; the leak check disarms it."""
    cfg = dict(ENGINE, chaos_page_pressure=5)
    t, j = port_engine(**cfg), ref_engine(**cfg)
    for eng in (t, j):
        assert eng.chaos_page_pressure == 5
        assert eng.allocator.num_free == 63 - 5
        assert eng.set_page_pressure(1000) == 63
        assert eng.allocator.num_free == 0
        assert eng.request_page_pressure(7) == 7
        assert eng.allocator.num_free == 0         # not applied yet
        eng.apply_pending_page_pressure()
        assert eng.chaos_page_pressure == 7
        assert eng.allocator.num_free == 63 - 7
    t.check_pool_clean()
    assert t.chaos_page_pressure == 0 and t.allocator.num_free == 63


@pytest.mark.parametrize("body", [
    {"replica": 0, "step_failure_rate": 0.5, "step_wedge_s": 0.1},
    {"replica": None, "step_failure_rate": 0.0, "page_pressure": 3},
    {"page_pressure": 0},
    {"replica": 7}, {"replica": 0, "kill": "kill9"},
    {"replica": "x"}, {"step_failure_rate": "nope"},
])
def test_apply_chaos_matches_reference(body):
    """EngineGroup.apply_chaos: the settings in effect, or the same kind
    of error (HTTP 400), as the reference's in-process group."""
    jgroup = build_engine_group(jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(vocab_size=VOCAB),
        engine=jcfg.EngineConfig(**ENGINE),
        server=jcfg.ServerConfig(tokenizer="byte")))
    tgroup = EngineGroup([port_engine(**ENGINE)], tcfg.ServerConfig())
    out = []
    for group in (tgroup, jgroup):
        try:
            out.append(group.apply_chaos(dict(body)))
        except (IndexError, TypeError, ValueError, KeyError) as e:
            out.append(type(e).__name__)
    assert out[0] == out[1]


# ---------------------------------------------- failure path, recovery

def _run_requests(group, prompts, max_new=12, base_id=0):
    cols = [_submit(group, base_id + i, p, max_new)[1]
            for i, p in enumerate(prompts)]
    for c in cols:
        assert c.finished.wait(TIMEOUT), "request hung"
    return cols


def test_chaos_with_spec_calls_in_flight_then_recovery():
    """n-gram speculation at pipeline depth 2 with verify rounds in
    flight: arming step_failure_rate 1.0 through apply_chaos fails the
    running requests with an error record, health goes degraded then
    quarantined; after disarming and the cooldown health recovers, the
    next requests finish "length" with the tokens of before the fault,
    and the pool is clean."""
    prompts = [[5, 9, 2, 7, 1, 8] * 3, [3, 1, 4, 1, 5, 9, 2, 6],
               [2, 7, 1, 8, 2, 8]]
    eng = port_engine(**dict(ENGINE, max_pages_per_seq=16),
                      spec_mode="ngram", num_speculative_tokens=4,
                      decode_pipeline_depth=2, latency_decode_threshold=0)
    group = EngineGroup([eng], tcfg.ServerConfig(
        quarantine_after_failures=2, quarantine_cooldown_s=0.3))
    group.start()
    try:
        before = [c.tokens for c in _run_requests(group, prompts, 24)]
        assert eng.spec_rounds_total > 0
        # Long requests; arm once they stream (calls in flight).
        cols = [_submit(group, 10 + i, p, 200)[1]
                for i, p in enumerate(prompts)]
        _wait(lambda: all(c.tokens for c in cols), what="streaming")
        group.apply_chaos({"replica": 0, "step_failure_rate": 1.0})
        for c in cols:
            assert c.finished.wait(TIMEOUT)
            assert c.seq.finish_reason == "error"
        assert group.health[0].state in (DEGRADED, QUARANTINED)
        if group.health[0].state != QUARANTINED:
            # A further request fails at its prefill: quarantined.
            c = _submit(group, 20, [1, 2, 3], 4)[1]
            assert c.finished.wait(TIMEOUT)
            assert c.seq.finish_reason == "error"
        assert group.health[0].state == QUARANTINED
        assert group.health_snapshot()["status"] == "unavailable"
        group.apply_chaos({"replica": None, "step_failure_rate": 0.0})
        time.sleep(0.35)
        assert group.health_snapshot()["status"] != "unavailable"
        after = [c.tokens for c in _run_requests(group, prompts, 24, 30)]
        assert after == before
        assert group.health[0].state == HEALTHY
        assert group.schedulers[0].stats.step_failures >= 2
    finally:
        group.stop(drain=True, timeout=TIMEOUT)
    eng.check_pool_clean()


def test_page_pressure_from_another_thread_then_returned():
    """page_pressure armed through apply_chaos holds real pages once the
    engine loop applies it; disarmed, the pages return."""
    eng = port_engine(**ENGINE)
    group = EngineGroup([eng], tcfg.ServerConfig())
    group.start()
    try:
        free = eng.allocator.num_free
        assert group.apply_chaos({"page_pressure": 9})["replicas"][0][
            "page_pressure"] == 9
        _wait(lambda: eng.allocator.num_free == free - 9, what="pressure")
        # Requests still run in what is left.
        assert all(c.seq.finish_reason == "length"
                   for c in _run_requests(group, [[1, 2, 3]], 6))
        group.apply_chaos({"page_pressure": 0})
        _wait(lambda: eng.chaos_page_pressure == 0, what="disarm")
    finally:
        group.stop(drain=True, timeout=TIMEOUT)
    eng.check_pool_clean()


# ------------------------------------------------------- step watchdog

def _server(**server_kw) -> InferenceServer:
    cfg = tcfg.FrameworkConfig(
        model=tcfg.tiny_llama(vocab_size=512),
        engine=tcfg.EngineConfig(**ENGINE),
        server=tcfg.ServerConfig(model_name="t", tokenizer="byte",
                                 **server_kw))
    return InferenceServer(cfg, device="cpu")


def test_watchdog_trips_on_a_wedged_dispatch_at_dp1():
    """A dispatch that hangs past step_watchdog_s quarantines the only
    replica; its request gets a retryable 503 at once, /healthz turns 503
    "unavailable" with the wedge counted, and new work is shed."""
    srv = _server(step_watchdog_s=0.15, quarantine_cooldown_s=3600.0,
                  retry_after_s=1.0)
    srv.engine.chaos_step_wedge_s = 2.0
    port = srv.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _get(port, "/healthz")
        assert status == 200
        t0 = time.monotonic()
        status, headers, raw = _post(port, {"prompt": "wedge me",
                                            "stream": False,
                                            "max_tokens": 4})
        assert status == 503 and "Retry-After" in headers
        assert b"replica failure" in raw
        assert time.monotonic() - t0 < 1.5      # before the wedge ends
        status, headers, raw = _get(port, "/healthz")
        body = json.loads(raw)
        assert status == 503 and body["status"] == "unavailable"
        assert body["replicas"][0]["state"] == QUARANTINED
        assert body["replicas"][0]["wedges"] >= 1
        status, headers, _ = _post(port, {"prompt": "nope",
                                          "stream": False,
                                          "max_tokens": 2})
        assert status == 503 and "Retry-After" in headers
        _, _, raw = _get(port, "/metrics")
        text = raw.decode()
        assert 'tpu_inf_replica_wedges_total{replica="0"} 1' in text
        assert srv.group.requests_unavailable >= 1
    finally:
        srv.engine.chaos_step_wedge_s = 0.0
        srv.shutdown(timeout=5.0)


def test_watchdog_off_by_default_and_interval():
    srv = _server()
    group = srv.group
    assert group.server_cfg.step_watchdog_s == 0.0
    assert not group._wedged(group.schedulers[0])
    group.schedulers[0].step_inflight_since = time.monotonic() - 100
    assert not group._wedged(group.schedulers[0])
    group.server_cfg = tcfg.ServerConfig(step_watchdog_s=0.5)
    assert group._wedged(group.schedulers[0])
    assert group._watch_interval() == pytest.approx(0.1)


# ------------------------------------------------------------ HTTP layer

def test_debug_chaos_endpoint_arms_engine_faults():
    srv = _server(enable_debug=True)
    port = srv.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _post(port, {"replica": 0, "step_failure_rate": 0.5,
                                      "step_wedge_s": 0.1}, "/debug/chaos")
        assert status == 200
        assert json.loads(raw)["replicas"][0] == {
            "step_failure_rate": 0.5, "step_wedge_s": 0.1,
            "page_pressure": 0}
        assert srv.engine.chaos_step_failure_rate == 0.5
        free = srv.engine.allocator.num_free
        status, _, raw = _post(port, {"replica": 0, "page_pressure": 5},
                               "/debug/chaos")
        assert json.loads(raw)["replicas"][0]["page_pressure"] == 5
        _wait(lambda: srv.engine.allocator.num_free == free - 5,
              what="pressure")
        _post(port, {"replica": 0, "page_pressure": 0}, "/debug/chaos")
        _wait(lambda: srv.engine.allocator.num_free == free, what="disarm")
        status, _, _ = _post(port, {"replica": None, "step_failure_rate": 0.0,
                                    "step_wedge_s": 0.0}, "/debug/chaos")
        assert status == 200 and srv.engine.chaos_step_failure_rate == 0.0
        assert _post(port, {"replica": 7}, "/debug/chaos")[0] == 400
        assert _post(port, {"kill": "kill9"}, "/debug/chaos")[0] == 400
        status, _, raw = _get(port, "/debug/requests")
        assert status == 200 and isinstance(json.loads(raw), list)
    finally:
        srv.shutdown(timeout=5.0)


def test_debug_routes_need_enable_debug():
    srv = _server()
    port = srv.start(host="127.0.0.1", port=0)
    try:
        assert _post(port, {"replica": 0}, "/debug/chaos")[0] == 404
        assert _get(port, "/debug/requests")[0] == 404
    finally:
        srv.shutdown(timeout=5.0)


@pytest.mark.parametrize("server_kw,status", [
    ({"chaos_failure_rate": 1.0}, 503),
    ({"chaos_delay_s": 0.05}, 200),
    ({"chaos_failure_rate": 1.0, "chaos_delay_s": 0.05}, 503)])
def test_http_chaos_gate(server_kw, status):
    srv = _server(**server_kw)
    port = srv.start(host="127.0.0.1", port=0)
    try:
        got, _, raw = _post(port, {"prompt": "hi", "stream": False,
                                   "max_tokens": 3})
        assert got == status
        if status == 503:
            assert b"chaos: injected failure" in raw
    finally:
        srv.shutdown(timeout=5.0)


def test_cli_chaos_and_watchdog_flags():
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    resolve_engine_args)
    p = build_parser()
    args = p.parse_args([
        "--chaos-page-pressure", "3", "--chaos-step-failure-rate", "0.25",
        "--chaos-step-wedge-s", "0.5", "--chaos-failure-rate", "0.1",
        "--chaos-delay-s", "0.2", "--step-watchdog-s", "2", "--debug",
        "--host-cache-pages", "0"])
    ea = resolve_engine_args(args, p)
    assert (ea["chaos_page_pressure"], ea["chaos_step_failure_rate"],
            ea["chaos_step_wedge_s"]) == (3, 0.25, 0.5)
    assert (args.chaos_failure_rate, args.chaos_delay_s,
            args.step_watchdog_s, args.debug) == (0.1, 0.2, 2.0, True)
    d = p.parse_args([])
    assert (d.chaos_page_pressure, d.chaos_step_failure_rate,
            d.chaos_step_wedge_s, d.chaos_failure_rate, d.chaos_delay_s,
            d.step_watchdog_s, d.debug) == (0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                            False)
