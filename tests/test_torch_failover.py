"""The port's in-process EngineGroup at dp=2 against the reference's
(tests/test_failover.py's dp > 1 cases, port beside reference): two
float32 tiny-llama replicas each side on the same weights, every
scenario run through both groups. Routed replica per conversation turn,
greedy tokens, failover with identical tokens, health transitions and
the supervision counters must agree; route-stat keys, supervision keys
and the stats aggregation have one shape.
"""

import threading
import time

import pytest

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.server import replicas as jrep
from tests._leak import assert_pool_clean
from tests.test_torch_ladder import pair
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.server import replicas as trep

ENGINE_KW = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                 max_batch_size=2, prefill_buckets=(16,))


def _group(impl: str, dp: int = 2, **server_kw):
    jm, params, tm, tp = pair()
    if impl == "ref":
        engines = [JEngine(jm, jcfg.EngineConfig(**ENGINE_KW),
                           params=params, attn_backend="dense")
                   for _ in range(dp)]
        return jrep.EngineGroup(engines, jcfg.ServerConfig(**server_kw))
    engines = [InferenceEngine(tm, tcfg.EngineConfig(**ENGINE_KW),
                               params=tp, attn_backend="kernel",
                               device="cpu")
               for _ in range(dp)]
    return trep.EngineGroup(engines, tcfg.ServerConfig(**server_kw))


def _seq_cls(impl):
    return JSequence if impl == "ref" else Sequence


def _submit_and_wait(group, impl, rid, prompt, max_new, timeout=60.0):
    tokens, done, box = [], threading.Event(), {}
    seq = _seq_cls(impl)(request_id=rid, prompt_tokens=list(prompt),
                         max_new_tokens=max_new)
    group.submit(seq, lambda s, t: tokens.append(t),
                 lambda s: (box.setdefault("seq", s), done.set()))
    assert done.wait(timeout), "request did not finish"
    return tokens, box["seq"]


def _occupy(impl, sched, rid, max_new=64):
    """Pin load on one scheduler so the next request routes elsewhere."""
    got_token, done = threading.Event(), threading.Event()
    seq = _seq_cls(impl)(request_id=rid, prompt_tokens=[5, 6, 7],
                         max_new_tokens=max_new)
    sched.submit(seq, lambda s, t: got_token.set(), lambda s: done.set())
    assert got_token.wait(30), "busy request produced no token"
    return done


def _both(scenario, **server_kw):
    """Run ``scenario(group, impl)`` through the port's and the
    reference's group; returns (port result, reference result)."""
    out = {}
    for impl in ("port", "ref"):
        group = _group(impl, **server_kw).start()
        try:
            out[impl] = scenario(group, impl)
        finally:
            for e in group.engines:
                e.chaos_step_failure_rate = 0.0
                e.chaos_step_wedge_s = 0.0
            group.stop(drain=False, timeout=5.0)
    return out["port"], out["ref"]


# ---------------------------------------------------------------- unit


def test_health_state_machine():
    """healthy -> degraded -> quarantined -> recovered -> healthy, a
    late success does not beat the cooldown, probation failure goes
    straight back (tests/test_failover.py's case)."""
    h = trep.ReplicaHealth(tcfg.ServerConfig(quarantine_after_failures=3,
                                             quarantine_cooldown_s=0.05))
    assert h.state == trep.HEALTHY and h.routable
    h.on_error()
    assert h.state == trep.DEGRADED and h.routable
    h.on_ok()
    assert h.state == trep.HEALTHY and h.consecutive_failures == 0
    for _ in range(3):
        h.on_error()
    assert h.state == trep.QUARANTINED and not h.routable
    h.on_ok()
    assert h.state == trep.QUARANTINED
    time.sleep(0.06)
    h.maybe_recover()
    assert h.state == trep.RECOVERED and h.routable
    h.on_error()
    assert h.state == trep.QUARANTINED and h.quarantines == 2


def test_aggregate_replica_stats_equals_reference():
    """THE aggregation rule on the same per-replica dicts."""
    per = [{"steps": 3, "tokens_generated": 40, "pool_pressure": 0.5,
            "mean_batch_occupancy": 1.5, "decode_rung": 2, "rung_peak": 2,
            "lane_occupancy": 0.5, "mfu_estimate": 1e-4,
            "decode_call_s": {"p50": 0.1, "p99": 0.3},
            "prefix_cache": {"entries": 2, "evictable": 1},
            "hybrid_prefill": False, "role": "mixed", "attn_backend": "x",
            "health": {"state": "healthy"}},
           {"steps": 5, "tokens_generated": 60, "pool_pressure": 0.25,
            "mean_batch_occupancy": 0.5, "decode_rung": 4, "rung_peak": 4,
            "lane_occupancy": 0.25, "mfu_estimate": 3e-4,
            "decode_call_s": {"p50": 0.2, "p99": 0.1},
            "prefix_cache": {"entries": 1, "evictable": 0},
            "hybrid_prefill": True, "role": "mixed", "attn_backend": "x",
            "health": {"state": "degraded"}}]
    sup = {"retries_attempted": 1}
    got = trep.aggregate_replica_stats([dict(d) for d in per], sup)
    want = jrep.aggregate_replica_stats([dict(d) for d in per], sup)
    assert got == want
    one = trep.aggregate_replica_stats([dict(per[0])], sup)
    assert one == jrep.aggregate_replica_stats([dict(per[0])], sup)


def test_routing_score_equals_reference():
    from tpu_inference.server import kv_fabric
    for kw in (dict(prompt_pages=4, hbm=2, host=1, load=3, pressured=False),
               dict(prompt_pages=9, hbm=0, host=5, load=0, pressured=True)):
        for hw in (1.0, 8.0):
            got = trep.prefill_route_score(
                tcfg.ServerConfig(route_hit_weight=hw), **kw)
            want = kv_fabric.prefill_route_score(
                jcfg.ServerConfig(route_hit_weight=hw), fabric=0, **kw)
            assert got == want
    assert trep.cold_route_key(True, 2) == kv_fabric.cold_route_key(True, 2)


# ------------------------------------------------- failover scenarios


def test_step_failure_quarantines_and_fails_over():
    """dp=2, replica 1 failing every dispatch: quarantined, the request
    resubmitted to replica 0 with the tokens of a no-fault run, in both
    groups and equal between them."""

    def scenario(group, impl):
        probe = [1, 2, 3, 4]
        baseline, _ = _submit_and_wait(group, impl, 100, probe, 8)
        busy = _occupy(impl, group.schedulers[0], 101)
        group.engines[1].chaos_step_failure_rate = 1.0
        tokens, fseq = _submit_and_wait(group, impl, 102, probe, 8)
        assert tokens == baseline and fseq.attempt >= 1
        marked = [t for t in group.recent_snapshot(50)
                  if t["request_id"] == 102]
        assert marked and any(t["attempt"] >= 1 for t in marked)
        busy.wait(30)
        snap = group.health_snapshot()
        sup = snap["supervision"]
        stats = group.stats_snapshot()
        group.stop(drain=True, timeout=10.0)
        for sched in group.schedulers:
            sched.engine.drain_pipeline()
            assert_pool_clean(sched.engine)
        return (tokens, fseq.finish_reason, snap["status"],
                [r["state"] for r in snap["replicas"]],
                sup["retries_attempted"], sup["retries_succeeded"],
                stats["replicas"][1]["health"]["state"], stats["dp"])

    got, want = _both(scenario, quarantine_after_failures=1,
                      failover_max_retries=1, quarantine_cooldown_s=3600.0)
    assert got == want
    assert got[2] == "degraded" and got[3][1] == "quarantined"


def test_wedged_step_watchdog_failover():
    """A hanging dispatch trips the watchdog: replica 1 quarantined
    mid-flight, its stranded request resubmitted to replica 0."""

    def scenario(group, impl):
        group.warmup()
        probe = [9, 2, 4, 8]
        baseline, _ = _submit_and_wait(group, impl, 200, probe, 6)
        busy = _occupy(impl, group.schedulers[0], 201)
        group.engines[1].chaos_step_wedge_s = 0.8
        tokens, fseq = _submit_and_wait(group, impl, 202, probe, 6)
        assert tokens == baseline
        busy.wait(30)
        return (tokens, fseq.finish_reason, group.health[1].state,
                group.health[1].snapshot()["wedges"] >= 1,
                group.supervision_counters()["failovers"] >= 1)

    got, want = _both(scenario, step_watchdog_s=0.15,
                      quarantine_after_failures=3, failover_max_retries=1,
                      quarantine_cooldown_s=3600.0)
    assert got == want
    assert got[2] == "quarantined" and got[3] and got[4]


def test_streamed_request_fails_cleanly_not_regenerated():
    """A request that already streamed tokens is not re-generated when
    its replica fails mid-stream: it finishes "error"."""

    def scenario(group, impl):
        busy = _occupy(impl, group.schedulers[0], 301)
        got_token, done, box = threading.Event(), threading.Event(), {}

        def on_token(s, t):
            group.engines[1].chaos_step_failure_rate = 1.0
            got_token.set()

        group.submit(_seq_cls(impl)(request_id=302, prompt_tokens=[3, 1, 4],
                                    max_new_tokens=32), on_token,
                     lambda s: (box.setdefault("seq", s), done.set()))
        assert done.wait(60) and got_token.is_set()
        busy.wait(30)
        return (box["seq"].finish_reason,
                group.supervision_counters()["retries_attempted"])

    got, want = _both(scenario, quarantine_after_failures=1,
                      failover_max_retries=1, quarantine_cooldown_s=3600.0)
    assert got == want == ("error", 0)


def test_prefix_affinity_routes_conversations_to_warm_replica():
    """Cold conversations spread by the rotating tie-break; returning
    turns land on their warm replica, with the same routed replica,
    hit pages and tokens per turn as the reference."""

    def scenario(group, impl):
        t1a, t1b = list(range(10, 24)), list(range(100, 114))
        rep_a, sa = _submit_and_wait(group, impl, 400, t1a, 6)
        rep_b, sb = _submit_and_wait(group, impl, 401, t1b, 6)
        rep2a, fa = _submit_and_wait(group, impl, 402,
                                     t1a + rep_a + [7, 7], 4)
        rep2b, fb = _submit_and_wait(group, impl, 403,
                                     t1b + rep_b + [7, 7], 4)
        turns = [(s.routed_replica, s.route_hit_pages, toks)
                 for s, toks in ((sa, rep_a), (sb, rep_b), (fa, rep2a),
                                 (fb, rep2b))]
        snap = group.health_snapshot()
        routing = [r["routing"] for r in snap["replicas"]]
        spans = [(t["routed_replica"], t["route_hit_pages"])
                 for t in group.recent_snapshot(10)]
        return (turns, routing, snap["routing"], group.route_prefix_hits,
                group.route_cold, sorted(spans))

    got, want = _both(scenario)
    assert got == want
    turns = got[0]
    assert {turns[0][0], turns[1][0]} == {0, 1}
    assert turns[2][0] == turns[0][0] and turns[2][1] >= 2
    assert turns[3][0] == turns[1][0]


def test_prefix_affinity_failover_mid_conversation():
    """The warm replica dies mid-conversation: the turn fails over to
    the cold sibling with identical greedy tokens, and the quarantined
    replica gets no more traffic."""

    def scenario(group, impl):
        t1 = list(range(30, 44))
        rep1, s1 = _submit_and_wait(group, impl, 500, t1, 6)
        warm = s1.routed_replica
        h2 = t1 + rep1 + [7, 7]
        rep2, s2 = _submit_and_wait(group, impl, 501, h2, 4)
        h3 = h2 + rep2 + [7, 7]
        expect3, s3a = _submit_and_wait(group, impl, 502, h3, 2)
        group.engines[warm].chaos_step_failure_rate = 1.0
        rep3, s3 = _submit_and_wait(group, impl, 503, h3, 2)
        rep4, s4 = _submit_and_wait(group, impl, 504, h3, 2)
        assert rep3 == expect3 == rep4
        return (warm, s2.routed_replica, s3a.routed_replica,
                s3.routed_replica, s3.attempt, s4.routed_replica,
                rep1, rep2, rep3, group.health[warm].state,
                group.supervision_counters()["retries_succeeded"])

    got, want = _both(scenario, quarantine_after_failures=1,
                      failover_max_retries=1, quarantine_cooldown_s=3600.0)
    assert got == want
    warm = got[0]
    assert got[1:4] == (warm, warm, 1 - warm) and got[4] >= 1
    assert got[5] == 1 - warm and got[9] == "quarantined"


@pytest.mark.parametrize("hit_weight,expect_warm", [(1.0, False),
                                                    (8.0, True)])
def test_pressured_warm_replica_vs_cold_idle(hit_weight, expect_warm):
    """At the default hit weight a warm replica under pool pressure
    loses to a cold idle one; a high --route-hit-weight buys it back."""

    def scenario(group, impl):
        t1 = list(range(50, 64))
        rep1, s1 = _submit_and_wait(group, impl, 600, t1, 6)
        warm = s1.routed_replica
        eng = group.engines[warm]
        target_free = max(0, 3 - eng.prefix_cache.evictable)
        eng.request_page_pressure(eng.allocator.num_free - target_free)
        deadline = time.monotonic() + 5
        while not eng.under_pressure and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.under_pressure
        rep2, s2 = _submit_and_wait(group, impl, 601, t1 + rep1 + [7, 7], 2)
        return (s2.routed_replica == warm, s2.finish_reason, rep1, rep2)

    got, want = _both(scenario, route_hit_weight=hit_weight)
    assert got == want
    assert got[0] is expect_warm


def test_poison_request_after_distinct_replicas():
    """A request whose attempts error on poison_max_workers distinct
    replicas finishes "poison" and is counted, as in the reference."""

    def scenario(group, impl):
        for e in group.engines:
            e.chaos_step_failure_rate = 1.0
        _, fseq = _submit_and_wait(group, impl, 700, [4, 4, 4], 4)
        sup = group.supervision_counters()
        return (fseq.finish_reason, sup["poison_requests"],
                sup["retries_attempted"])

    got, want = _both(scenario, quarantine_after_failures=5,
                      failover_max_retries=3, poison_max_workers=2)
    assert got == want
    assert got[0] == "poison" and got[1] == 1


def test_admission_cap_sheds_at_dp2():
    """Both replicas at the cap: FleetSaturated, counted; once they are
    free the next request is served. The groups start only after the
    queued requests that hold the cap are cancelled, so nothing races
    the check."""
    out = {}
    for impl in ("port", "ref"):
        group = _group(impl, admission_queue_depth=1)
        shed = (trep.FleetSaturated if impl == "port"
                else jrep.FleetSaturated)
        for i, s in enumerate(group.schedulers):
            s.submit(_seq_cls(impl)(request_id=800 + i,
                                    prompt_tokens=[5, 6, 7],
                                    max_new_tokens=4),
                     lambda sq, t: None, lambda sq: None)
        with pytest.raises(shed):
            group.submit(_seq_cls(impl)(request_id=810,
                                        prompt_tokens=[1, 2, 3],
                                        max_new_tokens=2),
                         lambda s, t: None, lambda s: None)
        for i, s in enumerate(group.schedulers):
            s.cancel(800 + i)
        group.start()
        try:
            toks, fseq = _submit_and_wait(group, impl, 811, [1, 2, 3], 3)
            out[impl] = (group.requests_shed, fseq.finish_reason, toks)
        finally:
            group.stop(drain=False, timeout=5.0)
    assert out["port"] == out["ref"] and out["port"][0] == 1


def test_route_stat_and_supervision_shapes_match_reference():
    """Per-replica route stats have the reference's keys; every
    supervision key the port reports is the reference's (its KV-fabric
    keys wait for ROADMAP 1.15b)."""
    port, ref = _group("port"), _group("ref")
    hp, hr = port.health_snapshot(), ref.health_snapshot()
    assert [set(r["routing"]) for r in hp["replicas"]] == \
        [set(r["routing"]) for r in hr["replicas"]]
    fabric = {"route_fabric_hits", "fabric_puts", "fabric_hits"}
    assert set(hp["supervision"]) == set(hr["supervision"]) - fabric
    for rp, rr in zip(hp["replicas"], hr["replicas"]):
        assert set(rp) - {"device"} <= set(rr), set(rp) - set(rr)
