"""Port twin of engine/scheduler.py and server/replicas.py (dp=1): the
continuous-batching loop on the CPU with a tiny model — admission,
cancellation, rejection, priority order, interleaved chunked prefill —
and the replica health state machine behind /healthz. Every wait has a
timeout and every scheduler is stopped in ``finally``."""

import threading
import time

import pytest
import torch

from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler
from tpu_inference_torch.server.replicas import (EngineGroup, FleetSaturated,
                                                 FleetUnavailable,
                                                 ReplicaHealth)

TIMEOUT = 30
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(0)
    from tpu_inference_torch.models import llama
    return llama.init_params(tcfg.tiny_llama(vocab_size=256), gen, "cpu")


def _engine(params, **overrides):
    return InferenceEngine(tcfg.tiny_llama(vocab_size=256),
                           tcfg.EngineConfig(**{**ENGINE, **overrides}),
                           params=params, device="cpu")


class _Collector:
    """Token/finish callbacks for one request, with a finish event."""

    def __init__(self):
        self.tokens = []
        self.finished = threading.Event()
        self.seq = None

    def on_token(self, seq, tok):
        self.tokens.append(tok)

    def on_finish(self, seq):
        self.seq = seq
        self.finished.set()


def _submit(target, rid, prompt, max_new=6, **kw):
    c = _Collector()
    seq = Sequence(request_id=rid, prompt_tokens=list(prompt),
                   max_new_tokens=max_new, **kw)
    target.submit(seq, c.on_token, c.on_finish)
    return seq, c


def test_concurrent_requests_match_generate(params):
    """Requests served by the loop (batched prefill, chunked prefill of a
    long prompt interleaved with decode) give generate()'s tokens."""
    prompts = [[5, 6, 7], list(range(20, 32)), list(range(40, 110)),
               [1, 2]]
    want = _engine(params).generate(prompts, max_new_tokens=6)
    sched = EngineScheduler(_engine(params)).start()
    try:
        got = [_submit(sched, i, p) for i, p in enumerate(prompts)]
        for _, c in got:
            assert c.finished.wait(TIMEOUT)
    finally:
        sched.stop(timeout=TIMEOUT)
    assert [c.tokens for _, c in got] == want
    assert all(c.seq.finish_reason == "length" for _, c in got)
    assert sched.stats.requests_finished == 4
    assert sched.stats.prefills == 4
    assert sched.engine.allocator.num_free + \
        sched.engine.prefix_cache.evictable == ENGINE["num_pages"] - 1


def test_rejections_and_queued_cancel(params):
    # 7 allocatable pages: a 16-page (max per sequence) reservation
    # can never fit.
    eng = _engine(params, max_queue_len=1, num_pages=8)
    sched = EngineScheduler(eng)          # not started: requests stay queued
    seq, c = _submit(sched, 1, [1, 2, 3])
    _, full = _submit(sched, 2, [4, 5, 6])
    assert full.finished.is_set() and full.seq.finish_reason == "queue_full"
    sched.cancel(1)
    assert seq.done and seq.finish_reason == "cancelled"
    _, big = _submit(sched, 3, [7] * 10, max_new=200)
    assert big.seq.finish_reason == "too_large"
    assert sched.stats.requests_rejected == 2
    assert sched.load == 0


def test_priority_classes_jump_the_queue(params):
    sched = EngineScheduler(_engine(params))
    for rid, cls in enumerate(["batch", "background", "interactive",
                               "batch", "interactive"]):
        _submit(sched, rid, [1, 2], priority_class=cls)
    order = [p.seq.request_id for p in sched._waiting]
    assert order == [2, 4, 0, 3, 1]


def test_running_request_cancel_and_shutdown(params):
    sched = EngineScheduler(_engine(params)).start()
    try:
        seq, c = _submit(sched, 1, [3, 4, 5], max_new=200)
        deadline = time.monotonic() + TIMEOUT
        while not c.tokens and time.monotonic() < deadline:
            time.sleep(0.005)
        sched.cancel(1)
        assert c.finished.wait(TIMEOUT)
        assert c.seq.finish_reason == "cancelled"
        seq2, c2 = _submit(sched, 2, [3, 4, 5], max_new=200)
    finally:
        sched.stop(drain=False, timeout=TIMEOUT)
    assert c2.finished.wait(TIMEOUT)
    assert c2.seq.finish_reason in ("shutdown", "length")
    assert all(s is None for s in sched.engine.slots)


def test_failed_step_finishes_the_request_with_error(params, monkeypatch):
    eng = _engine(params)

    def boom(seqs):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(eng, "prefill_many", boom)
    errors = []
    sched = EngineScheduler(eng)
    sched.on_step_error = errors.append
    sched.start()
    try:
        _, c = _submit(sched, 1, [1, 2, 3])
        assert c.finished.wait(TIMEOUT)
    finally:
        sched.stop(timeout=TIMEOUT)
    assert c.seq.finish_reason == "error" and c.tokens == []
    assert sched.stats.step_failures == 1 and len(errors) == 1


def test_health_state_machine():
    h = ReplicaHealth(tcfg.ServerConfig(quarantine_after_failures=2,
                                        quarantine_cooldown_s=0.0))
    h.on_error()
    assert h.state == "degraded"
    h.on_ok()
    assert h.state == "healthy"
    h.on_error()
    h.on_error()
    assert h.state == "quarantined" and h.quarantines == 1
    assert h.routable and h.state == "recovered"      # cooldown 0
    h.on_error()                                       # probation fails
    assert h.state == "quarantined" and h.quarantines == 2


def test_engine_group_admission_cap_and_quarantine(params):
    group = EngineGroup([_engine(params)], tcfg.ServerConfig(
        admission_queue_depth=1, quarantine_cooldown_s=60.0))
    _submit(group, 1, [1, 2, 3])
    with pytest.raises(FleetSaturated):
        _submit(group, 2, [1, 2, 3])
    group.cancel(1)
    for _ in range(3):
        group.health[0].on_error()
    with pytest.raises(FleetUnavailable):
        _submit(group, 3, [1, 2, 3])
    snap = group.health_snapshot()
    assert snap["status"] == "unavailable"
    sup = snap["supervision"]
    assert {k: sup[k] for k in ("requests_shed", "requests_unavailable",
                                "states")} == {"requests_shed": 1,
                                               "requests_unavailable": 1,
                                               "states": ["quarantined"]}
    assert "tpu_inf_requests_shed_total 1" in group.prometheus_text()
    with pytest.raises(ValueError, match="at least one engine"):
        EngineGroup([])
