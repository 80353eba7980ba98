"""The port's dispatch-ahead pipeline and hybrid prefill-decode steps
against the reference's (tests/test_hybrid.py and tests/test_pipeline.py
cases, port beside reference): depth 1 and 2, hybrid off and on, and the
step token budget give the reference's greedy tokens; mid-prefill cancel
and preemption, drain on shutdown, liveness under pressure, the
chunk-only call, a failing drain, and the chunk-cap arithmetic behave as
the reference's; the pool is clean after every mix."""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_ladder import (VOCAB, port_engine, ref_engine,
                                     sched_run)
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler

BASE = dict(page_size=8, num_pages=128, max_pages_per_seq=16,
            max_batch_size=4, prefill_buckets=(16, 32),
            chunked_prefill_size=16, enable_prefix_cache=False)


def _mixed_prompts():
    rng = np.random.default_rng(21)
    return (rng.integers(0, VOCAB, size=6).tolist(),
            rng.integers(0, VOCAB, size=90).tolist())   # 6 chunks of 16


def _submit(sched, seqs):
    events = {s.request_id: [] for s in seqs}
    done = {s.request_id: threading.Event() for s in seqs}
    for s in seqs:
        sched.submit(s, lambda sq, t: events[sq.request_id].append(t),
                     lambda sq: done[sq.request_id].set())
    return events, done


@pytest.mark.parametrize("depth,budget", [(1, 0), (2, 0), (1, 24), (2, 24)],
                         ids=["sync", "dispatch-ahead", "token-budget",
                              "dispatch-ahead-budget"])
def test_hybrid_byte_equality_mixed_arrivals(depth, budget):
    """A short and a long prompt through hybrid steps: the tokens of
    each alone on the serial reference, and hybrid steps really ran."""
    short, long = _mixed_prompts()
    ref = ref_engine(**BASE)
    want_short = ref.generate([short], max_new_tokens=20)[0]
    want_long = ref.generate([long], max_new_tokens=8)[0]
    eng = port_engine(**BASE, hybrid_prefill=True,
                      decode_pipeline_depth=depth, step_token_budget=budget)
    sched = EngineScheduler(eng).start()
    try:
        s1 = Sequence(request_id=1, prompt_tokens=short, max_new_tokens=20)
        s2 = Sequence(request_id=2, prompt_tokens=long, max_new_tokens=8)
        events, done = _submit(sched, [s1, s2])
        for ev in done.values():
            assert ev.wait(120)
    finally:
        sched.stop(drain=False)
    assert events[1] == want_short and events[2] == want_long
    assert s2.finish_reason == "length"
    assert eng.hybrid_steps_total > 0
    eng.check_pool_clean()


@pytest.mark.parametrize("mode", [
    {"hybrid_prefill": False},
    {"hybrid_prefill": True},
    {"decode_pipeline_depth": 2},
    {"decode_pipeline_depth": 2, "hybrid_prefill": True},
    {"decode_pipeline_depth": 3, "hybrid_prefill": True,
     "step_token_budget": 20},
], ids=["serial", "hybrid", "depth2", "depth2-hybrid",
        "depth3-hybrid-budget"])
def test_scheduler_tokens_match_reference(mode):
    """The same mixed workload through both packages' schedulers in the
    same mode: identical token streams, request for request, and the
    same count of hybrid steps."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, size=n).tolist()
               for n in (5, 80, 9, 50, 12, 33)]
    cfg = dict(BASE, **mode)
    jeng = ref_engine(**cfg)
    want, _ = sched_run(jeng, prompts, 12, ref=True)
    eng = port_engine(**cfg)
    got, seqs = sched_run(eng, prompts, 12)
    assert got == want
    assert all(len(v) == 12 for v in got.values())
    assert eng.hybrid_steps_total == jeng.hybrid_steps_total
    assert (eng.hybrid_steps_total > 0) == bool(mode.get("hybrid_prefill"))
    eng.check_pool_clean()


def test_hybrid_matches_serial_scheduler():
    """Serial and hybrid schedulers within the port: the same streams."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, size=n).tolist()
               for n in (5, 80, 9, 50)]
    serial = port_engine(**BASE)
    hybrid = port_engine(**BASE, hybrid_prefill=True)
    a, _ = sched_run(serial, prompts, 10)
    b, _ = sched_run(hybrid, prompts, 10)
    assert a == b and serial.hybrid_steps_total == 0
    serial.check_pool_clean()
    hybrid.check_pool_clean()


def test_hybrid_mid_prefill_cancel():
    """Cancelling the long prompt between hybrid chunks ends it cleanly
    (no token), leaves the survivor byte-identical, leaks nothing."""
    short, long = _mixed_prompts()
    long = long * 2            # truncated to 127 tokens, 8 chunks
    eng = port_engine(**BASE, hybrid_prefill=True, decode_pipeline_depth=2)
    want_short = eng.generate([short], max_new_tokens=30)[0]
    sched = EngineScheduler(eng).start()
    try:
        s1 = Sequence(request_id=1, prompt_tokens=short, max_new_tokens=30)
        s2 = Sequence(request_id=2, prompt_tokens=long, max_new_tokens=8)
        events, done = _submit(sched, [s1, s2])
        deadline = time.time() + 60
        while s2.prefill_offset == 0 and time.time() < deadline:
            time.sleep(0.002)
        sched.cancel(2)
        assert done[2].wait(60) and done[1].wait(120)
    finally:
        sched.stop(drain=False)
    assert s2.finish_reason == "cancelled" and events[2] == []
    assert events[1] == want_short
    eng.check_pool_clean()


def test_hybrid_mid_prefill_preemption():
    """Preemption under optimistic admission while a long prompt prefills
    in hybrid steps: every request recompute-resumes to the tokens it
    gets alone, and the pool is clean."""
    rng = np.random.default_rng(11)
    shorts = [rng.integers(0, VOCAB, size=6).tolist() for _ in range(3)]
    long = rng.integers(0, VOCAB, size=90).tolist()
    ref = ref_engine(**BASE)
    want = ([ref.generate([p], max_new_tokens=40)[0] for p in shorts]
            + [ref.generate([long], max_new_tokens=8)[0]])
    # Pool math: the long prompt takes 12 pages, each short grows to 6;
    # 27 usable pages cannot hold all four at their peak.
    eng = port_engine(**dict(BASE, num_pages=28, admission="optimistic",
                             preempt_watermark_pages=6,
                             optimistic_headroom_pages=1),
                      hybrid_prefill=True)
    seqs = [Sequence(request_id=i, prompt_tokens=list(p), max_new_tokens=40)
            for i, p in enumerate(shorts)]
    seqs.append(Sequence(request_id=3, prompt_tokens=long, max_new_tokens=8))
    sched = EngineScheduler(eng).start()
    try:
        events, done = _submit(sched, seqs)
        for ev in done.values():
            assert ev.wait(240)
    finally:
        sched.stop(drain=False)
    assert [events[i] for i in range(4)] == want
    assert eng.preemptions_total >= 1
    assert eng.resumes_total == eng.preemptions_total
    assert eng.hybrid_steps_total > 0
    eng.check_pool_clean()


def test_hybrid_drain_shutdown():
    """stop(drain=True) with a hybrid prefill and decode lanes in flight:
    one terminal callback per request (finished or "shutdown"), no
    call left in flight, nothing leaked."""
    rng = np.random.default_rng(5)
    eng = port_engine(**BASE, hybrid_prefill=True, decode_pipeline_depth=2)
    sched = EngineScheduler(eng).start()
    finished = []
    s_short = Sequence(request_id=1,
                       prompt_tokens=rng.integers(0, VOCAB, 6).tolist(),
                       max_new_tokens=500)
    s_long = Sequence(request_id=2,
                      prompt_tokens=rng.integers(0, VOCAB, 120).tolist(),
                      max_new_tokens=500)
    for s in (s_short, s_long):
        sched.submit(s, lambda *a: None, lambda sq: finished.append(sq))
    deadline = time.time() + 60
    while not s_short.generated and time.time() < deadline:
        time.sleep(0.002)
    sched.stop(drain=True, timeout=0.3)
    assert sorted(s.request_id for s in finished) == [1, 2]
    assert all(s.finish_reason in ("length", "stop", "shutdown")
               for s in finished)
    assert not eng.pipeline_pending
    eng.check_pool_clean()


def test_hybrid_prefill_liveness_under_sustained_pressure():
    """With the watermark above the pool (pressure never clears), a
    mid-prefill prompt still advances a chunk per iteration while a lane
    decodes: its first token arrives before that lane finishes."""
    eng = port_engine(**BASE, hybrid_prefill=True, admission="optimistic",
                      preempt_watermark_pages=10_000)
    sched = EngineScheduler(eng).start()
    try:
        rng = np.random.default_rng(9)
        short = Sequence(request_id=1,
                         prompt_tokens=rng.integers(0, VOCAB, 6).tolist(),
                         max_new_tokens=500)
        long = Sequence(request_id=2,
                        prompt_tokens=rng.integers(0, VOCAB, 90).tolist(),
                        max_new_tokens=4)
        done = {1: threading.Event(), 2: threading.Event()}
        long_first = threading.Event()
        short_done_then = []
        sched.submit(short, lambda *a: None, lambda s: done[1].set())
        deadline = time.time() + 60
        while not short.generated and time.time() < deadline:
            time.sleep(0.002)

        def on_long(s, t):
            if not long_first.is_set():
                short_done_then.append(short.done)
                long_first.set()

        sched.submit(long, on_long, lambda s: done[2].set())
        assert long_first.wait(120), "long prompt starved under pressure"
        sched.cancel(1)
        for ev in done.values():
            assert ev.wait(60)
    finally:
        sched.stop(drain=False)
    assert short_done_then == [False]
    eng.check_pool_clean()


def test_hybrid_chunk_only_call_then_decode_staging():
    """A chunk-only call in flight (no decode half) is skipped by the
    carry fold: a lane that becomes stageable afterwards dispatches."""
    eng = port_engine(**BASE, hybrid_prefill=True, decode_pipeline_depth=4)
    k = eng.engine_cfg.decode_steps_per_call
    rng = np.random.default_rng(3)
    s1 = Sequence(request_id=1,
                  prompt_tokens=rng.integers(0, VOCAB, 5).tolist(),
                  max_new_tokens=k)
    eng.prefill(s1)
    long = Sequence(request_id=2,
                    prompt_tokens=rng.integers(0, VOCAB, 90).tolist(),
                    max_new_tokens=4)
    eng.prefill_begin(long)
    eng.hybrid_step_pipelined(long)        # decode grant + chunk 1
    eng.hybrid_step_pipelined(long)        # s1 covered: chunk-only
    assert any(c["outs"] is None for c in eng._inflight)
    s3 = Sequence(request_id=3,
                  prompt_tokens=rng.integers(0, VOCAB, 5).tolist(),
                  max_new_tokens=12)
    eng.prefill(s3)
    eng.hybrid_step_pipelined(long)
    for _ in range(50):
        eng.drain_pipeline()
        if long.prefill_prompt is None:
            break
        eng.hybrid_step_pipelined(long)
    assert long.prefill_prompt is None and long.generated
    eng.drain_pipeline()
    for s in list(eng.slots):
        if s is not None:
            eng.release(s)
    eng.check_pool_clean()


def test_hybrid_drain_error_keeps_engine_loop_alive():
    """An error surfacing at a drain fails the affected requests with
    "error" and the loop serves the next request."""
    eng = port_engine(**BASE, hybrid_prefill=True, decode_pipeline_depth=2)
    sched = EngineScheduler(eng).start()
    real = eng.drain_pipeline
    state = {"armed": False, "fired": False}

    def flaky():
        if state["armed"] and not state["fired"]:
            state["fired"] = True
            eng.abort_pipeline()
            raise RuntimeError("injected sync failure")
        return real()

    eng.drain_pipeline = flaky
    try:
        rng = np.random.default_rng(13)
        short = Sequence(request_id=1,
                         prompt_tokens=rng.integers(0, VOCAB, 6).tolist(),
                         max_new_tokens=40)
        long = Sequence(request_id=2,
                        prompt_tokens=rng.integers(0, VOCAB, 90).tolist(),
                        max_new_tokens=6)
        _, done = _submit(sched, [short, long])
        deadline = time.time() + 60
        while long.prefill_offset == 0 and time.time() < deadline:
            time.sleep(0.002)
        state["armed"] = True
        sched.cancel(2)
        assert done[2].wait(60) and done[1].wait(120)
        assert state["fired"]
        eng.drain_pipeline = real
        fresh = Sequence(request_id=3,
                         prompt_tokens=rng.integers(0, VOCAB, 6).tolist(),
                         max_new_tokens=5)
        _, done3 = _submit(sched, [fresh])
        assert done3[3].wait(60)
        assert fresh.finish_reason == "length"
    finally:
        sched.stop(drain=False)
    eng.check_pool_clean()


@pytest.mark.parametrize("budget", [0, 8, 24, 40, 100])
def test_hybrid_chunk_cap_matches_reference(budget):
    """_hybrid_chunk_cap equals the reference's for every granted decode
    token count, floored at a page of progress."""
    cfg = dict(BASE, hybrid_prefill=True, step_token_budget=budget)
    t, j = port_engine(**cfg), ref_engine(**cfg)
    for decode_tokens in (0, 1, 4, 8, 16, 31, 32, 100, 800):
        assert (t._hybrid_chunk_cap(decode_tokens)
                == j._hybrid_chunk_cap(decode_tokens))
    if budget:
        assert t._hybrid_chunk_cap(800) == t.engine_cfg.page_size


def test_pipeline_depth_2_keeps_calls_in_flight():
    """decode_steps_pipelined at depth 2 returns with one call still
    queued, yields the synchronous tokens, and drains clean."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=7).tolist() for _ in range(3)]
    want = port_engine(**BASE).generate(prompts, max_new_tokens=13)
    eng = port_engine(**BASE, decode_pipeline_depth=2)
    seqs = [Sequence(request_id=i, prompt_tokens=p, max_new_tokens=13)
            for i, p in enumerate(prompts)]
    for s in seqs:
        eng.prefill(s)
    assert eng.decode_steps_pipelined() == {}      # first call queued
    assert eng.pipeline_pending
    while eng.active_sequences() or eng.pipeline_pending:
        if not eng.decode_steps_pipelined() and not eng.active_sequences():
            eng.drain_pipeline()
    assert [s.generated for s in seqs] == want
    for s in seqs:
        eng.release(s)
    eng.check_pool_clean()


def test_decode_steps_chained_matches_reference():
    """n_calls chained K-step calls with one sync: the reference's
    tokens."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, VOCAB, size=9).tolist() for _ in range(3)]
    cfg = dict(BASE, decode_steps_per_call=4)
    out = []
    for eng, ref in ((port_engine(**cfg), False), (ref_engine(**cfg), True)):
        from tpu_inference.engine.engine import Sequence as JSequence
        cls = JSequence if ref else Sequence
        seqs = [cls(request_id=i, prompt_tokens=p, max_new_tokens=20)
                for i, p in enumerate(prompts)]
        for s in seqs:
            eng.prefill(s)
        res = eng.decode_steps_chained(3)
        out.append(({k: list(v) for k, v in res.items()},
                    [list(s.generated) for s in seqs]))
    assert out[0] == out[1]
