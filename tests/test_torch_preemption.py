"""The port's optimistic admission, watermark preemption and
recompute-resume against the reference's (tests/test_preemption.py
cases, port beside reference). The reference forces exhaustion with
``chaos_page_pressure``; these tests make the pool small instead (page
pressure itself: tests/test_torch_chaos.py).

Pinned: admission charges equal to the reference's; a preempted and
resumed sequence gives the tokens of an unpreempted run; the scheduler
under a tight pool gives the reference's tokens and preemption counts;
the starvation guard; the page-leak invariant across request mixes."""

import threading
import time

import numpy as np
import pytest

from tests.test_torch_ladder import (VOCAB, port_engine, ref_engine,
                                     sched_run)
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference_torch import telemetry
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler

PROMPTS = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10], [11, 12, 13, 14],
           [21, 22, 23, 24, 25, 26], [31, 32, 33]]


def _cfg(**kw) -> dict:
    base = dict(page_size=8, num_pages=40, max_pages_per_seq=16,
                max_batch_size=4, prefill_buckets=(16, 32),
                decode_steps_per_call=4)
    base.update(kw)
    return base


# Tight enough that 4 requests of 24 tokens preempt: 11 usable pages.
TIGHT = dict(admission="optimistic", optimistic_headroom_pages=1,
             preempt_watermark_pages=4, num_pages=12)


@pytest.mark.parametrize("prompt_len,max_new", [(12, 100), (3, 8), (40, 1),
                                                (100, 200), (7, 9)])
@pytest.mark.parametrize("mode", ["reserve", "optimistic"])
def test_admission_charges_match_reference(prompt_len, max_new, mode):
    cfg = _cfg(admission=mode, optimistic_headroom_pages=2)
    t, j = port_engine(**cfg), ref_engine(**cfg)
    for preemptions in (0, 3):
        ts = Sequence(request_id=0, prompt_tokens=list(range(prompt_len)),
                      max_new_tokens=max_new, preemptions=preemptions)
        js = JSequence(request_id=0, prompt_tokens=list(range(prompt_len)),
                       max_new_tokens=max_new, preemptions=preemptions)
        assert t._pages_reserved(ts) == j._pages_reserved(js)
        assert t._pages_for_admission(ts) == j._pages_for_admission(js)
    if mode == "optimistic" and prompt_len == 12 and max_new == 100:
        # 2 prompt pages + 2 headroom; the worst case is 14 pages.
        assert t._pages_for_admission(
            Sequence(request_id=0, prompt_tokens=list(range(12)),
                     max_new_tokens=100)) == 4


def test_admission_mode_validated():
    with pytest.raises(ValueError, match="admission"):
        port_engine(**_cfg(admission="yolo"))


def test_preempt_recompute_resume_token_identical():
    """Preempted mid-decode and re-prefilled, a sequence resumes its
    greedy stream exactly, reusing the pages it published."""
    prompt = list(range(1, 13))
    want = ref_engine(**_cfg()).generate([prompt], max_new_tokens=16)[0]
    eng = port_engine(**_cfg(admission="optimistic"))
    seq = Sequence(request_id=0, prompt_tokens=list(prompt),
                   max_new_tokens=16)
    eng.prefill(seq)
    while len(seq.generated) < 6:
        eng.decode_steps(max_steps=1)
    before = list(seq.generated)
    eng.preempt(seq)
    assert seq.slot == -1 and not seq.pages and seq.ctx_len == 0
    assert seq.preemptions == 1 and seq.generated == before
    assert eng.take_preempted() == [seq]
    assert eng.slots == [None] * eng.engine_cfg.max_batch_size
    eng.prefill(seq)
    assert seq.cached_tokens > 0 and eng.resumes_total == 1
    while not seq.done:
        eng.decode_steps()
    assert seq.generated == want and seq.finish_reason == "length"
    eng.release(seq)
    eng.check_pool_clean()


def test_double_preemption_still_identical():
    prompt = list(range(40, 52))
    want = ref_engine(**_cfg()).generate([prompt], max_new_tokens=20)[0]
    eng = port_engine(**_cfg(admission="optimistic"))
    seq = Sequence(request_id=0, prompt_tokens=list(prompt),
                   max_new_tokens=20)
    eng.prefill(seq)
    for stop_at in (5, 11):
        while len(seq.generated) < stop_at:
            eng.decode_steps(max_steps=1)
        eng.preempt(seq)
        eng.take_preempted()
        eng.prefill(seq)
    while not seq.done:
        eng.decode_steps()
    assert seq.generated == want and seq.preemptions == 2
    eng.release(seq)
    eng.check_pool_clean()


@pytest.mark.parametrize("extra", [{}, {"decode_pipeline_depth": 2},
                                   {"kv_quant": "int8"},
                                   {"host_cache_pages": 32}],
                         ids=["sync", "depth2", "int8-kv", "host-tier"])
def test_tight_pool_scheduler_matches_reference(extra):
    """The same four requests through both packages' schedulers under a
    tight optimistic pool: the same tokens and the same number of
    preemptions and resumes, every request finishing "length"."""
    cfg = _cfg(**TIGHT, **extra)
    jeng = ref_engine(**cfg)
    want, _ = sched_run(jeng, PROMPTS, 24, ref=True)
    eng = port_engine(**cfg)
    got, seqs = sched_run(eng, PROMPTS, 24)
    assert got == want
    assert all(s.finish_reason == "length" for s in seqs)
    assert eng.preemptions_total >= 1
    assert eng.preemptions_total == jeng.preemptions_total
    assert eng.resumes_total == jeng.resumes_total
    unpressured, _ = sched_run(port_engine(**_cfg(**extra)), PROMPTS, 24)
    assert got == unpressured
    eng.check_pool_clean()


@pytest.mark.parametrize("num_pages", [40, 12])
def test_reserve_mode_never_preempts(num_pages):
    """Reserve admission never preempts. With room every request ends
    "length"; over the tight pool the outcomes (tokens and finish
    reasons, "oom" included) are the reference's."""
    eng = port_engine(**_cfg(num_pages=num_pages))
    got, seqs = sched_run(eng, PROMPTS, 24)
    assert eng.preemptions_total == 0
    jeng = ref_engine(**_cfg(num_pages=num_pages))
    want, jseqs = sched_run(jeng, PROMPTS, 24, ref=True)
    assert got == want
    assert ([s.finish_reason for s in seqs]
            == [s.finish_reason for s in jseqs])
    if num_pages == 40:
        assert all(s.finish_reason == "length" for s in seqs)
    eng.check_pool_clean()


def test_starvation_guard_exempts_and_finishes():
    """A sequence at its preemption budget is never a victim, and a
    starved one fails with "oom" instead of preempting forever."""
    eng = port_engine(**_cfg(admission="optimistic",
                             preempt_max_per_request=1))
    s1 = Sequence(request_id=0, prompt_tokens=[1, 2, 3], max_new_tokens=8)
    s2 = Sequence(request_id=1, prompt_tokens=[4, 5, 6], max_new_tokens=8)
    eng.prefill(s1)
    eng.prefill(s2)
    s1.preemptions = 1
    assert eng._preempt_victim([s1, s2]) is s2
    assert eng._preempt_victim([s1]) is None
    eng._starved(s1)
    assert s1.done and s1.finish_reason == "oom"
    eng.release(s1)
    eng.release(s2)
    eng.check_pool_clean()


def test_starvation_guard_end_to_end():
    """preempt_max_per_request=1 under sustained pressure: every request
    finishes with the unpressured tokens."""
    want, _ = sched_run(port_engine(**_cfg()), PROMPTS, 24)
    eng = port_engine(**_cfg(**dict(TIGHT, preempt_max_per_request=1)))
    got, seqs = sched_run(eng, PROMPTS, 24)
    assert got == want
    assert all(s.finish_reason == "length" for s in seqs)
    assert all(s.preemptions <= 1 for s in seqs)
    eng.check_pool_clean()


def test_preemption_metrics_exposed():
    eng = port_engine(**_cfg(**TIGHT))
    sched_run(eng, PROMPTS, 24)
    text = telemetry.render_prometheus([({}, eng.telemetry.registry)])
    for name in ("tpu_inf_preemptions_total",
                 "tpu_inf_recompute_resumes_total",
                 "tpu_inf_swap_in_resumes_total"):
        assert f"\n{name} " in text, name
    assert f"tpu_inf_preemptions_total {eng.preemptions_total}" in text
    snap = EngineScheduler(eng).stats.snapshot(eng)
    assert snap["preemptions"] == eng.preemptions_total >= 1
    assert snap["admission"] == "optimistic"


def test_stop_drain_deadline_cancels_stragglers():
    """stop(drain=True) past its deadline: the running and the queued
    request both end with "shutdown", and nothing leaks."""
    eng = port_engine(**_cfg(max_batch_size=1))
    sched = EngineScheduler(eng).start()
    finished = {}
    evs = [threading.Event(), threading.Event()]
    running = Sequence(request_id=0, prompt_tokens=[1, 2, 3],
                       max_new_tokens=100)
    sched.submit(running, lambda s, t: None,
                 lambda s: (finished.__setitem__(0, s.finish_reason),
                            evs[0].set()))
    deadline = time.time() + 30
    while not running.generated and time.time() < deadline:
        time.sleep(0.002)
    queued = Sequence(request_id=1, prompt_tokens=[4, 5],
                      max_new_tokens=100)
    sched.submit(queued, lambda s, t: None,
                 lambda s: (finished.__setitem__(1, s.finish_reason),
                            evs[1].set()))
    sched.stop(drain=True, timeout=0.3)
    assert evs[0].wait(10) and evs[1].wait(10)
    assert finished == {0: "shutdown", 1: "shutdown"}
    eng.check_pool_clean()


def test_page_leak_invariant_across_request_mixes():
    """Finish + cancel + a failed call + preemption in one scheduler run
    (with the pipeline and the host tier on): the pool comes back
    clean."""
    eng = port_engine(**_cfg(**TIGHT, decode_pipeline_depth=2,
                             host_cache_pages=16))
    real = eng._decode_multi_fn
    state = {"fail": 0}

    def flaky(st, k_steps):
        if state["fail"] > 0:
            state["fail"] -= 1
            raise RuntimeError("injected decode failure")
        return real(st, k_steps)

    eng._decode_multi_fn = flaky
    sched = EngineScheduler(eng).start()
    evs = []
    seqs = []
    try:
        rng = np.random.default_rng(17)
        for i in range(8):
            ev = threading.Event()
            evs.append(ev)
            p = rng.integers(0, VOCAB, size=int(rng.integers(3, 20)))
            seqs.append(Sequence(request_id=i, prompt_tokens=p.tolist(),
                                 max_new_tokens=24))
            sched.submit(seqs[-1], lambda s, t: None,
                         lambda s, ev=ev: ev.set())
        sched.cancel(2)
        time.sleep(0.05)
        state["fail"] = 1
        for i, ev in enumerate(evs):
            if i != 2:
                assert ev.wait(60), f"request {i} never finished"
    finally:
        sched.stop(drain=True, timeout=10.0)
    reasons = {s.finish_reason for s in seqs}
    assert reasons <= {"length", "cancelled", "error"}
    eng.check_pool_clean()
