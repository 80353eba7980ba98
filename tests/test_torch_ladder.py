"""The port's decode batch ladder against the reference's (tests/
test_ladder.py's cases, port beside reference): greedy tokens identical
to the reference's with the ladder on, byte-identical across rungs
within the port, in-flight lanes surviving grow and shrink, the step
down after a drain, the admission headroom guard, and the pool clean
after every mix. The port runs its "kernel" backend (the kernels' plain
versions on CPU tensors), the reference its dense backend, on the same
weights.

The helpers here (``pair``, ``ecfg``, ``sched_run``) serve the other
engine-breadth test files too.
"""

import dataclasses
import functools
import threading
import time

import numpy as np
import pytest

import jax

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.engine.scheduler import EngineScheduler as JScheduler
from tpu_inference.models import build_model as j_build
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler
from tpu_inference_torch.models.weights import params_from_numpy

VOCAB = 256


@functools.lru_cache(maxsize=None)
def pair(preset: str = "tiny_llama"):
    """(reference model config, its params, port model config, the same
    params as torch tensors on the CPU)."""
    jm = getattr(jcfg, preset)(vocab_size=VOCAB)
    tm = getattr(tcfg, preset)(vocab_size=VOCAB)
    params, _ = j_build(jm, seed=0)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


def ecfg(**kw) -> dict:
    """tests/test_ladder.py's engine config, as a dict for either
    package's EngineConfig."""
    base = dict(page_size=8, num_pages=512, max_pages_per_seq=8,
                max_batch_size=16, decode_ladder=(4, 8, 16),
                prefill_buckets=(16, 32))
    base.update(kw)
    return base


def port_engine(preset="tiny_llama", **kw) -> InferenceEngine:
    _, _, tm, tp = pair(preset)
    return InferenceEngine(tm, tcfg.EngineConfig(**kw), params=tp,
                           attn_backend="kernel", device="cpu")


def ref_engine(preset="tiny_llama", **kw) -> JEngine:
    jm, params, _, _ = pair(preset)
    return JEngine(jm, jcfg.EngineConfig(**kw), params=params,
                   attn_backend="dense")


def sched_run(engine, prompts, max_new, ref: bool = False,
              timeout: float = 180.0):
    """Every prompt through the engine's scheduler, all queued before the
    loop starts (so the first admission pass sees the whole burst);
    returns ({request id: streamed tokens}, sequences)."""
    seq_cls, sched_cls = ((JSequence, JScheduler) if ref
                          else (Sequence, EngineScheduler))
    sched = sched_cls(engine)
    seqs = [seq_cls(request_id=i, prompt_tokens=list(p),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    events = {s.request_id: [] for s in seqs}
    done = {s.request_id: threading.Event() for s in seqs}
    for s in seqs:
        sched.submit(s, lambda sq, t: events[sq.request_id].append(t),
                     lambda sq: done[sq.request_id].set())
    sched.start()
    try:
        for s in seqs:
            assert done[s.request_id].wait(timeout), \
                f"request {s.request_id} hung"
    finally:
        sched.stop(drain=True, timeout=30)
    return events, seqs


def prompts_of(n, seed=7, length=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=length).tolist() for _ in range(n)]


def test_invalid_ladder_rejected():
    for bad in ((16, 8), (4, 4, 16), (4, 8)):   # unordered, dup, wrong top
        with pytest.raises(ValueError, match="decode_ladder"):
            port_engine(**ecfg(decode_ladder=bad))


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_ladder_tokens_match_reference(kv_quant):
    """The same burst through both packages' schedulers with the ladder
    on: identical streamed greedy tokens, and the ladder climbed."""
    prompts = prompts_of(12)
    cfg = ecfg(kv_quant=kv_quant)
    want, _ = sched_run(ref_engine(**cfg), prompts, 24, ref=True)
    eng = port_engine(**cfg)
    got, seqs = sched_run(eng, prompts, 24)
    assert got == want
    assert all(len(v) == 24 for v in got.values())
    assert eng.rung_peak == 16 and eng.rung_switches_total >= 1
    eng.check_pool_clean()


def test_byte_identity_across_rungs():
    """Within the port: the fixed base rung and the full ladder emit
    byte-identical greedy tokens (graph width is never a behaviour
    change)."""
    prompts = prompts_of(12)
    base = port_engine(**ecfg(max_batch_size=4, decode_ladder=()))
    base_events, _ = sched_run(base, prompts, 24)
    lad = port_engine(**ecfg())
    lad_events, _ = sched_run(lad, prompts, 24)
    assert base_events == lad_events
    assert lad.rung_peak == 16 and lad.rung_switches_total >= 1
    assert base.ladder == (4,) and base.rung_switches_total == 0
    base.check_pool_clean()
    lad.check_pool_clean()


def test_inflight_lanes_survive_grow_and_shrink():
    """Lanes admitted before a rung transition keep decoding through it,
    dispatch-ahead calls in flight included, and finish with the tokens
    the single-rung engine gives them."""
    eng = port_engine(**ecfg(decode_steps_per_call=4,
                             decode_pipeline_depth=2,
                             latency_decode_threshold=0))
    rng = np.random.default_rng(11)
    long_prompts = prompts_of(3, seed=11)
    want = port_engine(**ecfg(max_batch_size=4, decode_ladder=(),
                              decode_steps_per_call=4)).generate(
        long_prompts, max_new_tokens=48)
    sched = EngineScheduler(eng).start()
    try:
        longs = [Sequence(request_id=i, prompt_tokens=list(p),
                          max_new_tokens=48)
                 for i, p in enumerate(long_prompts)]
        done = {s.request_id: threading.Event() for s in longs}
        events = {s.request_id: [] for s in longs}
        for s in longs:
            sched.submit(s, lambda sq, t: events[sq.request_id].append(t),
                         lambda sq: done[sq.request_id].set())
        deadline = time.time() + 60
        while not all(events.values()) and time.time() < deadline:
            time.sleep(0.005)
        shorts = [Sequence(request_id=100 + i,
                           prompt_tokens=rng.integers(0, VOCAB,
                                                      size=6).tolist(),
                           max_new_tokens=16) for i in range(12)]
        sdone = {s.request_id: threading.Event() for s in shorts}
        for s in shorts:
            sched.submit(s, lambda sq, t: None,
                         lambda sq: sdone[sq.request_id].set())
        for s in shorts:
            assert sdone[s.request_id].wait(120)
        for s in longs:
            assert done[s.request_id].wait(120)
    finally:
        sched.stop(drain=True, timeout=20)
    for i, s in enumerate(longs):
        assert events[s.request_id] == want[i]
    assert all(len(s.generated) == 16 for s in shorts)
    assert eng.rung_peak == 16
    assert eng.rung_switches_total >= 2          # grew AND shrank
    eng.check_pool_clean()


def test_rung_steps_down_after_drain():
    """Once high slots drain, compaction moves the survivors into low
    slots and the next call runs a smaller rung."""
    eng = port_engine(**ecfg())
    for i, p in enumerate(prompts_of(10)):
        eng.prefill(Sequence(request_id=i, prompt_tokens=list(p),
                             max_new_tokens=32))
    eng.decode_steps()
    assert eng.decode_rung == 16
    for s in list(eng.slots)[2:]:
        if s is not None:
            s.done = True
            eng.release(s)
    eng.decode_steps()
    assert eng.decode_rung == 4
    assert all(s.slot < 4 for s in eng.active_sequences())
    for s in eng.active_sequences():
        s.done = True
        eng.release(s)
    eng.check_pool_clean()


def test_preemption_and_host_tier_compose_at_full_top_rung():
    """A full top-rung batch under optimistic admission with the host
    tier: preemption fires, every request completes with the reference's
    tokens (the reference under the same tight pool), and the pool is
    clean."""
    prompts = prompts_of(12, seed=3, length=8)
    cfg = ecfg(max_batch_size=8, decode_ladder=(2, 4, 8), num_pages=16,
               admission="optimistic", optimistic_headroom_pages=1,
               preempt_watermark_pages=4, host_cache_pages=64)
    want, _ = sched_run(ref_engine(**cfg), prompts, 16, ref=True)
    eng = port_engine(**cfg)
    assert eng.host_pool is not None
    got, seqs = sched_run(eng, prompts, 16)
    assert all(s.finish_reason == "length" for s in seqs)
    assert got == want
    base = port_engine(**ecfg(max_batch_size=4, decode_ladder=()))
    assert got == dict(enumerate(base.generate(prompts, max_new_tokens=16)))
    assert eng.preemptions_total >= 1 and eng.rung_peak >= 4
    eng.check_pool_clean()


@pytest.mark.parametrize("kv_quant", ["int8", "int4"])
def test_kv_layout_rung_invariant(kv_quant):
    """Quantized pools at every rung emit the base rung's tokens."""
    prompts = prompts_of(8, seed=5, length=10)

    def outs(batch, ladder, n):
        eng = port_engine(**ecfg(max_batch_size=batch, decode_ladder=ladder,
                                 kv_quant=kv_quant))
        out = eng.generate(prompts[:n], max_new_tokens=8)
        eng.check_pool_clean()
        return out

    base = outs(2, (), 8)                 # serial waves of 2
    for n in (4, 8):                      # rung 4, and 4 -> 8
        assert outs(8, (4, 8), n) == base[:n]


def test_stage_reuse_is_output_invariant():
    """Persistent staging buffers and rebuilding per call give the same
    tokens under rung churn."""
    prompts = prompts_of(10, seed=9)

    def run(reuse):
        eng = port_engine(**ecfg(stage_host_reuse=reuse))
        out = eng.generate(prompts, max_new_tokens=12)
        eng.check_pool_clean()
        return out

    assert run(True) == run(False)


def test_ladder_admit_headroom_guards_growth():
    """Growth past the base rung must leave the configured reclaimable
    slack: a tight pool stays at the base rung with the guard, climbs
    without it (as in the reference)."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, VOCAB, size=8).tolist() for _ in range(4)]

    def run(headroom):
        cfg = ecfg(max_batch_size=4, decode_ladder=(2, 4), num_pages=12,
                   max_pages_per_seq=2, ladder_admit_headroom_pages=headroom)
        eng = port_engine(**cfg)
        _, seqs = sched_run(eng, prompts, 8)
        assert all(s.finish_reason == "length" for s in seqs)
        eng.check_pool_clean()
        ref = ref_engine(**cfg)
        sched_run(ref, prompts, 8, ref=True)
        assert ref.rung_peak == eng.rung_peak
        return eng.rung_peak

    assert run(headroom=0) == 4
    assert run(headroom=6) == 2


def test_warmup_runs_every_rung_on_the_trash_page():
    """warmup() runs the decode call at every rung (K steps and the
    one-step route) and, with hybrid steps, the hybrid call at every
    reachable bucket and rung; every write lands on the trash page."""
    eng = port_engine(**ecfg(decode_steps_per_call=4, hybrid_prefill=True))
    seen = []
    orig = eng._decode_multi_fn

    def spy(st, k_steps):
        seen.append((len(st["ctx"]), k_steps))
        return orig(st, k_steps)

    eng._decode_multi_fn = spy
    eng.warmup()
    for b in (4, 8, 16):
        assert (b, 4) in seen and (b, 1) in seen
        assert seen.count((b, 4)) == 1 + 2     # plain + 2 hybrid buckets
    assert not eng.kv.k[:, 1:].any() and not eng.kv.v[:, 1:].any()


def test_chunk_only_calls_never_block_the_pipeline():
    """An in-flight chunk-only call (rung 0: no decode half) must not
    read as a rung cap."""
    eng = port_engine(**ecfg(decode_pipeline_depth=2))
    eng.prefill(Sequence(request_id=0, prompt_tokens=[1, 2, 3],
                         max_new_tokens=8))
    eng._inflight.append({"outs": None, "final": None, "final_window": None,
                          "event": None, "allowed": {}, "seqs": {},
                          "rung": 0, "prefill": None})
    assert not eng._pipeline_rung_blocked()
    eng._inflight.clear()
    for s in eng.active_sequences():
        s.done = True
        eng.release(s)
    eng.check_pool_clean()


def test_rung_choice_and_compaction_match_reference():
    """_rung_for_slots and _compact_slots against the reference's on the
    same slot occupancy."""
    t, j = port_engine(**ecfg()), ref_engine(**ecfg())
    rng = np.random.default_rng(21)
    for _ in range(20):
        occ = rng.random(16) < rng.random()
        for eng, cls in ((t, Sequence), (j, JSequence)):
            eng.slots = [cls(request_id=i, prompt_tokens=[1],
                             max_new_tokens=1, slot=i) if o else None
                         for i, o in enumerate(occ)]
        bound = [s for s in t.slots if s is not None]
        jbound = [s for s in j.slots if s is not None]
        assert t._rung_for_slots(bound) == j._rung_for_slots(jbound)
        t._compact_slots()
        j._compact_slots()
        assert ([s is None for s in t.slots]
                == [s is None for s in j.slots])
        assert ([s.request_id for s in t.slots if s is not None]
                == [s.request_id for s in j.slots if s is not None])


def test_ladder_knob_is_a_config_field():
    cfg = tcfg.EngineConfig(**ecfg())
    assert cfg.ladder_rungs == (4, 8, 16)
    assert dataclasses.replace(cfg, decode_ladder=()).ladder_rungs == (16,)
