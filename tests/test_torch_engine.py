"""Port InferenceEngine.generate against the JAX InferenceEngine.generate
(dense backend) on the same weights: greedy tokens identical, for both of
the port's attention backends ("kernel" runs the kernels' plain versions
on CPU tensors; "dense" the gather path)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.models.weights import params_from_numpy

# tests/test_kernels.py's engine config.
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)
# Crossing buckets; 70 tokens take three chunks of the 32-token bucket.
LENGTHS = (5, 12, 27, 70)


def _pair(preset, **engine):
    jm = getattr(jcfg, preset)(vocab_size=256)
    tm = getattr(tcfg, preset)(vocab_size=256)
    params, _ = j_build(jm, seed=0)
    tp = params_from_numpy(jax.device_get(params), tm, device="cpu")
    ecfg = {**ENGINE, **engine}
    return (jm, jcfg.EngineConfig(**ecfg), params,
            tm, tcfg.EngineConfig(**ecfg), tp)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in LENGTHS]


@pytest.mark.parametrize("preset,engine", [
    ("tiny_llama", {}),
    ("tiny_mistral", {}),                          # sliding window 64
    ("tiny_llama", {"chunked_prefill_size": 16,
                    "decode_steps_per_call": 3}),
])
def test_generate_matches_reference(preset, engine):
    jm, je, params, tm, te, tp = _pair(preset, **engine)
    prompts = _prompts()
    want = JEngine(jm, je, params=params, attn_backend="dense").generate(
        prompts, max_new_tokens=10)
    for backend in ("kernel", "dense"):
        got = InferenceEngine(tm, te, params=tp, attn_backend=backend,
                              device="cpu").generate(prompts,
                                                     max_new_tokens=10)
        assert got == want, backend


def test_prefix_cache_hit_matches_reference():
    """A repeated prompt reuses the first run's pages (prefix-cache hit)
    and still produces the reference's tokens."""
    jm, je, params, tm, te, tp = _pair("tiny_llama")
    prompt = _prompts(seed=9)[3]                   # 70 tokens
    jeng = JEngine(jm, je, params=params, attn_backend="dense")
    want = [jeng.generate([prompt], max_new_tokens=8) for _ in range(2)]
    eng = InferenceEngine(tm, te, params=tp, device="cpu")
    got = [eng.generate([prompt], max_new_tokens=8) for _ in range(2)]
    assert got == want
    assert eng.prefix_cache.hits_hbm.value == 1
    assert eng.prefix_cache.misses.value == 1
    # 70 prompt tokens + 7 settled generated ones: 9 full pages published.
    assert len(eng.prefix_cache) == 9


def test_incremental_prefill_and_decode_steps():
    """prefill_begin/prefill_step chunk a long prompt; decode_steps runs
    K steps per call with one sync; release returns every page."""
    _, _, _, tm, te, tp = _pair("tiny_llama", enable_prefix_cache=False)
    eng = InferenceEngine(tm, te, params=tp, device="cpu")
    seq = Sequence(request_id=7, prompt_tokens=_prompts()[3],
                   max_new_tokens=6)
    eng.prefill_begin(seq)
    assert eng.active_sequences() == []            # mid-prefill
    steps = 1
    while not eng.prefill_step(seq):
        steps += 1
    assert steps == 3 and seq.ctx_len == 70 and len(seq.generated) == 1
    out = eng.decode_steps()
    assert out == {7: seq.generated[1:5]}          # K = 4 tokens
    eng.decode_steps()
    assert seq.done and seq.finish_reason == "length"
    eng.release(seq)
    assert eng.allocator.num_free == te.num_pages - 1
    assert eng.free_slots() == list(range(te.max_batch_size))


def test_warmup_writes_only_the_trash_page():
    _, _, _, tm, te, tp = _pair("tiny_llama")
    eng = InferenceEngine(tm, te, params=tp, device="cpu")
    assert eng.warmup() >= 0.0
    assert not eng.kv.k[:, 1:].any() and not eng.kv.v[:, 1:].any()


@pytest.mark.parametrize("field,value", [
    ("hybrid_prefill", True),
    ("step_token_budget", 24),
    ("decode_pipeline_depth", 2),
    ("host_cache_pages", 8),
    ("admission", "optimistic"),
    ("decode_ladder", (2, 4)),
    ("ladder_admit_headroom_pages", 4),
    ("slo_ttft_ms", 250.0),
    ("slo_tpot_ms", 40.0),
])
def test_engine_breadth_knobs_are_served(field, value):
    """The knobs of the serving-engine slice boot the engine."""
    ecfg = dataclasses.replace(tcfg.EngineConfig(**ENGINE), **{field: value})
    eng = InferenceEngine(tcfg.tiny_llama(), ecfg, device="cpu")
    assert getattr(eng.engine_cfg, field) == value


@pytest.mark.parametrize("knobs,check", [
    ({"spec_mode": "ngram", "num_speculative_tokens": 2},
     lambda e: e.spec_ngram and e._spec_widths == [2, 3]),
    ({"spec_mode": "ngram", "num_speculative_tokens": 4, "ngram_window": 5},
     lambda e: e.spec_enabled and e._spec_widths == [2, 5]),
    ({"chaos_page_pressure": 4},
     lambda e: e.chaos_page_pressure == 4
     and e.allocator.num_free == ENGINE["num_pages"] - 1 - 4),
    ({"chaos_step_failure_rate": 0.5},
     lambda e: e.chaos_step_failure_rate == 0.5),
    ({"chaos_step_wedge_s": 1.0}, lambda e: e.chaos_step_wedge_s == 1.0),
], ids=["num_speculative_tokens", "spec_mode", "chaos_page_pressure",
        "chaos_step_failure_rate", "chaos_step_wedge_s"])
def test_spec_and_chaos_knobs_are_served(knobs, check):
    """The speculation and fault-injection knobs boot the engine and land
    in its state (speculation serves tokens: tests/test_torch_ngram_spec.py,
    test_torch_speculative.py; faults: test_torch_chaos.py)."""
    ecfg = dataclasses.replace(tcfg.EngineConfig(**ENGINE), **knobs)
    eng = InferenceEngine(tcfg.tiny_llama(), ecfg, device="cpu")
    assert check(eng)
    if not knobs.get("chaos_step_failure_rate"):
        assert len(eng.generate([[1, 2, 3]], max_new_tokens=3)[0]) == 3


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(tcfg.tiny_llama(), tcfg.EngineConfig(**ENGINE))


def test_config_envelope_boots_either_package():
    """framework_config_to_dict of a reference config boots the port (and
    the port's dict round-trips), with "pallas" read as "kernel"."""
    ref = jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(),
        engine=jcfg.EngineConfig(attn_backend="pallas", **ENGINE))
    port = tcfg.framework_config_from_dict(jcfg.framework_config_to_dict(ref))
    assert port.model.dtype == torch.float32
    assert port.engine.attn_backend == "kernel"
    assert port.engine.prefill_buckets == (16, 32)
    back = tcfg.framework_config_from_dict(
        tcfg.framework_config_to_dict(port))
    assert back == port
    ref2 = jcfg.framework_config_from_dict(tcfg.framework_config_to_dict(
        dataclasses.replace(port, engine=tcfg.EngineConfig(**ENGINE))))
    assert ref2.model == ref.model
