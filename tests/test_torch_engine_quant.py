"""Quantized serving in the port against the JAX InferenceEngine (dense
backend) on the same quantized weights: greedy tokens identical for
both of the port's attention backends ("kernel" runs the kernels' plain
versions on CPU tensors, reading the pool's codes and scales as the
CUDA kernels do; "dense" gathers and dequantizes), for int8 and int4
weights under each KV tier, and an int8 pool under a sliding window.
This is the reference's own contract for its two backends
(tests/test_kv_quant.py)."""

import numpy as np
import pytest

import jax

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.models import quant as jq
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models.quant import QuantizedArray
from tpu_inference_torch.models.weights import params_from_numpy

# tests/test_torch_engine.py's engine config; 70 tokens take three
# chunks of the 32-token bucket.
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)
LENGTHS = (5, 12, 27, 70)


@pytest.mark.parametrize("preset,quant,kv_quant", [
    ("tiny_llama", "int8", "none"),
    ("tiny_llama", "int8", "int8"),
    ("tiny_llama", "int8", "int4"),
    ("tiny_llama", "int4", "none"),
    ("tiny_llama", "int4", "int8"),
    ("tiny_llama", "int4", "int4"),
    ("tiny_llama", "none", "int4"),
    ("tiny_mistral", "none", "int8"),              # sliding window 64
])
def test_quantized_generate_matches_reference(preset, quant, kv_quant):
    jm = getattr(jcfg, preset)(vocab_size=256)
    tm = getattr(tcfg, preset)(vocab_size=256)
    params, _ = j_build(jm, seed=0)
    if quant != "none":
        params = jq.quantize_params(params, quant)
    tp = params_from_numpy(jax.device_get(params), tm, device="cpu")
    ecfg = dict(ENGINE, quant=quant, kv_quant=kv_quant)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in LENGTHS]
    want = JEngine(jm, jcfg.EngineConfig(**ecfg), params=params,
                   attn_backend="dense").generate(prompts, max_new_tokens=10)
    for backend in ("kernel", "dense"):
        eng = InferenceEngine(tm, tcfg.EngineConfig(**ecfg), params=tp,
                              attn_backend=backend, device="cpu")
        assert eng.kv.quantized == (kv_quant != "none")
        got = eng.generate(prompts, max_new_tokens=10)
        assert got == want, backend


def test_random_init_quantized_engine_counts_codes_and_scales():
    """With no params and a quant mode the engine draws quantized weights
    leaf by leaf; n_params and weight_bytes count codes plus scales, as
    the reference counts the leaves of its QuantizedArray tree."""
    cfg = tcfg.tiny_llama(vocab_size=256)
    eng = InferenceEngine(cfg, tcfg.EngineConfig(**ENGINE, quant="int4",
                                                 kv_quant="int8"),
                          device="cpu")
    wq = eng.params["blocks"]["wq"]
    assert isinstance(wq, QuantizedArray)
    ref = JEngine(jcfg.tiny_llama(vocab_size=256),
                  jcfg.EngineConfig(**ENGINE, quant="int4", kv_quant="int8"),
                  attn_backend="dense")
    assert eng.n_params == ref.n_params
    assert eng.weight_bytes == ref.weight_bytes
    out = eng.generate([[1, 2, 3]], max_new_tokens=4)
    assert len(out[0]) == 4


def test_config_envelope_carries_quant_modes():
    """One dict boots either package with both quant fields set."""
    ref = jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(),
        engine=jcfg.EngineConfig(quant="int4", kv_quant="int8", **ENGINE))
    port = tcfg.framework_config_from_dict(jcfg.framework_config_to_dict(ref))
    assert (port.engine.quant, port.engine.kv_quant) == ("int4", "int8")
    back = jcfg.framework_config_from_dict(
        tcfg.framework_config_to_dict(port))
    assert (back.engine.quant, back.engine.kv_quant) == ("int4", "int8")
    assert tcfg.framework_config_from_dict(
        tcfg.framework_config_to_dict(port)) == port


def test_entry_points_take_both_quant_modes(capsys):
    """build_server passes quant/kv_quant to the engine; the CLI offers
    both flags with the reference's choices."""
    from tpu_inference_torch.server.__main__ import main
    from tpu_inference_torch.server.http import build_server

    server = build_server("tiny-llama", device="cpu", warmup=False,
                          quant="int8", kv_quant="int4", num_pages=32,
                          max_pages_per_seq=8, prefill_buckets=(16,))
    try:
        assert isinstance(server.engine.params["blocks"]["w_up"],
                          QuantizedArray)
        assert server.engine.kv.packed_int4
        assert server.tags()["models"][0]["details"][
            "quantization_level"] == "Q8_0"
    finally:
        server.shutdown()
    with pytest.raises(SystemExit):
        main(["--help"])
    text = capsys.readouterr().out
    for flag in ("--quant {none,int8,int4}", "--kv-quant {none,int8,int4}"):
        assert flag in text
