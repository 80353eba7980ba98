"""The port's Mixtral family against tpu_inference.models.mixtral: the
reference's random weights carried across by params_from_numpy, the same
inputs through both. Forward logits within 1e-4; ``qeinsum`` (int8 and
grouped int4) within the reference's own tolerances
(tests/test_quant.py); ``moe_ffn`` on an input whose tokens overflow an
expert's capacity; and engine greedy tokens identical to the reference
InferenceEngine's (the port's "kernel" backend runs the kernels' plain
versions on CPU tensors), with quantized weights and pools, at a decode
ladder and in hybrid steps.

``tiny-mixtral`` (4 experts, top-2) never drops a token at the default
capacity factor 2.0: C = ceil(2 * T / 4 * 2) = T. The drop cases use
``E8``, tiny-mixtral with Mixtral-8x7B's 8 experts (C = T / 2 at the
default factor), so capacity dropping runs in prefill and decode calls.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.models import common as jc
from tpu_inference.models import mixtral as jmx
from tpu_inference.models import quant as jq
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models import mixtral as tmx
from tpu_inference_torch.models import quant as tq
from tpu_inference_torch.models.registry import get_model_fns
from tpu_inference_torch.models.weights import params_from_numpy
from tests.test_torch_ladder import ecfg, prompts_of, sched_run

VOCAB = 256
# tests/test_torch_engine_quant.py's engine config: 70 tokens take three
# chunks of the 32-token bucket; decode at batch 4 (C = 2 of 4 tokens
# per expert on E8).
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)
LENGTHS = (5, 12, 27, 70)


def _cfg(mod, preset: str):
    base = mod.tiny_mixtral(vocab_size=VOCAB)
    if preset == "E8":
        return dataclasses.replace(base, name="tiny-mixtral-e8", n_experts=8)
    return base


@functools.lru_cache(maxsize=None)
def pair(preset: str = "E8", quant: str = "none"):
    """(reference config, its params, port config, the same params as
    CPU tensors); quantized by the reference when ``quant`` is set."""
    jm, tm = _cfg(jcfg, preset), _cfg(tcfg, preset)
    params, _ = j_build(jm, seed=0)
    if quant != "none":
        params = jq.quantize_params(params, quant)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


def test_registry_serves_every_family():
    for preset, name in (("tiny-llama", "llama"), ("tiny-mixtral",
                                                   "mixtral"),
                         ("tiny-gpt2", "gpt2")):
        assert get_model_fns(tcfg.PRESETS[preset]()).__name__.endswith(
            "." + name)


@pytest.mark.parametrize("preset", ["tiny-mixtral", "E8"])
def test_forward_logits_match_reference(preset):
    jm, params, tm, tp = pair(preset)
    rng = np.random.default_rng(0)
    b, s = 2, 40
    tokens = rng.integers(0, VOCAB, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, _ = jmx.forward(params, jm, jnp.asarray(tokens), jnp.asarray(pos),
                          None, jc.make_dense_attn())
    got, _ = tmx.forward(tp, tm, torch.from_numpy(tokens),
                         torch.from_numpy(pos.copy()), None,
                         tc.make_dense_attn())
    assert got.dtype == torch.float32 and got.shape == (b, s, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["none", "int8", "int4"])
@pytest.mark.parametrize("eq", ["ecd,edf->ecf", "ecf,efd->ecd"])
def test_qeinsum_matches_reference(mode, eq):
    """Both expert contractions on the reference's own codes and scales
    (int4 with two groups of 128 along the contraction dim)."""
    rng = np.random.default_rng(4)
    e, c, d_in, d_out = 2, 3, 256, 8
    w = jnp.asarray(rng.normal(size=(e, d_in, d_out)) * 0.02, jnp.float32)
    a = jnp.asarray(rng.normal(size=(e, c, d_in)), jnp.float32)
    if mode == "none":
        jw, tw = w, torch.from_numpy(np.array(w))
    else:
        jw = jq.quantize_array(w, mode)
        tw = tq.QuantizedArray(torch.from_numpy(np.array(jw.q)),
                               torch.from_numpy(np.array(jw.scale)))
        if mode == "int4":
            assert tw.scale.shape == (e, 2, d_out)      # really grouped
    want = jq.qeinsum(eq, a, jw)
    got = tq.qeinsum(eq, torch.from_numpy(np.array(a)), tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_qeinsum_refuses_other_contractions():
    with pytest.raises(ValueError, match="expert contractions"):
        tq.qeinsum("td,df->tf", torch.zeros(2, 4), torch.zeros(4, 3))


def test_moe_ffn_capacity_drops_match_reference():
    """Tokens that all prefer the same experts overflow C = 16 of 32
    tokens (E8, factor 2.0): the later rows lose those experts, and the
    port drops exactly the reference's tokens."""
    jm, params, tm, tp = pair("E8")
    rng = np.random.default_rng(5)
    base = rng.normal(size=(1, 1, jm.d_model))
    x = (base + 0.05 * rng.normal(size=(2, 16, jm.d_model))).astype(
        np.float32)
    lp_j = jax.tree.map(lambda a: a[0], params["blocks"])
    lp_t = {k: v[0] for k, v in tp["blocks"].items()}
    xt = torch.from_numpy(x)
    _, _, slot, keep = tmx.route(tm, lp_t["w_router"], xt.reshape(32, -1))
    assert tmx.expert_capacity(tm, 32) == 16
    assert not bool(keep.all()), "no token overflowed an expert"
    assert bool(keep[:16].all())            # the first C rows always fit
    want = jmx.moe_ffn(jm, lp_j, jnp.asarray(x))
    got = tmx.moe_ffn(tm, lp_t, xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    # With room for every token the output changes: the drops mattered.
    roomy = dataclasses.replace(tm, expert_capacity_factor=4.0)
    assert not torch.allclose(tmx.moe_ffn(roomy, lp_t, xt), got)


def test_init_quantized_params_draws_one_slab_at_a_time(monkeypatch):
    """Expert leaves [L, E, in, out] quantize one [in, out] slab per call
    (L x E calls each); the router is not a QUANT_KEYS leaf and stays
    float."""
    calls = []
    real = tq.quantize_array
    monkeypatch.setattr(tq, "quantize_array",
                        lambda w, mode="int8": calls.append(tuple(w.shape))
                        or real(w, mode))
    tm = tcfg.tiny_mixtral()
    params = tq.init_quantized_params(tm, seed=0, mode="int8", device="cpu")
    blocks = params["blocks"]
    L, E, d, f = tm.n_layers, tm.n_experts, tm.d_model, tm.d_ff
    assert blocks["w_gate"].q.shape == (L, E, d, f)
    assert blocks["w_gate"].scale.shape == (L, E, 1, f)
    assert blocks["w_down"].q.shape == (L, E, f, d)
    assert isinstance(blocks["w_router"], torch.Tensor)
    assert blocks["w_router"].dtype == tm.dtype
    assert calls.count((d, f)) == 2 * L * E          # w_gate, w_up
    assert calls.count((f, d)) == L * E              # w_down
    assert all(len(s) == 2 for s in calls)


@pytest.mark.parametrize("preset,quant,kv_quant", [
    ("tiny-mixtral", "none", "none"),
    ("E8", "none", "none"),
    ("E8", "int8", "int8"),
    ("E8", "int4", "int4"),
    ("E8", "int8", "int4"),
])
def test_generate_matches_reference(preset, quant, kv_quant):
    """Greedy tokens of both port backends equal the reference engine's
    on the same (quantized) weights; on E8 the decode calls at batch 4
    run with C = 2, so tokens drop."""
    jm, params, tm, tp = pair(preset, quant)
    ecfg = dict(ENGINE, quant=quant, kv_quant=kv_quant)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in LENGTHS]
    want = JEngine(jm, jcfg.EngineConfig(**ecfg), params=params,
                   attn_backend="dense").generate(prompts, max_new_tokens=10)
    for backend in ("kernel", "dense"):
        eng = InferenceEngine(tm, tcfg.EngineConfig(**ecfg), params=tp,
                              attn_backend=backend, device="cpu")
        assert eng.generate(prompts, max_new_tokens=10) == want, backend
        eng.check_pool_clean()


@pytest.mark.parametrize("mode", ["ladder", "hybrid"])
def test_scheduler_modes_match_reference(mode):
    """A burst through both schedulers (E8, default capacity): at the
    decode ladder (4, 8, 16), whose calls carry idle lanes that still
    route and take expert slots, and in hybrid steps over an int8 pool;
    streamed tokens identical."""
    jm, params, tm, tp = pair("E8")
    if mode == "ladder":
        cfg, prompts, max_new = ecfg(), prompts_of(12), 24
    else:
        cfg = ecfg(max_batch_size=4, decode_ladder=(), max_pages_per_seq=16,
                   hybrid_prefill=True, chunked_prefill_size=16,
                   kv_quant="int8")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, VOCAB, size=n).tolist()
                   for n in (5, 9, 12, 40, 7, 14, 3, 70, 11, 6)]
        max_new = 16
    want, _ = sched_run(JEngine(jm, jcfg.EngineConfig(**cfg), params=params,
                                attn_backend="dense"), prompts, max_new,
                        ref=True)
    eng = InferenceEngine(tm, tcfg.EngineConfig(**cfg), params=tp,
                          attn_backend="kernel", device="cpu")
    got, _ = sched_run(eng, prompts, max_new)
    assert got == want
    if mode == "ladder":
        assert eng.rung_peak == 16
    else:
        assert eng.hybrid_steps_total >= 1
    eng.check_pool_clean()


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("preset", ["tiny-mixtral", "tiny-gpt2"])
def test_tiny_presets_serve_through_build_server(preset, quant, kv_quant):
    """Both new families boot through build_server in every weight and
    KV tier, answer /api/generate, and /api/tags reports the family."""
    import http.client

    from tpu_inference_torch.server.http import build_server

    server = build_server(preset, device="cpu", warmup=False, quant=quant,
                          kv_quant=kv_quant, num_pages=32,
                          max_pages_per_seq=8, prefill_buckets=(16,))
    try:
        port = server.start(port=0)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("GET", "/api/tags")
        details = json.loads(conn.getresponse().read())["models"][0][
            "details"]
        assert details["family"] == preset.split("-")[1]
        assert details["quantization_level"] == {
            "int8": "Q8_0", "int4": "Q4_0"}.get(quant, "F32")
        conn.request("POST", "/api/generate", json.dumps(
            {"prompt": "hi there", "max_tokens": 5, "stream": False}))
        body = json.loads(conn.getresponse().read())
        assert body["done_reason"] == "length" and body["eval_count"] == 5
    finally:
        server.shutdown()


def test_mixtral_8x7b_auto_sizing_on_an_80gb_card():
    """Mixtral-8x7B (46.7B parameters) does not fit an 80 GB card in
    bf16; int8 fits, and the sizing's reserve (15% of the card) holds
    three bf16 copies of an int8 expert leaf [8, 4096, 14336], what
    ``qeinsum`` makes per call for w_gate, w_up and w_down."""
    from tpu_inference_torch.engine import autosize

    cfg, card = tcfg.mixtral_8x7b(), 80 * 2**30
    assert abs(autosize.estimate_param_count(cfg) / 1e9 - 46.7) < 0.1
    with pytest.raises(ValueError, match="--quant int8"):
        autosize.auto_size(cfg, hbm_bytes=card)
    sz = autosize.auto_size(cfg, hbm_bytes=card, quant="int8",
                            kv_quant="int8", max_pages_per_seq=128)
    copy = cfg.n_experts * cfg.d_model * cfg.d_ff * 2
    assert 3 * copy < 0.15 * card
    assert sz.weight_bytes_per_chip + sz.kv_pool_bytes_per_chip + 3 * copy \
        < card
    assert sz.max_batch_size == 32
