"""The port's GPT-2 family against tpu_inference.models.gpt2: the
reference's random weights carried across by params_from_numpy (biases
and LayerNorm parameters randomized, so they take part), the same inputs
through both. LayerNorm and forward logits within 1e-4; engine greedy
tokens identical to the reference InferenceEngine's for both port
backends, with quantized weights and pools, at a decode ladder and in
hybrid steps; and a prompt that runs past the learned position table
(``max_seq_len``), where the reference's XLA gather clamps to the last
row."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.models import common as jc
from tpu_inference.models import gpt2 as jg
from tpu_inference.models import quant as jq
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models import gpt2 as tg
from tpu_inference_torch.models.weights import params_from_numpy
from tests.test_torch_ladder import ecfg, prompts_of, sched_run

VOCAB = 256
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32),
              decode_steps_per_call=4)
LENGTHS = (5, 12, 27, 70)


@functools.lru_cache(maxsize=None)
def pair(quant: str = "none"):
    """(reference config, its params, port config, the same params as
    CPU tensors). The reference's init zeroes every bias and sets every
    LayerNorm weight to one; they are drawn at random here."""
    jm, tm = jcfg.tiny_gpt2(vocab_size=VOCAB), tcfg.tiny_gpt2(
        vocab_size=VOCAB)
    params, _ = j_build(jm, seed=0)
    key = jax.random.PRNGKey(11)
    for i, name in enumerate(("ln1_w", "ln1_b", "b_qkv", "b_proj", "ln2_w",
                              "ln2_b", "b_fc", "b_out")):
        leaf = params["blocks"][name]
        noise = 0.1 * jax.random.normal(jax.random.fold_in(key, i),
                                        leaf.shape, leaf.dtype)
        params["blocks"][name] = leaf + noise
    if quant != "none":
        params = jq.quantize_params(params, quant)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jc.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = tc.layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    bf = tc.layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(b), 1e-5)
    assert bf.dtype == torch.bfloat16


def test_init_params_layout_matches_reference():
    jm, tm = jcfg.tiny_gpt2(), tcfg.tiny_gpt2()
    ref = jax.device_get(jg.init_params(jm, jax.random.PRNGKey(0)))
    port = tg.init_params(tm, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(port) == shapes(ref)
    assert torch.equal(port["blocks"]["ln1_w"], torch.ones(2, 128))
    assert not port["blocks"]["b_qkv"].any()
    assert abs(port["pos_embed"].std().item() - 0.02) < 2e-3


def test_forward_logits_match_reference():
    jm, params, tm, tp = pair()
    rng = np.random.default_rng(0)
    b, s = 2, 40
    tokens = rng.integers(0, VOCAB, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, _ = jg.forward(params, jm, jnp.asarray(tokens), jnp.asarray(pos),
                         None, jc.make_dense_attn())
    got, _ = tg.forward(tp, tm, torch.from_numpy(tokens),
                        torch.from_numpy(pos.copy()), None,
                        tc.make_dense_attn())
    assert got.dtype == torch.float32 and got.shape == (b, s, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("quant,kv_quant", [
    ("none", "none"), ("none", "int4"), ("int8", "int8"), ("int4", "int4"),
    ("int8", "int4"),
])
def test_generate_matches_reference(quant, kv_quant):
    """Greedy tokens of both port backends equal the reference engine's
    on the same (quantized) weights; Hq = Hkv, so the kernels run at
    n_rep 1."""
    jm, params, tm, tp = pair(quant)
    ecfg_ = dict(ENGINE, quant=quant, kv_quant=kv_quant)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in LENGTHS]
    want = JEngine(jm, jcfg.EngineConfig(**ecfg_), params=params,
                   attn_backend="dense").generate(prompts, max_new_tokens=10)
    for backend in ("kernel", "dense"):
        eng = InferenceEngine(tm, tcfg.EngineConfig(**ecfg_), params=tp,
                              attn_backend=backend, device="cpu")
        assert eng.generate(prompts, max_new_tokens=10) == want, backend
        eng.check_pool_clean()


@pytest.mark.parametrize("mode", ["ladder", "hybrid"])
def test_scheduler_modes_match_reference(mode):
    jm, params, tm, tp = pair()
    if mode == "ladder":
        cfg, prompts, max_new = ecfg(), prompts_of(12), 24
    else:
        cfg = ecfg(max_batch_size=4, decode_ladder=(), max_pages_per_seq=16,
                   hybrid_prefill=True, chunked_prefill_size=16)
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


def test_prompt_past_the_position_table_matches_reference():
    """tiny-gpt2 learns 512 positions; the engine's context (page 16 x
    64 pages = 1024) does not stop at them. A 520-token prompt and its
    12 new tokens sit at positions 0..531: the reference reads the
    table's last row for every position past 511 (XLA clamps the
    gather), and so does the port."""
    jm, params, tm, tp = pair()
    assert jm.max_seq_len == 512
    cfg = dict(page_size=16, num_pages=64, max_pages_per_seq=64,
               max_batch_size=2, prefill_buckets=(64, 256),
               decode_steps_per_call=4)
    prompt = np.random.default_rng(9).integers(0, VOCAB, size=520).tolist()
    want = JEngine(jm, jcfg.EngineConfig(**cfg), params=params,
                   attn_backend="dense").generate([prompt], max_new_tokens=12)
    got = InferenceEngine(tm, tcfg.EngineConfig(**cfg), params=tp,
                          attn_backend="kernel",
                          device="cpu").generate([prompt], max_new_tokens=12)
    assert got == want and len(got[0]) == 12
    # The clamp is the reference's behaviour, not an accident of these
    # weights: position 600 embeds exactly as position 511.
    toks = torch.tensor([[3, 3]])
    x = tg.embed_tokens(tp, tm, toks, torch.tensor([[511, 600]]))
    assert torch.equal(x[0, 0], x[0, 1])
    jx = (params["embed"][jnp.asarray([3, 3])]
          + params["pos_embed"][jnp.asarray([511, 600])])
    np.testing.assert_array_equal(np.asarray(jx), x[0].numpy())
