"""Port twin of models/quant.py against the JAX reference: weight codes,
scales and both int4 packings byte-identical; qdot within the
reference's own int4 tolerance (tests/test_quant.py, rtol 1e-4, atol
1e-5, float32); a JAX-quantized tree carried across by params_from_numpy
gives the reference's logits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.models import build_model as j_build
from tpu_inference.models import common as jc
from tpu_inference.models import llama as jl
from tpu_inference.models import quant as jq
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models import llama as tl
from tpu_inference_torch.models import quant as tq
from tpu_inference_torch.models.registry import build_model
from tpu_inference_torch.models.weights import params_from_numpy

# (shape, mode): int8 per channel; int4 grouped (contraction dim a
# multiple of 128, packed) and ungrouped (not a multiple: one group,
# unpacked); with and without a leading layer axis.
CASES = [((256, 64), "int8"), ((3, 200, 48), "int8"),
         ((256, 64), "int4"), ((2, 384, 40), "int4"),
         ((96, 40), "int4"), ((2, 64, 24), "int4")]


def _weight(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * 0.05


@pytest.mark.parametrize("shape,mode", CASES)
def test_quantize_array_byte_identical(shape, mode):
    w = _weight(shape)
    want = jq.quantize_array(jnp.asarray(w), mode)
    got = tq.quantize_array(torch.from_numpy(w), mode)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        tq.dequantize(got).numpy(), np.asarray(jq.dequantize(want)))


def test_int4_pack_unpack_byte_identical():
    rng = np.random.default_rng(1)
    codes = rng.integers(-7, 8, size=(2, 16, 12)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), codes)
    # Every byte value, through torch's int8 shifts and jnp's.
    every = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(every)).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(every))))


@pytest.mark.parametrize("shape,mode", [((256, 64), "int8"),
                                        ((256, 64), "int4"),
                                        ((384, 40), "int4"),
                                        ((96, 40), "int4"),
                                        ((96, 40), "none")])
def test_qdot_matches_reference(shape, mode):
    w = _weight(shape, seed=2)
    x = np.random.default_rng(3).standard_normal(
        (2, 5, shape[0])).astype(np.float32)
    if mode == "none":
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw = jq.quantize_array(jnp.asarray(w), mode)
        tw = tq.quantize_array(torch.from_numpy(w), mode)
    want = np.asarray(jq.qdot(jnp.asarray(x), jw))
    got = tc.qdot(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_quantized_array_views_and_device():
    qa = tq.quantize_array(torch.from_numpy(_weight((3, 256, 8))), "int4")
    layer = qa[1]
    assert tuple(layer.shape) == (128, 8) and layer.dtype == torch.int8
    assert tuple(layer.scale.shape) == (2, 8)
    assert torch.equal(layer.q, qa.q[1]) and torch.equal(layer.scale,
                                                         qa.scale[1])
    moved = qa.to("cpu")
    assert moved.q.device.type == "cpu" and torch.equal(moved.q, qa.q)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_params_byte_identical(mode):
    """The port's quantize_params on the reference's full-precision
    weights gives the codes and scales of the reference's quantize_array
    leaf by leaf, and leaves already quantized leaves alone.

    The reference's quantize_params runs quantize_array under jit, where
    XLA folds ``amax / 127`` into ``amax * (1 / 127)``: its scales sit
    within 1 ulp of the eager ones (codes equal here)."""
    jm, tm = jcfg.tiny_llama(), tcfg.tiny_llama()
    params, _ = j_build(jm, seed=0)
    jitted = jax.device_get(jq.quantize_params(params, mode))
    got = tq.quantize_params(
        params_from_numpy(jax.device_get(params), tm, device="cpu"), mode)
    for name, leaf in got["blocks"].items():
        if name not in tq.QUANT_KEYS:
            assert isinstance(leaf, torch.Tensor)
            continue
        want = jq.quantize_array(params["blocks"][name], mode)
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(leaf.scale.numpy(),
                                      np.asarray(want.scale))
        ref = jitted["blocks"][name]
        np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_max_ulp(leaf.scale.numpy(),
                                        np.asarray(ref.scale), maxulp=1)
    assert tq.quantize_params(got, mode)["blocks"]["wq"] is \
        got["blocks"]["wq"]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_params_from_numpy_carries_quantized_tree(mode):
    """A JAX-quantized tree crosses as int8 codes + float32 scales, and
    the port's forward matches the reference's within 1e-4 (float32)."""
    jm, tm = jcfg.tiny_llama(), tcfg.tiny_llama()
    params, _ = j_build(jm, seed=0)
    qparams = jq.quantize_params(params, mode)
    tp = params_from_numpy(jax.device_get(qparams), tm, device="cpu")
    wd = tp["blocks"]["w_down"]
    assert isinstance(wd, tq.QuantizedArray) and wd.q.dtype == torch.int8
    np.testing.assert_array_equal(wd.q.numpy(),
                                  np.asarray(qparams["blocks"]["w_down"].q))
    assert isinstance(tp["embed"], torch.Tensor)
    rng = np.random.default_rng(0)
    b, s = 2, 24
    tokens = rng.integers(0, jm.vocab_size, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, _ = jl.forward(qparams, jm, jnp.asarray(tokens), jnp.asarray(pos),
                         None, jc.make_dense_attn())
    got, _ = tl.forward(tp, tm, torch.from_numpy(tokens),
                        torch.from_numpy(pos.copy()), None,
                        tc.make_dense_attn())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_quantized_params_structure_and_determinism(mode):
    """Leaf-by-leaf quantized init has the tree, shapes and dtypes of
    init-then-quantize, is deterministic per seed, and is what
    build_model gives for a quant mode."""
    cfg = tcfg.tiny_llama()
    a = tq.init_quantized_params(cfg, seed=0, mode=mode, device="cpu")
    b, _ = build_model(cfg, seed=0, device="cpu", quant=mode)
    ref = tq.quantize_params(build_model(cfg, seed=0, device="cpu")[0],
                             mode)

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, pre + k + "."))
            elif isinstance(v, tq.QuantizedArray):
                out[pre + k + ".q"], out[pre + k + ".scale"] = v.q, v.scale
            else:
                out[pre + k] = v
        return out

    fa, fb, fr = flat(a), flat(b), flat(ref)
    assert fa.keys() == fr.keys() and len(
        [k for k in fa if k.endswith(".q")]) == 8
    for k in fa:
        assert fa[k].shape == fr[k].shape and fa[k].dtype == fr[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def test_unknown_quant_mode_rejected():
    with pytest.raises(ValueError, match="unknown quant mode"):
        tq.quantize_params({"wq": torch.zeros(4, 4)}, "int2")
    with pytest.raises(ValueError, match="needs a quant mode"):
        tq.init_quantized_params(tcfg.tiny_llama(), mode="none",
                                 device="cpu")
