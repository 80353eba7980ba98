"""Port twin of models/common.py against the JAX reference on the CPU:
the same numpy inputs through both, float32 within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.models import common as jc
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.models import common as tc

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    w = (0.1 * rng.standard_normal(48)).astype(np.float32)
    _close(tc.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                       offset),
           jc.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset))


@pytest.mark.parametrize("scaling", [None, "llama3"])
def test_apply_rope(scaling):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 9000, size=(2, 7)).astype(np.int32)
    js = jcfg.RopeScaling() if scaling else None
    ts = tcfg.RopeScaling() if scaling else None
    _close(tc.rope_frequencies(64, 500000.0, ts),
           jc.rope_frequencies(64, 500000.0, js))
    # Large positions: angles reach ~1e4 radians, where f32 cos/sin of
    # the two libraries part by a few ulps of the angle.
    _close(tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         500000.0, ts),
           jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0, js),
           tol=2e-3)
    small = pos % 64
    _close(tc.apply_rope(torch.from_numpy(x), torch.from_numpy(small),
                         10000.0, ts),
           jc.apply_rope(jnp.asarray(x), jnp.asarray(small), 10000.0, js))


@pytest.mark.parametrize("n_rep", [1, 3])
def test_repeat_kv(n_rep):
    x = np.random.default_rng(2).standard_normal((2, 3, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tc.repeat_kv(torch.from_numpy(x), n_rep).numpy(),
        np.asarray(jc.repeat_kv(jnp.asarray(x), n_rep)))


@pytest.mark.parametrize("q_offset,kv_len,window", [
    (0, None, 0),
    (0, None, 5),
    ((3, 0), (9, 6), 0),
    ((3, 0), (9, 6), 4),
    ((10, 2), (14, 8), 3),
])
def test_dense_causal_attention(q_offset, kv_len, window):
    rng = np.random.default_rng(3)
    b, sq, skv, hq, hkv, d = 2, 6, 16, 4, 2, 32
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    qo = np.asarray(q_offset, np.int32)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    got = tc.dense_causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=torch.from_numpy(qo),
        kv_len=None if kl is None else torch.from_numpy(kl),
        sliding_window=window)
    want = jc.dense_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=qo,
        kv_len=kl, sliding_window=window)
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_swiglu_and_linear(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    wg, wu = (0.2 * rng.standard_normal((2, 16, 24))).astype(np.float32)
    wd = (0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    _close(tc.swiglu(T(x), T(wg), T(wu), T(wd), act),
           jc.swiglu(J(x), J(wg), J(wu), J(wd), act))
    _close(tc.linear(T(x), T(wg), T(b)), jc.linear(J(x), J(wg), J(b)))
