"""Port twin of engine/sampling.py against the JAX reference.

Greedy rows, the top-k/top-p filter and the repetition penalty match the
reference on the same numpy inputs. Sampled rows cannot match jax
threefry bit for bit (the port draws from torch generators); they are
held to reproducibility within the port instead: a seeded row draws the
same token wherever it sits in the batch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_inference.engine import sampling as js
from tpu_inference_torch.engine import sampling as ts


def _sp(temps, top_ps=None, top_ks=None, seeds=None):
    b = len(temps)
    return ts.SamplingParams(
        temperature=torch.tensor(temps, dtype=torch.float32),
        top_p=torch.tensor(top_ps or [1.0] * b, dtype=torch.float32),
        top_k=torch.tensor(top_ks or [0] * b, dtype=torch.int64),
        seed=np.asarray(seeds or [-1] * b))


def _logits(b=4, v=64, seed=0):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 3


def test_greedy_matches_reference():
    lg = _logits()
    got = ts.sample(torch.from_numpy(lg), _sp([0.0] * 4), torch.Generator(),
                    ctx=[0] * 4, all_greedy=True)
    want = js.sample(jnp.asarray(lg), jax.random.PRNGKey(0),
                     js.SamplingParams.greedy(4))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 0, 0, 0], [1.0, 1.0, 1.0, 1.0]),
    ([1, 5, 0, 64], [1.0, 1.0, 1.0, 1.0]),
    ([0, 0, 0, 0], [0.1, 0.5, 0.9, 0.999]),
    ([3, 10, 0, 1], [0.5, 0.8, 0.3, 0.9]),
])
def test_apply_filters_matches_reference(top_k, top_p):
    lg = _logits(seed=1)
    got = ts.apply_filters(torch.from_numpy(lg),
                           torch.tensor(top_k),
                           torch.tensor(top_p, dtype=torch.float32))
    want = js.apply_filters(jnp.asarray(lg), jnp.asarray(top_k, jnp.int32),
                            jnp.asarray(top_p, jnp.float32))
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("penalty,last_n", [
    ([1.0, 1.3, 0.7, 2.0], [64, 64, 64, 64]),
    ([1.5, 1.5, 1.5, 1.5], [0, 3, 10, 200]),
])
def test_apply_repeat_penalty_matches_reference(penalty, last_n):
    rng = np.random.default_rng(2)
    lg = _logits(seed=2)
    window = rng.integers(-1, 64, size=(4, ts.PENALTY_WINDOW)).astype(
        np.int32)
    got = ts.apply_repeat_penalty(
        torch.from_numpy(lg), torch.from_numpy(window),
        torch.tensor(penalty), torch.tensor(last_n))
    want = js.apply_repeat_penalty(jnp.asarray(lg), jnp.asarray(window),
                                   jnp.asarray(penalty, jnp.float32),
                                   jnp.asarray(last_n, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_roll_window_matches_reference():
    w = np.arange(12, dtype=np.int32).reshape(3, 4)
    tok = np.asarray([7, 8, 9], np.int32)
    act = np.asarray([True, False, True])
    got = ts.roll_window(torch.from_numpy(w), torch.from_numpy(tok),
                         torch.from_numpy(act))
    want = js.roll_window(jnp.asarray(w), jnp.asarray(tok), jnp.asarray(act))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_penalized_greedy_matches_reference():
    lg = _logits(seed=3)
    window = np.full((4, ts.PENALTY_WINDOW), -1, np.int32)
    window[:, -1] = lg.argmax(-1)            # penalize each row's argmax
    pen = [1.0, 10.0, 10.0, 10.0]
    got = ts.sample(torch.from_numpy(lg), _sp([0.0] * 4), torch.Generator(),
                    ctx=[0] * 4, all_greedy=True,
                    penalty_window=torch.from_numpy(window),
                    repeat_penalty=torch.tensor(pen),
                    repeat_last_n=torch.full((4,), 64))
    want = js.sample(jnp.asarray(lg), jax.random.PRNGKey(0),
                     js.SamplingParams.greedy(4), ctx=jnp.zeros(4, jnp.int32),
                     penalty_window=jnp.asarray(window),
                     repeat_penalty=jnp.asarray(pen, jnp.float32),
                     repeat_last_n=jnp.full((4,), 64, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mixed_batch_greedy_rows_and_top_k_one():
    """Greedy rows stay argmax inside a sampled batch, and top_k=1 at a
    high temperature is greedy."""
    lg = torch.from_numpy(_logits(seed=4))
    got = ts.sample(lg, _sp([0.0, 1.5, 0.0, 2.0], top_ks=[0, 1, 0, 1]),
                    torch.Generator().manual_seed(1), ctx=[5] * 4,
                    all_greedy=False)
    np.testing.assert_array_equal(got.numpy(), lg.argmax(-1).int().numpy())


def test_seeded_rows_reproduce_across_batch_placement():
    lg = _logits(b=1, v=64, seed=5)[0]
    other = _logits(b=3, v=64, seed=6)
    picks = []
    for place in range(3):
        batch = np.insert(other, place, lg, axis=0)
        seeds = [-1, -1, -1]
        seeds.insert(place, 1234)
        out = ts.sample(torch.from_numpy(batch), _sp([1.0] * 4, seeds=seeds),
                        torch.Generator().manual_seed(place), ctx=[17] * 4,
                        all_greedy=False)
        picks.append(int(out[place]))
    assert picks[0] == picks[1] == picks[2]
    # Another position (or seed) draws from another stream.
    draws = {int(ts.sample(torch.from_numpy(lg[None]),
                           _sp([1.0], seeds=[1234]), torch.Generator(),
                           ctx=[c], all_greedy=False)[0])
             for c in range(20)}
    assert len(draws) > 1


def test_sampling_follows_the_distribution():
    """Unseeded rows draw from softmax(logits / T): frequencies over many
    draws sit within a few standard errors of the probabilities."""
    lg = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    out = ts.sample(lg, _sp([1.0] * 4000), gen, ctx=[0] * 4000,
                    all_greedy=False)
    freq = np.bincount(out.numpy(), minlength=4) / 4000
    p = torch.softmax(lg[0], -1).numpy()
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / 4000) + 1e-3)
