"""Pipeline stages in the port on the CPU (twins of
tests/test_pipeline.py): the port's ``pp_forward`` against the
reference's on the same weights (carried across by ``params_from_numpy``)
and tokens (a numpy seed), and against the port's own unsharded forward,
within the reference's 1e-4 (abs and rel).

The reference runs its stages over a ``pp`` mesh of the virtual CPU
devices; the port drives them from one process, every stage on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from tpu_inference import config as jcfg
from tpu_inference.models import build_model as j_build
from tpu_inference.models import quant as jq
from tpu_inference.parallel.pipeline import pp_forward as j_pp_forward
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models import llama
from tpu_inference_torch.models.quant import QuantizedArray
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.parallel.mesh import Mesh
from tpu_inference_torch.parallel.pipeline import pp_forward, stage_specs
from tpu_inference_torch.parallel.shardings import P

TOL = dict(atol=1e-4, rtol=1e-4)


def _meshes(pp):
    devs = np.empty(pp, dtype=object)
    devs[:] = [torch.device("cpu")] * pp
    return JMesh(np.array(jax.devices()[:pp]), ("pp",)), Mesh(devs, ("pp",))


def _case(n_layers=2, vocab=128, sliding_window=0, quant="none"):
    """tests/test_pipeline.py's _case in both packages: (port config,
    reference config, reference params, port params, tokens, positions)
    as numpy, [4, 9]."""
    def cfg(mod):
        return dataclasses.replace(mod.tiny_llama(vocab_size=vocab),
                                   n_layers=n_layers,
                                   sliding_window=sliding_window)

    jm, tm = cfg(jcfg), cfg(tcfg)
    params, _ = j_build(jm, seed=0)
    if quant != "none":
        params = jq.quantize_params(params, quant)
    tparams = params_from_numpy(jax.device_get(params), tm, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, (4, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (4, 9)).copy()
    return tm, jm, params, tparams, toks, pos


def _both(case, pp, n_micro=None):
    tm, jm, params, tparams, toks, pos = case
    jmesh, tmesh = _meshes(pp)
    want = np.asarray(j_pp_forward(params, jm, jnp.asarray(toks),
                                   jnp.asarray(pos), jmesh, n_micro=n_micro))
    got = pp_forward(tparams, tm, torch.from_numpy(toks),
                     torch.from_numpy(pos), tmesh, n_micro=n_micro)
    plain, _ = llama.forward(tparams, tm, torch.from_numpy(toks),
                             torch.from_numpy(pos), None,
                             tc.make_dense_attn(tm.sliding_window))
    return got.numpy(), want, plain.numpy()


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (2, 4), (4, 2)])
def test_pp_forward_matches_reference(pp, n_micro):
    """tests/test_pipeline.py:33's twin: fill (n_micro = pp),
    oversubscribed (n_micro > pp) and deep-pipe (pp 4) schedules."""
    got, want, plain = _both(_case(n_layers=4), pp, n_micro)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_pp_forward_swa_dialect():
    """tests/test_pipeline.py:45's twin: the window and micro-batched
    positions compose."""
    got, want, plain = _both(_case(n_layers=2, sliding_window=4), 2, 2)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)


def test_pp_forward_quantized_slabs():
    """tests/test_pipeline.py:55's twin: int8 layer slabs (codes and
    scales) split their layer axis like plain weights; the spec tree
    says so."""
    case = _case(n_layers=2, quant="int8")
    got, want, plain = _both(case, 2)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, plain, **TOL)
    specs = stage_specs(case[3])
    wq = specs["blocks"]["wq"]
    assert isinstance(wq, QuantizedArray) and wq.q == wq.scale == P("pp")
    assert specs["embed"] == P() and specs["final_norm"] == P()


def test_pp_forward_rejects_bad_shapes():
    """tests/test_pipeline.py:72's twin: the reference's checks and
    messages (and its family check)."""
    tm, _, _, tparams, toks, pos = _case(n_layers=2)
    _, mesh = _meshes(2)
    args = (torch.from_numpy(toks), torch.from_numpy(pos), mesh)
    with pytest.raises(ValueError, match="n_layers 3 % pp 2"):
        pp_forward(tparams, dataclasses.replace(tm, n_layers=3), *args)
    with pytest.raises(ValueError, match="batch 4 % n_micro 3"):
        pp_forward(tparams, tm, *args, n_micro=3)
    with pytest.raises(ValueError, match="llama family"):
        pp_forward(tparams, dataclasses.replace(tm, family="mixtral"),
                   *args)
