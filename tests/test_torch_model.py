"""Port forward against tpu_inference.models.llama.forward: the
reference's random weights carried across by params_from_numpy, the same
token ids through both, float32 logits within 1e-4."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import randomize_qkv_biases
from tpu_inference import config as jcfg
from tpu_inference.models import build_model as j_build
from tpu_inference.models import common as jc
from tpu_inference.models import llama as jl
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models import llama as tl
from tpu_inference_torch.models.registry import build_model, get_model_fns
from tpu_inference_torch.models.weights import params_from_numpy


def _llama31(cfgmod):
    """tiny-llama with the Llama-3.1 rope rescale binding at test scale."""
    return dataclasses.replace(
        cfgmod.tiny_llama(), name="tiny-llama31",
        rope_scaling=cfgmod.RopeScaling(original_max_len=16))


PRESETS = {
    "tiny-llama": lambda m: m.tiny_llama(),
    "tiny-qwen2": lambda m: m.tiny_qwen2(),
    "tiny-gemma": lambda m: m.tiny_gemma(),
    "tiny-mistral": lambda m: m.tiny_mistral(),
    "tiny-llama31": _llama31,
}


@pytest.mark.parametrize("name", list(PRESETS))
def test_forward_logits_match_reference(name):
    jm, tm = PRESETS[name](jcfg), PRESETS[name](tcfg)
    params, _ = j_build(jm, seed=0)
    if jm.qkv_bias:
        randomize_qkv_biases(params)
    tp = params_from_numpy(jax.device_get(params), tm, device="cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 80                      # past tiny-mistral's 64-token window
    tokens = rng.integers(0, jm.vocab_size, size=(b, s)).astype(np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, _ = jl.forward(params, jm, jnp.asarray(tokens), jnp.asarray(pos),
                         None, jc.make_dense_attn(jm.sliding_window))
    got, _ = tl.forward(tp, tm, torch.from_numpy(tokens),
                        torch.from_numpy(pos.copy()), None,
                        tc.make_dense_attn(tm.sliding_window))
    assert got.dtype == torch.float32 and got.shape == (b, s, jm.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_init_params_layout_matches_reference():
    """Same tree, shapes and dtypes as the reference's init (values come
    from a torch generator, so they differ)."""
    cfg_j, cfg_t = jcfg.tiny_qwen2(), tcfg.tiny_qwen2()
    ref = jax.device_get(jl.init_params(cfg_j, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    port = tl.init_params(cfg_t, gen, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    assert shapes(port) == shapes(ref)
    w = port["blocks"]["wq"]
    assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 2e-3
    again = tl.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], port["embed"])


def test_build_model_on_cpu_is_deterministic():
    a, mod = build_model(tcfg.tiny_llama(), seed=3, device="cpu")
    b, _ = build_model(tcfg.tiny_llama(), seed=3, device="cpu")
    assert mod is tl
    assert all(torch.equal(a["blocks"][k], b["blocks"][k])
               for k in a["blocks"])
