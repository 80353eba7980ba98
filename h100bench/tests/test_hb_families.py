"""Model families are found by ``model_type``: a configuration without
one fails when it is loaded, and a family unlike Mistral and Mixtral
(tests/families/toy_mla_moe.py: a dense first layer, then expert layers
with shared experts, a latent cache) runs through the weights, the
reference in all three precisions and the flops count from its own file
alone."""

import json
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import families, flops, spec, weights  # noqa: E402
from h100bench.reference import check, model  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setattr(families, "DIRS",
                        [os.path.join(HERE, "families"), *families.DIRS])
    cfg = spec.read_json(os.path.join(HERE, "toy_mla_moe.json"))
    return cfg, spec.model_shape(cfg)


def _logits(s, seed, toks, precision="fp32"):
    out = {}
    model.forward_logits(s, seed, [toks], "cpu", precision=precision,
                         on_logits=lambda n, lo, x: out.__setitem__(lo, x))
    return torch.cat([out[k] for k in sorted(out)])


def _toks(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (n,), generator=g).tolist()


@pytest.mark.parametrize("name, family", [
    ("mistral-7b-bf16", "mistral"), ("mixtral-8x7b-bf16-16l", "mixtral")])
def test_each_configuration_finds_its_family_by_model_type(name, family):
    cfg = spec.read_json(os.path.join(ROOT, "h100bench/configs",
                                      name + ".json"))
    assert spec.model_shape(cfg)["family"] == family
    assert families.of_config(cfg) is families.load(family)


def test_a_model_type_with_no_family_fails_when_loaded(tmp_path):
    cfg = {**spec.read_json(os.path.join(HERE, "tiny_mistral.json")),
           "model_type": "no_such_model"}
    with pytest.raises(LookupError, match="h100bench/families/"
                                          "no_such_model.py"):
        spec.model_shape(cfg)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    bench = spec.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"][0]["file"] = "cfg.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"] == bench["configs"][0]["name"])
    with pytest.raises(LookupError, match="no_such_model.py"):
        spec.load_cell(cell, str(tmp_path / "BENCHMARK.json"))


def test_toy_weights_stack_by_the_familys_groups(toy):
    _, s = toy
    params = weights.port_params(s, 7, "cpu")
    assert set(params) == {"embed", "final_norm", "lm_head",
                           "dense_blocks", "blocks"}
    assert params["dense_blocks"]["w_gate"].shape == (1, 64, 128)
    assert params["blocks"]["w_gate"].shape == (2, 8, 64, 32)
    assert "w_router" not in params["dense_blocks"]
    for key, layers in families.of(s).port_groups(s):
        for j, i in enumerate(layers):
            for n, v in weights.layer_weights(s, 7, i, "cpu").items():
                assert torch.equal(params[key][n][j], v), (key, i, n)


def test_toy_reference_is_causal_in_every_precision(toy):
    _, s = toy
    a = _toks(40)
    b = a[:30] + _toks(10, seed=1)
    ref = _logits(s, 3, a)
    for precision, lo, hi in (("fp32", 0, 0), ("bf16", 1e-4, 0.05),
                              ("fp8", 1e-3, 0.5)):
        la, lb = _logits(s, 3, a, precision), _logits(s, 3, b, precision)
        assert torch.equal(la[:30], lb[:30]) and \
            not torch.equal(la[30:], lb[30:])
        err = ((la - ref).abs().max() / ref.abs().max()).item()
        assert lo <= err <= hi, (precision, err)


def test_toy_gaps_read_nothing_for_the_references_own_tokens(toy):
    _, s = toy
    prompt, gen = _toks(20), []
    for _ in range(8):
        gen.append(int(_logits(s, 4, prompt + gen)[-1].argmax()))
    got = check.control_gaps(s, 4, [{"prompt_ids": prompt,
                                     "generated": gen}], "cpu")
    assert got["port"]["max"] == 0.0 and got["tokens"] == 8
    assert got["control_fp8"]["max"] >= got["witness_bf16"]["max"] >= 0


def test_toy_costs_sum_dense_and_expert_layers_and_a_latent_cache(toy):
    _, s = toy
    attn = 64 * 4 * 24 + 64 * 40 + 32 * 4 * 32 + 4 * 16 * 64
    dense = attn + 3 * 64 * 128
    sparse = attn + 3 * 64 * 32 * (2 + 1) + 64 * 8
    pair = 2 * 4 * 24 + 2 * 4 * 16
    kv, qo = 2 * (32 + 8), 2 * 4 * (24 + 16)       # not 2 x heads x dim
    assert flops.matmul_params(s) == dense + 2 * sparse
    assert flops.decode_attn_bytes(s, 100) == 3 * (kv * 100 + qo)
    assert flops.decode_attn_flops(s, 100) == 3 * pair * 100
    assert flops.decode_flops(s, 100) == \
        2 * (dense + 2 * sparse + 64 * 512) + 3 * pair * 100
    assert flops.prefill_flops(s, 10, cached=4) == (
        2 * 6 * (dense + 2 * sparse) + 3 * pair * (5 + 6 + 7 + 8 + 9 + 10)
        + 2 * 64 * 512)
