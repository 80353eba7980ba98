"""The plain reference at a tiny size: its masks, its routing, and its
agreement with the port's plain float32 forward."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import families, spec, weights  # noqa: E402
from h100bench.reference import check, model  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def _shape(name, **over):
    cfg = {**spec.read_json(os.path.join(HERE, name + ".json")), **over}
    return cfg, spec.model_shape(cfg)


def _logits(shape, seed, toks):
    out = {}
    model.forward_logits(shape, seed, [toks], "cpu",
                         on_logits=lambda n, lo, x: out.__setitem__(lo, x))
    return torch.cat([out[k] for k in sorted(out)])


def _toks(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (n,), generator=g).tolist()


def test_causal_mask_a_later_token_changes_no_earlier_logit():
    _, s = _shape("tiny_mixtral")
    a = _toks(40)
    b = a[:30] + _toks(10, seed=1)
    la, lb = _logits(s, 3, a), _logits(s, 3, b)
    assert torch.equal(la[:30], lb[:30])
    assert not torch.equal(la[30:], lb[30:])


def test_window_a_query_sees_itself_and_window_minus_one_before():
    _, s = _shape("tiny_mistral", sliding_window=8)
    torch.manual_seed(0)
    q = torch.randn(20, 4, 16)
    k = torch.randn(20, 2, 16)
    v = torch.randn(20, 2, 16)
    out = model.attention(q, k, v, window=8)
    k2, v2 = k.clone(), v.clone()
    k2[11], v2[11] = 100.0, 100.0     # 8 behind query 19: outside
    assert torch.allclose(model.attention(q, k2, v2, 8)[19], out[19])
    k2[12], v2[12] = 100.0, 100.0     # 7 behind: inside
    assert not torch.allclose(model.attention(q, k2, v2, 8)[19], out[19])
    # Without a window every earlier key counts.
    full = model.attention(q, k, v, window=0)
    assert not torch.allclose(full[19], out[19])
    assert torch.allclose(full[5], out[5])


def test_top2_routing_weights_sum_to_one_and_pick_the_largest():
    torch.manual_seed(0)
    x = torch.randn(50, 32)
    w = torch.randn(32, 8)
    idx, wts = families.load("mixtral").route(x, w, 2)
    assert torch.allclose(wts.sum(-1), torch.ones(50))
    logits = x @ w
    assert torch.equal(idx, logits.topk(2, dim=-1).indices)
    assert (wts[:, 0] >= wts[:, 1]).all()


def test_fp8_rounding_keeps_three_mantissa_bits():
    torch.manual_seed(0)
    x = torch.randn(64, 256)
    r = model._fp8_rows(x, dim=-1)
    rel = ((r - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel < 2**-4


@pytest.mark.parametrize("name", ["tiny_mistral", "tiny_mixtral"])
def test_reference_agrees_with_the_ports_plain_float32_forward(name):
    from h100bench import port
    from tpu_inference_torch.models import common, llama, mixtral

    cfg, s = _shape(name)
    mcfg = port.model_config(cfg)
    params = weights.port_params(s, 5, "cpu")
    toks = _toks(150)
    mod = {"llama": llama, "mixtral": mixtral}[mcfg.family]
    got, _ = mod.forward(params, mcfg, torch.tensor([toks]),
                         torch.arange(150)[None], None,
                         common.make_dense_attn(s["window"]))
    ref = _logits(s, 5, toks)
    assert (got[0] - ref).abs().max() < 1e-5


def test_weights_made_again_layer_by_layer_equal_the_ports():
    _, s = _shape("tiny_mixtral")
    params = weights.port_params(s, 9, "cpu")
    for i in range(s["layers"]):
        for k, v in weights.layer_weights(s, 9, i, "cpu").items():
            assert torch.equal(params["blocks"][k][i], v)
    assert torch.equal(params["lm_head"],
                       weights.top_weights(s, 9, "cpu")["lm_head"])


def test_served_tokens_that_are_the_references_own_read_no_gap():
    _, s = _shape("tiny_mistral")
    prompt = _toks(30)
    gen, ctx = [], list(prompt)
    for _ in range(12):                     # greedy from the reference
        nxt = int(_logits(s, 4, ctx)[-1].argmax())
        gen.append(nxt)
        ctx.append(nxt)
    sample = [{"prompt_ids": prompt, "generated": gen}]
    got = check.reference_gaps(s, 4, sample, "cpu")
    assert got["gaps"] == [0.0] * 12
    assert got["summary"] == {"max": 0.0, "mean": 0.0, "mismatch_share": 0.0}
    gen[5] = (gen[5] + 1) % 512
    got = check.reference_gaps(s, 4, sample, "cpu")
    assert got["gaps"][5] > 0 and got["summary"]["mismatch_share"] >= 1 / 12


def test_the_bf16_witness_and_the_fp8_control_round_the_products():
    w = torch.randn(64, 32)
    x = torch.randn(5, 64)
    exact = model.Linear(w, "fp32")(x)
    assert torch.equal(exact, x @ w)
    for precision, tol in (("bf16", 2**-6), ("fp8", 2**-2)):
        got = model.Linear(w, precision)(x)
        err = ((got - exact).abs().max() / exact.abs().max()).item()
        assert 0 < err < tol, (precision, err)


def test_pick_sample_takes_the_longest_then_draws_from_the_seed():
    reqs = [{"prompt_ids": [0] * p, "generated": [1] * g}
            for p, g in ((10, 5), (500, 40), (20, 30), (30, 30), (5, 90))]
    a = check.pick_sample(reqs, 1, min_tokens=60, max_requests=3)
    assert a[0] is reqs[1]
    assert check.pick_sample(reqs, 1, 60, 3) == a
    assert len(check.pick_sample(reqs, 1, 10_000, 3)) == 3
