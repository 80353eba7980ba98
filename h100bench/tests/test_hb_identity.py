"""The existing configurations read the same through the model families
as they did before them, to the last bit: the port's ModelConfig, the
weights' leaves and layout, the weights themselves, the reference's
logits in float32, the bf16 witness and the float8 control, the gaps
judged from them, every flops and bytes figure, and the mfu and
roofline readers on a made-up context. ``parent_readings.json`` holds
the readings of the harness before families/ existed; each test makes
them again by the same calls.

Full-size weights are not made here: their leaves, layout and per-layer
seeds are compared, and the values at test size.

Torch runs on one thread while a test computes: with several, the CPU's
float32 products come out in another order now and then.
"""

import dataclasses
import hashlib
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import families, flops, port, spec, weights  # noqa: E402
from h100bench.reference import check, model  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(os.path.dirname(HERE), "configs")
PARENT = spec.read_json(os.path.join(HERE, "parent_readings.json"))
REAL = ("mistral-7b-bf16", "mixtral-8x7b-bf16-16l")
TINY = [f"{n}.{dt}" for n in ("tiny_mistral", "tiny_mixtral")
        for dt in ("float32", "bfloat16")]
SEEDS = (5, 2**31 + 99)
KV = (1, 2, 100, 1000, 4095, 4096, 4097, 6000, 8191, 8192)
PROMPTS = ((1, 0), (2, 0), (17, 0), (500, 0), (4096, 0), (5000, 0),
           (5000, 16), (6000, 2048), (8000, 4096), (300, 299))


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config(name):
    if name in REAL:
        return spec.read_json(os.path.join(CONFIGS, name + ".json"))
    base, dt = name.split(".")
    return {**spec.read_json(os.path.join(HERE, base + ".json")),
            "torch_dtype": dt}


def _digest(items):
    h = hashlib.sha256()
    for name, t in items:
        t = t.detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _flat(tree, pre=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], pre + k + "/")
        else:
            yield pre + k, tree[k]


def _toks(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 512, (n,), generator=g).tolist()


@pytest.mark.parametrize("name", [*REAL, *TINY])
def test_the_ports_model_config_is_the_parents(name):
    mc = dataclasses.asdict(port.model_config(_config(name)))
    got = {k: v if isinstance(v, (int, float, str, bool, type(None)))
           else repr(v) for k, v in mc.items()}
    assert got == PARENT["port_config"][name]


@pytest.mark.parametrize("name", [*REAL, *TINY])
def test_leaves_and_the_ports_layout_are_the_parents(name):
    s = spec.model_shape(_config(name))
    want = PARENT["leaves"][name]
    for i in range(s["layers"]):
        got = [[n, list(sh), d] for n, sh, d in weights.layer_leaves(s, i)]
        assert got == want["layer"], i
    assert [[n, list(sh), d] for n, sh, d in weights.top_leaves(s)] == \
        want["top"]
    layout = {n: list(sh) for n, sh, _ in weights.top_leaves(s)}
    for key, layers in families.of(s).port_groups(s):
        assert layers == list(range(s["layers"]))
        layout.update({f"{key}/{n}": [len(layers), *sh]
                       for n, sh, _ in weights.layer_leaves(s, layers[0])})
    assert layout == want["port_layout"]


@pytest.mark.parametrize("name", TINY)
@pytest.mark.parametrize("seed", SEEDS)
def test_weights_are_the_parents(name, seed):
    s = spec.model_shape(_config(name))
    layers = [(f"{i}/{k}", v) for i in range(s["layers"])
              for k, v in sorted(weights.layer_weights(s, seed, i,
                                                       "cpu").items())]
    assert PARENT["weights"][f"{name}/{seed}"] == {
        "port": _digest(_flat(weights.port_params(s, seed, "cpu"))),
        "layers": _digest(layers),
        "top": _digest(sorted(weights.top_weights(s, seed, "cpu").items()))}


@pytest.mark.parametrize("name", TINY)
@pytest.mark.parametrize("precision", ["fp32", "bf16", "fp8"])
def test_reference_logits_are_the_parents(name, precision):
    s = spec.model_shape(_config(name))
    got = []
    model.forward_logits(s, 5, [_toks(150, 1), _toks(40, 2)], "cpu",
                         precision=precision,
                         on_logits=lambda n, lo, x: got.append(
                             (f"{n}/{lo}", x)))
    assert _digest(got) == PARENT["logits"][f"{name}/{precision}"]


@pytest.mark.parametrize("name", TINY)
def test_the_gaps_of_port_control_and_witness_are_the_parents(name):
    s = spec.model_shape(_config(name))
    a, b = _toks(160, 3), _toks(60, 4)
    sample = [{"prompt_ids": a[:120], "generated": a[120:]},
              {"prompt_ids": b[:20], "generated": b[20:]}]
    assert check.control_gaps(s, 5, sample, "cpu") == PARENT["gaps"][name]


@pytest.mark.parametrize("name", [*REAL, *TINY])
def test_flops_and_bytes_are_the_parents(name):
    s = spec.model_shape(_config(name))
    assert PARENT["flops"][name] == {
        "decode_flops": [flops.decode_flops(s, n) for n in KV],
        "decode_attn_flops": [flops.decode_attn_flops(s, n) for n in KV],
        "decode_attn_bytes": [flops.decode_attn_bytes(s, n) for n in KV],
        "prefill_flops": [flops.prefill_flops(s, p, c) for p, c in PROMPTS],
    }


def _synthetic_ctx(shape):
    g = torch.Generator().manual_seed(11)
    log = []
    for _ in range(60):
        p = int(torch.randint(2, 7000, (1,), generator=g))
        t0 = float(torch.rand(1, generator=g)) * 40
        n = int(torch.randint(1, 300, (1,), generator=g))
        log.append({"sent": t0 - 0.2, "prompt_tokens": p,
                    "tokens": [t0 + 0.013 * j for j in range(n)]})
    kernel = "void paged_decode_kernel_mma<bf16>"
    before = {"tpu_inf_decode_dispatches_total": 10.0,
              "tpu_inf_decode_dispatch_seconds_sum": 1.0,
              "tpu_inf_decode_sync_seconds_sum": 2.0}
    after = {"tpu_inf_decode_dispatches_total": 300.0,
             "tpu_inf_decode_dispatch_seconds_sum": 4.5,
             "tpu_inf_decode_sync_seconds_sum": 9.25}
    return {"shape": shape, "log": log, "window": (0.0, 40.0),
            "clean": (0.0, 24.0), "slice": (24.0, 28.0),
            "peak": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
            "engine": {"decode_steps_per_call": 8},
            "counters": (before, after),
            "trace": {"window_s": 4.0, "busy_s": 3.0,
                      "kernels": {kernel: 0.5, "gemm": 3.0},
                      "launches": {kernel: 64.0 * shape["layers"],
                                   "gemm": 96.0}}}


@pytest.mark.parametrize("name", REAL)
def test_mfu_and_roofline_readings_are_the_parents(name):
    ctx = _synthetic_ctx(spec.model_shape(_config(name)))
    got = {m: spec.metric_reader(m)(ctx) for m in PARENT["readers"][name]}
    assert got == PARENT["readers"][name]
