"""The comparison that decides ``correct`` must fail a broken timed path.

Each test drives the rest of a run at a tiny size on the CPU (the
harness's look for a card skipped): the port's server, the load
generator's child process, the window, the port's state freed, the
reference over a sample. A sound run comes out correct; with a fault
planted in the port underneath it comes out not correct:

- a decode step that returns its state unchanged (no K/V written);
- half of the batch left out (the decode attention dropped for the
  lanes whose context length is odd: half of the lanes of a step, and
  every request on every other step);
- a token altered where it is produced (the sampler's output shifted).

The exchange between chips has no fault here: every cell runs on one
chip. The control (the reference in float8 in the port's place) is held
against the limit at the same size.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import run, spec  # noqa: E402
from h100bench.reference import check  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 99
# Float32 on both sides at this size: the port agrees with the reference
# to ~1e-6 of a logit (test_hb_reference.py); a fault moves logits by
# tenths.
LIMIT = 1e-3


def _cell(name: str, dtype: str = "float32", limit: float = LIMIT):
    cfg = {**spec.read_json(os.path.join(HERE, name + ".json")),
           "torch_dtype": dtype}
    mix = {"loop": "open", "trace": "data/burstgpt_1.csv",
           "max_context": 256, "start_row": 40, "rate_rps": 6.0,
           "ramp_s": 1.0, "sample_min_tokens": 200,
           "sample_max_requests": 4, "logit_gap_limit": limit,
           "logit_gap_stat": "max"}
    return spec.Cell(name="tiny", chips=1, config=cfg, traffic=mix,
                     end_to_end=[], per_layer=[])


def _run(cell, seconds=2.0):
    raw = run.execute(cell, SEED, seconds, False, "cpu")
    return raw, run.judge(cell, SEED, raw, "cpu")


def _state_unchanged(monkeypatch):
    from tpu_inference_torch.engine import kv_cache as kvc
    orig = kvc.write_kv

    def write_kv(kv, layer_idx, k, v, slot):
        return kv if k.shape[1] == 1 else orig(kv, layer_idx, k, v, slot)

    monkeypatch.setattr(kvc, "write_kv", write_kv)


def _half_batch(monkeypatch):
    from tpu_inference_torch.kernels import paged_attention as pa
    orig = pa.paged_attention

    def paged_attention(q, k_pages, v_pages, block_tables, kv_len, *a,
                        **k):
        out = orig(q, k_pages, v_pages, block_tables, kv_len, *a, **k)
        out[kv_len % 2 == 1] = 0
        return out

    monkeypatch.setattr(pa, "paged_attention", paged_attention)


def _token_altered(monkeypatch):
    from tpu_inference_torch.engine import engine
    orig = engine.sample

    def sample(logits, *a, **k):
        return (orig(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample", sample)


@pytest.mark.parametrize("model", ["tiny_mistral", "tiny_mixtral"])
def test_a_sound_run_is_correct(model):
    _, (correct, tried, failed, checks) = _run(_cell(model))
    assert correct, checks
    assert tried > 0 and failed == 0
    assert checks["logit_gap_max"]["value"] <= LIMIT


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_fault_underneath_makes_the_run_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    _, (correct, _, _, checks) = _run(_cell("tiny_mistral"))
    assert not correct
    assert checks["logit_gap_max"]["value"] > 10 * LIMIT


def test_the_float8_control_fails_the_limit_the_bf16_port_keeps():
    """bf16 weights at this size: the port's reading and the control's,
    on one sample of finished requests."""
    cell = _cell("tiny_mistral", dtype="bfloat16")
    raw = run.execute(cell, SEED, 2.0, False, "cpu")
    sample = check.pick_sample(run.finished(raw), SEED, 200, 4)
    got = check.control_gaps(raw["shape"], SEED, sample, "cpu")
    assert got["tokens"] >= 200
    assert got["control_fp8"]["max"] > 3 * got["port"]["max"], got


def test_a_traced_run_reads_every_per_layer_metric(monkeypatch):
    """The --trace 1 path end to end, the CUDA profiler (absent here)
    replaced by a stand-in slice in which the two kernels ran."""
    from h100bench import trace

    slice_ = {"window_s": 1.0, "busy_s": 0.5, "device_ops": [],
              "idle_gaps": [],
              "kernels": {"paged_decode_kernel_mma": 0.2,
                          "paged_prefill_kernel_wgmma": 0.1},
              "launches": {"paged_decode_kernel_mma": 40.0,
                           "paged_prefill_kernel_wgmma": 4.0}}
    monkeypatch.setattr(trace, "profile_slice", lambda s: (object(), 1.0))
    monkeypatch.setattr(trace, "reduce_profile", lambda p, w: slice_)
    bench = spec.read_json(os.path.join(os.path.dirname(HERE),
                                        "..", "BENCHMARK.json"))
    cell = _cell("tiny_mistral")
    cell.per_layer = [m for m in bench["per_layer"]
                      if m["name"].endswith(".serve")]
    raw = run.execute(cell, SEED, 4.0, True, "cpu")
    got = run.metrics(cell, raw, True, "NVIDIA H100 80GB HBM3")
    assert raw["clean"][1] == raw["slice"][0] < raw["window"][1]
    assert {"prefix_hit_share.serve", "decode_call_ms.serve",
            "mfu.decode.serve", "device_idle_share.serve",
            "decode_attn_roofline.serve"} <= set(got)
    assert got["device_idle_share.serve"]["value"] == 50.0
    slowed = run.trace_slowdown(raw)
    assert slowed["decode_steps_per_s_in"] == 40.0 / raw["shape"]["layers"]
