"""The per-layer readers on a made-up context: counters, the roofline,
mfu, idle share, the trace's reduction, and the metric files found by
name."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import flops, readers, spec, trace, work  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PEAK = {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}


def _shape():
    return spec.model_shape(spec.read_json(os.path.join(
        ROOT, "h100bench/configs/mistral-7b-bf16.json")))


def _ctx(**over):
    log = [
        # Answered inside the slice [10, 20).
        {"sent": 11.0, "prompt_tokens": 100, "tokens": [12.0, 13.0, 14.0]},
        # Sent before the slice; its second token arrives after it.
        {"sent": 9.0, "prompt_tokens": 5000, "tokens": [10.5, 25.0]},
    ]
    kernels = {"void paged_decode_kernel_mma<bf16>": 0.5, "gemm": 3.0}
    # 64 runs of the decode kernel: two steps of a 32-layer model.
    launches = {"void paged_decode_kernel_mma<bf16>": 64.0, "gemm": 96.0}
    ctx = {"shape": _shape(), "log": log, "window": (0.0, 30.0),
           "clean": (0.0, 10.0), "slice": (10.0, 20.0), "peak": PEAK,
           "engine": {"decode_steps_per_call": 8},
           "counters": ({"q_sum": 1.0, "q_count": 2.0},
                        {"q_sum": 4.0, "q_count": 5.0}),
           "trace": {"window_s": 10.0, "busy_s": 4.0, "kernels": kernels,
                     "launches": launches}}
    ctx.update(over)
    return ctx


def test_histogram_mean_over_the_clean_span():
    assert readers.hist_mean(_ctx(), "q") == 1.0
    assert readers.hist_mean(_ctx(counters=({}, {"q_count": 0.0})),
                             "q") is None


def test_decoding_batch_is_read_from_the_log_at_an_instant():
    log = _ctx()["log"]
    # At 12.5 the first request has one token and will get two more; the
    # second has one and will get another.
    assert sorted(work.decoding_kv_lens(log, 12.5)) == [101, 5001]
    assert sorted(work.decoding_kv_lens(log, 13.5)) == [102, 5001]
    # At 14.5 the first request is done.
    assert work.decoding_kv_lens(log, 14.5) == [5001]
    assert work.decoding_kv_lens(log, 26.0) == []


def test_decode_roofline_counts_the_steps_the_trace_saw():
    ctx = _ctx(slice=(14.0, 15.0))
    s = ctx["shape"]
    # Over [14, 15) only the long request decodes, at kv length 5001 (the
    # window of 4096 caps what it reads); the trace saw two steps.
    nbytes = flops.decode_attn_bytes(s, 5001)
    assert nbytes == flops.decode_attn_bytes(s, 4096)
    assert readers.decode_steps(ctx, "paged_decode_kernel") == 2.0
    got = readers.roofline(ctx, "paged_decode_kernel",
                           work.decode_attn_step_bound_s)
    expect = 100.0 * 2 * nbytes / PEAK["hbm_bytes_s"] / 0.5
    assert abs(got - expect) < 1e-9


def test_decode_roofline_does_not_swing_with_arrivals_at_the_slice_ends():
    """Tokens that arrive in bursts at the slice's ends change nothing:
    the work is the steps the trace saw times the batch decoding."""
    base = _ctx(slice=(14.0, 15.0))
    late = _ctx(slice=(14.0, 15.0))
    late["log"][1]["tokens"] = [10.5, 14.99, 25.0]
    a = readers.roofline(base, "paged_decode_kernel",
                         work.decode_attn_step_bound_s)
    b = readers.roofline(late, "paged_decode_kernel",
                         work.decode_attn_step_bound_s)
    assert abs(a - b) / a < 0.01


def test_no_kernel_time_or_no_peak_reads_nothing():
    assert readers.roofline(_ctx(trace={"kernels": {}, "window_s": 1,
                                        "busy_s": 1}),
                            "paged_decode_kernel",
                            work.decode_attn_step_bound_s) is None
    assert readers.mfu(_ctx(peak=None), ("decode",)) is None


def test_mfu_counts_the_clean_span_only():
    ctx = _ctx(clean=(0.0, 12.5))
    s = ctx["shape"]
    # Both first tokens (10.5, 12.0) arrived in the span; the first
    # decode token (13.0) did not.
    expect = flops.prefill_flops(s, 5000) + flops.prefill_flops(s, 100)
    got = readers.mfu(ctx, ("decode", "prefill"))
    assert abs(got - 100.0 * expect / (12.5 * PEAK["bf16_flops"])) < 1e-9


def test_decode_mfu_divides_by_the_decode_calls_wall():
    """The open loop's decode mfu: the decode work of the clean span over
    the host wall of the port's decode calls, not over the span."""
    from h100bench import spec as spec_mod

    counters = ({"tpu_inf_decode_dispatches_total": 1.0,
                 "tpu_inf_decode_dispatch_seconds_sum": 0.5,
                 "tpu_inf_decode_sync_seconds_sum": 1.0},
                {"tpu_inf_decode_dispatches_total": 5.0,
                 "tpu_inf_decode_dispatch_seconds_sum": 1.0,
                 "tpu_inf_decode_sync_seconds_sum": 2.5})
    ctx = _ctx(clean=(0.0, 20.0), counters=counters)
    s = ctx["shape"]
    # Decode tokens arrived at 13.0 and 14.0 (request 1: kv 101, 102).
    expect = flops.decode_flops(s, 101) + flops.decode_flops(s, 102)
    assert readers.decode_wall_s(ctx) == 2.0
    got = spec_mod.metric_reader("mfu.decode.serve")(ctx)
    assert abs(got - 100.0 * expect / (2.0 * PEAK["bf16_flops"])) < 1e-9
    assert abs(spec_mod.metric_reader("decode_call_ms.serve")(ctx)
               - 500.0) < 1e-9
    assert spec_mod.metric_reader("mfu.decode.serve")(_ctx()) is None


def test_idle_share():
    assert readers.idle_share(_ctx()) == 60.0


def test_trace_reduction_unions_device_time_and_labels_gaps():
    ev = [("k1", True, 0.0, 1.0), ("k2", True, 0.5, 2.0),
          ("k1", True, 3.0, 4.0), ("cudaStreamSynchronize", False, 2.1,
                                   2.9)]
    r = trace.reduce_events(ev, 5.0)
    assert r["busy_s"] == 3.0
    assert r["kernels"] == {"k1": 2.0, "k2": 1.5}
    assert r["launches"] == {"k1": 2.0, "k2": 1.0}
    assert r["idle_gaps"] == [["cudaStreamSynchronize", 1.0]]
    assert r["device_ops"][0] == ["k1", 2.0]
    # A run cut by the slice's end counts by the share inside it.
    r = trace.reduce_events(ev, 3.5)
    assert r["launches"] == {"k1": 1.5, "k2": 1.0}
    assert trace.kernel_launches(r, "k") == 2.5


def test_every_per_layer_metric_has_a_reader_and_valid_entry():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        moved = next(x for x in bench["end_to_end"]
                     if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_prometheus_text_parses_and_sums_label_sets():
    text = ("# HELP x\n# TYPE x counter\nx_total 3\n"
            'y{kind="a"} 1.5\ny{kind="b"} 2\nh_sum 0.25\nh_count 4\n')
    got = readers.parse_prometheus(text)
    assert got == {"x_total": 3.0, "y": 3.5, "h_sum": 0.25, "h_count": 4.0}
