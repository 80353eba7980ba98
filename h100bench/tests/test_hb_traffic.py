"""The traffic generator: seeds, the rescaled BurstGPT gaps, clipping."""

import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import spec, traffic  # noqa: E402

BIG = 2**31 + 12345


def _mix(name):
    return spec.load_cell(name, os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "BENCHMARK.json")).traffic


def test_same_seed_same_requests_other_seed_other_requests():
    for name in ("mistral7b.chat", "mixtral8x7b.batch"):
        mix = _mix(name)
        a = traffic.build_plan(mix, BIG, 30)
        b = traffic.build_plan(mix, BIG, 30)
        c = traffic.build_plan(mix, BIG + 1, 30)
        assert a == b
        assert [r["prompt"] for r in a["requests"]] != \
            [r["prompt"] for r in c["requests"]]


def test_every_seed_sends_the_same_sizes_in_another_order():
    mix = _mix("mistral7b.chat")
    plans = [traffic.build_plan(mix, s, 30) for s in (1, 2, BIG)]
    sizes = [sorted((r["prompt_tokens"], r["num_predict"])
                    for r in p["requests"]) for p in plans]
    assert sizes[0] == sizes[1] == sizes[2]
    orders = [[r["prompt_tokens"] for r in p["requests"]] for p in plans]
    assert orders[0] != orders[1] or orders[1] != orders[2]


def test_open_window_holds_its_rate_and_starts_on_time():
    mix = {**_mix("mistral7b.chat"), "rate_rps": 5.0, "ramp_s": 10}
    plan = traffic.build_plan(mix, 7, 30)
    due = [r["due"] for r in plan["requests"]]
    assert due == sorted(due)
    window = [d for d in due if d >= plan["window_start"]]
    assert len(window) == 150 and min(window) == plan["window_start"]
    assert max(window) < plan["window_start"] + 30


def test_rescaled_gaps_keep_their_coefficient_of_variation():
    t, _, _ = traffic.read_trace(os.path.join(traffic.HERE,
                                              "data/burstgpt_1.csv"))
    gaps = traffic.gaps_of(t, 1000, 400)
    scaled = traffic.rescale(gaps, 80.0)
    cv = statistics.pstdev(gaps) / statistics.mean(gaps)
    cv_scaled = statistics.pstdev(scaled) / statistics.mean(scaled)
    assert abs(cv - cv_scaled) < 1e-9
    assert abs(scaled.sum() - 80.0) < 1e-9
    assert cv > 1.0                  # the trace is burstier than Poisson


def test_prompts_clip_to_the_context():
    p, q, n = traffic.clip_lengths(np.array([8192, 100, 1]),
                                   np.array([52, 2048, 0]), 8192)
    assert (p + q <= 8192).all() and p.min() >= 2 and q.min() >= 1
    assert n == 1 and p[0] == 8140


def test_prompts_are_printable_bytes_of_the_right_length():
    plan = traffic.build_plan(_mix("mistral7b.chat"), 3, 10)
    for r in plan["requests"]:
        assert len(r["prompt"]) == r["prompt_tokens"] - 1
        assert all(32 <= ord(c) < 127 for c in r["prompt"])


def test_chat_window_reaches_past_the_sliding_window():
    """At the benchmark's run_seconds the chat cell's window holds a
    request whose context passes Mistral's 4096-token window, so the
    windowed prefill and decode run in it and the sample can take them."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    bench = spec.read_json(os.path.join(root, "BENCHMARK.json"))
    cell = spec.load_cell("mistral7b.chat",
                          os.path.join(root, "BENCHMARK.json"))
    window = int(cell.config["sliding_window"])
    for seed in (1, BIG):
        plan = traffic.build_plan(cell.traffic, seed, bench["run_seconds"])
        longest = max(r["prompt_tokens"] + r["num_predict"]
                      for r in plan["requests"]
                      if r["due"] >= plan["window_start"])
        assert longest > window
