"""The traffic generator: seeds, the rescaled BurstGPT gaps, clipping."""

import os
import statistics
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import loadgen, spec, traffic  # noqa: E402

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


def _sessions(seed, seconds=51):
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cell = spec.load_cell("mistral7b.sessions",
                          os.path.join(root, "BENCHMARK.json"))
    return cell, traffic.build_plan(cell.traffic, seed, seconds)


def _play(plan, served):
    """Every turn the load generator would send, each turn served
    ``served(turn)`` tokens: (session, turn, prompt, tokens, ids), ids as
    the client sends them and the reference reads them (run.finished)."""
    out = []
    for s in plan["sessions"]:
        context = None
        for k, turn in enumerate(s["turns"]):
            got = loadgen.session_turn(plan, s, k, context)
            if got is None:
                break
            ids = (context or [256]) + list(got[0].encode())
            out.append((s, k, *got, ids))
            context = ids + [31999] * served(turn)
    return out


def test_sessions_plan_same_seed_same_plan_same_schedule_for_every_seed():
    """The seed draws every prompt's bytes; the sessions, their arrivals,
    turns, sizes and think times are the block's, so every seed puts the
    same work in the window."""
    _, a = _sessions(BIG)
    _, b = _sessions(BIG)
    _, c = _sessions(BIG + 1)
    assert a == b and a != c

    def schedule(plan):
        return [(s["due"], s["system"], [
            (len(t["user"]), t["num_predict"], t["think_s"])
            for t in s["turns"]]) for s in plan["sessions"]]
    assert schedule(a) == schedule(c)
    assert a["systems"] != c["systems"]
    w0 = a["window_start"]
    dues = [s["due"] for s in a["sessions"]]
    assert dues == sorted(dues) and dues[0] == 0.0 and w0 in dues
    assert max(dues) < w0 + 51


def test_sessions_share_system_prompts_and_stay_under_the_context():
    cell, plan = _sessions(BIG)
    tr = cell.traffic
    assert len(set(plan["systems"])) == tr["system_prompts"] == 4
    assert all(len(x) == tr["system_tokens"] == 1536
               for x in plan["systems"])
    assert {s["system"] for s in plan["sessions"]} == set(range(4))
    assert all(tr["turns"][0] <= len(s["turns"]) <= tr["turns"][1]
               for s in plan["sessions"])
    for served in (lambda t: 1, lambda t: t["num_predict"]):
        sent = _play(plan, served)
        for s, k, prompt, n, ids in sent:
            user = s["turns"][k]["user"]
            if k == 0:
                assert prompt == (f"system: {plan['systems'][s['system']]}"
                                  f"\nuser: {user}\nassistant:")
            else:
                assert prompt == f"\nuser: {user}\nassistant:"
            assert n == len(ids)
            assert n + s["turns"][k]["num_predict"] <= 8192
        # The window holds a turn whose context passes Mistral's window.
        assert any(s["due"] >= plan["window_start"] and
                   n + s["turns"][k]["num_predict"] > 4096
                   for s, k, _, n, _ in sent)


def test_a_later_turn_continues_the_previous_turns_context():
    """Turn k >= 1 sends the previous final record's context, served ids
    included, and only the transcript's next lines as text."""
    _, plan = _sessions(3)
    s = plan["sessions"][0]
    p0, n0 = loadgen.session_turn(plan, s, 0, None)
    assert n0 == 1 + len(p0.encode())
    context = [256] + list(p0.encode()) + [31999, 300, 4000]
    p1, n1 = loadgen.session_turn(plan, s, 1, context)
    assert p1 == "\nuser: " + s["turns"][1]["user"] + "\nassistant:"
    assert n1 == len(context) + len(p1.encode())
    room = plan["max_context"] - s["turns"][1]["num_predict"] - n1
    assert loadgen.session_turn(plan, s, 1, context + [7] * room) is not None
    assert loadgen.session_turn(plan, s, 1,
                                context + [7] * (room + 1)) is None
