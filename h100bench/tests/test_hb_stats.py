"""The end-to-end arithmetic: percentiles, and stalls in the window."""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import stats  # noqa: E402


def _req(due, tokens, error=None):
    return {"due": due, "sent": due, "tokens": tokens, "error": error,
            "done": False}


def test_nearest_rank():
    xs = list(range(1, 11))
    assert stats.nearest_rank(xs, 0.9) == 9
    assert stats.nearest_rank(xs, 0.5) == 5
    assert stats.nearest_rank([3.0], 0.9) == 3.0


def test_a_request_with_no_token_counts_as_the_worst():
    log = [_req(i, [i + 0.1]) for i in range(9)]
    log.append(_req(9.5, []))
    ts = stats.ttfts(log, 0, 10)
    assert math.isinf(max(ts))
    assert stats.nearest_rank(ts, 1.0) == math.inf
    # Nine answered at 0.1 s: the p90 lands on them, the worst is above.
    assert abs(stats.ttft_p90_s(log, 0, 10) - 0.1) < 1e-9
    log[0]["error"] = "HTTP 503"
    assert stats.ttft_p90_s(log, 0, 10) == math.inf
    for r in log[1:4]:
        r["tokens"] = []
    assert abs(stats.ttft_p50_s(log, 0, 10) - 0.1) < 1e-9
    log[4]["tokens"] = []
    assert stats.ttft_p50_s(log, 0, 10) == math.inf


def test_requests_due_outside_the_window_are_not_counted():
    log = [_req(-1.0, [5.0]), _req(1.0, [1.5]), _req(10.0, [10.1])]
    assert stats.ttfts(log, 0, 10) == [0.5]


def test_a_stall_in_the_window_shows_in_rate_and_gaps():
    steady = [_req(0.0, [0.1 * k for k in range(100)])]   # 10 tok/s
    stalled = [_req(0.0, [0.1 * k for k in range(50)]
                    + [4.9 + 3.0 + 0.1 * k for k in range(1, 21)])]
    w = (0.0, 10.0)
    assert stats.output_tok_s(steady, *w) == 10.0
    assert stats.output_tok_s(stalled, *w) == 7.0
    assert abs(stats.tpot_p90_ms(steady, *w) - 100.0) < 1e-6
    # 69 gaps: 68 of 0.1 s and one of 3.1 s.
    expect = 1000.0 * (0.1 * 68 + 3.1) / 69
    assert abs(stats.tpot_p90_ms(stalled, *w) - expect) < 1e-6


def test_tokens_after_the_window_are_left_out():
    log = [_req(0.0, [1.0, 2.0, 3.0, 11.0, 12.0])]
    assert stats.output_tok_s(log, 0, 10) == 0.3
    assert abs(stats.tpot_p90_ms(log, 0, 10) - 1000.0) < 1e-9


def test_closed_loop_attempts_are_the_requests_sent_in_the_window():
    log = [{"sent": 1.0, "tokens": [], "error": None},
           {"sent": 11.0, "tokens": [], "error": None},
           {"tokens": [], "error": None}]
    assert len(stats.attempted(log, 0, 10, "closed")) == 1


def test_sessions_in_flight_span_think_times_and_the_window_counts_turns():
    def turn(session, k, due, tokens, prompt=100, n=10):
        return {**_req(due, tokens), "session": session, "turn": k,
                "prompt_tokens": prompt, "num_predict": n}
    log = [turn(0, 0, 1.0, [1.5, 2.0]), turn(0, 1, 4.0, [4.5, 6.0]),
           turn(1, 0, 3.0, [3.5, 9.0], prompt=5000, n=100),
           turn(2, 0, 7.0, [])]                     # never answered
    assert [stats.sessions_in_flight(log, t) for t in (0.5, 3.0, 5.0,
                                                       6.5, 9.5)] == \
        [0, 2, 2, 1, 1]
    got = stats.sessions_summary(log, 3.5, 10.0, cut=1)
    assert got["turns_due"] == {0: 1, 1: 1}
    assert got["longest_context_due"] == 110
    assert got["sessions_cut"] == 1
    assert stats.attempted(log, 3.5, 10.0, "sessions") == log[1:2] + log[3:]
