"""End-to-end metrics from the load generator's log, by the host clock.

A request's record (loadgen.py) holds the time it was ``sent``, its
``due`` time in an open loop, the time of every token line received,
whether it is ``done`` and any ``error``. The window is [w0, w1) on the
same clock.

- ``ttft_p50_s``, ``ttft_p90_s``: the median and the p90 of first token
  minus due time, over every request due in the window; the first token
  is waited for past the window's close (the wait counts), and a request
  that failed or never got one ranks above every other. Both are logged
  with each run's window and neither is an end-to-end metric: at the
  ~100 requests a window holds, their spread from run to run is too wide
  for the largest bound the benchmark may set.
- ``tpot_p90_ms``: per request due in the window, (last token received
  in the window - first) / (tokens received in the window - 1), over the
  requests with at least 2 such tokens.
- ``output_tok_s``: every token line received in the window, of every
  request, over the window's seconds.

Percentiles are by nearest rank: the value at rank ceil(q * n).
"""

from __future__ import annotations

import math

INF = float("inf")


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile (0 < q <= 1) of ``values`` by nearest rank; inf
    sorts above every number."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def due_in(log: list, w0: float, w1: float) -> list:
    return [r for r in log if "due" in r and w0 <= r["due"] < w1]


def ttfts(log: list, w0: float, w1: float) -> list:
    return [r["tokens"][0] - r["due"]
            if r["tokens"] and r["error"] is None else INF
            for r in due_in(log, w0, w1)]


def ttft_p50_s(log: list, w0: float, w1: float) -> float:
    """inf where the median falls on a request that never got a token."""
    return nearest_rank(ttfts(log, w0, w1) or [INF], 0.5)


def ttft_p90_s(log: list, w0: float, w1: float) -> float:
    return nearest_rank(ttfts(log, w0, w1) or [INF], 0.9)


def tpots_ms(log: list, w0: float, w1: float) -> list:
    out = []
    for r in due_in(log, w0, w1):
        ts = [t for t in r["tokens"] if t < w1]
        if len(ts) >= 2:
            out.append(1000.0 * (ts[-1] - ts[0]) / (len(ts) - 1))
    return out


def tpot_p90_ms(log: list, w0: float, w1: float) -> float:
    """inf where no request due in the window got two tokens in it."""
    return nearest_rank(tpots_ms(log, w0, w1) or [INF], 0.9)


def output_tok_s(log: list, w0: float, w1: float) -> float:
    n = sum(1 for r in log for t in r["tokens"] if w0 <= t < w1)
    return n / (w1 - w0)


def attempted(log: list, w0: float, w1: float, loop: str) -> list:
    """The requests a run answers for: due in the window (open and
    sessions loops), or sent in it (closed loop)."""
    if loop == "closed":
        return [r for r in log if "sent" in r and w0 <= r["sent"] < w1]
    return due_in(log, w0, w1)


def sessions_in_flight(log: list, t: float) -> int:
    """Sessions whose first turn was due by ``t`` and whose last turn
    sent had not ended by then (its last token, or never), think times
    between turns included."""
    spans: dict = {}
    for r in log:
        if "session" not in r:
            continue
        end = r["tokens"][-1] if r["tokens"] else INF
        a, b = spans.get(r["session"], (INF, -INF))
        spans[r["session"]] = (min(a, r["due"]), max(b, end))
    return sum(1 for a, b in spans.values() if a <= t < b)


def sessions_summary(log: list, w0: float, w1: float, cut: int) -> dict:
    """For the log of a sessions loop: sessions in flight at the ramp's
    midpoint, the window's opening and the window's midpoint (at its
    close, sessions that would send another turn do not); turns due in
    the window by turn index; the longest context due in it; and how many
    sessions ended before a turn that would pass the context."""
    due = due_in(log, w0, w1)
    turns: dict = {}
    for r in due:
        turns[r["turn"]] = turns.get(r["turn"], 0) + 1
    mid_ramp = (min(r["due"] for r in log) + w0) / 2
    return {"sessions_in_flight": [sessions_in_flight(log, t) for t in
                                   (mid_ramp, w0, (w0 + w1) / 2)],
            "turns_due": dict(sorted(turns.items())),
            "longest_context_due": max((r["prompt_tokens"] + r["num_predict"]
                                        for r in due), default=0),
            "sessions_cut": cut}


def lateness(log: list) -> dict:
    """How late the generator sent the open loop's requests (s)."""
    late = [r["sent"] - r["due"] for r in log if "due" in r and "sent" in r]
    if not late:
        return {}
    return {"p50": nearest_rank(late, 0.5), "max": max(late),
            "n": len(late)}


E2E = {"tpot_p90_ms": tpot_p90_ms, "output_tok_s": output_tok_s}
