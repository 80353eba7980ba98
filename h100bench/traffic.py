"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``
with the cell's own keys over them, ``cells/<cell>.json``) and a seed
in, the requests and when they are due out.

Rows come from the BurstGPT trace (arXiv:2401.17644) copied into
``data/burstgpt_1.csv``: its arrival times and its prompt and reply
lengths. Every seed sends the same set of sizes and arrivals, in another
order: the rows of a fixed block, rotated by an offset drawn from the
seed. Prompts are printable bytes drawn from the seed; the byte
tokenizer makes each byte one token, after a BOS token.

Three loops:

- ``open``: a ramp block, then a window block, each rescaled so that its
  rows arrive at the cell's mean rate (``rate_rps``), the trace's own
  gaps kept in proportion, so the bursts are kept. The window's first
  request is due when the window opens.
- ``closed``: ``clients`` clients, each sending the next row of the
  block (cycled, every prompt drawn afresh) as soon as its reply ends.
- ``sessions``: multi-turn chat sessions arriving as a Poisson process
  at ``sessions_per_s``, a ramp block and a window block as in the open
  loop. Each opens with one of ``system_prompts`` shared system prompts
  of ``system_tokens`` tokens and has ``turns`` [lo, hi] turns, uniform;
  each turn is the next row of the block: its prompt length is the user
  message's, its reply length the turn's ``num_predict``. A turn is
  sent ``think_mean_s`` (exponential mean) after the previous reply
  ended, continuing the previous turn's context, so with the whole
  history, served replies included (loadgen.py ``session_turn``); a
  session ends before a turn that would pass ``max_context``. The
  sessions, their arrivals, turns, sizes, system prompts and think times
  are fixed by the block (``start_row``); the seed draws the bytes of
  every prompt. Rotating the sessions, as the open loop rotates its
  rows, would change which turns fall inside the window, and with them
  the window's work.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from h100bench import loadgen

HERE = os.path.dirname(os.path.abspath(__file__))
PRINTABLE = (32, 127)
# Closed-loop plans hold this many requests; a run sends what it can.
CLOSED_PLAN_REQUESTS = 4096


def read_trace(path: str) -> tuple:
    """(arrival seconds, prompt tokens, reply tokens) of every row."""
    with open(path) as f:
        rows = list(csv.DictReader(f))
    t = np.array([float(r["Timestamp"]) for r in rows])
    p = np.array([int(r["Request tokens"]) for r in rows])
    q = np.array([int(r["Response tokens"]) for r in rows])
    return t, p, q


def gaps_of(t: np.ndarray, lo: int, n: int) -> np.ndarray:
    """The n gaps after rows lo..lo+n-1 of the trace (the last row of the
    block takes the gap to the row after it)."""
    return np.diff(t[lo:lo + n + 1])


def rescale(gaps: np.ndarray, span: float) -> np.ndarray:
    """``gaps`` scaled so they sum to ``span``: the mean rate changes,
    the coefficient of variation does not."""
    total = float(gaps.sum())
    if total <= 0:
        return np.full(len(gaps), span / len(gaps))
    return gaps * (span / total)


def rotation(seed: int, salt: int, n: int) -> int:
    return int(np.random.default_rng([int(seed), salt]).integers(n))


def clip_lengths(prompt: np.ndarray, reply: np.ndarray,
                 max_context: int) -> tuple:
    """Prompt tokens (BOS included, at least 2) and reply tokens (at
    least 1), the prompt clipped so that prompt + reply <= max_context;
    and how many prompts were clipped."""
    reply = np.clip(reply, 1, max_context - 2)
    prompt = np.maximum(prompt, 2)
    clipped = prompt + reply > max_context
    prompt = np.where(clipped, max_context - reply, prompt)
    return prompt, reply, int(clipped.sum())


def prompt_text(rng: np.random.Generator, n_tokens: int) -> str:
    """``n_tokens - 1`` printable bytes (the BOS token makes n)."""
    return rng.integers(*PRINTABLE, size=n_tokens - 1,
                        dtype=np.uint8).tobytes().decode("ascii")


def _requests(prompt, reply, due, seed: int) -> list:
    rng = np.random.default_rng([int(seed), 7])
    out = []
    for i, (p, q) in enumerate(zip(prompt.tolist(), reply.tolist())):
        r = {"id": i, "prompt": prompt_text(rng, p), "prompt_tokens": p,
             "num_predict": q}
        if due is not None:
            r["due"] = float(due[i])
        out.append(r)
    return out


def build_plan(traffic: dict, seed: int, seconds: float) -> dict:
    """The requests of one run: ``{"loop", "requests", ...}``. An open
    plan gives each request ``due`` (seconds after the plan starts) and
    ``window_start``; a closed plan gives ``clients``; a sessions plan
    gives ``sessions`` in place of requests (each with its ``due``, its
    system prompt's index into ``systems`` and its ``turns``) and
    ``window_start``."""
    t, p, q = read_trace(os.path.join(HERE, traffic["trace"]))
    start = int(traffic["start_row"])
    max_ctx = int(traffic["max_context"])
    if traffic["loop"] == "open":
        rate = float(traffic["rate_rps"])
        ramp = float(traffic["ramp_s"])
        n_r = max(1, round(rate * ramp))
        n_w = max(1, round(rate * seconds))
        idx, due = [], []
        for salt, (lo, n, t0, span) in enumerate(
                ((start, n_r, 0.0, ramp), (start + n_r, n_w, ramp, seconds))):
            k = rotation(seed, salt, n)
            rows = np.roll(np.arange(lo, lo + n), -k)
            g = np.roll(rescale(gaps_of(t, lo, n), span), -k)
            idx.append(rows)
            due.append(t0 + np.concatenate([[0.0], np.cumsum(g)[:-1]]))
        idx = np.concatenate(idx)
        prompt, reply, clipped = clip_lengths(p[idx], q[idx], max_ctx)
        return {"loop": "open", "window_start": ramp, "rows": idx.tolist(),
                "clipped": clipped,
                "requests": _requests(prompt, reply, np.concatenate(due),
                                      seed)}
    if traffic["loop"] == "closed":
        n = int(traffic["block_rows"])
        k = rotation(seed, 0, n)
        block = np.roll(np.arange(start, start + n), -k)
        idx = np.resize(block, CLOSED_PLAN_REQUESTS)
        prompt, reply, clipped = clip_lengths(p[idx], q[idx], max_ctx)
        return {"loop": "closed", "clients": int(traffic["clients"]),
                "rows": block.tolist(), "clipped": clipped,
                "requests": _requests(prompt, reply, None, seed)}
    if traffic["loop"] == "sessions":
        return _sessions_plan(traffic, seed, seconds, p, q)
    raise ValueError(f"unknown loop {traffic['loop']!r}")


# The rate key of each loop that offers load at a fixed rate.
RATE_KEYS = {"open": "rate_rps", "sessions": "sessions_per_s"}


def _sessions_plan(traffic: dict, seed: int, seconds: float, p, q) -> dict:
    """The sessions of a ramp block and a window block, with prompt bytes
    drawn from ``seed``."""
    rate = float(traffic["sessions_per_s"])
    ramp = float(traffic["ramp_s"])
    lo_turns, hi_turns = (int(x) for x in traffic["turns"])
    n_sys = int(traffic["system_prompts"])
    max_ctx = int(traffic["max_context"])
    text_rng = np.random.default_rng([int(seed), 7])
    systems = [prompt_text(text_rng, int(traffic["system_tokens"]) + 1)
               for _ in range(n_sys)]
    row = int(traffic["start_row"])
    sessions, rows, clipped = [], [], 0
    for salt, (n, t0, span) in enumerate(
            ((max(1, round(rate * ramp)), 0.0, ramp),
             (max(1, round(rate * seconds)), ramp, seconds))):
        fixed = np.random.default_rng([int(traffic["start_row"]), 11, salt])
        turns = fixed.integers(lo_turns, hi_turns + 1, size=n)
        system = fixed.integers(0, n_sys, size=n)
        think = fixed.exponential(float(traffic["think_mean_s"]),
                                  size=(n, hi_turns))
        gaps = rescale(fixed.exponential(1.0, size=n), span)
        block = []
        for i in range(n):
            idx = np.arange(row, row + turns[i])
            row += turns[i]
            rows += idx.tolist()
            user, reply, _ = clip_lengths(p[idx], q[idx], max_ctx)
            first = loadgen.prompt_tokens(loadgen.chat_transcript(
                [("system", systems[system[i]]), ("user", "")]))
            room = max_ctx - int(reply[0]) - first
            clipped += int(user[0] > room)
            user[0] = max(1, min(int(user[0]), room))
            block.append({"system": int(system[i]), "turns": [
                {"user": prompt_text(text_rng, int(u) + 1),
                 "num_predict": int(r), "think_s": float(think[i, k])}
                for k, (u, r) in enumerate(zip(user, reply))]})
        due = t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        for j, sess in enumerate(block):
            sessions.append({"id": len(sessions), "due": float(due[j]),
                             **sess})
    return {"loop": "sessions", "window_start": ramp,
            "max_context": max_ctx, "systems": systems,
            "sessions": sessions, "rows": rows, "clipped": clipped}


def describe(plan: dict) -> str:
    """One line on what a plan sends, for the run's log."""
    if plan["loop"] == "sessions":
        return (f"sessions loop, {len(plan['sessions'])} sessions of "
                f"{sum(len(s['turns']) for s in plan['sessions'])} turns, "
                f"{plan['clipped']} first prompts clipped to the context")
    return (f"{plan['loop']} loop, {len(plan['requests'])} requests, "
            f"{plan['clipped']} prompts clipped to the context")
