"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``
with the cell's own keys over them, ``cells/<cell>.json``) and a seed
in, the requests and when they are due out.

Rows come from the BurstGPT trace (arXiv:2401.17644) copied into
``data/burstgpt_1.csv``: its arrival times and its prompt and reply
lengths. Every seed sends the same set of sizes and arrivals, in another
order: the rows of a fixed block, rotated by an offset drawn from the
seed. Prompts are printable bytes drawn from the seed; the byte
tokenizer makes each byte one token, after a BOS token.

Two loops:

- ``open``: a ramp block, then a window block, each rescaled so that its
  rows arrive at the cell's mean rate (``rate_rps``), the trace's own
  gaps kept in proportion, so the bursts are kept. The window's first
  request is due when the window opens.
- ``closed``: ``clients`` clients, each sending the next row of the
  block (cycled, every prompt drawn afresh) as soon as its reply ends.
"""

from __future__ import annotations

import csv
import os

import numpy as np

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
    ``window_start``; a closed plan gives ``clients``."""
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
    raise ValueError(f"unknown loop {traffic['loop']!r}")
