"""The work that the requests of a span of time carried, from the load
generator's log: what the mfu and roofline readers divide.

Tokens of one request: the first comes from its prefill, token j >= 1
from a decode step that attends over prompt + j keys.

The mfu readers count the work whose tokens arrived in a span of tens of
seconds: a token line is received when the call that produced it has
ended, and the calls that straddle the span's ends are a small share of
it. The roofline readers count a profiled slice of a few seconds, in
which a traced call lasts a second or more, so counting arrivals there
would swing by whole calls. They take the number of decode steps from
the kernels the trace saw run, and the work of one step from the decode
batch that the log shows at instants spread over the slice
(``decode_step_bound_s``).
"""

from __future__ import annotations

import bisect

from h100bench import flops

# Instants of the slice at which the decode batch is read.
STATE_SAMPLES = 64


def decode_kv_lens(log: list, s0: float, s1: float) -> list:
    """The kv length of every decode step whose token arrived in the
    slice."""
    return [r["prompt_tokens"] + j for r in log
            for j, t in enumerate(r["tokens"]) if j >= 1 and s0 <= t < s1]


def prefill_prompts(log: list, s0: float, s1: float) -> list:
    """The prompt length of every request whose first token arrived in
    the slice (the prefix cache's share is not known per request)."""
    return [r["prompt_tokens"] for r in log
            if r["tokens"] and s0 <= r["tokens"][0] < s1]


def decode_flops(shape: dict, log: list, s0: float, s1: float) -> int:
    return sum(flops.decode_flops(shape, n)
               for n in decode_kv_lens(log, s0, s1))


def prefill_flops(shape: dict, log: list, s0: float, s1: float) -> int:
    return sum(flops.prefill_flops(shape, p)
               for p in prefill_prompts(log, s0, s1))


def bound_s(nflops: int, nbytes: int, peak: dict) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    return max(nflops / peak["bf16_flops"], nbytes / peak["hbm_bytes_s"])


def decoding_kv_lens(log: list, t: float) -> list:
    """The kv length of the next decode step of every request decoding
    at ``t``: its first token has arrived by then and its last has not;
    with j tokens received, its next step attends prompt + j keys."""
    out = []
    for r in log:
        ts = r["tokens"]
        if ts and ts[0] <= t < ts[-1]:
            out.append(r["prompt_tokens"] + bisect.bisect_right(ts, t))
    return out


def decode_attn_step_bound_s(shape, log, s0, s1, peak) -> float:
    """The least time one decode step's attention (all layers) needs, as
    a mean over STATE_SAMPLES instants spread over [s0, s1) of the batch
    decoding at each."""
    total = 0.0
    for i in range(STATE_SAMPLES):
        lens = decoding_kv_lens(log, s0 + (i + 0.5) * (s1 - s0)
                                / STATE_SAMPLES)
        total += bound_s(sum(flops.decode_attn_flops(shape, n)
                             for n in lens),
                         sum(flops.decode_attn_bytes(shape, n)
                             for n in lens), peak)
    return total / STATE_SAMPLES
