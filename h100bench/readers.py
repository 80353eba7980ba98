"""What the per-layer metric readers (``metrics/<name>.py``) share.

A reader is ``read(ctx) -> float | None``; None when it finds nothing to
read, and the metric is then left out of the result line. ``ctx`` holds:

- ``shape``: the model's sizes (spec.model_shape);
- ``log``: the load generator's requests (loadgen.py);
- ``window``: (w0, w1), ``slice``: (s0, s1), the profiled slice, and
  ``clean``: (w0, s0), the window before the slice (the whole window in
  a run with no slice), on the monotonic clock;
- ``counters``: the port's ``/metrics`` read at both ends of ``clean``,
  each a {name: value} dict (label sets summed);
- ``trace``: trace.reduce_profile's numbers over the slice;
- ``peak``: the card's peaks (peaks.py), or None;
- ``engine``: the engine settings the run used.

A share is in percent.
"""

from __future__ import annotations

from h100bench import trace as tr
from h100bench import work


def parse_prometheus(text: str) -> dict:
    """{metric name: value} of a Prometheus text page, label sets summed
    (histograms give ``<name>_sum`` and ``<name>_count``)."""
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, _, value = line.rpartition(" ")
        name = head.split("{", 1)[0]
        try:
            out[name] = out.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return out


def delta(ctx: dict, name: str):
    before, after = ctx["counters"]
    if name not in after:
        return None
    return after[name] - before.get(name, 0.0)


def hist_mean(ctx: dict, name: str):
    """Mean of the observations a histogram took over the window."""
    n, s = delta(ctx, f"{name}_count"), delta(ctx, f"{name}_sum")
    if not n:
        return None
    return s / n


def decode_wall_s(ctx: dict):
    """Host wall (s) of the port's fused decode calls over the counters'
    span: the deltas of tpu_inf_decode_dispatch_seconds and
    tpu_inf_decode_sync_seconds (engine/engine.py); None with no call."""
    if not delta(ctx, "tpu_inf_decode_dispatches_total"):
        return None
    return ((delta(ctx, "tpu_inf_decode_dispatch_seconds_sum") or 0.0)
            + (delta(ctx, "tpu_inf_decode_sync_seconds_sum") or 0.0))


def mfu(ctx: dict, parts: tuple, seconds=None):
    """The bf16 peak's share (%) that the work of ``parts`` ("decode",
    "prefill") whose tokens arrived in ``clean`` needs over ``seconds``
    (by default the length of ``clean``)."""
    if ctx.get("peak") is None:
        return None
    fns = {"decode": work.decode_flops, "prefill": work.prefill_flops}
    a, b = ctx["clean"]
    n = sum(fns[p](ctx["shape"], ctx["log"], a, b) for p in parts)
    if seconds is None:
        seconds = b - a
    if n == 0 or not seconds:
        return None
    return 100.0 * n / (seconds * ctx["peak"]["bf16_flops"])


def decode_steps(ctx: dict, kernel: str):
    """Decode steps the card ran in the profiled slice: the runs of
    ``kernel``, launched once a layer a step."""
    if ctx.get("trace") is None:
        return None
    return tr.kernel_launches(ctx["trace"], kernel) / ctx["shape"]["layers"]


def roofline(ctx: dict, kernel: str, step_bound_fn):
    """The bound time of the slice's work for ``kernel`` over the device
    time of the kernels whose name holds ``kernel`` (%): the decode steps
    the card ran in the slice times the bound of one step of the batch
    decoding then (work.py)."""
    if ctx.get("trace") is None or ctx.get("peak") is None:
        return None
    spent = tr.kernel_seconds(ctx["trace"], kernel)
    bound = decode_steps(ctx, kernel) * step_bound_fn(
        ctx["shape"], ctx["log"], *ctx["slice"], ctx["peak"])
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def idle_share(ctx: dict):
    t = ctx.get("trace")
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
