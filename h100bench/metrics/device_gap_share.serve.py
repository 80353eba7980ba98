"""Share (%) of the window before the profiled slice in which the card
sat between two of the engine's dispatches while a sequence was bound:
the delta of the port's tpu_inf_device_gap_seconds_total (CUDA events
at each dispatch's start and end, engine/engine.py and telemetry.py
DeviceClock) over the span's length. No profiler runs then, so nothing
slows the host loop."""

from h100bench.readers import delta


def read(ctx):
    gap = delta(ctx, "tpu_inf_device_gap_seconds_total")
    a, b = ctx["clean"]
    if gap is None or b <= a:
        return None
    return 100.0 * gap / (b - a)
