"""Share (%) of the window before the profiled slice that bound decode
lanes spent stalled behind prefill dispatches: the delta of the port's
tpu_inf_decode_stall_during_prefill_seconds sum (the wall of each
prefill dispatch, batched, single or one chunk, that ran while decode
lanes were bound; engine/engine.py) over the span's length."""

from h100bench.readers import delta


def read(ctx):
    stall = delta(ctx, "tpu_inf_decode_stall_during_prefill_seconds_sum")
    a, b = ctx["clean"]
    if stall is None or b <= a:
        return None
    return 100.0 * stall / (b - a)
