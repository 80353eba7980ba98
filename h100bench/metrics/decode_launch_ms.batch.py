"""Host wall (ms) of the launch of one decode call in the window before
the profiled slice: the delta of the port's
tpu_inf_decode_launch_seconds sum over its count (engine/engine.py:
from the call's entry until its last operation, the readback copy, is
queued, before the host blocks on it). decode_call_ms less this is the
wait on the card."""

from h100bench.readers import hist_mean


def read(ctx):
    mean = hist_mean(ctx, "tpu_inf_decode_launch_seconds")
    return None if mean is None else 1000.0 * mean
