"""Host wall (ms) of one fused decode call in the window before the
profiled slice: the deltas of the port's
tpu_inf_decode_dispatch_seconds and tpu_inf_decode_sync_seconds sums
over that of tpu_inf_decode_dispatches_total (engine/engine.py)."""

from h100bench.readers import decode_wall_s, delta


def read(ctx):
    wall = decode_wall_s(ctx)
    if wall is None:
        return None
    return 1000.0 * wall / delta(ctx, "tpu_inf_decode_dispatches_total")
