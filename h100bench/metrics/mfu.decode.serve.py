"""The bf16 peak's share (%) of the port's decode steps while they run:
the operations that the decode steps whose tokens arrived in the window
before the profiled slice need (flops.py, active parameters only), over
the host wall of the fused decode calls in that span
(tpu_inf_decode_dispatch_seconds + tpu_inf_decode_sync_seconds). Over
the window's seconds it would read the offered rate, which an open loop
below its knee fixes."""

from h100bench.readers import decode_wall_s, mfu


def read(ctx):
    wall = decode_wall_s(ctx)
    if wall is None:
        return None
    return mfu(ctx, ("decode",), wall)
