"""Share (%) of the decode calls' launch wall that the engine thread
spent on the CPU, in the window before the profiled slice: the delta of
the port's tpu_inf_decode_launch_cpu_seconds_total (time.thread_time on
the engine thread) over that of the tpu_inf_decode_launch_seconds sum.
Below 100 the thread was off the CPU while it launched: waiting for the
GIL, descheduled, or blocked in a CUDA call."""

from h100bench.readers import delta


def read(ctx):
    cpu = delta(ctx, "tpu_inf_decode_launch_cpu_seconds_total")
    wall = delta(ctx, "tpu_inf_decode_launch_seconds_sum")
    if cpu is None or not wall:
        return None
    return 100.0 * cpu / wall
