"""Mean lag (ms) of a token line in the window before the profiled
slice: the delta of the port's tpu_inf_stream_lag_seconds sum over its
count (server/http.py: from the engine thread's stamp of the line's
oldest token to the return of the line's socket write)."""

from h100bench.readers import hist_mean


def read(ctx):
    mean = hist_mean(ctx, "tpu_inf_stream_lag_seconds")
    return None if mean is None else 1000.0 * mean
