"""Share (%) of the decode calls that replayed a captured CUDA graph, in
the window before the profiled slice: the delta of the port's
tpu_inf_decode_graph_replays_total over that of
tpu_inf_decode_dispatches_total (engine/decode_graphs.py). None on a
program without the counter."""

from h100bench.readers import delta


def read(ctx):
    replays = delta(ctx, "tpu_inf_decode_graph_replays_total")
    calls = delta(ctx, "tpu_inf_decode_dispatches_total")
    if replays is None or not calls:
        return None
    return 100.0 * replays / calls
