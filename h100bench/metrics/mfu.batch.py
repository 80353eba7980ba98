"""The bf16 peak's share (%) that the work of the window before the
profiled slice needs: the prefills and decode steps whose tokens
arrived then (work.py, flops.py, active parameters only), over its
seconds. In a closed loop every slot is kept busy, so the work that a
window holds is what the port gets through."""

from h100bench.readers import mfu


def read(ctx):
    return mfu(ctx, ("decode", "prefill"))
