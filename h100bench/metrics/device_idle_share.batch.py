"""Share (%) of the profiled slice in which no operation ran on the card:
1 minus the union of the device's kernel, copy and set intervals over
the slice's length."""

from h100bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
