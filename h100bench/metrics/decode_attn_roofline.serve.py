"""Roofline share (%) of the family's decode kernel (``DECODE_KERNEL`` of
families/<model_type>.py; for Mistral and Mixtral csrc/paged_attention.cu,
symbols paged_decode_kernel*) in the profiled slice: the decode steps
that the trace saw the kernel run (one run a layer a step) times the
least time one step of the batch decoding then needs for attention (each
cached key and value read once, capped by the window; work.py), over the
kernel's device time."""

from h100bench import families, work
from h100bench.readers import roofline


def read(ctx):
    return roofline(ctx, families.of(ctx["shape"]).DECODE_KERNEL,
                    work.decode_attn_step_bound_s)
