"""Hand-written Hopper kernels (CUDA C++ in csrc/, built with nvcc for
sm_90a, bound through ctypes), one module each, with the plain PyTorch
version beside every kernel. Importing builds nothing; see _build.py.

- paged_attention.paged_attention: paged decode attention.
- prefill_attention.paged_prefill_attention: paged prefill attention.

Each takes a float pool in q's dtype, an int8 pool, or a packed int4
pool (the last two with per-(token, head) scales; _pool.py has the
rules) and counts its launches per pool kind.

ring_attention.py and ulysses_attention.py are not kernels: the
sequence-parallel prefill attention over sp slices in plain PyTorch, as
the reference's are plain JAX with collectives.
"""

# csrc/<name>.cu of every kernel library on the serving path.
KERNEL_SOURCES = ("paged_attention", "prefill_attention")


def build_kernels() -> dict:
    """Build every kernel library (nvcc processes run in parallel) and
    load them; returns {name: build seconds} (0.0 = already built)."""
    from tpu_inference_torch.kernels import _build, paged_attention
    from tpu_inference_torch.kernels import prefill_attention

    secs = _build.build_all(list(KERNEL_SOURCES))
    paged_attention._library()
    prefill_attention._library()
    return secs
