"""tpu_inference_torch — the PyTorch / CUDA port of tpu_inference.

The JAX package ``tpu_inference/`` is the reference; every module here
has one twin there and is held against it by tests/test_torch_*.py.
This package imports PyTorch and never JAX, and nothing of the
reference package.

- models/   plain-function PyTorch Llama-family model over parameter dicts.
- kernels/  hand-written Hopper kernels (csrc/*.cu) for paged decode and
            paged prefill attention, each with its plain PyTorch version.
- engine/   paged KV pool, bucketed/chunked prefill, K-step decode with
            one host sync per call, sampling, prefix cache, the
            continuous-batching scheduler.
- server/   Ollama /api/generate over the standard library's HTTP server.
- parallel/ the tp mesh, sharding specs and the sharded forward that one
            process drives over every shard (tensor and expert
            parallelism).

Entry points run on CUDA unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
