"""Parallelism: device mesh, sharding specs (TP/EP), sequence
parallelism, pipeline stages and several processes.

Twin of ``tpu_inference/parallel/``: the reference builds a
``jax.sharding.Mesh``, annotates weights and KV pages with
``NamedSharding``s and lets GSPMD place the collectives. Here the mesh
is a grid of torch devices (mesh.py), ``shard_params`` cuts the weights
into one dict per tp shard (shardings.py), and parallel/tp.py runs the
shards one after another from one Python thread and reduces their
partial sums, which is where GSPMD's all-reduces sit. A replica's sp
slices are the devices its fresh prompts' prefill attention splits over
(kernels/ring_attention.py, kernels/ulysses_attention.py), driven by the
same process. pipeline.py splits the layer stack into stages;
multihost.py joins several processes (``torch.distributed``) and lays
the mesh over all their devices.
"""

from tpu_inference_torch.parallel.mesh import build_mesh
from tpu_inference_torch.parallel.multihost import (
    build_hybrid_mesh,
    initialize,
    process_local_engine_role,
    replica_meshes,
)
from tpu_inference_torch.parallel.pipeline import pp_forward, stage_specs
from tpu_inference_torch.parallel.shardings import (
    kv_sharding,
    param_shardings,
    param_specs,
    shard_params,
    validate_tp,
)

__all__ = [
    "build_mesh",
    "build_hybrid_mesh",
    "initialize",
    "replica_meshes",
    "process_local_engine_role",
    "pp_forward",
    "stage_specs",
    "param_specs",
    "param_shardings",
    "shard_params",
    "kv_sharding",
    "validate_tp",
]
