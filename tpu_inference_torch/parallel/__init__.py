"""Parallelism: device mesh + sharding specs (TP/EP), driven by one
process.

Twin of ``tpu_inference/parallel/``: the reference builds a
``jax.sharding.Mesh``, annotates weights and KV pages with
``NamedSharding``s and lets GSPMD place the collectives. Here the mesh
is a grid of torch devices (mesh.py), ``shard_params`` cuts the weights
into one dict per tp shard (shardings.py), and parallel/tp.py runs the
shards one after another from one Python thread and reduces their
partial sums, which is where GSPMD's all-reduces sit. Only tp (and EP,
over the same axis) is served; sp and several processes are ROADMAP
1.16b.
"""

from tpu_inference_torch.parallel.mesh import build_mesh
from tpu_inference_torch.parallel.shardings import (
    kv_sharding,
    param_shardings,
    param_specs,
    shard_params,
    validate_tp,
)

__all__ = [
    "build_mesh",
    "param_specs",
    "param_shardings",
    "shard_params",
    "kv_sharding",
    "validate_tp",
]
