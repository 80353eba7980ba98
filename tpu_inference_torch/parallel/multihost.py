"""Several processes: the runtime handshake and the mesh over every
process's devices (PyTorch twin of ``tpu_inference/parallel/multihost.py``).

- ``initialize()`` joins the processes with
  ``torch.distributed.init_process_group`` over a TCP store (the twin of
  ``jax.distributed.initialize``) and gathers every process's local
  devices, so each process sees the global device list.
- ``build_hybrid_mesh()`` lays out the mesh as the reference does: dp
  outermost (across slices: hosts or node groups), tp and sp contiguous
  inside a slice, and a replica never straddles a slice boundary.
- ``replica_meshes()`` gives the dp rows this process holds a device of,
  each as a dp-1 ``Mesh`` of torch devices that an engine takes as it
  is; ``process_local_engine_role()`` says what this process contributes.

A device here is a ``Device`` record (``id``, ``process_index``,
``device``, ``slice_index``): a ``torch.device`` names a device of the
process that holds it only, where a JAX device carries its process. The
backend is the caller's explicit choice and nothing switches it: NCCL
refuses two ranks on one card, so two processes sharing the one card of
a one-card machine pass ``"gloo"``.

Failure model, as in the reference: ``init_process_group`` waits for
every process and fails when one is absent; a lost process ends the job,
and recovery is a restart.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from tpu_inference_torch.config import ParallelConfig
from tpu_inference_torch.parallel.mesh import AXES, Mesh, default_devices


@dataclasses.dataclass(frozen=True)
class Device:
    """One device of the global list: its global ``id``, the process
    that holds it, its ``torch.device`` there and its slice."""

    id: int
    process_index: int
    device: torch.device
    slice_index: int = 0


# The handshake's result, set once per process by initialize().
_GLOBAL: Optional[List[Device]] = None


def _torch_dist():
    import torch.distributed as dist
    return dist if dist.is_available() else None


def process_index() -> int:
    dist = _torch_dist()
    return dist.get_rank() if dist and dist.is_initialized() else 0


def process_count() -> int:
    dist = _torch_dist()
    return dist.get_world_size() if dist and dist.is_initialized() else 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               local_devices: Optional[Sequence] = None) -> None:
    """Join the processes. A no-op in a single process (no coordinator
    and at most one process) and on a second call.

    ``coordinator_address`` is ``host:port`` of the TCP store (process 0
    serves it); ``backend`` ("gloo" or "nccl") must be given.
    ``local_devices`` are this process's devices (torch devices or their
    names; default every visible card), gathered from every process into
    the global list with ids in process order."""
    global _GLOBAL
    dist = _torch_dist()
    if dist is not None and dist.is_initialized():
        return
    if coordinator_address is None and (num_processes or 1) == 1:
        return                      # single process: nothing to set up
    if dist is None:
        raise RuntimeError("torch.distributed is not available in this "
                           "build of torch")
    if backend is None:
        raise ValueError("initialize() with several processes needs an "
                         "explicit backend ('gloo' or 'nccl')")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize() needs coordinator_address, "
                         "num_processes and process_id together")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    local = [str(torch.device(d)) for d in (
        local_devices if local_devices is not None
        else default_devices(max(1, torch.cuda.device_count())))]
    names: list = [None] * num_processes
    dist.all_gather_object(names, local)
    out: List[Device] = []
    for p, devs in enumerate(names):
        out += [Device(len(out), p, torch.device(d)) for d in devs]
    _GLOBAL = out


def global_devices(n: Optional[int] = None, platform: str = "cuda"
                   ) -> List[Device]:
    """The global device list: after ``initialize()`` every process's
    devices; in a single process ``n`` devices (default the visible
    cards) wrapping onto the cards as build_mesh's do, ids 0..n-1."""
    if _GLOBAL is not None:
        return list(_GLOBAL)
    if n is None:
        n = 1 if platform == "cpu" else max(1, torch.cuda.device_count())
    return [Device(i, 0, d)
            for i, d in enumerate(default_devices(n, platform))]


def _is_local(d) -> bool:
    """Whether mesh entry ``d`` (a Device or a torch.device, which is
    always this process's own) is held by this process."""
    return not isinstance(d, Device) or d.process_index == process_index()


def build_hybrid_mesh(pcfg: ParallelConfig,
                      devices: Optional[Sequence[Device]] = None,
                      num_slices: Optional[int] = None,
                      platform: str = "cuda") -> Mesh:
    """Mesh of ``Device`` records over several slices: dp outermost, tp
    and sp contiguous within each slice.

    ``num_slices`` defaults to the device list's slice count (1 unless
    the records say otherwise). Requires dp % num_slices == 0: replicas
    never straddle a slice boundary, so the tp reductions and sp moves
    stay inside one."""
    n = pcfg.n_devices
    devs = list(devices if devices is not None
                else global_devices(n, platform))
    if len(devs) < n:
        raise ValueError(f"mesh needs {n} devices; {len(devs)} visible")
    devs = devs[:n]
    if num_slices is None:
        num_slices = len({d.slice_index for d in devs})
    arr = np.empty(n, dtype=object)
    if num_slices > 1:
        if pcfg.dp % num_slices != 0:
            raise ValueError(
                f"dp={pcfg.dp} must be a multiple of num_slices="
                f"{num_slices}: a replica may not straddle a slice")
        arr[:] = sorted(devs, key=lambda d: (d.slice_index, d.id))
    else:
        arr[:] = devs
    arr = arr.reshape(pcfg.dp, pcfg.sp, pcfg.tp)
    return Mesh(arr.transpose(0, 2, 1), AXES)


def replica_meshes(mesh: Mesh) -> list:
    """``[(row_index, submesh), ...]`` for the dp rows holding a device
    of this process: each submesh keeps the axis names, dp at size 1,
    and holds the row's torch devices, so an engine takes it as it is."""
    out = []
    for i in range(mesh.devices.shape[0]):
        row = mesh.devices[i:i + 1]
        if any(_is_local(d) for d in row.flat):
            tdevs = np.empty(row.shape, dtype=object)
            tdevs.flat[:] = [d.device if isinstance(d, Device) else d
                             for d in row.flat]
            out.append((i, Mesh(tdevs, mesh.axis_names)))
    return out


def process_local_engine_role(mesh: Mesh) -> dict:
    """What this process contributes to the mesh: its index and the
    count, its devices in the mesh and whether it holds mesh row 0's
    first device (the row whose process runs the HTTP frontend)."""
    flat = list(mesh.devices.flat)
    return {
        "process_index": process_index(),
        "process_count": process_count(),
        "local_devices_in_mesh": sum(1 for d in flat if _is_local(d)),
        "hosts_frontend": _is_local(flat[0]),
    }
