"""Device mesh construction (PyTorch twin of
``tpu_inference/parallel/mesh.py``).

Axes (ParallelConfig): ``dp`` replicates the model, ``tp`` shards
attention heads / FFN hidden / experts / vocab, ``sp`` shards the
sequence (not served yet, ROADMAP 1.16b). The reference's mesh is a grid
of JAX devices that GSPMD compiles one program over; here it is a grid of
``torch.device``s that one process drives shard by shard
(parallel/tp.py).

A documented difference: the default device list wraps onto the visible
cards, ``cuda:{i % device_count}``, as dp replicas already do
(server/replicas.py ``replica_device``), so a tp 2 mesh runs both shards
on a one-card machine, back to back on ``cuda:0``. An explicit list
shorter than the mesh raises, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tpu_inference_torch.config import ParallelConfig

AXES = ("dp", "tp", "sp")


class Mesh:
    """A ``[dp, tp, sp]`` grid of torch devices with named axes."""

    def __init__(self, devices: np.ndarray, axis_names=AXES):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def tp_devices(self, dp_row: int = 0) -> list:
        """The devices of one replica's tp shards, in shard order."""
        return list(self.devices[dp_row, :, 0])



def default_devices(n: int, platform: str = "cuda") -> list:
    """``n`` devices for a mesh: ``cuda:{i % device_count}`` (every shard
    on the one card of a one-card machine), or ``n`` times the CPU."""
    if platform == "cpu":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if not count:
        raise RuntimeError("a CUDA mesh was asked for but no card is "
                           "visible; pass platform='cpu' to build a CPU "
                           "mesh")
    return [torch.device("cuda", i % count) for i in range(n)]


def build_mesh(pcfg: ParallelConfig, devices: Optional[Sequence] = None,
               platform: str = "cuda") -> Mesh:
    """Mesh over the first dp*tp*sp devices, axes ('dp', 'tp', 'sp').

    ``devices`` (torch devices or their names) is taken as given;
    without it the devices wrap onto the visible cards (``platform``
    "cuda") or are all the CPU (``platform`` "cpu"). tp groups are
    contiguous in device order, dp the outermost axis, as in the
    reference."""
    n = pcfg.n_devices
    if devices is None:
        devices = default_devices(n, platform)
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(
            f"mesh needs {n} devices (dp={pcfg.dp} tp={pcfg.tp} "
            f"sp={pcfg.sp}); only {len(devices)} given")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    arr = arr.reshape(pcfg.dp, pcfg.sp, pcfg.tp)
    return Mesh(arr.transpose(0, 2, 1), AXES)
