"""Several processes in the port on the CPU: the twins of
tests/test_parallel.py's mesh and multihost cases (:175-243) and of
tests/test_multihost_2proc.py:24.

- the hybrid mesh's layout (device ids) equals the reference's over the
  8 virtual CPU devices, single-slice and multi-slice, with the same
  "straddle" refusal; replica meshes split by dp row into dp-1 meshes of
  torch devices an engine takes; ``initialize()`` is a no-op in one
  process and the role dict is the reference's;
- two real processes join through ``initialize(..., backend="gloo")``
  on a TCP store, build the dp 2 x tp 2 hybrid mesh over their four
  devices (two CPU devices each), reduce across both with a gloo
  ``all_reduce``, and each serves its own dp row from the JAX tiny
  llama's weights (written to an ``.npz`` by the parent): their tokens
  equal each other's and the reference oracle's.

This file is also the worker: ``python tests/test_torch_multihost.py
worker <host:port> <n> <rank> <weights.npz>`` prints one JSON line. The
worker imports torch and the port only; JAX is imported inside the tests.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(page_size=8, num_pages=32, max_pages_per_seq=4,
                 max_batch_size=2, prefill_buckets=(16,))
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]
MAX_NEW = 6


def _ids(mesh) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(mesh.devices)


def _ref_ids(pcfg, **kw) -> np.ndarray:
    from tpu_inference import config as jcfg
    from tpu_inference.parallel.multihost import build_hybrid_mesh

    return _ids(build_hybrid_mesh(jcfg.ParallelConfig(**pcfg), **kw))


def _port_mesh(pcfg, **kw):
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.parallel.multihost import build_hybrid_mesh

    return build_hybrid_mesh(tcfg.ParallelConfig(**pcfg), platform="cpu",
                             **kw)


def test_dp_tp_mesh_shapes():
    """tests/test_parallel.py:175's twin: the shape of a dp x tp x sp
    mesh, and a mesh larger than the device list refused."""
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.parallel.multihost import (build_hybrid_mesh,
                                                        global_devices)

    mesh = _port_mesh(dict(dp=2, tp=2, sp=2))
    assert mesh.shape == {"dp": 2, "tp": 2, "sp": 2}
    with pytest.raises(ValueError, match="needs 16 devices"):
        build_hybrid_mesh(tcfg.ParallelConfig(dp=4, tp=4),
                          devices=global_devices(8, "cpu"))


def test_replica_meshes_split():
    """tests/test_parallel.py:182's twin: one dp-1 submesh per dp row,
    the axis names kept, its devices torch devices in the row's order;
    an engine takes one as it is."""
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.parallel.multihost import replica_meshes

    mesh = _port_mesh(dict(dp=2, tp=2, sp=2))
    rows = replica_meshes(mesh)
    assert [i for i, _ in rows] == [0, 1]
    for i, sub in rows:
        assert sub.shape == {"dp": 1, "tp": 2, "sp": 2}
        assert sub.axis_names == mesh.axis_names
        assert list(sub.devices.flat) == [d.device for d in
                                          mesh.devices[i:i + 1].flat]
    eng = InferenceEngine(tcfg.tiny_llama(), tcfg.EngineConfig(**ENGINE_KW),
                          device="cpu", mesh=rows[1][1])
    assert (eng.tp, eng.sp) == (2, 2)


def test_hybrid_mesh_single_slice():
    """tests/test_parallel.py:198's twin: the reference's layout, tp
    groups contiguous in device order."""
    pcfg = dict(dp=2, tp=2, sp=2)
    ids = _ids(_port_mesh(pcfg))
    np.testing.assert_array_equal(ids, _ref_ids(pcfg))
    assert ids[0, 0, 0] + 1 == ids[0, 1, 0]


def test_hybrid_mesh_multi_slice_layout():
    """tests/test_parallel.py:210's twin: dp splits across slices, tp
    never straddles one; the refusal names it."""
    pcfg = dict(dp=2, tp=4, sp=1)
    ids = _ids(_port_mesh(pcfg, num_slices=2))
    np.testing.assert_array_equal(ids, _ref_ids(pcfg, num_slices=2))
    assert set(ids[0].flat) == {0, 1, 2, 3}
    assert set(ids[1].flat) == {4, 5, 6, 7}
    with pytest.raises(ValueError, match="straddle"):
        _port_mesh(dict(dp=1, tp=8), num_slices=2)


def test_multihost_initialize_noop_single_process():
    """tests/test_parallel.py:236's twin: initialize() in one process
    does nothing; the role of a tp 2 mesh is the reference's; several
    processes need an explicit backend."""
    from tpu_inference import config as jcfg
    from tpu_inference.parallel.mesh import build_mesh as j_build_mesh
    from tpu_inference.parallel.multihost import (
        process_local_engine_role as j_role)
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.parallel import build_mesh
    from tpu_inference_torch.parallel.multihost import (
        initialize, process_local_engine_role)

    initialize()
    initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    role = process_local_engine_role(
        build_mesh(tcfg.ParallelConfig(tp=2), platform="cpu"))
    assert role == j_role(j_build_mesh(jcfg.ParallelConfig(tp=2)))
    assert role == {"process_index": 0, "process_count": 1,
                    "local_devices_in_mesh": 2, "hosts_frontend": True}
    with pytest.raises(ValueError, match="explicit backend"):
        initialize("127.0.0.1:1", num_processes=2, process_id=0)


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _unflatten(flat) -> dict:
    out: dict = {}
    for key, arr in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def test_two_process_rendezvous_mesh_and_reduce(tmp_path):
    """tests/test_multihost_2proc.py:24's twin over gloo: both processes
    see 4 global devices and the dp 2 x tp 2 mesh, the all_reduce sums
    all 16 ones, exactly rank 0 hosts the frontend, each serves its own
    row at tp 2 and the tokens are the reference oracle's."""
    import jax
    from tpu_inference.config import EngineConfig, tiny_llama
    from tpu_inference.engine.engine import InferenceEngine as JEngine
    from tpu_inference.models import build_model as j_build

    params, _ = j_build(tiny_llama(), seed=0)
    weights = tmp_path / "tiny_llama.npz"
    np.savez(weights, **_flatten(jax.device_get(params)))
    oracle = JEngine(tiny_llama(), EngineConfig(**ENGINE_KW), params=params)
    want = oracle.generate(PROMPTS, max_new_tokens=MAX_NEW)

    env = dict(os.environ, PYTHONPATH=REPO)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "worker", coord, "2",
         str(pid), str(weights)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                raise AssertionError("rendezvous hung: a worker never "
                                     "finished")
            assert p.returncode == 0, (
                f"worker failed rc={p.returncode}\n{err.decode()[-2000:]}")
            outs.append(json.loads(out.decode().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    for rec in outs:
        assert rec["process_count"] == 2
        assert rec["global_devices"] == 4
        assert rec["mesh_shape"] == {"dp": 2, "tp": 2, "sp": 1}
        assert rec["all_reduce"] == 16.0
        assert rec["role"]["local_devices_in_mesh"] == 2
    assert {r["pid"]: r["role"]["hosts_frontend"] for r in outs} == {
        0: True, 1: False}
    assert sorted(r["replica_row"] for r in outs) == [0, 1]
    assert outs[0]["tokens"] == outs[1]["tokens"] == want


def _worker(coord: str, nproc: int, pid: int, weights: str) -> None:
    """One process of the rendezvous test (see the module docstring)."""
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models.weights import params_from_numpy
    from tpu_inference_torch.parallel import multihost

    for _ in range(2):              # the second call is a no-op
        multihost.initialize(coord, nproc, pid, backend="gloo",
                             local_devices=["cpu", "cpu"])
    mesh = multihost.build_hybrid_mesh(tcfg.ParallelConfig(dp=2, tp=2),
                                       num_slices=2)
    role = multihost.process_local_engine_role(mesh)
    # Every local device holds a 2 x 2 block of ones: the full sum needs
    # the other process's blocks.
    local = sum(torch.ones(2, 2).sum() for d in mesh.devices.flat
                if d.process_index == pid)
    total = local.clone()
    torch.distributed.all_reduce(total)
    rows = multihost.replica_meshes(mesh)
    assert len(rows) == 1, rows
    row, sub = rows[0]
    cfg = tcfg.tiny_llama()
    with np.load(weights) as f:
        params = params_from_numpy(_unflatten(dict(f)), cfg, device="cpu")
    eng = InferenceEngine(cfg, tcfg.EngineConfig(**ENGINE_KW),
                          params=params, device="cpu", mesh=sub)
    tokens = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    print(json.dumps({
        "pid": pid, "process_count": multihost.process_count(),
        "global_devices": len(multihost.global_devices()),
        "mesh_shape": mesh.shape, "all_reduce": float(total),
        "replica_row": row, "tokens": tokens, "role": role}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
