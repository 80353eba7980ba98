"""Greedy decode calls as captured CUDA graphs, replayed from static
device inputs.

An eager decode call launches about 50 kernels a layer a step from
Python, and on the card the host's launch rate, not the kernels, sets
its pace. ``DecodeGraphs`` captures the whole K-step call once per
(ladder rung, steps per call) at warm-up: the K-step loop, every layer's
forward with the paged decode kernel (its ctypes launcher runs on the
capturing stream), the unembedding, the greedy argmax, the
``where``/``alive``/``ctx`` carry and the stacked outputs. A call then
costs one packed host-to-device copy and one graph launch. All of an
engine's graphs share one memory pool.

Which calls replay is decided from what the engine can observe, with no
switch of its own (``bar`` and ``call_bar``): the kernel attention
backend, the forward on one device (tp 1), no draft-model rounds, the
NaN check off, and staging arrays that say all-greedy with no
repetition penalty. Those calls compute only the argmax of the logits,
so the graph holds no sampling state and no random number generator.
Every other call runs the engine's eager ``_decode_loop``, which is the
same loop the graphs captured: a replay runs the same kernels in the
same order on the same values.

Static inputs (``_Inputs``): per rung, one int32 device buffer holds
``tokens, ctx, allowed, eos`` and the block tables; a ring of host
buffers (pinned on the card) holds the next calls' values, so the host
never rewrites one whose copy is still queued. A carry token already on
the device (an in-flight call's last tokens) is copied device to device
over the tokens after the packed copy. The outputs of a replay are
cloned at once: the next replay of any graph of the pool may overwrite
them while an older in-flight call still needs its carry.

On the CPU, ``EagerReplay`` stands in for ``torch.cuda.CUDAGraph``: its
replay re-runs the captured body on the static buffers, so the tests
drive this module's whole path.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_inference_torch.engine import numerics
from tpu_inference_torch.engine.sampling import sample
from tpu_inference_torch.kernels import paged_attention as pa


def bar(engine) -> Optional[str]:
    """Why no decode call of ``engine`` can replay a graph, or None."""
    if engine.attn_backend != "kernel":
        return f"attention backend {engine.attn_backend!r} (dense gather)"
    if engine.mesh is not None:
        return f"the forward is sharded over tp {engine.tp} devices"
    if engine.spec_draft:
        return "draft-model speculation (every decode call is a spec round)"
    return None


def call_bar(st: dict) -> Optional[str]:
    """Why the decode call staged in ``st`` runs eager, or None: a
    sampled row (a seeded one draws from a generator per row on the
    host), a repetition penalty, or ``--debug-nans`` (its checks sync on
    the host)."""
    if numerics.debug_nans():
        return "debug-nans"
    if not bool(np.all(np.asarray(st["temps"]) <= 0.0)):
        return "sampled rows"
    if bool(np.any(np.asarray(st["rpens"]) != 1.0)):
        return "repetition penalty"
    return None


_graph_launch = None


def _cu_graph_launch():
    """libcuda's ``cuGraphLaunch``, called with the interpreter lock
    held (``ctypes.PyDLL``). ``CUDAGraph.replay`` releases the lock for
    the launch; a profiler stopping on another thread meanwhile (its
    ``_disable_profiler`` holds the lock) deadlocked against the launch
    in flight in 2 of 14 traced benchmark runs (H100, torch 2.11 with
    CUDA 12.8). Holding the lock keeps the two apart. The graphs hold no
    random number state, so ``replay``'s generator prologue has nothing
    to do."""
    global _graph_launch
    if _graph_launch is None:
        import ctypes
        lib = ctypes.PyDLL("libcuda.so.1")
        lib.cuGraphLaunch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.cuGraphLaunch.restype = ctypes.c_int
        _graph_launch = lib.cuGraphLaunch
    return _graph_launch


class _CudaGraph:
    """One captured call on the card. The paged decode kernel's launches
    inside the capture are recorded, not counted; each replay counts
    them again (kernels/paged_attention.py ``count_launches``)."""

    def __init__(self, device: torch.device, pool, stream):
        self.device, self.pool, self.stream = device, pool, stream
        self.graph = self.out = self.launches = self.exec = None

    def capture(self, body: Callable):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream), pa.recording() as launches:
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                self.out = body()
            finally:
                graph.capture_end()
        self.graph, self.launches = graph, collections.Counter(launches)
        self.exec = graph.raw_cuda_graph_exec()

    def replay(self):
        with torch.cuda.device(self.device):
            err = _cu_graph_launch()(
                self.exec, torch.cuda.current_stream(self.device).cuda_stream)
        if err:
            raise RuntimeError(f"cuGraphLaunch failed (CUresult {err})")
        pa.count_launches(self.launches)
        return self.out


class EagerReplay:
    """``CUDAGraph``'s part here on the CPU: capture keeps the body and
    replay runs it again on the static buffers, leaving its results in
    the same output tensors every time, as a graph's replay does."""

    def __init__(self):
        self.body = self.out = None

    def capture(self, body: Callable):
        self.body = body
        self.out = tuple(t.clone() for t in body())

    def replay(self):
        for out, got in zip(self.out, self.body()):
            out.copy_(got)
        return self.out


class _Inputs:
    """A rung's static device inputs and the host ring that fills them."""

    def __init__(self, b: int, max_pages: int, device: torch.device,
                 ring: int):
        n = b * (4 + max_pages)
        self.b = b
        self.dev = torch.zeros((n,), dtype=torch.int32, device=device)
        self.tokens, self.ctx, self.allowed, self.eos = (
            self.dev[i * b:(i + 1) * b] for i in range(4))
        self.bts = self.dev[4 * b:].view(b, max_pages)
        cuda = device.type == "cuda"
        self.host = [torch.zeros((n,), dtype=torch.int32, pin_memory=cuda)
                     for _ in range(ring)]
        # An event not yet recorded synchronizes at once.
        self.copied = [torch.cuda.Event() if cuda else None
                       for _ in range(ring)]
        self.next = 0

    def load(self, st: dict) -> None:
        """Queue ``st``'s values into the device buffer: one packed copy
        from the next host buffer of the ring (waiting first, should
        its previous copy still be queued), then a device-to-device copy
        of the tokens when they already sit on the device."""
        i, b = self.next, self.b
        self.next = (i + 1) % len(self.host)
        if self.copied[i] is not None:
            self.copied[i].synchronize()
        h = self.host[i].numpy()
        tok = st["tokens"]
        on_device = isinstance(tok, torch.Tensor)
        if not on_device:
            h[:b] = tok
        h[b:2 * b] = st["ctx"]
        h[2 * b:3 * b] = st["allowed"]
        h[3 * b:4 * b] = st["eos"]
        h[4 * b:] = np.asarray(st["bts"]).reshape(-1)
        self.dev.copy_(self.host[i], non_blocking=True)
        if self.copied[i] is not None:
            self.copied[i].record()
        if on_device:
            self.tokens.copy_(tok)


class DecodeGraphs:
    """The captured greedy decode calls of one engine, by (rung, K)."""

    def __init__(self, engine, graph_type=None):
        self.engine = engine
        self.graph_type = graph_type
        self.graphs: Dict[Tuple[int, int], object] = {}
        self.inputs: Dict[int, _Inputs] = {}
        self.replays: Dict[Tuple[int, int], int] = {}
        self.pool_bytes = 0
        self.capture_s = 0.0

    @torch.no_grad()
    def capture(self, shapes: List[Tuple[int, int]]) -> None:
        """Capture one graph per (rung, K) of ``shapes``. On the card,
        each rung's call first runs once eagerly on the capturing stream
        (the library handles, workspaces and the decode kernel's split
        counters of that stream exist before capture; the largest rung
        first, so the counters are sized once), with every lane still:
        all writes land on the trash page."""
        eng, dev = self.engine, self.engine.device
        t0 = time.perf_counter()
        ring = max(2, eng.engine_cfg.decode_pipeline_depth + 1)
        for b in sorted({b for b, _ in shapes}, reverse=True):
            self.inputs[b] = _Inputs(b, eng.max_pages, dev, ring)
        cuda = self.graph_type is None
        if cuda:
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(dev)
            torch.cuda.synchronize(dev)
            # Warm-up has counted these shapes' launches already.
            with torch.cuda.stream(stream), pa.recording():
                for inp in self.inputs.values():
                    self._body(inp, 1)()
            torch.cuda.synchronize(dev)
            reserved = torch.cuda.memory_reserved(dev)
            make = lambda: _CudaGraph(dev, pool, stream)  # noqa: E731
        else:
            make = self.graph_type
        for b, k in sorted(shapes, reverse=True):
            graph = make()
            graph.capture(self._body(self.inputs[b], k))
            self.graphs[(b, k)] = graph
            self.replays[(b, k)] = 0
        if cuda:
            torch.cuda.synchronize(dev)
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.capture_s = time.perf_counter() - t0

    def _body(self, inp: _Inputs, k: int) -> Callable:
        def body():
            outs, final, _ = self.engine._decode_loop(
                inp.tokens, inp.ctx, inp.bts, inp.allowed, inp.eos, k,
                _greedy, nan_checks=False)
            return outs, final
        return body

    def run(self, st: dict, k_steps: int):
        """Replay the (rung, K) graph on ``st``'s values: (outs [K, B],
        final carry tokens [B], None), cloned off the pool; None when no
        graph was captured for that shape (the caller runs eager)."""
        key = (len(st["ctx"]), k_steps)
        graph = self.graphs.get(key)
        tel = self.engine.telemetry
        if graph is None:
            tel.decode_graph_eager.inc()
            return None
        self.inputs[key[0]].load(st)
        outs, final = graph.replay()
        self.replays[key] += 1
        tel.decode_graph_replays.inc()
        return outs.clone(), final.clone(), None


def _greedy(logits: torch.Tensor, step: int, win) -> torch.Tensor:
    """``sample`` of an all-greedy batch with no penalty: the argmax,
    with no sampling parameter, generator or position read."""
    del step, win
    return sample(logits, None, None, None, all_greedy=True)
