"""Pipeline stages: the layer stack split over a ``pp`` axis (PyTorch twin
of ``tpu_inference/parallel/pipeline.py``).

Each stage owns ``n_layers / pp`` consecutive blocks (a slab of the
stacked layer weights) and activations flow stage to stage in a
GPipe-style micro-batch schedule. The reference runs one SPMD program
per stage under ``shard_map``: every stage computes every step, bubbles
are masked, activations move by ``ppermute`` and a ``psum`` combines the
last stage's hidden states. Here one process drives the stages: a loop
over ``n_micro + pp - 1`` steps in which stage s runs its slab on
micro-batch ``t - s`` when that index is in range (bubbles are skipped,
not computed), activations move to the next stage's device with
``Tensor.to``, and on the device the weights already live on a stage's
slab is a view of the stacked tensors, not a copy.

Scope, as in the reference: a full-sequence forward (prefill-shaped)
against the unsharded forward; no serving path uses it.
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models import llama
from tpu_inference_torch.models.common import (make_dense_attn, rms_norm,
                                               rope_tables)
from tpu_inference_torch.models.quant import QuantizedArray
from tpu_inference_torch.parallel.shardings import P


def stage_specs(params: dict) -> dict:
    """Partition specs: blocks split their leading (layer) axis over
    ``pp``; embeddings, norms and the head replicate. A quantized leaf's
    codes and scales take the same spec."""

    def tree(v, spec):
        if isinstance(v, dict):
            return {k: tree(x, spec) for k, x in v.items()}
        return QuantizedArray(spec, spec) if isinstance(
            v, QuantizedArray) else spec

    return {name: tree(sub, P("pp") if name == "blocks" else P())
            for name, sub in params.items()}


def _slab(blocks: dict, lo: int, hi: int, device) -> dict:
    """Layers ``[lo, hi)`` of the stacked blocks on ``device`` (views
    where they already live there)."""
    return {k: v[lo:hi].to(device) for k, v in blocks.items()}


def pp_forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
               positions: torch.Tensor, mesh,
               n_micro: Optional[int] = None) -> torch.Tensor:
    """Pipeline-parallel full-sequence logits, == llama.forward's.

    ``mesh`` has a ``pp`` axis (parallel/mesh.py ``Mesh``); stage s runs
    on its s-th device. tokens/positions: [B, S] on the params' device;
    B must divide into ``n_micro`` micro-batches (default: the pp degree,
    the smallest count that fills the pipe). Steps = n_micro + pp - 1.
    Returns float32 logits [B, S, V] on the params' device."""
    pp = mesh.shape["pp"]
    if cfg.family != "llama":
        raise ValueError(
            f"pp_forward supports the llama family (got {cfg.family!r}); "
            "MoE layer stacks ([L, E, ...] experts) need EP-aware stages")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} % pp {pp} != 0")
    b = tokens.shape[0]
    if n_micro is None:
        n_micro = pp
    if n_micro < 1 or b % n_micro:
        raise ValueError(f"batch {b} % n_micro {n_micro} != 0")
    l_local = cfg.n_layers // pp
    mb = b // n_micro
    attn = make_dense_attn(cfg.sliding_window)
    devices = [torch.device(d) for d in mesh.axis_devices("pp")]
    home = tokens.device
    slabs = [_slab(params["blocks"], s * l_local, (s + 1) * l_local,
                   devices[s]) for s in range(pp)]
    final_w = params["final_norm"].to(devices[-1])

    def run_stage(s: int, x: torch.Tensor, pos: torch.Tensor):
        rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_scaling)
        for i in range(l_local):
            lp = {k: v[i] for k, v in slabs[s].items()}
            x, _ = llama.decoder_block(cfg, s * l_local + i, lp, x, pos,
                                       None, attn, rope=rope)
        return x

    out = [None] * n_micro
    carry = [None] * pp          # each stage's output of the last step
    with torch.no_grad():
        for t in range(n_micro + pp - 1):
            sent = [None] * pp
            for s in range(pp):
                m = t - s        # the micro-batch stage s works on
                if not 0 <= m < n_micro:
                    continue     # a bubble: nothing to compute
                rows = slice(m * mb, (m + 1) * mb)
                if s == 0:
                    x = llama.embed_tokens(params, cfg,
                                           tokens[rows]).to(devices[0])
                else:
                    x = carry[s - 1].to(devices[s])
                x = run_stage(s, x, positions[rows].to(devices[s]))
                if s == pp - 1:
                    h = rms_norm(x, final_w, cfg.norm_eps, cfg.norm_offset)
                    out[m] = h.to(home)
                else:
                    sent[s] = x
            carry = sent
        # The head runs once, on the gathered hidden states (the stages
        # move activation-sized data only).
        return llama.unembed(params, cfg, torch.cat(out, dim=0))
