#!/usr/bin/env python3
"""Where tensor parallelism's logits part from tp 1's, on one NVIDIA card.

Run from the root of a checkout: ``python3 scripts/tp_logit_gap.py
[OUT.json]`` (default ``build/tp_logit_gap.json``). Llama-3-8B's widths
with random weights from seed 0, a 300-token prompt, TF32 off:

1. first-step logits of tp 1, tp 1 with the prompt in a 1024-row bucket
   (only the GEMMs' M changes) and tp 2 (both shards on the card),
   each as max |diff| over the largest |logit| of tp 1, in bf16 and in
   float32 at 8 and 32 layers;
2. at 4 layers in bf16 and dense attention: the share of each layer's
   outputs that differ between tp 2 and tp 1, and for layer 0's
   matmuls the share of elements that differ between a column slice
   and the full product, between tp 2's float32 partial sums and
   cuBLAS's full bf16 product of a row-parallel matmul, and between
   each and the exact (float32) product rounded to bf16.

Prints the card (name and power limit) and one JSON line per result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def logits(mcfg, params, prompt, buckets, tp) -> torch.Tensor:
    """tp ``tp``'s first-step logits of ``prompt`` (float32, host)."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
    from tpu_inference_torch.parallel import build_mesh

    mesh = build_mesh(cfgs.ParallelConfig(tp=tp)) if tp > 1 else None
    eng = InferenceEngine(mcfg, cfgs.EngineConfig(
        page_size=16, num_pages=64, max_pages_per_seq=128, max_batch_size=8,
        prefill_buckets=buckets), params=params, device="cuda", mesh=mesh)
    seen = []
    unembed = eng.mod.unembed
    mod = eng.mod

    class Spy:
        def __getattr__(self, name):
            return getattr(mod, name)

        def unembed(self, *a, **k):
            x = unembed(*a, **k)
            seen.append(x.float().cpu())
            return x

    eng.mod = Spy()
    seq = Sequence(request_id=0, prompt_tokens=list(prompt),
                   max_new_tokens=2)
    eng.prefill(seq)
    torch.cuda.synchronize()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return seen[-1][0]


def gap_by_depth(prompt) -> dict:
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.models.registry import build_model

    out = {}
    base = (64, 128, 256, 512, 1024)
    for dtype, layers in ((torch.bfloat16, 8), (torch.bfloat16, 32),
                          (torch.float32, 8), (torch.float32, 32)):
        mcfg = dataclasses.replace(cfgs.PRESETS["llama-3-8b"](),
                                   n_layers=layers, dtype=dtype)
        params, _ = build_model(mcfg, seed=0, device="cuda")
        ref = logits(mcfg, params, prompt, base, 1)
        scale = ref.abs().max().item()
        row = {"max_abs_logit": scale}
        for name, buckets, tp in (("tp1_m1024", (1024,), 1),
                                  ("tp2", base, 2)):
            got = logits(mcfg, params, prompt, buckets, tp)
            row[name] = (got - ref).abs().max().item() / scale
        out[f"{str(dtype).replace('torch.', '')} {layers} layers"] = row
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def share(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() != b.float()).float().mean().item()


def where_they_part(prompt) -> dict:
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.models import common, llama
    from tpu_inference_torch.models.registry import build_model
    from tpu_inference_torch.parallel import build_mesh, shard_params
    from tpu_inference_torch.parallel.tp import TPModel

    bf16 = torch.bfloat16
    mcfg = dataclasses.replace(cfgs.PRESETS["llama-3-8b"](), n_layers=4)
    params, mod = build_model(mcfg, seed=0, device="cuda")
    mesh = build_mesh(cfgs.ParallelConfig(tp=2))
    sharded = shard_params(params, mcfg, mesh)
    tp = TPModel(mod, mesh.tp_devices())
    toks = torch.tensor([prompt], device="cuda")
    pos = torch.arange(len(prompt), device="cuda")[None]
    one, two = [], []
    with torch.no_grad():
        mod.forward_hidden(params, mcfg, toks, pos, None,
                           common.make_dense_attn(),
                           on_layer=lambda i, x: one.append(x.clone()))
        tp.forward_hidden(sharded, mcfg, toks, pos, None,
                          common.make_dense_attn(),
                          on_layer=lambda i, x: two.append(x.clone()))
        out = {"layer_outputs_differing": [share(a, b)
                                           for a, b in zip(one, two)]}
        lp = llama.layer_params(params, 0)
        halves = [llama.layer_params(s, 0) for s in sharded.shards]
        h = llama.attn_norm(mcfg, lp, llama.embed_tokens(params, mcfg,
                                                         toks))
        full = common.qdot(h, lp["wq"]).to(bf16)
        part = common.qdot(h, halves[0]["wq"]).to(bf16)
        out["wq_column_slice_vs_full"] = share(
            part, full[..., :part.shape[-1]])
        gen = torch.Generator(device="cuda").manual_seed(1)
        for name, width in (("wo", mcfg.n_heads * mcfg.head_dim),
                            ("w_down", mcfg.d_ff)):
            x = torch.randn((1, len(prompt), width), device="cuda",
                            generator=gen).to(bf16)
            w, half = lp[name], width // 2
            cublas = common.qdot(x, w).to(bf16)
            partial = (common.qdot(x[..., :half], halves[0][name], True)
                       + common.qdot(x[..., half:], halves[1][name], True)
                       ).to(bf16)
            exact = torch.matmul(x.float(), w.float()).to(bf16)
            out[name] = {"tp2_partial_sum_vs_full": share(partial, cublas),
                         "full_vs_exact": share(cublas, exact),
                         "tp2_partial_sum_vs_exact": share(partial, exact)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_logit_gap: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from tpu_inference_torch.kernels import build_kernels
    build_kernels()
    from tpu_inference_torch import config as cfgs
    vocab = cfgs.PRESETS["llama-3-8b"]().vocab_size
    prompt = np.random.default_rng(2).integers(0, vocab, size=300).tolist()
    result = {"card": card, "by_depth": gap_by_depth(prompt),
              "where_they_part": where_they_part(prompt)}
    for key in ("by_depth", "where_they_part"):
        print(json.dumps({key: result[key]}), flush=True)
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        "build", "tp_logit_gap.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
