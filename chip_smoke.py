#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
failing loudly (any failure exits non-zero before the result line):

1. device: require CUDA; print the card's name and power limit.
2. build: compile every kernel of the serving path from
   tpu_inference_torch/csrc/ with nvcc (in parallel), print build times.
3. kernels: each kernel variant (bf16 and float32 pools, int8 pools,
   packed int4 pools) against its plain PyTorch version on the card at
   the main path's shapes (Llama-3-8B: Hq 32, Hkv 8, D 128, page 16,
   batch 8, and the decode ladder's batch 16 and 32; a sliding-window
   case; float32-q cases; tolerance in check_close), with the kernel's
   device time, the plain version's time, one PyTorch library call's
   time (scaled_dot_product_attention over KV gathered, and for
   quantized pools dequantized, beforehand and untimed) and the roofline
   bound of the card for the same work; then a correctness sweep over
   shapes off the main path for every pool kind (edge_phase), including
   the split-KV decode's boundaries and empty splits and the prefill
   tile's ragged rows and keys (split_edge_cases); then the decode
   kernel's rung identity: a lane's output row bit-identical at batch 8,
   16 and 32 and in reversed batch order (rung_identity_phase). Both
   kernels are timed at GPT-2's shapes too (Hq = Hkv = 12, D 64). The
   prefill kernel's plan (kernels/prefill_attention.py prefill_plan)
   picks its path from shapes: where it picks the long-query wgmma path
   (bf16 chunks of 128 rows or more: 4 x 512 fresh, 512 at offset 1024,
   2048 at offset 2048), the short-query mma.sync path is forced on the same
   inputs, checked and timed beside it (mma_path_ms); threshold_cases
   times both paths at 32 to 512 rows for every pool kind; the edge
   sweep adds the plan's boundaries (plan_edge_cases: rows just under,
   at and over the threshold and ragged, n_rep 1/4/8, head_dim 48 to
   256, pages of 8 to 32, a window cutting a key tile, a prefix ending
   mid-page, an inactive verify lane).
4. engine: tiny-llama and tiny-mistral (float32) on the card, unquantized
   and with int8/int4 weights and int8/int4 KV pools: greedy tokens of
   the "kernel" backend identical to the "dense" backend, and through
   the scheduler identical across the serving modes (ENGINE_MODES: the
   decode ladder, pipeline depth 2, hybrid prefill, optimistic
   admission over a pool small enough to preempt and use the host
   tier), each mode's machinery seen running and the pool clean after.
   The same for tiny-gpt2 and tiny-mixtral in every weight tier and KV
   pool (FAMILY_CASES); a Mixtral with 8 experts, whose calls drop
   tokens at the default capacity, is held kernel-vs-dense only.
   Then speculative decoding (spec_engine_phase: n-gram at every ladder
   rung, at depth 2 and under optimistic admission with the host tier,
   and draft-model rounds with the target as its own draft, with both
   backends, tokens identical to plain decode) and fault injection
   (chaos_phase: a failure armed with verify rounds in flight, health
   degraded then quarantined then recovered, the same tokens after, the
   step watchdog, page pressure, the pool clean; the flight recorder's
   step_error and watchdog captures listed newest first, each with step
   records).
5. main paths: the Ollama server in-process with llama-3-8b at full
   width (32 layers, bf16 activations, random weights from a seed, byte
   tokenizer), concurrent streamed /api/generate requests over
   localhost, five times: bf16 weights and pool; int8 weights over an
   int8 pool; int8 weights over a packed int4 pool (each six requests,
   one long enough to prefill in chunks); the reference's chip
   configuration (booted through the CLI's parser and "auto"
   resolution: batch and pool sized from the card, ladder auto,
   pipeline depth 2, hybrid prefill, host tier auto; 32 concurrent
   requests of BurstGPT prompt lengths, then 4 alone; the ladder must
   top out at and reach 32, with a rung switch and a hybrid step); and
   a pressure run (a few hundred pages, optimistic admission, a fixed
   host tier: preemption, host offload and restore must happen, and the
   4 returning requests reproduce). Each server is freed before the
   next boots. Every request must finish with done_reason "length" and
   all its tokens, the server must count no failed dispatch, and both
   kernels must launch the path's variant and no other. Two speculative
   lanes follow: n-gram speculation on the reference's chip flags
   (ngram_phase, int8 + int8 KV: verify rounds through the prefill
   kernel at S 2 and 5, the decode kernel only in fallback rounds; it,
   the reference-config lane, the pressure lane and the two quantized
   main paths serve the model at full width cut to CUT_LAYERS of its 32
   layers, to keep the script inside its time limit, as do the fleet,
   pd and elastic lanes below) and
   llama-3-8b in bf16 as its own draft (draft_phase: acceptance above
   0.5, no decode-kernel launch in the dense rounds).
   The prefill kernel is also checked and timed at the verify round's
   shapes (verify_cases, in the kernel phase).
   Every lane's server runs with ``enable_debug``. On the bf16 lane,
   after its six requests, the observability phase (observability_phase):
   six fresh streamed requests, then their timelines from GET
   /debug/requests?n=6 (queue + prefill + decode within 1 ms of e2e),
   each one's span tree from /debug/trace?id= (route, queue_wait,
   prefill, decode, durations within 1 ms of its timeline; the chunked
   one's prefill_chunk children cover its uncached prompt), the Chrome
   export
   (one X event per span of every recent trace) and /metrics' fleet
   TTFT p50 gauge equal to the exact p50 of the timelines' TTFTs, with
   the host cost of a span logged; GET /debug/steps beside the dispatch
   counts of /metrics (the kinds
   include prefill_chunk and decode, one ledger record per dispatch, the
   MFU gauge finite and positive); /api/chat unary and streamed (greedy,
   16 tokens, the role-prefix transcript: the chat text equals
   /api/generate's for that transcript, no context field); /api/embed
   with inputs of 41, 200 and 500 tokens and /api/embeddings with the
   first ([3, 4096], finite, cosine with the batched row >= 0.999,
   distinct rows; wall and peak memory recorded); /api/show and /api/ps
   (the engine's parameter count and weight bytes, BF16); and POST
   /debug/profile {"seconds": 2} while rounds of four requests stream
   (a trace under build/profile/replica0 naming both kernels, with CPU
   op events on the engine thread's native id). Every profiled
   lane records the step ledger's verdicts over its profiled window
   beside the profiler's busy share.
6. the other families, each on the main path's six requests: Mixtral-
   8x7B at full width, cut to CUT_LAYERS of its 32 layers, with int8
   weights over an int8 pool (the whole model's 46.7B parameters do not
   fit the card in bf16), and GPT-2 at full width in
   bf16, whose prompts stay inside its 1024 learned positions, then one
   request past them (clamped to the table's last row, as the
   reference's gather does); the Mixtral lane reads /debug/steps with
   the bf16 lane's gates. Each lane records TTFT, tok/s, the device's
   busy share, peak memory and launches by kernel variant (and the
   prefill kernel's by path: the llama lanes must launch the long-query
   path in their pool kind); the previous
   server must have freed the card first. Then a checkpoint lane: a
   random full-width GPT-2 written as an HF directory under build/ and
   served through the CLI's ``--model auto --checkpoint DIR
   --check-numerics`` must give the tokens of the same weights carried
   in by params_from_numpy (recorded as not run when safetensors is not
   importable).

7. dp > 1 on the one card (the replicas share it): fleet_tiny_phase,
   after the chaos phase, runs tiny-llama (float32, so greedy tokens do
   not depend on the batch) at dp 2: a pinned greedy mix gives one
   outputs_sha256 through the in-process group, the subprocess fleet
   and one dp-1 engine on the same weights; in the fleet, kill -9 and
   SIGTERM of the worker holding a mid-decode stream (tokens identical,
   failovers counted, the worker back under its replica label, no
   /metrics counter or histogram series falls, pages migrated and a
   swap-in-resume after the next stats refresh) and a seeded corrupt
   and delay transport-chaos run (the same sha, frame errors, no
   restart); every worker's pool clean. fleet_phase, after the draft
   lane, serves llama-3-8b (bf16, full width, CUT_LAYERS deep) through
   the CLI with ``--dp 2 --fleet subprocess --num-pages 512``: two waves
   of 8
   concurrent BurstGPT-length requests, SIGTERM to one worker mid-
   decode in the first and, once healed, kill -9 to the other in the
   second; every stream "length" with its 48 tokens, pages migrated
   with a swap-in-resume, the drain inside drain_timeout_s, no worker
   process left and the card's free memory back after. In both lanes
   the kernels run inside the worker processes: their launch counts
   (and each worker's device and peak memory) are read through the
   workers' stats RPC, every replica must have launched both kernels on
   the card, and the lanes' launches join the kernels line. The CRC-32C
   paths (the one in use, numpy, the card's) are timed on 64 MiB and
   must agree.
8. P/D roles (a prefill worker hands each settled prefill, its KV pages
   included, to a decode worker). (a) pd_identity_phase, after the draft
   lane: llama-3-8b bf16 (bf16 pool, page 16) as engine A (mixed) and
   engine B (decode) on the same weights; for prompts of 13 x 16 + 5,
   64 and 1501 tokens, A decodes the prompt alone (the oracle), then
   prefills it again and exports the live sequence
   (export_sequence_kv_live), and B adopts it (adopt_sequence): B's
   pages byte-equal to the export, its 16 greedy tokens after the
   adoption equal A's at batch 1, no prefill-kernel launch on B, both
   pools clean; then the same on tiny-llama over int8 and int4 KV pools
   (their scale rows travel with the pages). (b) in fleet_tiny_phase, a
   third fleet of one prefill and one decode worker on the same pinned
   mix: the dp-1 outputs_sha256, one handoff and one adoption per
   request and no recompute, no decode-kernel launch on the prefill
   worker and no prefill-kernel launch on the decode worker; then kill
   -9 of the decode worker while a handed-off stream decodes: the dp-1
   tokens, the recompute counted in tpu_inf_pd_handoff_recomputes_total,
   the worker back under its replica label and role. (c) pd_phase,
   after the fleet lane: llama-3-8b bf16 through the CLI with ``--dp 2
   --fleet subprocess --roles prefill,decode --num-pages 512``, 8
   concurrent BurstGPT-length requests of 48 tokens: every stream
   "length" with its tokens, 8 handoffs all adopted by the decode
   worker and none recomputed, the prefill kernel on the prefill worker
   only and the decode kernel on the decode worker only (their stats
   RPC), both roles' tpu_inf_worker_role_info on /metrics, no worker
   left and the card's memory back; recorded: TTFT, the first
   inter-token gap per request, the handoff wall and bytes, tok/s
   beside the fleet lane's mixed wave. Its launches join the kernels
   line under bf16.
9. The elastic fleet (the autoscaler, rolling upgrades, per-class
   admission lanes). (a) in fleet_tiny_phase, one tiny-llama worker at
   admission cap 1 with class lanes (its dispatches held 0.05 s each
   by the chaos wedge): a batch stream mid-decode, a batch arrival parked,
   an interactive arrival preempting the batch stream, all three with
   the dp-1 engine's tokens; then a rollout under traffic (the pinned
   mix through the lanes: the dp-1 sha, nothing failed) and the mix
   again on the successor (the same sha). (b) elastic_phase, after the
   pd lane: llama-3-8b bf16 through the CLI with ``--dp 2 --fleet
   subprocess --autoscale --autoscale-min 2 --autoscale-max 3``, class
   lanes, short windows and a TTFT target of a quarter of the fleet
   lane's TTFT p50 in this run: a class wave (batch parked and
   preempted, no interactive request shed), a scale-up to 3 whose
   worker launches both kernels in bf16, a scale-down to 2 once idle,
   then POST /debug/rollout under a wave (both workers replaced,
   nothing failed, a second POST 409) and a last wave on the
   successors; every stream "length", no worker left, the card's memory
   back. Each retiring worker's launches are read before its process
   exits, and the lane's launches join the kernels line under bf16.
10. The fleet KV fabric (a prefix prefilled on one replica warms every
   replica through the router's pool). (a) in pd_identity_phase: engine
   A (llama-3-8b bf16, full width, batch 1) serves a 1024-token prefix
   and a suffix, its publish hook feeding a FabricPool; engine B, on the
   same weights, adopts the pool's 64 prefix pages through
   request_import_host and prefills a second prompt with the same
   prefix: B's prefix pages byte-equal to A's, the prefill kernel at
   q_offset 1024 with S the suffix's 128, B's first-step logits within
   check_close of A's cold prefill, no pool rejection, both pools clean;
   then tiny-llama over int8 and int4 KV pools, tokens gated equal.
   (b) in fleet_tiny_phase, both backends: a seed request publishes, the
   seed replica pressured, the same prompt served by the other replica
   pulls the prefix (tokens the dp-1 engine's); in the subprocess fleet
   kill -9 of the seed worker: its respawn adopts the pool's hot set
   before it is UP and its first request with the prefix is host-warm
   with no pull. (c) fabric_phase, after the elastic lane: llama-3-8b
   bf16 at dp 2 with a 256-page pool, a 1024-token shared system prompt
   and BurstGPT-length user suffixes: a seed request, one request alone
   and then a wave of 8 routed around the pressured seed worker (each
   with a dispatch pulling 64 pages; the other worker's caches dropped
   in between), kill
   -9 of the seed worker, its warm-booted respawn serving a host-warm
   request; no failed pull or warm boot, no rejection or frame error,
   both kernels in every worker, no series falls, no worker left. This
   relay arm runs CUT_LAYERS deep. Its launches join the kernels line
   under bf16.
   The shared-memory KV plane (``--kv-plane shm``: every KV payload in
   a /dev/shm arena, descriptors on the sockets). (a) in
   fleet_tiny_phase, the P/D pair and the subprocess fabric part again
   on the shm plane: the same sha and tokens, every handoff, publish,
   pull and warm-boot page by descriptor (_shm_gates: the router's arena
   up, every worker attached with no failed allocation, no relayed
   byte, slabs written and read). (b) the fabric lane's shm arm, after
   the relay arm, CUT_LAYERS deep too (it ran all 32 layers until the
   tp lanes joined the script's time) with ``--shm-arena-bytes``
   SHM_ARENA_BYTES (4 GiB, 1 GiB a region; /dev/shm's free space is
   logged and checked first): the same seed, wave, kill -9 and
   warm-booted respawn, then one more request and SIGTERM to its worker
   mid-decode (_shm_drain). Gates beside the relay arm's: _shm_gates for
   the handoff, fabric_put, migrate and import-kv verbs; the warm boot
   read from the arena (its descriptor pages cover the prefix, nothing
   relayed); tpu_inf_shm_reclaims_total up after the kill -9; the drain
   migrating one request by descriptor inside drain_timeout_s; no
   shm_arena_unavailable event; no segment left under /dev/shm. Its
   launches join the kernels line under bf16. Recorded in both arms:
   each pull's wall and bytes and its parts (the worker's slab reads,
   deserialize and wait for the engine loop; the router's pool read and
   serialize on the relay), alone and 8 at once, the warm boot's wall
   and bytes, the
   router's RSS; in the shm arm the drain's walls and bytes. The fleet
   lane's CRC-32C line times 2 MiB pages one by one and from 8 threads.
11. Tensor and expert parallelism (tp_phase, after the checkpoint lane;
   one process drives every shard, all on the one card, back to back).
   (a) both kernels at Llama-3-8B's head-sharded shapes, tp 2 (Hq 16,
   Hkv 4) and tp 4 (Hq 8, Hkv 2), against their plain versions through
   check_close and timed with bound and library times: decode B 8 ctx
   1024 over the bf16, int8 and int4 pools, prefill 512 at offset 1024
   over bf16 and int8 (the kernels line's ``*_tp2``/``*_tp4`` rows).
   (b) tiny-llama, tiny-llama-fatkv, tiny-mixtral (expert parallel) and
   tiny-gpt2 (float32, kernel backend): greedy tokens at tp 2, and tp 4
   where the heads divide, equal tp 1's on the same weights, both
   kernels launched at the shard's heads only, pools clean; tiny-llama
   with int8 weights over an int8 pool and grouped int4 weights over an
   int4 pool at tp 2, and a pipelined decode (depth 2) at tp 2. (c)
   ``--model llama-3-8b --tp 2`` bf16 at CUT_LAYERS (it ran all 32
   layers until the sp phase joined the script's time), booted by
   _serve_cli: the first step's logits against a tp 1 engine's on the
   same seeded weights, gated twice (tp_serve_phase: in float32 within
   max(1e-4 of the largest |logit|, 4 x float32's own M noise), and in
   bf16 within twice tp 1's own bf16 error against float32; every
   number printed), then the main path's six requests, every one "length"
   with its 48 tokens, both kernels launched in bf16 only and at Hq 16
   / Hkv 4 only (launches_by_heads). (d) the same with ``--quant int8
   --kv-quant int8`` at CUT_LAYERS. (e) in fleet_tiny_phase, dp 2 x tp
   2 on the subprocess fleet (_tp_fleet_tiny): the dp-1 sha, every
   worker's kernels at its shards' heads. The tp lanes' launches join
   the kernels line.
12. Sequence parallelism, pipeline stages and several processes
   (sp_phase, after the tp phase; every sp slice on the one card, back
   to back). (a) tiny-llama-fatkv and tiny-mistral (float32, kernel
   backend) at SP_TINY's meshes: ring at sp 2 and 4, Ulysses at sp 2,
   tp 2 x sp 2 with both, the window dialect under each, int8 KV at tp
   2 x sp 2: greedy tokens equal sp 1's, every fresh single-chunk prompt
   on the sp path (the engine's prefill_paths), a prompt over a cached
   prefix on the prefill kernel, pools clean. (b) ring at sp 2 and 4
   and Ulysses at sp 2 at Llama-3-8B's heads, S 4096, bf16 and float32,
   within check_close of dense attention, their device ms beside dense
   attention's and the prefill kernel's on the same fresh prompt (not
   kernels of the repo: logged, not in the kernels line). (c) ``--model
   llama-3-8b --sp 2 --sp-attn ring`` bf16 at 32 layers through the
   CLI, buckets to 4096: the first-step logits of a 4096-token prompt
   against tp 1 x sp 1's under the tp lanes' rule, then four fresh
   prompts of 2048-4095 tokens at once (the sp path) and one over a
   cached prefix (the prefill kernel): every request "length" with its
   48 tokens, both kernels in bf16 only; the prompt's prefill wall
   beside sp 1's. (d) the same for ``--tp 2 --sp 2 --sp-attn ulysses``
   with int8 weights and int8 KV at CUT_LAYERS (held against sp 1 over a
   float pool: the sp prefill attends its raw K/V, as the reference's).
   (e) pp_forward of llama-3-8b at 32 layers, pp 2 and 4, 4
   micro-batches of 512 tokens, against the unsharded forward (float32
   within max(1e-4 of the largest |logit|, 4 x its M noise), bf16 within
   twice its own error against float32). (f) two processes of this
   script (``--multihost-worker``) join through ``initialize(...,
   backend="gloo")`` on a TCP store, build the dp 2 hybrid mesh over
   their cuda:0, all_reduce a sum computed on the card (32), row 0's
   process alone hosts the frontend, each serves its row: tokens equal
   each other's and one process's. The sp lanes' launches join the
   kernels line.

Then it prints one JSON line {"kernels": [...]} (one entry per kernel
variant), the card line, and as the last line {"ok": true, "device":
{...}}. A copy of every number goes to build/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import torch

# Float32 peak outside the tensor cores (NVIDIA's H100 SXM data sheet,
# 700 W). The bf16 peak and the memory rate are the port's own table
# (engine/autosize.py detect_peak_flops / detect_peak_hbm_bw, keyed by the
# card's name), which the MFU gauge and the step ledger divide by too.
F32_PEAK_FLOPS = 67e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SEED = 0
# What library_ms times: one PyTorch call computing the same attention.
LIBRARY_NOTE = ("scaled_dot_product_attention (enable_gqa) over KV "
                "gathered, and for quantized pools dequantized, beforehand "
                "(untimed)")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, flush: torch.Tensor | None = None) -> float:
    """Mean device time of fn() in ms over ``iters`` launches, CUDA events
    around each launch; the L2 is flushed before each one when a flush
    buffer is given (the serving path reads each layer's pool cold). A
    spin kernel (~30 ms) goes first so the host enqueues every launch
    before the device reaches it: the events then time the device's work,
    not the host's launch overhead (the kernels take tens of us, about
    what a Python wrapper takes to launch them)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(50_000_000)
    for start, end in events:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    from tpu_inference_torch.engine import autosize
    peak = (autosize.detect_peak_flops() if dtype == torch.bfloat16
            else F32_PEAK_FLOPS)
    t_bytes = bytes_moved / autosize.detect_peak_hbm_bw() * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k, v, mask):
    """One library call computing the same attention:
    scaled_dot_product_attention in its GQA mode over KV gathered
    beforehand (the gather is not timed). q [B, Hq, Sq, D], k/v
    [B, Hkv, T, D]."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def paged_pool(gen, b, mp, pg, hkv, d, dtype, kv="none"):
    """K/V pools of b * mp pages (+ the trash page) and a block table of
    distinct pages. ``kv`` "int8"/"int4": standard-normal K/V quantized
    as the engine writes them (engine/kv_cache.py), codes plus scales.
    Returns (k, v, k_scale, v_scale, block_tables)."""
    from tpu_inference_torch.engine import kv_cache as kvc
    num_pages = b * mp + 1
    shape = (num_pages, pg, hkv, d)
    k = torch.randn(shape, generator=gen, device="cuda")
    v = torch.randn(shape, generator=gen, device="cuda")
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:b * mp].reshape(b, mp).to(torch.int32).contiguous()
    if kv == "none":
        return k.to(dtype), v.to(dtype), None, None, bt
    qfn = kvc.quantize_kv_int4 if kv == "int4" else kvc.quantize_kv
    (kq, ks), (vq, vs) = qfn(k), qfn(v)
    return kq, vq, ks, vs, bt


def gathered(k_pages, v_pages, k_scale, v_scale, bt, dtype):
    """KV of each sequence gathered (and dequantized) into [B, Hkv, T, D]
    in q's dtype, for the library call."""
    from tpu_inference_torch.engine.kv_cache import gather_pages
    k = gather_pages(k_pages, k_scale, bt).to(dtype).transpose(1, 2)
    v = gather_pages(v_pages, v_scale, bt).to(dtype).transpose(1, 2)
    return k.contiguous(), v.contiguous()


def kv_bytes(tokens, hkv, d, k_pages, elem) -> float:
    """Bytes of K and V for ``tokens`` positions: codes (1 byte each for
    int8, half a byte for int4) plus 4 bytes of scale per token and
    head, or the float pool's elements."""
    if k_pages.dtype == torch.int8:
        return 2.0 * tokens * hkv * (d + 4)
    if k_pages.dtype == torch.uint8:
        return 2.0 * tokens * hkv * (d / 2 + 4)
    return 2.0 * tokens * hkv * d * elem


def check_close(name, got, want, dtype) -> tuple:
    """(max abs error, that error over the largest |want|) of a kernel's
    output against its plain version. The limit is TOL[dtype] abs, times
    the largest |want| where that is below 1: over a long context the
    softmax is nearly flat and outputs are ~0.05, where a flat 2e-2
    would pass a lost or doubled key chunk by a small margin. One bf16
    ulp is at most 2**-7 of the largest output, well inside 2e-2 of it."""
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    tol = TOL[dtype] * min(1.0, scale)
    if not torch.isfinite(got.float()).all() or (err > tol).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3g},"
                             f" tolerance {tol:.3g} abs: {TOL[dtype]} x "
                             f"min(1, largest |output| {scale:.3g}))")
    return err.max().item(), err.max().item() / max(scale, 1e-30)


# Attention heads (Hq, Hkv, head_dim) of the served models: Llama-3-8B's
# (Mixtral-8x7B's too) and GPT-2's (multi-head, n_rep 1).
LLAMA_HEADS = (32, 8, 128)
GPT2_HEADS = (12, 12, 64)


def decode_case(name, b, kv_lens, window, dtype, flush, gen, kv="none",
                heads=LLAMA_HEADS):
    from tpu_inference_torch.kernels import paged_attention as pa
    (hq, hkv, d), pg = heads, 16
    mp = max(-(-n // pg) for n in kv_lens)
    k_pages, v_pages, ks, vs, bt = paged_pool(gen, b, mp, pg, hkv, d, dtype,
                                              kv)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, bt, kv_len, ks, vs)
    got = pa.paged_attention(*args, sliding_window=window)
    want = pa.paged_attention_plain(*args, sliding_window=window)
    torch.cuda.synchronize()
    err, rel = check_close(name, got, want, dtype)
    kg, vg = gathered(k_pages, v_pages, ks, vs, bt, dtype)
    pos = torch.arange(mp * pg, device="cuda")[None, :]
    valid = pos < kv_len[:, None]
    if window:
        valid &= pos >= kv_len[:, None] - window
    mask = valid[:, None, None, :]
    lib = library_call(q[:, :, None, :], kg, vg, mask)
    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    attended = sum(min(n, window) if window else n for n in kv_lens)
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem + kv_bytes(attended, hkv, d, k_pages, elem)
              + bt.numel() * 4 + b * 4)
    flops = 4.0 * attended * hq * d
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "variant": name, "dtype": str(dtype).replace("torch.", ""),
        "kv": kv,
        "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page": pg,
                  "kv_len": kv_lens, "sliding_window": window},
        "max_abs_err": err, "err_over_scale": rel, "tolerance": TOL[dtype],
        "ms": time_ms(lambda: pa.paged_attention(*args,
                                                 sliding_window=window),
                      flush=flush),
        "plain_ms": time_ms(lambda: pa.paged_attention_plain(
            *args, sliding_window=window), iters=5, flush=flush),
        "library_ms": time_ms(lib, flush=flush),
        "library_max_abs_err": lib_err,
        "library": LIBRARY_NOTE, "bytes": nbytes, "flops": flops,
        "bound_ms": b_ms, "bound_by": b_by,
        "splits": pa.split_plan(mp, pg, window),
    }


def prefill_case(name, s, q_offsets, kv_lens, window, dtype, flush, gen,
                 kv="none", inactive: int = 0, heads=LLAMA_HEADS):
    """One prefill-kernel case; the last ``inactive`` lanes are inactive
    as a speculative verify round stages them (q_offset 0, kv_len S, an
    all-trash-page block table). Where the plan picks the wgmma path,
    the short-query kernel (the mma path, forced) is checked and timed
    beside it in the same call."""
    from tpu_inference_torch.kernels import prefill_attention as pfa
    (hq, hkv, d), pg = heads, 16
    b = len(kv_lens)
    mp = max(-(-n // pg) for n in kv_lens)
    k_pages, v_pages, ks, vs, bt = paged_pool(gen, b, mp, pg, hkv, d, dtype,
                                              kv)
    if inactive:
        bt[b - inactive:] = 0
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    q_off = torch.tensor(q_offsets, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, bt, kv_len, q_off, ks, vs)
    variant = ("f32" if dtype == torch.float32 else "bf16") if kv == "none" \
        else kv
    plan = pfa.prefill_plan(s, hq // hkv, d, variant, dtype)
    got = pfa.paged_prefill_attention(*args, sliding_window=window)
    want = pfa.paged_prefill_attention_plain(*args, sliding_window=window)
    torch.cuda.synchronize()
    err, rel = check_close(name, got, want, dtype)
    short_path = {}
    if plan["path"] == "wgmma":
        mma = dict(path="mma", code=pfa.PATHS["mma"], tile_rows=64)
        check_close(f"{name} (mma path)", pfa._launch(
            mma, *args, sliding_window=window), want, dtype)
        short_path = {"mma_path_ms": time_ms(lambda: pfa._launch(
            mma, *args, sliding_window=window), flush=flush)}
    kg, vg = gathered(k_pages, v_pages, ks, vs, bt, dtype)
    q_pos = q_off[:, None] + torch.arange(s, device="cuda")[None, :]
    k_pos = torch.arange(mp * pg, device="cuda")[None, None, :]
    valid = (k_pos <= q_pos[:, :, None]) & (k_pos < kv_len[:, None, None])
    if window:
        valid &= k_pos > q_pos[:, :, None] - window
    pairs = int(valid.sum().item())
    lib = library_call(q.transpose(1, 2).contiguous(), kg, vg,
                       valid[:, None])
    # Rows with no valid key: the kernel outputs 0, the library NaN.
    live = valid.any(-1)[:, :, None, None]
    lib_err = (torch.where(live, lib().transpose(1, 2).float(), want.float())
               - want.float()).abs().max().item()
    keys = 0
    for off, n in zip(q_offsets, kv_lens):
        lo = max(0, off - window + 1) if window else 0
        keys += max(0, min(n, off + s) - lo)
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem + kv_bytes(keys, hkv, d, k_pages, elem)
              + bt.numel() * 4 + 2 * b * 4)
    flops = 4.0 * pairs * hq * d
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "variant": name, "dtype": str(dtype).replace("torch.", ""),
        "kv": kv,
        "shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "page": pg,
                  "q_offset": q_offsets, "kv_len": kv_lens,
                  "sliding_window": window, "inactive_lanes": inactive},
        "max_abs_err": err, "err_over_scale": rel, "tolerance": TOL[dtype],
        "ms": time_ms(lambda: pfa.paged_prefill_attention(
            *args, sliding_window=window), flush=flush),
        "plain_ms": time_ms(lambda: pfa.paged_prefill_attention_plain(
            *args, sliding_window=window), iters=3, flush=flush),
        "library_ms": time_ms(lib, flush=flush),
        "library_max_abs_err": lib_err,
        "library": LIBRARY_NOTE, "bytes": nbytes, "flops": flops,
        "bound_ms": b_ms, "bound_by": b_by, "path": plan["path"],
        **short_path,
    }


def kernel_phase() -> dict:
    """Every variant of both kernels at the main paths' shapes. The first
    case of each pool kind is its headline (the kernels line)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    mixed = [1, 17, 128, 333, 512, 700, 1000, 1500]
    decode, prefill = [], []
    for kv in ("none", "int8", "int4"):
        tag = "" if kv == "none" else f" {kv} pool"
        decode += [
            decode_case(f"decode bs8 ctx1024{tag}", 8, [1024] * 8, 0, bf16,
                        flush, gen, kv),
            decode_case(f"decode bs8 mixed ctx{tag}", 8, mixed, 0, bf16,
                        flush, gen, kv),
            decode_case(f"decode bs8 ctx2048 swa256{tag}", 8, [2048] * 8,
                        256, bf16, flush, gen, kv),
            # The decode ladder's other rungs.
            decode_case(f"decode bs16 ctx1024{tag}", 16, [1024] * 16, 0,
                        bf16, flush, gen, kv),
            decode_case(f"decode bs32 ctx1024{tag}", 32, [1024] * 32, 0,
                        bf16, flush, gen, kv),
        ]
        prefill += [
            prefill_case(f"prefill 4 lanes x 512 fresh{tag}", 512,
                         [0, 0, 0, 0], [512, 300, 450, 129], 0, bf16, flush,
                         gen, kv),
            prefill_case(f"prefill chunk 512 at offset 1024{tag}", 512,
                         [1024], [1500], 0, bf16, flush, gen, kv),
            prefill_case(f"prefill chunk 2048 at offset 2048{tag}", 2048,
                         [2048], [4096], 0, bf16, flush, gen, kv),
        ]
    decode += [
        decode_case("decode bs8 mixed ctx f32", 8,
                    [1, 40, 300, 1024, 7, 64, 65, 999], 0, f32, flush, gen),
        decode_case("decode bs8 ctx1024 f32", 8, [1024] * 8, 0, f32, flush,
                    gen),
        decode_case("decode bs8 ctx1024 f32 int8 pool", 8, [1024] * 8, 0,
                    f32, flush, gen, "int8"),
    ]
    prefill += [
        prefill_case("prefill 1024 fresh swa256", 1024, [0], [1024], 256,
                     bf16, flush, gen),
        prefill_case("prefill 2 lanes x 200 f32 cached prefix", 200, [37, 0],
                     [237, 150], 0, f32, flush, gen),
        prefill_case("prefill chunk 512 at offset 1024 f32", 512, [1024],
                     [1500], 0, f32, flush, gen),
        prefill_case("prefill chunk 512 at offset 1024 f32 int8 pool", 512,
                     [1024], [1500], 0, f32, flush, gen, "int8"),
    ]
    # GPT-2's shapes (Hq = Hkv = 12, head_dim 64: one live row of the
    # decode kernel's 16-row tile, the prefill tile's 64-row block).
    gpt2 = [
        decode_case("decode gpt2 bs8 ctx1024", 8, [1024] * 8, 0, bf16, flush,
                    gen, heads=GPT2_HEADS),
        prefill_case("prefill gpt2 4 lanes x 512 fresh", 512, [0, 0, 0, 0],
                     [512, 300, 450, 129], 0, bf16, flush, gen,
                     heads=GPT2_HEADS),
    ]
    del flush
    return {"decode": decode, "prefill": prefill, "gpt2": gpt2,
            "verify": verify_cases(gen), "threshold": threshold_cases(gen)}


def threshold_cases(gen) -> list:
    """Both bf16 tensor-core paths forced on the same inputs, for every
    pool kind (Llama-3-8B heads, n_rep 4): one lane of S 8 to 128 at
    offset 1024 (32 to 512 rows) and the verify round's B 8 / 32 lanes of
    S 2 and 5 at offsets over 1..1500: the times that place
    WGMMA_MIN_ROWS."""
    import numpy as np

    from tpu_inference_torch.kernels import prefill_attention as pfa
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    (hq, hkv, d), pg = LLAMA_HEADS, 16
    shapes = [(1, s) for s in (8, 16, 32, 64, 128)] + list(VERIFY_SHAPES)
    out = []
    for kv in ("none", "int8", "int4"):
        for b, s in shapes:
            offs = ([1024] if b == 1 else np.random.default_rng(
                SEED + 4 + b).integers(1, 1501, size=b).tolist())
            lens = [o + s for o in offs]
            mp = -(-max(lens) // pg)
            k, v, ks, vs, bt = paged_pool(gen, b, mp, pg, hkv, d,
                                          torch.bfloat16, kv)
            q = torch.randn((b, s, hq, d), generator=gen,
                            device="cuda").to(torch.bfloat16)
            args = (q, k, v, bt,
                    torch.tensor(lens, dtype=torch.int32, device="cuda"),
                    torch.tensor(offs, dtype=torch.int32, device="cuda"),
                    ks, vs)
            want = pfa.paged_prefill_attention_plain(*args)
            row = {"kv": kv, "B": b, "S": s, "rows": s * hq // hkv}
            for path in ("mma", "wgmma"):
                plan = dict(path=path, code=pfa.PATHS[path], tile_rows=0)
                check_close(f"threshold {path} B{b} S{s} {kv}",
                            pfa._launch(plan, *args, sliding_window=0),
                            want, torch.bfloat16)
                row[f"{path}_ms"] = time_ms(lambda: pfa._launch(
                    plan, *args, sliding_window=0), flush=flush)
            out.append(row)
    del flush
    return out


# Speculative verify shapes (engine/speculative.py verify_round): S = γ+1
# (γ 4) and the 2-wide probe, at ladder rungs 8 and 32.
VERIFY_SHAPES = ((8, 2), (8, 5), (32, 2), (32, 5))


def verify_cases(gen) -> list:
    """The prefill kernel at the n-gram verify round's shapes: B 8 and 32
    lanes of S 2 and 5 queries at offsets mixed over 1..1500 (the
    context), the last lane inactive, for every pool kind with bf16 q
    (the served model) and with float32 q at B 8 x S 5 (the tiny
    engines)."""
    import numpy as np
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    cases = []
    for kv in ("none", "int8", "int4"):
        tag = "" if kv == "none" else f" {kv} pool"
        for dtype, shapes in ((torch.bfloat16, VERIFY_SHAPES),
                              (torch.float32, ((8, 5),))):
            for b, s in shapes:
                # The same contexts at every S and pool kind of a batch.
                offs = np.random.default_rng(SEED + 4 + b).integers(
                    1, 1501, size=b).tolist()
                offs[-1] = 0
                lens = [o + s for o in offs]
                f32 = " f32" if dtype == torch.float32 else ""
                cases.append(prefill_case(
                    f"prefill verify B{b} S{s}{f32}{tag}", s, offs, lens, 0,
                    dtype, flush, gen, kv, inactive=1))
    del flush
    return cases


def _worse(a, b) -> list:
    """Elementwise max of two (abs error, error over scale) pairs."""
    return [max(x, y) for x, y in zip(a, b)]


def edge_phase() -> tuple:
    """Both kernels against their plain versions (correctness only) over
    shapes off the main path: MHA to n_rep 8, head_dim 48 to 256, pages
    of 8 to 32 tokens, one-token contexts, page-boundary lengths, ragged
    query tiles, cached-prefix offsets and sliding windows, for float
    pools, int8 pools and packed int4 pools (head_dim 64 to 256: the
    int4 page load takes 32 codes at a time). Returns the number of
    shapes checked and the largest error by q dtype and pool kind."""
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    checked = 0
    worst: dict = {}
    shapes = [(8, 8, 64, 8), (16, 2, 128, 32), (4, 4, 256, 16),
              (4, 2, 48, 8)]
    for kv in ("none", "int8", "int4"):
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{str(dtype).replace('torch.', '')}/{kv}"
            worst[key] = [0.0, 0.0]
            for hq, hkv, d, pg in shapes:
                if kv != "none" and d % 32:
                    continue
                for window in (0, 3 * pg // 2):
                    kv_lens = [1, pg, pg + 1, 5 * pg - 1, 7 * pg]
                    b, mp = len(kv_lens), 7
                    k, v, ks, vs, bt = paged_pool(gen, b, mp, pg, hkv, d,
                                                  dtype, kv)
                    q = torch.randn((b, hq, d), generator=gen,
                                    device="cuda").to(dtype)
                    kl = torch.tensor(kv_lens, dtype=torch.int32,
                                      device="cuda")
                    name = (f"edge decode {hq}/{hkv}x{d} pg{pg} w{window} "
                            f"{key}")
                    worst[key] = _worse(worst[key], check_close(
                        name, pa.paged_attention(
                            q, k, v, bt, kl, ks, vs, sliding_window=window),
                        pa.paged_attention_plain(
                            q, k, v, bt, kl, ks, vs,
                            sliding_window=window), dtype))
                    checked += 1
                    for s_len, offs, prompts in (
                            (1, [0, 9], [1, 1]),
                            (13, [0, 2 * pg + 3], [13, 7]),
                            (100, [0, pg], [100, 77])):
                        kvl = [o + n for o, n in zip(offs, prompts)]
                        mp = max(-(-n // pg) for n in kvl)
                        k, v, ks, vs, bt = paged_pool(gen, 2, mp, pg, hkv,
                                                      d, dtype, kv)
                        q = torch.randn((2, s_len, hq, d), generator=gen,
                                        device="cuda").to(dtype)
                        args = (q, k, v, bt,
                                torch.tensor(kvl, dtype=torch.int32,
                                             device="cuda"),
                                torch.tensor(offs, dtype=torch.int32,
                                             device="cuda"), ks, vs)
                        name = (f"edge prefill {hq}/{hkv}x{d} pg{pg} "
                                f"S{s_len} w{window} {key}")
                        worst[key] = _worse(worst[key], check_close(
                            name, pfa.paged_prefill_attention(
                                *args, sliding_window=window),
                            pfa.paged_prefill_attention_plain(
                                *args, sliding_window=window), dtype))
                        checked += 1
    checked += split_edge_cases(gen, worst)
    checked += plan_edge_cases(gen, worst)
    torch.cuda.synchronize()
    return checked, worst


def plan_edge_cases(gen, worst: dict) -> int:
    """The prefill plan's boundaries, for every pool kind and q dtype:
    rows (S x n_rep) just under, at and just over one 128-row tile (a
    bf16 pool's wgmma threshold) and a ragged count, at n_rep 1, 4 and 8, head_dim 48 to 256 with pages
    of 8 to 32 tokens; a window cutting a 64-key tile on every other
    shape; each call with a fresh lane, a lane whose cached prefix ends
    mid-page and an inactive verify-style lane (q_offset 0, kv_len S,
    the trash page only). Returns the number of shapes checked."""
    from tpu_inference_torch.kernels import prefill_attention as pfa
    checked, hkv = 0, 2
    for kv in ("none", "int8", "int4"):
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{str(dtype).replace('torch.', '')}/{kv}"
            for n_rep in (1, 4, 8):
                edge = pfa.TILE_ROWS["wgmma"] // n_rep  # one full tile
                for d, pg in ((48, 8), (64, 16), (128, 32), (256, 16)):
                    if kv != "none" and d % 32:
                        continue
                    for i, s_len in enumerate((edge - 1, edge, edge + 1,
                                               77)):
                        window = 100 if i % 2 else 0
                        offs = [0, 37, 0]
                        kvl = [o + s_len for o in offs]
                        mp = -(-max(kvl) // pg)
                        k, v, ks, vs, bt = paged_pool(
                            gen, 3, mp, pg, hkv, d, dtype, kv)
                        bt[2] = 0
                        q = torch.randn((3, s_len, hkv * n_rep, d),
                                        generator=gen,
                                        device="cuda").to(dtype)
                        args = (q, k, v, bt,
                                torch.tensor(kvl, dtype=torch.int32,
                                             device="cuda"),
                                torch.tensor(offs, dtype=torch.int32,
                                             device="cuda"), ks, vs)
                        worst[key] = _worse(worst[key], check_close(
                            f"plan edge prefill r{n_rep} d{d} pg{pg} "
                            f"S{s_len} w{window} {key}",
                            pfa.paged_prefill_attention(
                                *args, sliding_window=window),
                            pfa.paged_prefill_attention_plain(
                                *args, sliding_window=window), dtype))
                        checked += 1
    return checked


def split_edge_cases(gen, worst: dict) -> int:
    """The redesigned kernels' edges, for every pool kind and q dtype at
    n_rep 1, 4 and 8 and head_dim 64, 128 and 256 (page 16): decode at
    batch 1 and 3 over the main path's 128 pages, lengths on and just
    past a split boundary up to 2048, later splits empty; prefill chunks
    whose rows (S x n_rep) are not a multiple of the 64-row tile and
    whose keys end mid-tile. Returns the number of shapes checked."""
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    checked = 0
    hkv, pg, mp = 2, 16, 128
    for kv in ("none", "int8", "int4"):
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{str(dtype).replace('torch.', '')}/{kv}"
            for n_rep in (1, 4, 8):
                for d in (64, 128, 256):
                    hq = hkv * n_rep
                    for b in (1, 3):
                        _, pps = pa.split_plan(mp, pg, 0)
                        edge = pps * pg  # first split's last token + 1
                        for kv_lens in (([edge], [2048]) if b == 1 else
                                        ([1, edge + 1, 2 * edge],)):
                            k, v, ks, vs, bt = paged_pool(
                                gen, b, mp, pg, hkv, d, dtype, kv)
                            q = torch.randn((b, hq, d), generator=gen,
                                            device="cuda").to(dtype)
                            kl = torch.tensor(kv_lens, dtype=torch.int32,
                                              device="cuda")
                            worst[key] = _worse(worst[key], check_close(
                                f"split decode {hq}/{hkv}x{d} {kv_lens} "
                                f"{key}",
                                pa.paged_attention(q, k, v, bt, kl, ks, vs),
                                pa.paged_attention_plain(q, k, v, bt, kl, ks,
                                                         vs), dtype))
                            checked += 1
                    s_len, offs = 77, [0, 300]
                    kvl = [o + s_len for o in offs]
                    k, v, ks, vs, bt = paged_pool(
                        gen, 2, -(-max(kvl) // pg), pg, hkv, d, dtype, kv)
                    q = torch.randn((2, s_len, hq, d), generator=gen,
                                    device="cuda").to(dtype)
                    args = (q, k, v, bt,
                            torch.tensor(kvl, dtype=torch.int32,
                                         device="cuda"),
                            torch.tensor(offs, dtype=torch.int32,
                                         device="cuda"), ks, vs)
                    worst[key] = _worse(worst[key], check_close(
                        f"tile prefill {hq}/{hkv}x{d} S{s_len} {key}",
                        pfa.paged_prefill_attention(*args),
                        pfa.paged_prefill_attention_plain(*args), dtype))
                    checked += 1
    return checked


def rung_identity_phase() -> dict:
    """The decode kernel's output row for a lane is bit-identical at every
    ladder rung: the same lanes (Llama-3-8B heads, 128 pages of 16, ragged
    lengths up to 2048 across split boundaries) in batches of 8, 16 and
    32, and in the batch of 32 reversed, for every pool kind and both q
    dtypes. Returns the lanes compared per case."""
    from tpu_inference_torch.kernels import paged_attention as pa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    hq, hkv, d, pg, mp, top = 32, 8, 128, 16, 128, 32
    compared = {}
    for kv in ("none", "int8", "int4"):
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{str(dtype).replace('torch.', '')}/{kv}"
            k, v, ks, vs, bt = paged_pool(gen, top, mp, pg, hkv, d, dtype, kv)
            q = torch.randn((top, hq, d), generator=gen,
                            device="cuda").to(dtype)
            kl = torch.randint(1, mp * pg + 1, (top,), generator=gen,
                               device="cuda", dtype=torch.int32)
            kl[:4] = torch.tensor([256, 257, 2048, 1], dtype=torch.int32)
            out = {b: pa.paged_attention(q[:b].contiguous(), k, v,
                                         bt[:b].contiguous(),
                                         kl[:b].contiguous(), ks, vs)
                   for b in (8, 16, 32)}
            rev = torch.arange(top - 1, -1, -1, device="cuda")
            flipped = pa.paged_attention(q[rev].contiguous(), k, v,
                                         bt[rev].contiguous(),
                                         kl[rev].contiguous(), ks, vs)[rev]
            torch.cuda.synchronize()
            same = (torch.equal(out[8], out[16][:8])
                    and torch.equal(out[8], out[32][:8])
                    and torch.equal(out[16], out[32][:16])
                    and torch.equal(flipped, out[32]))
            if not same:
                raise AssertionError(
                    f"decode kernel {key}: a lane's output row differs "
                    "across batch widths 8/16/32 (or batch order)")
            compared[key] = top
    return compared


def gemm_rung_evidence() -> dict:
    """Evidence, not a gate: does one row of a library GEMM (a
    torch.matmul on cuBLAS, bf16, at Llama-3-8B's projection shapes)
    depend on how many rows the call has? Decode calls have the ladder's
    rung rows (8, 16, 32), prefill calls lanes x bucket rows (one lane
    or four of 64 tokens: 64 or 256). The decode kernel's rows do not
    depend on the batch (rung_identity_phase); the model's matmuls are
    the library's. Returns, per shape and base M, the largest difference
    of the base call's rows when the call has 2x and 4x the rows."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    out = {}
    for name, (k, n) in (("wq 4096x4096", (4096, 4096)),
                         ("wk 4096x1024", (4096, 1024)),
                         ("w1 4096x14336", (4096, 14336)),
                         ("w2 14336x4096", (14336, 4096)),
                         ("unembed 4096x128256", (4096, 128256))):
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(
            torch.bfloat16)
        x = torch.randn((256, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        for base_m in (8, 64):
            if name.startswith("unembed") and base_m == 64:
                continue          # the prefill unembeds one row per lane
            base = (x[:base_m] @ w).float()
            out[f"{name} M{base_m}"] = {
                str(m): (x[:m] @ w)[:base_m].float().sub(base).abs().max()
                .item() for m in (2 * base_m, 4 * base_m)}
        del w
    torch.cuda.synchronize()
    return out


def _sched_run(engine, prompts: list, max_new: int) -> dict:
    """Every prompt through the engine's scheduler at once (queued before
    the loop starts); {request id: streamed tokens}. The pool must be
    clean afterwards."""
    from tpu_inference_torch.engine.engine import Sequence
    from tpu_inference_torch.engine.scheduler import EngineScheduler
    sched = EngineScheduler(engine)
    seqs = [Sequence(request_id=i, prompt_tokens=list(p),
                     max_new_tokens=max_new) for i, p in enumerate(prompts)]
    events = {s.request_id: [] for s in seqs}
    done = {s.request_id: threading.Event() for s in seqs}
    for s in seqs:
        sched.submit(s, lambda sq, t: events[sq.request_id].append(t),
                     lambda sq: done[sq.request_id].set())
    sched.start()
    try:
        for s in seqs:
            if not done[s.request_id].wait(300):
                raise AssertionError(f"request {s.request_id} hung")
    finally:
        sched.stop(drain=True, timeout=30)
    bad = [s.request_id for s in seqs
           if s.finish_reason != "length" or len(s.generated) != max_new]
    if bad or sched.stats.step_failures:
        raise AssertionError(f"requests {bad} did not finish with all "
                             f"their tokens ({sched.stats.step_failures} "
                             "failed dispatches)")
    engine.check_pool_clean()
    return events


# The serving-engine modes the tiny engines compare, each against the
# single-rung, depth-1, serial-chunk, reserve-admission baseline. The
# optimistic pool is small enough that its 12 requests preempt, and
# (with the prefix cache on) demote pages to the host tier and restore
# them.
ENGINE_MODES = (("ladder (4, 8, 16)", {"max_batch_size": 16,
                                       "decode_ladder": (4, 8, 16)}),
                ("pipeline depth 2", {"decode_pipeline_depth": 2}),
                ("hybrid prefill", {"hybrid_prefill": True}),
                ("optimistic + host tier", {"admission": "optimistic",
                                            "num_pages": 20,
                                            "host_cache_pages": 64}))


def engine_modes(mcfg, ecfg, params, prompts: list) -> dict:
    """One tiny engine configuration through the scheduler in the
    baseline and in every ENGINE_MODES mode: greedy tokens identical,
    pool clean, and the mode's machinery demonstrably used."""
    from tpu_inference_torch.engine.engine import InferenceEngine
    max_new = 24
    base = _sched_run(InferenceEngine(mcfg, ecfg, params=params,
                                      device="cuda"), prompts, max_new)
    used = {}
    for name, over in ENGINE_MODES:
        eng = InferenceEngine(mcfg, dataclasses.replace(ecfg, **over),
                              params=params, device="cuda")
        got = _sched_run(eng, prompts, max_new)
        if got != base:
            diff = [i for i in base if base[i] != got[i]]
            raise AssertionError(f"{mcfg.name} {name}: greedy tokens differ "
                                 f"from the baseline for requests {diff}")
        tel = eng.telemetry
        used[name] = {
            "rung_peak": eng.rung_peak, "hybrid_steps": eng.hybrid_steps_total,
            "preemptions": eng.preemptions_total,
            "offloaded_pages": tel.kv_offload_pages.value,
            "restored_pages": tel.kv_restore_pages.value}
    u = used
    if (u["ladder (4, 8, 16)"]["rung_peak"] != 16
            or u["hybrid prefill"]["hybrid_steps"] < 1
            or u["optimistic + host tier"]["preemptions"] < 1):
        raise AssertionError(f"{mcfg.name}: a mode's machinery never ran: "
                             f"{used}")
    opt = u["optimistic + host tier"]
    if not mcfg.sliding_window and (opt["offloaded_pages"] < 1
                                    or opt["restored_pages"] < 1):
        raise AssertionError(f"{mcfg.name}: the host tier never offloaded "
                             f"and restored: {opt}")
    return used


# (preset, quant, kv_quant) of the tiny engines: unquantized, each KV
# tier, each weight tier, int8 over int8 as on the main path, and an
# int8 pool under a sliding window.
ENGINE_CASES = (("tiny_llama", "none", "none"),
                ("tiny_mistral", "none", "none"),
                ("tiny_llama", "none", "int8"),
                ("tiny_llama", "none", "int4"),
                ("tiny_llama", "int8", "none"),
                ("tiny_llama", "int4", "none"),
                ("tiny_llama", "int8", "int8"),
                ("tiny_mistral", "none", "int8"))
# The Mixtral and GPT-2 families in every weight tier and KV pool.
# tiny-mixtral (4 experts, top-2) sits at capacity factor E / k = 2.0,
# where C >= T and no token drops, so it passes the cross-mode gate too;
# tiny_mixtral_e8 (Mixtral-8x7B's 8 experts, C = T / 2) drops tokens, so
# a token depends on which others share its call: kernel-vs-dense only.
FAMILY_CASES = tuple((preset, q, kv)
                     for preset in ("tiny_gpt2", "tiny_mixtral")
                     for q, kv in (("none", "none"), ("none", "int8"),
                                   ("none", "int4"), ("int8", "none"),
                                   ("int4", "none"), ("int8", "int8"))) + (
    ("tiny_mixtral_e8", "none", "none"), ("tiny_mixtral_e8", "int8", "int8"))


def tiny_config(preset: str):
    from tpu_inference_torch import config as cfgs
    if preset == "tiny_mixtral_e8":
        return dataclasses.replace(cfgs.tiny_mixtral(vocab_size=256),
                                   name="tiny-mixtral-e8", n_experts=8)
    return getattr(cfgs, preset)(vocab_size=256)


def engine_phase(cases) -> list:
    """Tiny engines on the card: the "kernel" backend's greedy tokens
    identical to the "dense" backend's on the same weights, for every
    case (the reference's own contract between its two backends,
    tests/test_kv_quant.py), and through the scheduler identical across
    ENGINE_MODES unless the model drops tokens."""
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models.registry import build_model

    base = cfgs.EngineConfig(page_size=8, num_pages=64, max_pages_per_seq=16,
                             max_batch_size=4, prefill_buckets=(16, 32),
                             decode_steps_per_call=4)
    # The serving modes' baseline: 12 requests through the scheduler, the
    # two long prompts prefilled in 16-token chunks (or hybrid steps).
    mode_base = dataclasses.replace(base, num_pages=128,
                                    chunked_prefill_size=16)
    mrng = np.random.default_rng(7)
    mode_prompts = [mrng.integers(0, 256, size=n).tolist()
                    for n in (5, 9, 12, 40, 7, 14, 3, 70, 11, 6, 16, 10)]
    done = []
    for preset, quant, kv_quant in cases:
        mcfg = tiny_config(preset)
        ecfg = dataclasses.replace(base, quant=quant, kv_quant=kv_quant)
        params, _ = build_model(mcfg, seed=SEED, device="cuda", quant=quant)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 256, size=n).tolist()
                   for n in (5, 12, 27, 70)]
        out = {}
        for backend in ("dense", "kernel"):
            eng = InferenceEngine(mcfg, ecfg, params=params,
                                  attn_backend=backend, device="cuda")
            out[backend] = eng.generate(prompts, max_new_tokens=12)
        label = f"{mcfg.name} quant={quant} kv_quant={kv_quant}"
        if out["dense"] != out["kernel"]:
            raise AssertionError(f"{label}: kernel backend tokens differ "
                                 f"from dense: {out}")
        log(f"engine {label}: kernel backend greedy-identical to dense "
            f"({sum(len(t) for t in out['kernel'])} tokens)")
        if mcfg.n_experts and (mcfg.expert_capacity_factor
                               < mcfg.n_experts / mcfg.n_experts_per_tok):
            done.append({"label": label, "modes": None})
            continue
        used = engine_modes(mcfg, dataclasses.replace(
            mode_base, quant=quant, kv_quant=kv_quant), params, mode_prompts)
        log(f"engine {label}: scheduler tokens identical across "
            f"{', '.join(n for n, _ in ENGINE_MODES)}; pool clean; "
            f"{json.dumps(used)}")
        done.append({"label": label, "modes": used})
    return done


# The speculative modes the tiny engines compare against their plain
# scheduler baseline: n-gram (γ 4; its fresh lanes start on the 2-wide
# probe round) at every ladder rung, at pipeline depth 2, under
# optimistic admission with the host tier and preemption; draft-model
# speculation with the target as its own draft.
NGRAM = {"spec_mode": "ngram", "num_speculative_tokens": 4}
SPEC_MODES = (("ngram ladder (4, 8, 16)", {**NGRAM, "max_batch_size": 16,
                                           "decode_ladder": (4, 8, 16)}),
              ("ngram depth 2", {**NGRAM, "decode_pipeline_depth": 2,
                                 "latency_decode_threshold": 0}),
              ("ngram optimistic + host tier", {
                  **NGRAM, "admission": "optimistic", "num_pages": 20,
                  "host_cache_pages": 64}),
              ("draft (target as draft)", {"num_speculative_tokens": 4}))


def _echo_prompts(rng, n: int, lengths) -> list:
    """Prompts that repeat a short random passage of their own, so the
    n-gram proposer finds matches in the prompt (and in the tiny models'
    cycles)."""
    out = []
    for i in range(n):
        passage = rng.integers(0, 256, size=int(rng.integers(4, 9))).tolist()
        length = int(lengths[i % len(lengths)])
        out.append((passage * (length // len(passage) + 1))[:length])
    return out


def spec_engine_phase() -> list:
    """Tiny engines (float32) on the card under speculative decoding:
    through the scheduler in every SPEC_MODES mode and with both
    attention backends, greedy tokens identical to the plain baseline's;
    the n-gram modes accept proposals, run verify rounds at S 2 and 5
    through the prefill kernel, and fall back to the plain call at least
    once; the draft equal to the target accepts (nearly) every proposal;
    the pool is clean after every run."""
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.models.registry import build_model

    base = cfgs.EngineConfig(page_size=8, num_pages=128,
                             max_pages_per_seq=16, max_batch_size=4,
                             prefill_buckets=(16, 32),
                             decode_steps_per_call=4,
                             chunked_prefill_size=16)
    rng = np.random.default_rng(11)
    prompts = (_echo_prompts(rng, 8, (12, 20, 30, 9))
               + [rng.integers(0, 256, size=n).tolist() for n in (5, 14, 40,
                                                                  7)])
    max_new = 32
    done = []
    verify_lens: dict = {}
    for preset in ("tiny_llama", "tiny_mistral"):
        mcfg = getattr(cfgs, preset)(vocab_size=256)
        params, _ = build_model(mcfg, seed=SEED, device="cuda")
        want = _sched_run(InferenceEngine(mcfg, base, params=params,
                                          device="cuda"), prompts, max_new)
        for name, over in SPEC_MODES:
            draft = "spec_mode" not in over
            for backend in ("kernel", "dense"):
                pfa.reset_counts()
                pa.reset_counts()
                eng = InferenceEngine(
                    mcfg, dataclasses.replace(base, **over), params=params,
                    attn_backend=backend, device="cuda",
                    draft_cfg=mcfg if draft else None,
                    draft_params=params if draft else None)
                got = _sched_run(eng, prompts, max_new)
                label = f"{mcfg.name} {name} [{backend}]"
                if got != want:
                    diff = [i for i in want if want[i] != got[i]]
                    raise AssertionError(f"{label}: greedy tokens differ "
                                         f"from plain decode for {diff}")
                rec = {"label": label, "drafted": eng.spec_drafted,
                       "accepted": eng.spec_accepted,
                       "rounds": eng.spec_rounds_total,
                       "fallback_rounds": eng.spec_fallback_rounds,
                       "throttles": eng.spec_throttles_total,
                       "rung_peak": eng.rung_peak,
                       "preemptions": eng.preemptions_total,
                       "prefill_launches_by_len": {
                           str(k): v for k, v in
                           sorted(pfa.launches_by_len.items())},
                       "decode_launches": pa.launches}
                if draft:
                    if eng.spec_accepted < 0.9 * eng.spec_drafted or \
                            not eng.spec_drafted:
                        raise AssertionError(f"{label}: a draft equal to "
                                             f"the target accepted {rec}")
                    if backend == "kernel" and pa.launches:
                        raise AssertionError(f"{label}: the decode kernel "
                                             "ran in a dense spec round")
                elif eng.spec_rounds_total <= 0 or eng.spec_accepted <= 0:
                    raise AssertionError(f"{label}: no accepted verify "
                                         f"round: {rec}")
                if backend == "kernel":
                    for k, v in pfa.launches_by_len.items():
                        if k <= 5:
                            verify_lens[k] = verify_lens.get(k, 0) + v
                log(f"engine spec {label}: tokens identical to plain "
                    f"decode; pool clean; {json.dumps(rec)}")
                done.append(rec)
    fallbacks = sum(r["fallback_rounds"] for r in done)
    if not verify_lens.get(2) or not verify_lens.get(5) or not fallbacks:
        raise AssertionError(f"spec engines: verify launches by S "
                             f"{verify_lens}, {fallbacks} fallback rounds")
    return done


def chaos_phase() -> dict:
    """Fault injection on the card (tiny-llama float32, n-gram speculation
    at pipeline depth 2, in an EngineGroup with a step watchdog): arming
    step_failure_rate 1.0 through apply_chaos while verify rounds are in
    flight fails the running requests with an error record, health goes
    degraded then quarantined; after disarming and the cooldown it
    recovers, and the next requests finish "length" with the tokens of
    before the fault; a wedge longer than step_watchdog_s trips the
    watchdog; page pressure holds real pages and returns them; the pool
    is clean. The group's flight recorder writes under a temporary
    directory: the failures must leave a step_error capture and the
    wedge a watchdog capture, listed by blackbox_index newest first,
    each with step records."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip-smoke-blackbox-") as bb:
        return _chaos_run(bb)


def _chaos_run(blackbox_dir: str) -> dict:
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
    from tpu_inference_torch.server.replicas import EngineGroup

    mcfg = cfgs.tiny_llama(vocab_size=256)
    ecfg = cfgs.EngineConfig(page_size=8, num_pages=512,
                             max_pages_per_seq=128, max_batch_size=4,
                             prefill_buckets=(16, 32),
                             decode_steps_per_call=4,
                             decode_pipeline_depth=2,
                             latency_decode_threshold=0, **NGRAM)
    eng = InferenceEngine(mcfg, ecfg, seed=SEED, device="cuda")
    eng.warmup()
    group = EngineGroup([eng], cfgs.ServerConfig(
        quarantine_after_failures=2, quarantine_cooldown_s=0.5,
        step_watchdog_s=0.5, blackbox_dir=blackbox_dir))
    prompts = _echo_prompts(np.random.default_rng(12), 3, (18, 9, 26))
    states = []

    def submit(rid, prompt, max_new):
        ev = {"tokens": [], "done": threading.Event(), "seq": None}

        def fin(sq):
            ev["seq"] = sq
            ev["done"].set()
        group.submit(Sequence(request_id=rid, prompt_tokens=list(prompt),
                              max_new_tokens=max_new),
                     lambda sq, t: ev["tokens"].append(t), fin)
        return ev

    def run(base_id):
        evs = [submit(base_id + i, p, 24) for i, p in enumerate(prompts)]
        for ev in evs:
            if not ev["done"].wait(120):
                raise AssertionError("chaos phase: a request hung")
        if any(ev["seq"].finish_reason != "length" for ev in evs):
            raise AssertionError("chaos phase: a request did not finish "
                                 "with all its tokens")
        return [ev["tokens"] for ev in evs]

    def wait_for(pred, what):
        t_end = time.monotonic() + 60
        while not pred():
            if time.monotonic() > t_end:
                raise AssertionError(f"chaos phase: {what} never held")
            time.sleep(0.001)

    group.start()
    try:
        before = run(0)
        # Long enough to stream for a second or more on the card.
        long = [submit(10 + i, p, 900) for i, p in enumerate(prompts)]
        wait_for(lambda: all(ev["tokens"] for ev in long), "streaming")
        # The failure fires at the top of the next step, before that step
        # syncs the verify round staged by the one before: record the
        # calls the scheduler's failure path drops.
        aborted = []
        abort = eng.abort_pipeline

        def counted_abort():
            aborted.append(len(eng._inflight))
            abort()
        eng.abort_pipeline = counted_abort
        group.apply_chaos({"replica": 0, "step_failure_rate": 1.0})
        for ev in long:
            if not ev["done"].wait(60) or \
                    ev["seq"].finish_reason != "error":
                raise AssertionError("chaos phase: an armed failure did not "
                                     "fail the running requests")
        if not any(aborted):
            raise AssertionError(f"chaos phase: no call was in flight when "
                                 f"a step failed ({aborted})")
        states.append(group.health[0].state)
        if group.health[0].state != "quarantined":
            ev = submit(20, prompts[0], 4)
            ev["done"].wait(60)
            states.append(group.health[0].state)
        if states[-1] != "quarantined":
            raise AssertionError(f"chaos phase: health went {states}")
        group.apply_chaos({"replica": None, "step_failure_rate": 0.0})
        time.sleep(0.6)
        if group.health_snapshot()["status"] == "unavailable":
            raise AssertionError("chaos phase: no recovery after cooldown")
        after = run(30)
        if after != before:
            raise AssertionError("chaos phase: tokens after the fault "
                                 "differ from before it")
        states.append(group.health[0].state)
        failures = group.schedulers[0].stats.step_failures
        # A wedge past the watchdog's deadline.
        group.apply_chaos({"step_wedge_s": 1.5})
        wedged = submit(40, prompts[1], 4)
        if not wedged["done"].wait(60):
            raise AssertionError("chaos phase: wedged request hung")
        group.apply_chaos({"step_wedge_s": 0.0})
        wedges = group.health[0].wedges
        if wedges < 1 or wedged["seq"].finish_reason != "unavailable":
            raise AssertionError(f"chaos phase: the watchdog did not fire "
                                 f"({wedges} wedges, "
                                 f"{wedged['seq'].finish_reason})")
        wait_for(lambda: group.schedulers[0].step_inflight_since is None,
                 "the wedged call's end")
        # Page pressure holds real pages, then returns them.
        free = eng.allocator.num_free
        group.apply_chaos({"page_pressure": 40})
        wait_for(lambda: eng.allocator.num_free == free - 40, "pressure")
        held = eng.chaos_page_pressure
        group.apply_chaos({"page_pressure": 0})
        wait_for(lambda: eng.allocator.num_free == free, "pressure release")
        captures = group.blackbox_index()["captures"]
    finally:
        group.apply_chaos({"step_wedge_s": 0.0, "step_failure_rate": 0.0})
        group.stop(drain=True, timeout=30)
    eng.check_pool_clean()
    triggers = [c.get("trigger") for c in captures]
    ts = [c.get("ts") or 0.0 for c in captures]
    firsts = {t: triggers.index(t) for t in ("watchdog", "step_error")
              if t in triggers}
    if (len(firsts) != 2 or firsts["watchdog"] > firsts["step_error"]
            or ts != sorted(ts, reverse=True)
            or any(c.get("n_steps", 0) <= 0 for c in captures
                   if c.get("trigger") in firsts)):
        raise AssertionError(f"chaos phase: flight-recorder captures "
                             f"{captures}")
    return {"calls_in_flight_at_failures": aborted, "health_states": states,
            "step_failures": failures, "wedges": wedges,
            "pressure_pages_held": held,
            "spec_rounds": eng.spec_rounds_total,
            "blackbox": [{k: c.get(k) for k in ("file", "trigger",
                                                "n_steps", "n_spans")}
                         for c in captures]}


def _stream_request(port: int, prompt: str, max_tokens: int,
                    options: dict | None = None,
                    headers: dict | None = None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    body = {"model": "llama-3-8b", "prompt": prompt, "temperature": 0.0,
            "max_tokens": max_tokens, "stream": True}
    if options:
        body["options"] = options
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/api/generate", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        t_headers = time.perf_counter()   # headers wait for the 1st token
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()[:500]}")
        request_id = resp.getheader("X-Request-Id")
        lines = [json.loads(x) for x in resp.read().splitlines() if x]
        t_end = time.perf_counter()
    finally:
        conn.close()
    final = lines[-1]
    # A failed dispatch still ends the stream with done: true, but with
    # done_reason "error": only a normal finish passes.
    reason = final.get("done_reason")
    if (not final.get("done") or reason not in ("length", "stop")
            or final.get("eval_count", 0) <= 0
            or (reason == "length" and final["eval_count"] != max_tokens)):
        raise AssertionError(f"bad terminal record: {final}")
    if any(x["done"] for x in lines[:-1]):
        raise AssertionError("done record before the end of the stream")
    ctx = final["context"]
    if (len(ctx) != final["prompt_eval_count"] + final["eval_count"]
            or not all(0 <= t < 128256 for t in ctx)):
        raise AssertionError("context ids malformed")
    return {"ttft_s": t_headers - t0, "e2e_s": t_end - t0,
            "prompt_tokens": final["prompt_eval_count"],
            "eval_count": final["eval_count"],
            "eval_duration_s": final["eval_duration"] / 1e9,
            "done_reason": final["done_reason"], "context": ctx,
            "request_id": request_id}


def run_requests(port: int, prompts: list, max_tokens: int,
                 stagger_s: float = 0.0, options: dict | None = None,
                 headers: dict | None = None) -> tuple:
    """All prompts as concurrent streamed requests; (results, wall s).
    ``stagger_s`` between thread starts makes the server see them in
    order; ``options`` are the requests' Ollama options, ``headers``
    their extra HTTP headers."""
    results: list = [None] * len(prompts)
    errors: list = []

    def worker(i: int) -> None:
        try:
            results[i] = _stream_request(port, prompts[i], max_tokens,
                                         options, headers)
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(stagger_s)
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a main-path request did not finish")
    return results, wall


def server_stats(port: int) -> dict:
    """The server's stats snapshot (/metrics?format=json). Fails if any
    engine dispatch failed so far: the scheduler finishes the requests of
    a failed dispatch with done_reason "error" and counts it in
    step_failures, so no exception on the served path can pass."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/metrics?format=json")
        snap = json.loads(conn.getresponse().read())
    finally:
        conn.close()
    if snap["step_failures"] != 0:
        raise AssertionError(f"{snap['step_failures']} engine dispatches "
                             "failed on the main path")
    return snap


def engine_phases(snap: dict) -> dict:
    """The server's own phase histograms (count and total seconds of
    prefill and decode dispatches, host bubbles between decode calls,
    queue wait, server-side TTFT)."""
    return {k: {"count": v["count"], "sum_s": v["sum"]}
            for k, v in snap["phases"].items()}


def _kernel_class(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "paged_attention"
    if "paged_prefill_kernel" in name:
        return "prefill_attention"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "nvjet",
                                       "cublas")):
        return "matmul"
    if "copy_kernel" in name:     # dtype conversions (int8 codes -> bf16)
        return "copy_convert"
    return "other"


def profile_requests(port: int, prompts: list, max_tokens: int,
                     trace_path: str | None = None,
                     options: dict | None = None, engine=None) -> dict:
    """The same concurrent requests again, under torch.profiler: device
    time by kernel and by class, and the device's busy share of the
    window (and with ``trace_path`` the chrome trace, written there). With
    ``engine``, the step ledger's reading of the same window beside it
    (ledger_summary). A profiler that cannot trace here is reported, not
    fatal; a failed request is."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"error": repr(e)}
    try:
        t0 = time.perf_counter()
        run_requests(port, prompts, max_tokens, options=options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prof.stop()
    kernels = []
    try:
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0.0)
            if us > 0:
                kernels.append((evt.key, us / 1e3, evt.count))
    except RuntimeError as e:
        return {"error": repr(e)}
    if trace_path is not None:
        try:
            prof.export_chrome_trace(trace_path)
        except (RuntimeError, OSError) as e:
            log(f"chrome trace not written: {e!r}")
    busy = sum(ms for _, ms, _ in kernels)
    by_class: dict = {}
    for name, ms, _ in kernels:
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    kernels.sort(key=lambda k: -k[1])
    out = {"window_s": wall, "device_busy_ms": busy,
           "device_busy_share": busy / (wall * 1e3),
           "by_class_ms": by_class,
           "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                           for n, ms, c in kernels[:12]]}
    if engine is not None:
        out["ledger"] = ledger_summary(engine.telemetry.steps_report(
            window_s=time.perf_counter() - t0))
    return out


def ledger_summary(report: dict) -> dict:
    """The step ledger's reading (a /debug/steps replica report, or
    EngineTelemetry.steps_report): verdict, roofline fractions and walls
    by step kind, the MFU gauge and its replay."""
    fields = ("records", "tokens", "chunk_tokens", "verdict",
              "compute_frac", "hbm_frac", "host_frac", "device_s",
              "staging_s", "bubble_s", "compile_events")
    return {"records_window": report["records_window"],
            "records_total": report["records_total"],
            "truncated": report["truncated"],
            "kinds": {k: {f: v[f] for f in fields}
                      for k, v in report["kinds"].items()},
            "top_sinks": report["top_sinks"], "mfu": report["mfu"],
            "peaks": report["peaks"]}


# The served paths: (label, quant, kv_quant, the kernels' variant).
MAIN_PATHS = (("bf16", "none", "none", "bf16"),
              ("int8 weights + int8 KV", "int8", "int8", "int8"),
              ("int8 weights + int4 KV", "int8", "int4", "int4"))


def _prompts() -> list:
    """Six prompts spread over the buckets. Byte tokenizer: n bytes ->
    n + 1 tokens (BOS); 1500 > the 1024 bucket, so that one prefills in
    two chunks."""
    import random
    rng = random.Random(SEED)
    words = ["tensor", "page", "kernel", "hopper", "token", "cache",
             "stream", "batch", "warp", "prefill", "decode", "softmax"]

    def text(n_bytes: int) -> str:
        out = ""
        while len(out) < n_bytes:
            out += rng.choice(words) + " "
        return out[:n_bytes]

    return [text(n) for n in (40, 100, 200, 400, 900, 1500)]


def _free_card(label: str) -> int:
    """Bytes still allocated on the card before ``label`` boots; the
    previous lane's server must have given its memory back."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    if left > 2 * 2**30:
        raise AssertionError(f"{label}: {left / 1e9:.2f} GB still allocated "
                             "before boot; the previous server was not "
                             "freed")
    return left


def main_path_phase(label: str, quant: str, kv_quant: str, variant: str,
                    profile: bool = True, model: str = "llama-3-8b",
                    prompts: list | None = None, engine_kw: dict | None = None,
                    after=None) -> dict:
    """Boot ``model`` at full width with these quant modes, serve the six
    concurrent requests (``prompts``, default _prompts()) with every
    kernel count set to 0 just before and read just after, check every
    gate, run ``after(port, server)`` (extra checks, its dict kept), and
    free the server."""
    import gc

    from tpu_inference_torch.engine import autosize
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.server.http import build_server

    allocated_before = _free_card(label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = build_server(model, device="cuda", seed=SEED, enable_debug=True,
                          server_overrides={"profile_dir": PROFILE_DIR},
                          **{"max_pages_per_seq": 128, "num_pages": 512,
                             "max_batch_size": 8, "quant": quant,
                             "kv_quant": kv_quant, **(engine_kw or {})})
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    boot_peak = torch.cuda.max_memory_allocated()
    extra = {}
    try:
        port = server.start(port=0)
        prompts = prompts or _prompts()
        max_tokens = 48
        pa.reset_counts()
        pfa.reset_counts()
        results, wall = run_requests(port, prompts, max_tokens)
        by_variant = {"paged_attention": dict(pa.launches_by_variant),
                      "prefill_attention": dict(pfa.launches_by_variant)}
        launches = {"paged_attention": pa.launches,
                    "prefill_attention": pfa.launches}
        by_batch = {str(b): n for b, n in sorted(pa.launches_by_batch.items())}
        by_len = {str(n): c for n, c in sorted(pfa.launches_by_len.items())}
        by_path = dict(sorted(pfa.launches_by_path.items()))
        for name, counts in by_variant.items():
            others = {k: n for k, n in counts.items() if k != variant and n}
            if counts[variant] <= 0 or others:
                raise AssertionError(
                    f"{label}: {name} launched {counts}; the path must run "
                    f"its {variant} variant and no other")
        if (model == "llama-3-8b"
                and by_path.get(f"{variant}/wgmma", 0) <= 0):
            raise AssertionError(f"{label}: no prefill launch took the "
                                 f"long-query (wgmma) path: {by_path}")
        phases = engine_phases(server_stats(port))
        serve_peak = torch.cuda.max_memory_allocated()
        # Greedy determinism: the shortest prompt again, alone.
        again = _stream_request(port, prompts[0], max_tokens)
        if again["context"] != results[0]["context"]:
            raise AssertionError(f"{label}: greedy output not reproducible")
        if after is not None:
            extra = after(port, server)
        prof = (profile_requests(port, prompts, max_tokens,
                                 engine=server.engine) if profile
                else {"error": "not profiled on this path"})
        server_stats(port)
        n_layers = server.engine.model_cfg.n_layers
        weight_bytes = server.engine.weight_bytes
        kv_pool_bytes = sum(t.numel() * t.element_size()
                            for t in server.engine.kv if t is not None)
    finally:
        server.shutdown()
        del server
        gc.collect()
        torch.cuda.empty_cache()
    ttfts = sorted(r["ttft_s"] for r in results)
    total_eval = sum(r["eval_count"] for r in results)
    per_req = [r["eval_count"] / r["eval_duration_s"] for r in results
               if r["eval_duration_s"] > 0]
    if any(r["done_reason"] != "length" for r in results):
        raise AssertionError(f"{label}: a request did not finish 'length'")
    return {
        "label": label, "model": model, "layers": n_layers,
        "activations": "bfloat16", "quant": quant, "kv_quant": kv_quant,
        "variant": variant,
        "boot_s": boot_s, "boot_peak_bytes": boot_peak,
        "allocated_before_boot_bytes": allocated_before,
        "max_memory_allocated": serve_peak,
        "requests": len(results),
        "prompt_tokens": [r["prompt_tokens"] for r in results],
        "max_tokens": max_tokens,
        "ttft_s": [r["ttft_s"] for r in results],
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
        "decode_tok_s_per_request": per_req,
        "aggregate_tok_s": total_eval / wall, "wall_s": wall,
        "eval_tokens": total_eval, "launches": launches,
        "launches_by_variant": by_variant,
        "decode_launches_by_batch": by_batch,
        "prefill_launches_by_len": by_len,
        "prefill_launches_by_path": by_path,
        "launches_per_forward": n_layers,
        "done_reasons": [r["done_reason"] for r in results],
        "weight_bytes": weight_bytes, "kv_pool_bytes": kv_pool_bytes,
        "weight_read_bound_ms_per_step": (
            weight_bytes / autosize.detect_peak_hbm_bw() * 1e3),
        "decode_ms_per_token_per_request": [1e3 / x for x in per_req],
        "engine_phases": phases,
        "profile": prof,
        **extra,
    }


# Where the lanes' servers write POST /debug/profile traces.
PROFILE_DIR = os.path.join("build", "profile")


def _http(port: int, method: str, path: str, body=None) -> tuple:
    """(status, body bytes, perf_counter at the response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_headers = time.perf_counter()
        return resp.status, resp.read(), t_headers
    finally:
        conn.close()


def _http_json(port: int, method: str, path: str, body=None):
    status, raw, _ = _http(port, method, path, body)
    if status != 200:
        raise AssertionError(f"{method} {path}: HTTP {status}: {raw[:300]}")
    return json.loads(raw)


def steps_phase(port: int, label: str) -> dict:
    """GET /debug/steps beside /metrics?format=json, the lane idle. Gates:
    the kinds include prefill_chunk and decode, records_total equals the
    prefill plus decode dispatches the lane made, the MFU gauge is
    finite and positive."""
    import math
    rep = _http_json(port, "GET", "/debug/steps")["replicas"]["0"]
    phases = server_stats(port)["phases"]
    dispatches = (phases["prefill_dispatch_s"]["count"]
                  + phases["decode_dispatch_s"]["count"])
    if not {"prefill_chunk", "decode"} <= set(rep["kinds"]):
        raise AssertionError(f"{label}: ledger kinds {list(rep['kinds'])}")
    if rep["records_total"] != dispatches:
        raise AssertionError(f"{label}: {rep['records_total']} ledger "
                             f"records for {dispatches} dispatches")
    gauge = rep["mfu"]["gauge"]
    if gauge is None or not math.isfinite(gauge) or gauge <= 0:
        raise AssertionError(f"{label}: MFU gauge {gauge}")
    out = {**ledger_summary(rep), "dispatches": dispatches}
    log(f"[{label}] /debug/steps: verdicts "
        f"{json.dumps({k: v['verdict'] for k, v in rep['kinds'].items()})}"
        f", mfu {json.dumps(rep['mfu'])}")
    return out


CHAT = [{"role": "system", "content": "You answer in one short line."},
        {"role": "user", "content": "Name three prime numbers."}]


def chat_phase(port: int) -> dict:
    """/api/chat, unary then streamed (greedy, 16 tokens, the byte
    tokenizer's role-prefix transcript), then /api/generate with that
    transcript alone. The unary request caches the transcript's pages,
    so the streamed chat and the generate see the same prefix hit. Gates:
    chat records carry ``message`` and no ``context``/``response``, the
    streamed text equals the generate text, eval_count 16 (or an EOS
    "stop" at the generate's count)."""
    opts = {"num_predict": 16, "temperature": 0}
    body = {"model": "llama-3-8b", "messages": CHAT, "options": opts}
    unary = _http_json(port, "POST", "/api/chat", dict(body, stream=False))
    t0 = time.perf_counter()
    status, raw, t_headers = _http(port, "POST", "/api/chat",
                                   dict(body, stream=True))
    if status != 200:
        raise AssertionError(f"streamed chat: HTTP {status}")
    lines = [json.loads(x) for x in raw.splitlines() if x]
    streamed = "".join(x["message"]["content"] for x in lines)
    transcript = "\n".join(f"{m['role']}: {m['content']}"
                           for m in CHAT) + "\nassistant:"
    gen = _http_json(port, "POST", "/api/generate", {
        "model": "llama-3-8b", "prompt": transcript, "stream": False,
        "options": opts})
    for rec in (unary, lines[-1]):
        if ("context" in rec or "response" in rec or "message" not in rec
                or rec["eval_count"] != gen["eval_count"]
                or not (rec["eval_count"] == 16
                        or rec["done_reason"] == "stop")):
            raise AssertionError(f"chat record {rec}")
    if not all("message" in x and "response" not in x for x in lines):
        raise AssertionError("a streamed chat line without 'message'")
    if streamed != gen["response"]:
        raise AssertionError(f"chat text {streamed!r} != generate "
                             f"{gen['response']!r}")
    return {"ttft_streamed_s": t_headers - t0,
            "eval_count": lines[-1]["eval_count"],
            "done_reason": lines[-1]["done_reason"],
            "prompt_eval_count": gen["prompt_eval_count"],
            "unary_equals_streamed":
                unary["message"]["content"] == streamed}


def embed_phase(port: int, d_model: int) -> dict:
    """/api/embed with three inputs of 41, 200 and 500 tokens (byte
    tokenizer: n bytes and BOS), /api/embeddings with the first. Gates:
    [3, d_model], finite, the lone vector's cosine with row 0 >= 0.999
    (another bucket and lane count: bf16 GEMM rows depend on M), no two
    rows equal. Records the call's wall and the peak allocated memory."""
    texts = _family_prompts((40, 199, 499))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    embs = torch.tensor(_http_json(port, "POST", "/api/embed",
                                   {"input": texts})["embeddings"],
                        dtype=torch.float64)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    lone = torch.tensor(_http_json(port, "POST", "/api/embeddings",
                                   {"prompt": texts[0]})["embedding"],
                        dtype=torch.float64)
    cos = float(torch.nn.functional.cosine_similarity(lone, embs[0], dim=0))
    if tuple(embs.shape) != (3, d_model) or not bool(
            torch.isfinite(embs).all()):
        raise AssertionError(f"embeddings {tuple(embs.shape)}, finite "
                             f"{bool(torch.isfinite(embs).all())}")
    if cos < 0.999:
        raise AssertionError(f"lone embedding's cosine with row 0: {cos}")
    if any(torch.equal(embs[i], embs[j]) for i in range(3)
           for j in range(i + 1, 3)):
        raise AssertionError("distinct texts gave equal embeddings")
    return {"tokens": [41, 200, 500], "wall_s": wall,
            "max_memory_allocated": peak, "lone_cosine": cos}


def card_phase(port: int, engine) -> dict:
    """/api/show and /api/ps: the engine's parameter count and weight
    bytes, quantization level BF16."""
    show = _http_json(port, "POST", "/api/show", {"model": "llama-3-8b"})
    (ps,) = _http_json(port, "GET", "/api/ps")["models"]
    got = (show["model_info"]["general.parameter_count"], ps["size"],
           show["details"]["quantization_level"],
           ps["details"]["quantization_level"])
    if got != (engine.n_params, engine.weight_bytes, "BF16", "BF16"):
        raise AssertionError(f"model card {got}")
    return {"parameter_count": got[0], "size": got[1],
            "parameter_size": ps["details"]["parameter_size"]}


def profile_phase(port: int, server) -> dict:
    """POST /debug/profile {"seconds": 2} while requests stream: rounds
    of four concurrent requests (fresh prompts, so each prefills) run
    back to back until the capture returns, so the window sees prefills
    and decode steps whenever the profiler comes up. Gates: a trace
    under PROFILE_DIR/replica0 whose events name both hand-written
    kernels, and CPU op events on the engine thread's native id (the
    scheduler's ``thread_native_id``): the launch loop, not only the
    capturing thread."""
    got: dict = {}

    def capture() -> None:
        try:
            got["body"] = _http_json(port, "POST", "/debug/profile",
                                     {"seconds": 2})
        except AssertionError as e:
            got["error"] = e

    trace_dir = os.path.join(PROFILE_DIR, "replica0")
    before = set(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else set()
    th = threading.Thread(target=capture)
    t0 = time.perf_counter()
    th.start()
    rounds = 0
    while th.is_alive() and time.perf_counter() - t0 < 120:
        sizes = tuple(60 + 40 * rounds + 10 * i for i in range(4))
        run_requests(port, _family_prompts(sizes), 16)
        rounds += 1
    th.join(timeout=300)
    if "error" in got or th.is_alive():
        raise AssertionError(f"/debug/profile: {got.get('error')}")
    new = sorted(set(os.listdir(trace_dir)) - before)
    if got["body"]["dir"] != trace_dir or not new:
        raise AssertionError(f"/debug/profile wrote {new} ({got['body']})")
    with open(os.path.join(trace_dir, new[-1])) as f:
        text = f.read()
    names = {k: k in text for k in ("paged_decode_kernel",
                                    "paged_prefill_kernel")}
    if not all(names.values()):
        raise AssertionError(f"profile trace kernels: {names} "
                             f"({len(text)} bytes, {rounds} rounds)")
    engine_tid = server.group.schedulers[0].thread_native_id
    cpu_ops: dict = {}
    for ev in json.loads(text)["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            cpu_ops[ev.get("tid")] = cpu_ops.get(ev.get("tid"), 0) + 1
    engine_ops = cpu_ops.get(engine_tid, 0)
    if engine_ops <= 0:
        raise AssertionError(f"profile trace: no CPU op on the engine "
                             f"thread {engine_tid} (ops by thread "
                             f"{cpu_ops})")
    return {"trace": os.path.join(trace_dir, new[-1]),
            "trace_bytes": len(text), "request_rounds": rounds,
            "wall_s": time.perf_counter() - t0, "kernels_named": names,
            "engine_thread": engine_tid,
            "engine_thread_cpu_ops": engine_ops,
            "cpu_ops_by_thread": {str(k): n for k, n in cpu_ops.items()},
            **got["body"]}


def _span_add_cost_s(n: int = 10_000) -> float:
    """Median host wall of one SpanRecorder.add over ``n`` calls, eight
    spans per trace (a request's worth), on a recorder of its own."""
    from tpu_inference_torch.telemetry import SpanRecorder
    rec = SpanRecorder(enabled=True)
    walls = []
    for i in range(n):
        t = time.perf_counter()
        t0 = time.perf_counter_ns()
        rec.add("decode", f"cost-{i // 8}", t, t + 0.001,
                output_tokens=48, reason="length", preemptions=0)
        walls.append(time.perf_counter_ns() - t0)
    walls.sort()
    return walls[n // 2] / 1e9


def request_observability_phase(port: int) -> dict:
    """Six fresh streamed requests (the main path's lengths, new text),
    then the request half of observability. Gates: GET
    /debug/requests?n=6 gives their six timelines, each's queue +
    prefill + decode within 1 ms of its e2e; /debug/trace?id= of each
    is a tree rooted at ``request`` with route, queue_wait, prefill and
    decode, whose prefill and decode durations are within 1 ms of its
    timeline, and the chunked request's prefill_chunk children cover
    its uncached prompt; /debug/trace?format=chrome is
    trace-event JSON with one ``X`` event per span of every recent
    trace; /metrics' fleet tpu_inf_slo_ttft_seconds{q="0.5"} equals the
    exact quantile of the timelines' TTFTs (to their 6 decimals). Logs
    the host cost of one SpanRecorder.add, the spans per request and
    their share of the median request's e2e."""
    import re

    from tpu_inference_torch.telemetry import pooled_quantile
    t0 = time.perf_counter()
    results, _ = run_requests(port, _family_prompts(
        (41, 101, 201, 401, 901, 1501)), 48)
    ids = [r["request_id"] for r in results]
    timelines = _http_json(port, "GET", "/debug/requests?n=6")
    if sorted(t["trace_id"] for t in timelines) != sorted(ids):
        raise AssertionError(f"/debug/requests?n=6 gave "
                             f"{[t['trace_id'] for t in timelines]}, the "
                             f"requests were {ids}")
    for t in timelines:
        gap = abs(t["queue_wait_s"] + t["prefill_s"] + t["decode_s"]
                  - t["e2e_s"])
        if gap > 1e-3 or t["output_tokens"] != 48:
            raise AssertionError(f"timeline {t}: phases off e2e by {gap}")
    spans_per_request = []
    for t in timelines:
        snap = _http_json(port, "GET", f"/debug/trace?id={t['trace_id']}")
        spans_per_request.append(snap["n_spans"])
        root = snap["tree"]
        kids = {c["name"]: c for c in root["children"]}
        if (root["name"] != "request" or root.get("synthetic")
                or not {"route", "queue_wait", "prefill",
                        "decode"} <= set(kids)):
            raise AssertionError(f"trace {t['trace_id']}: root "
                                 f"{root['name']}, children {list(kids)}")
        for name, key in (("prefill", "prefill_s"), ("decode", "decode_s")):
            if abs(kids[name]["dur"] - t[key]) > 1e-3:
                raise AssertionError(f"trace {t['trace_id']}: {name} span "
                                     f"{kids[name]['dur']} s, timeline "
                                     f"{t[key]} s")
        chunks = [c for c in kids["prefill"]["children"]
                  if c["name"] == "prefill_chunk"]
        if t["prompt_tokens"] > 1024:
            covered = sum(c["attrs"]["tokens"] for c in chunks)
            if (len(chunks) < 2 or covered
                    != t["prompt_tokens"] - t["cached_tokens"]):
                raise AssertionError(f"chunked request's prefill_chunk "
                                     f"spans {len(chunks)} covering "
                                     f"{covered} tokens ({t})")
    everything = _http_json(port, "GET", "/debug/requests?n=256")
    chrome = _http_json(port, "GET", "/debug/trace?format=chrome")
    per_trace: dict = {}
    for ev in chrome["traceEvents"]:
        if ev["ph"] == "X" and ev.get("cat") == "request":
            if not all(isinstance(ev[k], (int, float))
                       for k in ("ts", "dur", "pid", "tid")):
                raise AssertionError(f"malformed trace event {ev}")
            tid = ev["args"]["trace_id"]
            per_trace[tid] = per_trace.get(tid, 0) + 1
    for t in everything:
        n = _http_json(port, "GET",
                       f"/debug/trace?id={t['trace_id']}")["n_spans"]
        if per_trace.get(t["trace_id"]) != n:
            raise AssertionError(f"chrome export: {per_trace.get(t['trace_id'])}"
                                 f" events for trace {t['trace_id']} of "
                                 f"{n} spans")
    status, raw, _ = _http(port, "GET", "/metrics")
    m = re.search(r'^tpu_inf_slo_ttft_seconds\{q="0\.5"\} (\S+)$',
                  raw.decode(), re.M)
    want = pooled_quantile([[t["ttft_s"] for t in everything]], 0.5)
    if status != 200 or m is None or abs(float(m.group(1)) - want) > 1e-6:
        raise AssertionError(f"tpu_inf_slo_ttft_seconds{{q=0.5}} "
                             f"{m and m.group(1)} != the timelines' exact "
                             f"p50 {want} ({len(everything)} requests)")
    add_s = _span_add_cost_s()
    e2e = sorted(t["e2e_s"] for t in timelines)[len(timelines) // 2]
    spans = sum(spans_per_request) / len(spans_per_request)
    out = {"requests": len(timelines), "timelines_total": len(everything),
           "spans_per_request": spans_per_request,
           "chrome_events": sum(per_trace.values()),
           "slo_ttft_p50_s": float(m.group(1)),
           "span_add_median_s": add_s, "median_e2e_s": e2e,
           "span_share_of_median_e2e": spans * add_s / e2e,
           "wall_s": time.perf_counter() - t0}
    log(f"[bf16] request observability: SpanRecorder.add median "
        f"{add_s * 1e6:.2f} us over 10000 calls; {spans:.1f} spans per "
        f"request = {out['span_share_of_median_e2e']:.2e} of the median "
        f"e2e {e2e:.3f} s")
    return out


def observability_phase(port: int, server) -> dict:
    """The bf16 lane's server, after its requests: the request half of
    observability (request_observability_phase), the step ledger
    (steps_phase), /api/chat, the embeddings, the model card and a
    /debug/profile capture, each with its own gates."""
    t0 = time.perf_counter()
    out = {"requests": request_observability_phase(port)}
    out["steps"] = steps_phase(port, "bf16")
    out["chat"] = chat_phase(port)
    out["embed"] = embed_phase(port, server.engine.model_cfg.d_model)
    out["model_card"] = card_phase(port, server.engine)
    out["profile"] = profile_phase(port, server)
    out["wall_s"] = time.perf_counter() - t0
    log(f"[bf16] observability phase: {json.dumps(out)}")
    return {"observability": out}


def _family_prompts(sizes) -> list:
    """Prompts of these byte lengths, as _prompts() makes them."""
    import random
    rng = random.Random(SEED + 1)
    words = ["expert", "router", "token", "layer", "norm", "position",
             "cache", "stream", "gate", "kernel", "page", "softmax"]
    out = []
    for n in sizes:
        text = ""
        while len(text) < n:
            text += rng.choice(words) + " "
        out.append(text[:n])
    return out


def mixtral_phase(card: str) -> dict:
    """Mixtral-8x7B at full width (d_model 4096, 32/8 heads, 8 experts
    top-2, d_ff 14336, vocab 32000; main() cuts its 32 layers to
    CUT_LAYERS) with int8 weights over an int8 pool, batch 8: the full
    46.7B parameters do not fit the card in bf16.
    The six requests of the llama lanes; expert capacity at the default
    factor 2.0, so tokens may drop as the reference drops them."""
    label = "mixtral-8x7b int8 + int8 KV"
    mp = main_path_phase(label, "int8", "int8", "int8", model="mixtral-8x7b",
                         after=lambda port, _: {
                             "steps": steps_phase(port, label)})
    prof = mp["profile"]
    if "by_class_ms" in prof:
        mp["int8_to_bf16_share_of_busy"] = (
            prof["by_class_ms"].get("copy_convert", 0.0)
            / max(prof["device_busy_ms"], 1e-9))
    return mp


GPT2_MAX_POS = 1024


def gpt2_phase(card: str) -> dict:
    """GPT-2 at full width (12 layers, d_model 768, 12/12 heads, vocab
    50257, bf16), batch 8: six concurrent requests whose prompts and 48
    new tokens stay inside the 1024 learned positions (the longest, 976
    tokens, prefills in two 512-token chunks), then one request alone
    that runs past position 1023. There the reference's XLA gather reads
    the table's last row; the port clamps to it: the request must finish
    with all its tokens, and a forward over positions past the table
    must equal the forward with the positions clamped."""
    sizes = (40, 100, 200, 400, 700, GPT2_MAX_POS - 48 - 1)

    def past_the_table(port: int, server) -> dict:
        from tpu_inference_torch.models import common, gpt2
        r = _stream_request(port, _family_prompts((1000,))[0], 48)
        last = r["prompt_tokens"] + r["eval_count"] - 1
        if last < GPT2_MAX_POS or r["done_reason"] != "length":
            raise AssertionError(f"gpt2: the long request did not cross "
                                 f"position {GPT2_MAX_POS}: {r}")
        eng = server.engine
        toks = torch.tensor([r["context"][:1100]], device="cuda")
        pos = torch.arange(toks.shape[1], device="cuda")[None]
        attn = common.make_dense_attn()
        with torch.no_grad():
            a, _ = gpt2.forward(eng.params, eng.model_cfg, toks, pos, None,
                                attn)
            b, _ = gpt2.forward(eng.params, eng.model_cfg, toks,
                                pos.clamp(max=GPT2_MAX_POS - 1), None, attn)
        if not (torch.isfinite(a).all() and torch.equal(a, b)):
            raise AssertionError("gpt2: positions past the table do not "
                                 "read its last row")
        return {"past_the_table": {"prompt_tokens": r["prompt_tokens"],
                                   "last_position": last,
                                   "ttft_s": r["ttft_s"],
                                   "eval_count": r["eval_count"]}}

    return main_path_phase("gpt2 bf16", "none", "none", "bf16", model="gpt2",
                           prompts=_family_prompts(sizes),
                           engine_kw={"chunked_prefill_size": 512},
                           after=past_the_table)


def checkpoint_phase(card: str) -> dict:
    """A random GPT-2 at full width (seed 0, bf16) written as an HF
    directory (config.json + model.safetensors) under build/, served
    through the CLI's path with ``--model auto --checkpoint DIR
    --check-numerics``: four requests one at a time must give the tokens
    of the same weights carried in by params_from_numpy and served the
    same way. Not run (and recorded so) when safetensors is missing."""
    try:
        from safetensors.torch import save_file
    except ImportError as e:
        log(f"checkpoint lane: not run ({e!r}: safetensors is not "
            "importable here)")
        return {"label": "checkpoint", "run": False, "reason": repr(e)}
    import gc

    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models import gpt2, weights
    from tpu_inference_torch.server.http import InferenceServer

    _free_card("checkpoint")
    cfg = cfgs.gpt2_small()
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), "cuda")
    sd = {hf: params[leaf] for leaf, hf in weights.GPT2_TOP_KEYS.items()}
    for leaf, hf in weights.GPT2_BLOCK_KEYS.items():
        for i in range(cfg.n_layers):
            sd[f"h.{i}.{hf}"] = params["blocks"][leaf][i]
    sd = {k: v.contiguous().cpu() for k, v in sd.items()}
    del params
    path = os.path.join("build", "gpt2-checkpoint")
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "gpt2", "vocab_size": cfg.vocab_size,
                   "n_embd": cfg.d_model, "n_layer": cfg.n_layers,
                   "n_head": cfg.n_heads, "n_positions": cfg.max_seq_len,
                   "layer_norm_epsilon": cfg.norm_eps,
                   "torch_dtype": "bfloat16"}, f)
    write_s = time.perf_counter() - t0
    prompts = _family_prompts((30, 200, 600, 900))
    flags = ["--model", "auto", "--checkpoint", path, "--check-numerics",
             "--max-pages-per-seq", "128", "--num-pages", "512",
             "--max-batch-size", "8", "--host-cache-pages", "0"]

    def serve(server) -> list:
        try:
            port = server.start(port=0)
            return [_stream_request(port, p, 32)["context"] for p in prompts]
        finally:
            server.shutdown()

    t0 = time.perf_counter()
    server, _ = _serve_cli(flags)
    load_s = time.perf_counter() - t0
    if server.tags()["models"][0]["details"]["family"] != "gpt2":
        raise AssertionError("checkpoint: /api/tags does not say gpt2")
    loaded = server.engine.params
    carried = weights.params_from_numpy(weights.convert_gpt2(
        cfg, {k: v.float().numpy() for k, v in sd.items()}), cfg, "cuda")
    same = all(torch.equal(a, b) for a, b in zip(
        _tensors(loaded), _tensors(carried)))
    if not same:
        raise AssertionError("checkpoint: loaded weights differ from the "
                             "params_from_numpy tree")
    del loaded
    from_ckpt = serve(server)
    ref_cfg = dataclasses.replace(server.cfg, checkpoint_path=None)
    del server
    gc.collect()
    engine = InferenceEngine(ref_cfg.model, ref_cfg.engine, params=carried,
                             device="cuda")
    from_numpy = serve(InferenceServer(ref_cfg, engine=engine))
    del engine, carried
    gc.collect()
    torch.cuda.empty_cache()
    if from_ckpt != from_numpy:
        raise AssertionError("checkpoint: greedy tokens differ from the "
                             "same weights served from params_from_numpy")
    return {"label": "checkpoint", "run": True, "model": "gpt2",
            "bytes": os.path.getsize(os.path.join(path,
                                                  "model.safetensors")),
            "write_s": write_s, "boot_with_check_numerics_s": load_s,
            "requests": len(prompts),
            "tokens_equal": True}


def _tensors(tree) -> list:
    return [t for v in tree.values()
            for t in (_tensors(v) if isinstance(v, dict) else [v])]


def _burst_prompts(n: int, echo: bool = False) -> list:
    """``n`` prompts whose lengths are the ``Request tokens`` of BurstGPT
    rows drawn with numpy from SEED (capped at 1500 tokens); byte
    tokenizer: n - 1 bytes -> n tokens (BOS). Random letters; with
    ``echo`` each prompt repeats a 48-byte random passage of its own (no
    two prompts share a prefix), so the n-gram proposer finds matches."""
    import csv

    import numpy as np
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "BurstGPT_1.csv")) as f:
        lens = np.asarray([int(float(r["Request tokens"]))
                           for r in csv.DictReader(f)])
    pick = np.random.default_rng(SEED).choice(len(lens), n, replace=False)
    rng = np.random.default_rng(SEED + 1)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    sizes = [max(1, min(int(lens[i]), 1500) - 1) for i in pick]
    if not echo:
        return [rng.choice(letters, k).tobytes().decode() for k in sizes]
    return [np.resize(rng.choice(letters, 48), k).tobytes().decode()
            for k in sizes]


def _serve_cli(flags: list):
    """Boot the server the way ``python -m tpu_inference_torch.server``
    does with these flags (its parser, its "auto" resolution, its
    numerics check); returns (server, the resolved EngineConfig
    fields)."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    parser = build_parser()
    return boot_server(parser.parse_args(flags), parser)


def _check_variant(label: str, variant: str, need_decode: bool = True
                   ) -> dict:
    """Both kernels ran the path's variant and no other since the last
    reset (the decode kernel may not have run at all when not
    ``need_decode``); returns the counts by variant (and the decode's by
    batch, the prefill's by query length)."""
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    by_variant = {"paged_attention": dict(pa.launches_by_variant),
                  "prefill_attention": dict(pfa.launches_by_variant)}
    for name, counts in by_variant.items():
        others = {k: n for k, n in counts.items() if k != variant and n}
        unused = counts[variant] <= 0 and (need_decode
                                           or name != "paged_attention")
        if unused or others:
            raise AssertionError(
                f"{label}: {name} launched {counts}; the path must run "
                f"its {variant} variant and no other")
    return {"by_variant": by_variant,
            "decode_by_batch": {str(b): n for b, n in
                                sorted(pa.launches_by_batch.items())},
            "prefill_by_len": {str(s): n for s, n in
                               sorted(pfa.launches_by_len.items())},
            "prefill_by_path": dict(sorted(pfa.launches_by_path.items()))}


def _summarize(results: list, wall: float) -> dict:
    ttfts = sorted(r["ttft_s"] for r in results)
    per_req = [r["eval_count"] / r["eval_duration_s"] for r in results
               if r["eval_duration_s"] > 0]
    total = sum(r["eval_count"] for r in results)
    return {"requests": len(results), "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_max_s": ttfts[-1], "wall_s": wall,
            "aggregate_tok_s": total / wall, "eval_tokens": total,
            "decode_tok_s_per_request": per_req,
            "prompt_tokens": [r["prompt_tokens"] for r in results]}


# Every llama-3-8b lane but the bf16 main path, the draft lane and the sp
# phase's ring lane, and the Mixtral lane, serve their model at full
# width cut to this many of its 32 layers (their host-bound walls scale
# with the layers; the script must stay well inside its time limit).
CUT_LAYERS = 8


@contextlib.contextmanager
def _depth_cut(model: str, n_layers: int):
    """Serve preset ``model`` at full width but only its first
    ``n_layers`` layers while the block runs (the CLI resolves presets
    at boot)."""
    from tpu_inference_torch import config as cfgs
    full = cfgs.PRESETS[model]
    cfgs.PRESETS[model] = lambda: dataclasses.replace(full(),
                                                      n_layers=n_layers)
    try:
        yield
    finally:
        cfgs.PRESETS[model] = full


def reference_config_phase(card: str) -> dict:
    """The reference's chip configuration (its benchmarks' serving flags)
    on the port: llama-3-8b at full width (main() cuts its depth to
    CUT_LAYERS layers), int8 weights + int8 KV, batch
    and pool sized from the card, decode ladder auto, pipeline depth 2,
    hybrid prefill, host tier auto. 32 concurrent BurstGPT-length
    requests (48 greedy tokens each), then 4 alone so the ladder steps
    down. Gates: every request "length" with all its tokens, no failed
    dispatch, the ladder tops out at 32 and was reached, at least one
    rung switch and one hybrid step, int8 kernel variants only. The
    prompts repeat a passage each (``_burst_prompts(echo=True)``), the
    traffic of the n-gram lane (ngram_phase), which counts the requests
    whose tokens differ from these."""
    import gc

    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    label = "reference chip config"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, ea = _serve_cli([
        "--model", "llama-3-8b", "--quant", "int8", "--kv-quant", "int8",
        "--max-batch-size", "auto", "--num-pages", "auto", "--batch-cap",
        "32", "--max-pages-per-seq", "128", "--decode-pipeline-depth", "2",
        "--hybrid-prefill", "--step-ledger-depth", "4096",
        "--seed", str(SEED)])
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    eng = server.engine
    sizing = {"layers": eng.model_cfg.n_layers,
              "max_batch_size": ea["max_batch_size"],
              "num_pages": ea["num_pages"],
              "decode_ladder": list(eng.ladder),
              "host_cache_pages": ea["host_cache_pages"],
              "card_total_memory": torch.cuda.get_device_properties(
                  0).total_memory,
              "weight_bytes": eng.weight_bytes,
              "kv_pool_bytes": sum(t.numel() * t.element_size()
                                   for t in eng.kv if t is not None)}
    log(f"[{label}] sized on {card}: {json.dumps(sizing)}")
    if eng.ladder[-1] != 32:
        raise AssertionError(f"{label}: ladder {eng.ladder} does not top "
                             "out at 32")
    try:
        port = server.start(port=0)
        prompts = _burst_prompts(32, echo=True)
        max_tokens = 48
        pa.reset_counts()
        pfa.reset_counts()
        results, wall = run_requests(port, prompts, max_tokens)
        snap32 = server_stats(port)
        alone = []
        t_alone = time.perf_counter()
        for p in prompts[:4]:
            alone.append(_stream_request(port, p, max_tokens))
        alone_wall = time.perf_counter() - t_alone
        launches = _check_variant(label, "int8")
        snap = server_stats(port)
        if snap["rung_peak"] != 32 or snap["rung_switches"] < 1:
            raise AssertionError(f"{label}: rung peak {snap['rung_peak']}, "
                                 f"{snap['rung_switches']} switches")
        if snap["hybrid_steps"] < 1:
            raise AssertionError(f"{label}: no hybrid step ran")
        peak_mem = torch.cuda.max_memory_allocated()
        prof = profile_requests(port, prompts, max_tokens, engine=eng)
        server_stats(port)
    finally:
        server.shutdown()
        del server, eng
        gc.collect()
        torch.cuda.empty_cache()
    out = {"label": label, "model": "llama-3-8b", "quant": "int8",
           "kv_quant": "int8", "variant": "int8", "boot_s": boot_s,
           "layers": sizing["layers"], "sizing": sizing, "max_memory_allocated": peak_mem,
           **_summarize(results, wall),
           "alone": _summarize(alone, alone_wall),
           "launches": {"paged_attention": sum(launches["by_variant"][
               "paged_attention"].values()), "prefill_attention": sum(
               launches["by_variant"]["prefill_attention"].values())},
           "launches_by_variant": launches["by_variant"],
           "decode_launches_by_batch": launches["decode_by_batch"],
           "done_reasons": [r["done_reason"] for r in results + alone],
           "rung_peak": snap["rung_peak"],
           "rung_switches": snap["rung_switches"],
           "rung_calls": snap["rung_calls"],
           "rung_calls_32_concurrent": snap32["rung_calls"],
           "mean_batch_occupancy": snap["mean_batch_occupancy"],
           "mean_batch_occupancy_32_concurrent":
               snap32["mean_batch_occupancy"],
           "steps_32_concurrent": snap32["steps"],
           "hybrid_steps": snap["hybrid_steps"],
           "decode_pipeline_depth": snap["decode_pipeline_depth"],
           "decode_call_s": snap["decode_call_s"],
           "prefill_launches_by_len": launches["prefill_by_len"],
           "prefill_launches_by_path": launches["prefill_by_path"],
           "engine_phases": engine_phases(snap), "profile": prof,
           "generated": [r["context"][r["prompt_tokens"]:]
                         for r in results + alone]}
    return out


# Requests of the pressure run that return one by one, twice (a count
# that keeps the whole script near 11 minutes).
RETURNING = 4


def pressure_phase(card: str) -> dict:
    """The same model and int8 tiers over a pool of a few hundred pages:
    optimistic admission, a fixed host tier. The 32 BurstGPT requests,
    then the first RETURNING again (their prefixes return from the host
    tier), then those once more: greedy output must reproduce between
    the two runs. Gates: preemptions, pages offloaded and restored,
    every request "length" with all its tokens, no failed dispatch. The
    pool holds the first 8 requests whole, so the returning ones run
    unpreempted; they run one after another, so both runs group the same
    rows into each library GEMM (gemm_rung_evidence: a row's result can
    depend on the call's row count)."""
    import gc

    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    label = "pressure"
    prompts = _burst_prompts(32)
    max_tokens = 48
    # The pool: the first 8 requests' full need (byte tokenizer: a
    # prompt of n bytes is n + 1 tokens) plus 3 pages, so they run whole
    # while the 32, arriving in order, admit a 9th lane on prompt + 2
    # pages of headroom and outgrow the pool.
    need8 = sum(-(-(len(p) + 1 + max_tokens) // 16) for p in prompts[:8])
    num_pages = need8 + 4
    t0 = time.perf_counter()
    server, ea = _serve_cli([
        "--model", "llama-3-8b", "--quant", "int8", "--kv-quant", "int8",
        "--max-batch-size", "32", "--num-pages", str(num_pages),
        "--max-pages-per-seq", "128", "--decode-pipeline-depth", "2",
        "--hybrid-prefill", "--admission", "optimistic",
        "--host-cache-pages", "4096", "--seed", str(SEED)])
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    try:
        port = server.start(port=0)
        pa.reset_counts()
        pfa.reset_counts()
        results, wall = run_requests(port, prompts, max_tokens,
                                     stagger_s=0.01)
        t8 = time.perf_counter()
        first8 = [_stream_request(port, p, max_tokens)
                  for p in prompts[:RETURNING]]
        wall8 = time.perf_counter() - t8
        snap8 = server_stats(port)
        again8 = [_stream_request(port, p, max_tokens)
                  for p in prompts[:RETURNING]]
        launches = _check_variant(label, "int8")
        snap = server_stats(port)
    finally:
        server.shutdown()
        del server
        gc.collect()
        torch.cuda.empty_cache()
    differ = [i for i, (a, b) in enumerate(zip(first8, again8))
              if a["context"] != b["context"]]
    if differ:
        raise AssertionError(f"{label}: greedy output of the returning "
                             f"requests {differ} not reproducible")
    pc = snap["prefix_cache"]
    if (snap["preemptions"] < 1 or pc["offloaded_pages"] < 1
            or pc["restored_pages"] < 1):
        raise AssertionError(f"{label}: preemptions {snap['preemptions']}, "
                             f"offloaded {pc['offloaded_pages']}, restored "
                             f"{pc['restored_pages']}")
    return {"label": label, "model": "llama-3-8b", "quant": "int8",
            "kv_quant": "int8", "variant": "int8", "boot_s": boot_s,
            "num_pages": num_pages, "host_cache_pages": 4096,
            **_summarize(results, wall),
            "returning": _summarize(first8, wall8),
            "launches": {"paged_attention": sum(launches["by_variant"][
                "paged_attention"].values()), "prefill_attention": sum(
                launches["by_variant"]["prefill_attention"].values())},
            "launches_by_variant": launches["by_variant"],
            "decode_launches_by_batch": launches["decode_by_batch"],
            "prefill_launches_by_len": launches["prefill_by_len"],
            "prefill_launches_by_path": launches["prefill_by_path"],
            "done_reasons": [r["done_reason"]
                             for r in results + first8 + again8],
            "preemptions": snap["preemptions"],
            "recompute_resumes": snap["recompute_resumes"],
            "swap_in_resumes": snap["swap_in_resumes"],
            "preemptions_before_returning": snap8["preemptions"],
            "prefix_cache": pc, "rung_peak": snap["rung_peak"],
            "hybrid_steps": snap["hybrid_steps"],
            "engine_phases": engine_phases(snap)}


def _verify_prefill_ms(trace_path: str) -> dict:
    """Device ms of the prefill kernel split by what launched it, from a
    torch.profiler chrome trace: a verify round's launch has one row
    tile per (kv-head, lane) (S x n_rep <= 64 rows), a prompt chunk's
    more (buckets of 64 tokens and up; the mma kernel's row tiles are
    grid.x, the wgmma and simt kernels' grid.y)."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = {"verify_ms": 0.0, "verify_launches": 0, "prompt_ms": 0.0,
           "prompt_launches": 0}
    for ev in events:
        if "paged_prefill_kernel" not in str(ev.get("name", "")) or \
                "dur" not in ev:
            continue
        grid = (ev.get("args") or {}).get("grid")
        if not grid:
            return {"error": "kernel events carry no grid"}
        mma = "paged_prefill_kernel_mma" in str(ev["name"])
        kind = "verify" if grid[0 if mma else 1] == 1 else "prompt"
        out[f"{kind}_ms"] += ev["dur"] / 1e3
        out[f"{kind}_launches"] += 1
    return out


# Ollama options of the n-gram lane's repetitive traffic: a repetition
# penalty below 1 favours the last 64 tokens (a positive logit is divided
# by it), so the random-weight model falls into the loops the proposer
# catches. Its greedy output on the echo prompts alone repeats almost no
# token (the ``speculative_plain_options`` block of the report): the
# prompts are byte ids, and the model draws from all 128256.
LOOP_OPTIONS = {"repeat_penalty": 0.2, "repeat_last_n": 64}


def ngram_phase(card: str, plain: dict) -> dict:
    """n-gram speculation at full width (main() cuts its depth to
    CUT_LAYERS layers, as the reference lane's): the reference chip
    configuration (CLI flags as reference_config_phase, hybrid prefill
    included, which
    is inert under speculation) plus ``--spec-mode ngram
    --num-speculative-tokens 4``. Traffic: the plain run's 32 echo
    prompts with its options (their tokens are compared with the plain
    run's), then the same 32 with LOOP_OPTIONS, then 4 of them alone with
    LOOP_OPTIONS, twice. Gates: every request "length" with all its
    tokens, no failed dispatch, verify rounds ran, no hybrid step, both
    kernels on their int8 variants only, the prefill kernel's S 2 and 5
    launches exactly one forward's per verify round, the decode kernel
    only in fallback rounds (at most layers x K per fallback), the 4
    alone reproducible. Reported, not gated (cuBLAS rows depend on M,
    and a verify forward runs at M = B x (γ+1)): requests whose tokens
    differ from the plain run's."""
    import gc

    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    label = "ngram spec"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, ea = _serve_cli([
        "--model", "llama-3-8b", "--quant", "int8", "--kv-quant", "int8",
        "--max-batch-size", "auto", "--num-pages", "auto", "--batch-cap",
        "32", "--max-pages-per-seq", "128", "--decode-pipeline-depth", "2",
        "--hybrid-prefill", "--spec-mode", "ngram",
        "--num-speculative-tokens", "4", "--step-ledger-depth", "4096",
        "--seed", str(SEED)])
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    eng = server.engine
    n_layers = eng.model_cfg.n_layers
    k_steps = eng.engine_cfg.decode_steps_per_call
    try:
        port = server.start(port=0)
        prompts = _burst_prompts(32, echo=True)
        max_tokens = 48
        pa.reset_counts()
        pfa.reset_counts()
        same, same_wall = run_requests(port, prompts, max_tokens)
        snap_same = server_stats(port)
        results, wall = run_requests(port, prompts, max_tokens,
                                     options=LOOP_OPTIONS)
        snap32 = server_stats(port)
        alone, alone_again = [], []
        t_alone = time.perf_counter()
        for p in prompts[:4]:
            alone.append(_stream_request(port, p, max_tokens, LOOP_OPTIONS))
        alone_wall = time.perf_counter() - t_alone
        for p in prompts[:4]:
            alone_again.append(_stream_request(port, p, max_tokens,
                                               LOOP_OPTIONS))
        launches = _check_variant(label, "int8", need_decode=False)
        snap = server_stats(port)
        spec = snap["speculative"]
        by_len = {int(k): v for k, v in launches["prefill_by_len"].items()}
        verify_launches = sum(v for k, v in by_len.items() if k <= 17)
        decode_launches = sum(launches["by_variant"][
            "paged_attention"].values())
        if spec["rounds"] <= 0 or snap["hybrid_steps"]:
            raise AssertionError(f"{label}: {spec['rounds']} verify rounds, "
                                 f"{snap['hybrid_steps']} hybrid steps")
        if set(k for k in by_len if k <= 17) - {2, 5} or \
                verify_launches != n_layers * spec["rounds"]:
            raise AssertionError(f"{label}: prefill launches by S {by_len} "
                                 f"for {spec['rounds']} verify rounds")
        if decode_launches > n_layers * k_steps * spec["fallback_rounds"]:
            raise AssertionError(f"{label}: {decode_launches} decode kernel "
                                 f"launches for {spec['fallback_rounds']} "
                                 "fallback rounds")
        if [r["context"] for r in alone] != \
                [r["context"] for r in alone_again]:
            raise AssertionError(f"{label}: the 4 requests alone do not "
                                 "reproduce")
        peak_mem = torch.cuda.max_memory_allocated()
        os.makedirs("build", exist_ok=True)
        trace = os.path.join("build", "ngram_profile.json")
        prof = profile_requests(port, prompts, max_tokens, trace_path=trace,
                                options=LOOP_OPTIONS, engine=server.engine)
        if os.path.exists(trace):
            try:
                prof["prefill_kernel_split"] = _verify_prefill_ms(trace)
            except (OSError, ValueError, TypeError) as e:
                prof["prefill_kernel_split"] = {"error": repr(e)}
            os.remove(trace)
        server_stats(port)
    finally:
        server.shutdown()
        del server, eng
        gc.collect()
        torch.cuda.empty_cache()
    generated = [r["context"][r["prompt_tokens"]:] for r in same]
    differ = [i for i, (a, b) in enumerate(zip(generated,
                                               plain["generated"]))
              if a != b]
    return {"label": label, "model": "llama-3-8b", "quant": "int8",
            "kv_quant": "int8", "variant": "int8", "boot_s": boot_s,
            "layers": n_layers, "max_memory_allocated": peak_mem,
            "options": LOOP_OPTIONS, **_summarize(results, wall),
            "plain_options_run": _summarize(same, same_wall),
            "alone": _summarize(alone, alone_wall),
            "launches": {"paged_attention": decode_launches,
                         "prefill_attention": sum(launches["by_variant"][
                             "prefill_attention"].values())},
            "launches_by_variant": launches["by_variant"],
            "decode_launches_by_batch": launches["decode_by_batch"],
            "prefill_launches_by_len": launches["prefill_by_len"],
            "prefill_launches_by_path": launches["prefill_by_path"],
            "verify_rounds_by_width": {str(k): v // n_layers for k, v in
                                       sorted(by_len.items()) if k <= 17},
            "done_reasons": [r["done_reason"] for r in
                             same + results + alone + alone_again],
            "speculative": spec,
            "speculative_plain_options": snap_same["speculative"],
            "speculative_32_concurrent": snap32["speculative"],
            "requests_differing_from_plain": differ,
            "rung_calls": snap["rung_calls"],
            "rung_calls_plain_options": snap_same["rung_calls"],
            "rung_calls_32_concurrent": snap32["rung_calls"],
            "hybrid_steps": snap["hybrid_steps"],
            "mean_batch_occupancy": snap["mean_batch_occupancy"],
            "engine_phases": engine_phases(snap), "profile": prof}


def draft_phase(card: str) -> dict:
    """Draft-model speculation at full width: llama-3-8b bf16 as the
    target and as its own draft (the target's params; one weight set,
    two pools), γ 4, 4 concurrent requests of 32 tokens. Gates: every
    request "length" with all its tokens, no failed dispatch, acceptance
    above 0.5, the draft's prefill runs the bf16 prefill kernel beside
    the target's (two forwards per prefill call), and the decode kernel
    never launches (the reference's spec_round attends on the dense
    path)."""
    import gc

    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.models.registry import build_model
    from tpu_inference_torch.server.http import InferenceServer
    label = "draft spec"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mcfg = cfgs.PRESETS["llama-3-8b"]()
    ecfg = cfgs.EngineConfig(max_pages_per_seq=128, num_pages=512,
                             max_batch_size=8, num_speculative_tokens=4)
    params, _ = build_model(mcfg, seed=SEED, device="cuda")
    engine = InferenceEngine(mcfg, ecfg, params=params, device="cuda",
                             draft_cfg=mcfg, draft_params=params)
    server = InferenceServer(cfgs.FrameworkConfig(
        model=mcfg, engine=ecfg, server=cfgs.ServerConfig(
            model_name="llama-3-8b", tokenizer="byte")), engine=engine)
    del params
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    n_layers = mcfg.n_layers
    try:
        port = server.start(port=0)
        prompts = _prompts()[:4]
        max_tokens = 32
        pa.reset_counts()
        pfa.reset_counts()
        results, wall = run_requests(port, prompts, max_tokens)
        snap = server_stats(port)
        by_variant = {"paged_attention": dict(pa.launches_by_variant),
                      "prefill_attention": dict(pfa.launches_by_variant)}
        spec = snap["speculative"]
        prefills = snap["phases"]["prefill_dispatch_s"]["count"] if \
            "prefill_dispatch_s" in snap["phases"] else None
        peak_mem = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        del server, engine
        gc.collect()
        torch.cuda.empty_cache()
    pf = by_variant["prefill_attention"]
    if pa.launches or any(n for k, n in pf.items() if k != "bf16"):
        raise AssertionError(f"{label}: decode kernel launches "
                             f"{by_variant['paged_attention']}, prefill "
                             f"{pf}")
    if not prefills or pf["bf16"] != 2 * n_layers * prefills:
        raise AssertionError(f"{label}: {pf['bf16']} bf16 prefill launches "
                             f"are not two forwards of {n_layers} layers "
                             f"for each of {prefills} prefill calls")
    if spec["acceptance_rate"] <= 0.5:
        raise AssertionError(f"{label}: acceptance {spec}")
    return {"label": label, "model": "llama-3-8b", "quant": "none",
            "kv_quant": "none", "variant": "bf16", "boot_s": boot_s,
            "max_memory_allocated": peak_mem, **_summarize(results, wall),
            "launches": {"paged_attention": pa.launches,
                         "prefill_attention": pfa.launches},
            "launches_by_variant": by_variant,
            "decode_launches_by_batch": {},
            "prefill_launches_by_len": {str(k): v for k, v in sorted(
                pfa.launches_by_len.items())},
            "prefill_launches_by_path": dict(sorted(
                pfa.launches_by_path.items())),
            "prefill_calls": prefills,
            "done_reasons": [r["done_reason"] for r in results],
            "speculative": spec, "engine_phases": engine_phases(snap)}


# --------------------------------------------------------------------------
# P/D: the live KV handoff's export and adoption, in one process.
# --------------------------------------------------------------------------

# Prompt lengths: 13 pages and 5 tokens (the export ends mid-page), one
# page boundary, and BurstGPT's longest (capped) prompt.
PD_LENGTHS = (13 * 16 + 5, 64, 1501)


def _pd_export(engine, prompt: list, max_new: int) -> tuple:
    """Prefill ``prompt`` through a scheduler with the handoff hook:
    (first token, (digests, host pages, ctx_len), the export's seconds);
    the sequence finishes "handoff" after its first token."""
    from tpu_inference_torch.engine.engine import Sequence
    from tpu_inference_torch.engine.scheduler import EngineScheduler
    box, done = {}, threading.Event()

    def hook(seq):
        t0 = time.perf_counter()
        box["export"] = engine.export_sequence_kv_live(seq)
        box["export_s"] = time.perf_counter() - t0
        return bool(box["export"][1])

    sched = EngineScheduler(engine)
    sched.on_prefill_handoff = hook
    seq = Sequence(request_id=0, prompt_tokens=list(prompt),
                   max_new_tokens=max_new)
    seq.handoff_after_prefill = True
    sched.submit(seq, lambda s, t: None, lambda s: done.set())
    sched.start()
    try:
        if not done.wait(300):
            raise AssertionError("the handoff prefill hung")
    finally:
        sched.stop(drain=True, timeout=30)
    if seq.finish_reason != "handoff":
        raise AssertionError(f"the prefill finished {seq.finish_reason!r}, "
                             "not as a handoff")
    return seq.generated[0], box["export"], box["export_s"]


def _pd_adopt(engine, prompt: list, max_new: int, first: int,
              pages: list, ctx_len: int) -> list:
    """Resume ``prompt`` from its first token and an export's pages
    through a scheduler (adoption at admission); the tokens after the
    first."""
    from tpu_inference_torch.engine.engine import Sequence
    from tpu_inference_torch.engine.scheduler import EngineScheduler
    seq = Sequence(request_id=1, prompt_tokens=list(prompt),
                   max_new_tokens=max_new)
    seq.generated, seq.resume_base = [first], 1
    seq.adopt_kv = (pages, ctx_len)
    toks, done = [], threading.Event()
    sched = EngineScheduler(engine)
    sched.submit(seq, lambda s, t: toks.append(t), lambda s: done.set())
    sched.start()
    try:
        if not done.wait(300):
            raise AssertionError("the adopted decode hung")
    finally:
        sched.stop(drain=True, timeout=30)
    if (seq.finish_reason != "length" or not seq.adopted
            or sched.stats.prefills):
        raise AssertionError(f"adoption: finished {seq.finish_reason!r}, "
                             f"adopted {seq.adopted}, "
                             f"{sched.stats.prefills} prefills")
    return toks


def _pd_identity(label: str, mcfg, kv_quant: str, lengths, variant: str,
                 params=None) -> dict:
    """Engine A (mixed) and engine B (decode) on the same weights, the
    prefix cache off so A's two prefills of a prompt are the same
    computation, batch 1 (both decode at the one rung). For each prompt:
    A decodes it alone (the oracle), prefills it again and exports the
    live sequence; B adopts the export. Gates: B's adopted pages are
    byte-equal to the export (scale rows included), B's tokens after the
    adoption equal A's, B launched no prefill kernel and the decode
    kernel in ``variant``, both pools clean after."""
    import gc

    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine import kv_cache as kvc
    from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    max_new = 17          # the first token, then 16 after the adoption
    kw = dict(page_size=16, num_pages=256, max_pages_per_seq=128,
              max_batch_size=1, kv_quant=kv_quant, enable_prefix_cache=False)
    a = InferenceEngine(mcfg, cfgs.EngineConfig(**kw), params=params,
                        seed=SEED, device="cuda")
    b = InferenceEngine(mcfg, cfgs.EngineConfig(**kw, role="decode"),
                        params=a.params, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    out = {"label": label, "kv_quant": kv_quant, "prompts": []}
    try:
        for n in lengths:
            prompt = rng.integers(0, min(mcfg.vocab_size, 32000),
                                  size=n).tolist()
            want = _sched_run(a, [prompt], max_new)[0]
            first, (digests, pages, ctx_len), export_s = _pd_export(
                a, prompt, max_new)
            t0 = time.perf_counter()
            blob = kvc.serialize_host_pages(pages)
            serialize_s = time.perf_counter() - t0
            if first != want[0] or ctx_len != n or len(pages) != -(-n // 16) \
                    or len(digests) != n // 16:
                raise AssertionError(
                    f"{label}: export of {n} tokens: first token {first} "
                    f"(oracle {want[0]}), ctx_len {ctx_len}, {len(pages)} "
                    f"pages, {len(digests)} digests")
            pa.reset_counts()
            pfa.reset_counts()
            # The adopted pages, read back off B's pool.
            probe = Sequence(request_id=2, prompt_tokens=list(prompt),
                             max_new_tokens=max_new)
            probe.generated, probe.resume_base = [first], 1
            t0 = time.perf_counter()
            probe.adopt_kv = (kvc.deserialize_host_pages(blob, copy=False),
                              ctx_len)
            b.adopt_sequence(probe)
            torch.cuda.synchronize()
            adopt_s = time.perf_counter() - t0
            back = kvc.offload_pages(b.kv, probe.pages)
            torch.cuda.synchronize()
            b.release(probe)
            if kvc.serialize_host_pages(back) != blob:
                raise AssertionError(f"{label}: {n} tokens: the adopted "
                                     "pages differ from the export")
            got = _pd_adopt(b, prompt, max_new, first,
                            kvc.deserialize_host_pages(blob), ctx_len)
            if [first] + got != want:
                raise AssertionError(f"{label}: {n} tokens: tokens after "
                                     f"the adoption {got} differ from the "
                                     f"mixed engine's {want[1:]}")
            if pfa.launches or pa.launches_by_variant[variant] <= 0:
                raise AssertionError(
                    f"{label}: the decode engine launched prefill "
                    f"{dict(pfa.launches_by_variant)}, decode "
                    f"{dict(pa.launches_by_variant)}")
            # The handoff's work in one process: pool -> host pages ->
            # blob (CRC-32C) -> checked pages -> the adopting pool.
            out["prompts"].append({
                "tokens": n, "pages": len(pages), "blob_bytes": len(blob),
                "export_s": export_s, "serialize_s": serialize_s,
                "adopt_s": adopt_s,
                "handoff_s": export_s + serialize_s + adopt_s,
                "decode_launches": pa.launches})
        a.check_pool_clean()
        b.check_pool_clean()
    finally:
        del a, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pd_identity_phase(card: str) -> list:
    """(a) of the P/D gates: the export/adopt identity at full width
    (llama-3-8b, bf16 weights and pool, page 16, PD_LENGTHS), then on
    tiny-llama over int8 and int4 KV pools (their scale rows travel
    with the pages)."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.models.registry import build_model
    _free_card("pd identity")
    mcfg = cfgs.PRESETS["llama-3-8b"]()
    params, _ = build_model(mcfg, seed=SEED, device="cuda")
    out = [_pd_identity("pd identity llama-3-8b bf16", mcfg, "none",
                        PD_LENGTHS, "bf16", params=params)]
    fabric = [_fabric_identity("fabric identity llama-3-8b bf16", mcfg,
                               "none", "bf16", params=params)]
    del params
    for kv in ("int8", "int4"):
        out.append(_pd_identity(f"pd identity tiny-llama {kv} KV",
                                tiny_config("tiny_llama"), kv,
                                (13 * 16 + 5, 64, 901), kv))
        fabric.append(_fabric_identity(
            f"fabric identity tiny-llama {kv} KV", tiny_config("tiny_llama"),
            kv, kv, gate_tokens=True))
    log(f"[pd identity] on {card}: adopted pages byte-equal to the export, "
        "tokens after the adoption equal the mixed engine's at batch 1, no "
        "prefill launch on the decode engine, pools clean: "
        + json.dumps(out))
    log(f"[fabric identity] on {card}: B's prefix pages from the pool "
        "byte-equal to A's, B's prefill at q_offset "
        f"{FABRIC_PREFIX} with S {FABRIC_SUFFIX}, first-step logits within "
        "tolerance of A's cold prefill, tokens gated on float32, no pool "
        "rejection, pools clean: " + json.dumps(fabric))
    return out + fabric


# --------------------------------------------------------------------------
# The KV fabric: pages published by one engine, adopted by another.
# --------------------------------------------------------------------------

# The shared prefix (64 pages of 16) and the suffix of the served prompt
# (one prefill bucket: the suffix prefills as one chunk of S 128).
FABRIC_PREFIX, FABRIC_SUFFIX = 1024, 128


class _LogitSpy:
    """A model module whose ``unembed`` also keeps each call's logits
    (float32, on the host); everything else is the module's."""

    def __init__(self, mod, out: list):
        self._mod, self._out = mod, out

    def __getattr__(self, name):
        return getattr(self._mod, name)

    def unembed(self, *args, **kw):
        x = self._mod.unembed(*args, **kw)
        self._out.append(x.float().cpu())
        return x


@contextlib.contextmanager
def _prefill_spy(calls: list):
    """Record (S, q_offset of lane 0) of every prefill-kernel call made
    while the block runs (the engine imports the wrapper at each
    forward, so the module attribute is the one it calls)."""
    from tpu_inference_torch.kernels import prefill_attention as pfa
    orig = pfa.paged_prefill_attention

    def spy(q, k_pages, v_pages, block_tables, kv_len, q_offset, *a, **kw):
        calls.append((int(q.shape[1]), int(q_offset[0])))
        return orig(q, k_pages, v_pages, block_tables, kv_len, q_offset,
                    *a, **kw)

    pfa.paged_prefill_attention = spy
    try:
        yield
    finally:
        pfa.paged_prefill_attention = orig


def _first_step(engine, prompt: list) -> tuple:
    """Prefill ``prompt`` on ``engine`` alone (engine API, no scheduler):
    (the first-step logits [V], the first token, the sequence's cached
    tokens and host-restored pages, the prefill kernel's (S, q_offset)
    calls, the wall); the sequence is released after."""
    from tpu_inference_torch.engine.engine import Sequence
    logits, calls = [], []
    seq = Sequence(request_id=90, prompt_tokens=list(prompt),
                   max_new_tokens=8)
    mod, engine.mod = engine.mod, _LogitSpy(engine.mod, logits)
    try:
        t0 = time.perf_counter()
        with _prefill_spy(calls):
            engine.prefill(seq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine.mod = mod
    out = (logits[-1][0], seq.generated[0], seq.cached_tokens,
           seq.host_restored_pages, calls, wall)
    engine.release(seq)
    return out


def _fabric_identity(label: str, mcfg, kv_quant: str, variant: str,
                     params=None, gate_tokens: bool = False) -> dict:
    """Engine A publishes into a port FabricPool through its publish
    hook; engine B, on the same weights, adopts the pool's pages through
    request_import_host and serves a second prompt with the same prefix.
    A serves prefix + 96 tokens; B then serves prefix + FABRIC_SUFFIX.
    Gates: the pool matches the whole 64-page prefix; B's prefill
    restores the 64 pages from its host tier and launches the prefill
    kernel at q_offset FABRIC_PREFIX with S FABRIC_SUFFIX (no longer
    call); B's device pages for the prefix byte-equal to A's (scale rows
    included); B's first-step logits within check_close of A's cold
    prefill of the same prompt; pool kv_rejections 0; both pools clean.
    The greedy tokens of both are recorded, and gated equal when
    ``gate_tokens`` (float32: they do not depend on the batch)."""
    import gc

    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine import kv_cache as kvc
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.engine.prefix_cache import _chain_hashes
    from tpu_inference_torch.server.kv_fabric import FabricPool
    n_prefix = FABRIC_PREFIX // 16
    kw = dict(page_size=16, num_pages=256, max_pages_per_seq=128,
              max_batch_size=1, kv_quant=kv_quant, host_cache_pages=128)
    a = InferenceEngine(mcfg, cfgs.EngineConfig(**kw), params=params,
                        seed=SEED, device="cuda")
    b = InferenceEngine(mcfg, cfgs.EngineConfig(**kw), params=a.params,
                        device="cuda")
    pool = FabricPool(256)
    a.fabric_publish = pool.put_pages
    rng = np.random.default_rng(SEED + 11)
    # The tokens of the prompts stay below 32000 (the smallest vocab).
    vocab = min(mcfg.vocab_size, 32000)
    prefix = rng.integers(0, vocab, size=FABRIC_PREFIX).tolist()
    p1 = prefix + rng.integers(0, vocab, size=96).tolist()
    p2 = prefix + rng.integers(0, vocab, size=FABRIC_SUFFIX).tolist()
    out = {"label": label, "kv_quant": kv_quant}
    try:
        _sched_run(a, [p1], 8)
        digests = _chain_hashes(p2, 16)[:n_prefix]
        if pool.match_depth(digests) != n_prefix:
            raise AssertionError(f"{label}: the pool holds "
                                 f"{pool.match_depth(digests)} of the "
                                 f"{n_prefix} prefix pages")
        t0 = time.perf_counter()
        entries = pool.get_pages(digests)
        get_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b.request_import_host(entries)
        b.apply_pending_imports()
        import_s = time.perf_counter() - t0
        before = pfa_launches()
        logits_b, first_b, cached, restored, calls, warm_s = _first_step(
            b, p2)
        if (cached != FABRIC_PREFIX or restored != n_prefix
                or (FABRIC_SUFFIX, FABRIC_PREFIX) not in calls
                or any(s > FABRIC_SUFFIX for s, _ in calls)):
            raise AssertionError(
                f"{label}: B cached {cached} tokens, restored {restored} "
                f"pages, prefill calls (S, q_offset) {sorted(set(calls))}")
        paths = {k: n - before[1].get(k, 0)
                 for k, n in pfa_launches()[1].items()
                 if n > before[1].get(k, 0)}
        # B's device pages for the prefix, read back off its pool, against
        # the pool's blobs of A's pages (copied off A's pool at publish).
        published = dict(pool.hot_set(pool.used))
        pages_b = kvc.offload_pages(b.kv, [b.prefix_cache._table[d]
                                           for d in digests])
        torch.cuda.synchronize()
        differ = [i for i, (d, y) in enumerate(zip(digests, pages_b))
                  if kvc.serialize_host_pages([y]) != published[d]]
        if differ:
            raise AssertionError(f"{label}: B's prefix pages {differ[:8]} "
                                 "differ from A's")
        # A's cache was cleared by _sched_run's pool check: a cold prefill.
        logits_a, first_a, cached_a, _, _, cold_s = _first_step(a, p2)
        if cached_a:
            raise AssertionError(f"{label}: A's reference prefill was not "
                                 f"cold ({cached_a} cached tokens)")
        dtype = mcfg.dtype
        err, scale = check_close(f"{label} first-step logits", logits_b,
                                 logits_a, dtype)
        want = _sched_run(a, [p2], 8)[0]
        got = _sched_run(b, [p2], 8)[0]
        if gate_tokens and (got != want or first_b != first_a):
            raise AssertionError(f"{label}: B's tokens {got} differ from "
                                 f"A's {want}")
        if pool.kv_rejections:
            raise AssertionError(f"{label}: {pool.kv_rejections} pool "
                                 "rejections")
        a.check_pool_clean()
        b.check_pool_clean()
        out.update({
            "prefix_pages": n_prefix, "pool_pages": pool.used,
            "pool_bytes": pool.bytes_used,
            "published_pages": a.fabric_published_pages,
            "publish_s": a.fabric_publish_s,
            "publish_s_per_page": a.fabric_publish_s
            / max(1, a.fabric_published_pages),
            "get_pages_s": get_s, "import_s": import_s,
            "fabric_warm_prefill_s": warm_s, "cold_prefill_s": cold_s,
            "prefill_calls": sorted(set(calls)),
            "prefill_launches_by_path": paths,
            "logits_max_abs_err": err, "logits_err_over_scale": scale,
            "first_token": [first_a, first_b],
            "tokens_equal": got == want, "tokens_gated": gate_tokens})
    finally:
        del a, b
        gc.collect()
        torch.cuda.empty_cache()
    return out


def pfa_launches() -> tuple:
    """The prefill kernel's launches and launches by path, now."""
    from tpu_inference_torch.kernels import prefill_attention as pfa
    return pfa.launches, dict(pfa.launches_by_path)


# --------------------------------------------------------------------------
# The process fleet (dp 2 on the one card): the in-process group, the
# subprocess fleet and its faults.
# --------------------------------------------------------------------------

_SAMPLE_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def _monotone_series(text: str) -> dict:
    """{(name, labels): value} of every counter and histogram sample of a
    Prometheus text page (the series that must never fall)."""
    kinds = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    out = {}
    for line in text.splitlines():
        m = _SAMPLE_LINE.match(line)
        if not m:
            continue
        name = m.group(1)
        fam = re.sub(r"_(bucket|sum|count)$", "", name)
        if kinds.get(name) == "counter" or kinds.get(fam) == "histogram":
            out[(name, m.group(2) or "")] = float(m.group(3))
    return out


def _no_series_fell(label: str, before: dict, after: dict) -> int:
    fell = {k: (v, after.get(k)) for k, v in before.items()
            if after.get(k) is None or after[k] < v}
    if fell:
        raise AssertionError(f"{label}: /metrics series fell or vanished "
                             f"across a restart: {list(fell.items())[:8]}")
    return len(before)


def _fleet_submit(group, rid: int, prompt: list, max_new: int,
                  cls: str = "interactive") -> tuple:
    from tpu_inference_torch.engine.engine import Sequence
    toks, done, box = [], threading.Event(), {}
    group.submit(Sequence(request_id=rid, prompt_tokens=list(prompt),
                          max_new_tokens=max_new, priority_class=cls),
                 lambda s, t: toks.append(t),
                 lambda s: (box.update(seq=s), done.set()))
    return toks, done, box


def _fleet_finish(label: str, pend: tuple) -> list:
    toks, done, box = pend
    if not done.wait(300):
        raise AssertionError(f"{label}: a request did not finish")
    if box["seq"].finish_reason != "length":
        raise AssertionError(f"{label}: finished {box['seq'].finish_reason}")
    return list(toks)


def _wait_fleet(group, label: str, pred, what: str, timeout: float = 180.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{label}: {what} not reached in {timeout:.0f} s "
                         f"(states {[h.state for h in group.workers]})")


def _healed(group) -> bool:
    return all(h.state == "up" for h in group.workers)


def _tracked_worker(group, rid: int) -> int:
    with group._lock:
        return group._tracked[rid].worker.replica


def _worker_reads(group, reads: dict, label: str) -> list:
    """Read every live worker's stats RPC (its device and its kernels'
    counts, which live in that process) into ``reads``, keyed by pid, so
    a restarted worker is a new entry; each must sit on the card."""
    out = group.worker_stats()
    for w in out:
        if not str(w["device"]).startswith("cuda"):
            raise AssertionError(f"{label}: worker {w['replica']} serves on "
                                 f"{w['device']}, not the card")
        reads[w["pid"]] = w
    return out


def _gate_launches(reads: dict, label: str, variant: str) -> None:
    """Every replica launched both kernels (some incarnation of it, as
    last read), and every worker process only in ``variant``."""
    for w in reads.values():
        for kind in ("decode", "prefill"):
            others = {k: n for k, n in w["kernels"][kind].items()
                      if k != variant and n}
            if others:
                raise AssertionError(f"{label}: worker {w['replica']} "
                                     f"{kind} launches {others}")
    for r in {w["replica"] for w in reads.values()} | {0, 1}:
        ran = [w for w in reads.values() if w["replica"] == r
               and w["kernels"]["decode"][variant] > 0
               and w["kernels"]["prefill"][variant] > 0]
        if not ran:
            raise AssertionError(
                f"{label}: replica {r} never launched both kernels in "
                f"{variant}: {[w['kernels'] for w in reads.values()]}")


def _launch_totals(reads: dict) -> dict:
    """Launches summed over worker processes (each one's last read)."""
    by_variant = {"paged_attention": {}, "prefill_attention": {}}
    by_batch, by_len, by_path = {}, {}, {}
    for w in reads.values():
        for name, kind in (("paged_attention", "decode"),
                           ("prefill_attention", "prefill")):
            for k, n in w["kernels"][kind].items():
                by_variant[name][k] = by_variant[name].get(k, 0) + n
        for b, n in w["kernels"]["decode_by_batch"].items():
            by_batch[b] = by_batch.get(b, 0) + n
        for q, n in w["kernels"]["prefill_by_len"].items():
            by_len[q] = by_len.get(q, 0) + n
        for k, n in w["kernels"]["prefill_by_path"].items():
            by_path[k] = by_path.get(k, 0) + n
    return {"by_variant": by_variant, "decode_by_batch": by_batch,
            "prefill_by_len": by_len, "prefill_by_path": by_path}


def _read_before_retire(group, reads: dict) -> list:
    """Route every retirement (a scale-down's, a rollout's) through a
    wrapper of the group's drain that reads the worker's stats RPC into
    ``reads`` first, and then until the worker stops answering: its
    kernels' counts leave with its process, and its drain settles the
    calls in flight. Each retirement appends a record with its drain
    wall (the drain RPC to the worker retired); _settle_retirements
    fills in what each one migrated."""
    from tpu_inference_torch.server.fleet import WorkerGone
    retirements: list = []
    drain = group.drain_worker
    gone = ("retired", "dead", "restarting", "quarantined")

    def follow(h, pid, rec):
        while h.state not in gone:
            try:
                reads[pid] = group.worker_stat(h)
            except (WorkerGone, TimeoutError, RuntimeError):
                break
            time.sleep(0.05)
        deadline = time.monotonic() + group.server_cfg.drain_timeout_s + 30
        while h.state not in gone and time.monotonic() < deadline:
            time.sleep(0.02)
        rec.update(state=h.state, drain_s=time.perf_counter() - rec["t0"])

    def wrapped(replica, migrate=None):
        h = group.workers[replica]
        pid = h.pid
        reads[pid] = group.worker_stat(h)
        rec = {"replica": replica, "pid": pid, "t0": time.perf_counter(),
               "migrations0": group.migrations,
               "bytes0": group.migrated_bytes}
        retirements.append(rec)
        drain(replica, migrate)
        threading.Thread(target=follow, args=(h, pid, rec),
                         name="smoke-retire-read", daemon=True).start()

    group.drain_worker = wrapped
    return retirements


def _settle_retirements(group, retirements: list) -> list:
    """Each retirement's migrations and migrated bytes: the router's
    counters from its drain to the next one's (the last: to now; the
    imports land on threads after the exit). Call once the fleet is
    quiet; nothing else may migrate meanwhile."""
    ends = [(r["migrations0"], r["bytes0"]) for r in retirements[1:]]
    ends.append((group.migrations, group.migrated_bytes))
    out = []
    for r, (m1, b1) in zip(retirements, ends):
        out.append({"replica": r["replica"], "pid": r["pid"],
                    "state": r.get("state"), "drain_s": r.get("drain_s"),
                    "migrations": m1 - r["migrations0"],
                    "migrated_bytes": b1 - r["bytes0"]})
    return out


def _pids_gone(label: str, pids) -> None:
    deadline = time.monotonic() + 30
    alive = set(pids)
    while alive and time.monotonic() < deadline:
        for pid in list(alive):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                alive.discard(pid)
        time.sleep(0.1)
    if alive:
        raise AssertionError(f"{label}: worker processes {sorted(alive)} "
                             "outlived the fleet")


def _card_memory_back(label: str, free_before: int) -> int:
    """The card's free memory once a fleet's workers are gone: back to
    within 1 GiB of ``free_before`` (waiting up to 60 s), or the lane
    fails. Returns the free bytes."""
    deadline = time.monotonic() + 60
    while (torch.cuda.mem_get_info()[0] < free_before - 2**30
           and time.monotonic() < deadline):
        time.sleep(0.5)
    free_after = torch.cuda.mem_get_info()[0]
    if free_after < free_before - 2**30:
        raise AssertionError(f"{label}: {(free_before - free_after) / 1e9:.2f}"
                             " GB of card memory not given back")
    return free_after


def _pool_clean(label: str, group) -> None:
    for h in group._live_workers():
        snap = h.client.rpc("debug", clear=True)
        bad = (snap["pipeline_pending"] or snap["preempted_uncollected"]
               or snap["slots_bound"] or snap["refs_held"]
               or snap["evictable_count"] or snap["host_used"]
               or snap.get("tier_overlap", 0)
               or snap["num_free"] != snap["num_pages"] - 1)
        if bad:
            raise AssertionError(f"{label}: worker {h.replica} pool not "
                                 f"clean: {snap}")


def _mix_sha(outs: list) -> str:
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for o in outs:
        h.update(np.asarray(o, np.int32).tobytes() + b"|")
    return h.hexdigest()


FLEET_TINY_ENGINE = dict(page_size=8, num_pages=256, max_pages_per_seq=32,
                         max_batch_size=4, prefill_buckets=(16, 32, 64, 128),
                         decode_steps_per_call=4, host_cache_pages=64)


def fleet_tiny_phase(card: str) -> dict:
    """tiny-llama (float32) at dp 2 on the card, where greedy tokens do
    not depend on the batch's width: a pinned greedy mix gives one
    outputs_sha256 through the in-process group, the subprocess fleet
    and one dp-1 engine on the same weights (random from SEED); then, in
    the subprocess fleet, kill -9 and SIGTERM of the worker holding a
    mid-decode stream (tokens identical; failovers up; the worker back
    under its replica label; no /metrics counter falls; after the next
    stats refresh, pages migrated and a swap-in-resume), and a seeded
    corrupt/delay transport-chaos run (the same sha, frame errors > 0,
    no restart). Every worker's pool invariants clean after; both
    kernels launched in every worker, on the card. Then the P/D pair
    (_pd_fleet_tiny) and the elastic gates (_elastic_fleet_tiny)."""
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.server.http import build_engine_group

    label = "fleet tiny-llama f32 dp2"
    mcfg = tiny_config("tiny_llama")

    def cfg(fleet: str):
        return cfgs.FrameworkConfig(
            model=mcfg, engine=cfgs.EngineConfig(**FLEET_TINY_ENGINE),
            parallel=cfgs.ParallelConfig(dp=2),
            server=cfgs.ServerConfig(
                model_name="tiny-llama", warmup=False, fleet=fleet,
                worker_restart_max=10, worker_restart_backoff_s=0.1,
                drain_timeout_s=10.0),
            seed=SEED)

    rng = np.random.default_rng(11)
    mix = [rng.integers(0, 256, size=n).tolist()
           for n in (5, 12, 27, 40, 70, 9)]
    long_a, long_b = (rng.integers(0, 256, size=40).tolist()
                      for _ in range(2))
    mix_new, long_new = 32, 160
    # The oracle: one dp-1 engine on the same weights (SEED).
    dp1 = InferenceEngine(mcfg, cfgs.EngineConfig(**FLEET_TINY_ENGINE),
                          seed=SEED, device="cuda")
    want_mix = _sched_run(dp1, mix, mix_new)
    want_mix = [want_mix[i] for i in range(len(mix))]
    want_long = _sched_run(dp1, [long_a, long_b], long_new)
    # The fabric part's prompt: 8 full pages and a straggler.
    fab_prompt = rng.integers(0, 256, size=65).tolist()
    want_fab = _sched_run(dp1, [fab_prompt], mix_new)[0]
    del dp1

    def run_mix(group, base: int) -> list:
        pend = [_fleet_submit(group, base + i, p, mix_new)
                for i, p in enumerate(mix)]
        return [_fleet_finish(label, x) for x in pend]

    inproc = build_engine_group(cfg("in-process"), device="cuda").start()
    try:
        sha_in = _mix_sha(run_mix(inproc, 0))
    finally:
        inproc.stop(drain=False)
        del inproc
    t0 = time.perf_counter()
    group = build_engine_group(cfg("subprocess"), device="cuda")
    pids, reads = set(), {}
    try:
        group.start()
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        sha_sub = _mix_sha(run_mix(group, 100))
        sha_dp1 = _mix_sha(want_mix)
        if not sha_in == sha_sub == sha_dp1:
            raise AssertionError(f"{label}: outputs_sha256 differ: "
                                 f"in-process {sha_in}, subprocess "
                                 f"{sha_sub}, dp-1 {sha_dp1}")
        _worker_reads(group, reads, label)
        out = {"label": label, "variant": "f32", "model": mcfg.name,
               "outputs_sha256": sha_sub, "boot_s": boot_s}

        # kill -9 of the worker holding a mid-decode stream.
        group._refresh_caches()
        before = _monotone_series(group.prometheus_text())
        failovers0 = group.failovers
        a = _fleet_submit(group, 200, long_a, long_new)
        b = _fleet_submit(group, 201, long_b, long_new)
        _wait_fleet(group, label, lambda: min(len(a[0]), len(b[0])) >= 8,
                    "two streams mid-decode")
        victim = _tracked_worker(group, 200)
        _worker_reads(group, reads, label)
        group.apply_chaos({"replica": victim, "kill": "sigkill"})
        if [_fleet_finish(label, a), _fleet_finish(label, b)] != \
                [want_long[0], want_long[1]]:
            raise AssertionError(f"{label}: tokens after kill -9 differ")
        if group.failovers <= failovers0:
            raise AssertionError(f"{label}: no failover counted")
        _wait_fleet(group, label,
                    lambda: group.workers[victim].restarts >= 1
                    and _healed(group), "the restart after kill -9")
        pids |= {h.pid for h in group.workers}
        group._refresh_caches()
        n_series = _no_series_fell(label, before,
                                   _monotone_series(group.prometheus_text()))
        out["kill9"] = {"replica": victim, "failovers": group.failovers,
                        "restarts": group.workers[victim].restarts,
                        "series_checked": n_series}

        # SIGTERM: drain, KV migration, swap-in-resume.
        mig0 = group.migrated_pages
        a = _fleet_submit(group, 300, long_a, long_new)
        _wait_fleet(group, label, lambda: len(a[0]) >= 24,
                    "a stream mid-decode")
        src = _tracked_worker(group, 300)
        _worker_reads(group, reads, label)
        restarts0 = group.workers[src].restarts
        group.apply_chaos({"replica": src, "kill": "sigterm"})
        if _fleet_finish(label, a) != want_long[0]:
            raise AssertionError(f"{label}: tokens after the drain differ")
        _wait_fleet(group, label,
                    lambda: group.workers[src].restarts > restarts0
                    and _healed(group), "the restart after the drain")
        pids |= {h.pid for h in group.workers}
        _wait_fleet(group, label,
                    lambda: group.supervision_counters()[
                        "swap_in_resumes"] >= 1, "a swap-in-resume", 30.0)
        if group.migrated_pages <= mig0:
            raise AssertionError(f"{label}: the drain migrated no page")
        sup = group.supervision_counters()
        out["sigterm"] = {k: sup[k] for k in (
            "migrations", "migrated_pages", "migrated_bytes",
            "swap_in_resumes", "resume_reused_tokens",
            "resume_recomputed_tokens")}

        # Seeded transport chaos: corrupt and delay worker->router frames.
        restarts0 = sum(h.restarts for h in group.workers)
        frame_errors0 = group.frame_errors
        group.apply_chaos({"rpc": {"seed": 42, "corrupt_rate": 0.05,
                                   "delay_rate": 0.1, "delay_s": 0.002,
                                   "verbs": ["token"],
                                   "direction": "recv"}})
        try:
            sha_chaos = _mix_sha(run_mix(group, 400))
        finally:
            group.apply_chaos({"rpc": {"corrupt_rate": 0.0,
                                       "delay_rate": 0.0}})
        if sha_chaos != sha_dp1:
            raise AssertionError(f"{label}: outputs differ under transport "
                                 "chaos")
        if group.frame_errors <= frame_errors0:
            raise AssertionError(f"{label}: no corrupted frame rejected")
        if sum(h.restarts for h in group.workers) != restarts0:
            raise AssertionError(f"{label}: transport chaos restarted a "
                                 "worker")
        out["chaos_rpc"] = {"frame_errors": group.frame_errors
                            - frame_errors0,
                            "reconnects": group.reconnects}
        _worker_reads(group, reads, label)
        _gate_launches(reads, label, "f32")
        _pool_clean(label, group)
        launches = _launch_totals(reads)
        out.update({
            "launches_by_variant": launches["by_variant"],
            "decode_launches_by_batch": launches["decode_by_batch"],
            "prefill_launches_by_len": launches["prefill_by_len"],
            "prefill_launches_by_path": launches["prefill_by_path"],
            "workers_read": len(reads),
            "boot_walls_s": {h.replica: h.boot_walls for h in group.workers},
        })
    finally:
        group.stop(drain=False)
    _pids_gone(label, pids)
    pd_cfg = cfg("subprocess")
    pd_cfg.server = dataclasses.replace(pd_cfg.server,
                                        worker_roles=("prefill", "decode"))
    out["pd"] = _pd_fleet_tiny(label, pd_cfg, run_mix, sha_dp1,
                               long_a, want_long[0], long_new)
    # The same P/D pair on the shm plane: the same sha.
    pd_cfg.server = dataclasses.replace(pd_cfg.server, kv_plane="shm",
                                        shm_arena_bytes=TINY_ARENA_BYTES)
    out["pd_shm"] = _pd_fleet_tiny(label, pd_cfg, run_mix, sha_dp1,
                                   long_a, want_long[0], long_new)
    out["elastic"] = _elastic_fleet_tiny(
        label, cfg("subprocess"), mix, want_mix, mix_new, long_a,
        want_long[0], long_new, sha_dp1)
    out["fabric"] = _fabric_fleet_tiny(label, cfg, fab_prompt, want_fab,
                                       mix_new)
    out["fabric_shm"] = _fabric_fleet_tiny(label, cfg, fab_prompt, want_fab,
                                           mix_new, plane="shm")
    out["tp2"] = _tp_fleet_tiny(label, cfg, run_mix, sha_dp1)
    log(f"[{label}] on {card}: sha {sha_sub} equal in-process / subprocess "
        f"/ P/D (relay and shm) / elastic / dp 2 x tp 2 / dp-1; "
        + json.dumps({
            k: v for k, v in out.items()
            if k not in ("label", "outputs_sha256")}))
    return out


def _tp_fleet_tiny(label: str, cfg, run_mix, sha_dp1: str) -> dict:
    """(e) of the tp gates: dp 2 x tp 2 on the subprocess fleet, each
    worker process driving its two shards on the card: the pinned mix's
    sha equals the dp-1 engine's, every worker launched both kernels at
    the shard's heads (tiny-llama's 4/2 split in two: 2/1) and no other,
    the pools clean, no worker process left."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.server.http import build_engine_group

    lab = f"{label} x tp2"
    c = cfg("subprocess")
    c.parallel = cfgs.ParallelConfig(dp=2, tp=2)
    t0 = time.perf_counter()
    group = build_engine_group(c, device="cuda")
    pids, reads = set(), {}
    try:
        group.start()
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        sha = _mix_sha(run_mix(group, 600))
        if sha != sha_dp1:
            raise AssertionError(f"{lab}: outputs_sha256 {sha} differs from "
                                 f"the dp-1 engine's {sha_dp1}")
        _worker_reads(group, reads, lab)
        _gate_launches(reads, lab, "f32")
        heads = {w["replica"]: w["kernels_by_heads"] for w in reads.values()}
        for r, by in heads.items():
            if any(set(n) != {"2/1"} for n in by.values()):
                raise AssertionError(f"{lab}: worker {r} launched at heads "
                                     f"{by}; its shards run at 2/1")
        _pool_clean(lab, group)
    finally:
        group.stop(drain=False)
    _pids_gone(lab, pids)
    return {"outputs_sha256": sha, "boot_s": boot_s,
            "launches_by_heads": heads}


def _role_info(text: str) -> set:
    """(replica, role) of every tpu_inf_worker_role_info sample at 1."""
    return set(re.findall(
        r'^tpu_inf_worker_role_info\{replica="(\d+)",role="(\w+)"\} 1',
        text, re.M))


# The tiny fleets' arena on the shm plane (a tiny-llama page is a few KB).
TINY_ARENA_BYTES = 64 * 2**20


def _pd_fleet_tiny(label: str, cfg, run_mix, sha_dp1: str, long_a: list,
                   want_long: list, long_new: int) -> dict:
    """(b) of the P/D gates: the fleet_tiny mix through a subprocess
    fleet of one prefill and one decode worker. Gates: the dp-1 sha;
    one handoff and one adoption per request, no recompute; no
    decode-kernel launch on the prefill worker and no prefill-kernel
    launch on the decode worker; on the shm plane (``cfg.server.
    kv_plane``) every handoff by descriptor (_shm_gates). Then kill -9
    of the decode worker while a handed-off stream decodes: the dp-1
    tokens, the recompute counted in tpu_inf_pd_handoff_recomputes_total,
    the worker back under its replica label and role."""
    from tpu_inference_torch.server.http import build_engine_group
    shm = cfg.server.kv_plane == "shm"
    label = label + " P/D" + (" shm" if shm else "")
    group = build_engine_group(cfg, device="cuda")
    pids, reads = set(), {}
    try:
        group.start()
        pids |= {h.pid for h in group.workers}
        n0 = group.pd_handoffs
        outs = run_mix(group, 500)
        sha = _mix_sha(outs)
        if sha != sha_dp1:
            raise AssertionError(f"{label}: outputs_sha256 {sha} differs "
                                 f"from the dp-1 engine's {sha_dp1}")
        sup = group.stats_snapshot()["supervision"]
        n = len(outs)
        if (group.pd_handoffs - n0 != n or sup["pd_adoptions"] != n
                or sup["pd_handoff_recomputes"] != 0):
            raise AssertionError(f"{label}: {n} requests, handoffs "
                                 f"{group.pd_handoffs - n0}, {sup}")
        by_role = {w["replica"]: w["kernels"]
                   for w in _worker_reads(group, reads, label)}
        if (by_role[0]["decode"]["f32"] or by_role[1]["prefill"]["f32"]
                or not by_role[0]["prefill"]["f32"]
                or not by_role[1]["decode"]["f32"]):
            raise AssertionError(f"{label}: launches by role {by_role}")
        out = {"outputs_sha256": sha, "pd_handoffs": n,
               "pd_adoptions": sup["pd_adoptions"],
               "launches_by_role": {"prefill": by_role[0],
                                    "decode": by_role[1]}}
        if shm:
            out["shm"] = _shm_gates(label, group, reads,
                                    ("handoff", "submit", "import-kv"))

        # kill -9 of the decode worker under a handed-off stream.
        rec0 = group._pd_recomputes_total()
        a = _fleet_submit(group, 600, long_a, long_new)

        def on_decode_worker():
            with group._lock:
                e = group._tracked.get(600)
                return (e is not None and e.worker is group.workers[1]
                        and len(e.tokens) >= 8)

        _wait_fleet(group, label, on_decode_worker,
                    "a handed-off stream mid-decode")
        group.apply_chaos({"replica": 1, "kill": "sigkill"})
        if _fleet_finish(label, a) != want_long:
            raise AssertionError(f"{label}: tokens after kill -9 of the "
                                 "decode worker differ")
        _wait_fleet(group, label,
                    lambda: group.workers[1].restarts >= 1
                    and _healed(group), "the decode worker's restart")
        pids |= {h.pid for h in group.workers}
        text = group.prometheus_text()
        m = re.search(r"^tpu_inf_pd_handoff_recomputes_total (\S+)$", text,
                      re.M)
        role = group.health_snapshot()["replicas"][1]["role"]
        if (m is None or float(m.group(1)) <= rec0 or role != "decode"
                or _role_info(text) != {("0", "prefill"), ("1", "decode")}):
            raise AssertionError(f"{label}: after kill -9: recomputes "
                                 f"{m and m.group(1)} (before {rec0}), "
                                 f"role {role}, {_role_info(text)}")
        out["kill9"] = {"recomputes": float(m.group(1)),
                        "restarts": group.workers[1].restarts}
        _pool_clean(label, group)
    finally:
        group.stop(drain=False)
    _pids_gone(label, pids)
    return out


def _elastic_fleet_tiny(label: str, cfg, mix: list, want_mix: list,
                        mix_new: int, long_a: list, want_long: list,
                        long_new: int, sha_dp1: str) -> dict:
    """The elastic gates where tokens hold (float32): one worker at
    admission cap 1 with class lanes. A batch stream mid-decode, a batch
    arrival that parks, an interactive arrival that preempts the running
    batch stream: all three give the dp-1 engine's tokens, the preempted
    one resumed from the router's token record. Then a rollout under
    traffic: the pinned mix as batch requests through the lanes while
    the pass replaces the worker (the old worker's dispatches held 0.05
    s each by the chaos wedge, so requests are in flight at its drain):
    the dp-1 sha, nothing failed; a last mix on the successor, the same
    sha.
    Launches read before the retirement; both workers launched both
    kernels; the successor's pool clean."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.server.http import build_engine_group
    label = label + " elastic"
    cfg.parallel = cfgs.ParallelConfig(dp=1)
    cfg.server = dataclasses.replace(cfg.server, admission_queue_depth=1,
                                     class_queue_depth=8)
    group = build_engine_group(cfg, device="cuda")
    pids, reads = set(), {}
    retirements = _read_before_retire(group, reads)
    try:
        group.start()
        pids |= {h.pid for h in group.workers}
        # Every dispatch of this worker 0.05 s longer: the batch stream
        # is still running when the others arrive, and requests are in
        # flight when the rollout drains it (its successor boots without).
        group.apply_chaos({"step_wedge_s": 0.05})
        a = _fleet_submit(group, 800, long_a, long_new, cls="batch")
        _wait_fleet(group, label, lambda: len(a[0]) >= 8,
                    "a batch stream mid-decode")
        b = _fleet_submit(group, 801, mix[0], mix_new, cls="batch")
        deferred = group.supervision_counters()["class_deferred"]["batch"]
        c = _fleet_submit(group, 802, mix[1], mix_new)
        outs = [_fleet_finish(label, x) for x in (a, b, c)]
        sup = group.supervision_counters()
        preempted = sup["class_preemptions"].get("batch", 0)
        if outs != [want_long, want_mix[0], want_mix[1]]:
            raise AssertionError(f"{label}: class-wave tokens differ from "
                                 "the dp-1 engine's")
        if deferred < 1 or preempted < 1 or sup["requests_shed"]:
            raise AssertionError(f"{label}: deferred {deferred}, preempted "
                                 f"{preempted}, shed {sup['requests_shed']}")
        out = {"class_wave": {"deferred_batch": deferred,
                              "preempted_batch": preempted,
                              "tokens": "equal to the dp-1 engine's"}}

        box: dict = {}
        th = threading.Thread(target=lambda: box.update(res=group.rollout()))
        pend = [_fleet_submit(group, 900 + i, p, mix_new, cls="batch")
                for i, p in enumerate(mix)]
        th.start()
        outs = [_fleet_finish(label, x) for x in pend]
        th.join(timeout=600)
        res = box.get("res")
        if th.is_alive() or res is None:
            raise AssertionError(f"{label}: the rollout did not finish")
        pids |= {h.pid for h in group.workers if h.pid}
        if (_mix_sha(outs) != sha_dp1 or res["failed"]
                or [r["old_state"] for r in res["replaced"]] != ["retired"]):
            raise AssertionError(f"{label}: rollout under traffic: sha "
                                 f"{_mix_sha(outs)} (dp-1 {sha_dp1}), {res}")
        sha_after = _mix_sha([_fleet_finish(label, x) for x in [
            _fleet_submit(group, 1000 + i, p, mix_new, cls="batch")
            for i, p in enumerate(mix)]])
        if sha_after != sha_dp1:
            raise AssertionError(f"{label}: the successor's sha differs")
        _worker_reads(group, reads, label)
        _gate_launches(reads, label, "f32")
        _pool_clean(label, group)
        out.update({"outputs_sha256": sha_after, "rollout": res,
                    "retirements": _settle_retirements(group, retirements),
                    "migrations": group.migrations,
                    "boot_walls_s": {h.replica: h.boot_walls
                                     for h in group.workers},
                    "launches_by_variant":
                        _launch_totals(reads)["by_variant"]})
    finally:
        group.stop(drain=False)
    _pids_gone(label, pids)
    return out


def _fabric_fleet_tiny(label: str, cfg, prompt: list, want: list,
                       max_new: int, plane: str = "relay") -> dict:
    """The KV fabric where tokens hold (float32), in both backends: the
    warm-once flow (a seed request publishes its prefix; with the seed
    replica pressured, the same prompt routes to the other replica and
    its dispatch pulls the prefix from the pool), tokens the dp-1
    engine's. Then, in the subprocess fleet, kill -9 of the seed worker:
    its respawn adopts the pool's hot set before it is UP, and with the
    sibling pressured its first request with the prefix is host-warm
    (every prefix page) with no fabric pull, tokens the dp-1 engine's.
    Both kernels in every worker; the pools clean. ``plane`` "shm" runs
    the subprocess fleet alone (the in-process fleet moves no KV between
    processes), on the shm plane: every publish, pull and warm-boot page
    by descriptor (_shm_gates), the respawn's warm boot read from the
    arena."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.server.http import build_engine_group
    shm = plane == "shm"
    label = label + " fabric" + (" shm" if shm else "")
    n_pages = (len(prompt) - 1) // FLEET_TINY_ENGINE["page_size"]

    def fabric_cfg(fleet: str):
        c = cfg(fleet)
        # Page pressure (every free page held) must put the seed replica
        # under the watermark while its own cached pages stay.
        c.engine = cfgs.EngineConfig(**FLEET_TINY_ENGINE,
                                     preempt_watermark_pages=40)
        c.server = dataclasses.replace(c.server, fabric_cache_pages=64,
                                       kv_plane=plane,
                                       shm_arena_bytes=TINY_ARENA_BYTES)
        return c

    def flow(group, base, pressure, unpressure, is_pressured) -> dict:
        pend = _fleet_submit(group, base, prompt, max_new)
        if _fleet_finish(label, pend) != want:
            raise AssertionError(f"{label}: the seed request's tokens "
                                 "differ from the dp-1 engine's")
        seed = pend[2]["seq"].routed_replica
        _wait_fleet(group, label, lambda: group.fabric.used >= n_pages,
                    "the fabric publish", 60.0)
        pressure(seed)
        _wait_fleet(group, label, lambda: is_pressured(seed),
                    "the seed replica under pressure", 60.0)
        try:
            pend = _fleet_submit(group, base + 1, prompt, max_new)
            toks = _fleet_finish(label, pend)
        finally:
            unpressure(seed)
        fin = pend[2]["seq"]
        if (fin.routed_replica != 1 - seed
                or fin.route_fabric_hit_pages != n_pages or toks != want):
            raise AssertionError(
                f"{label}: the warm-once turn routed to "
                f"{fin.routed_replica} (seed {seed}), pulled "
                f"{fin.route_fabric_hit_pages} pages, tokens equal "
                f"{toks == want}")
        snap = group.health_snapshot()["fabric"]
        if snap["kv_rejections"] or snap["pages_used"] < n_pages:
            raise AssertionError(f"{label}: fabric {snap}")
        return {"seed_replica": seed,
                "route_fabric_hit_pages": fin.route_fabric_hit_pages,
                "fabric": snap}

    out = {}
    if not shm:
        group = build_engine_group(fabric_cfg("in-process"),
                                   device="cuda").start()
        try:
            out["in_process"] = flow(
                group, 1100,
                lambda i: group.engines[i].request_page_pressure(256),
                lambda i: group.engines[i].request_page_pressure(0),
                lambda i: group.engines[i].under_pressure)
        finally:
            group.stop(drain=False)
            del group
    group = build_engine_group(fabric_cfg("subprocess"), device="cuda")
    pids, reads, boots = set(), {}, []
    try:
        group.start()
        pids |= {h.pid for h in group.workers}

        def pressured(i):
            return bool(group.health_snapshot()["replicas"][i]
                        .get("under_pressure"))

        def page_pressure(i, n):
            group.apply_chaos({"replica": i, "page_pressure": n})

        res = flow(group, 1200, lambda i: page_pressure(i, 256),
                   lambda i: page_pressure(i, 0), pressured)
        out["subprocess"] = res
        seed = res["seed_replica"]
        _worker_reads(group, reads, label)
        warmboot = group._fabric_warmboot

        def spy(h, client):
            boots.append({"replica": h.replica, "state": h.state,
                          "incarnation": h.incarnation})
            return warmboot(h, client)

        group._fabric_warmboot = spy
        victim = group.workers[seed]
        inc = victim.incarnation
        group.apply_chaos({"replica": seed, "kill": "sigkill"})
        _wait_fleet(group, label, lambda: victim.incarnation > inc
                    and _healed(group), "the respawn after kill -9")
        group._fabric_warmboot = warmboot
        pids |= {h.pid for h in group.workers}
        wb = victim.warmboots[-1] if victim.warmboots else {}
        if (not boots or boots[-1]["state"] == "up"
                or wb.get("incarnation") != victim.incarnation
                or wb.get("adopted", 0) < n_pages):
            raise AssertionError(f"{label}: the respawn's warm boot "
                                 f"{boots} {wb}")
        page_pressure(1 - seed, 256)
        try:
            _wait_fleet(group, label, lambda: pressured(1 - seed),
                        "the sibling under pressure", 60.0)
            pend = _fleet_submit(group, 1300, prompt, max_new)
            toks = _fleet_finish(label, pend)
        finally:
            page_pressure(1 - seed, 0)
        fin = pend[2]["seq"]
        if (fin.routed_replica != seed or toks != want
                or fin.route_host_hit_pages < n_pages
                or fin.route_fabric_hit_pages):
            raise AssertionError(
                f"{label}: the respawn's first request routed to "
                f"{fin.routed_replica}, host-warm "
                f"{fin.route_host_hit_pages}, pulled "
                f"{fin.route_fabric_hit_pages}, tokens equal {toks == want}")
        _worker_reads(group, reads, label)
        _gate_launches(reads, label, "f32")
        if shm:
            if wb.get("desc_pages", 0) < n_pages or wb["relay_bytes"]:
                raise AssertionError(f"{label}: the respawn's warm boot "
                                     f"{wb} was not read from the arena")
            out["shm"] = _shm_gates(label, group, reads,
                                    ("fabric_put", "import-kv"))
        _pool_clean(label, group)
        out["warm_boot"] = {"replica": seed, "record": wb,
                            "host_hit_pages": fin.route_host_hit_pages,
                            "tokens": "equal to the dp-1 engine's"}
        out["launches_by_variant"] = _launch_totals(reads)["by_variant"]
    finally:
        group.stop(drain=False)
    _pids_gone(label, pids)
    return out


def _crc_mb_s() -> dict:
    """CRC-32C of the port's integrity module on this machine, 64 MiB of
    seeded bytes: each path's MB/s (the one crc32c resolves to, numpy,
    and the card's block path), every path's value equal; and each
    path's MB/s over the same bytes as 32 calls of 2 MiB (a llama-3-8b
    page, checksummed one by one on the shm plane and by the pool), and
    the path in use over them from 8 threads at once."""
    import numpy as np
    from tpu_inference_torch import integrity
    data = np.random.default_rng(SEED).integers(
        0, 256, 64 << 20, dtype=np.uint8).tobytes()
    out = {"crc32c_is": ("google_crc32c"
                         if integrity.crc32c is not integrity._crc32c_fast
                         else "the port's (card for >= 1 MiB, else numpy)")}
    values = set()
    for name, fn in (("crc32c", integrity.crc32c),
                     ("numpy", integrity._crc32c_np),
                     ("card", lambda d: integrity._crc32c_blocks(d, 0,
                                                                 "cuda"))):
        fn(data[:1 << 20])                       # warm (the card's tables)
        torch.cuda.synchronize()
        t = time.perf_counter()
        values.add(fn(data))
        out[f"{name}_mb_s"] = len(data) / 1e6 / (time.perf_counter() - t)
        t = time.perf_counter()
        pages = [fn(data[at:at + (2 << 20)])
                 for at in range(0, len(data), 2 << 20)]
        out[f"{name}_2mib_pages_mb_s"] = (len(data) / 1e6
                                          / (time.perf_counter() - t))
        values.add(tuple(pages))
    # The path in use, 8 threads at once on 2 MiB pages (a wave's 8
    # concurrent pulls each checksum their pages this way).
    got = [None] * 8
    step = len(data) // 8

    def run(k):
        got[k] = [integrity.crc32c(data[at:at + (2 << 20)])
                  for at in range(k * step, (k + 1) * step, 2 << 20)]

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    out["crc32c_2mib_pages_8_threads_mb_s"] = (len(data) / 1e6
                                               / (time.perf_counter() - t))
    values.add(tuple(c for g in got for c in g))
    if len(values) != 2:
        raise AssertionError(f"CRC-32C paths disagree: {values}")
    return out


def fleet_phase(card: str, dp1: dict) -> dict:
    """llama-3-8b (bf16, full width; main() cuts its depth to CUT_LAYERS)
    at dp 2 through the CLI's ``--dp 2 --fleet subprocess --num-pages
    512``: two workers share the card. Two waves of 8 concurrent BurstGPT-length
    requests (48 tokens): SIGTERM to one worker mid-decode in the first,
    and once healed, kill -9 to the other in the second. Gates: every
    stream "length" with its 48 tokens (the router's stream indices are
    gapless), pages migrated with a swap-in-resume, the drain inside
    drain_timeout_s, both kernels launched (bf16 only) in every worker
    on the card, and after the lane no worker process left and the
    card's free memory back. bf16 GEMM rows depend on M, so a resumed
    request may diverge from an uninterrupted run: tokens are not
    compared."""
    label = "fleet llama-3-8b bf16 dp2"
    free_before = torch.cuda.mem_get_info()[0]
    crc = _crc_mb_s()
    t0 = time.perf_counter()
    server, ea = _serve_cli([
        "--model", "llama-3-8b", "--dp", "2", "--fleet", "subprocess",
        "--num-pages", "512", "--max-pages-per-seq", "128",
        "--max-batch-size", "8", "--host-cache-pages", "2048",
        "--no-warmup", "--seed", str(SEED)])
    group = server.group
    pids, reads = set(), {}
    try:
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        drain_budget = group.server_cfg.drain_timeout_s
        prompts = _burst_prompts(16)
        max_tokens = 48
        waves, all_results = [], []
        drain = {}
        for wave, kill in ((0, "sigterm"), (1, "sigkill")):
            box: dict = {}

            def traffic(ps=prompts[8 * wave:8 * wave + 8]):
                box["results"], box["wall"] = run_requests(port, ps,
                                                           max_tokens)

            th = threading.Thread(target=traffic)
            th.start()

            victim = wave % 2

            def mid_decode():
                # Keep the last counts of every worker before the fault.
                _worker_reads(group, reads, label)
                with group._lock:
                    return any(e.worker is group.workers[victim]
                               and 2 <= len(e.tokens) <= max_tokens - 8
                               for e in group._tracked.values())

            _wait_fleet(group, label, mid_decode,
                        f"a stream mid-decode on replica {victim}", 300.0)
            mig0, bytes0 = group.migrations, group.migrated_bytes
            restarts0 = group.workers[victim].restarts
            vh = group.workers[victim]
            with group._lock:
                held = {rid: len(e.template.prompt_tokens) + len(e.tokens)
                        for rid, e in group._tracked.items()
                        if e.worker is vh}

            def settled():
                # Every request the victim held finished or runs on the
                # other worker.
                with group._lock:
                    return all(
                        rid not in group._tracked
                        or group._tracked[rid].worker not in (None, vh)
                        for rid in held)
            t_kill = time.perf_counter()
            group.apply_chaos({"replica": victim, "kill": kill})
            if kill == "sigterm":
                _wait_fleet(group, label,
                            lambda: group.workers[victim].state != "up",
                            "the drain", drain_budget + 30)
                exit_s = time.perf_counter() - t_kill
                _wait_fleet(group, label, settled, "the migration",
                            drain_budget + 30)
                # The worker's own drain (SIGTERM to its exit), then every
                # request it held re-dispatched on the other worker.
                drain = {"replica": victim,
                         "held_tokens": sorted(held.values()),
                         "worker_exit_s": exit_s,
                         "settled_s": time.perf_counter() - t_kill,
                         "migrations": group.migrations - mig0,
                         "migrated_bytes": group.migrated_bytes - bytes0}
            th.join(timeout=900)
            if th.is_alive() or "results" not in box:
                raise AssertionError(f"{label}: wave {wave} did not finish")
            _wait_fleet(group, label,
                        lambda: group.workers[victim].restarts > restarts0
                        and _healed(group), f"the restart after {kill}")
            pids |= {h.pid for h in group.workers}
            all_results += box["results"]
            waves.append({"kill": kill, "replica": victim,
                          **_summarize(box["results"], box["wall"]),
                          "done_reasons": [r["done_reason"]
                                           for r in box["results"]]})
            if kill == "sigterm":
                # The destination's swap-in shows in the router's view
                # with its next stats refresh (once a second), and only
                # until that worker restarts: read it before wave 2.
                _wait_fleet(group, label,
                            lambda: group.supervision_counters()[
                                "swap_in_resumes"] >= 1,
                            "a swap-in-resume", 30.0)
                drain["swap_in_resumes"] = group.supervision_counters()[
                    "swap_in_resumes"]
        sup = group.supervision_counters()
        if drain.get("migrated_bytes", 0) <= 0 or sup["migrated_pages"] <= 0:
            raise AssertionError(f"{label}: the drain migrated nothing: "
                                 f"{drain} {sup}")
        if drain["settled_s"] > drain_budget:
            raise AssertionError(f"{label}: the drain took "
                                 f"{drain['settled_s']:.2f} s, over its "
                                 f"{drain_budget} s budget: {drain}; CRC "
                                 f"{crc}")
        final = _worker_reads(group, reads, label)
        _gate_launches(reads, label, "bf16")
        snap = server_stats(port)
        launches = _launch_totals(reads)
        boot_walls = {h.replica: h.boot_walls for h in group.workers}
    finally:
        server.shutdown()
        del server, group
    _pids_gone(label, pids)
    free_after = _card_memory_back(label, free_before)
    ttfts = sorted(r["ttft_s"] for r in all_results)
    out = {"label": label, "model": "llama-3-8b", "quant": "none",
           "kv_quant": "none", "variant": "bf16", "dp": 2,
           "fleet": "subprocess", "boot_s": boot_s,
           "boot_walls_s": boot_walls, "waves": waves, "drain": drain,
           "crc32c": crc, "supervision": {k: sup[k] for k in (
               "failovers", "migrations", "migrated_pages",
               "migrated_bytes", "swap_in_resumes", "worker_restarts",
               "resume_reused_tokens", "resume_recomputed_tokens")},
           "worker_peak_memory_bytes": {str(w["replica"]):
                                        w["max_memory_allocated"]
                                        for w in final},
           "requests": len(all_results),
           "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
           "aggregate_tok_s": waves[0]["aggregate_tok_s"],
           "dp1_bf16_aggregate_tok_s": dp1["aggregate_tok_s"],
           "launches_by_variant": launches["by_variant"],
           "decode_launches_by_batch": launches["decode_by_batch"],
           "prefill_launches_by_len": launches["prefill_by_len"],
           "prefill_launches_by_path": launches["prefill_by_path"],
           "workers_read": len(reads), "step_failures":
               snap["step_failures"],
           "free_memory_before_after_bytes": [free_before, free_after]}
    log(f"[{label}] on {card}: boot {boot_s:.1f} s, per worker and restart "
        f"{json.dumps(boot_walls)}; drain {json.dumps(drain)}; CRC-32C "
        f"{json.dumps(crc)}; waves {json.dumps(waves)}; aggregate "
        f"{out['aggregate_tok_s']:.1f} tok/s (dp-1 bf16 lane "
        f"{dp1['aggregate_tok_s']:.1f}, not comparable as a claim); worker "
        f"peaks {json.dumps(out['worker_peak_memory_bytes'])}; launches "
        f"{json.dumps(launches['by_variant'])} over {len(reads)} worker "
        f"processes; supervision {json.dumps(out['supervision'])}")
    return out


def pd_phase(card: str, fleet: dict) -> dict:
    """(c) of the P/D gates: llama-3-8b (bf16, full width; main() cuts
    its depth to CUT_LAYERS) through the CLI with ``--dp 2 --fleet subprocess --roles prefill,decode``, one
    wave of 8 concurrent BurstGPT-length requests of 48 tokens. Gates:
    every stream "length" with its 48 tokens; one handoff per request,
    each adopted by the decode worker, none recomputed; the prefill
    kernel launched on the prefill worker only and the decode kernel on
    the decode worker only (their stats RPC); /metrics names both roles;
    no worker process left and the card's free memory back after.
    Recorded beside them: TTFT, the first inter-token gap per request as
    the router sees the tokens arrive (the handoff sits there, not in
    TTFT), the handoff wall (export to the decode worker's accept) and
    bytes, and tok/s beside the fleet lane's first (mixed dp-2) wave.
    bf16 tokens are not compared across topologies (GEMM rows depend on
    M): pd_identity_phase holds the adoption's identity."""
    label = "pd llama-3-8b bf16 1p1d"
    free_before = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    server, _ = _serve_cli([
        "--model", "llama-3-8b", "--dp", "2", "--fleet", "subprocess",
        "--roles", "prefill,decode", "--num-pages", "512",
        "--max-pages-per-seq", "128", "--max-batch-size", "8",
        "--no-warmup", "--seed", str(SEED)])
    group = server.group
    pids, reads = set(), {}
    # Router-side arrival times of each stream's tokens, and the exact
    # handoff walls the tpu_inf_pd_handoff_seconds histogram observes.
    arrivals: dict = {}
    on_token = group._on_token

    def timed_token(h, client, obj):
        arrivals.setdefault(obj["rid"], []).append(time.perf_counter())
        on_token(h, client, obj)

    class Recording:
        def __init__(self, hist):
            self.hist, self.values = hist, []

        def observe(self, v):
            self.values.append(v)
            self.hist.observe(v)

        def __getattr__(self, name):
            return getattr(self.hist, name)

    export_s: list = []
    on_handoff = group._on_handoff

    def timed_handoff(h, client, obj, blob):
        export_s.append(float(obj.get("export_s") or 0.0))
        on_handoff(h, client, obj, blob)

    group._on_token = timed_token
    group._on_handoff = timed_handoff
    handoff_s = group._pd_handoff_s_hist = Recording(
        group._pd_handoff_s_hist)
    try:
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        max_tokens = 48
        results, wall = run_requests(port, _burst_prompts(8), max_tokens)
        if any(r["done_reason"] != "length" for r in results):
            raise AssertionError(f"{label}: a request did not finish "
                                 "'length'")
        sup = group.stats_snapshot()["supervision"]
        by_role = {w["replica"]: w
                   for w in _worker_reads(group, reads, label)}
        adoptions = by_role[1]["stats"]["pd_adoptions"]
        if (group.pd_handoffs != 8 or adoptions != 8
                or sup["pd_handoff_recomputes"] != 0):
            raise AssertionError(f"{label}: handoffs {group.pd_handoffs}, "
                                 f"adoptions {adoptions}, {sup}")
        k0, k1 = by_role[0]["kernels"], by_role[1]["kernels"]
        if (k0["prefill"]["bf16"] <= 0 or sum(k0["decode"].values())
                or k1["decode"]["bf16"] <= 0 or sum(k1["prefill"].values())):
            raise AssertionError(f"{label}: launches by role: prefill "
                                 f"worker {k0}, decode worker {k1}")
        text = _http(port, "GET", "/metrics")[1].decode()
        if _role_info(text) != {("0", "prefill"), ("1", "decode")}:
            raise AssertionError(f"{label}: /metrics role series "
                                 f"{_role_info(text)}")
        snap = server_stats(port)
        launches = _launch_totals(reads)
        handoff_bytes = group.rpc_blob_bytes["handoff"]
        boot_walls = {h.replica: h.boot_walls for h in group.workers}
    finally:
        server.shutdown()
        del server, group
    _pids_gone(label, pids)
    free_after = _card_memory_back(label, free_before)
    gaps = sorted(t[1] - t[0] for t in arrivals.values() if len(t) > 1)
    walls = sorted(handoff_s.values)
    mixed = fleet["waves"][0]
    out = {"label": label, "model": "llama-3-8b", "quant": "none",
           "kv_quant": "none", "variant": "bf16", "dp": 2,
           "fleet": "subprocess", "roles": ["prefill", "decode"],
           "boot_s": boot_s, "boot_walls_s": boot_walls,
           **_summarize(results, wall),
           "first_gap_s": gaps, "first_gap_p50_s": gaps[len(gaps) // 2],
           "first_gap_max_s": gaps[-1],
           "handoff_s": walls, "handoff_p50_s": walls[len(walls) // 2],
           "handoff_max_s": walls[-1],
           # The prefill worker's share of each wall (export and
           # serialization); the rest is the router's relay and the
           # decode worker's accept.
           "handoff_export_s": sorted(export_s),
           "handoff_bytes_per_request": handoff_bytes / 8,
           "pd_handoffs": 8, "pd_adoptions": adoptions,
           "fleet_mixed_wave": {k: mixed[k] for k in (
               "ttft_p50_s", "ttft_max_s", "aggregate_tok_s",
               "decode_tok_s_per_request")},
           "launches_by_variant": launches["by_variant"],
           "decode_launches_by_batch": launches["decode_by_batch"],
           "prefill_launches_by_len": launches["prefill_by_len"],
           "prefill_launches_by_path": launches["prefill_by_path"],
           "launches_by_role": {"prefill": k0, "decode": k1},
           "step_failures": snap["step_failures"],
           "done_reasons": [r["done_reason"] for r in results],
           "free_memory_before_after_bytes": [free_before, free_after]}
    log(f"[{label}] on {card}: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("label",)}))
    return out


ELASTIC_CAP, ELASTIC_DEPTH = 4, 8
ROLLOUT_TOKENS = 512


def _class_ttfts(results: list) -> dict:
    ttfts = sorted(r["ttft_s"] for r in results)
    return {"requests": len(ttfts), "ttft_p50_s": ttfts[len(ttfts) // 2],
            "ttft_max_s": ttfts[-1]}


def elastic_phase(card: str, fleet: dict) -> dict:
    """The elastic fleet on the card: llama-3-8b (bf16, full width;
    main() cuts its depth to CUT_LAYERS, as the fleet lane's) through the
    CLI with ``--dp 2 --fleet subprocess --autoscale
    --autoscale-min 2 --autoscale-max 3``, class lanes (admission cap
    ELASTIC_CAP a worker, lanes ELASTIC_DEPTH deep) and a TTFT target of
    a quarter of the fleet lane's TTFT p50 in this run (the same model,
    dp and fleet on this card: every wave breaches it). Stages, in order:
    (1) a class wave: 12 ``X-Priority: batch`` streams past the cap, then
    2 interactive ones; gates: tpu_inf_class_deferred{class="batch"}
    seen above 0 on /metrics, tpu_inf_class_preempted_total{class=
    "batch"} >= 1, tpu_inf_class_shed_total{class="interactive"} 0.
    (2) the scale-up (in the class wave or in waves after it, up to
    three): tpu_inf_fleet_scale_ups_total 1 and tpu_inf_replicas 3, the
    new worker up; a follow-up wave reaches it, and its stats RPC shows
    decode and prefill launches in bf16 and no other variant. (3) the
    scale-down once idle: tpu_inf_fleet_scale_downs_total 1,
    tpu_inf_replicas 2, the retired worker's process gone. (4) with 2
    replicas, POST /debug/rollout while a wave is in flight: both
    workers replaced, nothing failed, a second POST 409,
    tpu_inf_fleet_rollouts_total 1; the successors serve a last wave and
    launch both kernels (the rollout's wave streams ROLLOUT_TOKENS
    tokens, the others 48). Every stream "length" with its tokens, no
    stream gap or frame error (tpu_inf_worker_reconnects_total 0), no
    worker process left and the card's memory back after. Each worker's
    launches are read before it retires. bf16 tokens are not compared
    (GEMM rows depend on M). Recorded: boot walls, each retirement's
    drain wall and migrated bytes, the rollout's wall, TTFT by class,
    the card's peak memory with three workers."""
    label = "elastic llama-3-8b bf16 dp2"
    free_before = torch.cuda.mem_get_info()[0]
    total = torch.cuda.mem_get_info()[1]
    slo_ms = max(1, int(250 * fleet["ttft_p50_s"]))
    t0 = time.perf_counter()
    server, _ = _serve_cli([
        "--model", "llama-3-8b", "--dp", "2", "--fleet", "subprocess",
        "--num-pages", "512", "--max-pages-per-seq", "128",
        "--max-batch-size", "8", "--debug", "--no-warmup",
        "--seed", str(SEED), "--autoscale", "--autoscale-min", "2",
        "--autoscale-max", "3", "--autoscale-breach-window-s", "1",
        "--autoscale-cooldown-s", "3", "--autoscale-idle-window-s", "2",
        "--slo-ttft-ms", str(slo_ms),
        "--admission-queue-depth", str(ELASTIC_CAP),
        "--class-queue-depth", str(ELASTIC_DEPTH)])
    group = server.group
    pids, reads = set(), {}
    retirements = _read_before_retire(group, reads)
    watch = {"deferred_batch_max": 0.0, "peak_used_3_workers": 0,
             "stop": False}
    max_tokens = 48
    # Prompts: the class wave 0-13, up to three waves for the scale-up
    # 14-37, its follow-up 38-45, the rollout's wave 46-53, the last
    # 54-61.
    prompts = _burst_prompts(62)
    batch_h = {"X-Priority": "batch"}
    inter_h = {"X-Priority": "interactive"}

    def metric(text: str, name: str, labels: str = "") -> float:
        m = re.search(rf"^{name}{re.escape(labels)} (\S+)$", text, re.M)
        if m is None:
            raise AssertionError(f"{label}: {name}{labels} not on /metrics")
        return float(m.group(1))

    def poll(port: int) -> None:
        # /metrics' batch lane, the card's memory with three workers, and
        # every worker pid (a booting one's too).
        while not watch["stop"]:
            text = _http(port, "GET", "/metrics")[1].decode()
            watch["deferred_batch_max"] = max(
                watch["deferred_batch_max"],
                metric(text, "tpu_inf_class_deferred", '{class="batch"}'))
            if sum(h.state == "up" for h in group.workers) >= 3:
                watch["peak_used_3_workers"] = max(
                    watch["peak_used_3_workers"],
                    total - torch.cuda.mem_get_info()[0])
            pids.update(h.pid for h in group.workers if h.pid)
            time.sleep(0.25)

    def quiet() -> bool:
        return not any(h.state in ("booting", "restarting", "draining")
                       for h in group.workers)

    def live_up(n: int) -> bool:
        live = group._live_workers()
        return len(live) == n and all(h.state == "up" for h in live)

    poller = None
    try:
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        poller = threading.Thread(target=poll, args=(port,), daemon=True)
        poller.start()

        # (1) The class wave.
        box: dict = {}

        def batch_wave():
            box["batch"], box["batch_wall"] = run_requests(
                port, prompts[:12], max_tokens, stagger_s=0.05,
                headers=batch_h)

        th = threading.Thread(target=batch_wave)
        th.start()
        _wait_fleet(group, label, lambda: any(group._deferred.values()),
                    "a batch request parked", 120.0)
        inter, inter_wall = run_requests(port, prompts[12:14], max_tokens,
                                         headers=inter_h)
        th.join(timeout=900)
        if th.is_alive() or "batch" not in box:
            raise AssertionError(f"{label}: the batch wave did not finish")
        text = _http(port, "GET", "/metrics")[1].decode()
        class_wave = {
            "deferred_batch_max_seen": watch["deferred_batch_max"],
            "preempted_batch": metric(text, "tpu_inf_class_preempted_total",
                                      '{class="batch"}'),
            "shed": {c: metric(text, "tpu_inf_class_shed_total",
                               f'{{class="{c}"}}')
                     for c in ("interactive", "batch", "background")},
            "batch": _class_ttfts(box["batch"]),
            "interactive": _class_ttfts(inter),
            "scale_ups_during": group.scale_ups}
        if (class_wave["deferred_batch_max_seen"] <= 0
                or class_wave["preempted_batch"] < 1
                or class_wave["shed"]["interactive"] != 0):
            raise AssertionError(f"{label}: class wave {class_wave}")

        # (2) The scale-up, then a wave that reaches the new worker.
        waves = 0
        while len(group.workers) < 3 and waves < 3:
            run_requests(port, prompts[14 + 8 * waves:22 + 8 * waves],
                         max_tokens)
            waves += 1
        _wait_fleet(group, label, lambda: group.scale_ups >= 1
                    and live_up(3), "the scale-up worker up", 300.0)
        text = _http(port, "GET", "/metrics")[1].decode()
        if (metric(text, "tpu_inf_fleet_scale_ups_total") != 1
                or metric(text, "tpu_inf_replicas") != 3):
            raise AssertionError(f"{label}: after the scale-up: "
                                 f"{group.supervision_counters()}")
        new = group.workers[2]
        follow, follow_wall = run_requests(port, prompts[38:46],
                                           max_tokens)
        by_rep = {w["replica"]: w
                  for w in _worker_reads(group, reads, label)}
        k_new = by_rep[new.replica]["kernels"]
        if (k_new["decode"]["bf16"] <= 0 or k_new["prefill"]["bf16"] <= 0
                or sum(k_new["decode"].values()) != k_new["decode"]["bf16"]
                or sum(k_new["prefill"].values())
                != k_new["prefill"]["bf16"]):
            raise AssertionError(f"{label}: the scale-up worker's launches "
                                 f"{k_new}")
        scale_up = {"replica": new.replica, "boot_walls_s": new.boot_walls,
                    "class_wave_triggered": class_wave["scale_ups_during"]
                    > 0, "extra_waves": waves,
                    "follow_up": _summarize(follow, follow_wall),
                    "new_worker_kernels": k_new,
                    "peak_used_3_workers_bytes":
                        watch["peak_used_3_workers"]}

        # (3) The scale-down once idle.
        t_idle = time.perf_counter()
        _wait_fleet(group, label, lambda: group.scale_downs >= 1
                    and live_up(2) and quiet(), "the scale-down", 120.0)
        gone = [h for h in group.workers if h.state == "retired"]
        text = _http(port, "GET", "/metrics")[1].decode()
        if (len(gone) != 1 or gone[0].proc.poll() is None
                or metric(text, "tpu_inf_fleet_scale_downs_total") != 1
                or metric(text, "tpu_inf_replicas") != 2):
            raise AssertionError(f"{label}: after the scale-down: "
                                 f"{[h.state for h in group.workers]}")
        _pids_gone(label, [gone[0].pid])
        scale_down = {"replica": gone[0].replica,
                      "after_idle_s": time.perf_counter() - t_idle}

        # (4) The rollout, with 2 replicas (the autoscaler waits while
        # it runs, so at most three workers share the card), and a wave
        # sent as it starts: the wave runs on the old workers while the
        # first successor boots and is long enough to span both boots,
        # so each drain finds streams mid-decode and migrates their KV.
        olds = [h.replica for h in group._live_workers()]
        roll: dict = {}
        rt = threading.Thread(target=lambda: roll.update(
            reply=_http(port, "POST", "/debug/rollout", {})))
        rt.start()
        _wait_fleet(group, label, group._rollout_lock.locked,
                    "the rollout under way", 30.0)
        wave: dict = {}

        def rollout_wave():
            wave["results"], wave["wall"] = run_requests(
                port, prompts[46:54], ROLLOUT_TOKENS)

        th = threading.Thread(target=rollout_wave)
        th.start()
        status = _http(port, "POST", "/debug/rollout", {})[0]
        if status != 409:
            raise AssertionError(f"{label}: a second rollout got {status}")
        rt.join(timeout=900)
        th.join(timeout=900)
        if rt.is_alive() or th.is_alive() or "results" not in wave:
            raise AssertionError(f"{label}: the rollout or its wave did "
                                 "not finish")
        status, raw, _ = roll["reply"]
        res = json.loads(raw)
        if (status != 200 or res["failed"]
                or sorted(r["old"] for r in res["replaced"]) != sorted(olds)
                or any(r["old_state"] != "retired" for r in res["replaced"])):
            raise AssertionError(f"{label}: rollout {status} {res}")
        text = _http(port, "GET", "/metrics")[1].decode()
        if metric(text, "tpu_inf_fleet_rollouts_total") != 1:
            raise AssertionError(f"{label}: rollouts_total")
        succ = [r["new"] for r in res["replaced"]]
        last, last_wall = run_requests(port, prompts[54:62], max_tokens)
        by_rep = {w["replica"]: w
                  for w in _worker_reads(group, reads, label)}
        for r in succ:
            k = by_rep[r]["kernels"]
            if k["decode"]["bf16"] <= 0 or k["prefill"]["bf16"] <= 0:
                raise AssertionError(f"{label}: successor {r} launches {k}")
        rollout = {"status": status, "result": res, "second_post": 409,
                   "successor_boot_walls_s": {
                       r: group.workers[r].boot_walls for r in succ},
                   "wave": _summarize(wave["results"], wave["wall"]),
                   "last_wave": _summarize(last, last_wall)}

        _wait_fleet(group, label, quiet, "a quiet fleet", 120.0)
        settled = _settle_retirements(group, retirements)
        _worker_reads(group, reads, label)
        for w in reads.values():
            for kind in ("decode", "prefill"):
                if sum(w["kernels"][kind].values()) != \
                        w["kernels"][kind]["bf16"]:
                    raise AssertionError(f"{label}: worker {w['replica']} "
                                         f"{kind} launches {w['kernels']}")
        sup = group.supervision_counters()
        if sup["worker_reconnects"] or sup["frame_errors"]:
            raise AssertionError(f"{label}: a stream gap or frame error: "
                                 f"{sup}")
        snap = server_stats(port)
        launches = _launch_totals(reads)
        boot_walls = {h.replica: h.boot_walls for h in group.workers}
        states = [h.state for h in group.workers]
    finally:
        watch["stop"] = True
        if poller is not None:
            poller.join(timeout=10)
        pids.update(h.pid for h in group.workers if h.pid)
        server.shutdown()
        del server, group
    _pids_gone(label, pids)
    free_after = _card_memory_back(label, free_before)
    every = (box["batch"] + inter + follow + wave["results"] + last)
    out = {"label": label, "model": "llama-3-8b", "quant": "none",
           "kv_quant": "none", "variant": "bf16", "dp": 2,
           "fleet": "subprocess", "slo_ttft_ms": slo_ms,
           "admission_cap": ELASTIC_CAP, "class_depth": ELASTIC_DEPTH,
           "boot_s": boot_s, "boot_walls_s": boot_walls, "states": states,
           "class_wave": class_wave, "scale_up": scale_up,
           "scale_down": scale_down, "rollout": rollout,
           "retirements": settled,
           "supervision": {k: sup[k] for k in (
               "scale_ups", "scale_downs", "rollouts", "class_preemptions",
               "class_shed", "migrations", "migrated_bytes", "failovers",
               "worker_restarts")},
           "requests": len(every),
           "done_reasons": sorted({r["done_reason"] for r in every}),
           "worker_peak_memory_bytes": {str(w["pid"]):
                                        w["max_memory_allocated"]
                                        for w in reads.values()},
           "peak_used_3_workers_bytes": watch["peak_used_3_workers"],
           "launches_by_variant": launches["by_variant"],
           "decode_launches_by_batch": launches["decode_by_batch"],
           "prefill_launches_by_len": launches["prefill_by_len"],
           "prefill_launches_by_path": launches["prefill_by_path"],
           "workers_read": len(reads), "step_failures":
               snap["step_failures"],
           "free_memory_before_after_bytes": [free_before, free_after]}
    log(f"[{label}] on {card}: " + json.dumps(
        {k: v for k, v in out.items() if k not in ("label",)}))
    return out


# The fabric lane's warm boot pushes the whole pool: the pool keeps its
# pages in LRU order and the 8 users' suffix pages are published after
# the shared prefix, so a 64-page hot set (the reference's default) would
# hold suffix pages (the lane logs how many prefix pages it would hold).
FABRIC_WARMBOOT_PAGES = 256


def _fabric_prompts(n: int) -> tuple:
    """The shared system prompt (FABRIC_PREFIX - 1 random letters: with
    the byte tokenizer's BOS, FABRIC_PREFIX tokens, 64 pages of 16) and
    ``n`` users' prompts: the system prompt and a suffix of a BurstGPT
    request's length (_burst_prompts, capped at 512 bytes)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 3)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz     ", np.uint8)
    system = rng.choice(letters, FABRIC_PREFIX - 1).tobytes().decode()
    return system, [system + u[:512] for u in _burst_prompts(n)]


def _rss_bytes() -> dict:
    """This process's resident set now and at its peak (/proc)."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                out[key] = int(val.split()[0]) * 1024
    return out


# The shm arm's arena: 1 GiB for each of its max(4, 2 dp) = 4 regions,
# room for a worker's share of the 512 MiB pool plus a drain export.
SHM_ARENA_BYTES = 4 * 2**30
_SHM_DIR = "/dev/shm"


def _shm_segments() -> set:
    """The shared-memory segments under /dev/shm now."""
    return {n for n in os.listdir(_SHM_DIR) if n.startswith("psm_")}


def _series_sum(text: str, name: str) -> float:
    """A counter summed over its labels (every worker's replica)."""
    total = 0.0
    for line in text.splitlines():
        m = _SAMPLE_LINE.match(line)
        if m and m.group(1) == name:
            total += float(m.group(3))
    return total


def _shm_gates(label: str, group, reads: dict, verbs) -> dict:
    """The shm plane in use and nothing relayed: the router's arena up,
    every worker read attached to its region with no failed allocation,
    no KV byte through the router for ``verbs``, and slabs both written
    and read (tpu_inf_kv_plane_shm_{puts,gets}_total). Returns the
    plane's numbers."""
    group._refresh_caches()
    text = group.prometheus_text()
    out = {"rpc_blob_bytes": dict(group.rpc_blob_bytes),
           "puts": _series_sum(text, "tpu_inf_kv_plane_shm_puts_total"),
           "gets": _series_sum(text, "tpu_inf_kv_plane_shm_gets_total"),
           "reclaims": group.shm_reclaims,
           "slabs_tracked": group._arena_dir.slabs_tracked
           if group._arena_dir is not None else None,
           "workers": {str(w["replica"]) + "/" + str(w["pid"]): w["arena"]
                       for w in reads.values()}}
    bad = [k for k, a in out["workers"].items()
           if a is None or a["alloc_failures"]]
    relayed = {v: group.rpc_blob_bytes[v] for v in verbs
               if group.rpc_blob_bytes[v]}
    if (group.arena is None or bad or relayed or out["puts"] <= 0
            or out["gets"] <= 0):
        raise AssertionError(
            f"{label}: the shm plane was not in use throughout: arena "
            f"{group.arena is not None}, workers unattached or full {bad}, "
            f"relayed {relayed}, {out}")
    return out


def fabric_phase(card: str, plane: str = "relay") -> dict:
    """The fleet KV fabric on the card: llama-3-8b (bf16, full width;
    main() cuts the relay arm to CUT_LAYERS, the shm arm runs all 32
    layers) through the CLI with ``--dp 2 --fleet subprocess --num-pages
    512 --max-pages-per-seq 128 --max-batch-size 8 --host-cache-pages
    2048 --fabric-cache-pages 256`` (the pool holds 512 MiB at full
    width) and ``--fabric-warmboot-pages`` FABRIC_WARMBOOT_PAGES;
    ``--preempt-watermark-pages 128`` so that page pressure (every free
    page held) puts a worker holding one request's cached pages under
    the watermark. ``plane`` "shm" adds ``--kv-plane shm
    --shm-arena-bytes`` SHM_ARENA_BYTES. Traffic: a 1024-token shared
    system prompt and users each adding a BurstGPT-length suffix (capped
    at 512), 48 tokens out. Stages: one seed request; the prefix's 64
    pages in the pool; page pressure on the seed worker; one request
    alone (routed around it: its dispatch pulls the prefix, the pull
    timed alone), then the other worker's caches dropped; 8 concurrent
    requests (the other worker's dispatches pull the prefix again); the
    pressure lifted and the seed worker killed with kill
    -9; once respawned (its warm boot before it is UP), the other
    worker's cache cleared and pressured, and one more request. The shm
    arm then sends one more request and SIGTERMs the worker serving it
    mid-decode (the drain migrates it). Gates: every stream "length"
    with its 48 tokens; the wave on the other worker, one of its
    dispatches with route_fabric_hit_pages 64; no fabric_pull_failed or
    fabric_warmboot_failed event, no pool rejection, no frame error; the
    respawn's warm boot adopting the prefix, and its request host-warm
    (>= 64 pages) with no fabric pull; both kernels (bf16 only) in every
    worker; no /metrics counter falls across the restart; no worker left
    after and the card's memory back. On the shm arm also: the arena
    fits /dev/shm (its free space logged); the router's arena up and
    every worker attached (_shm_gates) with no relayed handoff,
    fabric_put, migrate or import-kv byte and slabs written and read;
    the warm boot read from the arena (its descriptor pages cover the
    prefix, nothing relayed); tpu_inf_shm_reclaims_total > 0 after the
    kill -9; the drain migrating by descriptor; no shm_arena_unavailable
    event; no segment left under /dev/shm after. Recorded: the seed
    request's TTFT (a cold prefill) and the fabric-warm ones, each
    pull's wall and bytes and its parts (the worker's slab reads,
    deserialize and wait for the engine loop; on the relay plane the
    router's pool read and serialize), alone and 8 at once, the publish
    wall per page on the engine
    thread, the warm boot's wall and pages, the drain's walls and bytes
    (shm), the tpu_inf_fabric_*, tpu_inf_route_fabric_*, tpu_inf_shm_*
    and tpu_inf_kv_plane_shm_* series at the end, the router's RSS, the
    prefill launches by path on the fabric-warm worker."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch import telemetry as tel
    from tpu_inference_torch.engine.prefix_cache import _chain_hashes
    shm = plane == "shm"
    n_layers = cfgs.PRESETS["llama-3-8b"]().n_layers
    label = ("fabric shm llama-3-8b bf16 dp2" if shm
             else "fabric llama-3-8b bf16 dp2")
    free_before = torch.cuda.mem_get_info()[0]
    n_prefix = FABRIC_PREFIX // 16
    system, prompts = _fabric_prompts(11)
    max_tokens = 48
    events: list = []
    log_event = tel.log_event
    flags = []
    dev_shm = None
    if shm:
        import shutil
        du = shutil.disk_usage(_SHM_DIR)
        dev_shm = {"total": du.total, "free": du.free,
                   "arena": SHM_ARENA_BYTES}
        log(f"[{label}] {_SHM_DIR}: {json.dumps(dev_shm)}")
        if du.free < SHM_ARENA_BYTES:
            raise AssertionError(
                f"{label}: the {SHM_ARENA_BYTES} B arena does not fit "
                f"{_SHM_DIR} ({du.free} B free of {du.total})")
        flags = ["--kv-plane", "shm",
                 "--shm-arena-bytes", str(SHM_ARENA_BYTES)]
        segments0 = _shm_segments()

    def spy_log(event, *args, **kw):
        events.append(event)
        return log_event(event, *args, **kw)

    rss0 = _rss_bytes()
    t0 = time.perf_counter()
    tel.log_event = spy_log
    try:
        server, _ = _serve_cli([
            "--model", "llama-3-8b", "--dp", "2", "--fleet", "subprocess",
            "--num-pages", "512", "--max-pages-per-seq", "128",
            "--max-batch-size", "8", "--host-cache-pages", "2048",
            "--fabric-cache-pages", "256",
            "--fabric-warmboot-pages", str(FABRIC_WARMBOOT_PAGES),
            "--preempt-watermark-pages", "128", "--no-warmup",
            "--seed", str(SEED)] + flags)
    except BaseException:
        tel.log_event = log_event
        raise
    group = server.group
    pids, reads = set(), {}
    drain = shm_out = None
    try:
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        pids |= {h.pid for h in group.workers}
        if shm and group.arena is None:
            raise AssertionError(f"{label}: no arena (events {events})")
        prefix = _chain_hashes(server.tokenizer.encode(system), 16)[:n_prefix]

        def timeline(request_id: str) -> dict:
            for t in group.recent_snapshot(64):
                if t.get("trace_id") == request_id:
                    return t
            raise AssertionError(f"{label}: no timeline for {request_id}")

        def pressured(i: int) -> bool:
            return bool(group.health_snapshot()["replicas"][i]
                        .get("under_pressure"))

        def page_pressure(i: int, n: int) -> None:
            group.apply_chaos({"replica": i, "page_pressure": n})

        seed_r = _stream_request(port, prompts[0], max_tokens)
        seed = timeline(seed_r["request_id"])["routed_replica"]
        other = 1 - seed
        _wait_fleet(group, label,
                    lambda: group.fabric.match_depth(prefix) == n_prefix,
                    "the prefix in the pool", 60.0)
        page_pressure(seed, 512)
        _wait_fleet(group, label, lambda: pressured(seed),
                    "the seed worker under pressure", 60.0)
        # One pull alone (a user suffix no other prompt has), then the
        # other worker's caches dropped so the wave pulls again.
        pulls0 = len(group.fabric_pulls)
        try:
            lone_r = _stream_request(
                port, system + prompts[1][len(system):][::-1], max_tokens)
            lone_tl = timeline(lone_r["request_id"])
            lone_pulls = list(group.fabric_pulls)[pulls0:]
            if (lone_tl["routed_replica"] != other
                    or lone_tl["route_fabric_hit_pages"] != n_prefix
                    or len(lone_pulls) != 1):
                raise AssertionError(
                    f"{label}: the lone request: routed to "
                    f"{lone_tl['routed_replica']}, pulled "
                    f"{lone_tl['route_fabric_hit_pages']} pages in "
                    f"{lone_pulls}")
            group.workers[other].client.rpc("debug", clear=True)
            pulls0 = len(group.fabric_pulls)
            wave, wave_wall = run_requests(port, prompts[1:9], max_tokens)
        finally:
            page_pressure(seed, 0)
        wave_tl = [timeline(r["request_id"]) for r in wave]
        pulls = list(group.fabric_pulls)[pulls0:]
        if any(t["routed_replica"] != other for t in wave_tl):
            raise AssertionError(
                f"{label}: the wave did not route around the pressured "
                f"worker {seed}: {[t['routed_replica'] for t in wave_tl]}")
        warm = [(r["ttft_s"], t["route_fabric_hit_pages"])
                for r, t in zip(wave, wave_tl)]
        if not any(n == n_prefix for _, n in warm):
            raise AssertionError(f"{label}: no dispatch pulled the "
                                 f"{n_prefix}-page prefix: {warm}")
        # The seed worker's counts leave with its process.
        _worker_reads(group, reads, label)
        group._refresh_caches()
        before = _monotone_series(group.prometheus_text())
        hot_set = (group.fabric.hot_set_descs if shm
                   else group.fabric.hot_set)
        pool_order = [d for d, _ in hot_set(FABRIC_WARMBOOT_PAGES)]
        prefix_in_mru64 = len(set(pool_order[:64]) & set(prefix))
        victim = group.workers[seed]
        inc = victim.incarnation
        reclaims0 = group.shm_reclaims
        t_kill = time.perf_counter()
        group.apply_chaos({"replica": seed, "kill": "sigkill"})
        _wait_fleet(group, label, lambda: victim.incarnation > inc
                    and _healed(group), "the respawn after kill -9", 300.0)
        respawn_s = time.perf_counter() - t_kill
        pids |= {h.pid for h in group.workers}
        wb = victim.warmboots[-1] if victim.warmboots else {}
        if (wb.get("incarnation") != victim.incarnation
                or wb.get("adopted", 0) < n_prefix):
            raise AssertionError(f"{label}: the respawn's warm boot {wb}")
        if shm and (wb.get("desc_pages", 0) < n_prefix or wb["relay_bytes"]
                    or group.shm_reclaims <= reclaims0):
            raise AssertionError(
                f"{label}: the respawn's warm boot {wb} was not read from "
                f"the arena, or no slab was reclaimed ("
                f"{group.shm_reclaims - reclaims0})")
        group._refresh_caches()
        n_series = _no_series_fell(label, before,
                                   _monotone_series(group.prometheus_text()))
        # The other worker, idle: its cached pages dropped, so page
        # pressure puts it under the watermark.
        group.workers[other].client.rpc("debug", clear=True)
        page_pressure(other, 512)
        try:
            _wait_fleet(group, label, lambda: pressured(other),
                        "the other worker under pressure", 60.0)
            last = _stream_request(port, prompts[9], max_tokens)
        finally:
            page_pressure(other, 0)
        last_tl = timeline(last["request_id"])
        if (last_tl["routed_replica"] != seed
                or last_tl["route_host_hit_pages"] < n_prefix
                or last_tl["route_fabric_hit_pages"]):
            raise AssertionError(
                f"{label}: the respawn's request: routed to "
                f"{last_tl['routed_replica']}, host-warm "
                f"{last_tl['route_host_hit_pages']}, pulled "
                f"{last_tl['route_fabric_hit_pages']}")
        results = [seed_r, lone_r] + wave + [last]
        if shm:
            drained = _shm_drain(label, group, port, prompts[10],
                                 max_tokens, reads)
            results.append(drained.pop("result"))
            drain = drained
            pids |= {h.pid for h in group.workers}
        failed = [e for e in events
                  if e in ("fabric_pull_failed", "fabric_warmboot_failed",
                           "shm_arena_unavailable")]
        if failed or group.fabric.kv_rejections or group.frame_errors:
            raise AssertionError(
                f"{label}: events {failed}, pool rejections "
                f"{group.fabric.kv_rejections}, frame errors "
                f"{group.frame_errors}")
        final = _worker_reads(group, reads, label)
        _gate_launches(reads, label, "bf16")
        if shm:
            shm_out = _shm_gates(label, group, reads, (
                "handoff", "fabric_put", "migrate", "import-kv"))
        text = group.prometheus_text()
        series = {}
        for line in text.splitlines():
            m = _SAMPLE_LINE.match(line)
            if m and m.group(1).startswith((
                    "tpu_inf_fabric_", "tpu_inf_route_fabric_",
                    "tpu_inf_shm_", "tpu_inf_kv_plane_shm_",
                    "tpu_inf_rpc_blob_bytes_total")):
                series[m.group(1) + (m.group(2) or "")] = float(m.group(3))
        launches = _launch_totals(reads)
        publish = {str(w["replica"]) + "/" + str(w["pid"]): w["fabric"]
                   for w in reads.values()}
        warm_worker = [w for w in final if w["replica"] == other]
        snap = server_stats(port)
        rss = _rss_bytes()
        fabric_snap = group.fabric.snapshot()
        boot_walls = {h.replica: h.boot_walls for h in group.workers}
    finally:
        tel.log_event = log_event
        server.shutdown()
        del server, group
    _pids_gone(label, pids)
    free_after = _card_memory_back(label, free_before)
    if shm:
        left = _shm_segments() - segments0
        if left:
            raise AssertionError(f"{label}: segments left in {_SHM_DIR}: "
                                 f"{sorted(left)}")
    pages = sum(v["published_pages"] for v in publish.values())
    publish_s = sum(v["publish_s"] for v in publish.values())
    ttfts = sorted(r["ttft_s"] for r in results)
    out = {"label": label, "model": "llama-3-8b", "quant": "none",
           "kv_quant": "none", "variant": "bf16", "dp": 2,
           "layers": n_layers, "kv_plane": plane,
           "fleet": "subprocess", "boot_s": boot_s,
           "boot_walls_s": boot_walls, "seed_replica": seed,
           "seed_ttft_s": seed_r["ttft_s"],
           "seed_prompt_tokens": seed_r["prompt_tokens"],
           "wave": {**_summarize(wave, wave_wall),
                    "ttft_and_pulled_pages": warm,
                    "first_fabric_warm_ttft_s": min(
                        t for t, n in warm if n == n_prefix)},
           "lone": {"ttft_s": lone_r["ttft_s"], "pull": lone_pulls[0]},
           "pulls": pulls, "respawn_s": respawn_s, "warm_boot": wb,
           "prefix_pages_in_mru_64": prefix_in_mru64,
           "last": {"ttft_s": last["ttft_s"],
                    "route_host_hit_pages": last_tl["route_host_hit_pages"],
                    "route_fabric_hit_pages":
                        last_tl["route_fabric_hit_pages"]},
           "drain": drain, "shm": shm_out, "dev_shm": dev_shm,
           "publish": publish,
           "publish_s_per_page": publish_s / max(1, pages),
           "fabric": fabric_snap, "series": series,
           "series_checked": n_series,
           "router_rss_bytes": {"before_boot": rss0, "end": rss},
           "fabric_warm_worker_prefill_by_path": (
               warm_worker[0]["kernels"]["prefill_by_path"]
               if warm_worker else None),
           "requests": len(results),
           "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
           "launches_by_variant": launches["by_variant"],
           "decode_launches_by_batch": launches["decode_by_batch"],
           "prefill_launches_by_len": launches["prefill_by_len"],
           "prefill_launches_by_path": launches["prefill_by_path"],
           "workers_read": len(reads),
           "step_failures": snap["step_failures"],
           "free_memory_before_after_bytes": [free_before, free_after]}
    log(f"[{label}] on {card}: " + json.dumps(
        {k: v for k, v in out.items() if k != "label"}))

    def parts(p: dict) -> dict:
        w = p.get("worker_parts_s") or {}
        return {"wall_s": p["wall_s"], "mb": p["bytes"] / 1e6,
                **{k: w.get(k) for k in ("read", "deserialize", "apply")},
                **{k: p[k] for k in ("get_s", "serialize_s") if k in p}}

    log(f"[{label}] pull parts (s): alone "
        f"{json.dumps(parts(lone_pulls[0]))}; 8 at once "
        f"{json.dumps([parts(p) for p in pulls])}")
    return out


def _shm_drain(label: str, group, port: int, prompt: str, max_tokens: int,
               reads: dict) -> dict:
    """The shm arm's drain: one more request, and SIGTERM to the worker
    serving it once it decodes. Gates: the stream "length" with its
    tokens, one migration by descriptor (bytes migrated, none relayed),
    the drain settled inside drain_timeout_s, the worker back. Returns
    the walls (SIGTERM to the worker's exit, and to the request running
    on the other worker), the bytes and the request's result."""
    box: dict = {}

    def traffic():
        box["results"], box["wall"] = run_requests(port, [prompt],
                                                   max_tokens)

    th = threading.Thread(target=traffic)
    th.start()

    def mid_decode():
        with group._lock:
            return [e.worker.replica for e in group._tracked.values()
                    if e.worker is not None
                    and 4 <= len(e.tokens) <= max_tokens - 16]

    _wait_fleet(group, label, lambda: bool(mid_decode()),
                "the drained request mid-decode", 300.0)
    victim = mid_decode()[0]
    vh = group.workers[victim]
    _worker_reads(group, reads, label)
    mig0, bytes0 = group.migrations, group.migrated_bytes
    relayed0 = dict(group.rpc_blob_bytes)
    restarts0 = vh.restarts
    budget = group.server_cfg.drain_timeout_s
    t_kill = time.perf_counter()
    group.apply_chaos({"replica": victim, "kill": "sigterm"})
    _wait_fleet(group, label, lambda: vh.state != "up", "the drain",
                budget + 30)
    exit_s = time.perf_counter() - t_kill

    def settled():
        with group._lock:
            return all(e.worker not in (None, vh)
                       for e in group._tracked.values())

    _wait_fleet(group, label, settled, "the migration", budget + 30)
    settled_s = time.perf_counter() - t_kill
    th.join(timeout=300)
    if th.is_alive() or "results" not in box:
        raise AssertionError(f"{label}: the drained request did not finish")
    _wait_fleet(group, label, lambda: vh.restarts > restarts0
                and _healed(group), "the restart after the drain", 300.0)
    out = {"replica": victim, "worker_exit_s": exit_s,
           "settled_s": settled_s, "migrations": group.migrations - mig0,
           "migrated_bytes": group.migrated_bytes - bytes0,
           "relayed_bytes": {v: group.rpc_blob_bytes[v] - relayed0[v]
                             for v in relayed0},
           "result": box["results"][0]}
    if (out["migrations"] != 1 or out["migrated_bytes"] <= 0
            or any(out["relayed_bytes"].values())
            or settled_s > budget):
        raise AssertionError(f"{label}: the drain did not migrate by "
                             f"descriptor inside {budget} s: {out}")
    return out


# ---------------------------------------------------------------------------
# Tensor and expert parallelism: tp shards driven by one process
# (parallel/tp.py), every shard on the one card.
# ---------------------------------------------------------------------------

# A tp shard's attention heads (Hq, Hkv, head_dim) of Llama-3-8B (and
# Mixtral-8x7B): tp 2 and tp 4.
TP_HEADS = {2: (16, 4, 128), 4: (8, 2, 128)}
# The tiny models held at tp > 1 against tp 1 (every tp their heads,
# d_ff, vocab and experts divide).
TP_TINY = (("tiny_llama", (2,)), ("tiny_llama_fatkv", (2, 4)),
           ("tiny_mixtral", (2,)), ("tiny_gpt2", (2, 4)))
# The full-width lanes: (label, quant, kv_quant, variant, layers cut).
TP_LANES = (("tp2 bf16", "none", "none", "bf16", CUT_LAYERS),
            ("tp2 int8 weights + int8 KV", "int8", "int8", "int8",
             CUT_LAYERS))


def _tp_mesh(tp: int):
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.parallel import build_mesh
    return build_mesh(cfgs.ParallelConfig(tp=tp))


def _heads_counts() -> dict:
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    return {"paged_attention": dict(pa.launches_by_heads),
            "prefill_attention": dict(pfa.launches_by_heads)}


def _gate_heads(label: str, want: str, need_decode: bool = True) -> dict:
    """Both kernels launched at the shard's heads ``want`` ("Hq/Hkv") and
    at no other since the last reset."""
    got = _heads_counts()
    for name, counts in got.items():
        if name == "paged_attention" and not need_decode and not counts:
            continue
        if set(counts) != {want} or counts[want] <= 0:
            raise AssertionError(f"{label}: {name} launched at heads "
                                 f"{counts}; every shard runs at {want}")
    return got


def tp_kernel_cases() -> dict:
    """(a) Both kernels at the head-sharded shapes of Llama-3-8B at tp 2
    (Hq 16, Hkv 4) and tp 4 (Hq 8, Hkv 2) against their plain versions,
    timed as the full-head cases are: decode B 8 ctx 1024 over the bf16,
    int8 and int4 pools, prefill 512 at offset 1024 over bf16 and int8."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    bf16 = torch.bfloat16
    decode, prefill = [], []
    for tp, heads in TP_HEADS.items():
        for kv in ("none", "int8", "int4"):
            tag = "" if kv == "none" else f" {kv} pool"
            c = decode_case(f"decode tp{tp} bs8 ctx1024{tag}", 8,
                            [1024] * 8, 0, bf16, flush, gen, kv, heads=heads)
            decode.append({**c, "tp": tp})
        for kv in ("none", "int8"):
            tag = "" if kv == "none" else f" {kv} pool"
            c = prefill_case(f"prefill tp{tp} chunk 512 at offset 1024{tag}",
                             512, [1024], [1500], 0, bf16, flush, gen, kv,
                             heads=heads)
            prefill.append({**c, "tp": tp})
    del flush
    return {"decode": decode, "prefill": prefill}


def tp_tiny_phase() -> list:
    """(b) Tiny float32 models on the card with the kernel backend: greedy
    tokens at tp 2 (and tp 4 where the heads divide) equal tp 1's on the
    same weights, every shard's kernels launched at its head counts and
    at no other, the pools clean; then tiny-llama with int8 weights over
    an int8 pool and grouped int4 weights over an int4 pool at tp 2, and
    a pipelined decode (depth 2, through the scheduler) at tp 2."""
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.models.registry import build_model

    base = cfgs.EngineConfig(page_size=8, num_pages=64, max_pages_per_seq=16,
                             max_batch_size=4, prefill_buckets=(16, 32),
                             decode_steps_per_call=4)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 12, 27, 70)]
    cases = ([(p, tps, "none", "none", {}) for p, tps in TP_TINY]
             + [("tiny_llama", (2,), q, q, {}) for q in ("int8", "int4")]
             + [("tiny_llama", (2,), "none", "none",
                 {"decode_pipeline_depth": 2})])
    done = []
    for preset, tps, quant, kv_quant, over in cases:
        mcfg = tiny_config(preset)
        ecfg = dataclasses.replace(base, quant=quant, kv_quant=kv_quant,
                                   **over)
        params, _ = build_model(mcfg, seed=SEED, device="cuda", quant=quant)

        def run(tp: int):
            eng = InferenceEngine(mcfg, ecfg, params=params,
                                  attn_backend="kernel", device="cuda",
                                  mesh=_tp_mesh(tp) if tp > 1 else None)
            if over:
                out = _sched_run(eng, prompts, 24)
                return [out[i] for i in range(len(prompts))]
            out = eng.generate(prompts, max_new_tokens=12)
            eng.check_pool_clean()
            return out

        want = run(1)
        label = (f"tp {mcfg.name} quant={quant} kv_quant={kv_quant}"
                 + (" depth 2" if over else ""))
        heads = {}
        for tp in tps:
            pa.reset_counts()
            pfa.reset_counts()
            got = run(tp)
            if got != want:
                raise AssertionError(f"{label}: tp {tp} greedy tokens differ "
                                     f"from tp 1: {got} vs {want}")
            heads[tp] = _gate_heads(
                f"{label} tp {tp}",
                f"{mcfg.n_heads // tp}/{mcfg.n_kv_heads // tp}")
        log(f"engine {label}: tokens at tp {list(tps)} identical to tp 1 "
            f"({sum(len(t) for t in want)} tokens), pools clean; launches by "
            f"shard heads {json.dumps(heads)}")
        done.append({"label": label, "tps": list(tps), "heads": heads})
    return done


def _widen(tree: dict) -> dict:
    """A params dict with every float leaf in float32 (quantized codes
    and scales as they are)."""
    return {k: _widen(v) if isinstance(v, dict)
            else v.float() if isinstance(v, torch.Tensor) else v
            for k, v in tree.items()}


def _tp_reference_logits(mcfg, quant: str, kv_quant: str, prompt: list,
                         tp: int) -> dict:
    """The first-step logits (and first tokens) a tp lane is held
    against, on the seeded weights the CLI builds: ``bf16`` at tp 1;
    then those weights widened to float32 at tp 1, at tp 1 with the
    prompt in a 1024-row bucket (only the GEMMs' M changes: float32's
    own noise) and at ``tp`` (``f32``, ``f32_m1024``, ``f32_tp``)."""
    import gc

    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models.registry import build_model

    def first(cfg, params, buckets=None, tp_: int = 1) -> tuple:
        kw = {"prefill_buckets": buckets} if buckets else {}
        eng = InferenceEngine(cfg, cfgs.EngineConfig(
            page_size=16, num_pages=64, max_pages_per_seq=128,
            max_batch_size=8, quant=quant, kv_quant=kv_quant, **kw),
            params=params, device="cuda",
            mesh=_tp_mesh(tp_) if tp_ > 1 else None)
        logits, token, *_ = _first_step(eng, prompt)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return logits, token

    params, _ = build_model(mcfg, seed=SEED, device="cuda", quant=quant)
    out = {"bf16": first(mcfg, params)}
    wide = _widen(params)
    del params
    gc.collect()
    f32 = dataclasses.replace(mcfg, dtype=torch.float32)
    out["f32"] = first(f32, wide)
    out["f32_m1024"] = first(f32, wide, (1024,))
    out["f32_tp"] = first(f32, wide, tp_=tp)
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def tp_serve_phase(label: str, quant: str, kv_quant: str, variant: str,
                   card: str) -> dict:
    """(c)/(d) llama-3-8b at full width through the CLI
    (``--model llama-3-8b --tp 2``), its first-step logits held against
    tp 1's on the same seeded weights by two gates (every number
    printed):

    - the tp arithmetic, in float32 (the weights widened, TF32 off):
      tp 2 within max(TOL float32 x the largest |logit|, 4 x float32's
      own noise) of tp 1, the noise being tp 1 against itself with only
      the GEMMs' M changed;
    - the served bf16 model: tp 2 within 2 x tp 1's own bf16 error (tp
      1 bf16 against tp 1 float32) of tp 1. Not a fixed share of the
      largest |logit|: on an H100 bf16 tp 2 and tp 1 differ by 3.6% of
      it at 32 layers while their float32 forms agree to 1.6e-5, as
      cuBLAS's own bf16 rounding of a full-width row-parallel product
      is 1 ulp off the exact product in 0.24-0.78% of its elements (tp
      2's float32 partial sums: 0.13-0.42%) and the norms spread each
      such ulp over the row (scripts/tp_logit_gap.py measures both).

    Then the main path's six requests, every one finishing "length"
    with all its tokens, both kernels launched in the lane's variant
    only and at the shard's heads (Hq 16 / Hkv 4) only. The server is
    freed after."""
    import gc

    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa

    tp = 2
    mcfg = cfgs.PRESETS["llama-3-8b"]()
    prompt = np.random.default_rng(SEED + 2).integers(
        0, mcfg.vocab_size, size=300).tolist()
    allocated_before = _free_card(label)
    t0 = time.perf_counter()
    refs = _tp_reference_logits(mcfg, quant, kv_quant, prompt, tp)
    refs_s = time.perf_counter() - t0
    f32, scale32 = refs["f32"][0], refs["f32"][0].abs().max().item()
    noise = _max_diff(refs["f32_m1024"][0], f32)
    diff_f32 = _max_diff(refs["f32_tp"][0], f32)
    limit_f32 = max(TOL[torch.float32] * scale32, 4 * noise)
    want = refs["bf16"][0]
    bf16_err = _max_diff(want, f32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, engine_args = _serve_cli([
        "--model", "llama-3-8b", "--tp", str(tp), "--quant", quant,
        "--kv-quant", kv_quant, "--num-pages", "512",
        "--max-pages-per-seq", "128", "--max-batch-size", "8",
        "--host-cache-pages", "0", "--seed", str(SEED), "--debug"])
    try:
        eng = server.engine
        hkv = [s.k.shape[3] for s in eng.kv.shards]
        if eng.tp != tp or hkv != [mcfg.n_kv_heads // tp] * tp:
            raise AssertionError(f"{label}: engine tp {eng.tp}, pool heads "
                                 f"per shard {hkv}")
        got, first_tp, *_ = _first_step(eng, prompt)
        diff = _max_diff(got, want)
        scale = want.abs().max().item()
        gates = {
            "f32_max_abs_diff": diff_f32, "f32_limit": limit_f32,
            "f32_max_abs_logit": scale32, "f32_m_noise": noise,
            "bf16_max_abs_diff": diff, "bf16_max_abs_logit": scale,
            "bf16_over_max_logit": diff / scale,
            "bf16_tp1_err_vs_f32": bf16_err, "bf16_limit": 2 * bf16_err,
            "first_tokens": {"bf16_tp1": refs["bf16"][1], "bf16_tp2":
                             first_tp, "f32_tp1": refs["f32"][1],
                             "f32_tp2": refs["f32_tp"][1]}}
        log(f"[{label}] first-step logits, tp {tp} vs tp 1: float32 max "
            f"|diff| {diff_f32:.4g} (limit {limit_f32:.4g}; max |logit| "
            f"{scale32:.4g}, float32 M noise {noise:.4g}); bf16 max |diff| "
            f"{diff:.4g}, max |logit| {scale:.4g} ({diff / scale:.4g} of "
            f"it; limit 2 x tp 1's bf16 error against float32 "
            f"{bf16_err:.4g}); first tokens "
            f"{json.dumps(gates['first_tokens'])}")
        if not diff_f32 <= limit_f32:
            raise AssertionError(f"{label}: float32 tp {tp} first-step "
                                 f"logits off by {diff_f32:.4g} (limit "
                                 f"{limit_f32:.4g})")
        if not diff <= 2 * bf16_err:
            raise AssertionError(f"{label}: bf16 tp {tp} first-step logits "
                                 f"off by {diff:.4g}, over twice tp 1's own "
                                 f"bf16 error {bf16_err:.4g}")
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        max_tokens = 48
        pa.reset_counts()
        pfa.reset_counts()
        results, wall = run_requests(port, _prompts(), max_tokens)
        counts = _check_variant(label, variant)
        heads = _gate_heads(label, f"{mcfg.n_heads // tp}/{hkv[0]}")
        short = [r["eval_count"] for r in results
                 if r["done_reason"] != "length"
                 or r["eval_count"] != max_tokens]
        if short:
            raise AssertionError(f"{label}: requests ended short: {short}")
        phases = engine_phases(server_stats(port))
        serve_peak = torch.cuda.max_memory_allocated()
        n_layers, weight_bytes = eng.model_cfg.n_layers, eng.weight_bytes
    finally:
        server.shutdown()
        del server
        gc.collect()
        torch.cuda.empty_cache()
    return {
        "label": label, "model": "llama-3-8b", "layers": n_layers, "tp": tp,
        "activations": "bfloat16", "quant": quant, "kv_quant": kv_quant,
        "variant": variant, "boot_s": boot_s, "reference_logits_s": refs_s,
        "allocated_before_boot_bytes": allocated_before,
        "max_memory_allocated": serve_peak, "weight_bytes": weight_bytes,
        "logit_gates": gates, "max_tokens": max_tokens, "engine_args": {
            k: engine_args[k] for k in ("num_pages", "max_batch_size",
                                        "decode_ladder")},
        **_summarize(results, wall),
        "ttft_s": [r["ttft_s"] for r in results],
        "launches_by_variant": counts["by_variant"],
        "decode_launches_by_batch": counts["decode_by_batch"],
        "prefill_launches_by_len": counts["prefill_by_len"],
        "prefill_launches_by_path": counts["prefill_by_path"],
        "launches_by_heads": heads, "engine_phases": phases,
    }


def tp_phase(card: str) -> dict:
    """Gates (a)-(d) of tensor parallelism (the docstring's item 11)."""
    out, walls = {}, {}
    for name, fn in (("kernels", tp_kernel_cases), ("tiny", tp_tiny_phase)):
        t = time.perf_counter()
        out[name] = fn()
        walls[name] = time.perf_counter() - t
    for c in out["kernels"]["decode"] + out["kernels"]["prefill"]:
        log(f"kernel {c['variant']} [{c['dtype']}]: err "
            f"{c['max_abs_err']:.3g} ({c['err_over_scale']:.3g} of the "
            f"largest output) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
            f"library {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
            f"({c['bound_by']})" + (f" path {c['path']}" if "path" in c
                                    else ""))
    out["lanes"] = []
    for label, quant, kv_quant, variant, cut in TP_LANES:
        if cut:
            log(f"tp lane [{label}]: llama-3-8b cut to {cut} of its 32 "
                "layers (the script's time limit)")
        t = time.perf_counter()
        with (_depth_cut("llama-3-8b", cut) if cut
              else contextlib.nullcontext()):
            mp = tp_serve_phase(label, quant, kv_quant, variant, card)
        walls[label] = time.perf_counter() - t
        per = mp["decode_tok_s_per_request"]
        log(f"main path llama-3-8b [{label}] on {card}: {mp['layers']} "
            f"layers, {mp['requests']} requests, TTFT p50 "
            f"{mp['ttft_p50_s']:.3f}s max {mp['ttft_max_s']:.3f}s; decode "
            f"{min(per):.1f}-{max(per):.1f} tok/s per request, "
            f"{mp['aggregate_tok_s']:.1f} aggregate; peak allocated "
            f"{mp['max_memory_allocated'] / 1e9:.2f} GB; launches "
            f"{json.dumps(mp['launches_by_variant'])}; by shard heads "
            f"{json.dumps(mp['launches_by_heads'])}")
        out["lanes"].append(mp)
    out["walls_s"] = walls
    return out


# The sp phase's tiny engines: (preset, tp, sp, sp_attn, kv_quant).
SP_TINY = (("tiny_llama_fatkv", 1, 2, "ring", "none"),
           ("tiny_llama_fatkv", 1, 4, "ring", "none"),
           ("tiny_llama_fatkv", 1, 2, "ulysses", "none"),
           ("tiny_llama_fatkv", 2, 2, "ring", "none"),
           ("tiny_llama_fatkv", 2, 2, "ulysses", "none"),
           ("tiny_mistral", 1, 2, "ring", "none"),
           ("tiny_mistral", 1, 2, "ulysses", "none"),
           ("tiny_llama_fatkv", 2, 2, "ring", "int8"))
# (b): the sp attention against dense attention at Llama-3-8B's heads.
SP_ATTN_CASES = (("ring", 2), ("ring", 4), ("ulysses", 2))
SP_ATTN_S = 4096
# The full-width lanes: (label, quant, kv_quant, variant, tp, sp, sp_attn,
# layers cut).
SP_LANES = (("sp2 ring bf16", "none", "none", "bf16", 1, 2, "ring", None),
            ("tp2 x sp2 ulysses int8 weights + int8 KV", "int8", "int8",
             "int8", 2, 2, "ulysses", CUT_LAYERS))
# Buckets and table width of the sp lanes: a 4096-token prompt prefills
# in one chunk (the sp path takes single-chunk prompts only).
SP_BUCKETS = (512, 1024, 2048, 4096)
SP_MAX_PAGES = 272                      # 4352 tokens of context at page 16


def _sp_mesh(tp: int, sp: int):
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.parallel import build_mesh
    return build_mesh(cfgs.ParallelConfig(tp=tp, sp=sp))


def sp_tiny_phase() -> list:
    """(a) Tiny float32 engines on the card (kernel backend): greedy
    tokens at each SP_TINY mesh equal sp 1's on the same weights; every
    fresh single-chunk prompt counted on the sp path (the engine's
    prefill_paths) and no other; then, where the prefix cache is on, a
    prompt over a cached prefix served by the prefill kernel (paged
    path, launches counted); pools clean."""
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.models.registry import build_model

    base = cfgs.EngineConfig(page_size=8, num_pages=96, max_pages_per_seq=16,
                             max_batch_size=4, prefill_buckets=(16, 32, 128),
                             decode_steps_per_call=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (5, 12, 27, 100)]
    done = []
    for preset, tp, sp, attn, kv_quant in SP_TINY:
        mcfg = tiny_config(preset)
        ecfg = dataclasses.replace(base, kv_quant=kv_quant, sp_attn=attn)
        params, _ = build_model(mcfg, seed=SEED, device="cuda")

        def engine(tp_: int, sp_: int):
            return InferenceEngine(mcfg, ecfg, params=params,
                                   attn_backend="kernel", device="cuda",
                                   mesh=(_sp_mesh(tp_, sp_)
                                         if tp_ * sp_ > 1 else None))

        want = engine(1, 1).generate(prompts, max_new_tokens=12)
        label = (f"sp {mcfg.name} tp {tp} x sp {sp} {attn} "
                 f"kv_quant={kv_quant}")
        eng = engine(tp, sp)
        got = eng.generate(prompts, max_new_tokens=12)
        if got != want:
            raise AssertionError(f"{label}: greedy tokens differ from sp 1: "
                                 f"{got} vs {want}")
        fresh = {f"sp_{attn}": len(prompts)}
        if eng.prefill_paths != fresh:
            raise AssertionError(f"{label}: prefill chunks by path "
                                 f"{eng.prefill_paths}; every fresh prompt "
                                 f"must take the sp path ({fresh})")
        cached = None
        if eng.prefix_cache is not None:
            # The longest prompt's pages are cached now: a prompt over
            # them prefills its tail through the prefill kernel.
            seq = Sequence(request_id=99, prompt_tokens=prompts[3][:96]
                           + [1, 2, 3], max_new_tokens=4)
            n0 = pfa.launches
            eng.prefill(seq)
            while not seq.done:
                eng.decode_steps()
            eng.release(seq)
            cached = {"cached_tokens": seq.cached_tokens,
                      "prefill_launches": pfa.launches - n0,
                      "paths": dict(eng.prefill_paths)}
            if (seq.cached_tokens <= 0 or cached["prefill_launches"] <= 0
                    or eng.prefill_paths.get("paged") != 1):
                raise AssertionError(f"{label}: the cached-prefix prompt "
                                     f"did not take the prefill kernel: "
                                     f"{cached}")
        eng.check_pool_clean()
        log(f"engine {label}: tokens identical to sp 1 "
            f"({sum(len(t) for t in want)} tokens), prefill chunks by path "
            f"{json.dumps(fresh)}, cached prefix {json.dumps(cached)}, "
            "pool clean")
        done.append({"label": label, "paths": fresh, "cached": cached})
    return done


def sp_attention_cases() -> list:
    """(b) Ring at sp 2 and 4 and Ulysses at sp 2 (every slice on the one
    card) at Llama-3-8B's heads (Hq 32, Hkv 8, D 128), S SP_ATTN_S, bf16
    and float32, each within check_close of dense_causal_attention on
    the same inputs; device times beside dense attention's and the
    prefill kernel's on a fresh prompt of the same length (prefill_case:
    q_offset 0, kv_len S, checked against its plain version too). These
    are evidence, not kernels of the repo's table."""
    from tpu_inference_torch.kernels.ring_attention import (
        ring_attention_local, seq_sharded_call)
    from tpu_inference_torch.kernels.ulysses_attention import (
        ulysses_attention_local)
    from tpu_inference_torch.models.common import dense_causal_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    hq, hkv, d = LLAMA_HEADS
    s = SP_ATTN_S
    bodies = {"ring": ring_attention_local,
              "ulysses": ulysses_attention_local}
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((1, s, hq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((1, s, hkv, d), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((1, s, hkv, d), generator=gen,
                        device="cuda").to(dtype)
        want = dense_causal_attention(q, k, v)
        dense_ms = time_ms(lambda: dense_causal_attention(q, k, v), iters=5)
        kernel = prefill_case(f"prefill fresh S {s}", s, [0], [s], 0, dtype,
                              flush, gen)
        for attn, sp in SP_ATTN_CASES:
            devs = [torch.device("cuda", 0)] * sp

            def run():
                return seq_sharded_call(bodies[attn], q, k, v, devs)

            name = f"{attn} sp {sp} S {s}"
            err, rel = check_close(name, run(), want, dtype)
            out.append({"name": name, "dtype": str(dtype)[6:],
                        "shape": {"B": 1, "S": s, "Hq": hq, "Hkv": hkv,
                                  "D": d, "sp": sp},
                        "max_abs_err": err, "err_over_scale": rel,
                        "ms": time_ms(run, iters=5), "dense_ms": dense_ms,
                        "prefill_kernel_ms": kernel["ms"],
                        "prefill_kernel_path": kernel["path"],
                        "prefill_kernel_max_abs_err": kernel["max_abs_err"]})
        del q, k, v, want
    del flush
    return out


def _sp_reference_logits(mcfg, quant: str, kv_quant: str, prompt: list,
                         tp: int, sp: int, sp_attn: str) -> dict:
    """The first-step logits (and first tokens, and the prefill's wall)
    an sp lane is held against, on the seeded weights the CLI builds:
    ``bf16`` at tp 1 x sp 1 (the wall of its second, warm run); then
    those weights widened to float32 at tp 1 x sp 1, the same with the
    prompt in a 16-row-larger bucket (only the GEMMs' M changes:
    float32's own noise), and at the lane's tp x sp (``f32``, ``f32_m``,
    ``f32_sp``). A fresh prompt's sp prefill attends its raw K/V, not
    the pool (as the reference's), so the tp 1 x sp 1 engines run over a
    float pool: a quantized pool would put its codes' error into the
    references' first step and not into the lane's."""
    import gc

    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models.registry import build_model

    n = len(prompt)

    def first(cfg, params, bucket=SP_BUCKETS[-1], tp_=1, sp_=1,
              repeat: int = 1) -> tuple:
        eng = InferenceEngine(cfg, cfgs.EngineConfig(
            page_size=16, num_pages=SP_MAX_PAGES + 8,
            max_pages_per_seq=SP_MAX_PAGES, max_batch_size=8, quant=quant,
            kv_quant=kv_quant if tp_ * sp_ > 1 else "none",
            prefill_buckets=(bucket,), sp_attn=sp_attn,
            enable_prefix_cache=False),
            params=params, device="cuda",
            mesh=_sp_mesh(tp_, sp_) if tp_ * sp_ > 1 else None)
        for _ in range(repeat):
            logits, token, _, _, _, wall = _first_step(eng, prompt)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return logits, token, wall

    params, _ = build_model(mcfg, seed=SEED, device="cuda", quant=quant)
    out = {"bf16": first(mcfg, params, repeat=2)}
    wide = _widen(params)
    del params
    gc.collect()
    f32 = dataclasses.replace(mcfg, dtype=torch.float32)
    out["f32"] = first(f32, wide)
    out["f32_m"] = first(f32, wide, bucket=n + 16)
    out["f32_sp"] = first(f32, wide, tp_=tp, sp_=sp)
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sp_prompts() -> list:
    """Four fresh prompts of 2048-4095 tokens (byte tokenizer: n bytes ->
    n + 1 tokens), distinct from their first bytes on, then one sharing
    the third's first 3000 bytes (187 full pages cached after it
    finishes)."""
    import numpy as np
    words = []
    for i, n in enumerate((2047, 2600, 3300, 4094)):
        rng = np.random.default_rng(SEED + 40 + i)
        words.append("".join(chr(97 + c) for c in
                             rng.integers(0, 26, size=n)))
    tail = "".join(chr(65 + c) for c in
                   np.random.default_rng(SEED + 50).integers(0, 26, 700))
    return words + [words[2][:3000] + tail]


def sp_serve_phase(label: str, quant: str, kv_quant: str, variant: str,
                   tp: int, sp: int, sp_attn: str, card: str) -> dict:
    """(c)/(d) llama-3-8b at full width through the CLI (``--sp 2
    --sp-attn ...``, buckets up to 4096 and a table of SP_MAX_PAGES
    pages), its first-step logits on a 4096-token prompt held against tp
    1 x sp 1's on the same seeded weights under the tp lanes' rule
    (float32 within max(TOL float32 x the largest |logit|, 4 x float32's
    own M noise); bf16 within 2 x tp 1 x sp 1's own bf16 error against
    float32). Then four fresh prompts of 2048-4095 tokens at once and one
    over a cached prefix: every request "length" with its 48 tokens, the
    fresh ones on the sp path, the cached one on the prefill kernel (the
    engine's prefill_paths), both kernels launched in the lane's variant
    only. The prefill walls of the 4096-token prompt alone (sp 1 vs the
    lane) are recorded beside the requests' TTFTs. The server is freed
    after."""
    import gc

    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa

    mcfg = cfgs.PRESETS["llama-3-8b"]()
    prompt = np.random.default_rng(SEED + 3).integers(
        0, mcfg.vocab_size, size=SP_BUCKETS[-1]).tolist()
    allocated_before = _free_card(label)
    t0 = time.perf_counter()
    refs = _sp_reference_logits(mcfg, quant, kv_quant, prompt, tp, sp,
                                sp_attn)
    refs_s = time.perf_counter() - t0
    f32, scale32 = refs["f32"][0], refs["f32"][0].abs().max().item()
    noise = _max_diff(refs["f32_m"][0], f32)
    diff_f32 = _max_diff(refs["f32_sp"][0], f32)
    limit_f32 = max(TOL[torch.float32] * scale32, 4 * noise)
    want = refs["bf16"][0]
    bf16_err = _max_diff(want, f32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, engine_args = _serve_cli([
        "--model", "llama-3-8b", "--tp", str(tp), "--sp", str(sp),
        "--sp-attn", sp_attn, "--quant", quant, "--kv-quant", kv_quant,
        "--num-pages", "1536", "--max-pages-per-seq", str(SP_MAX_PAGES),
        "--prefill-buckets", ",".join(map(str, SP_BUCKETS)),
        "--max-batch-size", "8", "--host-cache-pages", "0",
        "--seed", str(SEED), "--debug"])
    try:
        eng = server.engine
        if (eng.tp, eng.sp) != (tp, sp):
            raise AssertionError(f"{label}: engine tp {eng.tp} sp {eng.sp}")
        got, first_sp, _, _, _, sp_wall = _first_step(eng, prompt)
        diff = _max_diff(got, want)
        scale = want.abs().max().item()
        gates = {
            "f32_max_abs_diff": diff_f32, "f32_limit": limit_f32,
            "f32_max_abs_logit": scale32, "f32_m_noise": noise,
            "bf16_max_abs_diff": diff, "bf16_max_abs_logit": scale,
            "bf16_over_max_logit": diff / scale,
            "bf16_sp1_err_vs_f32": bf16_err, "bf16_limit": 2 * bf16_err,
            "first_tokens": {"bf16_sp1": refs["bf16"][1], "bf16_sp":
                             first_sp, "f32_sp1": refs["f32"][1],
                             "f32_sp": refs["f32_sp"][1]}}
        log(f"[{label}] first-step logits on a {len(prompt)}-token prompt, "
            f"tp {tp} x sp {sp} {sp_attn} vs tp 1 x sp 1: float32 max "
            f"|diff| {diff_f32:.4g} (limit {limit_f32:.4g}; max |logit| "
            f"{scale32:.4g}, float32 M noise {noise:.4g}); bf16 max |diff| "
            f"{diff:.4g}, max |logit| {scale:.4g} ({diff / scale:.4g} of "
            f"it; limit 2 x sp 1's bf16 error against float32 "
            f"{bf16_err:.4g}); first tokens "
            f"{json.dumps(gates['first_tokens'])}")
        if not diff_f32 <= limit_f32:
            raise AssertionError(f"{label}: float32 first-step logits off "
                                 f"by {diff_f32:.4g} (limit "
                                 f"{limit_f32:.4g})")
        if not diff <= 2 * bf16_err:
            raise AssertionError(f"{label}: bf16 first-step logits off by "
                                 f"{diff:.4g}, over twice sp 1's own bf16 "
                                 f"error {bf16_err:.4g}")
        port = server.start(port=0)
        boot_s = time.perf_counter() - t0
        max_tokens = 48
        prompts = _sp_prompts()
        pa.reset_counts()
        pfa.reset_counts()
        eng.prefill_paths.clear()
        results, wall = run_requests(port, prompts[:4], max_tokens)
        fresh_paths = dict(eng.prefill_paths)
        cached, _ = run_requests(port, prompts[4:], max_tokens)
        results += cached
        counts = _check_variant(label, variant)
        paths = dict(eng.prefill_paths)
        want_paths = {f"sp_{sp_attn}": 4, "paged": 1}
        if fresh_paths != {f"sp_{sp_attn}": 4} or paths != want_paths:
            raise AssertionError(f"{label}: prefill chunks by path "
                                 f"{fresh_paths} then {paths}; want the four "
                                 f"fresh prompts on the sp path and the "
                                 f"cached one paged ({want_paths})")
        short = [r["eval_count"] for r in results
                 if r["done_reason"] != "length"
                 or r["eval_count"] != max_tokens]
        if short:
            raise AssertionError(f"{label}: requests ended short: {short}")
        phases = engine_phases(server_stats(port))
        serve_peak = torch.cuda.max_memory_allocated()
        n_layers, weight_bytes = eng.model_cfg.n_layers, eng.weight_bytes
    finally:
        server.shutdown()
        del server
        gc.collect()
        torch.cuda.empty_cache()
    return {
        "label": label, "model": "llama-3-8b", "layers": n_layers, "tp": tp,
        "sp": sp, "sp_attn": sp_attn, "activations": "bfloat16",
        "quant": quant, "kv_quant": kv_quant, "variant": variant,
        "boot_s": boot_s, "reference_logits_s": refs_s,
        "allocated_before_boot_bytes": allocated_before,
        "max_memory_allocated": serve_peak, "weight_bytes": weight_bytes,
        "logit_gates": gates, "max_tokens": max_tokens,
        "prefill_wall_4096_s": {"sp1_bf16": refs["bf16"][2],
                                "lane": sp_wall},
        "prefill_paths": paths, "engine_args": {
            k: engine_args[k] for k in ("num_pages", "max_batch_size",
                                        "decode_ladder")},
        **_summarize(results, wall),
        "ttft_s": [r["ttft_s"] for r in results],
        "launches_by_variant": counts["by_variant"],
        "decode_launches_by_batch": counts["decode_by_batch"],
        "prefill_launches_by_len": counts["prefill_by_len"],
        "prefill_launches_by_path": counts["prefill_by_path"],
        "launches_by_heads": _heads_counts(), "engine_phases": phases,
    }


def sp_pp_phase() -> list:
    """(e) pp_forward of llama-3-8b at full width (32 layers) at pp 2 and
    4, 4 micro-batches over 4 x 512 tokens, against the unsharded forward
    with the same dense attention: float32 (weights widened) within
    max(TOL float32 x the largest |logit|, 4 x float32's own M noise, the
    unsharded forward micro-batch by micro-batch); bf16 within twice the
    unsharded bf16's own error against float32."""
    import gc

    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.models import llama
    from tpu_inference_torch.models.common import make_dense_attn
    from tpu_inference_torch.models.registry import build_model
    from tpu_inference_torch.parallel.mesh import Mesh
    from tpu_inference_torch.parallel.pipeline import pp_forward

    import numpy as np
    mcfg = cfgs.PRESETS["llama-3-8b"]()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    toks = torch.randint(0, mcfg.vocab_size, (4, 512), generator=gen,
                         device="cuda")
    pos = torch.arange(512, device="cuda")[None].expand(4, 512)

    def mesh(pp: int) -> Mesh:
        devs = np.empty(pp, dtype=object)
        devs[:] = [torch.device("cuda", 0)] * pp
        return Mesh(devs, ("pp",))

    def plain(params, cfg, rows=slice(None)):
        with torch.no_grad():
            out, _ = llama.forward(params, cfg, toks[rows], pos[rows], None,
                                   make_dense_attn(cfg.sliding_window))
        return out

    def run(params, cfg) -> dict:
        out = {"plain": plain(params, cfg)}
        for pp in (2, 4):
            t = time.perf_counter()
            out[pp] = pp_forward(params, cfg, toks, pos, mesh(pp), n_micro=4)
            torch.cuda.synchronize()
            out[f"wall_{pp}"] = time.perf_counter() - t
        return out

    params, _ = build_model(mcfg, seed=SEED, device="cuda")
    b16 = run(params, mcfg)
    wide = _widen(params)
    del params
    gc.collect()
    f32cfg = dataclasses.replace(mcfg, dtype=torch.float32)
    f32 = run(wide, f32cfg)
    f32_m = torch.cat([plain(wide, f32cfg, slice(i, i + 1))
                       for i in range(4)])
    del wide
    gc.collect()
    scale32 = f32["plain"].abs().max().item()
    noise = _max_diff(f32_m, f32["plain"])
    limit32 = max(TOL[torch.float32] * scale32, 4 * noise)
    bf16_err = _max_diff(b16["plain"], f32["plain"])
    out = []
    for pp in (2, 4):
        row = {"pp": pp, "n_micro": 4, "tokens": [4, 512],
               "f32_max_abs_diff": _max_diff(f32[pp], f32["plain"]),
               "f32_limit": limit32, "f32_m_noise": noise,
               "f32_max_abs_logit": scale32,
               "bf16_max_abs_diff": _max_diff(b16[pp], b16["plain"]),
               "bf16_err_vs_f32": bf16_err, "bf16_limit": 2 * bf16_err,
               "wall_s": {"bf16": b16[f"wall_{pp}"],
                          "f32": f32[f"wall_{pp}"]}}
        log(f"pp llama-3-8b pp {pp} x 4 micro-batches: float32 max |diff| "
            f"{row['f32_max_abs_diff']:.4g} (limit {limit32:.4g}; max "
            f"|logit| {scale32:.4g}, M noise {noise:.4g}); bf16 max |diff| "
            f"{row['bf16_max_abs_diff']:.4g} (limit 2 x {bf16_err:.4g}); "
            f"walls {json.dumps(row['wall_s'])}")
        if not row["f32_max_abs_diff"] <= limit32:
            raise AssertionError(f"pp {pp}: float32 logits off by "
                                 f"{row['f32_max_abs_diff']:.4g}")
        if not row["bf16_max_abs_diff"] <= 2 * bf16_err:
            raise AssertionError(f"pp {pp}: bf16 logits off by "
                                 f"{row['bf16_max_abs_diff']:.4g}, over "
                                 f"twice the unsharded bf16 error")
        out.append(row)
    del b16, f32, f32_m
    gc.collect()
    torch.cuda.empty_cache()
    return out


# (f): the two processes' tiny engine.
MH_ENGINE = dict(page_size=8, num_pages=32, max_pages_per_seq=4,
                 max_batch_size=2, prefill_buckets=(16,))
MH_PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7]]


def _mh_tokens(mesh=None) -> list:
    """tiny-llama (float32, kernel backend, seeded weights) on this
    process's card: the greedy tokens of MH_PROMPTS."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    eng = InferenceEngine(cfgs.tiny_llama(), cfgs.EngineConfig(**MH_ENGINE),
                          seed=SEED, attn_backend="kernel", device="cuda",
                          mesh=mesh)
    out = eng.generate(MH_PROMPTS, max_new_tokens=6)
    eng.check_pool_clean()
    return out


def multihost_worker(coord: str, nproc: str, pid: str) -> int:
    """One process of (f): join through initialize(..., backend="gloo")
    (NCCL refuses two ranks on one card), build the dp 2 hybrid mesh over
    both processes' cuda:0, all_reduce a sum computed on the card, serve
    this process's dp row; prints one JSON line."""
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.parallel import multihost

    nproc, pid = int(nproc), int(pid)
    for _ in range(2):              # the second call is a no-op
        multihost.initialize(coord, nproc, pid, backend="gloo",
                             local_devices=["cuda:0"])
    mesh = multihost.build_hybrid_mesh(cfgs.ParallelConfig(dp=2),
                                       num_slices=2)
    role = multihost.process_local_engine_role(mesh)
    total = torch.ones(4, 4, device="cuda").sum().cpu()
    torch.distributed.all_reduce(total)
    (row, sub), = multihost.replica_meshes(mesh)
    tokens = _mh_tokens(sub)
    print(json.dumps({"pid": pid, "process_count": multihost.process_count(),
                      "global_devices": len(multihost.global_devices()),
                      "mesh_shape": mesh.shape, "all_reduce": float(total),
                      "replica_row": row,
                      "device": str(list(sub.devices.flat)[0]),
                      "tokens": tokens, "role": role}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def sp_multihost_phase() -> dict:
    """(f) Two processes on the card (multihost_worker): both see two
    global devices, the all_reduce gives 32, rank 0 alone hosts the
    frontend, each serves its own row, and their tokens equal each
    other's and a single-process run's."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         coord, "2", str(pid)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            if p.returncode != 0:
                raise AssertionError(f"multihost worker rc {p.returncode}: "
                                     f"{err.decode()[-2000:]}")
            outs.append(json.loads(out.decode().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    wall = time.perf_counter() - t0
    want = _mh_tokens()
    for rec in outs:
        if (rec["process_count"] != 2 or rec["global_devices"] != 2
                or rec["all_reduce"] != 32.0
                or rec["mesh_shape"] != {"dp": 2, "tp": 1, "sp": 1}
                or rec["role"]["local_devices_in_mesh"] != 1
                or rec["device"] != "cuda:0"):
            raise AssertionError(f"multihost worker saw {rec}")
    if {r["pid"]: r["role"]["hosts_frontend"] for r in outs} != {
            0: True, 1: False}:
        raise AssertionError(f"multihost roles {[r['role'] for r in outs]}")
    if sorted(r["replica_row"] for r in outs) != [0, 1]:
        raise AssertionError("the two processes did not serve both rows")
    if not outs[0]["tokens"] == outs[1]["tokens"] == want:
        raise AssertionError(f"multihost tokens {outs[0]['tokens']} / "
                             f"{outs[1]['tokens']} vs one process {want}")
    return {"processes": 2, "wall_s": wall, "all_reduce": 32.0,
            "tokens_equal": True, "roles": [r["role"] for r in outs]}


def sp_phase(card: str) -> dict:
    """Gates (a)-(f) of sequence parallelism, pipeline stages and several
    processes (the docstring's item 12)."""
    out, walls = {}, {}
    for name, fn in (("tiny", sp_tiny_phase), ("attention",
                                               sp_attention_cases)):
        t = time.perf_counter()
        out[name] = fn()
        walls[name] = time.perf_counter() - t
    for c in out["attention"]:
        log(f"sp attention {c['name']} [{c['dtype']}]: err "
            f"{c['max_abs_err']:.3g} ({c['err_over_scale']:.3g} of the "
            f"largest output) ms {c['ms']:.3f}; dense attention "
            f"{c['dense_ms']:.3f} ms; the prefill kernel on the fresh "
            f"prompt {c['prefill_kernel_ms']:.3f} ms "
            f"({c['prefill_kernel_path']} path)")
    out["lanes"] = []
    for label, quant, kv_quant, variant, tp, sp, attn, cut in SP_LANES:
        t = time.perf_counter()
        with (_depth_cut("llama-3-8b", cut) if cut
              else contextlib.nullcontext()):
            mp = sp_serve_phase(label, quant, kv_quant, variant, tp, sp,
                                attn, card)
        walls[label] = time.perf_counter() - t
        per = mp["decode_tok_s_per_request"]
        log(f"main path llama-3-8b [{label}] on {card}: {mp['layers']} "
            f"layers, {mp['requests']} requests of "
            f"{min(mp['prompt_tokens'])}-{max(mp['prompt_tokens'])} "
            f"tokens, TTFT p50 {mp['ttft_p50_s']:.3f}s max "
            f"{mp['ttft_max_s']:.3f}s; decode {min(per):.1f}-{max(per):.1f} "
            f"tok/s per request; peak allocated "
            f"{mp['max_memory_allocated'] / 1e9:.2f} GB; the 4096-token "
            f"prompt's prefill alone {json.dumps(mp['prefill_wall_4096_s'])}"
            f" s; prefill chunks by path {json.dumps(mp['prefill_paths'])}; "
            f"launches {json.dumps(mp['launches_by_variant'])}")
        out["lanes"].append(mp)
    for name, fn in (("pp", sp_pp_phase), ("multihost", sp_multihost_phase)):
        t = time.perf_counter()
        out[name] = fn()
        walls[name] = time.perf_counter() - t
    log(f"multihost: {json.dumps(out['multihost'])}")
    out["walls_s"] = walls
    return out


def log_ledger(label: str, prof: dict) -> None:
    """The step ledger's verdicts over a profiled window."""
    led = prof.get("ledger")
    if led is None:
        return
    kinds = {k: {f: v[f] for f in ("records", "verdict", "compute_frac",
                                   "hbm_frac", "host_frac")}
             for k, v in led["kinds"].items()}
    log(f"[{label}] step ledger over the profiled window: "
        f"{json.dumps(kinds)}; mfu {json.dumps(led['mfu'])}")


def log_new_path(mp: dict, card: str) -> None:
    per = mp["decode_tok_s_per_request"]
    log(f"main path llama-3-8b [{mp['label']}] on {card}: {mp['requests']} "
        f"requests, TTFT p50 {mp['ttft_p50_s']:.3f}s max "
        f"{mp['ttft_max_s']:.3f}s; decode {min(per):.1f}-{max(per):.1f} "
        f"tok/s per request, {mp['aggregate_tok_s']:.1f} aggregate; "
        f"launches {json.dumps(mp['launches_by_variant'])}; decode launches "
        f"by batch {json.dumps(mp['decode_launches_by_batch'])}")
    keys = ("sizing", "max_memory_allocated", "rung_peak", "rung_switches",
            "rung_calls", "rung_calls_32_concurrent", "mean_batch_occupancy",
            "mean_batch_occupancy_32_concurrent", "steps_32_concurrent",
            "hybrid_steps",
            "decode_pipeline_depth", "decode_call_s", "alone", "returning",
            "preemptions", "recompute_resumes", "swap_in_resumes",
            "preemptions_before_returning", "prefix_cache", "num_pages",
            "speculative", "speculative_plain_options",
            "speculative_32_concurrent", "plain_options_run", "options",
            "rung_calls_plain_options",
            "verify_rounds_by_width", "requests_differing_from_plain",
            "prefill_launches_by_len", "prefill_launches_by_path",
            "prefill_calls")
    log(f"[{mp['label']}] " + json.dumps(
        {k: mp[k] for k in keys if k in mp}))
    for name, ph in mp["engine_phases"].items():
        if ph["count"]:
            log(f"[{mp['label']}] phase {name}: {ph['count']} x, "
                f"{ph['sum_s']:.4f} s total")
    prof = mp.get("profile")
    if prof is not None and "by_class_ms" in prof:
        log(f"[{mp['label']}] profile ({prof['window_s']:.2f}s window): "
            f"device busy share {prof['device_busy_share']:.3f}; by class "
            f"(ms) {json.dumps(prof['by_class_ms'])}"
            + (f"; prefill kernel by caller "
               f"{json.dumps(prof['prefill_kernel_split'])}"
               if "prefill_kernel_split" in prof else ""))
        log_ledger(mp["label"], prof)
    elif prof is not None:
        log(f"[{mp['label']}] profile: not measured ({prof['error']})")


def log_family_path(mp: dict, card: str) -> None:
    log_main_path(mp, card)
    keys = ("max_memory_allocated", "boot_peak_bytes", "boot_s",
            "allocated_before_boot_bytes", "decode_launches_by_batch",
            "prefill_launches_by_len", "prefill_launches_by_path",
            "int8_to_bf16_share_of_busy",
            "past_the_table")
    log(f"[{mp['label']}] " + json.dumps(
        {k: mp[k] for k in keys if k in mp}))


def log_main_path(mp: dict, card: str) -> None:
    for name, ph in mp["engine_phases"].items():
        if ph["count"]:
            log(f"[{mp['label']}] phase {name}: {ph['count']} x, "
                f"{ph['sum_s']:.4f} s total")
    prof = mp["profile"]
    if "by_class_ms" in prof:
        log(f"[{mp['label']}] profile ({prof['window_s']:.2f}s window): "
            f"device busy share {prof['device_busy_share']:.3f}; by class "
            f"(ms) {json.dumps(prof['by_class_ms'])}")
        for k in prof["top_kernels"]:
            log(f"  {k['ms']:9.2f} ms x{k['count']:<6} {k['name']}")
        log_ledger(mp["label"], prof)
    else:
        log(f"[{mp['label']}] profile: not measured ({prof['error']})")
    log(f"main path {mp['model']} [{mp['label']}] on {card}: TTFT p50 "
        f"{mp['ttft_p50_s']:.3f}s max {mp['ttft_max_s']:.3f}s; decode "
        f"{min(mp['decode_tok_s_per_request']):.1f}-"
        f"{max(mp['decode_tok_s_per_request']):.1f} tok/s per request, "
        f"{mp['aggregate_tok_s']:.1f} aggregate over {mp['requests']} "
        f"requests; weights {mp['weight_bytes'] / 1e9:.2f} GB (read bound "
        f"{mp['weight_read_bound_ms_per_step']:.2f} ms/step); launches "
        f"{json.dumps(mp['launches_by_variant'])}")


def _path_totals(paths: list) -> dict:
    """Prefill launches by pool kind and kernel path, summed over
    ``paths`` (each main path's counts were set to 0 just before it)."""
    out: dict = {}
    for mp in paths:
        for k, n in mp.get("prefill_launches_by_path", {}).items():
            out[k] = out.get(k, 0) + n
    return dict(sorted(out.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multihost-worker"]:
        # One of the sp phase's two processes (sp_multihost_phase).
        return multihost_worker(*sys.argv[2:5])
    t_all = time.perf_counter()
    # The port comes first: without it (a directory holding this script
    # alone) the run fails before printing anything.
    from tpu_inference_torch.kernels import KERNEL_SOURCES, _build
    from tpu_inference_torch.kernels import build_kernels

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build_s = build_kernels()
    log(f"build: {json.dumps(build_s)} in {time.perf_counter() - t0:.1f}s")
    for name in KERNEL_SOURCES:
        with open(_build._lib_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    phase_s = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = phase_s.get(name, 0.0) + time.perf_counter() - t
        return out

    kernels = timed("kernels", kernel_phase)
    for kind in ("decode", "prefill", "gpt2", "verify"):
        for c in kernels[kind]:
            log(f"kernel {c['variant']} [{c['dtype']}]: err "
                f"{c['max_abs_err']:.3g} ({c['err_over_scale']:.3g} of the "
                f"largest output) ms {c['ms']:.4f} plain {c['plain_ms']:.4f} "
                f"library {c['library_ms']:.4f} bound {c['bound_ms']:.4f} "
                f"({c['bound_by']})"
                + (f" path {c['path']}" if "path" in c else "")
                + (f" (mma path {c['mma_path_ms']:.4f})"
                   if "mma_path_ms" in c else ""))
    for row in kernels["threshold"]:
        log(f"kernel threshold {row['kv']} B {row['B']} x S {row['S']} "
            f"({row['rows']} rows a lane): mma {row['mma_ms']:.4f} ms, "
            f"wgmma {row['wgmma_ms']:.4f} ms")
    n_edge, edge_err = timed("edge", edge_phase)
    log(f"kernel edge cases: {n_edge} shapes within tolerance of their "
        f"plain versions (max abs err, and over the largest output: "
        f"{json.dumps(edge_err)})")
    rung_identity = timed("rung_identity", rung_identity_phase)
    log(f"decode kernel rung identity: a lane's row bit-identical at batch "
        f"8, 16 and 32 and in reversed order ({json.dumps(rung_identity)})")
    gemm_evidence = timed("gemm_evidence", gemm_rung_evidence)
    log(f"library GEMM rows vs batch width (evidence, not a gate; max abs "
        f"diff of rows 0-7 from M 8): {json.dumps(gemm_evidence)}")
    engines = (timed("engine", engine_phase, ENGINE_CASES)
               + timed("families", engine_phase, FAMILY_CASES))
    spec_engines = timed("spec", spec_engine_phase)
    chaos = timed("chaos", chaos_phase)
    log(f"chaos: failures fail their requests, health "
        f"{' -> '.join(chaos['health_states'])}, tokens after recovery "
        f"identical, watchdog fired, page pressure returned, pool clean: "
        f"{json.dumps(chaos)}")
    main_paths = {}
    mp = timed("fleet_tiny", fleet_tiny_phase, card)
    main_paths[mp["label"]] = mp
    for label, quant, kv_quant, variant in MAIN_PATHS:
        # The quantized paths run CUT_LAYERS of llama-3-8b's layers.
        with (_depth_cut("llama-3-8b", CUT_LAYERS) if variant != "bf16"
              else contextlib.nullcontext()):
            mp = timed("main", main_path_phase, label, quant, kv_quant,
                       variant, variant != "int4",
                       after=(observability_phase if label == "bf16"
                              else None))
        log_main_path(mp, card)
        main_paths[label] = mp
    for name, phase in (("reference", reference_config_phase),
                        ("pressure", pressure_phase)):
        with _depth_cut("llama-3-8b", CUT_LAYERS):
            mp = timed(name, phase, card)
        log_new_path(mp, card)
        main_paths[mp["label"]] = mp
    with _depth_cut("llama-3-8b", CUT_LAYERS):
        mp = timed("ngram", ngram_phase, card,
                   main_paths["reference chip config"])
    log_new_path(mp, card)
    main_paths[mp["label"]] = mp
    mp = timed("draft", draft_phase, card)
    log_new_path(mp, card)
    main_paths[mp["label"]] = mp
    pd_identity = timed("pd_identity", pd_identity_phase, card)
    # The fleet, pd and elastic lanes and the fabric lane's relay arm run
    # CUT_LAYERS of llama-3-8b's layers (the elastic lane's TTFT target is
    # a quarter of the fleet lane's p50, so both are cut alike); the
    # fabric lane's shm arm runs all 32.
    with _depth_cut("llama-3-8b", CUT_LAYERS):
        fleet = timed("fleet", fleet_phase, card, main_paths["bf16"])
        main_paths[fleet["label"]] = fleet
        mp = timed("pd", pd_phase, card, fleet)
        main_paths[mp["label"]] = mp
        mp = timed("elastic", elastic_phase, card, fleet)
        main_paths[mp["label"]] = mp
        mp = timed("fabric", fabric_phase, card, "relay")
        main_paths[mp["label"]] = mp
    # The fabric lane's shm arm too, since the tp lanes joined (the
    # script must stay inside its time limit).
    with _depth_cut("llama-3-8b", CUT_LAYERS):
        mp = timed("fabric_shm", fabric_phase, card, "shm")
    main_paths[mp["label"]] = mp
    # Mixtral runs CUT_LAYERS of its 32 layers.
    for name, phase, cut in (("mixtral", mixtral_phase, "mixtral-8x7b"),
                             ("gpt2", gpt2_phase, None)):
        with (_depth_cut(cut, CUT_LAYERS) if cut
              else contextlib.nullcontext()):
            mp = timed(name, phase, card)
        log_family_path(mp, card)
        main_paths[mp["label"]] = mp
    checkpoint = timed("checkpoint", checkpoint_phase, card)
    log(f"checkpoint lane: {json.dumps(checkpoint)}")
    tp = timed("tp", tp_phase, card)
    for mp in tp["lanes"]:
        main_paths[mp["label"]] = mp
    sp = timed("sp", sp_phase, card)
    for mp in sp["lanes"]:
        main_paths[mp["label"]] = mp

    entries = []
    for kind, name, src, replaces in (
            ("decode", "paged_attention",
             "tpu_inference_torch/csrc/paged_attention.cu",
             "tpu_inference/kernels/paged_attention.py:46"),
            ("prefill", "prefill_attention",
             "tpu_inference_torch/csrc/prefill_attention.cu",
             "tpu_inference/kernels/prefill_attention.py:46")):
        for variant, kv in (("bf16", "none"), ("int8", "int8"),
                            ("int4", "int4")):
            # Launches of this variant over every main path that runs it
            # (each path's counts were set to 0 just before it).
            paths = [mp for mp in main_paths.values()
                     if mp["variant"] == variant]
            launched = sum(mp["launches_by_variant"][name][variant]
                           for mp in paths)
            cases = [c for c in kernels[kind]
                     if c["kv"] == kv and c["dtype"] == "bfloat16"
                     and "swa" not in c["variant"]
                     and "mixed" not in c["variant"]]
            # The headline (batch 8 or the first prefill case), then for
            # the decode kernel the ladder's other rungs.
            for head in (cases if kind == "decode" else cases[:1]):
                b = head["shape"]["B"]
                suffix = f"_bs{b}" if kind == "decode" and b != 8 else ""
                entries.append({
                    "name": (name if variant == "bf16"
                             else f"{name}_{variant}") + suffix,
                    "route": "cuda", "source": src, "replaces": replaces,
                    "launches": launched,
                    "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                    "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"], "library": LIBRARY_NOTE,
                    "variant": head["variant"], "pool": variant,
                    "main_paths": [mp["label"] for mp in paths],
                    **({"path": head["path"],
                        "launches_by_path": _path_totals(paths)}
                       if kind == "prefill" else {}),
                    **({"launches_at_this_batch": sum(
                        int(mp.get("decode_launches_by_batch", {}).get(
                            str(b), 0)) for mp in paths)}
                       if kind == "decode" else {})})
            if kind == "decode":
                continue
            for head in (c for c in kernels["verify"]
                         if c["kv"] == kv and c["dtype"] == "bfloat16"):
                b, s_len = head["shape"]["B"], head["shape"]["S"]
                entries.append({
                    "name": (name if variant == "bf16"
                             else f"{name}_{variant}")
                    + f"_verify_bs{b}_s{s_len}",
                    "route": "cuda", "source": src, "replaces": replaces,
                    "launches": launched,
                    "launches_at_this_len": sum(
                        int(mp.get("prefill_launches_by_len", {}).get(
                            str(s_len), 0)) for mp in paths),
                    "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                    "plain_ms": head["plain_ms"],
                    "bound_ms": head["bound_ms"],
                    "bound_by": head["bound_by"],
                    "library_ms": head["library_ms"], "library": LIBRARY_NOTE,
                    "variant": head["variant"], "pool": variant,
                    "main_paths": [mp["label"] for mp in paths],
                    "path": head["path"],
                    "launches_by_path": _path_totals(paths)})
    # The head-sharded cases (tp_phase (a)): "launches" as the full-head
    # rows' (the variant over every main path), "launches_at_these_heads"
    # over the tp and sp lanes that ran the variant.
    for kind, name, src, replaces in (
            ("decode", "paged_attention",
             "tpu_inference_torch/csrc/paged_attention.cu",
             "tpu_inference/kernels/paged_attention.py:46"),
            ("prefill", "prefill_attention",
             "tpu_inference_torch/csrc/prefill_attention.cu",
             "tpu_inference/kernels/prefill_attention.py:46")):
        for head in tp["kernels"][kind]:
            variant = {"none": "bf16"}.get(head["kv"], head["kv"])
            paths = [mp for mp in main_paths.values()
                     if mp["variant"] == variant]
            sh = head["shape"]
            at = f"{sh['Hq']}/{sh['Hkv']}"
            entries.append({
                "name": (name if variant == "bf16" else f"{name}_{variant}")
                + f"_tp{head['tp']}",
                "route": "cuda", "source": src, "replaces": replaces,
                "launches": sum(mp["launches_by_variant"][name][variant]
                                for mp in paths),
                "launches_at_these_heads": sum(
                    mp["launches_by_heads"][name].get(at, 0)
                    for mp in tp["lanes"] + sp["lanes"]
                    if mp["variant"] == variant),
                "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "library": LIBRARY_NOTE,
                "variant": head["variant"], "pool": variant,
                "heads": at, "main_paths": [mp["label"] for mp in paths],
                **({"path": head["path"]} if "path" in head else {})})
    gpt2_paths = [mp for mp in main_paths.values() if mp["model"] == "gpt2"]
    for head, name, src, replaces in zip(
            kernels["gpt2"], ("paged_attention", "prefill_attention"),
            ("tpu_inference_torch/csrc/paged_attention.cu",
             "tpu_inference_torch/csrc/prefill_attention.cu"),
            ("tpu_inference/kernels/paged_attention.py:46",
             "tpu_inference/kernels/prefill_attention.py:46")):
        entries.append({
            "name": f"{name}_gpt2", "route": "cuda", "source": src,
            "replaces": replaces,
            # The bf16 variant's launches on the gpt2 lane alone.
            "launches": sum(mp["launches_by_variant"][name]["bf16"]
                            for mp in gpt2_paths),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library": LIBRARY_NOTE, "variant": head["variant"],
            "pool": "bf16", "main_paths": [mp["label"] for mp in gpt2_paths],
            **({"path": head["path"],
                "launches_by_path": _path_totals(gpt2_paths)}
               if "path" in head else {})})
    report = {"card": card, "torch": torch.__version__,
              "kernels": entries, "kernel_cases": kernels,
              "main_paths": main_paths, "checkpoint": checkpoint,
              "pd_identity": pd_identity, "phase_s": phase_s,
              "tp": {k: v for k, v in tp.items() if k != "lanes"},
              "sp": {k: v for k, v in sp.items() if k != "lanes"},
              "engine_cases": engines, "spec_engine_cases": spec_engines,
              "chaos": chaos, "rung_identity": rung_identity,
              "gemm_rung_evidence": gemm_evidence,
              "edge": {"checked": n_edge,
                                                "max_abs_err_and_over_scale":
                                                edge_err},
              "build_s": build_s,
              "total_s": time.perf_counter() - t_all}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"main_paths": {
        v: {k: x for k, x in mp.items()
            if k not in ("ttft_s", "profile", "generated")}
        for v, mp in main_paths.items()}, "card": card}))
    log(f"total_s {report['total_s']:.1f}; by phase "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
