#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
failing loudly (any failure exits non-zero before the result line):

1. device: require CUDA; print the card's name and power limit.
2. build: compile every kernel of the serving path from
   tpu_inference_torch/csrc/ with nvcc (in parallel), print build times.
3. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shapes (Llama-3-8B: Hq 32, Hkv 8, D 128, page 16,
   bf16, batch 8; a sliding-window case; a float32 case), with the
   kernel's time, the plain version's time, one PyTorch library call's
   time (scaled_dot_product_attention over the pre-gathered KV) and the
   roofline bound of the card for the same work; then a correctness
   sweep over shapes off the main path (edge_phase).
4. engine: tiny-llama and tiny-mistral (float32) on the card, greedy
   tokens of the "kernel" backend identical to the "dense" backend.
5. main path: the Ollama server in-process with llama-3-8b at full width
   (32 layers, bf16, random weights from a seed, byte tokenizer),
   concurrent streamed /api/generate requests over localhost (one long
   enough to prefill in chunks); every request must finish normally
   (done_reason "length" with all its tokens, or "stop"), the server
   must count no failed dispatch, and both kernels' launch counts must
   rise.

Then it prints one JSON line {"kernels": [...]}, the card line, and as
the last line {"ok": true, "device": {...}}. A copy of every number goes
to build/chip_smoke.json.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
SEED = 0


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
    buffer is given (the serving path reads each layer's pool cold)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(q, k, v, mask):
    """One library call computing the same attention:
    scaled_dot_product_attention in its GQA mode over KV gathered
    beforehand (the gather is not timed). q [B, Hq, Sq, D], k/v
    [B, Hkv, T, D]."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)


def paged_pool(gen, b, mp, pg, hkv, d, dtype):
    num_pages = b * mp + 1
    shape = (num_pages, pg, hkv, d)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda") + 1
    bt = perm[:b * mp].reshape(b, mp).to(torch.int32).contiguous()
    return k, v, bt


def gathered(k_pages, v_pages, bt):
    b, mp = bt.shape
    _, pg, hkv, d = k_pages.shape
    k = k_pages[bt.long()].reshape(b, mp * pg, hkv, d).transpose(1, 2)
    v = v_pages[bt.long()].reshape(b, mp * pg, hkv, d).transpose(1, 2)
    return k.contiguous(), v.contiguous()


def check_close(name, got, want, dtype) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    if not torch.isfinite(got.float()).all() or (err > tol).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err.max().item():.3g},"
                             f" tolerance {tol} abs)")
    return err.max().item()


def decode_case(name, b, kv_lens, window, dtype, flush, gen):
    from tpu_inference_torch.kernels import paged_attention as pa
    hq, hkv, d, pg = 32, 8, 128, 16
    mp = max(-(-n // pg) for n in kv_lens)
    k_pages, v_pages, bt = paged_pool(gen, b, mp, pg, hkv, d, dtype)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, bt, kv_len)
    got = pa.paged_attention(*args, sliding_window=window)
    want = pa.paged_attention_plain(*args, sliding_window=window)
    torch.cuda.synchronize()
    err = check_close(name, got, want, dtype)
    kg, vg = gathered(k_pages, v_pages, bt)
    pos = torch.arange(mp * pg, device="cuda")[None, :]
    valid = pos < kv_len[:, None]
    if window:
        valid &= pos >= kv_len[:, None] - window
    mask = valid[:, None, None, :]
    lib = library_call(q[:, :, None, :], kg, vg, mask)
    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    attended = sum(min(n, window) if window else n for n in kv_lens)
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem + 2 * attended * hkv * d * elem
              + bt.numel() * 4 + b * 4)
    flops = 4.0 * attended * hq * d
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "variant": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"B": b, "Hq": hq, "Hkv": hkv, "D": d, "page": pg,
                  "kv_len": kv_lens, "sliding_window": window},
        "max_abs_err": err, "tolerance": TOL[dtype],
        "ms": time_ms(lambda: pa.paged_attention(*args,
                                                 sliding_window=window),
                      flush=flush),
        "plain_ms": time_ms(lambda: pa.paged_attention_plain(
            *args, sliding_window=window), iters=5, flush=flush),
        "library_ms": time_ms(lib, flush=flush), "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def prefill_case(name, s, q_offsets, kv_lens, window, dtype, flush, gen):
    from tpu_inference_torch.kernels import prefill_attention as pfa
    hq, hkv, d, pg = 32, 8, 128, 16
    b = len(kv_lens)
    mp = max(-(-n // pg) for n in kv_lens)
    k_pages, v_pages, bt = paged_pool(gen, b, mp, pg, hkv, d, dtype)
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    q_off = torch.tensor(q_offsets, dtype=torch.int32, device="cuda")
    args = (q, k_pages, v_pages, bt, kv_len, q_off)
    got = pfa.paged_prefill_attention(*args, sliding_window=window)
    want = pfa.paged_prefill_attention_plain(*args, sliding_window=window)
    torch.cuda.synchronize()
    err = check_close(name, got, want, dtype)
    kg, vg = gathered(k_pages, v_pages, bt)
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
    nbytes = (2 * q.numel() * elem + 2 * keys * hkv * d * elem
              + bt.numel() * 4 + 2 * b * 4)
    flops = 4.0 * pairs * hq * d
    b_ms, b_by = bound(nbytes, flops, dtype)
    return {
        "variant": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "page": pg,
                  "q_offset": q_offsets, "kv_len": kv_lens,
                  "sliding_window": window},
        "max_abs_err": err, "tolerance": TOL[dtype],
        "ms": time_ms(lambda: pfa.paged_prefill_attention(
            *args, sliding_window=window), flush=flush),
        "plain_ms": time_ms(lambda: pfa.paged_prefill_attention_plain(
            *args, sliding_window=window), iters=3, flush=flush),
        "library_ms": time_ms(lib, flush=flush), "library_max_abs_err": lib_err,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def kernel_phase() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    decode = [
        decode_case("decode bs8 ctx1024", 8, [1024] * 8, 0, bf16, flush, gen),
        decode_case("decode bs8 mixed ctx", 8,
                    [1, 17, 128, 333, 512, 700, 1000, 1500], 0, bf16, flush,
                    gen),
        decode_case("decode bs8 ctx2048 swa256", 8, [2048] * 8, 256, bf16,
                    flush, gen),
        decode_case("decode bs8 mixed ctx f32", 8,
                    [1, 40, 300, 1024, 7, 64, 65, 999], 0, f32, flush, gen),
        decode_case("decode bs8 ctx1024 f32", 8, [1024] * 8, 0, f32, flush,
                    gen),
    ]
    prefill = [
        prefill_case("prefill 4 lanes x 512 fresh", 512, [0, 0, 0, 0],
                     [512, 300, 450, 129], 0, bf16, flush, gen),
        prefill_case("prefill chunk 512 at offset 1024", 512, [1024],
                     [1500], 0, bf16, flush, gen),
        prefill_case("prefill 1024 fresh swa256", 1024, [0], [1024], 256,
                     bf16, flush, gen),
        prefill_case("prefill 2 lanes x 200 f32 cached prefix", 200, [37, 0],
                     [237, 150], 0, f32, flush, gen),
        prefill_case("prefill chunk 512 at offset 1024 f32", 512, [1024],
                     [1500], 0, f32, flush, gen),
    ]
    del flush
    return {"decode": decode, "prefill": prefill}


def edge_phase() -> tuple:
    """Both kernels against their plain versions (correctness only) over
    shapes off the main path: MHA to n_rep 8, head_dim 48 to 256, pages
    of 8 to 32 tokens, one-token contexts, page-boundary lengths, ragged
    query tiles, cached-prefix offsets and sliding windows. Returns the
    number of shapes checked and the largest error by dtype."""
    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    checked = 0
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    shapes = [(8, 8, 64, 8), (16, 2, 128, 32), (4, 4, 256, 16),
              (4, 2, 48, 8)]
    for dtype in (torch.bfloat16, torch.float32):
        for hq, hkv, d, pg in shapes:
            for window in (0, 3 * pg // 2):
                kv_lens = [1, pg, pg + 1, 5 * pg - 1, 7 * pg]
                b, mp = len(kv_lens), 7
                k, v, bt = paged_pool(gen, b, mp, pg, hkv, d, dtype)
                q = torch.randn((b, hq, d), generator=gen,
                                device="cuda").to(dtype)
                kl = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
                name = f"edge decode {hq}/{hkv}x{d} pg{pg} w{window}"
                worst[dtype] = max(worst[dtype], check_close(
                    name, pa.paged_attention(
                        q, k, v, bt, kl, sliding_window=window),
                    pa.paged_attention_plain(q, k, v, bt, kl,
                                             sliding_window=window), dtype))
                for s_len, offs, prompts in ((1, [0, 9], [1, 1]),
                                             (13, [0, 2 * pg + 3], [13, 7]),
                                             (100, [0, pg], [100, 77])):
                    kv = [o + n for o, n in zip(offs, prompts)]
                    mp = max(-(-n // pg) for n in kv)
                    k, v, bt = paged_pool(gen, 2, mp, pg, hkv, d, dtype)
                    q = torch.randn((2, s_len, hq, d), generator=gen,
                                    device="cuda").to(dtype)
                    args = (q, k, v, bt,
                            torch.tensor(kv, dtype=torch.int32,
                                         device="cuda"),
                            torch.tensor(offs, dtype=torch.int32,
                                         device="cuda"))
                    name = (f"edge prefill {hq}/{hkv}x{d} pg{pg} S{s_len} "
                            f"w{window}")
                    worst[dtype] = max(worst[dtype], check_close(
                        name, pfa.paged_prefill_attention(
                            *args, sliding_window=window),
                        pfa.paged_prefill_attention_plain(
                            *args, sliding_window=window), dtype))
                    checked += 1
                checked += 1
    torch.cuda.synchronize()
    return checked, {str(k).replace("torch.", ""): v
                     for k, v in worst.items()}


def engine_phase() -> None:
    import numpy as np
    from tpu_inference_torch import config as cfgs
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.models.registry import build_model

    ecfg = cfgs.EngineConfig(page_size=8, num_pages=64, max_pages_per_seq=16,
                             max_batch_size=4, prefill_buckets=(16, 32),
                             decode_steps_per_call=4)
    for preset in (cfgs.tiny_llama, cfgs.tiny_mistral):
        mcfg = preset(vocab_size=256)
        params, _ = build_model(mcfg, seed=SEED, device="cuda")
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, 256, size=n).tolist()
                   for n in (5, 12, 27, 70)]
        out = {}
        for backend in ("dense", "kernel"):
            eng = InferenceEngine(mcfg, ecfg, params=params,
                                  attn_backend=backend, device="cuda")
            out[backend] = eng.generate(prompts, max_new_tokens=12)
        if out["dense"] != out["kernel"]:
            raise AssertionError(f"{mcfg.name}: kernel backend tokens differ "
                                 f"from dense: {out}")
        log(f"engine {mcfg.name}: kernel backend greedy-identical to dense "
            f"({sum(len(t) for t in out['kernel'])} tokens)")


def _stream_request(port: int, prompt: str, max_tokens: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/api/generate", json.dumps({
            "model": "llama-3-8b", "prompt": prompt, "temperature": 0.0,
            "max_tokens": max_tokens, "stream": True}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        t_headers = time.perf_counter()   # headers wait for the 1st token
        if resp.status != 200:
            raise AssertionError(f"HTTP {resp.status}: {resp.read()[:500]}")
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
            "done_reason": final["done_reason"], "context": ctx}


def run_requests(port: int, prompts: list, max_tokens: int) -> tuple:
    """All prompts as concurrent streamed requests; (results, wall s)."""
    results: list = [None] * len(prompts)
    errors: list = []

    def worker(i: int) -> None:
        try:
            results[i] = _stream_request(port, prompts[i], max_tokens)
        except Exception as e:   # noqa: BLE001 — re-raised below
            errors.append(e)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
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
    return "other"


def profile_requests(port: int, prompts: list, max_tokens: int) -> dict:
    """The same concurrent requests again, under torch.profiler: device
    time by kernel and by class, and the device's busy share of the
    window. A profiler that cannot trace here is reported, not fatal; a
    failed request is."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"error": repr(e)}
    try:
        t0 = time.perf_counter()
        run_requests(port, prompts, max_tokens)
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
    busy = sum(ms for _, ms, _ in kernels)
    by_class: dict = {}
    for name, ms, _ in kernels:
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
    kernels.sort(key=lambda k: -k[1])
    return {"window_s": wall, "device_busy_ms": busy,
            "device_busy_share": busy / (wall * 1e3),
            "by_class_ms": by_class,
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                            for n, ms, c in kernels[:12]]}


def main_path_phase() -> dict:
    import random

    from tpu_inference_torch.kernels import paged_attention as pa
    from tpu_inference_torch.kernels import prefill_attention as pfa
    from tpu_inference_torch.server.http import build_server

    t0 = time.perf_counter()
    server = build_server("llama-3-8b", device="cuda", seed=SEED,
                          max_pages_per_seq=128, num_pages=512,
                          max_batch_size=8)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    try:
        port = server.start(port=0)
        rng = random.Random(SEED)
        words = ["tensor", "page", "kernel", "hopper", "token", "cache",
                 "stream", "batch", "warp", "prefill", "decode", "softmax"]

        def text(n_bytes: int) -> str:
            out = ""
            while len(out) < n_bytes:
                out += rng.choice(words) + " "
            return out[:n_bytes]

        # Byte tokenizer: n bytes -> n + 1 tokens (BOS). Spread over the
        # buckets; 1500 > the 1024 bucket, so it prefills in two chunks.
        lengths = [40, 100, 200, 400, 900, 1500]
        prompts = [text(n) for n in lengths]
        max_tokens = 48
        pa.launches = 0
        pfa.launches = 0
        results, wall = run_requests(port, prompts, max_tokens)
        launches = {"paged_attention": pa.launches,
                    "prefill_attention": pfa.launches}
        if launches["paged_attention"] <= 0 or \
                launches["prefill_attention"] <= 0:
            raise AssertionError(f"main path skipped a kernel: {launches}")
        phases = engine_phases(server_stats(port))
        # Greedy determinism: the shortest prompt again, alone.
        again = _stream_request(port, prompts[0], max_tokens)
        if again["context"] != results[0]["context"]:
            raise AssertionError("greedy output not reproducible")
        profile = profile_requests(port, prompts, max_tokens)
        server_stats(port)
        n_layers = server.engine.model_cfg.n_layers
        weight_bytes = server.engine.weight_bytes
    finally:
        server.shutdown()
    ttfts = sorted(r["ttft_s"] for r in results)
    total_eval = sum(r["eval_count"] for r in results)
    per_req = [r["eval_count"] / r["eval_duration_s"] for r in results
               if r["eval_duration_s"] > 0]
    return {
        "model": "llama-3-8b", "layers": n_layers, "dtype": "bfloat16",
        "boot_s": boot_s, "requests": len(results),
        "prompt_tokens": [r["prompt_tokens"] for r in results],
        "max_tokens": max_tokens,
        "ttft_s": [r["ttft_s"] for r in results],
        "ttft_p50_s": ttfts[len(ttfts) // 2], "ttft_max_s": ttfts[-1],
        "decode_tok_s_per_request": per_req,
        "aggregate_tok_s": total_eval / wall, "wall_s": wall,
        "eval_tokens": total_eval, "launches": launches,
        "launches_per_forward": n_layers,
        "done_reasons": [r["done_reason"] for r in results],
        "weight_bytes": weight_bytes,
        "weight_read_bound_ms_per_step": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "decode_ms_per_token_per_request": [1e3 / x for x in per_req],
        "engine_phases": phases,
        "profile": profile,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
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

    kernels = kernel_phase()
    for kind in ("decode", "prefill"):
        for c in kernels[kind]:
            log(f"kernel {c['variant']} [{c['dtype']}]: err "
                f"{c['max_abs_err']:.3g} ms {c['ms']:.4f} plain "
                f"{c['plain_ms']:.4f} library {c['library_ms']:.4f} bound "
                f"{c['bound_ms']:.4f} ({c['bound_by']})")
    n_edge, edge_err = edge_phase()
    log(f"kernel edge cases: {n_edge} shapes within tolerance of their "
        f"plain versions (max abs err {json.dumps(edge_err)})")
    engine_phase()
    main_path = main_path_phase()
    for name, ph in main_path["engine_phases"].items():
        if ph["count"]:
            log(f"phase {name}: {ph['count']} x, {ph['sum_s']:.4f} s total")
    prof = main_path["profile"]
    if "by_class_ms" in prof:
        log(f"profile ({prof['window_s']:.2f}s window): device busy share "
            f"{prof['device_busy_share']:.3f}; by class (ms) "
            f"{json.dumps(prof['by_class_ms'])}")
        for k in prof["top_kernels"]:
            log(f"  {k['ms']:9.2f} ms x{k['count']:<6} {k['name']}")
    else:
        log(f"profile: not measured ({prof['error']})")
    log(f"main path llama-3-8b on {card}: TTFT p50 "
        f"{main_path['ttft_p50_s']:.3f}s max {main_path['ttft_max_s']:.3f}s;"
        f" aggregate decode {main_path['aggregate_tok_s']:.1f} tok/s over "
        f"{main_path['requests']} requests; launches "
        f"{json.dumps(main_path['launches'])}")

    entries = []
    for kind, name, src, replaces in (
            ("decode", "paged_attention",
             "tpu_inference_torch/csrc/paged_attention.cu",
             "tpu_inference/kernels/paged_attention.py:46"),
            ("prefill", "prefill_attention",
             "tpu_inference_torch/csrc/prefill_attention.cu",
             "tpu_inference/kernels/prefill_attention.py:46")):
        head = kernels[kind][0]
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_path["launches"][name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "variant": head["variant"], "cases": kernels[kind]})
    report = {"card": card, "torch": torch.__version__,
              "kernels": entries, "main_path": main_path,
              "build_s": build_s,
              "total_s": time.perf_counter() - t_all}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"main_path": {k: v for k, v in main_path.items()
                                  if k != "ttft_s"}, "card": card}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
