"""Run one cell of the benchmark and print its result line.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Set-up (weights made on the card from the
seed, kernels built or loaded, the server's warm-up of every shape, the
traffic's ramp) runs from process start to the window's opening; then
the load generator's requests are measured for ``--seconds``. With
``--trace 1`` a slice of the window is profiled and the cell's per-layer
metrics are reported instead of its end-to-end ones. Once the window
has closed and the port's state is freed, a sample of the finished
requests goes through the plain reference (reference/check.py), which
decides ``correct``. The last line of standard output is one JSON
object; the last lines of standard error name each number compared and
its limit.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_inference")
# A closed loop's window opens once, over FULL_POLLS polls FULL_POLL_S
# apart, the decode calls between polls have surfaced FULL_SHARE of a
# full batch's tokens.
FULL_POLL_S = 1.0
FULL_POLLS = 2
FULL_SHARE = 0.9
MAX_RAMP_S = 240.0
UNREAD = 1e9          # an end-to-end metric's value where it has none
LOADGEN_WAIT_S = 120.0
# The profiled slice of a --trace 1 run: SLICE_S seconds from SLICE_AT
# of the window. Tracing slows the port's host loop several times over,
# so what the host clock and the port's counters read comes from the
# window before the slice.
SLICE_S = 4.0
SLICE_AT = 0.6
# Fixed cache directories inside the checkout, for anything the port or
# PyTorch would compile (the port's own kernels build into build/kernels).
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def log(msg: str) -> None:
    print(f"[h100bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, a
    JAX library's or the JAX package's (compared whole)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _start_loadgen(plan: dict, port: int, t0: float) -> subprocess.Popen:
    child = subprocess.Popen(
        [sys.executable, "-m", "h100bench.loadgen"], cwd=ROOT,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    child.stdin.write(json.dumps({"plan": plan, "port": port, "t0": t0})
                      + "\n")
    child.stdin.flush()
    return child


def _stop_loadgen(child: subprocess.Popen) -> list:
    try:
        out, _ = child.communicate("stop\n", timeout=LOADGEN_WAIT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return json.loads(out.strip().splitlines()[-1])["requests"]


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


def _open_window(cell, served, plan: dict, t0: float) -> float:
    """The window's opening: an open loop's ``window_start``; a closed
    loop's first moment, after ``ramp_s``, at which the decode calls of
    FULL_POLLS polls in a row each surfaced FULL_SHARE of a full batch's
    tokens (the port's tpu_inf_tokens_per_dispatch)."""
    from h100bench.readers import parse_prometheus

    if plan["loop"] == "open":
        w0 = t0 + plan["window_start"]
        _sleep_until(w0)
        return w0
    _sleep_until(t0 + float(cell.traffic["ramp_s"]))
    ecfg = served.engine_cfg
    full_call = FULL_SHARE * ecfg.max_batch_size * ecfg.decode_steps_per_call
    name = "tpu_inf_tokens_per_dispatch"
    last, full = parse_prometheus(served.scrape()), 0
    while full < FULL_POLLS:
        if time.monotonic() - t0 > MAX_RAMP_S:
            raise RuntimeError(f"the decode batch never filled in "
                               f"{MAX_RAMP_S} s")
        time.sleep(FULL_POLL_S)
        now = parse_prometheus(served.scrape())
        calls = now[f"{name}_count"] - last.get(f"{name}_count", 0.0)
        tokens = now[f"{name}_sum"] - last.get(f"{name}_sum", 0.0)
        full = full + 1 if calls and tokens / calls >= full_call else 0
        last = now
    return time.monotonic()


def setup(cell, seed: int, device: str) -> tuple:
    """(shape, params, served server, set-up split): the weights made
    from the seed and the port's server built on them and warmed up."""
    import torch

    from h100bench import port as port_mod
    from h100bench import spec, weights

    shape = spec.model_shape(cell.config)
    t = time.monotonic()
    params = weights.port_params(shape, seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    split = {"weights_s": time.monotonic() - t}
    t = time.monotonic()
    served = port_mod.serve(cell.config, params, seed, device)
    split["build_and_warmup_s"] = time.monotonic() - t
    from tpu_inference_torch.kernels import _build
    split["kernel_build_s"] = dict(_build.build_seconds)
    ecfg = served.engine_cfg
    log(f"engine: max_batch_size {ecfg.max_batch_size}, num_pages "
        f"{ecfg.num_pages}, ladder {list(ecfg.decode_ladder)}, "
        f"max_context {ecfg.max_context}")
    return shape, params, served, split


def drive(cell, served, plan: dict, seconds: float, trace: bool) -> dict:
    """Run the load generator on ``plan``, measure the window (and with
    ``trace`` profile a slice of it), stop the generator. The log, the
    window, the slice and the port's counters at both ends."""
    from h100bench import readers
    from h100bench import trace as tr

    child = None
    try:
        t0 = time.monotonic() + 0.2
        child = _start_loadgen(plan, served.port, t0)
        w0 = _open_window(cell, served, plan, t0)
        before = readers.parse_prometheus(served.scrape())
        w1 = w0 + seconds
        prof = slice_ = clean = None
        if trace:
            # The port's counters and the mfu are read over [w0, s0),
            # before the tracing slows the host.
            s0 = w0 + SLICE_AT * seconds
            _sleep_until(s0)
            clean = readers.parse_prometheus(served.scrape())
            s0 = time.monotonic()
            prof, slice_s = tr.profile_slice(min(SLICE_S, 0.5 * seconds))
            slice_ = (s0, s0 + slice_s)
        _sleep_until(w1)
        after = readers.parse_prometheus(served.scrape())
        requests = _stop_loadgen(child)
        child = None
    finally:
        if child is not None:
            child.kill()
            child.wait()
    trace_out = (tr.reduce_profile(prof, slice_[1] - slice_[0])
                 if prof is not None else None)
    return {"log": requests, "window": (w0, w1), "slice": slice_,
            "clean": (w0, slice_[0]) if slice_ else (w0, w1),
            "counters": (before, clean or after),
            "window_counters": (before, after), "trace": trace_out,
            "ramp_s": w0 - t0, "plan": plan}


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            t_start: float = T_START) -> dict:
    """Set up, run the window, free the port's state. Returns what the
    judgement and the metrics read."""
    import torch

    from h100bench import traffic

    shape, params, served, split = setup(cell, seed, device)
    ecfg = served.engine_cfg
    try:
        plan = traffic.build_plan(cell.traffic, seed, seconds)
        log(f"plan: {plan['loop']} loop, {len(plan['requests'])} "
            f"requests, {plan['clipped']} prompts clipped to the context")
        raw = drive(cell, served, plan, seconds, trace)
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    finally:
        served.close()
    split["ramp_s"] = raw.pop("ramp_s")
    del served, params
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {**raw, "shape": shape,
            "engine": {"max_batch_size": ecfg.max_batch_size,
                       "decode_steps_per_call": ecfg.decode_steps_per_call},
            "memory_peak_bytes": peak,
            "setup_s": raw["window"][0] - t_start, "setup_split": split}


def finished(raw: dict) -> list:
    """Finished requests with their prompt's token ids (BOS, then one
    token per byte), as the reference reads them."""
    prompts = {r["id"]: r["prompt"] for r in raw["plan"]["requests"]}
    out = []
    for r in raw["log"]:
        if r["done"] and r.get("generated"):
            ids = [256] + list(prompts[r["id"]].encode("ascii"))
            out.append({"id": r["id"], "prompt_ids": ids,
                        "generated": r["generated"]})
    return out


def judge(cell, seed: int, raw: dict, device: str) -> tuple:
    """(correct, attempted, failed, checks): the cell's statistic of the
    logit gaps of a sample of finished requests against its limit, no
    failed request, and enough served tokens compared."""
    from h100bench import stats
    from h100bench.reference import check

    tr = cell.traffic
    w0, w1 = raw["window"]
    tried = stats.attempted(raw["log"], w0, w1, raw["plan"]["loop"])
    failed = sum(1 for r in tried if r["error"] is not None)
    sample = check.pick_sample(finished(raw), seed,
                               int(tr["sample_min_tokens"]),
                               int(tr["sample_max_requests"]))
    t = time.monotonic()
    ref = check.reference_gaps(raw["shape"], seed, sample, device)
    longest = max((len(s["prompt_ids"]) + len(s["generated"])
                   for s in sample), default=0)
    log(f"reference: {len(sample)} requests, {len(ref['gaps'])} served "
        f"tokens, longest {longest} tokens, {time.monotonic() - t:.1f} s; "
        f"gaps {json.dumps(ref['summary'])}")
    stat = tr["logit_gap_stat"]
    gap = ref["summary"].get(stat, float("inf"))
    checks = {
        f"logit_gap_{stat}": {"value": gap,
                              "limit": float(tr["logit_gap_limit"])},
        "failed_requests_max": {"value": failed, "limit": 0},
        "compared_tokens_min": {"value": len(ref["gaps"]),
                                "limit": int(tr["sample_min_tokens"])},
    }
    correct = (gap <= float(tr["logit_gap_limit"]) and failed == 0
               and len(ref["gaps"]) >= int(tr["sample_min_tokens"]))
    return correct, len(tried), failed, checks


def window_summary(raw: dict) -> dict:
    """What the window held, for the log: requests sent and finished,
    prompt and output tokens, and the port's decode calls."""
    from h100bench import readers, stats

    w0, w1 = raw["window"]
    log_ = raw["log"]
    ctx = {"counters": raw["window_counters"]}
    calls = readers.delta(ctx, "tpu_inf_tokens_per_dispatch_count") or 0
    toks = readers.delta(ctx, "tpu_inf_tokens_per_dispatch_sum") or 0
    return {
        "sent": sum(1 for r in log_ if w0 <= r.get("sent", -1) < w1),
        "first_tokens": sum(1 for r in log_
                            if r["tokens"] and w0 <= r["tokens"][0] < w1),
        "prompt_tokens_first": sum(
            r["prompt_tokens"] for r in log_
            if r["tokens"] and w0 <= r["tokens"][0] < w1),
        "tokens": sum(1 for r in log_ for t in r["tokens"] if w0 <= t < w1),
        "decode_calls": calls,
        "decode_tokens_per_call": toks / calls if calls else None,
        "prefill_dispatches": readers.delta(
            ctx, "tpu_inf_prefill_dispatches_total"),
        "ttft_p50_s": (stats.ttft_p50_s(log_, w0, w1)
                       if raw["plan"]["loop"] == "open" else None),
        "ttft_p90_s": (stats.ttft_p90_s(log_, w0, w1)
                       if raw["plan"]["loop"] == "open" else None),
        "tok_s_before_trace": _tok_s(log_, [raw["clean"]]),
        "tok_s_in_trace": (_tok_s(log_, [raw["slice"]]) if raw["slice"]
                           else None),
    }


def trace_slowdown(raw: dict) -> dict:
    """How far tracing slowed the port in a --trace 1 run: decode steps a
    second before the slice (the port's counters) and in it (the decode
    kernel's runs in the trace, one a layer a step), and their ratio."""
    from h100bench import readers

    a, b = raw["clean"]
    calls = readers.delta({"counters": raw["counters"]},
                          "tpu_inf_decode_dispatches_total") or 0.0
    before = calls * raw["engine"]["decode_steps_per_call"] / (b - a)
    steps = readers.decode_steps(raw, "paged_decode_kernel")
    inside = steps / raw["trace"]["window_s"]
    return {"decode_steps_per_s_before": before,
            "decode_steps_per_s_in": inside,
            "host_slowdown": before / inside if inside else None}


def _tok_s(log_: list, spans: list) -> float:
    n = sum(1 for r in log_ for t in r["tokens"]
            for a, b in spans if a <= t < b)
    return n / sum(b - a for a, b in spans)


def metrics(cell, raw: dict, trace: bool, kind: str) -> dict:
    from h100bench import peaks, spec, stats

    w0, w1 = raw["window"]
    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                value = raw["setup_s"]
            else:
                value = stats.E2E[m["name"]](raw["log"], w0, w1)
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    ctx = {**raw, "peak": peaks.PEAKS.get(kind)}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(args) -> int:
    from h100bench import spec, stats

    cell = spec.load_cell(args.workload, os.path.join(ROOT,
                                                      "BENCHMARK.json"))
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    kind = torch.cuda.get_device_name(0)
    raw = execute(cell, args.seed, float(args.seconds), bool(args.trace),
                  "cuda")
    log(f"set-up {raw['setup_s']:.3f} s: {json.dumps(raw['setup_split'])}")
    log(f"generator lateness (s): {json.dumps(stats.lateness(raw['log']))}")
    log(f"window: {json.dumps(window_summary(raw))}")
    vals = metrics(cell, raw, bool(args.trace), kind)
    correct, tried, failed, checks = judge(cell, args.seed, raw, "cuda")
    unread = [k for k, v in vals.items() if not math.isfinite(v["value"])]
    for k in unread:
        # A tail that fell on a request with no answer: no number to
        # give, and the run is not correct.
        log(f"{k} has no finite value: reported as {UNREAD}")
        vals[k]["value"] = UNREAD
        correct = False
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": raw["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": tried, "failed": failed,
              "metrics": vals, "device": device}
    if args.trace:
        t = raw["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
        # Beside every traced metric: the slice, and how far the tracing
        # slowed the host loop in it.
        result["slice"] = {"seconds": t["window_s"], **trace_slowdown(raw)}
        log(f"slice: {json.dumps(result['slice'])}")
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package is loaded: {found}")
        return 3
    for name, c in checks.items():
        log(f"check {name}: {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(run(parse_args()))
