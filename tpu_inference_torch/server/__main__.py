"""CLI entry point: ``python -m tpu_inference_torch.server --model llama-3-8b``.

Serves the Ollama protocol on the card (``--device cuda``, the default)
or, for tests and small presets, on the CPU (``--device cpu``). The
model is a preset of any of the three families (``llama-3-8b``,
``mixtral-8x7b``, ``gpt2``, ...) with random weights made from
``--seed``, or a local HF checkpoint: ``--model auto --checkpoint DIR``
reads the architecture from DIR/config.json and streams DIR's
safetensors onto the card (``--tokenizer auto`` takes DIR's tokenizer;
``--check-numerics`` checks the weights and one forward before
serving; ``--debug-nans`` checks every serving forward layer by layer).
``--quant int8 --kv-quant int8`` serves int8 weights over an int8 KV
pool (int4 for either is the other tier); Mixtral-8x7B fits one 80 GB
card only with ``--quant int8`` or int4.

The sizing and engine flags are the reference's, with its defaults and
its order of resolving "auto": ``--max-batch-size``/``--num-pages auto``
from the card's memory (engine/autosize.py), then ``--decode-ladder``
against the batch size, then ``--host-cache-pages auto`` from the
machine's available RAM. The reference's chip configuration::

    python -m tpu_inference_torch.server --model llama-3-8b --quant int8 \\
        --kv-quant int8 --max-batch-size auto --num-pages auto \\
        --batch-cap 32 --decode-pipeline-depth 2

Speculative decoding: ``--spec-mode ngram`` (self-drafting from each
sequence's history) or ``--draft-model <preset>`` (``--spec-mode auto``
then means draft), ``--num-speculative-tokens`` γ. Fault injection:
``--chaos-*``, the step watchdog ``--step-watchdog-s``. ``--debug``
serves ``POST /debug/chaos``, ``GET /debug/steps`` (the step ledger's
roofline report, ``--step-ledger-depth`` records), ``POST
/debug/profile`` (torch.profiler traces under ``--profile-dir``), ``GET
/debug/requests`` (request timelines), ``GET /debug/trace`` (span trees
and their Chrome export) and ``GET /debug/blackbox`` (the flight
recorder's captures under ``--blackbox-dir``, newest
``--blackbox-retain`` kept). ``--slo-ttft-ms`` / ``--slo-tpot-ms`` set
the targets the SLO breach counters count against.

Replicas: ``--dp N`` serves N replicas, as threads of this process
(``--fleet in-process``) or as supervised worker processes behind a
router (``--fleet subprocess``: ``--worker-restart-*``,
``--drain-timeout-s``, ``--no-fleet-migrate``, ``--rpc-deadline-*``,
``--poison-max-workers`` and the ``--chaos-rpc-*`` transport faults).
Both route by ``--routing`` (``prefix_affinity``, weighted by
``--route-hit-weight``/``--route-host-hit-weight``, or
``least_loaded``) and resubmit a failed request up to
``--failover-retries`` times.
Replica i serves on ``cuda:{i % device_count}``, so on one card they all
share it, and ``--num-pages``/``--max-batch-size`` must then be integers
(``auto`` would size every replica from the whole card). P/D roles
need ``--fleet subprocess``: ``--roles prefill,decode`` (one per
replica) over ``--pd-ratio P:D|auto`` (sized by
``autosize.pd_worker_roles``, with ``--pd-prompt-rate`` and
``--pd-decode-rate``) over a uniform ``--role``;
``--pd-prefill-nice`` lowers the prefill workers' CPU priority.

Tensor parallelism: ``--tp N`` splits every replica's weights (heads,
d_ff, experts, vocab) and KV pool (kv heads) over N shards that one
process drives (parallel/tp.py); shard i of replica r serves on
``cuda:{(r * N + i) % device_count}``, so on one card every shard shares
it, and ``--num-pages``/``--max-batch-size`` must then be integers.
Sequence parallelism: ``--sp N --sp-attn ring|ulysses`` splits a fresh
prompt's prefill attention over N sequence slices of each tp shard
(kernels/ring_attention.py, kernels/ulysses_attention.py); a replica's
tp x sp devices wrap onto the cards as tp's do, and the same integer
sizing rule holds when they share one.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import threading

from tpu_inference_torch.config import PRESETS, ServerConfig
from tpu_inference_torch.engine.autosize import int_or_auto


def _buckets(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA LLM inference server (Ollama-protocol "
                    "endpoint)")
    p.add_argument("--model", default="tiny-llama",
                   help=f"preset ({', '.join(sorted(PRESETS))}), a local "
                        "HF checkpoint dir (config.json read for the "
                        "architecture), or 'auto' with --checkpoint")
    p.add_argument("--tokenizer", default="byte",
                   help="'byte', a local HF tokenizer dir, or 'auto' "
                        "(= the checkpoint dir's tokenizer when present)")
    p.add_argument("--checkpoint", default=None,
                   help="local HF safetensors directory (random weights "
                        "from --seed if omitted)")
    p.add_argument("--check-numerics", action="store_true",
                   help="before serving: every parameter finite, and one "
                        "forward finite layer by layer (catches corrupt "
                        "checkpoints)")
    p.add_argument("--debug-nans", action="store_true",
                   help="while serving, check every layer's output and "
                        "the logits of every forward for NaNs and fail "
                        "the step naming the layer (the twin of "
                        "jax_debug_nans; syncs once a layer)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=11434)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises when no card is visible) "
                        "or 'cpu'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--step-ledger-depth", type=int, default=256,
                   help="step-ledger ring depth (per-dispatch records "
                        "behind GET /debug/steps; floor 8)")
    p.add_argument("--profile-dir", default=ServerConfig.profile_dir,
                   help="where POST /debug/profile writes its traces "
                        "(chosen by the operator, never by a client)")
    p.add_argument("--slo-ttft-ms", type=float, default=0.0,
                   help="rolling SLO target for time-to-first-token "
                        "(ms): requests past it count into "
                        "tpu_inf_slo_breaches_total{slo=\"ttft\"}; the "
                        "windowed p50/p95 gauges export regardless. "
                        "0 = no target")
    p.add_argument("--slo-tpot-ms", type=float, default=0.0,
                   help="rolling SLO target for time-per-output-token "
                        "(ms): breaches count into "
                        "tpu_inf_slo_breaches_total{slo=\"tpot\"}; "
                        "0 = no target")
    # The reference's /tmp/tpu-inf-blackbox, under TMPDIR when it is set.
    p.add_argument("--blackbox-dir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "tpu-inf-blackbox"),
                   help="crash flight-recorder root (per-replica "
                        "capture dirs survive kill -9; '' disables). "
                        "Operator-chosen — clients never name capture "
                        "paths")
    p.add_argument("--blackbox-retain", type=int, default=8,
                   help="flight-recorder retention cap: newest N "
                        "trigger captures kept per replica")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int_or_auto, default=512,
                   help="KV pool pages, or 'auto': fill the card's memory "
                        "left after weights + activation headroom")
    p.add_argument("--max-pages-per-seq", type=int, default=64,
                   help="max context = page-size * this")
    p.add_argument("--max-batch-size", type=int_or_auto, default=8,
                   help="decode slots, or 'auto': size from the card's "
                        "memory after weights (engine/autosize.py)")
    p.add_argument("--target-ctx", type=int, default=0,
                   help="with auto sizing: expected context tokens per "
                        "sequence (0 = half the per-sequence max)")
    p.add_argument("--batch-cap", type=int, default=32,
                   help="upper bound for --max-batch-size auto")
    p.add_argument("--decode-ladder", default="auto",
                   help="decode batch ladder: 'auto' (doubling rungs "
                        "8/16/32/... up to max-batch-size), 'off' (one "
                        "rung at max-batch-size), or comma rungs like "
                        "'8,16,32'; each call runs at the smallest rung "
                        "covering the occupied lanes")
    p.add_argument("--ladder-admit-headroom-pages", type=int, default=0,
                   help="growing the batch past the base rung must leave "
                        "this many reclaimable KV pages spare; 0 = off")
    p.add_argument("--prefill-buckets", type=_buckets,
                   default=(64, 128, 256, 512, 1024),
                   help="comma-separated prompt buckets")
    p.add_argument("--chunked-prefill-size", type=int, default=0)
    p.add_argument("--max-prefill-batch", type=int, default=4)
    p.add_argument("--decode-steps-per-call", type=int, default=8)
    p.add_argument("--decode-pipeline-depth", type=int, default=1,
                   help=">1 keeps that many K-step decode calls queued on "
                        "the card (hides the host's dispatch time; adds "
                        "(depth-1)*K steps of streaming latency)")
    p.add_argument("--hybrid-prefill", action="store_true",
                   help="run each chunk of a multi-chunk prompt inside "
                        "the decode call, so running lanes keep producing "
                        "tokens; greedy output is unchanged")
    p.add_argument("--step-token-budget", type=int, default=0,
                   help="with --hybrid-prefill: chunk tokens per call are "
                        "capped at this minus the granted decode tokens "
                        "(floor: page-size); 0 = uncapped")
    p.add_argument("--latency-decode-threshold", type=int, default=1)
    p.add_argument("--attn-backend", default="auto",
                   choices=("auto", "kernel", "dense"))
    p.add_argument("--quant", default="none",
                   choices=("none", "int8", "int4"),
                   help="weight quantization: int8 codes with per-channel "
                        "scales, or int4 codes with group-128 scales")
    p.add_argument("--kv-quant", default="none",
                   choices=("none", "int8", "int4"),
                   help="KV-cache quantization: int8 codes with per-token-"
                        "head scales, or nibble-packed int4")
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--host-cache-pages", type=int_or_auto, default="auto",
                   help="host-RAM KV tier capacity in pages: evicted "
                        "prefix-cache pages demote to pinned host memory "
                        "and swap back in on reuse; 0 = off, 'auto' "
                        "(default) = half the available RAM "
                        "(/proc/meminfo MemAvailable) less 2 GiB")
    p.add_argument("--fabric-cache-pages", type=int, default=0,
                   help="fleet KV fabric: router-side shared pool "
                        "capacity in pages (README 'KV fabric'); "
                        "settled prefix pages published by any replica "
                        "warm prefills on EVERY replica, and autoscaled "
                        "workers boot warm from the pool; 0 = off")
    p.add_argument("--fabric-publish-min-pages", type=int, default=1,
                   help="fleet KV fabric: publish a prefix to the pool "
                        "only once at least this many settled pages are "
                        "available (filters short one-off prompts)")
    p.add_argument("--fabric-warmboot-pages", type=int, default=64,
                   help="fleet KV fabric: push up to this many MRU pool "
                        "pages into a newly spawned worker BEFORE it "
                        "becomes routable (warm boot for autoscale "
                        "scale-ups, restarts, and rollouts); 0 = off")
    p.add_argument("--kv-plane", default="relay",
                   choices=("relay", "shm"),
                   help="KV data plane (README 'KV data plane'): how KV "
                        "payloads (fabric publishes, P/D handoffs, drain "
                        "migrations) move between processes. 'relay' = "
                        "blobs ride the RPC sockets through the router "
                        "(default, works everywhere); 'shm' = payloads "
                        "go into a shared-memory page arena and only "
                        "descriptors cross the sockets (zero-copy; "
                        "needs --fleet subprocess on Linux, silently "
                        "falls back to relay otherwise)")
    p.add_argument("--shm-arena-bytes", type=int,
                   default=256 * 1024 * 1024,
                   help="--kv-plane shm: total shared-memory arena size "
                        "in bytes, split into one single-writer region "
                        "per worker (default 256 MiB)")
    p.add_argument("--route-fabric-hit-weight", type=float, default=0.25,
                   help="prefix-affinity: pages of prefill work one "
                        "fabric-pool hit page is worth (fourth "
                        "temperature: HBM-warm > host-warm > "
                        "fabric-warm > cold — a fabric page saves the "
                        "compute but pays deserialize + host->device "
                        "swap-in; 0 ignores fabric warmth)")
    p.add_argument("--admission", default="reserve",
                   choices=("reserve", "optimistic"),
                   help="'reserve' charges each request prompt + max_new "
                        "(no preemption); 'optimistic' charges prompt + "
                        "headroom and preempts/recompute-resumes under "
                        "pressure (token-identical under greedy decoding)")
    p.add_argument("--optimistic-headroom-pages", type=int, default=2,
                   help="optimistic admission: decode-headroom pages "
                        "charged per request on top of its prompt")
    p.add_argument("--preempt-watermark-pages", type=int, default=4,
                   help="preempt the most recently admitted sequences "
                        "when a decode grant comes up short and "
                        "free+evictable pages fall below this")
    p.add_argument("--preempt-max-per-request", type=int, default=3,
                   help="starvation guard: after this many preemptions a "
                        "request re-admits under full reservation")
    p.add_argument("--spec-mode", default="auto",
                   choices=("auto", "off", "draft", "ngram"),
                   help="speculative decoding proposal source: 'ngram' "
                        "= draft-free self-drafting (prompt lookup "
                        "against each sequence's own history; no draft "
                        "model; composes with the decode ladder, host KV "
                        "tier and repeat_penalty); 'draft' = a separate "
                        "draft model (--draft-model); 'auto' = draft when "
                        "--draft-model is given, else off")
    p.add_argument("--draft-model", default=None,
                   help="enable draft-model speculative decoding with "
                        "this draft preset or HF checkpoint dir (random "
                        "weights from --seed + 1 without a checkpoint)")
    p.add_argument("--draft-checkpoint", default=None,
                   help="HF safetensors dir for the draft model (required "
                        "when --checkpoint is set)")
    p.add_argument("--num-speculative-tokens", type=int, default=4,
                   help="speculation depth γ: proposed tokens verified "
                        "per round (each round emits 1..γ+1 tokens from "
                        "one target forward); [1, 16] when spec is on")
    p.add_argument("--ngram-window", type=int, default=3,
                   help="ngram spec: longest suffix n-gram matched "
                        "against the sequence's history ([1, 8]; "
                        "matching tries window..1, most recent match "
                        "wins)")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--request-timeout-s", type=float, default=600.0)
    p.add_argument("--admission-queue-depth", type=int, default=0)
    p.add_argument("--step-watchdog-s", type=float, default=0.0,
                   help="quarantine the replica whose prefill/decode "
                        "dispatch stays in flight this long (a wedged "
                        "card or call); 0 = off. With --no-warmup the "
                        "first dispatch builds the kernels")
    p.add_argument("--quarantine-after", type=int, default=3,
                   help="consecutive step failures before a replica is "
                        "quarantined (first failure marks it degraded)")
    p.add_argument("--quarantine-cooldown-s", type=float, default=30.0,
                   help="quarantined replicas re-enter (probation) after "
                        "this long; one clean step re-promotes, one "
                        "failure re-quarantines")
    p.add_argument("--failover-retries", type=int, default=1,
                   help="resubmit a request failed/stranded by a sick "
                        "replica (before any token streamed) to a "
                        "healthy one at most this many times")
    p.add_argument("--routing", default="prefix_affinity",
                   choices=("prefix_affinity", "least_loaded"),
                   help="dp replica routing: 'prefix_affinity' scores "
                        "replicas by expected re-prefill pages (prompt "
                        "pages minus a prefix-cache peek) blended with "
                        "load/pressure; 'least_loaded' routes on load "
                        "alone")
    p.add_argument("--route-hit-weight", type=float, default=1.0,
                   help="prefix-affinity: pages of prefill work one "
                        "peeked cache-hit page is worth in the routing "
                        "score (1.0 = at cost; larger lets warmth "
                        "outbid queue depth and pool pressure)")
    p.add_argument("--route-host-hit-weight", type=float, default=0.5,
                   help="prefix-affinity: pages of prefill work one "
                        "host-tier hit page is worth (a host page saves "
                        "the compute but pays a host->device swap-in; 0 "
                        "ignores host warmth)")
    p.add_argument("--default-class", default="interactive",
                   choices=("interactive", "batch", "background"),
                   help="priority class for requests without an "
                        "X-Priority header: interactive lanes preempt "
                        "batch/background ones at the admission "
                        "watermark instead of shedding 429")
    p.add_argument("--class-queue-depth", type=int, default=0,
                   help="per-class deferral queue depth: over the "
                        "admission cap, batch/background requests park "
                        "here (drained as load drops) instead of "
                        "shedding; 0 = legacy single global cap")
    p.add_argument("--debug", action="store_true",
                   help="expose the unauthenticated /debug/* endpoints "
                        "(request timelines, span traces, step ledger, "
                        "flight-recorder index, chaos and profiler "
                        "control)")
    p.add_argument("--chaos-page-pressure", type=int, default=0,
                   help="fault injection: hold this many KV pages out "
                        "of the pool at boot (adjustable via POST "
                        "/debug/chaos)")
    p.add_argument("--chaos-failure-rate", type=float, default=0.0,
                   help="HTTP fault injection: 503 this fraction of "
                        "generate requests")
    p.add_argument("--chaos-delay-s", type=float, default=0.0,
                   help="HTTP fault injection: delay requests uniformly "
                        "up to this many seconds")
    p.add_argument("--chaos-step-failure-rate", type=float, default=0.0,
                   help="engine fault injection: each prefill/decode "
                        "dispatch raises with this probability")
    p.add_argument("--chaos-step-wedge-s", type=float, default=0.0,
                   help="engine fault injection: each dispatch sleeps "
                        "this long first (exercises the step watchdog)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: weights and the KV pool "
                        "split over this many shards (experts too, for "
                        "Mixtral), driven by one process; shard i on "
                        "cuda:{i %% device_count} (one card: all share "
                        "it)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel degree: sharded-sequence "
                        "prefill over this many devices (long prompts); "
                        "the tp x sp devices wrap onto the visible cards "
                        "as --tp's do")
    p.add_argument("--sp-attn", default="ring",
                   choices=("ring", "ulysses"),
                   help="sequence-parallel algorithm: 'ring' (K/V chunks "
                        "rotate over the sp slices, O((S/n)^2) memory) or "
                        "'ulysses' (regroup to head slices and back, "
                        "balanced causal load; needs head counts "
                        "divisible by tp*sp)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas, each with its own "
                        "weights, KV pool and scheduler; replica i on "
                        "cuda:{i %% device_count} (one card: all share "
                        "it); requests route by prefix affinity")
    p.add_argument("--fleet", default="in-process",
                   choices=("in-process", "subprocess"),
                   help="dp fleet backend: 'in-process' runs every "
                        "replica as a thread of this server; "
                        "'subprocess' runs a router plus one worker "
                        "process per replica over a local framed RPC "
                        "(worker faults isolated, restarts with backoff, "
                        "drains migrate KV pages)")
    p.add_argument("--worker-restart-max", type=int, default=3,
                   help="subprocess fleet: restarts allowed per worker "
                        "(doubling backoff) before it stays down and "
                        "the fleet serves degraded on the survivors")
    p.add_argument("--worker-restart-backoff-s", type=float, default=0.5,
                   help="subprocess fleet: first restart backoff "
                        "(doubles per consecutive failure, at most 30 s)")
    p.add_argument("--drain-timeout-s", type=float, default=10.0,
                   help="subprocess fleet: budget a SIGTERM'd worker "
                        "gets to settle dispatches and export KV pages "
                        "before exiting")
    p.add_argument("--no-fleet-migrate", action="store_true",
                   help="subprocess fleet: disable drain-time KV page "
                        "migration (resubmissions re-prefill from "
                        "scratch)")
    p.add_argument("--autoscale", action="store_true",
                   help="subprocess fleet: SLO-driven autoscaler: spawn "
                        "a worker when pooled p95 TTFT/TPOT breaches "
                        "--slo-ttft-ms/--slo-tpot-ms for a sustained "
                        "window, drain-and-migrate the coldest replica "
                        "away when occupancy stays under the low "
                        "watermark")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="autoscaler floor on live replicas")
    p.add_argument("--autoscale-max", type=int, default=0,
                   help="autoscaler ceiling on live replicas "
                        "(0 = dp + 2)")
    p.add_argument("--autoscale-breach-window-s", type=float, default=3.0,
                   help="seconds of continuous p95-over-target before a "
                        "scale-up")
    p.add_argument("--autoscale-cooldown-s", type=float, default=10.0,
                   help="minimum seconds between scale decisions "
                        "(anti-flap hysteresis)")
    p.add_argument("--autoscale-low-watermark", type=float, default=0.25,
                   help="scale down when pooled ladder occupancy stays "
                        "under this (0..1) for the idle window")
    p.add_argument("--autoscale-idle-window-s", type=float, default=5.0,
                   help="seconds of continuous low occupancy before a "
                        "scale-down")
    p.add_argument("--role", default="mixed",
                   choices=("prefill", "decode", "mixed"),
                   help="uniform worker phase role: 'prefill' workers "
                        "prefill prompts and hand each settled prefill "
                        "(KV pages and stream state) to a decode worker, "
                        "nothing recomputed; 'decode' workers adopt "
                        "handoffs and decode; 'mixed' (default) runs "
                        "both. Needs --fleet subprocess when not 'mixed'")
    p.add_argument("--roles", default=None,
                   help="per-worker phase roles, comma-separated, one per "
                        "dp replica (e.g. 'prefill,decode,decode'); "
                        "overrides --role; needs --fleet subprocess")
    p.add_argument("--pd-ratio", default=None,
                   help="the prefill:decode worker split over dp: 'P:D' "
                        "(e.g. '1:3') or 'auto' (by each phase's share of "
                        "card-seconds, engine/autosize.py "
                        "pd_worker_roles); overrides --role, exclusive "
                        "with --roles; needs --fleet subprocess and "
                        "dp >= 2")
    p.add_argument("--pd-prompt-rate", type=float, default=None,
                   help="with --pd-ratio auto: prompt tokens/s offered to "
                        "the fleet (default: 512-token prompts)")
    p.add_argument("--pd-decode-rate", type=float, default=None,
                   help="with --pd-ratio auto: decode tokens/s (default: "
                        "128-token replies)")
    p.add_argument("--pd-prefill-nice", type=int, default=0,
                   help="os.nice() increment of the prefill-role worker "
                        "processes (a shared host: decode cadence stays "
                        "flat under prefill bursts; 0 = off)")
    p.add_argument("--chaos-rpc-seed", type=int, default=0,
                   help="transport fault injection: seed of the frame "
                        "fault schedule (same seed => same faults at "
                        "the same frame indices)")
    p.add_argument("--chaos-rpc-corrupt-rate", type=float, default=0.0,
                   help="transport fault injection: flip one byte in "
                        "this fraction of RPC frames (CRC rejects them; "
                        "reconnect + resync)")
    p.add_argument("--chaos-rpc-drop-rate", type=float, default=0.0,
                   help="transport fault injection: reset the "
                        "connection instead of sending this fraction "
                        "of frames")
    p.add_argument("--chaos-rpc-delay-rate", type=float, default=0.0,
                   help="transport fault injection: delay this "
                        "fraction of frames by --chaos-rpc-delay-s")
    p.add_argument("--chaos-rpc-delay-s", type=float, default=0.02,
                   help="transport fault injection: per-delayed-frame "
                        "sleep (seconds)")
    p.add_argument("--chaos-rpc-truncate-rate", type=float, default=0.0,
                   help="transport fault injection: torn write (a "
                        "prefix of the frame, then a reset)")
    p.add_argument("--chaos-rpc-wedge-after", type=int, default=0,
                   help="transport fault injection: after this many "
                        "matching frames the connection swallows all "
                        "traffic until the deadline watchdog recycles "
                        "it (0 = off; one-shot)")
    p.add_argument("--chaos-rpc-wedge-replica", type=int, default=0,
                   help="replica whose router connection arms the "
                        "wedge (with --chaos-rpc-wedge-after)")
    p.add_argument("--chaos-rpc-verbs", default="",
                   help="comma-separated RPC verbs the transport chaos "
                        "applies to ('' = every verb)")
    p.add_argument("--chaos-rpc-direction", default="both",
                   choices=("send", "recv", "both"),
                   help="which direction transport chaos applies to: "
                        "send = router->worker, recv = worker->router")
    p.add_argument("--rpc-deadline-fast-s", type=float, default=10.0,
                   help="deadline of control-plane RPCs (cancel, chaos, "
                        "healthz, ...); three consecutive timeouts "
                        "recycle the connection")
    p.add_argument("--rpc-deadline-slow-s", type=float, default=60.0,
                   help="deadline of RPCs that move KV bytes or block "
                        "on admission (submit, import-kv, drain)")
    p.add_argument("--poison-max-workers", type=int, default=3,
                   help="finish a request as poison (terminal 500) once "
                        "its attempts crashed or wedged this many "
                        "distinct workers (0 disables)")
    return p


def resolve_spec_mode(args, p: argparse.ArgumentParser) -> str:
    """``--spec-mode`` resolved and checked as the reference does
    ("auto" = draft when --draft-model is given, else off); usage errors
    go through ``p.error``. Returns "off", "draft" or "ngram"."""
    from tpu_inference_torch.config import validate_spec_config

    spec_mode = args.spec_mode
    if spec_mode == "auto":
        spec_mode = "draft" if args.draft_model else "off"
    if spec_mode == "draft" and not args.draft_model:
        p.error("--spec-mode draft requires --draft-model")
    if spec_mode == "off" and args.draft_model:
        p.error("--spec-mode off conflicts with --draft-model "
                "(drop one)")
    if spec_mode != "off":
        try:
            validate_spec_config(spec_mode, args.num_speculative_tokens,
                                 args.ngram_window,
                                 has_draft_model=bool(args.draft_model))
        except ValueError as e:
            p.error(str(e))
    return spec_mode


def resolve_engine_args(args, p: argparse.ArgumentParser) -> dict:
    """The EngineConfig fields of parsed ``args``, "auto" resolved in the
    reference's order (sizing, ladder, host tier); usage errors go
    through ``p.error``."""
    from tpu_inference_torch.engine import autosize

    spec_mode = resolve_spec_mode(args, p)
    if args.dp > 1 and "auto" in (args.num_pages, args.max_batch_size):
        # Each replica would size itself from the whole card it shares.
        p.error(f"--num-pages/--max-batch-size auto with --dp {args.dp}: "
                "replicas on one card would each size themselves from "
                "the whole card; pass integers")
    n_shards = args.tp * args.sp
    if n_shards > 1 and "auto" in (args.num_pages, args.max_batch_size) \
            and shards_share_a_card(args.device, n_shards):
        # The sizing takes weights/tp per card; shards on one card hold
        # the whole model there, and sp slices their attention's
        # activations beside it.
        what = "tp x sp" if args.tp > 1 and args.sp > 1 else (
            "tp" if args.tp > 1 else "sp")
        p.error(f"--num-pages/--max-batch-size auto with --tp {args.tp} "
                f"--sp {args.sp}: the {what} shards share a card, so a "
                "card holds more than weights/tp; pass integers")
    try:
        max_batch_size, num_pages = autosize.resolve_sizing_args(args)
        decode_ladder = autosize.parse_decode_ladder(args.decode_ladder,
                                                     max_batch_size)
    except (ValueError, RuntimeError) as e:
        p.error(str(e))
    if len(decode_ladder) > 1:
        print(f"[autosize] decode ladder: {list(decode_ladder)}",
              file=sys.stderr)
    host_cache_pages = args.host_cache_pages
    if host_cache_pages == "auto":
        # Every replica builds its own host tier: the machine's budget
        # is divided among them.
        host_cache_pages = autosize.auto_host_cache_pages(
            autosize.resolve_model_config(args.model, args.checkpoint),
            kv_quant=args.kv_quant,
            page_size=args.page_size) // max(1, args.dp)
        print(f"[autosize] host KV tier: {host_cache_pages} pages (from "
              f"/proc/meminfo MemAvailable, dp={args.dp})", file=sys.stderr)
    return dict(
        page_size=args.page_size, num_pages=num_pages,
        max_pages_per_seq=args.max_pages_per_seq,
        max_batch_size=max_batch_size, decode_ladder=decode_ladder,
        ladder_admit_headroom_pages=args.ladder_admit_headroom_pages,
        prefill_buckets=args.prefill_buckets,
        chunked_prefill_size=args.chunked_prefill_size,
        max_prefill_batch=args.max_prefill_batch,
        decode_steps_per_call=args.decode_steps_per_call,
        decode_pipeline_depth=args.decode_pipeline_depth,
        hybrid_prefill=args.hybrid_prefill,
        step_token_budget=args.step_token_budget,
        latency_decode_threshold=args.latency_decode_threshold,
        attn_backend=args.attn_backend, quant=args.quant,
        kv_quant=args.kv_quant,
        enable_prefix_cache=not args.no_prefix_cache,
        host_cache_pages=host_cache_pages, admission=args.admission,
        optimistic_headroom_pages=args.optimistic_headroom_pages,
        preempt_watermark_pages=args.preempt_watermark_pages,
        preempt_max_per_request=args.preempt_max_per_request,
        max_new_tokens=args.max_new_tokens, sp_attn=args.sp_attn,
        spec_mode="ngram" if spec_mode == "ngram" else "draft",
        ngram_window=args.ngram_window,
        num_speculative_tokens=(args.num_speculative_tokens
                                if spec_mode != "off" else 0),
        chaos_page_pressure=args.chaos_page_pressure,
        chaos_step_failure_rate=args.chaos_step_failure_rate,
        chaos_step_wedge_s=args.chaos_step_wedge_s,
        step_ledger_depth=args.step_ledger_depth,
        slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms)


def shards_share_a_card(device, tp: int) -> bool:
    """Whether ``tp`` shards (a replica's tp * sp) on ``device`` land on
    fewer cards than that (they wrap onto the visible cards; the CPU
    counts as one)."""
    import torch

    if str(device).split(":")[0] != "cuda":
        return True
    return torch.cuda.device_count() < tp


def worker_roles_from_args(args) -> tuple:
    """The per-worker roles of parsed ``args``: ``--roles`` over
    ``--pd-ratio`` over ``--role`` (() when every worker is mixed).
    Raises ValueError with a flag-spelling message."""
    from tpu_inference_torch.config import resolve_worker_roles

    if args.roles and args.pd_ratio:
        raise ValueError("--roles and --pd-ratio both name the worker "
                         "split; pick one")
    if args.roles:
        return resolve_worker_roles(
            args.dp, tuple(r.strip() for r in args.roles.split(",")))
    if args.pd_ratio:
        from tpu_inference_torch.engine.autosize import pd_worker_roles
        return pd_worker_roles(args.dp, args.pd_ratio,
                               prompt_token_rate=args.pd_prompt_rate,
                               decode_token_rate=args.pd_decode_rate)
    if args.role != "mixed":
        return resolve_worker_roles(args.dp, (), default_role=args.role)
    return ()


def server_overrides(args) -> dict:
    """The ServerConfig fields of parsed ``args``."""
    return {"host": args.host, "port": args.port,
            "request_timeout_s": args.request_timeout_s,
            "admission_queue_depth": args.admission_queue_depth,
            "step_watchdog_s": args.step_watchdog_s,
            "quarantine_after_failures": args.quarantine_after,
            "quarantine_cooldown_s": args.quarantine_cooldown_s,
            "failover_max_retries": args.failover_retries,
            "routing": args.routing,
            "route_hit_weight": args.route_hit_weight,
            "route_host_hit_weight": args.route_host_hit_weight,
            "default_class": args.default_class,
            "profile_dir": args.profile_dir,
            "blackbox_dir": args.blackbox_dir,
            "blackbox_retain": args.blackbox_retain,
            "chaos_failure_rate": args.chaos_failure_rate,
            "chaos_delay_s": args.chaos_delay_s,
            "fleet": args.fleet,
            "fabric_cache_pages": args.fabric_cache_pages,
            "fabric_publish_min_pages": args.fabric_publish_min_pages,
            "fabric_warmboot_pages": args.fabric_warmboot_pages,
            "route_fabric_hit_weight": args.route_fabric_hit_weight,
            "kv_plane": args.kv_plane,
            "shm_arena_bytes": args.shm_arena_bytes,
            "worker_restart_max": args.worker_restart_max,
            "worker_restart_backoff_s": args.worker_restart_backoff_s,
            "drain_timeout_s": args.drain_timeout_s,
            "fleet_migrate": not args.no_fleet_migrate,
            "autoscale": args.autoscale,
            "autoscale_min_replicas": args.autoscale_min,
            "autoscale_max_replicas": args.autoscale_max,
            "autoscale_breach_window_s": args.autoscale_breach_window_s,
            "autoscale_cooldown_s": args.autoscale_cooldown_s,
            "autoscale_low_watermark": args.autoscale_low_watermark,
            "autoscale_idle_window_s": args.autoscale_idle_window_s,
            "class_queue_depth": args.class_queue_depth,
            "worker_roles": worker_roles_from_args(args),
            "pd_prefill_nice": args.pd_prefill_nice,
            "chaos_rpc_seed": args.chaos_rpc_seed,
            "chaos_rpc_corrupt_rate": args.chaos_rpc_corrupt_rate,
            "chaos_rpc_drop_rate": args.chaos_rpc_drop_rate,
            "chaos_rpc_delay_rate": args.chaos_rpc_delay_rate,
            "chaos_rpc_delay_s": args.chaos_rpc_delay_s,
            "chaos_rpc_truncate_rate": args.chaos_rpc_truncate_rate,
            "chaos_rpc_wedge_after": args.chaos_rpc_wedge_after,
            "chaos_rpc_wedge_replica": args.chaos_rpc_wedge_replica,
            "chaos_rpc_verbs": tuple(v for v in
                                     args.chaos_rpc_verbs.split(",") if v),
            "chaos_rpc_direction": args.chaos_rpc_direction,
            "rpc_deadline_fast_s": args.rpc_deadline_fast_s,
            "rpc_deadline_slow_s": args.rpc_deadline_slow_s,
            "poison_max_workers": args.poison_max_workers}


def boot_server(args, p: argparse.ArgumentParser):
    """The server of parsed ``args``, built and (with --check-numerics)
    checked, not started; returns (server, the EngineConfig fields).
    Usage errors go through ``p.error``."""
    from tpu_inference_torch.engine.autosize import resolve_model_config

    for model, ckpt, flag in ((args.model, args.checkpoint, "--model"),
                              (args.draft_model, args.draft_checkpoint,
                               "--draft-model")):
        if model is not None:
            try:
                resolve_model_config(model, ckpt)
            except ValueError as e:
                p.error(f"{flag}: {e}")
    # The roles resolve before any model loads: a bad split is a usage
    # error in milliseconds.
    try:
        worker_roles = worker_roles_from_args(args)
    except ValueError as e:
        p.error(str(e))
    if any(r != "mixed" for r in worker_roles):
        if args.fleet != "subprocess":
            p.error("--role/--roles/--pd-ratio need --fleet subprocess "
                    "(the live KV handoff moves pages between worker "
                    "processes)")
        print(f"[pd] worker roles: {list(worker_roles)}", file=sys.stderr)
    if args.fleet == "subprocess" and args.draft_model:
        p.error("--fleet subprocess does not support --draft-model "
                "(workers boot their own weights; use --spec-mode ngram "
                "or the in-process fleet)")
    if args.autoscale and args.fleet != "subprocess":
        p.error("--autoscale needs --fleet subprocess (scaling spawns "
                "and drains worker processes)")
    if args.autoscale and not (args.slo_ttft_ms or args.slo_tpot_ms):
        p.error("--autoscale needs an SLO target to scale on: set "
                "--slo-ttft-ms and/or --slo-tpot-ms")
    if args.fleet == "subprocess" and args.check_numerics:
        p.error("--check-numerics needs the in-process fleet (the "
                "workers load their own weights)")
    engine_args = resolve_engine_args(args, p)
    if args.debug_nans:
        # Before the engine is built, as the reference's
        # jax.config.update("jax_debug_nans", True).
        from tpu_inference_torch.engine.numerics import set_debug_nans
        set_debug_nans(True)
        if args.fleet == "subprocess":
            print("[debug-nans] on in this process only: the worker "
                  "processes do not inherit it (as the reference's "
                  "workers do not inherit jax_debug_nans)", file=sys.stderr)

    from tpu_inference_torch.server.http import build_server

    server = build_server(
        model=args.model, tokenizer=args.tokenizer,
        checkpoint=args.checkpoint, warmup=not args.no_warmup,
        device=args.device, seed=args.seed, draft_model=args.draft_model,
        draft_checkpoint=args.draft_checkpoint, enable_debug=args.debug,
        server_overrides=server_overrides(args), dp=args.dp, tp=args.tp,
        sp=args.sp, **engine_args)
    if args.check_numerics:
        for engine in server.group.engines:
            engine.check_numerics()
        print("numerics check passed: params finite, forward finite",
              flush=True)
    return server, engine_args


def main(argv=None) -> None:
    p = build_parser()
    args = p.parse_args(argv)
    server, engine_args = boot_server(args, p)
    port = server.start()
    print(f"serving {args.model} on http://{args.host}:{port} "
          f"(device={server.engine.device}, "
          f"attn_backend={server.engine.attn_backend}, "
          f"quant={args.quant}, kv_quant={args.kv_quant}, "
          f"batch={engine_args['max_batch_size']} "
          f"ladder={list(server.engine.ladder)}, "
          f"pages={engine_args['num_pages']}, "
          f"step_ledger={engine_args['step_ledger_depth']}, "
          f"dp={args.dp} tp={args.tp} sp={args.sp} "
          f"sp_attn={args.sp_attn} fleet={args.fleet})",
          flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
