"""Metrics and structured logs for the port's engine, scheduler and HTTP
layer.

Twin of the parts of ``tpu_inference/telemetry.py`` that this slice's
engine, scheduler and server call, with the reference's metric names:

- ``log_event``: one-line structured JSON logs on stderr, leveled via
  ``TPU_INF_LOG`` (default "warning").
- ``Counter`` / ``Gauge`` / ``Histogram`` / ``Registry`` and
  ``render_prometheus``: Prometheus text exposition (format 0.0.4).
- ``EngineTelemetry``: the per-engine metric bundle (dispatch and
  request-phase histograms, read-through pool and scheduler gauges).

Span recording, the step ledger, SLO windows and the flight recorder
wait for ROADMAP item 1.18.
"""

from __future__ import annotations

import json
import os
import sys
import time
from bisect import bisect_left
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _log_threshold() -> int:
    return _LEVELS.get(os.environ.get("TPU_INF_LOG", "warning").lower(), 30)


def log_event(event: str, level: str = "info", **fields: Any) -> None:
    """Emit one structured JSON log line to stderr (dropped below the
    ``TPU_INF_LOG`` threshold before any serialization)."""
    if _LEVELS.get(level, 20) < _log_threshold():
        return
    rec = {"ts": round(time.time(), 4), "level": level, "event": event}
    rec.update(fields)
    try:
        line = json.dumps(rec, default=str)
    except (TypeError, ValueError):
        line = json.dumps({"ts": rec["ts"], "level": level, "event": event,
                           "error": "unserializable fields"})
    print(line, file=sys.stderr, flush=True)


class Counter:
    """Monotonic counter; ``fn`` makes it read-through (computed at
    collect time)."""

    __slots__ = ("name", "help", "labels", "value", "fn")
    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Mapping[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value: float = 0
        self.fn = fn

    def inc(self, n: float = 1) -> None:
        self.value += n

    def collect_value(self) -> float:
        return self.fn() if self.fn is not None else self.value


class Gauge(Counter):
    """Point-in-time value; ``fn`` = computed at collect time."""

    __slots__ = ()
    kind = "gauge"

    def set(self, v: float) -> None:
        self.value = v


# Log-spaced bucket bounds: seconds ~7.6 us .. 1024 s; counts 1 .. 512.
SECONDS_BUCKETS = tuple(2.0 ** e for e in range(-17, 11))
COUNT_BUCKETS = tuple(float(2 ** e) for e in range(0, 10))
# Rates in [0, 1] (speculative acceptance).
RATE_BUCKETS = tuple(i / 8 for i in range(9))


class Histogram:
    """Fixed-bucket histogram (Prometheus ``histogram`` semantics)."""

    __slots__ = ("name", "help", "labels", "bounds", "_counts", "sum")
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = SECONDS_BUCKETS,
                 labels: Optional[Mapping[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds: Tuple[float, ...] = tuple(buckets)
        self._counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum: float = 0.0

    def observe(self, v: float) -> None:
        self._counts[bisect_left(self.bounds, v)] += 1
        self.sum += v

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in list(self._counts):
            acc += c
            out.append(acc)
        return out

    def phase_snapshot(self) -> Dict[str, Any]:
        cum = self.cumulative()
        return {"count": cum[-1], "sum": self.sum,
                "buckets": [[b, c] for b, c in zip(self.bounds, cum)]}


class Registry:
    """Ordered metric collection; re-adding a (name, labels) key with a
    ``fn`` re-binds it (restartable components never leave stale
    closures)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def _get(self, cls, name, help, fn, labels, **kw):
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help, labels=labels, **kw)
            self._metrics[key] = m
        if fn is not None:
            m.fn = fn
        return m

    def counter(self, name: str, help: str = "", fn=None,
                **labels: str) -> Counter:
        return self._get(Counter, name, help, fn, labels)

    def gauge(self, name: str, help: str = "", fn=None,
              **labels: str) -> Gauge:
        return self._get(Gauge, name, help, fn, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = SECONDS_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, help, None, labels,
                         buckets=buckets)

    def collect(self) -> List[Any]:
        return list(self._metrics.values())


def escape_label_value(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    if v != v:                                   # NaN
        return "NaN"
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def _fmt_labels(labels: Mapping[str, str],
                extra: Optional[Mapping[str, str]] = None) -> str:
    merged = dict(extra or {})
    merged.update(labels)
    if not merged:
        return ""
    return "{" + ",".join(f'{k}="{escape_label_value(v)}"'
                          for k, v in merged.items()) + "}"


def render_prometheus(groups: Iterable[Tuple[Mapping[str, str], Registry]]
                      ) -> str:
    """Render label-tagged registries as one Prometheus text page;
    HELP/TYPE once per metric name, samples of a name contiguous."""
    families: Dict[str, Tuple[str, str, List[Tuple[Dict[str, str], Any]]]] = {}
    for shared, registry in groups:
        for m in registry.collect():
            fam = families.setdefault(m.name, (m.kind, m.help, []))
            fam[2].append((dict(shared), m))
    lines: List[str] = []
    for name, (kind, help_, samples) in families.items():
        help_ = help_.replace("\\", "\\\\").replace("\n", "\\n")
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for shared, m in samples:
            if kind == "histogram":
                cum = m.cumulative()
                for le, c in zip(m.bounds, cum):
                    ll = _fmt_labels({**m.labels, "le": _fmt_value(le)},
                                     shared)
                    lines.append(f"{name}_bucket{ll} {c}")
                ll = _fmt_labels({**m.labels, "le": "+Inf"}, shared)
                lines.append(f"{name}_bucket{ll} {cum[-1]}")
                ls = _fmt_labels(m.labels, shared)
                lines.append(f"{name}_sum{ls} {_fmt_value(m.sum)}")
                lines.append(f"{name}_count{ls} {cum[-1]}")
            else:
                ls = _fmt_labels(m.labels, shared)
                lines.append(f"{name}{ls} {_fmt_value(m.collect_value())}")
    return "\n".join(lines) + "\n"


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Histogram attribute -> JSON phases key (stats snapshot).
PHASE_HISTOGRAMS = {
    "prefill_dispatch": "prefill_dispatch_s",
    "decode_dispatch": "decode_dispatch_s",
    "decode_sync": "decode_sync_s",
    "dispatch_bubble": "dispatch_bubble_s",
    "tokens_per_dispatch": "tokens_per_dispatch",
    "hybrid_dispatch": "hybrid_dispatch_s",
    "decode_stall_during_prefill": "decode_stall_during_prefill_s",
    "kv_swap": "kv_swap_s",
    "queue_wait": "queue_wait_s",
    "prefill_phase": "prefill_phase_s",
    "decode_phase": "decode_phase_s",
    "ttft": "ttft_s",
    "e2e": "e2e_s",
}


def emit_build_info(registry: Registry, *, backend: str = "",
                    fleet: str = "", kv_quant: str = "",
                    spec_mode: str = "", routing: str = "") -> None:
    """The ``tpu_inf_build_info`` info-gauge (constant 1; the labels are
    the payload: version and serving configuration, for dashboard
    joins)."""
    from tpu_inference_torch import __version__
    registry.gauge(
        "tpu_inf_build_info",
        "Build/config info gauge (constant 1; the labels carry the "
        "version and serving configuration for dashboard joins)",
        fn=lambda: 1.0,
        version=__version__, backend=backend or "unknown",
        fleet=fleet or "none", kv_quant=kv_quant or "none",
        spec_mode=spec_mode or "off", routing=routing or "none")


class EngineTelemetry:
    """Per-engine metric bundle.

    Engine phases (observed by engine/engine.py): ``prefill_dispatch_s``
    (host wall of one prefill call including its first-token readback),
    ``decode_dispatch_s`` (host wall of one K-step decode call: with its
    sync at pipeline depth 1, the non-blocking dispatch alone deeper),
    ``decode_sync_s`` (host wall waiting on a dispatch-ahead call's
    event), ``dispatch_bubble_s`` (host gap between consecutive decode
    calls while sequences were active), ``tokens_per_dispatch``,
    ``hybrid_dispatch_s`` (host wall of one hybrid prefill+decode call),
    ``decode_stall_during_prefill_s`` (wall of one serial chunked-prefill
    call, up to its synced output, while decode lanes were active: the
    stall hybrid steps remove),
    ``kv_swap_s`` (host wall of one host-tier page batch copy),
    ``spec_accept_rate`` (acceptance per lane per spec round) and
    ``spec_gamma_g`` (mean adaptive γ of the latest verify round).
    Request phases (engine/scheduler.py at finish): ``queue_wait_s``,
    ``prefill_phase_s``, ``decode_phase_s``, ``ttft_s``, ``e2e_s``.
    """

    def __init__(self, engine=None):
        self.registry = r = Registry()
        self.prefill_dispatch_s = r.histogram(
            "tpu_inf_prefill_dispatch_seconds",
            "Host wall time of one prefill dispatch")
        self.decode_dispatch_s = r.histogram(
            "tpu_inf_decode_dispatch_seconds",
            "Host wall time of one fused-decode engine call")
        self.dispatch_bubble_s = r.histogram(
            "tpu_inf_dispatch_bubble_seconds",
            "Host-side gap between consecutive decode calls with active "
            "sequences (device-idle exposure)")
        self.tokens_per_dispatch = r.histogram(
            "tpu_inf_tokens_per_dispatch",
            "Tokens surfaced per fused decode call", buckets=COUNT_BUCKETS)
        self.decode_sync_s = r.histogram(
            "tpu_inf_decode_sync_seconds",
            "Host wall blocked syncing a dispatch-ahead decode call")
        self.hybrid_dispatch_s = r.histogram(
            "tpu_inf_hybrid_dispatch_seconds",
            "Host wall time of one hybrid prefill+decode fused dispatch")
        self.decode_stall_during_prefill_s = r.histogram(
            "tpu_inf_decode_stall_during_prefill_seconds",
            "Wall time active decode lanes sat stalled behind a serial "
            "chunked-prefill dispatch (structurally zero while hybrid "
            "steps fuse chunks into the decode dispatch; pressure-"
            "degraded rounds chunk serially and record their real stalls)")
        self.kv_swap_s = r.histogram(
            "tpu_inf_kv_swap_seconds",
            "Host wall of one device<->host KV page-batch swap (both "
            "directions queue non-blocking copies on the stream)")
        self.kv_offload_pages = r.counter(
            "tpu_inf_kv_offload_pages_total",
            "KV pages demoted from the device pool to the host-RAM tier")
        self.kv_restore_pages = r.counter(
            "tpu_inf_kv_restore_pages_total",
            "KV pages promoted from the host-RAM tier back into the "
            "device pool")
        self.kv_offload_bytes = r.counter(
            "tpu_inf_kv_offload_bytes_total",
            "Bytes copied device->host by KV page demotion")
        self.kv_restore_bytes = r.counter(
            "tpu_inf_kv_restore_bytes_total",
            "Bytes copied host->device by KV page promotion")
        self.spec_accept_rate = r.histogram(
            "tpu_inf_spec_acceptance_rate",
            "Per-sequence-round speculative acceptance rate "
            "(accepted / drafted positions; one observation per lane "
            "per spec round)",
            buckets=RATE_BUCKETS)
        self.spec_gamma_g = r.gauge(
            "tpu_inf_spec_gamma",
            "Mean adaptive speculation depth γ across the latest spec "
            "round's lanes (0 = every lane throttled to plain decode)")
        self.hybrid_steps = r.counter(
            "tpu_inf_hybrid_steps_total",
            "Hybrid prefill+decode fused dispatches issued")
        self.queue_wait_s = r.histogram(
            "tpu_inf_queue_wait_seconds",
            "Request admission queue wait (enqueue -> prefill start)")
        self.prefill_phase_s = r.histogram(
            "tpu_inf_prefill_phase_seconds",
            "Request prefill phase (prefill start -> first token)")
        self.decode_phase_s = r.histogram(
            "tpu_inf_decode_phase_seconds",
            "Request decode phase (first token -> finish)")
        self.ttft_s = r.histogram(
            "tpu_inf_ttft_seconds",
            "Time to first token (enqueue -> first token)")
        self.e2e_s = r.histogram(
            "tpu_inf_e2e_seconds",
            "Request end-to-end latency (enqueue -> finish)")
        self.decode_dispatches = r.counter(
            "tpu_inf_decode_dispatches_total",
            "Fused-decode engine calls dispatched")
        self.prefill_dispatches = r.counter(
            "tpu_inf_prefill_dispatches_total", "Prefill dispatches issued")
        if engine is not None:
            self.bind_engine(engine)

    def bind_engine(self, engine) -> None:
        """Read-through metrics over state the engine already tracks."""
        r = self.registry
        alloc = engine.allocator
        total = engine.engine_cfg.num_pages - 1   # page 0 = trash page
        r.counter("tpu_inf_kv_page_allocs_total", "KV pool pages allocated",
                  fn=lambda: alloc.pages_allocated_total)
        r.counter("tpu_inf_kv_page_frees_total", "KV pool pages freed",
                  fn=lambda: alloc.pages_freed_total)
        r.gauge("tpu_inf_kv_pages_total", "Allocatable KV pool pages",
                fn=lambda: total)
        r.gauge("tpu_inf_kv_pages_in_use", "KV pool pages in use",
                fn=lambda: total - alloc.num_free)
        r.gauge("tpu_inf_kv_page_util",
                "KV pool utilization (in_use / total)",
                fn=lambda: (total - alloc.num_free) / max(total, 1))
        r.gauge("tpu_inf_kv_pool_pressure",
                "1 - (free+evictable)/total: fraction of the pool pinned "
                "by running sequences",
                fn=lambda: engine.pool_pressure)
        r.counter("tpu_inf_preemptions_total",
                  "Sequences preempted for KV pool pressure "
                  "(admission=optimistic watermark safety net)",
                  fn=lambda: engine.preemptions_total)
        r.counter("tpu_inf_recompute_resumes_total",
                  "Preempted sequences re-prefilled (recompute-resume)",
                  fn=lambda: engine.resumes_total)
        r.counter("tpu_inf_swap_in_resumes_total",
                  "Resume prefills that restored KV pages from the "
                  "cache tiers instead of recomputing them all",
                  fn=lambda: engine.swap_in_resumes)
        r.gauge("tpu_inf_model_params", "Model parameter count",
                fn=lambda: engine.n_params)
        r.gauge("tpu_inf_active_sequences", "Bound decode slots",
                fn=lambda: sum(s is not None for s in engine.slots))
        r.gauge("tpu_inf_decode_rung",
                "Active batch-ladder rung (batch size of the decode call "
                "the latest dispatch ran)",
                fn=lambda: engine.decode_rung)
        r.gauge("tpu_inf_decode_ladder_top",
                "Top batch-ladder rung (max concurrent decode lanes)",
                fn=lambda: engine.ladder[-1])
        r.counter("tpu_inf_rung_switches_total",
                  "Decode dispatches that changed ladder rung",
                  fn=lambda: engine.rung_switches_total)
        r.gauge("tpu_inf_decode_occupancy",
                "Decode lane occupancy: bound slots / top ladder rung",
                fn=lambda: (sum(s is not None for s in engine.slots)
                            / max(engine.ladder[-1], 1)))

    def bind_spec(self, engine) -> None:
        """Read-through speculative-decoding counters (bound only when
        speculation is on, so other servers expose no dead series)."""
        r = self.registry
        r.counter("tpu_inf_spec_drafted_total",
                  "Speculative positions proposed for verification "
                  "(draft-model or n-gram proposals)",
                  fn=lambda: engine.spec_drafted)
        r.counter("tpu_inf_spec_accepted_total",
                  "Speculative positions accepted by the target model",
                  fn=lambda: engine.spec_accepted)
        r.counter("tpu_inf_spec_rounds_total",
                  "Verify rounds dispatched (ngram mode)",
                  fn=lambda: engine.spec_rounds_total)
        r.counter("tpu_inf_spec_fallback_rounds_total",
                  "Spec-mode rounds that ran the plain fused-K decode "
                  "call because no lane proposed",
                  fn=lambda: engine.spec_fallback_rounds)
        r.counter("tpu_inf_spec_throttles_total",
                  "Sequences throttled to γ=0 by the acceptance EWMA",
                  fn=lambda: engine.spec_throttles_total)

    def bind_host_pool(self, pool) -> None:
        """Read-through metrics over the host-RAM KV tier's accounting
        (engine/kv_cache.py HostPagePool)."""
        r = self.registry
        r.gauge("tpu_inf_kv_host_pages_total",
                "Host-RAM KV tier capacity (pages)",
                fn=lambda: pool.capacity)
        r.gauge("tpu_inf_kv_host_pages_used",
                "Host-RAM KV tier pages resident",
                fn=lambda: pool.used)
        r.counter("tpu_inf_kv_host_evictions_total",
                  "Host-tier entries dropped for good (second-tier LRU "
                  "eviction or supersession by a fresh HBM publish)",
                  fn=lambda: pool.evicted_total)

    def bind_scheduler(self, sched) -> None:
        """Read-through metrics over SchedulerStats counters."""
        r = self.registry
        stats = sched.stats
        r.counter("tpu_inf_steps_total", "Scheduler loop decode steps",
                  fn=lambda: stats.steps)
        r.counter("tpu_inf_prefills_total", "Prefills completed",
                  fn=lambda: stats.prefills)
        r.counter("tpu_inf_tokens_generated_total", "Tokens generated",
                  fn=lambda: stats.tokens_generated)
        r.counter("tpu_inf_tokens_prefix_cached_total",
                  "Prompt tokens served from KV prefix reuse",
                  fn=lambda: stats.tokens_prefix_cached)
        r.counter("tpu_inf_requests_rejected_total",
                  "Requests rejected at submission",
                  fn=lambda: stats.requests_rejected)
        r.counter("tpu_inf_step_failures_total",
                  "Prefill/decode dispatch exceptions",
                  fn=lambda: stats.step_failures)
        r.gauge("tpu_inf_queue_depth", "Requests waiting for admission",
                fn=lambda: len(sched._waiting))

    def request_finished(self, reason: str) -> None:
        """Per-finish-reason counter (lazy label children)."""
        self.registry.counter(
            "tpu_inf_requests_finished_total",
            "Finished requests by terminal reason",
            reason=reason or "unknown").inc()

    def phase_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON dump of the phase histograms (/metrics?format=json)."""
        return {key: getattr(self, attr).phase_snapshot()
                for key, attr in PHASE_HISTOGRAMS.items()}
