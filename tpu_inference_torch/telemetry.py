"""Metrics, structured logs and the step ledger for the port's engine,
scheduler and HTTP layer.

Twin of the parts of ``tpu_inference/telemetry.py`` that this slice's
engine, scheduler and server call, with the reference's metric names:

- ``log_event``: one-line structured JSON logs on stderr, leveled via
  ``TPU_INF_LOG`` (default "warning").
- ``Counter`` / ``Gauge`` / ``Histogram`` / ``Registry`` and
  ``render_prometheus``: Prometheus text exposition (format 0.0.4), with
  the exposition's own cost in ``tpu_inf_metrics_render_seconds``.
- ``EngineTelemetry``: the per-engine metric bundle (dispatch and
  request-phase histograms, read-through pool and scheduler gauges, the
  ``tpu_inf_mfu_estimate`` gauge).
- The step ledger (``StepLedger``, ``StepCostModel``,
  ``roofline_report``, ``merge_steps_reports``): one record per engine
  dispatch, graded against the card's peaks into compute-, HBM- or
  host-bound verdicts per step kind (GET /debug/steps).
- ``capture_torch_profile``: the torch.profiler capture behind POST
  /debug/profile, CPU ops of every thread (the engine thread's launch
  loop included) beside the card's kernels.
- Request tracing: ``SpanRecorder`` (one per replica and one for the
  router), ``assemble_trace`` and ``spans_to_chrome`` (GET /debug/trace).
- Rolling SLO gauges: ``RollingWindow``, ``pooled_quantile``,
  ``SLOTracker``, ``pooled_slo``, ``register_fleet_slo``.
- The crash flight recorder: ``FlightRecorder``, ``blackbox_index``
  (GET /debug/blackbox), ``attach_flight_recorder`` and, for the process
  fleet's router, ``attach_router_flight_recorder``.
- The process fleet's registry transport: ``dump_registry``,
  ``registry_from_dump``, ``fold_dump_into_carry`` and ``apply_carry``
  (a worker's series stay monotone across its restarts), and
  ``merge_phases`` (fleet phase histograms).

``TPU_INF_TELEMETRY=0`` turns collection off: every metric the engine
updates becomes the shared no-op ``NULL_METRIC``, the ledger
``NULL_LEDGER``, the span recorder a no-op, no SLO tracker or flight
recorder is bound, and the phase snapshot is empty.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import math
import os
import sys
import threading
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


class _NullMetric:
    """Shared no-op stand-in when telemetry is disabled: every mutator is
    an attribute lookup and an empty call, so instrumented code needs no
    ``if enabled`` branches of its own."""

    __slots__ = ()

    def inc(self, n: float = 1) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL_METRIC = _NullMetric()


def telemetry_enabled() -> bool:
    return os.environ.get("TPU_INF_TELEMETRY", "1") != "0"


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


class SharedHistogram(Histogram):
    """A Histogram that several threads observe (one HTTP handler thread
    per stream): each observation's two read-modify-writes happen under
    a lock, so none is lost. The engine's own histograms have one writer,
    the engine thread, and take no lock."""

    __slots__ = ("_lock",)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            Histogram.observe(self, v)


class Registry:
    """Ordered metric collection; re-adding a (name, labels) key with a
    ``fn`` re-binds it (restartable components never leave stale
    closures)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    def add(self, metric):
        """Register a built metric, replacing any of the same name and
        labels (registry_from_dump)."""
        self._metrics[(metric.name,
                       tuple(sorted(metric.labels.items())))] = metric
        return metric

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


# Self-metrics: the exposition observes its own cost. One registry per
# process, rendered as an extra unlabeled group on every scrape (a render
# exposes the histogram of the renders before it).
_SELF_REGISTRY = Registry()
_RENDER_SECONDS = _SELF_REGISTRY.histogram(
    "tpu_inf_metrics_render_seconds",
    "Host wall of one Prometheus text exposition render")


def render_prometheus(groups: Iterable[Tuple[Mapping[str, str], Registry]]
                      ) -> str:
    """Render label-tagged registries as one Prometheus text page;
    HELP/TYPE once per metric name, samples of a name contiguous."""
    t_render = time.perf_counter()
    groups = list(groups)
    if telemetry_enabled():
        groups.append(({}, _SELF_REGISTRY))
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
    out = "\n".join(lines) + "\n"
    _RENDER_SECONDS.observe(time.perf_counter() - t_render)
    return out


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# The series this package builds that the reference has no twin of: the
# decode call's launch split, the card's dispatch and gap time from CUDA
# events, the HTTP stream's lag, and the decode calls served by a graph
# replay or eager though eligible (PERF.md section 3 names each).
PORT_SERIES = (
    "tpu_inf_decode_launch_seconds",
    "tpu_inf_decode_launch_cpu_seconds_total",
    "tpu_inf_device_dispatch_seconds_total",
    "tpu_inf_device_gap_seconds_total",
    "tpu_inf_stream_lag_seconds",
    "tpu_inf_decode_graph_replays_total",
    "tpu_inf_decode_graph_eager_total",
)

# JSON phases key (stats snapshot) -> histogram attribute.
PHASE_HISTOGRAMS = {
    "prefill_dispatch_s": "prefill_dispatch_s",
    "decode_dispatch_s": "decode_dispatch_s",
    "decode_sync_s": "decode_sync_s",
    "dispatch_bubble_s": "dispatch_bubble_s",
    "tokens_per_dispatch": "tokens_per_dispatch",
    "hybrid_dispatch_s": "hybrid_dispatch_s",
    "decode_stall_during_prefill_s": "decode_stall_during_prefill_s",
    "kv_swap_s": "kv_swap_s",
    "spec_acceptance_rate": "spec_accept_rate",
    "queue_wait_s": "queue_wait_s",
    "prefill_phase_s": "prefill_phase_s",
    "decode_phase_s": "decode_phase_s",
    "ttft_s": "ttft_s",
    "e2e_s": "e2e_s",
}


def merge_phases(snaps: Sequence[Optional[Dict[str, Any]]]
                 ) -> Dict[str, Any]:
    """Element-wise merge of same-shaped ``phase_snapshot`` dicts (dp
    replicas into one fleet histogram)."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    base = snaps[0]
    if len(snaps) == 1:
        return dict(base)
    cum = [0] * len(base["buckets"])
    count, total = 0, 0.0
    for s in snaps:
        if len(s["buckets"]) != len(cum):
            continue
        count += s["count"]
        total += s["sum"]
        for i, (_, c) in enumerate(s["buckets"]):
            cum[i] += c
    return {"count": count, "sum": total,
            "buckets": [[b[0], c] for b, c in zip(base["buckets"], cum)]}


# ---------------------------------------------------------------------------
# Registry transport (the process fleet): a worker's samples travel over
# the RPC as a dump; the router rebuilds metrics from it under the
# worker's stable replica="i" label. Counter and histogram series of dead
# incarnations fold into a per-replica carry, so a restart never resets
# the fleet's scrape (Prometheus reads a dip as a counter reset).
# ---------------------------------------------------------------------------


def dump_registry(registry: Registry) -> List[Dict[str, Any]]:
    """A registry's current samples as JSON-able records (read-through
    metrics evaluated here, so the dump stands alone)."""
    out: List[Dict[str, Any]] = []
    for m in registry.collect():
        rec: Dict[str, Any] = {"name": m.name, "kind": m.kind,
                               "help": m.help, "labels": dict(m.labels)}
        if m.kind == "histogram":
            rec["bounds"] = list(m.bounds)
            rec["counts"] = list(m._counts)
            rec["sum"] = m.sum
        else:
            rec["value"] = m.collect_value()
        out.append(rec)
    return out


def registry_from_dump(samples: Sequence[Dict[str, Any]]) -> Registry:
    """A renderable Registry rebuilt from :func:`dump_registry` records."""
    r = Registry()
    for rec in samples:
        labels = rec.get("labels") or {}
        if rec["kind"] == "histogram":
            h = Histogram(rec["name"], rec.get("help", ""),
                          buckets=rec.get("bounds") or SECONDS_BUCKETS,
                          labels=labels)
            counts = list(rec.get("counts") or [])
            if len(counts) == len(h._counts):
                h._counts = counts
            h.sum = rec.get("sum", 0.0)
            r.add(h)
        else:
            cls = Gauge if rec["kind"] == "gauge" else Counter
            m = cls(rec["name"], rec.get("help", ""), labels=labels)
            m.value = rec.get("value", 0)
            r.add(m)
    return r


def _dump_key(rec: Dict[str, Any]) -> Tuple:
    return (rec["name"], tuple(sorted((rec.get("labels") or {}).items())))


def fold_dump_into_carry(carry: Dict[Tuple, Dict[str, Any]],
                         dump: Sequence[Dict[str, Any]]) -> None:
    """Add a dead incarnation's monotonic series (counters and
    histograms; gauges die with the process) into ``carry``, in place."""
    for rec in dump or ():
        if rec["kind"] == "gauge":
            continue
        key = _dump_key(rec)
        base = carry.get(key)
        if base is None:
            carry[key] = copy.deepcopy(rec)
        elif rec["kind"] == "counter":
            base["value"] = base.get("value", 0) + rec.get("value", 0)
        elif (rec["kind"] == "histogram"
              and base.get("bounds") == rec.get("bounds")):
            base["counts"] = [a + b for a, b in zip(base["counts"],
                                                    rec["counts"])]
            base["sum"] = base.get("sum", 0.0) + rec.get("sum", 0.0)


def apply_carry(carry: Dict[Tuple, Dict[str, Any]],
                dump: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The live dump plus the carried totals, without changing either.
    Carried series the live incarnation has not minted again still
    render, so no series vanishes across a restart."""
    if not carry:
        return list(dump or ())
    out: List[Dict[str, Any]] = []
    seen = set()
    for rec in dump or ():
        key = _dump_key(rec)
        seen.add(key)
        base = carry.get(key)
        if base is None or rec["kind"] == "gauge":
            out.append(rec)
            continue
        rec = copy.deepcopy(rec)
        if rec["kind"] == "counter":
            rec["value"] = rec.get("value", 0) + base.get("value", 0)
        elif (rec["kind"] == "histogram"
              and base.get("bounds") == rec.get("bounds")):
            rec["counts"] = [a + b for a, b in zip(rec["counts"],
                                                   base["counts"])]
            rec["sum"] = rec.get("sum", 0.0) + base.get("sum", 0.0)
        out.append(rec)
    for key, rec in carry.items():
        if key not in seen:
            out.append(rec)
    return out


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


def torch_trace(trace_dir: str, until: Callable[[], Any]) -> str:
    """Run torch.profiler (CPU activity, and the card's kernels when CUDA
    is available) around ``until()``, which blocks (a sleep, a wait for a
    stop signal), and write one Chrome trace into ``trace_dir``; returns
    its path. The profiler starts and stops on the calling thread (torch
    does not allow one thread to stop what another started) and records
    the CPU ops of every thread: by default it would record only the
    calling thread's, and the engine thread's launch loop is the one that
    matters. A torch without the all-threads option raises (TypeError)."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))
    prof.start()
    try:
        until()
    finally:
        prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def capture_torch_profile(profile_dir: str, replica: int,
                          seconds: float) -> Dict[str, Any]:
    """The capture behind POST /debug/profile: clamp the window to
    [0.1, 60] s and trace it while serving goes on, into
    ``{profile_dir}/replica{i}/`` (the operator's directory, never a
    client-chosen path). Raises whatever the profiler raises (another
    profiler running, a trace that cannot be written)."""
    seconds = min(max(0.1, float(seconds)), 60.0)
    trace_dir = os.path.join(profile_dir, f"replica{int(replica)}")
    torch_trace(trace_dir, lambda: time.sleep(seconds))
    return {"dir": trace_dir, "seconds": seconds, "replica": int(replica)}


# ---------------------------------------------------------------------------
# Step ledger and roofline attribution.
#
# The phase histograms say how long dispatches take; the step ledger says
# why. Every engine dispatch pushes one fixed-shape record into a ring; an
# analytic cost model (FLOPs from the architecture, HBM bytes from the
# weight bytes per device loop iteration plus the KV bytes touched at the
# serving kv_quant) turns each record into achieved FLOP/s and bytes/s,
# and a windowed aggregation gives one verdict per step kind:
# compute-bound, hbm-bound or host-bound (staging + bubble dominate).
# ---------------------------------------------------------------------------

STEP_KINDS = ("prefill_chunk", "decode", "hybrid", "spec_verify")

# Record layout (one tuple per dispatch; /debug/steps serializes it).
STEP_FIELDS = (
    "ts",             # unix seconds the record was pushed (~ sync time)
    "kind",           # one of STEP_KINDS
    "rung",           # batch-ladder rung dispatched (0 = prefill)
    "slots",          # decode lanes occupied in the dispatch
    "tokens",         # tokens generated (the MFU gauge's unit)
    "chunk_tokens",   # prompt tokens processed (prefill / hybrid chunk)
    "steps",          # device loop iterations (the weights stream from
                      # memory once per iteration)
    "device_s",       # the card: the dispatch's CUDA-event time; the
                      # CPU: dispatch wall + sync wall
    "staging_s",      # host batch-staging wall
    "bubble_s",       # host gap before the dispatch while lanes were
                      # active
    "kv_read_tokens",  # sum of (query position, context token) pairs
    "kv_swap_bytes",  # host<->device KV tier traffic since last record
    "spec_accepted",  # speculative positions accepted (spec_verify)
    "compile_event",  # 1 = first dispatch of this rung / bucket
)


class StepLedger:
    """Fixed-depth ring of per-dispatch step records.

    ``push`` is the hot-path write: one tuple, one list store, one int
    add (each atomic under the GIL); no locks. Readers copy the ring
    first, so a concurrent push can at worst duplicate or miss the newest
    record, never tear one."""

    __slots__ = ("depth", "_ring", "_n")

    def __init__(self, depth: int = 256):
        self.depth = max(8, int(depth))
        self._ring: List[Optional[tuple]] = [None] * self.depth
        self._n = 0

    def push(self, kind: str, rung: int, slots: int, tokens: int,
             chunk_tokens: int, steps: int, device_s: float,
             staging_s: float, bubble_s: float, kv_read_tokens: int,
             kv_swap_bytes: float, spec_accepted: int,
             compile_event: bool) -> None:
        self._ring[self._n % self.depth] = (
            time.time(), kind, int(rung), int(slots), int(tokens),
            int(chunk_tokens), int(steps), float(device_s),
            float(staging_s), float(bubble_s), int(kv_read_tokens),
            float(kv_swap_bytes), int(spec_accepted),
            1 if compile_event else 0)
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def overflowed(self) -> bool:
        return self._n > self.depth

    def records(self) -> List[tuple]:
        """Resident records, oldest first (a copy of the ring)."""
        ring, n = list(self._ring), self._n
        if n <= self.depth:
            return [r for r in ring[:n] if r is not None]
        i = n % self.depth
        return [r for r in ring[i:] + ring[:i] if r is not None]

    def snapshot(self) -> List[Dict[str, Any]]:
        """JSON-able dump, one dict per record keyed by STEP_FIELDS."""
        return [dict(zip(STEP_FIELDS, r)) for r in self.records()]


class _NullLedger:
    """No-op ledger when telemetry is disabled (a shared singleton, as
    NULL_METRIC)."""

    __slots__ = ()
    depth = 0
    count = 0
    overflowed = False

    def push(self, *a, **k) -> None:
        pass

    def records(self) -> List[tuple]:
        return []

    def snapshot(self) -> List[Dict[str, Any]]:
        return []


NULL_LEDGER = _NullLedger()


class DeviceClock:
    """Device time of the engine's dispatches from CUDA events (the card
    only; the engine builds none on the CPU or with telemetry off).

    ``start()`` records a dispatch's start event before its first queued
    operation and returns the dispatch's number; ``stop(n, bound)``
    records its end event after its last one, with ``bound`` = a
    sequence stays bound after it; ``read(n)``, once the host has
    synchronised on the dispatch anyway, adds start -> end to
    ``dispatch_total`` and, if a sequence was bound when the previous
    dispatch ended, that end -> this start to ``gap_total`` (the card's
    time outside any dispatch while requests wait: host staging, launch
    latency, the loop's other work, and any device work outside the
    brackets), and returns the dispatch's device seconds. It adds no
    synchronisation.

    Events come from ``event_factory`` (``torch.cuda.Event(
    enable_timing=True)``; fakes with known times in the tests), made
    once: a ring of ``depth`` (start, end) pairs, re-recorded in turn.
    A dispatch read after ``depth`` newer ones started has lost its pair
    and counts nothing (``read`` returns None), and a gap whose end
    event was re-recorded is left out, so a reading is never another
    dispatch's."""

    __slots__ = ("dispatch_total", "gap_total", "_stream", "_ring",
                 "_gen", "_prev", "_n", "_bound_end")

    def __init__(self, event_factory: Callable[[], Any],
                 dispatch_total, gap_total, depth: int = 16,
                 stream: Any = None):
        self.dispatch_total = dispatch_total
        self.gap_total = gap_total
        self._stream = stream
        depth = max(2, int(depth))
        self._ring = [(event_factory(), event_factory())
                      for _ in range(depth)]
        self._gen: List[int] = [-1] * depth     # dispatch held by a slot
        self._prev: List[Optional[int]] = [None] * depth
        self._n = 0
        self._bound_end: Optional[int] = None

    def start(self) -> int:
        n = self._n
        self._n += 1
        slot = n % len(self._ring)
        self._gen[slot] = n
        self._prev[slot] = self._bound_end
        self._ring[slot][0].record(self._stream)
        return n

    def stop(self, n: int, bound: bool) -> None:
        self._ring[n % len(self._ring)][1].record(self._stream)
        self._bound_end = n if bound else None

    def read(self, n: int) -> Optional[float]:
        d = len(self._ring)
        if self._gen[n % d] != n:
            return None
        start, end = self._ring[n % d]
        dt = start.elapsed_time(end) / 1e3
        self.dispatch_total.inc(dt)
        prev = self._prev[n % d]
        if prev is not None and self._gen[prev % d] == prev:
            gap = self._ring[prev % d][1].elapsed_time(start) / 1e3
            self.gap_total.inc(max(0.0, gap))
        return dt


_NULL_RANGE = contextlib.nullcontext()


def phase_range(phase: str):
    """The engine loop's phase ``phase`` as a profiler range named
    ``tpu_inf.<phase>`` (``torch.profiler.record_function``), on the
    profiler's own clock beside the kernels and the CUDA calls, while a
    torch profiler records; otherwise a shared no-op context (one module
    lookup and one flag read)."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", False):
        return _NULL_RANGE
    import torch
    return torch.profiler.record_function(f"tpu_inf.{phase}")


def stream_lag_histogram(registry: Registry, enabled: bool):
    """The HTTP layer's ``tpu_inf_stream_lag_seconds`` in ``registry`` (a
    fleet's registry of the HTTP layer, rendered without labels; every
    handler thread observes it), or NULL_METRIC when telemetry is off."""
    if not enabled:
        return NULL_METRIC
    return registry.add(SharedHistogram(
        "tpu_inf_stream_lag_seconds",
        "Per token line written to a client: the engine thread's stamp "
        "of the oldest token in the line to the return of the line's "
        "socket write (streamed); the one response of a non-streamed "
        "request counts once, from its first token"))


class StepCostModel:
    """Analytic per-record FLOPs and HBM bytes from the architecture: no
    device counters, so the same model grades CPU runs and the card.

    - matmul FLOPs: 2 x params per position processed (generated tokens
      + prompt chunk tokens).
    - attention FLOPs: 4 x n_heads x head_dim per layer per (query
      position, context token) pair (QK^T and AV).
    - HBM bytes: the weight bytes once per device loop iteration, KV
      bytes for every context token attended and every new position (at
      the serving kv_quant's per-token size), and host<->device swap
      traffic. Weight bytes are counted as stored: a path that also
      writes and reads a bf16 copy of each quantized slab moves more.
    """

    __slots__ = ("n_params", "n_layers", "n_heads", "head_dim",
                 "weight_bytes", "kv_token_bytes", "peak_flops",
                 "peak_hbm_bw")

    def __init__(self, *, n_params: int, n_layers: int, n_heads: int,
                 head_dim: int, weight_bytes: int, kv_token_bytes: int,
                 peak_flops: float, peak_hbm_bw: float):
        self.n_params = int(n_params)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.weight_bytes = int(weight_bytes)
        self.kv_token_bytes = int(kv_token_bytes)
        self.peak_flops = float(peak_flops)
        self.peak_hbm_bw = float(peak_hbm_bw)

    @classmethod
    def from_engine(cls, engine) -> "StepCostModel":
        from tpu_inference_torch.engine import autosize
        mcfg, ecfg = engine.model_cfg, engine.engine_cfg
        return cls(n_params=engine.n_params, n_layers=mcfg.n_layers,
                   n_heads=mcfg.n_heads, head_dim=mcfg.head_dim,
                   weight_bytes=autosize.weight_bytes(mcfg, ecfg.quant),
                   kv_token_bytes=autosize.kv_bytes_per_token(
                       mcfg, ecfg.kv_quant),
                   peak_flops=autosize.detect_peak_flops(engine.device),
                   peak_hbm_bw=autosize.detect_peak_hbm_bw(engine.device))

    def flops(self, rec: tuple) -> float:
        positions = rec[4] + rec[5]          # tokens + chunk_tokens
        return (2.0 * self.n_params * positions
                + 4.0 * self.n_layers * self.n_heads * self.head_dim
                * rec[10])                   # kv_read_tokens

    def hbm_bytes(self, rec: tuple) -> float:
        positions = rec[4] + rec[5]
        return (float(self.weight_bytes) * max(1, rec[6])   # steps
                + float(self.kv_token_bytes) * (rec[10] + positions)
                + rec[11])                   # kv_swap_bytes

    def as_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self.__slots__}


def _finalize_kind(agg: Dict[str, Any], peak_flops: float,
                   peak_hbm_bw: float) -> Dict[str, Any]:
    """Achieved rates, roofline fractions and the verdict from one kind's
    raw sums (shared by the per-replica report and the merge, so the two
    cannot disagree)."""
    device_s = agg["device_s"]
    host_s = agg["staging_s"] + agg["bubble_s"]
    out = dict(agg)
    out["host_s"] = round(host_s, 6)
    if device_s > 0:
        out["achieved_flops_per_s"] = round(agg["flops"] / device_s, 3)
        out["achieved_bytes_per_s"] = round(agg["hbm_bytes"] / device_s, 3)
    else:
        out["achieved_flops_per_s"] = 0.0
        out["achieved_bytes_per_s"] = 0.0
    compute_frac = out["achieved_flops_per_s"] / max(peak_flops, 1.0)
    hbm_frac = out["achieved_bytes_per_s"] / max(peak_hbm_bw, 1.0)
    host_frac = host_s / max(host_s + device_s, 1e-12)
    out["compute_frac"] = round(compute_frac, 6)
    out["hbm_frac"] = round(hbm_frac, 6)
    out["host_frac"] = round(host_frac, 6)
    if host_frac > 0.5:
        out["verdict"] = "host-bound"
    elif compute_frac >= hbm_frac:
        out["verdict"] = "compute-bound"
    else:
        out["verdict"] = "hbm-bound"
    for k in ("device_s", "staging_s", "bubble_s", "flops", "hbm_bytes",
              "kv_swap_bytes"):
        out[k] = round(out[k], 6)
    return out


def _ledger_mfu_ewma(recs: Sequence[tuple], n_params: int,
                     peak_flops: float, bind_unix: Optional[float],
                     now: float, tau_s: float = 30.0) -> Optional[float]:
    """Replay the MFU gauge's dt-weighted EWMA (alpha = 1 - exp(-dt/tau))
    over the ledger's (ts, tokens) events from the gauge's bind time: the
    value /debug/steps compares with ``tpu_inf_mfu_estimate`` (a plain
    window average would not agree over short windows)."""
    if not recs:
        return None
    rate = 0.0
    t = bind_unix if bind_unix is not None else recs[0][0]
    for r in recs:
        ts, tokens = r[0], r[4]
        dt = max(1e-6, ts - t)
        inst = tokens / dt
        rate += (1.0 - math.exp(-dt / tau_s)) * (inst - rate)
        t = ts
    dt = now - t
    if dt > 1e-3:
        rate *= math.exp(-dt / tau_s)   # the gauge's zero-rate tail
    return rate * 2.0 * n_params / max(peak_flops, 1.0)


def _top_sinks(kinds: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    return sorted(
        ({"sink": f"{k}.{comp}", "seconds": v[f"{comp}_s"]}
         for k, v in kinds.items() for comp in ("device", "staging",
                                                "bubble")
         if v[f"{comp}_s"] > 0),
        key=lambda s: -s["seconds"])[:3]


def _agreement(gauge: Optional[float], ledger: Optional[float]
               ) -> Optional[float]:
    if gauge and ledger is not None and gauge > 0:
        return round(ledger / gauge, 4)
    return None


def roofline_report(ledger, model: StepCostModel, *,
                    mfu_gauge: Optional[float] = None,
                    bind_unix: Optional[float] = None,
                    window_s: float = 60.0,
                    now: Optional[float] = None) -> Dict[str, Any]:
    """One replica's step attribution over the trailing window: per-kind
    roofline sums and verdicts, per-rung occupancy, the top three time
    sinks, and the ledger-replayed MFU beside the gauge's."""
    now = time.time() if now is None else now
    recs = ledger.records()
    cutoff = now - window_s
    window = [r for r in recs if r[0] >= cutoff]
    kinds: Dict[str, Dict[str, Any]] = {}
    rungs: Dict[str, Dict[str, float]] = {}
    for r in window:
        agg = kinds.get(r[1])
        if agg is None:
            agg = kinds[r[1]] = {
                "records": 0, "tokens": 0, "chunk_tokens": 0,
                "device_s": 0.0, "staging_s": 0.0, "bubble_s": 0.0,
                "flops": 0.0, "hbm_bytes": 0.0, "kv_swap_bytes": 0.0,
                "kv_read_tokens": 0, "spec_accepted": 0,
                "compile_events": 0}
        agg["records"] += 1
        agg["tokens"] += r[4]
        agg["chunk_tokens"] += r[5]
        agg["device_s"] += r[7]
        agg["staging_s"] += r[8]
        agg["bubble_s"] += r[9]
        agg["kv_read_tokens"] += r[10]
        agg["kv_swap_bytes"] += r[11]
        agg["spec_accepted"] += r[12]
        agg["compile_events"] += r[13]
        agg["flops"] += model.flops(r)
        agg["hbm_bytes"] += model.hbm_bytes(r)
        if r[1] != "prefill_chunk":
            ra = rungs.setdefault(str(r[2]), {"dispatches": 0,
                                              "slots_sum": 0})
            ra["dispatches"] += 1
            ra["slots_sum"] += r[3]
    kinds = {k: _finalize_kind(v, model.peak_flops, model.peak_hbm_bw)
             for k, v in kinds.items()}
    occupancy = {rung: {"dispatches": ra["dispatches"],
                        "mean_slots": round(ra["slots_sum"]
                                            / max(ra["dispatches"], 1), 2)}
                 for rung, ra in rungs.items()}
    ledger_mfu = _ledger_mfu_ewma(recs, model.n_params, model.peak_flops,
                                  bind_unix, now)
    mfu = {"gauge": mfu_gauge,
           "ledger": None if ledger_mfu is None else round(ledger_mfu, 12),
           "agreement": _agreement(mfu_gauge, ledger_mfu)}
    return {
        "enabled": True,
        "ts": round(now, 3),
        "window_s": window_s,
        "records_window": len(window),
        "records_total": ledger.count,
        "ledger_depth": ledger.depth,
        "truncated": bool(ledger.overflowed),
        "peaks": {"flops_per_s": model.peak_flops,
                  "hbm_bytes_per_s": model.peak_hbm_bw},
        "kinds": kinds,
        "rung_occupancy": occupancy,
        "top_sinks": _top_sinks(kinds),
        "compile_events": sum(r[13] for r in window),
        "mfu": mfu,
    }


# Raw per-kind sums merge_steps_reports adds up before it derives the
# verdict fields again (fractions and verdicts do not sum).
_KIND_SUM_FIELDS = ("records", "tokens", "chunk_tokens", "device_s",
                    "staging_s", "bubble_s", "flops", "hbm_bytes",
                    "kv_swap_bytes", "kv_read_tokens", "spec_accepted",
                    "compile_events")


def merge_steps_reports(reports: Sequence[Optional[Dict[str, Any]]]
                        ) -> Dict[str, Any]:
    """The fleet's step attribution from per-replica reports: per-kind
    sums pooled and graded again, occupancy pooled, the MFU gauge and
    replay averaged over replicas (MFU is a per-card share)."""
    reports = [r for r in reports if r and r.get("enabled")]
    if not reports:
        return {"enabled": False}
    peaks = reports[0].get("peaks") or {}
    peak_flops = peaks.get("flops_per_s") or 1.0
    peak_bw = peaks.get("hbm_bytes_per_s") or 1.0
    kinds: Dict[str, Dict[str, Any]] = {}
    rungs: Dict[str, Dict[str, float]] = {}
    for rep in reports:
        for k, v in (rep.get("kinds") or {}).items():
            agg = kinds.setdefault(k, {f: 0 for f in _KIND_SUM_FIELDS})
            for f in _KIND_SUM_FIELDS:
                agg[f] += v.get(f, 0)
        for rung, ra in (rep.get("rung_occupancy") or {}).items():
            dst = rungs.setdefault(rung, {"dispatches": 0,
                                          "slots_sum": 0.0})
            dst["dispatches"] += ra.get("dispatches", 0)
            dst["slots_sum"] += (ra.get("mean_slots", 0)
                                 * ra.get("dispatches", 0))
    kinds = {k: _finalize_kind(v, peak_flops, peak_bw)
             for k, v in kinds.items()}
    occupancy = {rung: {"dispatches": int(ra["dispatches"]),
                        "mean_slots": round(ra["slots_sum"]
                                            / max(ra["dispatches"], 1), 2)}
                 for rung, ra in rungs.items()}
    gauges = [r["mfu"].get("gauge") for r in reports
              if (r.get("mfu") or {}).get("gauge") is not None]
    ledgers = [r["mfu"].get("ledger") for r in reports
               if (r.get("mfu") or {}).get("ledger") is not None]
    mfu = {"gauge": round(sum(gauges) / len(gauges), 12) if gauges
           else None,
           "ledger": round(sum(ledgers) / len(ledgers), 12) if ledgers
           else None}
    mfu["agreement"] = _agreement(mfu["gauge"], mfu["ledger"])
    return {
        "enabled": True,
        "replicas_merged": len(reports),
        "window_s": max(r.get("window_s", 0) for r in reports),
        "records_window": sum(r.get("records_window", 0)
                              for r in reports),
        "records_total": sum(r.get("records_total", 0) for r in reports),
        "truncated": any(r.get("truncated") for r in reports),
        "peaks": {"flops_per_s": peak_flops, "hbm_bytes_per_s": peak_bw},
        "kinds": kinds,
        "rung_occupancy": occupancy,
        "top_sinks": _top_sinks(kinds),
        "compile_events": sum(r.get("compile_events", 0)
                              for r in reports),
        "mfu": mfu,
    }


# ---------------------------------------------------------------------------
# Request tracing. A span is one JSON-able dict describing a timed phase
# of one request:
#
#     {"name", "trace": trace_id, "parent": parent span NAME ("" = the
#      root "request" span), "ts": unix seconds, "dur": seconds,
#      "replica": emitting replica (-1 = the router), "attrs": {...}}
#
# Instrumented code passes time.perf_counter() readings; the recorder
# maps them to unix seconds through a (time.time(), perf_counter())
# anchor taken at construction, so spans of different recorders land on
# one timeline. Parents are linked by NAME within a trace (names are
# unique per trace per replica except prefill_chunk, whose parent
# "prefill" is unambiguous).
# ---------------------------------------------------------------------------


class SpanRecorder:
    """Bounded span sink (one per engine replica, one in the router).
    Finished traces move to a recent ring at ``seal()``; spans no
    request owns (cache-eviction swap-outs) land in a maintenance ring.
    A lock guards the tables (spans are recorded per request and per
    chunk, never per decode step); every export returns a copy.
    Disabled (``TPU_INF_TELEMETRY=0``) every method is a no-op."""

    MAX_TRACES = 256
    MAX_SPANS_PER_TRACE = 96

    def __init__(self, enabled: Optional[bool] = None, replica: int = -1):
        self.enabled = telemetry_enabled() if enabled is None else enabled
        self.replica = replica
        self._anchor_unix = time.time()
        self._anchor_mono = time.perf_counter()
        self._open: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self._recent: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        self._maintenance: collections.deque = collections.deque(maxlen=128)
        self._lock = threading.Lock()
        self.spans_dropped = 0
        self.traces_evicted = 0

    def to_unix(self, t_mono: float) -> float:
        return self._anchor_unix + (t_mono - self._anchor_mono)

    def _span(self, name: str, trace_id: str, t0: float, t1: float,
              parent: str, attrs: Dict[str, Any]) -> dict:
        # The duration is the difference of the rounded endpoints, so
        # ts + dur lands on the rounded end (within a float ulp) and a
        # span that ends where the next begins never appears to overlap
        # it by a rounding step.
        ts = round(self.to_unix(t0), 6)
        end = round(self.to_unix(max(t0, t1)), 6)
        span = {"name": name, "trace": trace_id, "parent": parent,
                "ts": ts, "dur": round(end - ts, 6),
                "replica": self.replica}
        if attrs:
            span["attrs"] = attrs
        return span

    def add(self, name: str, trace_id: str, t0: float, t1: float,
            parent: str = "request", **attrs: Any) -> None:
        """Record one finished span (perf_counter start and end). The
        spans per trace and the open traces are both capped, so a trace
        that is never sealed cannot grow without bound."""
        if not self.enabled or not trace_id:
            return
        span = self._span(name, trace_id, t0, t1, parent, attrs)
        with self._lock:
            spans = self._open.get(trace_id)
            if spans is None:
                while len(self._open) >= self.MAX_TRACES:
                    self._open.popitem(last=False)
                    self.traces_evicted += 1
                spans = self._open[trace_id] = []
            if len(spans) >= self.MAX_SPANS_PER_TRACE:
                self.spans_dropped += 1
                return
            spans.append(span)

    def add_maintenance(self, name: str, t0: float, t1: float,
                        **attrs: Any) -> None:
        """Record a span no single request owns: it shows in the Chrome
        timeline on the replica's maintenance lane, never in a tree."""
        if not self.enabled:
            return
        self._maintenance.append(self._span(name, "-maintenance-",
                                            t0, t1, "", attrs))

    def ingest(self, trace_id: str, spans: Sequence[dict]) -> None:
        """Fold spans another recorder exported (with their own replica
        tags and unix timestamps) into this one's open table, or into
        the sealed trace when it is already sealed."""
        if not self.enabled or not trace_id or not spans:
            return
        with self._lock:
            dest = self._open.get(trace_id)
            if dest is None:
                dest = self._recent.get(trace_id)
            if dest is None:
                while len(self._open) >= self.MAX_TRACES:
                    self._open.popitem(last=False)
                    self.traces_evicted += 1
                dest = self._open[trace_id] = []
            room = self.MAX_SPANS_PER_TRACE - len(dest)
            if room < len(spans):
                self.spans_dropped += len(spans) - max(0, room)
            dest.extend(list(spans)[:max(0, room)])

    def seal(self, trace_id: str) -> None:
        """The request finished: move its spans to the recent ring (what
        /debug/trace and the Chrome export read)."""
        if not self.enabled or not trace_id:
            return
        with self._lock:
            spans = self._open.pop(trace_id, None)
            if spans is None:
                return
            prior = self._recent.pop(trace_id, None)
            if prior:
                spans = prior + spans
            while len(self._recent) >= self.MAX_TRACES:
                self._recent.popitem(last=False)
                self.traces_evicted += 1
            self._recent[trace_id] = spans

    def annotate(self, trace_id: str, name: str, **attrs: Any) -> bool:
        """Add ``attrs`` to the span ``name`` of a trace, open or sealed
        (what a later layer learns about a recorded span: the HTTP
        layer's write times on the root "request" span). False when the
        trace holds no such span."""
        if not self.enabled or not trace_id:
            return False
        with self._lock:
            spans = self._recent.get(trace_id) or self._open.get(trace_id)
            for span in spans or ():
                if span["name"] == name:
                    span["attrs"] = {**span.get("attrs", {}), **attrs}
                    return True
        return False

    def get_trace(self, trace_id: str) -> Optional[List[dict]]:
        with self._lock:
            spans = self._recent.get(trace_id) or self._open.get(trace_id)
            return list(spans) if spans else None

    def export_recent(self, trace_id: str) -> List[dict]:
        """A copy of a sealed trace's spans (they stay in the ring)."""
        with self._lock:
            return list(self._recent.get(trace_id) or ())

    def export_open(self, trace_id: str) -> List[dict]:
        """A copy of an unfinished trace's spans so far."""
        with self._lock:
            return list(self._open.get(trace_id) or ())

    def recent_traces(self, n: int = 64) -> Dict[str, List[dict]]:
        """The last ``n`` sealed traces, oldest first (none for n <= 0)."""
        if n <= 0:
            return {}
        with self._lock:
            ids = list(self._recent)[-n:]
            return {tid: list(self._recent[tid]) for tid in ids}

    def maintenance_spans(self, n: int = 128) -> List[dict]:
        return list(self._maintenance)[-n:]


# Every span name a recorder of the port emits (the reference's
# vocabulary).
SPAN_NAMES = (
    "request", "route", "queue_wait", "prefill", "prefill_chunk",
    "decode", "handoff", "handoff_adopt", "handoff_export",
    "drain_export", "migrate", "kv_swap_in", "kv_swap_out", "rollout",
    "scale_up", "scale_down",
)


def register_span_ring(registry: Registry, recorder: SpanRecorder) -> None:
    """Span-ring self-metrics over one SpanRecorder: occupancy gauges and
    drop/eviction counters, so trace loss under ring pressure shows on
    /metrics instead of silently truncating /debug/trace."""
    registry.gauge("tpu_inf_trace_ring_traces",
                   "Sealed request traces resident in the recent ring",
                   fn=lambda: float(len(recorder._recent)))
    registry.gauge("tpu_inf_trace_ring_open",
                   "Unsealed (in-flight or abandoned) traces in the "
                   "open table",
                   fn=lambda: float(len(recorder._open)))
    registry.counter("tpu_inf_trace_spans_dropped_total",
                     "Spans dropped by the per-trace span cap",
                     fn=lambda: recorder.spans_dropped)
    registry.counter("tpu_inf_trace_evictions_total",
                     "Whole traces evicted from the rings by the "
                     "trace-count cap",
                     fn=lambda: recorder.traces_evicted)


def assemble_trace(trace_id: str, spans: Sequence[dict]) -> dict:
    """One request's span tree: spans sorted by start time, children
    nested under their parent by NAME (first match in the same replica
    wins, then any replica; orphans attach to the root). The root is
    the router's ``request`` span when present, else a synthetic
    envelope covering every span."""
    spans = sorted(spans, key=lambda s: (s.get("ts", 0.0),
                                         -s.get("dur", 0.0)))
    nodes = [{**s, "children": []} for s in spans]
    root = next((n for n in nodes if n["name"] == "request"), None)
    if root is None:
        t0 = min((n["ts"] for n in nodes), default=0.0)
        t1 = max((n["ts"] + n["dur"] for n in nodes), default=0.0)
        root = {"name": "request", "trace": trace_id, "parent": "",
                "ts": round(t0, 6), "dur": round(t1 - t0, 6),
                "replica": -1, "children": [], "synthetic": True}
    by_name: Dict[Tuple[str, Optional[int]], dict] = {}
    for n in nodes:
        by_name.setdefault((n["name"], n.get("replica", -1)), n)
        by_name.setdefault((n["name"], None), n)
    for n in nodes:
        if n is root:
            continue
        parent = n.get("parent") or "request"
        if parent == n["name"]:
            parent = "request"
        target = (by_name.get((parent, n.get("replica", -1)))
                  or by_name.get((parent, None)))
        if target is None or target is n:
            target = root
        target["children"].append(n)
    return {"trace_id": trace_id, "n_spans": len(spans),
            "replicas": sorted({s.get("replica", -1) for s in spans}),
            "spans": spans, "tree": root}


def spans_to_chrome(traces: Mapping[str, Sequence[dict]],
                    pid_names: Optional[Mapping[int, str]] = None,
                    maintenance: Optional[Sequence[dict]] = None,
                    other_data: Optional[dict] = None) -> dict:
    """Span traces as Chrome trace-event JSON (complete ``ph:"X"``
    events, loadable in Perfetto): one pid per replica (router = pid 0,
    replica i = pid i+1), one tid per trace, unix microsecond
    timestamps."""
    events: List[dict] = []
    seen_pids: Dict[int, str] = {}
    seen_tids: set = set()
    pid_names = dict(pid_names or {})

    def _pid(replica: int) -> int:
        pid = replica + 1 if replica >= 0 else 0
        if pid not in seen_pids:
            seen_pids[pid] = pid_names.get(
                pid, "router" if pid == 0 else f"replica {pid - 1}")
        return pid

    for tidx, (trace_id, spans) in enumerate(traces.items(), start=1):
        for s in spans:
            pid = _pid(int(s.get("replica", -1)))
            if (pid, tidx) not in seen_tids:
                seen_tids.add((pid, tidx))
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tidx,
                               "args": {"name": f"trace {trace_id}"}})
            events.append({
                "name": s["name"], "cat": "request", "ph": "X",
                "ts": round(s["ts"] * 1e6, 1),
                "dur": round(max(s["dur"], 1e-6) * 1e6, 1),
                "pid": pid, "tid": tidx,
                "args": {**(s.get("attrs") or {}),
                         "trace_id": trace_id,
                         "parent": s.get("parent", "")},
            })
    for s in maintenance or ():
        pid = _pid(int(s.get("replica", -1)))
        events.append({
            "name": s["name"], "cat": "maintenance", "ph": "X",
            "ts": round(s["ts"] * 1e6, 1),
            "dur": round(max(s["dur"], 1e-6) * 1e6, 1),
            "pid": pid, "tid": 0,
            "args": dict(s.get("attrs") or {}),
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}}
            for pid, name in sorted(seen_pids.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": dict(other_data or {})}


# ---------------------------------------------------------------------------
# Rolling SLO gauges: a ring of the latest request latencies gives EXACT
# windowed quantiles (the log-bucketed histograms interpolate). Ring
# writes are single list stores; quantile reads sort a copy.
# ---------------------------------------------------------------------------

SLO_WINDOW = 512
SLO_QUANTILES = (0.5, 0.95)


class RollingWindow:
    """Ring of the last ``size`` observations with exact quantiles."""

    __slots__ = ("_ring", "_n")

    def __init__(self, size: int = SLO_WINDOW):
        self._ring = [0.0] * size
        self._n = 0

    def observe(self, v: float) -> None:
        self._ring[self._n % len(self._ring)] = v
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def values(self) -> List[float]:
        return self._ring[:min(self._n, len(self._ring))]

    def quantile(self, q: float) -> Optional[float]:
        return pooled_quantile([self.values()], q)


def pooled_quantile(windows: Sequence[Sequence[float]],
                    q: float) -> Optional[float]:
    """Exact quantile over several windows' pooled contents (per-window
    quantiles do not compose)."""
    xs = sorted(v for w in windows for v in (w or ()))
    if not xs:
        return None
    return xs[min(len(xs) - 1, int(q * len(xs)))]


class SLOTracker:
    """Windowed TTFT/TPOT quantiles and breach counts against the
    ``--slo-ttft-ms`` / ``--slo-tpot-ms`` targets (0 = no target: the
    quantile gauges still export, breaches never count)."""

    def __init__(self, ttft_target_s: float = 0.0,
                 tpot_target_s: float = 0.0):
        self.ttft_target_s = max(0.0, ttft_target_s)
        self.tpot_target_s = max(0.0, tpot_target_s)
        self.ttft = RollingWindow()
        self.tpot = RollingWindow()
        self.ttft_breaches = 0
        self.tpot_breaches = 0

    def observe(self, ttft_s: Optional[float],
                tpot_s: Optional[float]) -> None:
        if ttft_s is not None:
            self.ttft.observe(ttft_s)
            if self.ttft_target_s > 0 and ttft_s > self.ttft_target_s:
                self.ttft_breaches += 1
        if tpot_s is not None:
            self.tpot.observe(tpot_s)
            if self.tpot_target_s > 0 and tpot_s > self.tpot_target_s:
                self.tpot_breaches += 1

    def gauge_value(self, which: str, q: float) -> float:
        """The Prometheus gauges' value (NaN = empty window)."""
        ring = self.ttft if which == "ttft" else self.tpot
        v = ring.quantile(q)
        return float("nan") if v is None else v

    def snapshot(self, include_window: bool = True) -> dict:
        def _r(v):
            return None if v is None else round(v, 6)

        out = {
            "ttft_target_s": self.ttft_target_s or None,
            "tpot_target_s": self.tpot_target_s or None,
            "ttft_p50_s": _r(self.ttft.quantile(0.5)),
            "ttft_p95_s": _r(self.ttft.quantile(0.95)),
            "tpot_p50_s": _r(self.tpot.quantile(0.5)),
            "tpot_p95_s": _r(self.tpot.quantile(0.95)),
            "ttft_breaches": self.ttft_breaches,
            "tpot_breaches": self.tpot_breaches,
            "window_requests": min(self.ttft.count, SLO_WINDOW),
        }
        if include_window:
            # Raw ring contents, so a fleet view can pool exact quantiles.
            out["ttft_window"] = [round(v, 6) for v in self.ttft.values()]
            out["tpot_window"] = [round(v, 6) for v in self.tpot.values()]
        return out


def pooled_slo(slos: Sequence[Optional[dict]]) -> dict:
    """The fleet's SLO view from per-replica snapshots (with windows):
    pooled exact quantiles and summed breach counts."""
    slos = [s for s in slos if s]

    def _r(v):
        return None if v is None else round(v, 6)

    ttft = [s.get("ttft_window") or [] for s in slos]
    tpot = [s.get("tpot_window") or [] for s in slos]
    return {
        "ttft_target_s": next((s.get("ttft_target_s") for s in slos
                               if s.get("ttft_target_s")), None),
        "tpot_target_s": next((s.get("tpot_target_s") for s in slos
                               if s.get("tpot_target_s")), None),
        "ttft_p50_s": _r(pooled_quantile(ttft, 0.5)),
        "ttft_p95_s": _r(pooled_quantile(ttft, 0.95)),
        "tpot_p50_s": _r(pooled_quantile(tpot, 0.5)),
        "tpot_p95_s": _r(pooled_quantile(tpot, 0.95)),
        "ttft_breaches": sum(s.get("ttft_breaches", 0) for s in slos),
        "tpot_breaches": sum(s.get("tpot_breaches", 0) for s in slos),
        "window_requests": sum(s.get("window_requests", 0) for s in slos),
    }


def register_fleet_slo(registry: Registry,
                       quantile_fn: Callable[[str, float], float],
                       breaches_fn: Callable[[str], float]) -> None:
    """The fleet-level SLO series: ``quantile_fn(kind, q)`` returns the
    pooled exact quantile (NaN = no data), ``breaches_fn(kind)`` the
    fleet's breach total."""
    for q in SLO_QUANTILES:
        registry.gauge("tpu_inf_slo_ttft_seconds",
                       "Fleet rolling exact TTFT quantile (pooled "
                       "across replica windows; NaN = no data)",
                       fn=lambda q=q: quantile_fn("ttft", q),
                       q=f"{q:g}")
        registry.gauge("tpu_inf_slo_tpot_seconds",
                       "Fleet rolling exact TPOT quantile (pooled "
                       "across replica windows; NaN = no data)",
                       fn=lambda q=q: quantile_fn("tpot", q),
                       q=f"{q:g}")
    for kind in ("ttft", "tpot"):
        registry.counter("tpu_inf_slo_breaches_total",
                         "Fleet SLO target breaches (monotone across "
                         "worker restarts)",
                         fn=lambda k=kind: breaches_fn(k), slo=kind)


def register_fleet_elastic(registry: Registry,
                           scale_ups: Callable[[], int],
                           scale_downs: Callable[[], int],
                           rollouts: Callable[[], int],
                           class_preempted: Callable[[str], int],
                           class_deferred: Callable[[str], int],
                           class_shed: Callable[[str], int]) -> None:
    """The elastic fleet's series: autoscaler and rollout actuations and
    the per-class admission outcomes. All router state, so they survive
    worker restarts without a carry. Interactive requests never defer
    and are never preempted (they preempt), so those two series exist
    for the lower classes only."""
    from tpu_inference_torch.config import PRIORITY_CLASSES

    registry.counter("tpu_inf_fleet_scale_ups_total",
                     "Autoscaler scale-up actuations (worker spawned on "
                     "a sustained pooled-SLO breach)", fn=scale_ups)
    registry.counter("tpu_inf_fleet_scale_downs_total",
                     "Autoscaler scale-down actuations (coldest replica "
                     "drain-and-migrated away on a sustained lull)",
                     fn=scale_downs)
    registry.counter("tpu_inf_fleet_rollouts_total",
                     "Completed rolling-upgrade passes (POST "
                     "/debug/rollout)", fn=rollouts)
    for cls in PRIORITY_CLASSES:
        registry.counter("tpu_inf_class_shed_total",
                         "Requests shed with 429 after every class "
                         "escape (defer/preempt) failed",
                         fn=lambda c=cls: class_shed(c), **{"class": cls})
        if cls == PRIORITY_CLASSES[0]:
            continue
        registry.counter("tpu_inf_class_preempted_total",
                         "Running requests of this class preempted back "
                         "to their lane by an interactive arrival",
                         fn=lambda c=cls: class_preempted(c),
                         **{"class": cls})
        registry.gauge("tpu_inf_class_deferred",
                       "Requests currently parked in this class's "
                       "deferred admission lane",
                       fn=lambda c=cls: float(class_deferred(c)),
                       **{"class": cls})


def register_fabric(registry: Registry, pool) -> None:
    """The fleet KV fabric's series, one registration for both fleet
    backends. ``pool`` is a ``server.kv_fabric.FabricPool``; every
    series reads its counters, router state that survives worker
    restarts without a carry."""
    registry.counter("tpu_inf_fabric_hits_total",
                     "Fabric pool pages served to a replica's host tier "
                     "(crc-verified before adoption)",
                     fn=lambda: pool.hits)
    registry.counter("tpu_inf_fabric_misses_total",
                     "Fabric lookups that ended short of the requested "
                     "chain (absent or corrupt entry)",
                     fn=lambda: pool.misses)
    registry.counter("tpu_inf_fabric_puts_total",
                     "Pages published into the fabric pool (supersedes "
                     "included)", fn=lambda: pool.puts)
    registry.counter("tpu_inf_fabric_evictions_total",
                     "Fabric pool LRU capacity evictions",
                     fn=lambda: pool.evictions)
    registry.gauge("tpu_inf_fabric_pages_used",
                   "Serialized KV pages resident in the fabric pool",
                   fn=lambda: float(pool.used))
    registry.gauge("tpu_inf_fabric_bytes_used",
                   "Bytes of serialized KV resident in the fabric pool",
                   fn=lambda: float(pool.bytes_used))


# ---------------------------------------------------------------------------
# Crash flight recorder: a bounded per-replica blackbox directory of JSON
# captures (the last step records, recent spans, the resolved config and
# the stats), written on a watchdog trip, a step error and at exit, plus
# a periodic heartbeat that survives kill -9 (tmp + rename keeps every
# file whole). GET /debug/blackbox serves the index. Only ``capture``
# and the heartbeat swallow their errors: the recorder never takes
# serving down with it.
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Per-replica capture sink under ``{root}/replica-{i}/``.

    ``capture(trigger)`` writes ``capture-{seq:06d}-{trigger}.json``
    atomically and prunes past the retention cap (oldest first);
    ``maybe_periodic()`` refreshes one ``periodic.json`` at most every
    ``periodic_interval_s``. A per-trigger rate limit keeps a storm of
    step errors from churning the whole retention window."""

    def __init__(self, root_dir: str, replica: int = 0, *,
                 retain: int = 8, config: Optional[dict] = None,
                 steps_fn: Optional[Callable[[], list]] = None,
                 spans_fn: Optional[Callable[[], list]] = None,
                 stats_fn: Optional[Callable[[], dict]] = None,
                 periodic_interval_s: float = 10.0):
        self.root = root_dir
        self.replica = int(replica)
        self.dir = os.path.join(root_dir, f"replica-{self.replica}")
        self.retain = max(1, int(retain))
        self.config = dict(config or {})
        self.steps_fn = steps_fn
        self.spans_fn = spans_fn
        self.stats_fn = stats_fn
        self.periodic_interval_s = max(0.5, float(periodic_interval_s))
        self._last_periodic = 0.0
        self._last_by_trigger: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._atexit: Optional[Callable[[], Any]] = None
        try:
            os.makedirs(self.dir, exist_ok=True)
            for fname in os.listdir(self.dir):
                if fname.startswith("capture-"):
                    try:
                        self._seq = max(self._seq,
                                        int(fname.split("-")[1]) + 1)
                    except (ValueError, IndexError):
                        pass
            # A heartbeat a previous process left behind is its kill -9
            # postmortem: keep it under a sequence number before this
            # process's first beat overwrites it.
            prior = os.path.join(self.dir, "periodic.json")
            if os.path.exists(prior):
                dest = os.path.join(
                    self.dir, f"capture-{self._seq:06d}-postmortem.json")
                try:
                    with open(prior) as f:
                        payload = json.load(f)
                    payload["trigger"] = "postmortem"
                    self._write(dest, payload)
                    os.remove(prior)
                except (OSError, ValueError):
                    os.replace(prior, dest)
                self._seq += 1
        except OSError:
            pass

    def _payload(self, trigger: str) -> Dict[str, Any]:
        payload: Dict[str, Any] = {
            "ts": round(time.time(), 3), "replica": self.replica,
            "pid": os.getpid(), "trigger": trigger,
            "config": self.config}
        for key, fn, empty in (("steps", self.steps_fn, []),
                               ("spans", self.spans_fn, []),
                               ("stats", self.stats_fn, {})):
            try:
                payload[key] = fn() if fn is not None else empty
            except Exception:  # noqa: BLE001 — a section degrades to empty
                payload[key] = empty
        return payload

    def _write(self, path: str, payload: Dict[str, Any]) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def capture(self, trigger: str,
                min_interval_s: float = 1.0) -> Optional[str]:
        """Write one capture; returns its path (None = rate-limited or
        failed: the recorder never raises into serving code)."""
        try:
            with self._lock:
                now = time.time()
                if (now - self._last_by_trigger.get(trigger, -1e9)
                        < min_interval_s):
                    return None
                self._last_by_trigger[trigger] = now
                seq = self._seq
                self._seq += 1
            path = os.path.join(self.dir,
                                f"capture-{seq:06d}-{trigger}.json")
            self._write(path, self._payload(trigger))
            self._prune()
            log_event("blackbox_capture", trigger=trigger, path=path,
                      replica=self.replica)
            return path
        except Exception:  # noqa: BLE001 — never raise into serving code
            return None

    def _prune(self) -> None:
        caps = sorted(f for f in os.listdir(self.dir)
                      if f.startswith("capture-") and f.endswith(".json"))
        for fname in caps[:-self.retain]:
            try:
                os.unlink(os.path.join(self.dir, fname))
            except OSError:
                pass

    def maybe_periodic(self) -> None:
        """The scheduler loop's hook: refresh the heartbeat at most once
        per interval (a clock read and a compare otherwise)."""
        now = time.time()
        if now - self._last_periodic < self.periodic_interval_s:
            return
        self._last_periodic = now
        try:
            self._write(os.path.join(self.dir, "periodic.json"),
                        self._payload("periodic"))
        except Exception:  # noqa: BLE001 — never raise into serving code
            pass

    def install_atexit(self) -> None:
        import atexit
        self._atexit = lambda: self.capture("atexit", min_interval_s=0.0)
        atexit.register(self._atexit)

    def close(self) -> None:
        """Take the exit capture now and drop the interpreter-exit hook:
        a group that stops frees its engine, which the hook (through
        ``stats_fn``) would otherwise keep alive until exit."""
        hook, self._atexit = self._atexit, None
        if hook is not None:
            import atexit
            atexit.unregister(hook)
            hook()


def blackbox_index(root_dir: str) -> Dict[str, Any]:
    """The captures under a blackbox root, newest first (the GET
    /debug/blackbox body): trigger, timestamp, pid and the sizes of each
    payload section, enough to triage without reading the capture."""
    out: Dict[str, Any] = {"dir": root_dir, "captures": []}
    if not root_dir or not os.path.isdir(root_dir):
        return out
    for sub in sorted(os.listdir(root_dir)):
        rdir = os.path.join(root_dir, sub)
        if not (sub.startswith("replica-") and os.path.isdir(rdir)):
            continue
        try:
            replica = int(sub.split("-", 1)[1])
        except ValueError:
            continue
        try:
            fnames = sorted(os.listdir(rdir))
        except OSError:
            continue
        for fname in fnames:
            if not fname.endswith(".json"):
                continue
            path = os.path.join(rdir, fname)
            entry: Dict[str, Any] = {"replica": replica, "file": fname,
                                     "path": path}
            try:
                with open(path) as f:
                    payload = json.load(f)
                entry.update({
                    "trigger": payload.get("trigger"),
                    "ts": payload.get("ts"),
                    "pid": payload.get("pid"),
                    "n_steps": len(payload.get("steps") or ()),
                    "n_spans": len(payload.get("spans") or ()),
                    "has_config": bool(payload.get("config")),
                    "has_stats": bool(payload.get("stats")),
                })
            except (OSError, ValueError):
                entry["error"] = "unreadable"
            out["captures"].append(entry)
    out["captures"].sort(key=lambda e: e.get("ts") or 0.0, reverse=True)
    return out


def attach_flight_recorder(tel: "EngineTelemetry", root_dir: str,
                           replica: int, *, retain: int = 8,
                           config: Optional[dict] = None,
                           stats_fn: Optional[Callable[[], dict]] = None
                           ) -> Optional[FlightRecorder]:
    """Bind a FlightRecorder to one engine's telemetry bundle: the step
    ledger, the latest 32 sealed traces and maintenance spans, the
    config and ``stats_fn``. None when ``root_dir`` is empty or
    telemetry is off."""
    if not root_dir or not tel.enabled:
        return None
    recorder = tel.recorder

    def spans_fn() -> list:
        spans: list = []
        for trace in recorder.recent_traces(32).values():
            spans.extend(trace)
        spans.extend(recorder.maintenance_spans(32))
        return spans

    fr = FlightRecorder(root_dir, replica, retain=retain, config=config,
                        steps_fn=lambda: tel.step_ledger.snapshot(),
                        spans_fn=spans_fn, stats_fn=stats_fn)
    tel.flight = fr
    fr.install_atexit()
    return fr


def attach_router_flight_recorder(
        root_dir: str, *, retain: int = 8,
        config: Optional[dict] = None,
        stats_fn: Optional[Callable[[], dict]] = None,
        spans_fn: Optional[Callable[[], list]] = None,
        ) -> Optional[FlightRecorder]:
    """The process fleet router's capture sink, replica -1 (its
    ``replica--1/`` directory sorts apart from the workers' in the shared
    root): poison quarantines and corrupt-KV rejections are router
    verdicts. None when ``root_dir`` is empty."""
    if not root_dir:
        return None
    return FlightRecorder(root_dir, -1, retain=retain, config=config,
                          spans_fn=spans_fn, stats_fn=stats_fn)


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
    ``decode_stall_during_prefill_s`` (wall of one prefill dispatch,
    batched, single or one chunk, up to its synced output, while decode
    lanes were bound: the stall hybrid steps remove),
    ``decode_launch_s`` (host wall of one decode call from its entry
    until its last operation, the readback copy, is queued: the launch
    alone, before the host blocks) and ``decode_launch_cpu`` (the engine
    thread's CPU seconds over the same intervals, ``time.thread_time``:
    below the wall the thread was off the CPU while launching, waiting
    for the GIL, descheduled or blocked in a CUDA call; the counter
    says how long, not why),
    ``kv_swap_s`` (host wall of one host-tier page batch copy),
    ``spec_accept_rate`` (acceptance per lane per spec round) and
    ``spec_gamma_g`` (mean adaptive γ of the latest verify round).
    Request phases (engine/scheduler.py at finish): ``queue_wait_s``,
    ``prefill_phase_s``, ``decode_phase_s``, ``ttft_s``, ``e2e_s``.
    ``step_ledger``: one record per dispatch (engine._ledger_push),
    graded by ``cost_model`` in ``steps_report``. ``device_clock``: on
    the card, the dispatches' device time from CUDA events
    (``DeviceClock``, bound in ``bind_engine``; None on the CPU), behind
    ``tpu_inf_device_dispatch_seconds_total`` and
    ``tpu_inf_device_gap_seconds_total`` and the ledger's ``device_s``.
    ``recorder``: the replica's span sink (the owning EngineGroup stamps its replica
    index). ``slo``: the rolling TTFT/TPOT windows, bound in
    ``bind_engine``. ``flight``: the crash flight recorder, attached by
    the owning EngineGroup when the operator set a blackbox directory.
    ``enabled`` defaults to ``TPU_INF_TELEMETRY`` != "0".
    """

    def __init__(self, engine=None, enabled: Optional[bool] = None):
        self.enabled = telemetry_enabled() if enabled is None else enabled
        self.registry = r = Registry()
        self.recorder = SpanRecorder(enabled=self.enabled)
        self.slo: Optional[SLOTracker] = None
        # Sized and bound in bind_engine.
        self.step_ledger = NULL_LEDGER
        self.cost_model: Optional[StepCostModel] = None
        self.flight: Optional[FlightRecorder] = None
        self.device_clock: Optional[DeviceClock] = None
        if not self.enabled:
            for attr in PHASE_HISTOGRAMS.values():
                setattr(self, attr, NULL_METRIC)
            for attr in ("decode_dispatches", "prefill_dispatches",
                         "hybrid_steps", "spec_gamma_g",
                         "kv_offload_pages", "kv_restore_pages",
                         "kv_offload_bytes", "kv_restore_bytes",
                         "decode_launch_s", "decode_launch_cpu",
                         "decode_graph_replays", "decode_graph_eager"):
                setattr(self, attr, NULL_METRIC)
            return
        register_span_ring(r, self.recorder)
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
            "Wall time bound decode lanes sat stalled behind one prefill "
            "dispatch (batched, single or one chunk of a long prompt, up "
            "to its synced first tokens; structurally zero while hybrid "
            "steps fuse chunks into the decode dispatch; pressure-"
            "degraded rounds chunk serially and record their real stalls)")
        self.decode_launch_s = r.histogram(
            "tpu_inf_decode_launch_seconds",
            "Host wall of one decode call from its entry until its last "
            "operation (the readback copy) is queued, before the host "
            "blocks on it")
        self.decode_launch_cpu = r.counter(
            "tpu_inf_decode_launch_cpu_seconds_total",
            "Engine-thread CPU seconds (thread_time) over the decode "
            "calls' launch walls; below the wall the thread was off the "
            "CPU while launching (GIL wait, descheduled or a blocking "
            "CUDA call): how long, not why")
        self.decode_graph_replays = r.counter(
            "tpu_inf_decode_graph_replays_total",
            "Decode calls served by replaying a captured CUDA graph "
            "(engine/decode_graphs.py)")
        self.decode_graph_eager = r.counter(
            "tpu_inf_decode_graph_eager_total",
            "Decode calls eligible for a graph (greedy, no penalty, on "
            "an engine with graphs) that ran eager: no graph was "
            "captured for their (rung, steps)")
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
        """The step ledger (``step_ledger_depth`` records) and its cost
        model, and read-through metrics over state the engine already
        tracks."""
        if not self.enabled:
            return
        self.step_ledger = StepLedger(engine.engine_cfg.step_ledger_depth)
        self.cost_model = StepCostModel.from_engine(engine)
        r = self.registry
        if engine.device.type == "cuda":
            import torch

            self.device_clock = DeviceClock(
                lambda: torch.cuda.Event(enable_timing=True),
                r.counter("tpu_inf_device_dispatch_seconds_total",
                          "Device seconds of the engine's dispatches "
                          "(prefill, decode, hybrid, verify), CUDA events "
                          "before the first queued operation and after the "
                          "last"),
                r.counter("tpu_inf_device_gap_seconds_total",
                          "Device seconds from one dispatch's end event to "
                          "the next one's start while a sequence was "
                          "bound: the card idle, or busy outside the "
                          "engine's dispatches"),
                depth=engine.engine_cfg.decode_pipeline_depth + 16,
                stream=torch.cuda.current_stream(engine.device))
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
        # Drain-time KV migration to and from sibling replicas (zero in
        # the in-process fleet; exported so both backends' shapes match).
        r.counter("tpu_inf_kv_migrate_out_pages_total",
                  "KV pages exported at drain for migration to a "
                  "sibling replica",
                  fn=lambda: engine.migrate_out_pages)
        r.counter("tpu_inf_kv_migrate_out_bytes_total",
                  "Bytes exported at drain for KV migration",
                  fn=lambda: engine.migrate_out_bytes)
        r.counter("tpu_inf_kv_migrate_in_pages_total",
                  "Migrated KV pages adopted into this replica's host "
                  "tier",
                  fn=lambda: engine.migrate_in_pages)
        r.counter("tpu_inf_kv_migrate_in_bytes_total",
                  "Bytes adopted into the host tier by KV migration",
                  fn=lambda: engine.migrate_in_bytes)
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
        # Rolling SLO gauges: exact TTFT/TPOT quantiles over the last
        # SLO_WINDOW requests and breach counters against the
        # --slo-ttft-ms / --slo-tpot-ms targets.
        ecfg = engine.engine_cfg
        slo = self.slo = SLOTracker(ecfg.slo_ttft_ms / 1e3,
                                    ecfg.slo_tpot_ms / 1e3)
        for q in SLO_QUANTILES:
            r.gauge("tpu_inf_slo_ttft_seconds",
                    "Rolling exact TTFT quantile over the last "
                    f"{SLO_WINDOW} requests (NaN = no data)",
                    fn=lambda q=q: slo.gauge_value("ttft", q),
                    q=f"{q:g}")
            r.gauge("tpu_inf_slo_tpot_seconds",
                    "Rolling exact TPOT quantile over the last "
                    f"{SLO_WINDOW} requests (NaN = no data)",
                    fn=lambda q=q: slo.gauge_value("tpot", q),
                    q=f"{q:g}")
        r.counter("tpu_inf_slo_breaches_total",
                  "Finished requests whose TTFT exceeded --slo-ttft-ms "
                  "(never counts while no target is set)",
                  fn=lambda: slo.ttft_breaches, slo="ttft")
        r.counter("tpu_inf_slo_breaches_total",
                  "Finished requests whose TPOT exceeded --slo-tpot-ms "
                  "(never counts while no target is set)",
                  fn=lambda: slo.tpot_breaches, slo="tpot")

    def bind_spec(self, engine) -> None:
        """Read-through speculative-decoding counters (bound only when
        speculation is on, so other servers expose no dead series)."""
        if not self.enabled:
            return
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
        if not self.enabled:
            return
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
        """Read-through metrics over SchedulerStats counters, and the MFU
        gauge: decoded tokens/s x 2 x params over the card's bf16 peak
        (engine/autosize.py; the CPU reports against the H100 SXM). The
        rate is a dt-weighted EWMA (~30 s time constant) stepped at each
        token event (``note_tokens``, from the scheduler) and decayed to
        the moment of reading, so its value depends on neither who
        collects nor how often."""
        if not self.enabled:
            return
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
        from tpu_inference_torch.engine import autosize

        engine = sched.engine
        peak = autosize.detect_peak_flops(engine.device)
        tau_s = 30.0
        state = {"t": time.perf_counter(), "rate": 0.0}
        # The EWMA's wall-clock origin: /debug/steps replays the gauge's
        # smoothing over the ledger's timestamps from the same point.
        self._mfu_bind_unix = time.time()

        def _note(n: int) -> None:
            # One EWMA step per token event at its own time: the
            # arithmetic _ledger_mfu_ewma replays over the ledger's
            # records, so the two agree however the scrapes fall.
            now = time.perf_counter()
            dt = max(1e-6, now - state["t"])
            alpha = 1.0 - math.exp(-dt / tau_s)
            state["rate"] += alpha * (n / dt - state["rate"])
            state["t"] = now

        def _mfu() -> float:
            dt = time.perf_counter() - state["t"]
            decay = math.exp(-dt / tau_s) if dt > 1e-3 else 1.0
            return state["rate"] * decay * 2 * engine.n_params / peak

        self._mfu_note = _note

        self._mfu_gauge = r.gauge(
            "tpu_inf_mfu_estimate",
            "Estimated model FLOPs utilization (EWMA decode tokens/s "
            "x 2 x params / card bf16 peak, ~30s time constant)",
            fn=_mfu)

    def note_tokens(self, n: int) -> None:
        """``n`` tokens were generated now: one step of the MFU gauge's
        EWMA (a no-op with telemetry off or no scheduler bound)."""
        note = getattr(self, "_mfu_note", None)
        if note is not None and n > 0:
            note(n)

    def mfu_estimate(self) -> Optional[float]:
        """The MFU gauge's value (None when telemetry is off or no
        scheduler is bound). 12 decimals: a tiny CPU model against the
        card's peak sits near 1e-9, and the /debug/steps agreement needs
        the ratio, not a pair rounded to zero."""
        g = getattr(self, "_mfu_gauge", None)
        return round(g.collect_value(), 12) if g is not None else None

    def steps_report(self, window_s: float = 60.0) -> Dict[str, Any]:
        """This replica's step attribution (GET /debug/steps)."""
        if not self.enabled or self.cost_model is None:
            return {"enabled": False}
        return roofline_report(
            self.step_ledger, self.cost_model,
            mfu_gauge=self.mfu_estimate(),
            bind_unix=getattr(self, "_mfu_bind_unix", None),
            window_s=window_s)

    def request_finished(self, reason: str) -> None:
        """Per-finish-reason counter (lazy label children)."""
        if not self.enabled:
            return
        self.registry.counter(
            "tpu_inf_requests_finished_total",
            "Finished requests by terminal reason",
            reason=reason or "unknown").inc()

    def phase_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON dump of the phase histograms (/metrics?format=json; empty
        when telemetry is off)."""
        if not self.enabled:
            return {}
        return {key: getattr(self, attr).phase_snapshot()
                for key, attr in PHASE_HISTOGRAMS.items()}
