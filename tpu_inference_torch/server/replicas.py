"""The replica facade the HTTP layer talks to, at dp=1.

Twin of ``tpu_inference/server/replicas.py``'s ``EngineGroup`` for one
in-process replica: submit and cancel through its scheduler, a health
state machine driven by step failures, a step watchdog, admission
control, engine fault injection at run time (``apply_chaos``), the
health snapshot behind /healthz, the Prometheus page behind /metrics,
embeddings (``embed_many``), the step-ledger report behind /debug/steps
and the profiler capture behind /debug/profile. Several replicas and
resubmission on another replica are ROADMAP items 1.15 and 1.16.

Request observability at dp=1, as the reference's EngineGroup: the
router's own span recorder (replica -1) holds each request's root
``request`` span and its ``route`` span, and the engine's recorder the
phase spans; /debug/trace joins the two (``trace_snapshot``,
``trace_chrome``), /debug/requests reads the scheduler's timelines
(``recent_snapshot``). The route peeks the prefix cache as the
reference's prefix-affinity router does for its one candidate, so the
timelines' routing keys carry the reference's values. The fleet SLO
gauges pool the replica's windows; with ``ServerConfig.blackbox_dir``
set, a flight recorder captures on step errors, watchdog trips and
exit (``blackbox_index`` behind /debug/blackbox).

Health: healthy -> degraded (one failed step) -> quarantined
(``quarantine_after_failures`` in a row) -> recovered (after
``quarantine_cooldown_s``) -> healthy (one clean step). A quarantined
replica takes no requests (HTTP 503 with Retry-After).

Step watchdog (``ServerConfig.step_watchdog_s`` > 0): a monitor thread
quarantines the replica whose prefill/decode dispatch has been in flight
longer than the deadline (a wedged card or call) and finishes its
requests at once with reason "unavailable" (there is no other replica to
resubmit them to); whatever the wedged engine thread does when it wakes
reaches no client. The same thread runs the quarantine cooldown.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import ServerConfig
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.prefix_cache import _chain_hashes
from tpu_inference_torch.engine.scheduler import EngineScheduler


class AdmissionError(RuntimeError):
    """Request rejected before submission; carries the Retry-After hint."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class FleetSaturated(AdmissionError):
    """The replica is at the admission queue cap (HTTP 429)."""


class FleetUnavailable(AdmissionError):
    """No routable replica — quarantined (HTTP 503)."""


HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
RECOVERED = "recovered"


class ReplicaHealth:
    """Per-replica health state machine (thread-safe)."""

    def __init__(self, cfg: ServerConfig):
        self.cfg = cfg
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.wedges = 0                 # watchdog firings
        self.quarantines = 0
        self.since = time.monotonic()
        self._lock = threading.Lock()

    def _transition(self, state: str) -> None:
        if state == QUARANTINED and self.state != QUARANTINED:
            self.quarantines += 1
        if state != self.state:
            self.state = state
            self.since = time.monotonic()

    def on_ok(self) -> None:
        if self.state == HEALTHY and self.consecutive_failures == 0:
            return
        with self._lock:
            self.consecutive_failures = 0
            if self.state in (DEGRADED, RECOVERED):
                self._transition(HEALTHY)

    def on_error(self) -> None:
        with self._lock:
            self.consecutive_failures += 1
            if (self.state == RECOVERED or self.consecutive_failures
                    >= self.cfg.quarantine_after_failures):
                self._transition(QUARANTINED)
            elif self.state == HEALTHY:
                self._transition(DEGRADED)

    def mark_wedged(self) -> bool:
        """Watchdog deadline exceeded. True only on the transition, so
        the caller fails the stranded requests exactly once."""
        with self._lock:
            if self.state == QUARANTINED:
                return False
            self.wedges += 1
            self._transition(QUARANTINED)
            return True

    def maybe_recover(self) -> None:
        """QUARANTINED -> RECOVERED after the cooldown (the caller does
        not ask while the replica's dispatch is still wedged)."""
        with self._lock:
            if (self.state == QUARANTINED
                    and time.monotonic() - self.since
                    >= self.cfg.quarantine_cooldown_s):
                self._transition(RECOVERED)

    @property
    def routable(self) -> bool:
        self.maybe_recover()
        return self.state != QUARANTINED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "wedges": self.wedges,
                "quarantines": self.quarantines,
                "state_age_s": round(time.monotonic() - self.since, 3),
            }


@dataclasses.dataclass
class _Tracked:
    """Group-side state of one submitted request: the caller's
    callbacks, whether the watchdog already finished it (then the engine
    thread's late callbacks are dropped), the tokens forwarded and the
    submit time (the root span's)."""

    seq: Sequence
    on_token: Callable
    on_finish: Callable
    orphaned: bool = False
    delivered: int = 0
    t_submit: float = 0.0


def _ghost(seq: Sequence, reason: str) -> Sequence:
    """A finished copy of the client's request fields (nothing the engine
    thread still holds), for a terminal callback on another thread."""
    out = Sequence(request_id=seq.request_id,
                   prompt_tokens=list(seq.prompt_tokens),
                   max_new_tokens=seq.max_new_tokens,
                   temperature=seq.temperature, top_p=seq.top_p,
                   top_k=seq.top_k, seed=seq.seed,
                   repeat_penalty=seq.repeat_penalty,
                   repeat_last_n=seq.repeat_last_n,
                   eos_token_id=seq.eos_token_id, trace_id=seq.trace_id,
                   priority_class=seq.priority_class)
    out.done, out.finish_reason = True, reason
    out.finish_time = time.perf_counter()
    return out


class EngineGroup:
    """One engine + scheduler behind the facade the server calls."""

    def __init__(self, engines: List[InferenceEngine],
                 server_cfg: Optional[ServerConfig] = None):
        if len(engines) != 1:
            raise NotImplementedError(
                "the port serves one replica (dp=1); several replicas are "
                "ROADMAP 1.15/1.16")
        self.engines = engines
        self.server_cfg = server_cfg or ServerConfig()
        self.schedulers = [EngineScheduler(e) for e in engines]
        self.health = [ReplicaHealth(self.server_cfg) for _ in engines]
        for sched, health in zip(self.schedulers, self.health):
            sched.on_step_ok = health.on_ok
            sched.on_step_error = lambda exc, h=health: h.on_error()
        self.requests_shed = 0
        self.requests_unavailable = 0
        self._tracked: Dict[int, _Tracked] = {}
        self._lock = threading.Lock()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        # The router's spans (request root, route); the engines' phase
        # spans carry their replica index.
        self._recorder = telemetry.SpanRecorder(replica=-1)
        for i, e in enumerate(engines):
            e.telemetry.recorder.replica = i
        self._fleet_registry = telemetry.Registry()
        telemetry.register_span_ring(self._fleet_registry, self._recorder)
        self._fleet_registry.counter(
            "tpu_inf_requests_shed_total",
            "Requests rejected with 429 at the admission queue cap",
            fn=lambda: self.requests_shed)
        self._fleet_registry.counter(
            "tpu_inf_requests_unavailable_total",
            "Requests rejected with 503 (no routable replica)",
            fn=lambda: self.requests_unavailable)
        # The reference's supervision series (its EngineGroup at dp=1).
        # The port resubmits nothing (failover is ROADMAP 1.15), so the
        # retry and failover counters stay at 0.
        self.retries_attempted = 0
        self.retries_succeeded = 0
        self.failovers = 0
        r = self._fleet_registry
        r.gauge("tpu_inf_replicas", "Configured dp replicas",
                fn=lambda: len(self.engines))
        r.counter("tpu_inf_retries_attempted_total",
                  "Failover resubmissions attempted",
                  fn=lambda: self.retries_attempted)
        r.counter("tpu_inf_retries_succeeded_total",
                  "Failover resubmissions that finished cleanly",
                  fn=lambda: self.retries_succeeded)
        r.counter("tpu_inf_failovers_total",
                  "Requests stranded by a wedged replica and resubmitted",
                  fn=lambda: self.failovers)
        for i, health in enumerate(self.health):
            r.gauge("tpu_inf_replica_routable",
                    "1 when the replica accepts traffic (not quarantined)",
                    fn=lambda h=health: float(h.routable), replica=str(i))
            r.counter("tpu_inf_replica_quarantines_total",
                      "Entries into the quarantined state",
                      fn=lambda h=health: h.quarantines, replica=str(i))
            r.counter("tpu_inf_replica_wedges_total",
                      "Step-watchdog firings (wedged dispatches)",
                      fn=lambda h=health: h.wedges, replica=str(i))
        eng = engines[0]
        kw = dict(backend=eng.device.type, fleet=self.server_cfg.fleet,
                  kv_quant=eng.engine_cfg.kv_quant,
                  spec_mode=eng.spec_mode if eng.spec_enabled else "off",
                  routing=self.server_cfg.routing)
        telemetry.emit_build_info(self._fleet_registry, **kw)
        telemetry.emit_build_info(eng.telemetry.registry, **kw)
        # Fleet SLO gauges: exact quantiles pooled over the replicas'
        # windows (the per-replica series render under replica="i").
        telemetry.register_fleet_slo(
            r, self._pooled_slo_quantile,
            lambda k: sum(getattr(e.telemetry.slo, f"{k}_breaches", 0)
                          for e in self.engines
                          if e.telemetry.slo is not None))
        if self.server_cfg.blackbox_dir:
            for i, (e, s) in enumerate(zip(self.engines, self.schedulers)):
                telemetry.attach_flight_recorder(
                    e.telemetry, self.server_cfg.blackbox_dir, i,
                    retain=self.server_cfg.blackbox_retain,
                    config=dataclasses.asdict(self.server_cfg),
                    stats_fn=lambda s=s, e=e: s.stats.snapshot(e))

    def _pooled_slo_quantile(self, which: str, q: float) -> float:
        windows = []
        for e in self.engines:
            slo = e.telemetry.slo
            if slo is not None:
                ring = slo.ttft if which == "ttft" else slo.tpot
                windows.append(ring.values())
        v = telemetry.pooled_quantile(windows, q)
        return float("nan") if v is None else v

    def _fleet_slo(self) -> dict:
        return telemetry.pooled_slo(
            [e.telemetry.slo.snapshot() for e in self.engines
             if e.telemetry.slo is not None])

    @property
    def engine(self) -> InferenceEngine:
        return self.engines[0]

    def warmup(self) -> float:
        return sum(e.warmup() for e in self.engines)

    def start(self) -> "EngineGroup":
        for s in self.schedulers:
            s.start()
        self._watch_stop.clear()
        self._watch_thread = threading.Thread(
            target=self._watch, name="replica-watchdog", daemon=True)
        self._watch_thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self._watch_stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5.0)
            self._watch_thread = None
        for s in self.schedulers:
            s.stop(drain=drain, timeout=timeout)
        for e in self.engines:
            if e.telemetry.flight is not None:
                e.telemetry.flight.close()

    # ------------------------------------------------------- supervision

    def _watch_interval(self) -> float:
        cfg = self.server_cfg
        interval = 0.25
        if cfg.step_watchdog_s > 0:
            interval = min(interval, cfg.step_watchdog_s / 5)
        if cfg.quarantine_cooldown_s > 0:
            interval = min(interval, max(0.05, cfg.quarantine_cooldown_s / 5))
        return max(0.02, interval)

    def _wedged(self, sched: EngineScheduler) -> bool:
        wd = self.server_cfg.step_watchdog_s
        t0 = sched.step_inflight_since
        return wd > 0 and t0 is not None and time.monotonic() - t0 > wd

    def _watch(self) -> None:
        """Monitor thread: watchdog deadlines and quarantine cooldowns."""
        interval = self._watch_interval()
        while not self._watch_stop.wait(interval):
            for sched, health in zip(self.schedulers, self.health):
                if self._wedged(sched):
                    if health.mark_wedged():
                        flight = sched.engine.telemetry.flight
                        if flight is not None:
                            # The wedged dispatch's records are still the
                            # newest in the ledger.
                            flight.capture("watchdog")
                        self._fail_stranded(sched)
                else:
                    health.maybe_recover()

    def _routable(self, i: int) -> bool:
        """Replica ``i`` takes requests; a cooled-down quarantine recovers
        here too (lazily), unless the replica is still wedged."""
        health = self.health[i]
        if self._wedged(self.schedulers[i]):
            return health.state != QUARANTINED
        return health.routable

    def _fail_stranded(self, sched: EngineScheduler) -> None:
        """The watchdog quarantined the replica mid-dispatch: its engine
        thread may stay stuck, so its requests cannot finish through
        callbacks. Finish them now with "unavailable" (no other replica
        to resubmit them to) and cancel the originals, so the engine
        thread reaps them when it wakes; their late callbacks are
        dropped."""
        with self._lock:
            stranded = list(self._tracked.values())
            self._tracked.clear()
            for entry in stranded:
                entry.orphaned = True
        for entry in stranded:
            sched.cancel(entry.seq.request_id)
            telemetry.log_event(
                "request_failover", level="warning",
                request_id=entry.seq.trace_id or str(entry.seq.request_id),
                resubmitted=False)
            self._finish_trace(entry, "unavailable")
            entry.on_finish(_ghost(entry.seq, "unavailable"))

    def _finish_trace(self, entry: _Tracked, reason: str) -> None:
        """The terminal end of a tracked request: the router's root span
        (submit -> terminal) and its seal. The engine's recorder sealed
        the phase spans at the scheduler's finish."""
        tid = entry.seq.trace_id or str(entry.seq.request_id)
        self._recorder.add("request", tid, entry.t_submit
                           or time.perf_counter(), time.perf_counter(),
                           parent="", reason=reason, attempts=0,
                           output_tokens=entry.delivered)
        self._recorder.seal(tid)

    def _route_hit_pages(self, sched: EngineScheduler,
                         seq: Sequence) -> tuple:
        """(hbm, host, fabric) prefix-cache pages the reference's
        prefix-affinity router peeks for its one candidate: the most
        recent max_context-1 prompt tokens, never the final one (its
        logits are always recomputed). The digests are kept on the
        Sequence for admission's lookup. The port has no KV fabric."""
        pc = sched.engine.prefix_cache
        if self.server_cfg.routing != "prefix_affinity" or pc is None:
            return (0, 0, 0)
        ecfg = sched.engine.engine_cfg
        prompt_len = min(len(seq.prompt_tokens), ecfg.max_context - 1)
        cap = (prompt_len - 1) // ecfg.page_size
        if cap <= 0:
            return (0, 0, 0)
        if seq.prefix_digests is None:
            seq.prefix_digests = _chain_hashes(
                seq.prompt_tokens[-prompt_len:], ecfg.page_size)
        hbm, host = pc.peek_digests_tiered(seq.prefix_digests[:cap])
        return (hbm, host, 0)

    def _retry_after(self) -> float:
        return self.server_cfg.retry_after_s

    def submit(self, seq: Sequence, on_token: Callable,
               on_finish: Callable) -> None:
        """Submit to the replica; raises FleetUnavailable (quarantined)
        or FleetSaturated (admission queue cap) instead of queueing."""
        if not seq.trace_id:
            seq.trace_id = uuid.uuid4().hex[:16]
        sched = self.schedulers[0]
        if not self._routable(0):
            self.requests_unavailable += 1
            raise FleetUnavailable("all replicas quarantined",
                                   self._retry_after())
        t_route = time.perf_counter()
        hbm, host, fabric = self._route_hit_pages(sched, seq)
        self._recorder.add("route", seq.trace_id, t_route,
                           time.perf_counter(), dest=0, hbm_hit=hbm,
                           host_hit=host, fabric_hit=fabric)
        cap = self.server_cfg.admission_queue_depth
        if cap > 0 and sched.load >= cap:
            self.requests_shed += 1
            # A shed is terminal: seal the route span, so sustained
            # overload cannot fill the open table and evict live traces.
            self._recorder.seal(seq.trace_id)
            raise FleetSaturated(
                f"admission queue cap reached ({sched.load} >= {cap})",
                self._retry_after())
        seq.routed_replica = 0
        seq.route_hit_pages = hbm + host + fabric
        seq.route_host_hit_pages = host
        seq.route_fabric_hit_pages = fabric
        entry = _Tracked(seq, on_token, on_finish,
                         t_submit=time.perf_counter())

        def token(s: Sequence, tok: int) -> None:
            if not entry.orphaned:
                entry.delivered += 1
                entry.on_token(s, tok)

        def finish(s: Sequence) -> None:
            with self._lock:
                if entry.orphaned:
                    return
                self._tracked.pop(s.request_id, None)
            self._finish_trace(entry, s.finish_reason)
            entry.on_finish(s)

        with self._lock:
            self._tracked[seq.request_id] = entry
        sched.submit(seq, token, finish)

    def embed_many(self, batch) -> "np.ndarray":  # noqa: F821
        """Embeddings on the replica (the reference picks the least
        loaded one); FleetUnavailable when it is quarantined, counted
        with the generate 503s."""
        if not self._routable(0):
            with self._lock:
                self.requests_unavailable += 1
            raise FleetUnavailable("all replicas quarantined",
                                   self._retry_after())
        return self.engines[0].embed_many(batch)

    def steps_snapshot(self) -> dict:
        """Step-ledger attribution (GET /debug/steps): per-replica
        verdicts and the merged report (at dp=1 the merge of one)."""
        reports = {str(i): e.telemetry.steps_report()
                   for i, e in enumerate(self.engines)}
        return {"replicas": reports,
                "fleet": telemetry.merge_steps_reports(
                    list(reports.values()))}

    def recent_snapshot(self, n: int) -> List[dict]:
        """The latest ``n`` request timelines (GET /debug/requests),
        ordered by finish time."""
        items: List[dict] = []
        for s in self.schedulers:
            items.extend(s.recent_snapshot(n))
        items.sort(key=lambda t: t.get("finished_unix", 0.0))
        return items[-n:]

    def _trace_spans(self, trace_id: str) -> List[dict]:
        spans = self._recorder.get_trace(trace_id) or []
        for e in self.engines:
            spans.extend(e.telemetry.recorder.get_trace(trace_id) or ())
        return spans

    def trace_snapshot(self, trace_id: str) -> Optional[dict]:
        """One request's span tree (GET /debug/trace?id=): the router's
        spans and the replica's, joined; None when neither holds it."""
        spans = self._trace_spans(trace_id)
        if not spans:
            return None
        return telemetry.assemble_trace(trace_id, spans)

    def trace_chrome(self, n: int = 128) -> dict:
        """The latest ``n`` sealed traces as Chrome trace-event JSON (GET
        /debug/trace?format=chrome): pid 0 the router's spans, pid i+1
        replica i's, and each replica's maintenance lane."""
        traces = {tid: self._trace_spans(tid)
                  for tid in self._recorder.recent_traces(n)}
        maintenance: List[dict] = []
        for e in self.engines:
            maintenance.extend(e.telemetry.recorder.maintenance_spans())
        return telemetry.spans_to_chrome(
            traces,
            {0: "router", **{i + 1: f"replica {i}"
                             for i in range(len(self.engines))}},
            maintenance=maintenance,
            other_data={"fleet": self.server_cfg.fleet,
                        "spans_dropped": self._recorder.spans_dropped})

    def blackbox_index(self) -> dict:
        """The flight recorder's captures (GET /debug/blackbox)."""
        return telemetry.blackbox_index(self.server_cfg.blackbox_dir)

    def capture_profile(self, replica: int, seconds: float) -> dict:
        """POST /debug/profile {"seconds": N}: a torch.profiler capture
        in this process (the replica argument names the trace dir)."""
        return telemetry.capture_torch_profile(
            self.server_cfg.profile_dir, replica, seconds)

    def apply_chaos(self, body: dict) -> dict:
        """Arm/disarm engine fault injection (POST /debug/chaos):
        ``{"replica": i | null, "step_failure_rate": p, "step_wedge_s": s,
        "page_pressure": n}``, null replica = every replica. Process
        kills ("kill") need a process fleet (ROADMAP 1.15). Raises
        ValueError/IndexError/TypeError on a bad spec (HTTP 400). Returns
        the settings now in effect."""
        if body.get("kill") is not None:
            raise ValueError(
                "'kill' chaos (kill9/sigterm) needs --fleet subprocess; "
                "the in-process fleet simulates faults via "
                "step_failure_rate / step_wedge_s / page_pressure")
        engines = self.engines
        replica = body.get("replica")
        targets = engines if replica is None else [engines[int(replica)]]
        rate = body.get("step_failure_rate")
        wedge = body.get("step_wedge_s")
        pressure = body.get("page_pressure")
        for eng in targets:
            if rate is not None:
                eng.chaos_step_failure_rate = float(rate)
            if wedge is not None:
                eng.chaos_step_wedge_s = float(wedge)
            if pressure is not None:
                # Applied by the engine loop (the allocator is
                # engine-thread only), usually within milliseconds.
                eng.request_page_pressure(int(pressure))

        def _pp(e):
            t = e._pressure_target
            return e.chaos_page_pressure if t is None else t

        return {"replicas": [
            {"step_failure_rate": e.chaos_step_failure_rate,
             "step_wedge_s": e.chaos_step_wedge_s,
             "page_pressure": _pp(e)} for e in engines]}

    def cancel(self, request_id: int) -> None:
        # A request cancelled while queued never finishes through the
        # scheduler: release its entry here.
        with self._lock:
            self._tracked.pop(request_id, None)
        for s in self.schedulers:
            s.cancel(request_id)

    def health_snapshot(self) -> dict:
        replicas = []
        for h, e in zip(self.health, self.engines):
            d = h.snapshot()
            d["pool_pressure"] = round(e.pool_pressure, 4)
            d["device"] = str(e.device)
            if e.telemetry.slo is not None:
                d["slo"] = e.telemetry.slo.snapshot(include_window=False)
            replicas.append(d)
        routable = sum(1 for i in range(len(self.health))
                       if self._routable(i))
        status = ("unavailable" if routable == 0 else
                  "ok" if all(r["state"] == HEALTHY for r in replicas)
                  else "degraded")
        return {"status": status, "replicas": replicas,
                "slo": self._fleet_slo(),
                "supervision": {
                    "requests_shed": self.requests_shed,
                    "requests_unavailable": self.requests_unavailable,
                    "states": [h.state for h in self.health]}}

    def prometheus_text(self) -> str:
        groups = [({"replica": str(i)}, s.engine.telemetry.registry)
                  for i, s in enumerate(self.schedulers)]
        groups.append(({}, self._fleet_registry))
        return telemetry.render_prometheus(groups)

    def stats_snapshot(self) -> dict:
        """The replica's scheduler snapshot; at dp=1 it is the aggregate
        (its ``speculative`` block included when speculation is on), with
        the raw SLO windows stripped as the reference's aggregation
        does."""
        out = self.schedulers[0].stats.snapshot(self.engines[0])
        if isinstance(out.get("slo"), dict):
            out["slo"] = {k: v for k, v in out["slo"].items()
                          if not k.endswith("_window")}
        return out
