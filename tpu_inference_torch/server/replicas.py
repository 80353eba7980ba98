"""Data-parallel replica serving: dp engines behind one facade.

Twin of ``tpu_inference/server/replicas.py``. ``EngineGroup`` runs every
replica as an engine and scheduler thread of the server process (the
``--fleet in-process`` backend); ``server/fleet.py``'s
``ProcessEngineGroup`` runs each replica as its own worker process
behind a router (``--fleet subprocess``). The routing, failover and
admission rules below are the contract both backends implement, and
``aggregate_replica_stats`` is the one rule that folds their
per-replica stats.

Placement: replica i serves on ``cuda:{i % torch.cuda.device_count()}``
(server/http.py ``build_engine_group``), so on a one-card machine every
replica shares ``cuda:0``, each with its own weights, KV pool and
scheduler. The reference gives each replica its own devices.

Routing (``ServerConfig.routing``): "prefix_affinity" scores each
routable replica by the prefill work routing there would cost, the
prompt's pages minus its prefix-cache hits (a host-tier page at
``route_host_hit_weight``), plus ``route_load_pages`` per queued
request, with a pressure penalty that puts every pool under preemption
pressure behind the rest. When no replica holds any of the prompt (or
routing="least_loaded") the key is (pressure, load). Ties rotate. The
fourth temperature is the fleet KV fabric (``server/kv_fabric.py``):
pages the router's pool holds beyond a candidate's own warm depth score
at ``route_fabric_hit_weight``, and the routed replica pulls them into
its host tier before the request's prefill. Each engine with a prefix
cache publishes its settled prefix pages into the pool directly.

Supervision: each replica has a health state machine, healthy ->
degraded (one failed step) -> quarantined (``quarantine_after_failures``
in a row) -> recovered (after ``quarantine_cooldown_s``) -> healthy (one
clean step); a quarantined replica takes no requests. A step watchdog
(``step_watchdog_s`` > 0) quarantines a replica whose dispatch has been
in flight past the deadline and fails its requests over. A request that
errors before its first token is resubmitted from the prompt on another
replica (``failover_max_retries``); one that errored on
``poison_max_workers`` distinct replicas finishes "poison". Admission
control sheds load (FleetSaturated / FleetUnavailable -> HTTP 429 / 503
with Retry-After) instead of queueing to the request timeout.

Request observability: the router's own span recorder (replica -1)
holds each request's root ``request`` span and its ``route`` span, the
engines' recorders the phase spans; /debug/trace joins them. The fleet
SLO gauges pool the replicas' windows; with
``ServerConfig.blackbox_dir`` set, each replica gets a flight recorder.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import ServerConfig
from tpu_inference_torch.engine import kv_cache as kvc
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.prefix_cache import _chain_hashes
from tpu_inference_torch.engine.scheduler import EngineScheduler
from tpu_inference_torch.server import kv_fabric
from tpu_inference_torch.server.kv_fabric import (cold_route_key,
                                                  prefill_route_score)


class AdmissionError(RuntimeError):
    """Request rejected before submission; carries the Retry-After hint."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class FleetSaturated(AdmissionError):
    """Every routable replica is at the admission queue cap (HTTP 429)."""


class FleetUnavailable(AdmissionError):
    """No routable replica at all (HTTP 503)."""


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
        the caller fails the stranded requests over exactly once."""
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
        """Takes requests; a cooled-down quarantine recovers here (the
        group checks the state directly while a dispatch is wedged)."""
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


def _clone_request(seq: Sequence) -> Sequence:
    """A pristine copy of the client's request fields: engine state
    (slot, pages, generated, timings) starts fresh, so a failover attempt
    replays from the prompt like a new submit. The prompt's chain hashes
    are shared (a pure function of the tokens)."""
    return Sequence(
        request_id=seq.request_id,
        prompt_tokens=list(seq.prompt_tokens),
        max_new_tokens=seq.max_new_tokens,
        temperature=seq.temperature, top_p=seq.top_p, top_k=seq.top_k,
        seed=seq.seed, repeat_penalty=seq.repeat_penalty,
        repeat_last_n=seq.repeat_last_n, eos_token_id=seq.eos_token_id,
        trace_id=seq.trace_id,
        priority_class=seq.priority_class,
        prefix_digests=seq.prefix_digests)


def replica_device(device, replica: int) -> torch.device:
    """The device replica ``replica`` serves on: for a bare "cuda",
    ``cuda:{replica % device_count}`` (every replica shares the one card
    of a one-card machine); any other device as given. Without a card
    "cuda" stays "cuda", and building on it raises."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    return torch.device("cuda", replica % n) if n else dev


def shard_devices(device, replica: int, n: int) -> list:
    """The ``n`` devices of replica ``replica``'s shards (its tp * sp
    mesh, in build_mesh's order): replica_device of ``replica * n + i``,
    so shards wrap onto the visible cards as replicas do (one card:
    every shard of every replica shares it)."""
    return [replica_device(device, replica * n + i) for i in range(n)]


# Finish reasons a zero-delivery request may be resubmitted after.
_RETRYABLE = ("error",)


def routing_digests(seq: Sequence, page_size: int, max_context: int
                    ) -> Tuple[List[bytes], int]:
    """THE truncation rule for routing-time prefix digests, shared by
    every scoring site of both backends: the most recent max_context-1
    prompt tokens, never the final prompt token (its logits are always
    recomputed). Hashes the prompt once and caches the list on the
    Sequence. Returns (digests, prompt_pages)."""
    prompt_len = min(len(seq.prompt_tokens), max_context - 1)
    prompt_pages = kvc.pages_needed(prompt_len, page_size)
    cap = (prompt_len - 1) // page_size
    if cap <= 0:
        return [], prompt_pages
    if seq.prefix_digests is None:
        tokens = seq.prompt_tokens
        prompt = (tokens[-prompt_len:] if len(tokens) > prompt_len
                  else tokens)
        seq.prefix_digests = _chain_hashes(prompt, page_size)
    return seq.prefix_digests[:cap], prompt_pages


@dataclasses.dataclass
class _Tracked:
    """Group-side state of one request across attempts."""

    template: Sequence                  # pristine request for resubmission
    on_token: Callable
    on_finish: Callable
    sched: EngineScheduler
    delivered: int = 0                  # tokens forwarded to the caller
    attempts: int = 0                   # failover resubmissions so far
    generation: int = 0                 # bumped to orphan stale callbacks
    t_submit: float = 0.0               # perf_counter at submit
    # Distinct replicas whose attempt errored or wedged (the poison gate).
    failed_replicas: set = dataclasses.field(default_factory=set)


class EngineGroup:
    """dp engines and schedulers with prefix-affinity routing, health
    supervision, failover and admission control; at dp=1 a pass-through."""

    def __init__(self, engines: List[InferenceEngine],
                 server_cfg: Optional[ServerConfig] = None):
        if not engines:
            raise ValueError("EngineGroup needs at least one engine")
        self.engines = engines
        self.server_cfg = server_cfg or ServerConfig()
        self.schedulers = [EngineScheduler(e) for e in engines]
        self.health = [ReplicaHealth(self.server_cfg) for _ in engines]
        for sched, health in zip(self.schedulers, self.health):
            sched.on_step_ok = health.on_ok
            sched.on_step_error = lambda exc, h=health: h.on_error()
        self._tracked: Dict[int, _Tracked] = {}
        self._lock = threading.Lock()
        self.retries_attempted = 0
        self.retries_succeeded = 0
        self.failovers = 0              # stranded-by-wedge resubmissions
        self.requests_shed = 0          # 429: queue cap
        self.requests_unavailable = 0   # 503: no routable replica
        self.poison_requests = 0        # terminally quarantined
        # Routing accounting; plain ints (GIL-atomic increments, torn
        # reads tolerated).
        self._rr = 0                    # rotating tie-break cursor
        self.route_prefix_hits = 0
        self.route_cold = 0
        self.route_fabric_hits = 0      # dispatches that pulled fabric pages
        self._route_stats = [{"hits": 0, "cold": 0, "hit_pages": 0,
                              "host_hit_pages": 0,
                              "fabric_hit_pages": 0}
                             for _ in engines]
        # The fleet KV fabric: in-process, each engine publishes into the
        # pool by a direct call; a pull lands in the routed engine's host
        # tier through request_import_host before the dispatch.
        self.fabric = kv_fabric.FabricPool(self.server_cfg.fabric_cache_pages)
        for e in engines:
            if self.fabric.capacity > 0 and e.prefix_cache is not None:
                e.fabric_publish = self.fabric.put_pages
                e.fabric_publish_min_pages = \
                    self.server_cfg.fabric_publish_min_pages
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        # The router's spans (request root, route); the engines' phase
        # spans carry their replica index.
        self._recorder = telemetry.SpanRecorder(replica=-1)
        for i, e in enumerate(engines):
            e.telemetry.recorder.replica = i
        self._fleet_registry = telemetry.Registry()
        r = self._fleet_registry
        telemetry.register_span_ring(r, self._recorder)
        # The HTTP layer's token stream lag (server/http.py), beside the
        # supervision series, which are the reference's.
        self._http_registry = telemetry.Registry()
        self.stream_lag_s = telemetry.stream_lag_histogram(
            self._http_registry, self._recorder.enabled)
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
        r.counter("tpu_inf_requests_shed_total",
                  "Requests shed at the admission queue cap (HTTP 429)",
                  fn=lambda: self.requests_shed)
        r.counter("tpu_inf_requests_unavailable_total",
                  "Requests rejected with no routable replica (HTTP 503)",
                  fn=lambda: self.requests_unavailable)
        r.counter("tpu_inf_poison_requests_total",
                  "Requests quarantined after crashing/wedging "
                  "poison_max_workers distinct replicas (HTTP 500)",
                  fn=lambda: self.poison_requests)
        r.counter("tpu_inf_kv_integrity_rejections_total",
                  "KV blobs rejected on a failed end-to-end digest "
                  "check (recompute fallback, never adopted silently)",
                  fn=lambda: sum(e.kv_integrity_rejections
                                 for e in self.engines)
                  + self.fabric.kv_rejections)
        r.counter("tpu_inf_route_prefix_hits_total",
                  "Dispatches routed with a non-zero prefix-cache peek "
                  "(the request landed on a warm replica)",
                  fn=lambda: self.route_prefix_hits)
        r.counter("tpu_inf_route_cold_total",
                  "Dispatches routed with no cached prefix on any scored "
                  "replica (least-loaded fallback)",
                  fn=lambda: self.route_cold)
        self._route_hit_pages_hist = r.histogram(
            "tpu_inf_route_hit_pages",
            "Peeked prefix-cache hit pages per warm-routed dispatch",
            buckets=telemetry.COUNT_BUCKETS)
        r.counter("tpu_inf_route_fabric_hits_total",
                  "Dispatches that pulled fabric pages into the routed "
                  "replica's host tier (fourth-temperature warmth)",
                  fn=lambda: self.route_fabric_hits)
        self._route_fabric_hit_pages_hist = r.histogram(
            "tpu_inf_route_fabric_hit_pages",
            "Fabric pages pulled per fabric-warm dispatch",
            buckets=telemetry.COUNT_BUCKETS)
        telemetry.register_fabric(r, self.fabric)
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
        # Fleet SLO gauges: exact quantiles pooled over the replicas'
        # windows (the per-replica series render under replica="i").
        telemetry.register_fleet_slo(
            r, self._pooled_slo_quantile,
            lambda k: sum(getattr(e.telemetry.slo, f"{k}_breaches", 0)
                          for e in self.engines
                          if e.telemetry.slo is not None))
        # The dashboard-join info gauge, on the fleet registry and every
        # replica's (config-pure labels, identical across replicas).
        eng = engines[0]
        kw = dict(backend=eng.device.type, fleet=self.server_cfg.fleet,
                  kv_quant=eng.engine_cfg.kv_quant,
                  spec_mode=eng.spec_mode if eng.spec_enabled else "off",
                  routing=self.server_cfg.routing)
        telemetry.emit_build_info(r, **kw)
        for e in engines:
            if e.telemetry.enabled:
                telemetry.emit_build_info(e.telemetry.registry, **kw)
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
        """Replica 0 (single-engine callers, the model card)."""
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
                        self._failover_stranded(sched)
                else:
                    health.maybe_recover()

    def _routable(self) -> List[EngineScheduler]:
        out = []
        for sched, health in zip(self.schedulers, self.health):
            # A cooled-down quarantine recovers here too (lazily), unless
            # the replica is still wedged.
            if not self._wedged(sched):
                health.maybe_recover()
            if health.state != QUARANTINED:
                out.append(sched)
        return out

    def _rotate(self, ties: list):
        """Rotating pick among equal-key candidates (min() alone would
        herd a burst of equal-load requests onto replica 0)."""
        if len(ties) == 1:
            return ties[0]
        idx = self._rr % len(ties)
        self._rr += 1
        return ties[idx]

    def _digests_for(self, seq: Sequence) -> Tuple[List[bytes], int]:
        ecfg = self.engines[0].engine_cfg
        return routing_digests(seq, ecfg.page_size, ecfg.max_context)

    def _pick(self, cands: List[EngineScheduler],
              seq: Optional[Sequence] = None
              ) -> Tuple[EngineScheduler, Tuple[int, int, int]]:
        """Choose a replica for one request: (scheduler, (hbm, host,
        fabric_extra) hit pages peeked on it). The fabric term counts the
        pages the pool holds beyond the candidate's own warm depth, from
        the router's own index."""
        cfg = self.server_cfg
        if seq is not None and cfg.routing == "prefix_affinity":
            digests, prompt_pages = self._digests_for(seq)
            fdepth = self.fabric.match_depth(digests)
            hits = []
            for sched in cands:
                pc = sched.engine.prefix_cache
                hits.append(pc.peek_digests_tiered(digests)
                            if pc is not None else (0, 0))
            if any(h + w for h, w in hits) or fdepth > 0:
                scored = []
                for sched, (hbm, host) in zip(cands, hits):
                    fx = kv_fabric.fabric_extra_pages(
                        fdepth, hbm + host, prompt_pages)
                    pressured = sched.engine.under_pressure
                    score = prefill_route_score(
                        cfg, prompt_pages=prompt_pages, hbm=hbm, host=host,
                        fabric=fx, load=sched.load, pressured=pressured)
                    scored.append(((score, pressured, sched.load),
                                   sched, (hbm, host, fx)))
                best = min(key for key, _, _ in scored)
                return self._rotate([(s, h) for key, s, h in scored
                                     if key == best])
        keyed = [(cold_route_key(sched.engine.under_pressure, sched.load),
                  sched) for sched in cands]
        best = min(key for key, _ in keyed)
        return self._rotate([(s, (0, 0, 0)) for key, s in keyed
                             if key == best])

    def _peek_replica(self, sched: EngineScheduler,
                      seq: Sequence) -> Tuple[int, int, int]:
        """One replica's peeked hit pages (accounting on paths that chose
        by load, e.g. the admission-cap fallback)."""
        pc = sched.engine.prefix_cache
        if self.server_cfg.routing != "prefix_affinity" or pc is None:
            return (0, 0, 0)
        digests, prompt_pages = self._digests_for(seq)
        hbm, host = pc.peek_digests_tiered(digests)
        fx = kv_fabric.fabric_extra_pages(
            self.fabric.match_depth(digests), hbm + host, prompt_pages)
        return (hbm, host, fx)

    def _retry_after(self) -> float:
        return self.server_cfg.retry_after_s

    def embed_many(self, batch) -> "np.ndarray":  # noqa: F821
        """Embeddings on the least-loaded routable replica; a fleet with
        none counts the 503 with the generate ones."""
        routable = self._routable()
        if not routable:
            with self._lock:
                self.requests_unavailable += 1
            raise FleetUnavailable("all replicas quarantined",
                                   self._retry_after())
        return self._pick(routable)[0].engine.embed_many(batch)

    # -------------------------------------------------------- submission

    def submit(self, seq: Sequence, on_token: Callable,
               on_finish: Callable) -> None:
        """Route to the best routable replica; raises FleetUnavailable (no
        routable replica) or FleetSaturated (admission queue cap) instead
        of queueing."""
        if not seq.trace_id:
            seq.trace_id = uuid.uuid4().hex[:16]
        routable = self._routable()
        if not routable:
            with self._lock:
                self.requests_unavailable += 1
            raise FleetUnavailable("all replicas quarantined",
                                   self._retry_after())
        t_route = time.perf_counter()
        sched, hit_pages = self._pick(routable, seq)
        self._recorder.add(
            "route", seq.trace_id, t_route, time.perf_counter(),
            dest=self.schedulers.index(sched),
            hbm_hit=hit_pages[0], host_hit=hit_pages[1],
            fabric_hit=hit_pages[2])
        cap = self.server_cfg.admission_queue_depth
        if cap > 0 and sched.load >= cap:
            # A warm pick can saturate while a cold sibling has room: fall
            # back to least-loaded before shedding.
            sched = self._pick(routable)[0]
            hit_pages = self._peek_replica(sched, seq)
            if sched.load >= cap:
                with self._lock:
                    self.requests_shed += 1
                # A shed is terminal: seal the route span, so sustained
                # overload cannot fill the open table.
                self._recorder.seal(seq.trace_id)
                raise FleetSaturated(
                    f"admission queue cap reached ({sched.load} >= {cap} "
                    "on the least-loaded replica)", self._retry_after())
        entry = _Tracked(template=_clone_request(seq), on_token=on_token,
                         on_finish=on_finish, sched=sched,
                         t_submit=time.perf_counter())
        with self._lock:
            self._tracked[seq.request_id] = entry
        self._dispatch(entry, seq, sched, hit_pages)

    def _dispatch(self, entry: _Tracked, seq: Sequence,
                  sched: EngineScheduler,
                  hit_pages: Tuple[int, int, int] = (0, 0, 0)) -> None:
        gen = entry.generation
        entry.sched = sched
        seq.attempt = entry.attempts
        idx = self.schedulers.index(sched)
        hbm_hit, host_hit, fabric_extra = hit_pages
        # The fabric pull: the pages the pool holds beyond this replica's
        # warm depth land in its host tier before the dispatch (the
        # engine loop applies pending imports ahead of admission). A
        # corrupt or since-evicted entry just shortens the run.
        fabric_pulled = 0
        if fabric_extra > 0:
            warm = hbm_hit + host_hit
            entries = self.fabric.get_pages(
                self._digests_for(seq)[0][warm:warm + fabric_extra])
            if entries:
                sched.engine.request_import_host(entries)
                sched.kick()
                fabric_pulled = len(entries)
        seq.routed_replica = idx
        seq.route_hit_pages = hbm_hit + host_hit + fabric_pulled
        seq.route_host_hit_pages = host_hit
        seq.route_fabric_hit_pages = fabric_pulled
        stats = self._route_stats[idx]
        if seq.route_hit_pages > 0:
            self.route_prefix_hits += 1
            stats["hits"] += 1
            stats["hit_pages"] += seq.route_hit_pages
            stats["host_hit_pages"] += host_hit
            self._route_hit_pages_hist.observe(seq.route_hit_pages)
        else:
            self.route_cold += 1
            stats["cold"] += 1
        if fabric_pulled > 0:
            self.route_fabric_hits += 1
            stats["fabric_hit_pages"] += fabric_pulled
            self._route_fabric_hit_pages_hist.observe(fabric_pulled)

        def tok(s: Sequence, t: int) -> None:
            if entry.generation != gen:     # stale attempt (failed over)
                return
            entry.delivered += 1
            entry.on_token(s, t)

        def fin(s: Sequence) -> None:
            self._attempt_finished(entry, s, gen)

        sched.submit(seq, tok, fin)

    def _retry_target(self, failed: EngineScheduler,
                      template: Optional[Sequence] = None
                      ) -> Optional[Tuple[EngineScheduler,
                                          Tuple[int, int, int]]]:
        """Replica for a failover resubmission and its peeked hit pages:
        never the one that just failed while another is routable."""
        routable = self._routable()
        others = [s for s in routable if s is not failed]
        pool = others or routable
        return self._pick(pool, template) if pool else None

    def _attempt_finished(self, entry: _Tracked, seq: Sequence,
                          gen: int) -> None:
        """Terminal or retryable end of one attempt (engine thread). The
        decision happens under one lock hold, so it cannot interleave
        with ``_failover_stranded`` deciding about the same entry."""
        rid = entry.template.request_id
        with self._lock:
            if entry.generation != gen:     # the watchdog took over
                return
            if seq.finish_reason in _RETRYABLE:
                entry.failed_replicas.add(
                    self.schedulers.index(entry.sched))
            limit = self.server_cfg.poison_max_workers
            poison = (seq.finish_reason in _RETRYABLE and limit > 0
                      and len(entry.failed_replicas) >= limit)
            retryable = (not poison
                         and seq.finish_reason in _RETRYABLE
                         and entry.delivered == 0
                         and entry.attempts
                         < self.server_cfg.failover_max_retries)
            target = (self._retry_target(entry.sched, entry.template)
                      if retryable else None)
            if target is not None:
                entry.attempts += 1
                entry.generation += 1
                self.retries_attempted += 1
            else:
                self._tracked.pop(rid, None)
                if poison:
                    self.poison_requests += 1
                if entry.attempts and seq.finish_reason in ("stop", "length"):
                    self.retries_succeeded += 1
        if target is not None:
            self._dispatch(entry, _clone_request(entry.template), *target)
            return
        if poison:
            telemetry.log_event(
                "poison_quarantined", level="error",
                request_id=entry.template.trace_id or str(rid),
                replicas=sorted(entry.failed_replicas),
                attempts=entry.attempts)
            seq.finish_reason = "poison"
        self._finish_trace(entry, seq.finish_reason)
        entry.on_finish(seq)

    def _finish_trace(self, entry: _Tracked, reason: str) -> None:
        """The router's root span (submit -> terminal) and the seal; the
        engines' recorders sealed the phase spans at finish."""
        t = entry.template
        tid = t.trace_id or str(t.request_id)
        self._recorder.add("request", tid, entry.t_submit or
                           time.perf_counter(), time.perf_counter(),
                           parent="", reason=reason,
                           attempts=entry.attempts,
                           output_tokens=entry.delivered)
        self._recorder.seal(tid)

    def _failover_stranded(self, sched: EngineScheduler) -> None:
        """The watchdog quarantined a replica mid-dispatch: its engine
        thread may stay stuck, so its requests are detached here and
        resubmitted (nothing delivered yet, budget left) or finished
        ("unavailable" with no other replica, "error" otherwise); the
        originals are cancelled so the stuck thread reaps them when it
        wakes."""
        actions = []
        with self._lock:
            limit = self.server_cfg.poison_max_workers
            for rid, entry in list(self._tracked.items()):
                if entry.sched is not sched:
                    continue
                entry.generation += 1
                entry.failed_replicas.add(self.schedulers.index(sched))
                poison = (limit > 0
                          and len(entry.failed_replicas) >= limit)
                target = self._retry_target(sched, entry.template)
                can_retry = (not poison
                             and entry.delivered == 0
                             and entry.attempts
                             < self.server_cfg.failover_max_retries
                             and target is not None)
                if can_retry:
                    entry.attempts += 1
                    self.retries_attempted += 1
                    self.failovers += 1
                else:
                    self._tracked.pop(rid, None)
                    if poison:
                        self.poison_requests += 1
                actions.append((rid, entry, can_retry, target, poison))
        for rid, entry, can_retry, target, poison in actions:
            sched.cancel(rid)
            telemetry.log_event(
                "request_failover", level="warning",
                request_id=entry.template.trace_id or str(rid),
                resubmitted=can_retry, attempts=entry.attempts)
            if can_retry:
                self._dispatch(entry, _clone_request(entry.template), *target)
                continue
            if poison:
                telemetry.log_event(
                    "poison_quarantined", level="error",
                    request_id=entry.template.trace_id or str(rid),
                    replicas=sorted(entry.failed_replicas),
                    attempts=entry.attempts)
            ghost = _clone_request(entry.template)
            ghost.done = True
            ghost.finish_reason = ("poison" if poison
                                   else "unavailable" if target is None
                                   else "error")
            ghost.finish_time = time.perf_counter()
            self._finish_trace(entry, ghost.finish_reason)
            entry.on_finish(ghost)

    def cancel(self, request_id: int) -> None:
        # A request cancelled while queued never finishes through the
        # scheduler: release its entry here.
        with self._lock:
            entry = self._tracked.pop(request_id, None)
            if entry is not None:
                entry.generation += 1       # silence in-flight callbacks
        if entry is not None:
            entry.sched.cancel(request_id)

    # ----------------------------------------------------- observability

    def annotate_request(self, trace_id: str, **attrs) -> None:
        """Attributes a later layer learns (the HTTP layer's write
        times) on the request's root span, once the router recorded it."""
        self._recorder.annotate(trace_id, "request", **attrs)

    def health_snapshot(self) -> dict:
        """/healthz: per-replica states, pool pressure, routing and tier
        views, the fleet status and the supervision counters."""
        replicas = []
        for i, (h, e) in enumerate(zip(self.health, self.engines)):
            d = h.snapshot()
            d["pool_pressure"] = round(e.pool_pressure, 4)
            d["under_pressure"] = e.under_pressure
            d["preemptions"] = e.preemptions_total
            d["routing"] = dict(self._route_stats[i])
            d["device"] = str(e.device)
            if e.telemetry.slo is not None:
                d["slo"] = e.telemetry.slo.snapshot(include_window=False)
            if e.host_pool is not None:
                d["host_cache"] = {
                    "capacity_pages": e.host_pool.capacity,
                    "pages_used": e.host_pool.used,
                    "offloaded": e.host_pool.offloaded_total,
                    "restored": e.host_pool.restored_total,
                    "evicted": e.host_pool.evicted_total,
                    "swap_in_resumes": e.swap_in_resumes,
                }
            replicas.append(d)
        routable = len(self._routable())
        if routable == 0:
            status = "unavailable"
        elif all(r["state"] == HEALTHY for r in replicas):
            status = "ok"
        else:
            status = "degraded"
        return {
            "status": status,
            "fleet": "in-process",
            "routing": self.server_cfg.routing,
            "replicas": replicas,
            "slo": self._fleet_slo(),
            "fabric": self.fabric.snapshot(),
            "supervision": self.supervision_counters(),
        }

    def supervision_counters(self) -> dict:
        with self._lock:
            return {
                "retries_attempted": self.retries_attempted,
                "retries_succeeded": self.retries_succeeded,
                "failovers": self.failovers,
                "requests_shed": self.requests_shed,
                "requests_unavailable": self.requests_unavailable,
                "poison_requests": self.poison_requests,
                "kv_integrity_rejections": sum(
                    e.kv_integrity_rejections for e in self.engines)
                + self.fabric.kv_rejections,
                "route_prefix_hits": self.route_prefix_hits,
                "route_cold": self.route_cold,
                "route_fabric_hits": self.route_fabric_hits,
                "fabric_puts": self.fabric.puts,
                "fabric_hits": self.fabric.hits,
                "preemptions": sum(e.preemptions_total
                                   for e in self.engines),
                "recompute_resumes": sum(e.resumes_total
                                         for e in self.engines),
                "states": [h.state for h in self.health],
            }

    def prometheus_text(self) -> str:
        """Every replica's registry under a ``replica="i"`` label, plus
        the fleet registry."""
        groups = [({"replica": str(i)}, s.engine.telemetry.registry)
                  for i, s in enumerate(self.schedulers)]
        groups += [({}, self._fleet_registry), ({}, self._http_registry)]
        return telemetry.render_prometheus(groups)

    def recent_snapshot(self, n: int) -> List[dict]:
        """The latest ``n`` request timelines across replicas, ordered by
        finish time (GET /debug/requests)."""
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
        spans and every replica's, joined; None when none holds it."""
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

    def capture_profile(self, replica: int, seconds: float) -> dict:
        """POST /debug/profile {"seconds": N}: a torch.profiler capture
        in this process (every in-process replica is in it; the replica
        argument names the trace dir)."""
        return telemetry.capture_torch_profile(
            self.server_cfg.profile_dir, replica, seconds)

    def stats_snapshot(self) -> dict:
        """Aggregate counters and the per-replica breakdown."""
        per = [s.stats.snapshot(s.engine) for s in self.schedulers]
        for d, h in zip(per, self.health):
            d["health"] = h.snapshot()
        return aggregate_replica_stats(per, self.supervision_counters())

    def steps_snapshot(self) -> dict:
        """Step-ledger attribution (GET /debug/steps): per-replica
        verdicts and the fleet-merged report."""
        reports = {str(i): e.telemetry.steps_report()
                   for i, e in enumerate(self.engines)}
        return {"replicas": reports,
                "fleet": telemetry.merge_steps_reports(
                    list(reports.values()))}

    def blackbox_index(self) -> dict:
        """The flight recorders' captures (GET /debug/blackbox)."""
        return telemetry.blackbox_index(self.server_cfg.blackbox_dir)

    def apply_chaos(self, body: dict) -> dict:
        """Arm/disarm engine fault injection (POST /debug/chaos):
        ``{"replica": i | null, "step_failure_rate": p, "step_wedge_s": s,
        "page_pressure": n}``, null replica = every replica. Process
        kills ("kill") need ``--fleet subprocess``. Raises
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


# Per-replica gauges and config constants that are not summed across
# replicas (page counts sum, so fleet utilization stays consistent).
_NON_ADDITIVE = ("model_params", "approx_flops_per_token",
                 "mean_batch_occupancy", "decode_pipeline_depth",
                 "pool_pressure", "decode_rung", "rung_peak",
                 "lane_occupancy", "mfu_estimate")


def aggregate_replica_stats(per: List[dict], supervision: dict) -> dict:
    """Fold per-replica scheduler snapshots into the fleet stats dict:
    THE aggregation rule of both backends (live scheduler objects
    in-process, stats dicts fetched from workers in the process fleet),
    so /metrics?format=json has one shape whatever the fleet."""
    if len(per) == 1:
        out = dict(per[0])
        if isinstance(out.get("slo"), dict):
            out["slo"] = {k: v for k, v in out["slo"].items()
                          if not k.endswith("_window")}
        out["supervision"] = supervision
        return out
    agg = dict(per[0])
    for d in per[1:]:
        for k, v in d.items():
            if (k in _NON_ADDITIVE or isinstance(v, bool)
                    or not isinstance(v, (int, float))):
                continue
            base = agg.get(k, 0)
            agg[k] = (base if isinstance(base, (int, float))
                      and not isinstance(base, bool) else 0) + v
    # Replica 0's health and role would masquerade as the fleet's.
    agg.pop("health", None)
    agg.pop("role", None)
    # Fleet SLO quantiles pool the raw windows, which are then stripped
    # from copies of the per-replica views (never the caller's dicts:
    # the process fleet caches them, windows included).
    if any("slo" in d for d in per):
        agg["slo"] = telemetry.pooled_slo([d.get("slo") for d in per])
        per = [({**d, "slo": {k: v for k, v in d["slo"].items()
                              if not k.endswith("_window")}}
                if isinstance(d.get("slo"), dict) else d)
               for d in per]
    phase_keys = sorted(set().union(
        *(d.get("phases", {}).keys() for d in per)))
    agg["phases"] = {
        k: telemetry.merge_phases(
            [d.get("phases", {}).get(k) for d in per])
        for k in phase_keys}
    agg["mean_batch_occupancy"] = (
        sum(d.get("mean_batch_occupancy", 0.0) for d in per) / len(per))
    agg["decode_rung"] = max(d.get("decode_rung", 0) for d in per)
    agg["rung_peak"] = max(d.get("rung_peak", 0) for d in per)
    agg["lane_occupancy"] = round(
        sum(d.get("lane_occupancy", 0.0) for d in per) / len(per), 4)
    mfus = [d["mfu_estimate"] for d in per
            if d.get("mfu_estimate") is not None]
    agg["mfu_estimate"] = (round(sum(mfus) / len(mfus), 6)
                           if mfus else None)
    if "prefix_cache" in per[0]:
        agg["prefix_cache"] = {
            k: sum(d.get("prefix_cache", {}).get(k, 0) for d in per)
            for k in per[0]["prefix_cache"]}
    # Fleet decode-call latency: the element-wise worst replica.
    rings = [d.get("decode_call_s") for d in per]
    rings = [r for r in rings if r]
    agg["decode_call_s"] = (
        {k: max(r[k] for r in rings if k in r) for k in rings[0]}
        if rings else None)
    if "speculative" in per[0]:
        specs = [d.get("speculative") or {} for d in per]
        drafted = sum(s.get("drafted", 0) for s in specs)
        accepted = sum(s.get("accepted", 0) for s in specs)
        agg["speculative"] = {
            "mode": specs[0].get("mode"),
            "gamma": specs[0].get("gamma"),
            "drafted": drafted, "accepted": accepted,
            "acceptance_rate": (accepted / drafted) if drafted else 0.0,
            "rounds": sum(s.get("rounds", 0) for s in specs),
            "fallback_rounds": sum(s.get("fallback_rounds", 0)
                                   for s in specs),
            "throttles": sum(s.get("throttles", 0) for s in specs)}
    agg["replicas"] = per
    agg["dp"] = len(per)
    agg["supervision"] = supervision
    return agg
