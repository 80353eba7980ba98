"""The replica facade the HTTP layer talks to, at dp=1.

Twin of ``tpu_inference/server/replicas.py``'s ``EngineGroup`` for one
in-process replica: submit and cancel through its scheduler, a health
state machine driven by step failures, admission control, the health
snapshot behind /healthz, and the Prometheus page behind /metrics.
Several replicas, prefix-affinity routing and failover are ROADMAP
items 1.15 and 1.16.

Health: healthy -> degraded (one failed step) -> quarantined
(``quarantine_after_failures`` in a row) -> recovered (after
``quarantine_cooldown_s``) -> healthy (one clean step). A quarantined
replica takes no requests (HTTP 503 with Retry-After).
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, List, Optional

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import ServerConfig
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
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

    def maybe_recover(self) -> None:
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
                "quarantines": self.quarantines,
                "state_age_s": round(time.monotonic() - self.since, 3),
            }


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
        self._fleet_registry = telemetry.Registry()
        self._fleet_registry.counter(
            "tpu_inf_requests_shed_total",
            "Requests rejected with 429 at the admission queue cap",
            fn=lambda: self.requests_shed)
        self._fleet_registry.counter(
            "tpu_inf_requests_unavailable_total",
            "Requests rejected with 503 (no routable replica)",
            fn=lambda: self.requests_unavailable)
        self._fleet_registry.gauge(
            "tpu_inf_replica_healthy",
            "1 when the replica is routable", replica="0",
            fn=lambda: float(self.health[0].state != QUARANTINED))

    @property
    def engine(self) -> InferenceEngine:
        return self.engines[0]

    def warmup(self) -> float:
        return sum(e.warmup() for e in self.engines)

    def start(self) -> "EngineGroup":
        for s in self.schedulers:
            s.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        for s in self.schedulers:
            s.stop(drain=drain, timeout=timeout)

    def _retry_after(self) -> float:
        return self.server_cfg.retry_after_s

    def submit(self, seq: Sequence, on_token: Callable,
               on_finish: Callable) -> None:
        """Submit to the replica; raises FleetUnavailable (quarantined)
        or FleetSaturated (admission queue cap) instead of queueing."""
        if not seq.trace_id:
            seq.trace_id = uuid.uuid4().hex[:16]
        sched, health = self.schedulers[0], self.health[0]
        if not health.routable:
            self.requests_unavailable += 1
            raise FleetUnavailable("all replicas quarantined",
                                   self._retry_after())
        cap = self.server_cfg.admission_queue_depth
        if cap > 0 and sched.load >= cap:
            self.requests_shed += 1
            raise FleetSaturated(
                f"admission queue cap reached ({sched.load} >= {cap})",
                self._retry_after())
        sched.submit(seq, on_token, on_finish)

    def cancel(self, request_id: int) -> None:
        for s in self.schedulers:
            s.cancel(request_id)

    def health_snapshot(self) -> dict:
        replicas = []
        for h, e in zip(self.health, self.engines):
            d = h.snapshot()
            d["pool_pressure"] = round(e.pool_pressure, 4)
            d["device"] = str(e.device)
            replicas.append(d)
        routable = sum(1 for h in self.health if h.routable)
        status = ("unavailable" if routable == 0 else
                  "ok" if all(r["state"] == HEALTHY for r in replicas)
                  else "degraded")
        return {"status": status, "replicas": replicas,
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
        return self.schedulers[0].stats.snapshot(self.engines[0])
