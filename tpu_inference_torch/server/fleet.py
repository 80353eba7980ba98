"""Process fleet router: ``EngineGroup`` semantics over worker processes.

Twin of ``tpu_inference/server/fleet.py``. ``ProcessEngineGroup``
serves the same
facade as the in-process ``EngineGroup`` (submit/cancel; health, stats,
metrics, steps, recent, trace and blackbox snapshots; prefix-affinity
routing; failover; admission control) behind ``--fleet subprocess``, but
each dp replica is its own worker process (server/worker.py) speaking
the framed JSON RPC of ``server/transport.py`` over a local unix socket,
so a wedge, a crash or a ``kill -9`` takes out one process, and the GIL
is no longer the dp ceiling. On one card every worker shares it
(``cuda:{i % device_count}``), each with its own weights and KV pool.

Supervision: a monitor thread restarts a dead worker with doubling
backoff, up to ``worker_restart_max`` restarts (then it stays
quarantined and visible), under the same ``replica="i"`` label; counters
and histograms of dead incarnations fold into a per-replica carry
(``telemetry.fold_dump_into_carry``), so the fleet's scrape never
falls. A connection that dies or carries a bad frame while its process
lives is redialled and its requests resynced (no restart). Three RPC
timeouts in a row mark a connection wedged and recycle it. A request
whose attempts crashed or wedged ``poison_max_workers`` distinct
workers finishes "poison".

Failure handling:

- SIGTERM (or the drain RPC): the worker exports each live request's KV
  pages as ``migrate`` events; the router checks each blob's digest,
  imports it into a destination's host tier and resubmits with its own
  token record, so admission there is a swap-in-resume. Each export is
  claimed on the connection's reader thread and imported on a thread of
  its own, so a drain's exports land side by side (the reference
  imports them one after another on the reader thread).
- ``kill -9``: nothing can be exported; the router replays its token
  record as a recompute-resume on a survivor, token-identical under
  greedy, and the client's stream continues where it stopped.

P/D roles (``ServerConfig.worker_roles``, one per replica, resolved by
``config.resolve_worker_roles``): new prompts go to prefill-capable
workers, handoffs and resumes to decode-capable ones (``_phase_pool``;
a fleet missing a phase serves on the other workers). A prefill worker
settles a prompt, streams its first token and sends the live sequence
as a ``handoff`` event with its KV blob; the router checks the blob's
digest and resubmits the request with it to the least-loaded decode
worker (``decode_route_score``), which adopts the pages and decodes on
with nothing recomputed. Every failure degrades to a counted
recompute-resume: a corrupt blob, no decode worker, or a stale blob
(the router drops it once the adopter streams past the export, so a
decode worker's death resumes from the token record).

Elastic fleet: with ``ServerConfig.autoscale`` the monitor scales the
worker count on the router-observed TTFT (submit to first streamed
token, lane park time included) or the workers' pooled TPOT: a breach
sustained for ``autoscale_breach_window_s`` spawns a worker at a fresh
replica index, a lull under ``autoscale_low_watermark`` occupancy for
``autoscale_idle_window_s`` drains the coldest one away (its KV
migrates, its exit lands RETIRED, not respawned); one cooldown serves
both directions and nothing acts while a worker boots, restarts or
drains. ``rollout()`` (POST /debug/rollout) replaces every worker one
at a time: the successor boots first, then the predecessor drains and
retires. With ``class_queue_depth`` > 0, a request over the admission
cap parks in its class lane (batch, background) instead of a 429, and
an interactive one preempts the newest lowest-class running request,
which goes back to the front of its lane and resumes from the router's
token record.

Routing is the in-process group's four-temperature prefix affinity
(``kv_fabric.prefill_route_score``): the router hashes each prompt once
and probes every candidate's cache tiers through the side-effect-free
``peek`` RPC; the fourth tier, the KV fabric, it reads from its own
pool. Tokens stream through the router one event frame each,
unbuffered.

KV fabric (``fabric_cache_pages`` > 0): the router holds a
``kv_fabric.FabricPool`` of serialized prefix pages. Workers publish
settled prefix runs as ``fabric_put`` events; a dispatch first ships the
pages the pool holds beyond the chosen worker's warm depth into its host
tier over ``import-kv`` (a live handoff skips it), and a failed pull
lets the dispatch go on cold. Every worker incarnation (first boot,
respawn, scale-up, rollout successor) gets the pool's MRU hot set
(``fabric_warmboot_pages``) before it becomes routable. A handoff or a
drain export that finds no destination is parked in the pool (salvage),
so the retry's dispatch pulls it back.

KV planes (``kv_plane``): on the relay plane every KV payload crosses
the router in RPC frames. On the shm plane (``shm_arena.
effective_kv_plane``: worker processes on Linux) the router creates one
shared-memory segment of ``shm_arena_bytes`` in ``max(4, 2 dp)``
regions and names each boot-time worker its region in the envelope;
handoff, migrate, fabric-publish, fabric-pull and warm-boot frames then
carry slab descriptors, and ``rpc_blob_bytes`` stays at 0 for them. The
router's ``SlabDirectory`` registers each descriptor it receives,
releases it when the pool entry or the handoff lets go, and hands the
frees to the owner on the stats tick; a dead incarnation's region is
reclaimed by an epoch bump (``_reclaim_region``) at its respawn or
quarantine. A segment that cannot be created leaves the fleet on the
relay plane (``shm_arena_unavailable``); a worker past the region count
(a scale-up's, a rollout successor's) relays.

Before spawning workers for a card with the kernel backend, the router
builds the kernels once (``kernels.KERNEL_SOURCES``), so workers never
run ``nvcc`` side by side.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from typing import Callable, Dict, List, Optional, Tuple

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import (FrameworkConfig, class_rank,
                                        framework_config_to_dict,
                                        resolve_worker_roles)
from tpu_inference_torch.engine import kv_cache as kvc
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.integrity import KVIntegrityError
from tpu_inference_torch.server import kv_fabric, shm_arena
from tpu_inference_torch.server.replicas import (_RETRYABLE, FleetSaturated,
                                                 FleetUnavailable,
                                                 _clone_request,
                                                 aggregate_replica_stats,
                                                 routing_digests,
                                                 shard_devices)
from tpu_inference_torch.server.transport import (ChaosPolicy,
                                                  ChaosTransport, FrameError,
                                                  recv_frame, send_frame)


class WorkerGone(ConnectionError):
    """RPC failed because the worker's process or connection died."""


# Per-verb deadline classes: "slow" verbs touch the engine loop or move
# KV bytes; the rest answer from memory. hello/shutdown/embed/profile
# pass explicit budgets at their call sites.
_SLOW_RPC_VERBS = ("submit", "import-kv", "drain")

# Consecutive RPC timeouts on one connection before it counts as wedged
# and is recycled (a reconnect, not a restart).
_WEDGE_TIMEOUTS = 3

# How long a failed re-route keeps re-picking before the request fails
# "unavailable" (a redial, or most of a worker restart).
_REROUTE_GRACE_S = 10.0

# How long a submit whose connection died waits for the fleet's verdict
# on the worker (down, or redialled): a lost connection's own handler
# decides within _exits_soon's grace plus a redial's connect timeout.
_VERDICT_S = 10.0


class WorkerClient:
    """One live RPC connection to one worker incarnation. Requests are
    correlated by id; event frames go to the group's handler on this
    client's reader thread."""

    def __init__(self, path: str, proc: subprocess.Popen,
                 connect_timeout: float = 1800.0, replica: int = -1,
                 deadlines: Optional[dict] = None,
                 chaos: Optional[ChaosTransport] = None):
        deadline = time.monotonic() + connect_timeout
        last_err: Optional[Exception] = None
        self.sock = None
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                raise WorkerGone(
                    f"worker exited rc={proc.returncode} before accepting")
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(path)
                self.sock = s
                break
            except OSError as e:
                last_err = e
                s.close()
                time.sleep(0.05)
        if self.sock is None:
            raise WorkerGone(f"could not connect to worker: {last_err}")
        self.proc = proc
        self.rfile = self.sock.makefile("rb")
        self._wlock = threading.Lock()
        self._ids = itertools.count(1)
        self._pending: Dict[int, dict] = {}
        self._plock = threading.Lock()
        self.alive = True
        self.replica = replica
        self.deadlines = deadlines or {}
        self.chaos = chaos
        # Why the reader died: "" | "frame_error" | "stream_gap" |
        # "wedged".
        self.lost_reason = ""
        self._consec_timeouts = 0
        self.on_event: Optional[Callable] = None     # set by the group
        self.on_lost: Optional[Callable] = None
        self.on_timeout: Optional[Callable] = None   # (verb, timeout_s)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="fleet-worker-reader",
                                        daemon=True)

    def start_reader(self) -> None:
        self._reader.start()

    def close(self) -> None:
        self.alive = False
        try:
            # shutdown() wakes the reader parked in recv(); close() alone
            # would leave it blocked and on_lost would never fire.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def resolve_deadline(self, verb: str) -> float:
        if verb in _SLOW_RPC_VERBS:
            return float(self.deadlines.get("slow", 60.0))
        return float(self.deadlines.get("fast", 10.0))

    def rpc(self, verb: str, timeout: Optional[float] = None,
            blob: bytes = b"", **kw) -> dict:
        """Send one request frame and wait for its reply. ``timeout``
        None takes the verb's deadline class. Raises WorkerGone on a dead
        connection (or a draining worker), TimeoutError past the deadline
        (recycling the connection after _WEDGE_TIMEOUTS in a row),
        RuntimeError on an error reply."""
        if not self.alive:
            raise WorkerGone("connection closed")
        if timeout is None:
            timeout = self.resolve_deadline(verb)
        rid = next(self._ids)
        waiter = {"evt": threading.Event(), "reply": None}
        with self._plock:
            self._pending[rid] = waiter
        msg = {"id": rid, "verb": verb}
        msg.update(kw)
        try:
            with self._wlock:
                send_frame(self.sock, msg, blob, chaos=self.chaos,
                           verb=verb, direction="send")
        except (OSError, ConnectionError) as e:
            with self._plock:
                self._pending.pop(rid, None)
            raise WorkerGone(str(e))
        if not waiter["evt"].wait(timeout):
            with self._plock:
                self._pending.pop(rid, None)
            if not self.alive:
                raise WorkerGone("connection lost mid-RPC")
            self._consec_timeouts += 1
            telemetry.log_event("rpc_timeout", level="warning",
                                verb=verb, replica=self.replica,
                                timeout_s=round(float(timeout), 3),
                                consecutive=self._consec_timeouts)
            if self.on_timeout is not None:
                self.on_timeout(verb, float(timeout))
            if self._consec_timeouts >= _WEDGE_TIMEOUTS:
                # Open but mute: close it, and the reader's on_lost runs
                # the reconnect path (the process lives).
                self.lost_reason = self.lost_reason or "wedged"
                self.close()
            raise TimeoutError(f"worker RPC {verb!r} timed out "
                               f"after {timeout:.1f}s")
        self._consec_timeouts = 0
        reply = waiter["reply"]
        if reply is None or not reply[0].get("ok", False):
            err = (reply[0].get("error", "worker error") if reply
                   else "connection lost")
            kind = reply[0].get("kind", "") if reply else "gone"
            if kind in ("gone", "draining"):
                raise WorkerGone(err)
            raise RuntimeError(f"worker RPC {verb!r}: {err}")
        return reply[0]

    def _read_loop(self) -> None:
        try:
            while True:
                obj, blob = recv_frame(self.rfile)
                if "ev" in obj:
                    if self.on_event is not None:
                        self.on_event(self, obj, blob)
                    continue
                with self._plock:
                    waiter = self._pending.pop(obj.get("id"), None)
                if waiter is not None:
                    waiter["reply"] = (obj, blob)
                    waiter["evt"].set()
        except FrameError as e:
            # The stream cannot be trusted past a bad frame: recycle the
            # connection (the process may be fine).
            self.lost_reason = self.lost_reason or "frame_error"
            telemetry.log_event("frame_error", level="warning",
                                replica=self.replica, reason=e.reason,
                                error=str(e))
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            self.alive = False
            with self._plock:
                pending, self._pending = self._pending, {}
            for waiter in pending.values():
                waiter["evt"].set()
            if self.on_lost is not None:
                self.on_lost(self)


# Worker lifecycle states.
BOOTING = "booting"
UP = "up"
DRAINING = "draining"
RESTARTING = "restarting"
DEAD = "dead"                   # router teardown
# Restart budget spent: routed around and visible in /healthz and the
# tpu_inf_worker_quarantined gauge.
QUARANTINED = "quarantined"
# Intentional exit (a scale-down or a rollout's retirement): never
# respawned, outside the fleet's health arithmetic.
RETIRED = "retired"


class WorkerHandle:
    """Supervision state of one replica slot across incarnations: the
    replica index and its metrics label stay, the process, socket and
    client change per restart."""

    def __init__(self, replica: int):
        self.replica = replica
        self.state = BOOTING
        self.proc: Optional[subprocess.Popen] = None
        self.client: Optional[WorkerClient] = None
        self.socket_path = ""
        self.incarnation = 0
        self.restarts = 0               # successful respawns
        self.consecutive_failures = 0   # sets the restart backoff
        self.restart_at = 0.0           # monotonic deadline for respawn
        self.started_unix = 0.0
        self.pid: Optional[int] = None
        self.info: dict = {}
        # Boot wall of each incarnation (spawn to hello), seconds, and
        # each fabric warm boot (incarnation, pages offered and adopted,
        # bytes, wall).
        self.boot_walls: List[float] = []
        self.warmboots: List[dict] = []
        self.last_stats: dict = {}
        self.last_metrics: list = []
        self.last_health: dict = {}
        self.last_steps: dict = {}
        # Monotonic series of dead incarnations; folded_incarnation makes
        # the fold idempotent (the drained event and the exit can both
        # report one death).
        self.carry: Dict[tuple, dict] = {}
        self.folded_incarnation = 0
        # SLO breach totals of dead incarnations (the fleet counter
        # never decreases across a restart).
        self.slo_breach_carry = {"ttft": 0, "tpot": 0}
        # Set before an intentional drain (scale-down, rollout): the
        # death handler retires this worker instead of respawning it.
        self.retiring = False

    @property
    def routable(self) -> bool:
        return self.state == UP


class _Tracked:
    """Router-side state of one request across attempts, workers and
    migrations."""

    __slots__ = ("template", "on_token", "on_finish", "worker", "client",
                 "generation", "attempts", "tokens", "seq_local",
                 "resume_stream_len", "t_submit", "failed_workers",
                 "handoff_blob", "handoff_desc", "handoff_meta")

    def __init__(self, template: Sequence, on_token, on_finish):
        self.template = template
        self.on_token = on_token
        self.on_finish = on_finish
        self.worker: Optional[WorkerHandle] = None
        self.client: Optional[WorkerClient] = None
        self.generation = 0
        self.attempts = 0
        # Every token streamed to the caller, in order: the failover
        # record a killed worker's request recompute-resumes from.
        self.tokens: List[int] = []
        self.seq_local = _clone_request(template)
        # Tokens the latest resume re-prefilled (prompt + replayed).
        self.resume_stream_len = 0
        self.t_submit = time.perf_counter()
        # Replicas whose worker crashed or wedged under this request.
        self.failed_workers: set = set()
        # A P/D handoff's KV blob and its {"ctx_len", "n_generated"}: the
        # blob is dropped once the adopter streams past the export; the
        # meta stays, so a later failover counts as a handoff recompute.
        # On the shm plane the export is an arena descriptor instead,
        # held (registered with the slab books) for the same span.
        self.handoff_blob: Optional[bytes] = None
        self.handoff_desc: Optional[dict] = None
        self.handoff_meta: Optional[dict] = None


class _EngineInfo:
    """The model and engine facts the HTTP layer reads off
    ``group.engine``, from worker 0's hello."""

    def __init__(self, hello: dict):
        import torch

        self.n_params = hello.get("n_params", 0)
        self.weight_bytes = hello.get("weight_bytes", 0)
        self.attn_backend = hello.get("attn_backend", "?")
        self.ladder = tuple(hello.get("ladder") or (1,))
        self.swa_evict = hello.get("swa_evict", False)
        self.prefix_cache = True if hello.get("prefix_cache") else None
        self.spec_draft = hello.get("spec_draft", False)
        self.device = torch.device(hello.get("device", "cpu"))


class ProcessEngineGroup:
    """Router and N worker processes behind the EngineGroup facade
    (``ServerConfig.fleet = "subprocess"``)."""

    def __init__(self, cfg: FrameworkConfig, device="cuda"):
        self.cfg = cfg
        self.server_cfg = cfg.server
        self.engine_cfg = cfg.engine
        self.dp = max(1, cfg.parallel.dp)
        self.device = str(device)
        # Phase roles, one per replica; pd_enabled turns on the
        # phase-aware routing (an all-mixed fleet routes as before).
        self.roles = list(resolve_worker_roles(
            self.dp, cfg.server.worker_roles,
            default_role=cfg.engine.role))
        self.pd_enabled = any(r != "mixed" for r in self.roles)
        if self.pd_enabled and len(set(self.roles)) == 1:
            telemetry.log_event(
                "pd_roles_one_sided", level="warning", roles=self.roles,
                note="a P/D split needs both phases; this fleet serves "
                     "the other phase on the same workers")
        self.workers = [WorkerHandle(i) for i in range(self.dp)]
        self._sock_dir = tempfile.mkdtemp(prefix="torchinf-fleet-")
        self._started = False
        self._stopping = False
        self._start_lock = threading.Lock()
        self._lock = threading.Lock()
        self._tracked: Dict[int, _Tracked] = {}
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.engine: Optional[_EngineInfo] = None
        self.warmup_total_s = 0.0
        self.retries_attempted = 0
        self.retries_succeeded = 0
        self.failovers = 0
        self.requests_shed = 0
        self.requests_unavailable = 0
        self.route_prefix_hits = 0
        self.route_cold = 0
        self.route_fabric_hits = 0      # dispatches that pulled fabric pages
        self.migrations = 0             # drain exports received
        self.migrated_pages = 0
        self.migrated_bytes = 0
        self.resume_resubmits = 0
        self.resume_recomputed_tokens = 0
        self.resume_reused_tokens = 0
        self.reconnects = 0
        self.rpc_timeouts = 0
        self.frame_errors = 0
        self.kv_rejections = 0
        self.poison_requests = 0
        # P/D handoffs routed, and those that fell back to a recompute
        # on the router's side (stale blob, corrupt blob, no adopter).
        self.pd_handoffs = 0
        self.pd_handoff_recomputes = 0
        # KV payload bytes relayed through the router, by verb.
        self.rpc_blob_bytes: Dict[str, int] = {
            "submit": 0, "import-kv": 0, "handoff": 0, "migrate": 0,
            "fabric_put": 0}
        # The fleet KV fabric: the router's pool of serialized prefix
        # pages, fed by the workers' fabric_put events.
        self.fabric = kv_fabric.FabricPool(cfg.server.fabric_cache_pages)
        # The latest pulls (replica, pages, bytes, wall, plane), for the
        # logs.
        self.fabric_pulls: deque = deque(maxlen=256)
        # The shm plane: one segment for the fleet, a region per
        # boot-time replica (None on the relay plane, or when the
        # segment could not be created).
        self.arena: Optional[shm_arena.ArenaSegment] = None
        self._arena_dir: Optional[shm_arena.SlabDirectory] = None
        self.shm_reclaims = 0
        # Drain exports by descriptor still being read, by source region:
        # the region's reclaim at the respawn waits for them.
        self._arena_reads: Dict[int, int] = Counter()
        if shm_arena.effective_kv_plane(cfg.server) == "shm":
            try:
                self.arena = shm_arena.ArenaSegment(
                    cfg.server.shm_arena_bytes,
                    regions=max(4, self.dp * 2))
                self._arena_dir = shm_arena.SlabDirectory()
                self.fabric.on_release = self._arena_dir.release
            except Exception as e:  # noqa: BLE001 — degrade to relay
                telemetry.log_event(
                    "shm_arena_unavailable", level="warning", error=str(e),
                    note="kv_plane=shm degraded to relay")
                self.arena = None
        self._deadlines = {"fast": cfg.server.rpc_deadline_fast_s,
                           "slow": cfg.server.rpc_deadline_slow_s}
        # Transport chaos: config knobs, retuned by /debug/chaos. One
        # policy per replica (per-replica seeds; the one-shot wedge
        # survives that replica's reconnects).
        self._chaos_rpc_kw = self._chaos_kw_from_cfg(cfg.server)
        self._chaos_policies: Dict[int, ChaosPolicy] = {}
        # Router-side flight recorder: poison quarantines and corrupt-KV
        # rejections capture the router's view.
        self._flight = telemetry.attach_router_flight_recorder(
            cfg.server.blackbox_dir, retain=cfg.server.blackbox_retain,
            stats_fn=self.supervision_counters)
        # Candidate peeks fan out concurrently (created eagerly: lazy
        # creation under concurrent submits would race).
        self._peek_pool: Optional[ThreadPoolExecutor] = ThreadPoolExecutor(
            max_workers=max(4, self.dp), thread_name_prefix="fleet-peek")
        # The router's spans (request root, route, migrate); the
        # workers' spans ride finish and migrate events into it.
        self._recorder = telemetry.SpanRecorder(replica=-1)
        self._rr = 0
        self._route_stats = [{"hits": 0, "cold": 0, "hit_pages": 0,
                              "host_hit_pages": 0,
                              "fabric_hit_pages": 0}
                             for _ in range(self.dp)]
        # Elastic fleet: scale and rollout actuations, the per-class
        # admission outcomes, and the bounded lanes where batch and
        # background requests park at the admission cap (guarded by
        # _lock; the monitor's pump dispatches them as capacity frees).
        self.scale_ups = 0
        self.scale_downs = 0
        self.rollouts = 0
        self.class_preemptions: Dict[str, int] = {}
        self.class_shed: Dict[str, int] = {}
        self._deferred: Dict[str, deque] = {"batch": deque(),
                                            "background": deque()}
        self._breach_since = 0.0      # monotonic start of the breach
        self._idle_since = 0.0        # monotonic start of the lull
        self._last_scale_t = 0.0      # monotonic time of the last act
        self._rollout_lock = threading.Lock()
        # Router-observed TTFT samples (perf_counter at the first token,
        # submit to first token in s), pruned to a time horizon at each
        # autoscale tick: the scale-up sensor. Unlike the workers'
        # engine-side rings it sees lane park time, and it ages out, so a
        # finished burst releases the breach. Guarded by _lock.
        self._ttft_obs: deque = deque(maxlen=2048)
        self._fleet_registry = telemetry.Registry()
        self._build_registry()

    # ------------------------------------------------------ registries

    def _build_registry(self) -> None:
        r = self._fleet_registry
        telemetry.register_span_ring(r, self._recorder)
        r.gauge("tpu_inf_replicas",
                "Live replicas (quarantined workers excluded)",
                fn=lambda: float(len(self._live_workers())))
        r.counter("tpu_inf_retries_attempted_total",
                  "Failover resubmissions attempted",
                  fn=lambda: self.retries_attempted)
        r.counter("tpu_inf_retries_succeeded_total",
                  "Failover resubmissions that finished cleanly",
                  fn=lambda: self.retries_succeeded)
        r.counter("tpu_inf_failovers_total",
                  "Requests stranded by a dead/draining worker and "
                  "resubmitted",
                  fn=lambda: self.failovers)
        r.counter("tpu_inf_requests_shed_total",
                  "Requests shed at the admission queue cap (HTTP 429)",
                  fn=lambda: self.requests_shed)
        r.counter("tpu_inf_requests_unavailable_total",
                  "Requests rejected with no routable worker (HTTP 503)",
                  fn=lambda: self.requests_unavailable)
        r.counter("tpu_inf_route_prefix_hits_total",
                  "Dispatches routed with a non-zero prefix-cache peek",
                  fn=lambda: self.route_prefix_hits)
        r.counter("tpu_inf_route_cold_total",
                  "Dispatches routed with no cached prefix on any "
                  "scored worker",
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
        for verb in self.rpc_blob_bytes:
            r.counter("tpu_inf_rpc_blob_bytes_total",
                      "KV payload bytes relayed through the router's "
                      "RPC/event frames, by verb (descriptor frames on "
                      "the shm plane count 0 here)",
                      fn=lambda v=verb: self.rpc_blob_bytes[v], verb=verb)
        r.gauge("tpu_inf_shm_slabs_total",
                "Arena slabs the router still tracks: live plus released "
                "but not yet freed (frees go to the owning worker on its "
                "next stats tick). 0 on the relay plane.",
                fn=lambda: float(self._arena_dir.slabs_tracked
                                 if self._arena_dir is not None else 0))
        r.gauge("tpu_inf_shm_slabs_used",
                "Arena slabs still held by a consumer (a fabric pool "
                "entry or a pending handoff or migrate)",
                fn=lambda: float(self._arena_dir.slabs_live
                                 if self._arena_dir is not None else 0))
        r.counter("tpu_inf_shm_reclaims_total",
                  "Arena slabs reclaimed by a region epoch bump after "
                  "their worker incarnation died (their consumers "
                  "recompute)",
                  fn=lambda: self.shm_reclaims)
        r.counter("tpu_inf_fleet_migrations_total",
                  "In-flight requests migrated off a draining worker",
                  fn=lambda: self.migrations)
        r.counter("tpu_inf_fleet_migrated_pages_total",
                  "KV pages moved worker-to-worker by drain migration",
                  fn=lambda: self.migrated_pages)
        r.counter("tpu_inf_fleet_migrated_bytes_total",
                  "Bytes moved worker-to-worker by drain migration",
                  fn=lambda: self.migrated_bytes)
        r.counter("tpu_inf_resume_recomputed_tokens_total",
                  "Tokens re-prefilled from scratch by fleet "
                  "resubmission resumes (migration exists to shrink "
                  "this)",
                  fn=lambda: self.resume_recomputed_tokens)
        r.counter("tpu_inf_resume_reused_tokens_total",
                  "Tokens served from cache tiers (incl. migrated "
                  "pages) during fleet resubmission resumes",
                  fn=lambda: self.resume_reused_tokens)
        r.counter("tpu_inf_pd_handoffs_total",
                  "Prefill->decode live KV handoffs routed",
                  fn=lambda: self.pd_handoffs)
        r.counter("tpu_inf_pd_handoff_recomputes_total",
                  "Handoffs that fell back to recompute-resume (stale "
                  "export, no adopter, or a worker-side adoption "
                  "failure) instead of a clean adoption",
                  fn=self._pd_recomputes_total)
        self._pd_handoff_s_hist = r.histogram(
            "tpu_inf_pd_handoff_seconds",
            "Prefill->decode handoff wall: worker-side KV export + "
            "router-side routing/dispatch until the decode worker "
            "accepted the resume")
        r.counter("tpu_inf_worker_reconnects_total",
                  "Connection-level failovers: the socket died or a "
                  "frame was invalid while the worker process stayed "
                  "up, so the router reconnected and resynced instead "
                  "of paying a restart",
                  fn=lambda: self.reconnects)
        r.counter("tpu_inf_rpc_timeouts_total",
                  "Worker RPCs that exceeded their per-verb deadline "
                  "class",
                  fn=lambda: self.rpc_timeouts)
        r.counter("tpu_inf_frame_errors_total",
                  "Malformed RPC frames the router rejected (bad "
                  "magic/CRC/length); each recycles its connection",
                  fn=lambda: self.frame_errors)
        r.counter("tpu_inf_kv_integrity_rejections_total",
                  "Corrupt KV blobs rejected by digest verification "
                  "(router gate + worker import paths); every rejection "
                  "fell back to recompute-resume",
                  fn=self._kv_rejections_total)
        r.counter("tpu_inf_poison_requests_total",
                  "Requests quarantined after crashing or wedging "
                  "poison_max_workers distinct workers",
                  fn=lambda: self.poison_requests)
        # Fleet SLO gauges: exact quantiles pooled over every worker's
        # cached window; breach totals add the dead-incarnation carry.
        telemetry.register_fleet_slo(
            r, self._pooled_slo_quantile,
            lambda k: sum(h.slo_breach_carry[k]
                          + (((h.last_stats or {}).get("slo") or {})
                             .get(f"{k}_breaches", 0))
                          for h in self.workers))
        # Elastic fleet: scale events, rollouts, the class lanes.
        telemetry.register_fleet_elastic(
            r,
            scale_ups=lambda: self.scale_ups,
            scale_downs=lambda: self.scale_downs,
            rollouts=lambda: self.rollouts,
            class_preempted=lambda c: self.class_preemptions.get(c, 0),
            class_deferred=lambda c: len(self._deferred.get(c) or ()),
            class_shed=lambda c: self.class_shed.get(c, 0))
        telemetry.emit_build_info(
            r, backend=self._device_type(), fleet="subprocess",
            kv_quant=self.engine_cfg.kv_quant,
            spec_mode=(self.engine_cfg.spec_mode
                       if self.engine_cfg.num_speculative_tokens > 0
                       else "off"),
            routing=self.server_cfg.routing)
        for h in self.workers:
            self._register_worker_gauges(h)

    def _register_worker_gauges(self, h: WorkerHandle) -> None:
        """Per-worker series under the stable replica label: for every
        boot-time worker, and for each one a scale-up or a rollout adds
        at a fresh replica index."""
        r = self._fleet_registry
        rep = str(h.replica)
        r.gauge("tpu_inf_worker_role_info",
                "Worker phase role (constant 1; the role is the label)",
                fn=lambda: 1.0, replica=rep, role=self.roles[h.replica])
        r.gauge("tpu_inf_replica_routable",
                "1 when the worker accepts traffic",
                fn=lambda hh=h: float(hh.routable), replica=rep)
        r.gauge("tpu_inf_worker_up",
                "1 while the worker process is serving",
                fn=lambda hh=h: float(hh.state == UP), replica=rep)
        r.counter("tpu_inf_worker_restarts_total",
                  "Worker process respawns (stable replica label "
                  "across incarnations)",
                  fn=lambda hh=h: hh.restarts, replica=rep)
        r.gauge("tpu_inf_worker_quarantined",
                "1 while the crash-loop breaker holds this replica "
                "quarantined (restart budget spent; routed around)",
                fn=lambda hh=h: float(hh.state == QUARANTINED),
                replica=rep)

    def _device_type(self) -> str:
        return self.device.split(":")[0]

    def _pd_recomputes_total(self) -> int:
        """Every handoff that did not adopt cleanly: the router's
        fallbacks plus the workers' failed adoptions (their cached
        stats)."""
        return self.pd_handoff_recomputes + sum(
            (h.last_stats or {}).get("pd_adopt_fallbacks", 0)
            for h in self.workers)

    def _kv_rejections_total(self) -> int:
        return self.kv_rejections + self.fabric.kv_rejections + sum(
            (h.last_health or {}).get("kv_integrity_rejections", 0)
            for h in self.workers)

    @staticmethod
    def _chaos_kw_from_cfg(s) -> dict:
        return {"seed": s.chaos_rpc_seed,
                "corrupt_rate": s.chaos_rpc_corrupt_rate,
                "drop_rate": s.chaos_rpc_drop_rate,
                "delay_rate": s.chaos_rpc_delay_rate,
                "delay_s": s.chaos_rpc_delay_s,
                "truncate_rate": s.chaos_rpc_truncate_rate,
                "wedge_after": s.chaos_rpc_wedge_after,
                "wedge_replica": s.chaos_rpc_wedge_replica,
                "verbs": tuple(s.chaos_rpc_verbs),
                "direction": s.chaos_rpc_direction}

    def _make_chaos(self, replica: int) -> Optional[ChaosTransport]:
        """The router's chaos shim for one worker connection (None when
        chaos is off or aimed at worker->router frames only). The policy
        persists per replica; each connection gets a fresh transport."""
        kw = dict(self._chaos_rpc_kw)
        if kw["direction"] not in ("send", "both"):
            return None
        wedge_after = kw.pop("wedge_after")
        wedge = wedge_after if kw.pop("wedge_replica") == replica else 0
        pol = self._chaos_policies.get(replica)
        if pol is None:
            pol = ChaosPolicy(wedge_after=wedge, **kw)
            pol.seed += replica  # decorrelate per-worker schedules
            if pol.active:
                self._chaos_policies[replica] = pol
        if not pol.active:
            return None
        return ChaosTransport(pol)

    def _live_workers(self) -> List[WorkerHandle]:
        """Workers that count toward the fleet's size: not retired on
        purpose, not quarantined, not torn down."""
        return [h for h in self.workers
                if h.state not in (RETIRED, DEAD, QUARANTINED)]

    def _pooled_slo_quantile(self, which: str, q: float) -> float:
        windows = [(((h.last_stats or {}).get("slo") or {})
                    .get(f"{which}_window")) or []
                   for h in self.workers]
        v = telemetry.pooled_quantile(windows, q)
        return float("nan") if v is None else v

    def _fleet_slo(self) -> dict:
        out = telemetry.pooled_slo(
            [(h.last_stats or {}).get("slo") for h in self.workers])
        out["ttft_breaches"] += sum(h.slo_breach_carry["ttft"]
                                    for h in self.workers)
        out["tpot_breaches"] += sum(h.slo_breach_carry["tpot"]
                                    for h in self.workers)
        return out

    # ----------------------------------------------------------- spawn

    def _envelope(self, replica: int) -> dict:
        tp = max(1, self.cfg.parallel.tp)
        devices = shard_devices(self.device, replica, tp)
        env = {
            "config": framework_config_to_dict(self.cfg),
            # The worker builds on exactly this device; at tp > 1 its
            # shards on these (as the in-process group's), the degree
            # being the config's parallel.tp.
            "device": str(devices[0]),
            "devices": [str(d) for d in devices] if tp > 1 else None,
            "warmup": self.cfg.server.warmup,
            # The one field that differs between replicas: this worker's
            # phase role, and the prefill tier's nice increment.
            "role": self.roles[replica],
            "nice": (self.server_cfg.pd_prefill_nice
                     if self.roles[replica] == "prefill" else 0),
            # The fabric pool's watermark at boot (publish back-pressure;
            # the stats calls keep it fresh).
            "fabric_free": self.fabric.free_pages,
        }
        if self.arena is not None:
            # The shm plane: this worker's region (none past the region
            # count: such a worker relays, and says so).
            shm = self.arena.region_spec(replica)
            if shm is not None:
                env["shm"] = shm
            else:
                telemetry.log_event(
                    "shm_no_region", level="warning", replica=replica,
                    regions=self.arena.regions,
                    note="this worker rides the relay plane")
        return env

    def _spawn(self, h: WorkerHandle) -> None:
        """Launch one worker incarnation and wait for its hello (which
        waits for the worker's engine to be built and warmed)."""
        t0 = time.perf_counter()
        h.incarnation += 1
        if self.arena is not None and h.incarnation > 1:
            # The dead incarnation's slabs (pooled fabric pages, a
            # handoff nobody adopted) are taken back by an epoch bump:
            # their descriptors fail closed, and the fresh incarnation
            # mints under the new epoch in an empty region. A drain
            # export still being read (a destination's import-kv or a
            # salvage's copy, never a wait for a destination) finishes
            # first, bounded by the drain budget.
            deadline = time.monotonic() + self.server_cfg.drain_timeout_s
            while (self._arena_reads[h.replica] > 0
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            self._reclaim_region(h.replica)
        h.socket_path = os.path.join(
            self._sock_dir, f"w{h.replica}.{h.incarnation}.sock")
        env = dict(os.environ)
        # The repository may run uninstalled: the worker's interpreter
        # needs the same root on its path.
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_inference_torch.server.worker",
             "--socket", h.socket_path, "--replica", str(h.replica)],
            stdin=subprocess.PIPE, env=env)
        # Visible to stop() while it boots (a scale-up or a rollout's
        # successor): a fleet stopped mid-boot stops this process too,
        # where it would otherwise serve on, unrouted, after its hello.
        # stop() sets _stopping before it walks the workers, so a spawn
        # that reads it clear here is walked.
        h.proc, h.pid = proc, proc.pid
        try:
            if self._stopping:
                raise WorkerGone("the fleet is stopping")
            proc.stdin.write(json.dumps(self._envelope(h.replica)).encode())
            proc.stdin.close()
            client = self._connect(h, proc, connect_timeout=1800.0)
            hello = client.rpc("hello", timeout=1800.0)
        except BaseException:
            try:
                proc.kill()
                proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                pass
            raise
        h.client = client
        h.pid = hello.get("pid")
        h.info = hello
        h.started_unix = time.time()
        h.boot_walls.append(time.perf_counter() - t0)
        # Warm boot: the fabric's hot set lands in the fresh worker's host
        # tier before the UP flip makes it routable (a no-op while the
        # pool is empty).
        self._fabric_warmboot(h, client)
        h.state = UP
        h.consecutive_failures = 0
        self.warmup_total_s += hello.get("warmup_s", 0.0)
        if self.engine is None:
            self.engine = _EngineInfo(hello)
        telemetry.log_event(
            "worker_up", level="info", replica=h.replica,
            pid=h.pid, incarnation=h.incarnation, device=hello.get("device"))

    def _fabric_warmboot(self, h: WorkerHandle,
                         client: WorkerClient) -> int:
        """Push the fabric pool's MRU hot set (``fabric_warmboot_pages``
        of it) into a just-booted worker's host tier over import-kv. On
        the shm plane the descriptor entries go first, as descriptors:
        the worker reads and verifies each slab, and the digests it
        rejects are dropped from the pool. Each blob entry is re-verified
        here first: a corrupt one is dropped and counted, never shipped.
        Best effort: a failure leaves the worker cold but serving.
        Returns the pages adopted."""
        t0 = time.perf_counter()
        budget = self.server_cfg.fabric_warmboot_pages
        adopted = offered_d = desc_bytes = 0
        if self.arena is not None:
            hot_d = self.fabric.hot_set_descs(budget)
            if hot_d:
                offered_d = len(hot_d)
                desc_bytes = sum(int(dd["len"]) for _, dd in hot_d)
                try:
                    r = client.rpc(
                        "import-kv", digests=[d.hex() for d, _ in hot_d],
                        descs=[dd for _, dd in hot_d],
                        idem=f"wbd{h.replica}.{h.incarnation}")
                    adopted += int(r.get("adopted", 0))
                    for hexd in r.get("rejected_digests") or ():
                        self.fabric.reject(bytes.fromhex(hexd))
                except (WorkerGone, TimeoutError, RuntimeError) as e:
                    telemetry.log_event("fabric_warmboot_failed",
                                        level="warning", replica=h.replica,
                                        error=str(e))
                budget = max(0, budget - len(hot_d))
        pairs = []
        for d, b in self.fabric.hot_set(budget):
            try:
                pairs.append((d, kvc.deserialize_host_pages(b)[0]))
            except KVIntegrityError:
                self.fabric.reject(d)
        blob = b""
        if pairs:
            try:
                blob = kvc.serialize_host_pages([p for _, p in pairs])
                with self._lock:
                    self.rpc_blob_bytes["import-kv"] += len(blob)
                r = client.rpc("import-kv", blob=blob,
                               digests=[d.hex() for d, _ in pairs],
                               idem=f"wb{h.replica}.{h.incarnation}")
                adopted += int(r.get("adopted", 0))
            except (WorkerGone, TimeoutError, RuntimeError) as e:
                telemetry.log_event("fabric_warmboot_failed",
                                    level="warning", replica=h.replica,
                                    error=str(e))
                pairs = []
        if not pairs and not offered_d:
            return adopted
        h.warmboots.append({"incarnation": h.incarnation,
                            "offered": offered_d + len(pairs),
                            "desc_pages": offered_d, "adopted": adopted,
                            "bytes": desc_bytes + len(blob),
                            "relay_bytes": len(blob),
                            "wall_s": round(time.perf_counter() - t0, 6)})
        telemetry.log_event("fabric_warmboot", level="info",
                            replica=h.replica,
                            offered=offered_d + len(pairs), adopted=adopted)
        return adopted

    def _reclaim_region(self, rg: int) -> int:
        """A dead incarnation's slabs: drop the region's fabric entries,
        settle the slab books and bump the region's epoch, so every
        outstanding descriptor of it fails closed. Returns the slabs
        reclaimed."""
        if self.arena is None or self._arena_dir is None \
                or not (0 <= rg < self.arena.regions):
            return 0
        dropped = self.fabric.drop_region(rg)
        n = self._arena_dir.reclaim(rg)
        self.arena.bump_epoch(rg)
        with self._lock:
            self.shm_reclaims += n
        if n or dropped:
            telemetry.log_event("shm_region_reclaimed", level="info",
                                region=rg, slabs=n, fabric_entries=dropped)
        return n

    def _release_handoff_desc(self, entry: _Tracked) -> None:
        """Let go of a tracked handoff's slab (idempotent), wherever the
        blob variant would be dropped: it frees back to its owner on the
        next stats tick."""
        desc = entry.handoff_desc
        entry.handoff_desc = None
        if desc is not None and self._arena_dir is not None:
            self._arena_dir.release(desc)

    def _connect(self, h: WorkerHandle, proc: subprocess.Popen,
                 connect_timeout: float) -> WorkerClient:
        client = WorkerClient(h.socket_path, proc,
                              connect_timeout=connect_timeout,
                              replica=h.replica, deadlines=self._deadlines,
                              chaos=self._make_chaos(h.replica))
        client.on_event = lambda c, obj, blob, hh=h: self._on_event(
            hh, c, obj, blob)
        client.on_lost = lambda c, hh=h: self._on_conn_lost(hh, c)
        client.on_timeout = \
            lambda verb, t, hh=h: self._note_rpc_timeout(hh, verb, t)
        client.start_reader()
        return client

    def _build_kernels(self) -> None:
        """Build the kernels once, here, before any worker would."""
        if (self._device_type() == "cuda"
                and self.engine_cfg.attn_backend in ("auto", "kernel")):
            from tpu_inference_torch.kernels import KERNEL_SOURCES, _build
            _build.build_all(list(KERNEL_SOURCES))

    def _ensure_started(self) -> None:
        with self._start_lock:
            if self._started:
                return
            self._build_kernels()
            try:
                for h in self.workers:
                    self._spawn(h)
            except BaseException:
                # A worker that cannot boot (no card, a bad checkpoint):
                # no server; stop the workers already up.
                self.stop(drain=False, timeout=5.0)
                raise
            self._started = True

    # ---------------------------------------------------------- facade

    @property
    def engines(self) -> List[_EngineInfo]:
        """Length parity with EngineGroup.engines (the replica count)."""
        info = self.engine or _EngineInfo({})
        return [info] * len(self.workers)

    def warmup(self) -> float:
        self._ensure_started()
        return self.warmup_total_s

    def start(self) -> "ProcessEngineGroup":
        self._ensure_started()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(target=self._watch,
                                         name="fleet-monitor", daemon=True)
        self._monitor.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self._stopping = True
        if self._peek_pool is not None:
            self._peek_pool.shutdown(wait=False)
            self._peek_pool = None
        self._monitor_stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        for h in self.workers:
            if h.client is not None and h.client.alive:
                try:
                    h.client.rpc("shutdown", timeout=timeout + 30.0,
                                 drain=drain, timeout_s=timeout)
                except (WorkerGone, TimeoutError, RuntimeError):
                    pass
            if h.proc is not None and h.proc.poll() is None:
                try:
                    h.proc.terminate()
                    h.proc.wait(timeout=10.0)
                except (subprocess.TimeoutExpired, OSError):
                    try:
                        h.proc.kill()
                        h.proc.wait(timeout=5.0)
                    except (subprocess.TimeoutExpired, OSError):
                        pass
            if h.client is not None:
                h.client.close()
            h.state = DEAD
        # Every request still tracked gets its terminal callback (the
        # parked ones too: they are tracked; the lanes just drop them).
        with self._lock:
            leftovers = list(self._tracked.values())
            self._tracked.clear()
            for q in self._deferred.values():
                q.clear()
        for entry in leftovers:
            self._release_handoff_desc(entry)
            self._finish_trace(entry, "shutdown")
            ghost = entry.seq_local
            ghost.done, ghost.finish_reason = True, "shutdown"
            ghost.finish_time = time.perf_counter()
            entry.on_finish(ghost)
        if self.arena is not None:
            # Every worker is gone: unlink the segment.
            self.arena.close(unlink=True)
            self.arena = None
        if self._flight is not None:
            self._flight.close()
            self._flight = None

    # ------------------------------------------------------ supervision

    def _watch(self) -> None:
        """Monitor thread: process liveness, restart backoff, the
        once-a-second stats/metrics cache (which bounds what a kill -9's
        carry loses) and the autoscaler after it, and the class lanes'
        pump on every tick."""
        last_scrape = 0.0
        while not self._monitor_stop.wait(0.2):
            now = time.monotonic()
            for h in self.workers:
                if h.state in (UP, DRAINING) and h.proc is not None \
                        and h.proc.poll() is not None:
                    self._on_worker_down(
                        h, f"exit rc={h.proc.returncode}")
                elif h.state == RESTARTING and now >= h.restart_at \
                        and not self._stopping:
                    try:
                        self._spawn(h)
                        h.restarts += 1
                    except (WorkerGone, TimeoutError, RuntimeError,
                            OSError) as e:
                        h.consecutive_failures += 1
                        telemetry.log_event(
                            "worker_respawn_failed", level="error",
                            replica=h.replica, error=str(e))
                        self._schedule_restart(h)
            if now - last_scrape >= 1.0:
                last_scrape = now
                self._refresh_caches()
                if self.server_cfg.autoscale:
                    self._autoscale_tick(now)
            self._pump_deferred()

    def _refresh_caches(self) -> None:
        for h in self.workers:
            if h.state != UP or h.client is None:
                continue
            # The tick carries the pool's watermark and this region's
            # batched slab frees out; frees a failed call did not carry
            # go back for the next tick.
            frees = (self._arena_dir.drain_free(h.replica)
                     if self._arena_dir is not None else [])
            try:
                h.last_metrics = h.client.rpc("metrics")["samples"]
                h.last_stats = h.client.rpc(
                    "stats", fabric_free=self.fabric.free_pages,
                    arena_free=frees)["stats"]
                frees = []
                h.last_health = h.client.rpc("healthz")
                h.last_steps = h.client.rpc("steps")["steps"]
            except (WorkerGone, TimeoutError, RuntimeError):
                pass
            finally:
                if frees and self._arena_dir is not None:
                    self._arena_dir.requeue_free(h.replica, frees)

    def _schedule_restart(self, h: WorkerHandle) -> None:
        scfg = self.server_cfg
        if self._stopping:
            h.state = DEAD
            return
        # The budget covers respawns and consecutive boot failures: a
        # worker whose boot fails every time (no card, a deleted
        # checkpoint) ends quarantined, not respawning forever.
        if (h.restarts >= scfg.worker_restart_max
                or h.consecutive_failures > scfg.worker_restart_max):
            h.state = QUARANTINED
            telemetry.log_event("worker_quarantined", level="error",
                                replica=h.replica, restarts=h.restarts,
                                consecutive_failures=h.consecutive_failures)
            # No respawn will bump this region's epoch: reclaim now, or
            # its slabs stay pinned.
            self._reclaim_region(h.replica)
            return
        backoff = min(30.0, scfg.worker_restart_backoff_s
                      * (2 ** max(0, h.consecutive_failures)))
        h.restart_at = time.monotonic() + backoff
        h.state = RESTARTING

    def _note_rpc_timeout(self, h: WorkerHandle, verb: str,
                          timeout_s: float) -> None:
        with self._lock:
            self.rpc_timeouts += 1

    def _on_conn_lost(self, h: WorkerHandle, client: WorkerClient) -> None:
        if self._stopping or h.client is not client:
            return
        if client.lost_reason == "frame_error":
            with self._lock:
                self.frame_errors += 1
        # A broken connection to a live process is a transport fault:
        # reconnect, don't restart. A killed worker's socket closes
        # before its exit can be reaped, so a dying process gets a
        # moment first (else its requests would resync as after a
        # transport fault and miss the poison gate's evidence).
        if (h.state == UP and h.proc is not None
                and not self._exits_soon(h.proc)):
            threading.Thread(target=self._reconnect_worker,
                             args=(h, client), name="fleet-reconnect",
                             daemon=True).start()
            return
        if h.state in (UP, DRAINING):
            self._on_worker_down(h, "connection lost")

    @staticmethod
    def _exits_soon(proc: subprocess.Popen, grace_s: float = 0.25) -> bool:
        try:
            proc.wait(timeout=grace_s)
            return True
        except subprocess.TimeoutExpired:
            return False

    def _reconnect_worker(self, h: WorkerHandle,
                          old_client: WorkerClient) -> None:
        """Connection-level failover: redial the live worker, swap the
        client, resync the requests that rode the dead connection. Falls
        back to the worker-down path if the redial fails."""
        with self._lock:
            if h.client is not old_client or h.state != UP:
                return
        old_client.close()
        try:
            client = self._connect(h, h.proc, connect_timeout=5.0)
            client.rpc("hello")
        except (WorkerGone, TimeoutError, RuntimeError, OSError) as e:
            telemetry.log_event("worker_reconnect_failed",
                                level="warning", replica=h.replica,
                                reason=old_client.lost_reason,
                                error=str(e))
            if h.state in (UP, DRAINING):
                self._on_worker_down(h, f"reconnect failed: {e}")
            return
        with self._lock:
            if h.client is not old_client or h.state != UP:
                client.close()
                return
            # Chaos re-read at swap time: /debug/chaos may have retuned
            # it while this redial was in flight.
            client.chaos = self._make_chaos(h.replica)
            h.client = client
            self.reconnects += 1
        telemetry.log_event("worker_reconnect", level="warning",
                            replica=h.replica,
                            reason=old_client.lost_reason
                            or "connection lost")
        self._resync_worker(h, old_client)

    def _resync_worker(self, h: WorkerHandle,
                       old_client: WorkerClient) -> None:
        """Requests that streamed over the dead connection: cancel the
        worker-side ghost and re-dispatch from the router's token
        record, the same worker first (its pages are warm)."""
        with self._lock:
            victims = [e for e in self._tracked.values()
                       if e.worker is h and e.client is old_client]
            for entry in victims:
                entry.generation += 1
                entry.worker = entry.client = None
                entry.attempts += 1
                self.retries_attempted += 1
        for entry in victims:
            rid = entry.template.request_id
            if h.client is not None and h.client.alive:
                try:
                    h.client.rpc("cancel", rid=rid,
                                 idem=f"c{rid}.{entry.generation}")
                except (WorkerGone, TimeoutError, RuntimeError):
                    pass
            if self._quarantine_if_poison(entry):
                continue
            if h.routable and self._dispatch(entry, h, (0, 0, 0)):
                continue
            self._retry_or_fail(entry, exclude=h)

    def _quarantine_if_poison(self, entry: _Tracked) -> bool:
        """Once a request's attempts crashed or wedged
        ``poison_max_workers`` distinct workers, finish it "poison"
        instead of feeding it the rest of the fleet. True when it was."""
        limit = self.server_cfg.poison_max_workers
        if limit <= 0 or len(entry.failed_workers) < limit:
            return False
        rid = entry.template.request_id
        with self._lock:
            if self._tracked.pop(rid, None) is None:
                return True
            self.poison_requests += 1
            self._release_handoff_desc(entry)
        telemetry.log_event(
            "poison_quarantined", level="error",
            request_id=entry.template.trace_id or str(rid),
            workers=sorted(entry.failed_workers),
            attempts=entry.attempts, streamed=len(entry.tokens))
        if self._flight is not None:
            self._flight.capture("poison_request", min_interval_s=0.0)
        self._finish_trace(entry, "poison")
        ghost = entry.seq_local
        ghost.generated = list(entry.tokens)
        ghost.done, ghost.finish_reason = True, "poison"
        ghost.finish_time = time.perf_counter()
        entry.on_finish(ghost)
        return True

    def _on_worker_down(self, h: WorkerHandle, reason: str) -> None:
        """A worker incarnation died (kill -9, crash, or exit after a
        drain): fold its last series into the carry, fail its requests
        over from the router's token record, schedule a respawn under the
        same replica label."""
        with self._lock:
            # The monitor and the reader can both see the death; the
            # state flip picks one actor.
            if h.state not in (UP, DRAINING):
                return
            h.state = RETIRED if h.retiring else RESTARTING
        if h.state != RETIRED:
            h.consecutive_failures += 1
        if h.proc is not None and h.proc.poll() is None:
            try:
                h.proc.kill()
            except OSError:
                pass
        if h.proc is not None:
            try:
                h.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        if h.client is not None:
            h.client.close()
        if h.folded_incarnation != h.incarnation:
            # Once per incarnation, and the folded dump is cleared:
            # rendering it beside the carry would count it twice.
            h.folded_incarnation = h.incarnation
            telemetry.fold_dump_into_carry(h.carry, h.last_metrics)
            h.last_metrics = []
            slo = (h.last_stats or {}).get("slo") or {}
            h.slo_breach_carry["ttft"] += slo.get("ttft_breaches", 0)
            h.slo_breach_carry["tpot"] += slo.get("tpot_breaches", 0)
            if slo:
                h.last_stats = {**h.last_stats,
                                "slo": {**slo, "ttft_breaches": 0,
                                        "tpot_breaches": 0}}
        if h.state == RETIRED:
            # Intentional exit: the drain already migrated its requests
            # (the failover below is a safety net), nothing respawns.
            h.retiring = False
            telemetry.log_event("worker_retired", replica=h.replica,
                                reason=reason)
        else:
            telemetry.log_event("worker_down", level="warning",
                                replica=h.replica, reason=reason)
            self._harvest_blackbox(h, reason)
            self._schedule_restart(h)
        self._failover_worker(h)

    def _harvest_blackbox(self, h: WorkerHandle, reason: str) -> None:
        """The dead worker's flight-recorder captures (its directory is
        on the router's disk) go into the log."""
        root = self.server_cfg.blackbox_dir
        if not root:
            return
        rdir = os.path.join(root, f"replica-{h.replica}")
        try:
            captures = sorted(f for f in os.listdir(rdir)
                              if f.endswith(".json"))
        except OSError:
            captures = []
        if captures:
            telemetry.log_event(
                "worker_blackbox_harvested", replica=h.replica,
                reason=reason, captures=len(captures),
                newest=captures[-1], dir=rdir)

    # --------------------------------------------------------- routing

    def _routable(self) -> List[WorkerHandle]:
        return [h for h in self.workers if h.routable]

    def _fleet_load(self, h: WorkerHandle) -> int:
        with self._lock:
            return sum(1 for e in self._tracked.values() if e.worker is h)

    def _digests_for(self, seq: Sequence) -> Tuple[List[bytes], int]:
        ecfg = self.engine_cfg
        return routing_digests(seq, ecfg.page_size, ecfg.max_context)

    def _cold_peek(self, h: WorkerHandle) -> dict:
        """Scoring fallback for a worker that cannot answer a peek in
        time: no warmth, the router's load estimate, no pressure."""
        return {"hbm": 0, "host": 0, "load": self._fleet_load(h),
                "pressure": False, "occupancy": 0.0}

    def _peek(self, h: WorkerHandle, digests: List[bytes],
              timeout: float = 10.0) -> dict:
        client = h.client
        if client is None:
            return self._cold_peek(h)
        try:
            return client.rpc("peek", timeout=timeout,
                              digests=[d.hex() for d in digests])
        except (WorkerGone, TimeoutError, RuntimeError):
            return self._cold_peek(h)

    def _peek_many(self, cands: List[WorkerHandle],
                   digests: List[bytes]) -> List[dict]:
        """Candidate peeks in parallel under ``route_peek_timeout_s``; a
        straggler scores cold."""
        pool = self._peek_pool
        if len(cands) == 1 or self._stopping or pool is None:
            return [self._peek(h, digests) for h in cands]
        deadline = self.server_cfg.route_peek_timeout_s
        try:
            futs = [pool.submit(self._peek, h, digests, deadline + 0.5)
                    for h in cands]
        except RuntimeError:        # the pool shut down under a stop()
            return [self._peek(h, digests) for h in cands]
        _futures_wait(futs, timeout=deadline)
        return [f.result() if f.done() else self._cold_peek(h)
                for h, f in zip(cands, futs)]

    def _phase_pool(self, phase: Optional[str]) -> List[WorkerHandle]:
        """Routable workers for one phase: new prompts ("prefill") avoid
        decode-role workers, handoffs and resumes ("decode") avoid
        prefill-role ones. An empty phase pool falls back to every
        routable worker, so a degraded fleet still serves."""
        routable = self._routable()
        if not self.pd_enabled or phase is None:
            return routable
        exclude = "decode" if phase == "prefill" else "prefill"
        return ([h for h in routable
                 if self.roles[h.replica] != exclude] or routable)

    @staticmethod
    def _entry_phase(entry: _Tracked) -> str:
        """A resubmission's phase: a stream with tokens is decode work; a
        retry before any token re-enters as a prompt."""
        return "decode" if entry.tokens else "prefill"

    def _rotate(self, ties: list):
        if len(ties) == 1:
            return ties[0]
        idx = self._rr % len(ties)
        self._rr += 1
        return ties[idx]

    def _pick(self, cands: List[WorkerHandle],
              seq: Optional[Sequence] = None,
              phase: Optional[str] = None
              ) -> Tuple[WorkerHandle, Tuple[int, int, int], int]:
        """Choose a worker: (handle, (hbm, host, fabric_extra) peeked
        pages, load at decision time), by the formulas the in-process
        group uses (``kv_fabric``); the fabric depth comes from the
        router's own pool, no extra RPC. Under a P/D split a "decode"
        pick scores occupancy and load (``decode_route_score``)."""
        cfg = self.server_cfg
        digests: List[bytes] = []
        prompt_pages = 0
        if seq is not None and cfg.routing == "prefix_affinity":
            digests, prompt_pages = self._digests_for(seq)
        fdepth = self.fabric.match_depth(digests)
        peeks = self._peek_many(cands, digests)
        decode = phase == "decode" and self.pd_enabled
        if decode or (digests and (fdepth > 0 or any(
                p["hbm"] + p["host"] for p in peeks))):
            scored = []
            for h, p in zip(cands, peeks):
                fx = kv_fabric.fabric_extra_pages(
                    fdepth, p["hbm"] + p["host"], prompt_pages)
                if decode:
                    score = kv_fabric.decode_route_score(
                        cfg, hbm=p["hbm"], host=p["host"], fabric=fx,
                        load=p["load"],
                        occupancy=float(p.get("occupancy") or 0.0),
                        pressured=p["pressure"])
                else:
                    score = kv_fabric.prefill_route_score(
                        cfg, prompt_pages=prompt_pages, hbm=p["hbm"],
                        host=p["host"], fabric=fx, load=p["load"],
                        pressured=p["pressure"])
                scored.append(((score, p["pressure"], p["load"]),
                               h, (p["hbm"], p["host"], fx), p["load"]))
            best = min(key for key, _, _, _ in scored)
            return self._rotate([(h, hit, load)
                                 for key, h, hit, load in scored
                                 if key == best])
        keyed = [(kv_fabric.cold_route_key(p["pressure"], p["load"]), h,
                  p["load"])
                 for h, p in zip(cands, peeks)]
        best = min(key for key, _, _ in keyed)
        return self._rotate([(h, (0, 0, 0), load)
                             for key, h, load in keyed if key == best])

    # ------------------------------------------------------- submission

    def submit(self, seq: Sequence, on_token: Callable,
               on_finish: Callable) -> None:
        if not seq.trace_id:
            import uuid
            seq.trace_id = uuid.uuid4().hex[:16]
        # New prompts are prefill work (one snapshot of the routable
        # set, so the pick below never sees an empty pool).
        pool = self._phase_pool("prefill")
        if not pool:
            with self._lock:
                self.requests_unavailable += 1
            raise FleetUnavailable("no routable worker",
                                   self.server_cfg.retry_after_s)
        t_route = time.perf_counter()
        h, hit, load = self._pick(pool, seq)
        self._recorder.add(
            "route", seq.trace_id, t_route, time.perf_counter(),
            dest=h.replica, hbm_hit=hit[0], host_hit=hit[1],
            fabric_hit=hit[2], load=load)
        cap = self.server_cfg.admission_queue_depth
        if cap > 0 and load >= cap:
            # Affinity saturated a warm worker: least-loaded fallback
            # before shedding.
            h2, _, load2 = self._pick(pool)
            if load2 >= cap:
                # Class lanes: over the cap a batch or background request
                # parks in its lane instead of a 429, and an interactive
                # one preempts the newest lowest-class running request
                # (which resumes from the token record) and takes its
                # slot. Only when neither works does the shed fire.
                cls = seq.priority_class or "interactive"
                if self.server_cfg.class_queue_depth > 0:
                    if class_rank(cls) > 0:
                        if self._defer(seq, on_token, on_finish, cls):
                            return
                        self._shed(seq, cls, load2, cap)
                    vw = self._preempt_for_interactive()
                    if vw is None:
                        self._shed(seq, cls, load2, cap)
                    h, hit = vw, (0, 0, 0)
                else:
                    self._shed(seq, cls, load2, cap)
            else:
                h, hit = h2, self._peek_hit(h2, seq)
        entry = _Tracked(_clone_request(seq), on_token, on_finish)
        entry.seq_local.trace_id = seq.trace_id
        entry.seq_local.enqueue_time = time.perf_counter()
        with self._lock:
            self._tracked[seq.request_id] = entry
        if not self._dispatch(entry, h, hit):
            self._retry_or_fail(entry, exclude=h)

    def _peek_hit(self, h: WorkerHandle,
                  seq: Sequence) -> Tuple[int, int, int]:
        if self.server_cfg.routing != "prefix_affinity":
            return (0, 0, 0)
        digests, prompt_pages = self._digests_for(seq)
        p = self._peek(h, digests)
        fx = kv_fabric.fabric_extra_pages(
            self.fabric.match_depth(digests), p["hbm"] + p["host"],
            prompt_pages)
        return (p["hbm"], p["host"], fx)

    def _fabric_pull(self, h: WorkerHandle, t: Sequence, warm: int,
                     fabric_extra: int, entry: _Tracked) -> int:
        """Ship the fabric run beyond ``warm`` pages into worker ``h``'s
        host tier (import-kv), before its submit: the verb replies once
        the engine loop applied the import, so the request's prefill
        sees the pages. get_pages verifies every blob (a corrupt or
        since-evicted entry shortens the run), and the worker verifies
        the one import blob again. On the shm plane a run of descriptor
        entries goes as descriptors: the worker reads and verifies each
        slab, and the digests it rejects are dropped from the pool; no KV
        byte passes through the router. Returns the pages applied; 0 on
        a transport failure, and the dispatch goes on cold. An applied
        pull is recorded in ``fabric_pulls``: its wall and bytes, the
        worker's parts of it (``worker_parts_s``: slab reads, deserialize,
        the wait for the engine loop), and on the relay plane the
        router's pool read and serialize."""
        if h.client is None:
            return 0
        t0 = time.perf_counter()
        digests = self._digests_for(t)[0]
        want = digests[warm:warm + fabric_extra]
        if self.arena is not None:
            descs = self.fabric.get_descs(want)
            if descs:
                try:
                    r = h.client.rpc(
                        "import-kv", digests=[d.hex() for d, _ in descs],
                        descs=[dd for _, dd in descs],
                        idem=f"fd{t.request_id}.{entry.attempts}."
                             f"{entry.generation}")
                except (WorkerGone, TimeoutError, RuntimeError) as e:
                    telemetry.log_event("fabric_pull_failed",
                                        level="warning", replica=h.replica,
                                        error=str(e))
                    return 0
                rejected = r.get("rejected_digests") or ()
                for hexd in rejected:
                    self.fabric.reject(bytes.fromhex(hexd))
                if not r.get("applied"):
                    return 0
                self.fabric_pulls.append({
                    "replica": h.replica, "pages": len(descs),
                    "bytes": sum(int(dd["len"]) for _, dd in descs),
                    "wall_s": time.perf_counter() - t0, "plane": "shm",
                    "worker_parts_s": r.get("parts_s")})
                return max(0, len(descs) - len(rejected))
        entries = self.fabric.get_pages(want)
        if not entries:
            return 0
        t_get = time.perf_counter()
        try:
            blob = kvc.serialize_host_pages([p for _, p in entries])
            t_ser = time.perf_counter()
            with self._lock:
                self.rpc_blob_bytes["import-kv"] += len(blob)
            r = h.client.rpc(
                "import-kv", blob=blob,
                digests=[d.hex() for d, _ in entries],
                idem=f"f{t.request_id}.{entry.attempts}.{entry.generation}")
            if not r.get("applied"):
                return 0
        except (WorkerGone, TimeoutError, RuntimeError) as e:
            telemetry.log_event("fabric_pull_failed", level="warning",
                                replica=h.replica, error=str(e))
            return 0
        self.fabric_pulls.append({"replica": h.replica,
                                  "pages": len(entries), "bytes": len(blob),
                                  "wall_s": time.perf_counter() - t0,
                                  "plane": "relay",
                                  "get_s": t_get - t0,
                                  "serialize_s": t_ser - t_get,
                                  "worker_parts_s": r.get("parts_s")})
        return len(entries)

    def _shed(self, seq: Sequence, cls: str, load: int, cap: int) -> None:
        """The terminal 429, counted globally and by class. Clients pin
        the message: it is the single-cap shed's, letter for letter."""
        with self._lock:
            self.requests_shed += 1
            self.class_shed[cls] = self.class_shed.get(cls, 0) + 1
        # A shed is terminal: seal its route span.
        self._recorder.seal(seq.trace_id)
        raise FleetSaturated(
            f"admission queue cap reached ({load} >= {cap} on "
            "the least-loaded worker)",
            self.server_cfg.retry_after_s)

    def _defer(self, seq: Sequence, on_token: Callable,
               on_finish: Callable, cls: str) -> bool:
        """Park a batch or background request in its class lane. False
        when the lane is full (then the caller sheds: the lanes are
        bounded, so a flood cannot grow the router's memory)."""
        entry = _Tracked(_clone_request(seq), on_token, on_finish)
        entry.seq_local.trace_id = seq.trace_id
        entry.seq_local.enqueue_time = time.perf_counter()
        with self._lock:
            q = self._deferred[cls]
            if len(q) >= self.server_cfg.class_queue_depth:
                return False
            self._tracked[seq.request_id] = entry
            q.append(entry)
        telemetry.log_event("request_deferred", request_id=seq.request_id,
                            trace_id=seq.trace_id, priority_class=cls)
        return True

    def _preempt_for_interactive(self) -> Optional[WorkerHandle]:
        """Evict the newest lowest-class running request to the front of
        its lane (its re-dispatch replays the streamed tokens, identical
        under greedy) and return the worker whose slot it freed."""
        with self._lock:
            victims = [e for e in self._tracked.values()
                       if e.worker is not None
                       and class_rank(e.template.priority_class) > 0]
            if not victims:
                return None
            victim = max(victims, key=lambda e: (
                class_rank(e.template.priority_class), e.t_submit))
            vw, vc = victim.worker, victim.client
            # Detached under the lock: its worker's late events no longer
            # match, and no failover path claims it.
            victim.generation += 1
            victim.worker = victim.client = None
            victim.attempts += 1
            vcls = victim.template.priority_class
            self.class_preemptions[vcls] = (
                self.class_preemptions.get(vcls, 0) + 1)
            # Front of its lane: it resumes before never-started work of
            # its class.
            self._deferred[vcls].appendleft(victim)
        rid = victim.template.request_id

        def _rpc_cancel(client=vc):
            try:
                client.rpc("cancel", timeout=10.0, rid=rid)
            except (WorkerGone, TimeoutError, RuntimeError):
                pass

        if vc is not None:
            threading.Thread(target=_rpc_cancel, daemon=True,
                             name="fleet-preempt-cancel").start()
        telemetry.log_event("class_preempted", request_id=rid,
                            trace_id=victim.template.trace_id,
                            priority_class=vcls, replica=vw.replica)
        return vw

    def _pump_deferred(self) -> None:
        """Re-admit parked requests as capacity frees, batch before
        background. The monitor is the lanes' one consumer, and an entry
        leaves its lane under the lock before its dispatch, so no other
        path (a handoff, a retried finish, a failover) can hold it: they
        claim only entries bound to a worker, and a parked one is not."""
        if not any(self._deferred.values()):
            return
        cap = self.server_cfg.admission_queue_depth
        while True:
            with self._lock:
                entry = None
                for cls in ("batch", "background"):
                    q = self._deferred[cls]
                    # Drop heads cancelled while parked.
                    while q and q[0].template.request_id \
                            not in self._tracked:
                        q.popleft()
                    if q:
                        entry = q[0]
                        break
                if entry is None:
                    return
            pool = self._phase_pool(self._entry_phase(entry))
            if not pool:
                return
            h, hit, load = self._pick(pool, entry.template)
            if cap > 0 and load >= cap:
                return
            with self._lock:
                q = self._deferred[cls]
                if (not q or q[0] is not entry
                        or entry.template.request_id not in self._tracked):
                    continue
                q.popleft()
            if not self._dispatch(entry, h, hit):
                self._retry_or_fail(entry, exclude=h)

    def _dispatch(self, entry: _Tracked, h: WorkerHandle,
                  hit: Tuple[int, int, int]) -> bool:
        """Submit one attempt to one worker. False when the worker
        refused (dead or draining), so the caller re-routes."""
        t = entry.template
        gen_tokens = list(entry.tokens)
        with self._lock:
            entry.worker, entry.client = h, h.client
            gen0 = entry.generation
        hbm, host, fabric_extra = hit
        meta, handoff_blob = entry.handoff_meta, entry.handoff_blob
        handoff_desc = entry.handoff_desc
        live_handoff = (meta is not None
                        and bool(handoff_blob or handoff_desc)
                        and len(gen_tokens) == meta["n_generated"])
        # The fabric pull, before the submit. A live handoff skips it:
        # the attempt carries the whole KV already.
        fabric_pulled = 0
        if fabric_extra > 0 and not live_handoff:
            fabric_pulled = self._fabric_pull(h, t, hbm + host,
                                              fabric_extra, entry)
        total_hit = hbm + host + fabric_pulled
        sl = entry.seq_local
        sl.routed_replica = h.replica
        sl.route_hit_pages = total_hit
        sl.route_host_hit_pages = host
        sl.route_fabric_hit_pages = fabric_pulled
        sl.attempt = entry.attempts
        stats = self._route_stats[h.replica]
        if total_hit > 0:
            self.route_prefix_hits += 1
            stats["hits"] += 1
            stats["hit_pages"] += total_hit
            stats["host_hit_pages"] += host
            self._route_hit_pages_hist.observe(total_hit)
        else:
            self.route_cold += 1
            stats["cold"] += 1
        if fabric_pulled > 0:
            self.route_fabric_hits += 1
            stats["fabric_hit_pages"] += fabric_pulled
            self._route_fabric_hit_pages_hist.observe(fabric_pulled)
        if gen_tokens:
            self.resume_resubmits += 1
            entry.resume_stream_len = min(
                len(t.prompt_tokens) + len(gen_tokens),
                self.engine_cfg.max_context - 1)
        blob = b""
        payload_handoff = None
        if meta is not None:
            if live_handoff:
                # A live handoff: the worker adopts the exported pages
                # and decodes on with nothing recomputed. On the shm
                # plane the frame carries the descriptor only.
                payload_handoff = {"ctx_len": meta["ctx_len"]}
                if handoff_desc is not None:
                    payload_handoff["kv_desc"] = handoff_desc
                else:
                    blob = handoff_blob
            else:
                # Decode went past the export (the blob was dropped at
                # the adopter's first token), or it was never usable:
                # recompute-resume from the token record.
                entry.handoff_blob = entry.handoff_meta = None
                self._release_handoff_desc(entry)
                with self._lock:
                    self.pd_handoff_recomputes += 1
        payload = {
            "request_id": t.request_id,
            "route_hit_pages": total_hit,
            "route_host_hit_pages": host,
            "route_fabric_hit_pages": fabric_pulled,
            "prompt_tokens": list(t.prompt_tokens),
            "max_new_tokens": t.max_new_tokens,
            "temperature": t.temperature, "top_p": t.top_p,
            "top_k": t.top_k, "seed": t.seed,
            "repeat_penalty": t.repeat_penalty,
            "repeat_last_n": t.repeat_last_n,
            "eos_token_id": t.eos_token_id,
            "trace_id": t.trace_id,
            "class": t.priority_class,
            "attempt": entry.attempts,
            "generated": gen_tokens,
        }
        if payload_handoff is not None:
            payload["handoff"] = payload_handoff
        # One token per dispatch attempt: a duplicate submit frame (a
        # retry after a lost ack) replays the recorded ack.
        idem = f"s{t.request_id}.{entry.attempts}.{entry.generation}"
        client = h.client
        try:
            if client is None:
                raise WorkerGone("worker not connected")
            if blob:
                with self._lock:
                    self.rpc_blob_bytes["submit"] += len(blob)
            client.rpc("submit", seq=payload, blob=blob, idem=idem)
            return True
        except (WorkerGone, RuntimeError) as e:
            telemetry.log_event(
                "dispatch_refused", level="warning", replica=h.replica,
                request_id=t.request_id, error=str(e) or type(e).__name__)
            if (isinstance(e, WorkerGone) and client is not None
                    and self._await_verdict(h, client)):
                # The connection died under this submit, and the entry
                # stayed on h meanwhile: a worker-down failover took it
                # over (counting the death toward the poison gate), or a
                # redial's resync re-sent it. Else h went down before its
                # failover reached the entry: the death counts here.
                with self._lock:
                    if entry.worker is not h or entry.generation != gen0:
                        return True
                    if h.state not in (UP, DRAINING):
                        entry.failed_workers.add(h.replica)
            return False
        except TimeoutError:
            # The worker wedged with this attempt: it counts toward the
            # poison gate, and the cancel keeps a late ghost from
            # decoding beside the re-routed copy.
            entry.failed_workers.add(h.replica)
            try:
                client.rpc("cancel", timeout=5.0, rid=t.request_id,
                           idem=f"c{idem}")
            except (WorkerGone, TimeoutError, RuntimeError):
                pass
            return False

    def _await_verdict(self, h: WorkerHandle, client: WorkerClient) -> bool:
        """Wait (at most _VERDICT_S) until the fleet has ruled on a lost
        connection of ``h``: the worker was taken down or the connection
        was replaced. However slowly a killed worker is reaped, its
        death is then seen before the caller re-routes the request."""
        deadline = time.monotonic() + _VERDICT_S
        while time.monotonic() < deadline and not self._stopping:
            if h.client is not client or h.state != UP:
                return True
            time.sleep(0.02)
        return False

    def _retry_or_fail(self, entry: _Tracked,
                       exclude: Optional[WorkerHandle] = None) -> None:
        """Re-route an attempt after a refused dispatch, re-picking for a
        short grace window (a redial or a restart is often in progress)
        before the request fails "unavailable". Each round re-checks the
        claim, so a competing failover path never runs it twice."""
        if exclude is not None:
            with self._lock:
                if entry.worker is not exclude:
                    return          # another path took this entry over
                entry.worker = entry.client = None
        last = exclude
        deadline = time.monotonic() + _REROUTE_GRACE_S
        while not self._stopping:
            if self._quarantine_if_poison(entry):
                return
            phase = self._entry_phase(entry)
            pool = ([h for h in self._phase_pool(phase) if h is not last]
                    or [h for h in self._routable() if h is not last]
                    or self._routable())
            if pool:
                h, hit, _ = self._pick(pool, entry.template, phase=phase)
                if self._dispatch(entry, h, hit):
                    return
                with self._lock:
                    if entry.worker is not h:
                        return
                    entry.worker = entry.client = None
                last = h
            if time.monotonic() >= deadline:
                break
            time.sleep(0.25)
        rid = entry.template.request_id
        with self._lock:
            if self._tracked.pop(rid, None) is None:
                return          # cancelled, or finished by stop()
            self._release_handoff_desc(entry)
        telemetry.log_event("request_unavailable", level="warning",
                            request_id=rid, attempts=entry.attempts)
        self._finish_trace(entry, "unavailable")
        ghost = entry.seq_local
        ghost.done, ghost.finish_reason = True, "unavailable"
        ghost.finish_time = time.perf_counter()
        entry.on_finish(ghost)

    def cancel(self, request_id: int) -> None:
        with self._lock:
            entry = self._tracked.pop(request_id, None)
            if entry is not None:
                entry.generation += 1
                h = entry.worker
                self._release_handoff_desc(entry)
        if entry is None or h is None or h.client is None:
            return

        def _rpc_cancel(client=h.client):
            # Fire and forget: HTTP handlers must not block on a slow
            # worker; a lost cancel costs a few wasted tokens.
            try:
                client.rpc("cancel", rid=request_id,
                           idem=f"c{request_id}.x")
            except (WorkerGone, TimeoutError, RuntimeError):
                pass

        threading.Thread(target=_rpc_cancel, name="fleet-cancel",
                         daemon=True).start()

    # ----------------------------------------------------------- events

    def _on_event(self, h: WorkerHandle, client: WorkerClient,
                  obj: dict, blob: bytes) -> None:
        ev = obj.get("ev")
        if self._stopping and ev in ("migrate", "drained"):
            return      # teardown: no re-routing onto closing workers
        if ev == "token":
            self._on_token(h, client, obj)
        elif ev == "finish":
            self._on_finish(h, client, obj)
        elif ev == "handoff":
            self._on_handoff(h, client, obj, blob)
        elif ev == "spans":
            # A prefill worker's spans, sealed after its handoff left.
            self._recorder.ingest(obj.get("trace") or "",
                                  obj.get("spans") or ())
        elif ev == "migrate":
            self._on_migrate(h, client, obj, blob)
        elif ev == "fabric_put":
            self._on_fabric_put(h, obj, blob)
        elif ev == "drained":
            self._on_drained(h, client, obj)

    def _on_fabric_put(self, h: WorkerHandle, obj: dict,
                       blob: bytes) -> None:
        """Pool a worker's published prefix pages. The frame carries each
        page's blob length, so the reader slices without deserializing;
        every pull verifies its blob, so a corrupt publish can take a
        slot but is never adopted. A frame whose lengths disagree with
        its blob is dropped whole. On the shm plane the frame carries
        descriptors and no blob: each slab is registered with the slab
        books and its descriptor pooled."""
        digests = obj.get("digests") or ()
        descs = obj.get("descs")
        if descs is not None:
            if len(digests) != len(descs) or blob:
                with self._lock:
                    self.frame_errors += 1
                telemetry.log_event(
                    "fabric_put_malformed", level="warning",
                    replica=h.replica, digests=len(digests),
                    descs=len(descs), blob_bytes=len(blob))
                return
            for d, desc in zip(digests, descs):
                if self._arena_dir is not None:
                    self._arena_dir.register(desc)
                self.fabric.put_desc(bytes.fromhex(d), desc)
            return
        lens = obj.get("lens") or ()
        if len(digests) != len(lens) or sum(lens) != len(blob):
            with self._lock:
                self.frame_errors += 1
            telemetry.log_event(
                "fabric_put_malformed", level="warning",
                replica=h.replica, digests=len(digests),
                lens=len(lens), blob_bytes=len(blob))
            return
        with self._lock:
            self.rpc_blob_bytes["fabric_put"] += len(blob)
        off = 0
        for d, n in zip(digests, lens):
            self.fabric.put_blob(bytes.fromhex(d), blob[off:off + n])
            off += n

    def _fabric_salvage(self, digests: List[bytes], blob: bytes,
                        rid: int, path: str) -> int:
        """A handoff or a drain export whose destination is gone: park
        its full prefix pages in the fabric pool under their chain
        digests, so the retry's dispatch pulls them back instead of
        prefilling the whole stream again. Pages past the digest chain
        (a partial last page) recompute. Returns the pages parked."""
        if self.fabric.capacity <= 0 or not blob or not digests:
            return 0
        try:
            pages = kvc.deserialize_host_pages(blob)
        except KVIntegrityError:        # checked upstream; best effort
            return 0
        n = self.fabric.put_pages(list(zip(digests, pages)))
        if n:
            telemetry.log_event("fabric_salvage", level="info", path=path,
                                request_id=rid, pages=n)
        return n

    def _entry_for(self, rid: int, h: WorkerHandle,
                   client: WorkerClient) -> Optional[_Tracked]:
        entry = self._tracked.get(rid)
        if entry is None or entry.worker is not h \
                or entry.client is not client:
            return None
        return entry

    def _on_token(self, h, client, obj) -> None:
        with self._lock:
            entry = self._entry_for(obj["rid"], h, client)
            if entry is None:
                return
            tok = int(obj["t"])
            k = obj.get("k")
            if k is not None and int(k) != len(entry.tokens):
                # A stream-index gap: a frame went missing or came twice.
                # Appending would corrupt the completion; recycle the
                # connection and resync from the last good prefix.
                client.lost_reason = client.lost_reason or "stream_gap"
                bad = client
            else:
                bad = None
                entry.tokens.append(tok)
                meta = entry.handoff_meta
                if ((entry.handoff_blob is not None
                     or entry.handoff_desc is not None) and meta is not None
                        and len(entry.tokens) > meta["n_generated"]):
                    # The adopter streamed past the export: adopting it
                    # again would fork the stream. Drop it now.
                    entry.handoff_blob = None
                    self._release_handoff_desc(entry)
                sl = entry.seq_local
                sl.generated.append(tok)
                if sl.first_token_time == 0.0:
                    sl.first_token_time = time.perf_counter()
                    # The autoscaler's sensor: submit to first streamed
                    # token, lane park time included.
                    self._ttft_obs.append(
                        (sl.first_token_time,
                         sl.first_token_time - entry.t_submit))
        if bad is not None:
            telemetry.log_event(
                "stream_gap", level="error", replica=h.replica,
                request_id=obj["rid"], expected=len(entry.tokens),
                got=int(k))
            bad.close()
            return
        entry.on_token(sl, tok)

    def _finish_trace(self, entry: _Tracked, reason: str) -> None:
        """The router's root span (submit -> terminal, every attempt
        inside it) and the seal of the assembled cross-process trace."""
        rec = self._recorder
        if not rec.enabled:
            return
        t = entry.template
        tid = t.trace_id or str(t.request_id)
        rec.add("request", tid, entry.t_submit, time.perf_counter(),
                parent="", reason=reason, attempts=entry.attempts,
                output_tokens=len(entry.tokens))
        rec.seal(tid)

    def _on_finish(self, h, client, obj) -> None:
        rid = obj["rid"]
        reason = obj.get("reason", "stop")
        # The worker's spans ride the finish frame.
        self._recorder.ingest(obj.get("trace") or "",
                              obj.get("spans") or ())
        with self._lock:
            entry = self._entry_for(rid, h, client)
            if entry is None:
                return
            retryable = (reason in _RETRYABLE
                         and not entry.tokens
                         and entry.attempts
                         < self.server_cfg.failover_max_retries)
            # A retry before any token replays the prompt: prefill work.
            pool = ([w for w in self._phase_pool("prefill") if w is not h]
                    or self._routable()) if retryable else []
            if pool:
                entry.attempts += 1
                entry.generation += 1
                entry.worker = entry.client = None   # claim
                self.retries_attempted += 1
            else:
                self._tracked.pop(rid, None)
                self._release_handoff_desc(entry)
                if entry.attempts and reason in ("stop", "length"):
                    self.retries_succeeded += 1
            # The resume stream this attempt re-prefilled, minus what the
            # destination's cache tiers (migrated pages included) served.
            if entry.resume_stream_len and not pool:
                cached = int(obj.get("cached_tokens", 0))
                reused = min(cached, entry.resume_stream_len)
                self.resume_reused_tokens += reused
                self.resume_recomputed_tokens += (
                    entry.resume_stream_len - reused)
        if pool:
            # On a thread of its own: the pick may land on h, whose reply
            # only this reader can deliver.
            threading.Thread(target=self._redispatch, args=(entry, pool),
                             name="fleet-retry", daemon=True).start()
            return
        self._finish_trace(entry, reason)
        sl = entry.seq_local
        sl.done = True
        sl.finish_reason = reason
        sl.finish_time = time.perf_counter()
        sl.cached_tokens = int(obj.get("cached_tokens", 0))
        sl.host_restored_pages = int(obj.get("host_restored_pages", 0))
        sl.preemptions = int(obj.get("preemptions", 0))
        if sl.first_token_time and obj.get("prefill_s") is not None:
            # A local prefill start from the worker's prefill duration,
            # so the Ollama duration fields hold.
            sl.prefill_start = max(
                sl.enqueue_time,
                sl.first_token_time - float(obj["prefill_s"]))
        entry.on_finish(sl)

    def _redispatch(self, entry: _Tracked, pool: List[WorkerHandle]
                    ) -> None:
        h, hit, _ = self._pick(pool, entry.template)
        if not self._dispatch(entry, h, hit):
            self._retry_or_fail(entry, exclude=h)

    def _checked_blob(self, blob: bytes, path: str, rid: int) -> bytes:
        """Gate a KV blob on its digest before it is imported: a corrupt
        one is rejected and counted, and the request recompute-resumes
        from the router's token record."""
        if not blob:
            return blob
        err = kvc.verify_host_pages_blob(blob)
        if err is None:
            return blob
        with self._lock:
            self.kv_rejections += 1
        telemetry.log_event(
            "kv_blob_rejected", level="error", path=path,
            request_id=rid, bytes=len(blob), error=err)
        if self._flight is not None:
            self._flight.capture("kv_corruption", min_interval_s=0.0)
        return b""

    def _on_handoff(self, h, client, obj, blob) -> None:
        """A prefill worker settled a prompt and exported the live
        sequence (its pages, the partial final page included): claim the
        request here, on the connection's reader thread, then route it on
        a thread of its own (``_handoff_resume``): with no decode worker
        routable the destination may be this same worker, whose reply
        only this reader can deliver."""
        rid = obj["rid"]
        t0 = time.perf_counter()
        with self._lock:
            entry = self._entry_for(rid, h, client)
            if entry is None:
                return
            entry.generation += 1
            # Detach under the lock: a racing worker-down failover must
            # not resubmit it as well.
            entry.worker = entry.client = None
            entry.attempts += 1
            self.pd_handoffs += 1
            if blob:
                self.rpc_blob_bytes["handoff"] += len(blob)
            kv_desc = obj.get("kv_desc")
            if kv_desc is not None:
                # The shm plane: the export is in the prefill worker's
                # slab; the books hold it until the adopter streams past
                # it or a fallback lets go.
                if self._arena_dir is not None:
                    self._arena_dir.register(kv_desc)
                entry.handoff_desc = dict(kv_desc)
        threading.Thread(target=self._handoff_resume,
                         args=(h, entry, obj, blob, t0),
                         name="fleet-handoff", daemon=True).start()

    def _handoff_resume(self, h: WorkerHandle, entry: _Tracked, obj: dict,
                        blob: bytes, t0: float) -> None:
        """Check the handoff blob's digest and resume the request on the
        least-loaded decode worker as an adoption; every failure falls
        back to the recompute-resume machinery. A descriptor export is
        checked by its adopter, which reads the slab."""
        rid = entry.template.request_id
        n_gen = int(obj.get("n_generated", 0))
        entry.handoff_meta = {"ctx_len": int(obj.get("ctx_len", 0)),
                              "n_generated": n_gen}
        checked = self._checked_blob(blob, "handoff", rid)
        entry.handoff_blob = checked or None
        if n_gen != len(entry.tokens):
            # Out of step with the export (events are in order on a
            # connection, so this should not happen): recompute.
            telemetry.log_event(
                "handoff_token_mismatch", level="warning",
                request_id=entry.template.trace_id or str(rid),
                worker_generated=n_gen, router_streamed=len(entry.tokens))
            entry.handoff_blob = None
            self._release_handoff_desc(entry)
        pool = ([w for w in self._phase_pool("decode") if w is not h]
                or [w for w in self._routable() if w is not h]
                or self._routable())
        if not pool:
            # No destination: park the settled prefix in the fabric pool,
            # so the grace-window retry's dispatch pulls it back. A
            # descriptor export is read out of the arena first (the pool
            # entry outlives the slab).
            desc, arena = entry.handoff_desc, self.arena
            if not checked and desc is not None and arena is not None:
                try:
                    checked = arena.read(desc)
                except shm_arena.ArenaError:
                    checked = b""
                self._release_handoff_desc(entry)
                entry.handoff_blob = checked or None
            self._fabric_salvage(self._digests_for(entry.template)[0],
                                 checked, rid, "handoff")
            self._retry_or_fail(entry)     # already claimed
            return
        if len(pool) == 1:
            # One candidate: a peek could not change the answer.
            dest, hit = pool[0], (0, 0, 0)
        else:
            dest, hit, _ = self._pick(pool, entry.template, phase="decode")
        telemetry.log_event(
            "request_handoff", level="info",
            request_id=entry.template.trace_id or str(rid),
            source=h.replica, dest=dest.replica,
            ctx_len=entry.handoff_meta["ctx_len"],
            streamed=len(entry.tokens))
        if self._dispatch(entry, dest, hit):
            self._pd_handoff_s_hist.observe(
                float(obj.get("export_s") or 0.0)
                + time.perf_counter() - t0)
            # Routing and dispatch until the decode worker accepted the
            # resume (the worker's handoff_export span precedes it).
            self._recorder.add(
                "handoff", entry.template.trace_id or str(rid), t0,
                time.perf_counter(), source=h.replica, dest=dest.replica,
                export_s=obj.get("export_s"), streamed=len(entry.tokens))
        else:
            self._retry_or_fail(entry, exclude=dest)

    def _on_migrate(self, h, client, obj, blob) -> None:
        """A draining worker exported one in-flight request: claim it
        here, on the connection's reader thread, then import its pages
        into a destination's host tier and resubmit with the router's
        token record (the swap-in-resume path) on a thread of its own,
        so the reader takes the drain's next export at once and the
        exports land side by side."""
        rid = obj["rid"]
        t_mig = time.perf_counter()
        self._recorder.ingest(obj.get("trace") or "",
                              obj.get("spans") or ())
        with self._lock:
            # A draining worker refuses submits, and its drained event
            # trails its exports on the connection: it leaves the
            # routable set at its first export, so a salvage retry
            # routed in between does not pick it.
            if h.state == UP:
                h.state = DRAINING
            entry = self._entry_for(rid, h, client)
            if entry is None:
                return
            entry.generation += 1
            # Detach under the lock: the monitor's worker-down failover
            # can race this handler; whoever claims first resubmits.
            entry.worker = entry.client = None
            entry.attempts += 1
            self.migrations += 1
            self.retries_attempted += 1
            self.failovers += 1
            if blob:
                self.rpc_blob_bytes["migrate"] += len(blob)
            kv_desc = obj.get("kv_desc")
            if kv_desc is not None and self._arena_dir is not None:
                # The shm plane: the export is in the draining worker's
                # slab until the destination has read it.
                self._arena_dir.register(kv_desc)
                self._arena_reads[int(kv_desc["rg"])] += 1
        threading.Thread(target=self._migrate_resume,
                         args=(h, entry, obj, blob, t_mig),
                         name="fleet-migrate", daemon=True).start()

    def _migrate_resume(self, h: WorkerHandle, entry: _Tracked, obj: dict,
                        blob: bytes, t_mig: float) -> None:
        kv_desc = obj.get("kv_desc")
        if kv_desc is None or self._arena_dir is None:
            kv_desc = None
        let_go = []

        def read_done() -> None:
            # The export's slab has been read (or never will be): it is
            # let go at once, before any wait for a destination, so the
            # source region's reclaim at its respawn goes ahead (the
            # respawn may be the destination that wait is for).
            if kv_desc is not None and not let_go:
                let_go.append(True)
                self._arena_dir.release(kv_desc)
                with self._lock:
                    self._arena_reads[int(kv_desc["rg"])] -= 1

        try:
            self._migrate_to(h, entry, obj, blob, t_mig, kv_desc, read_done)
        finally:
            read_done()

    def _migrate_to(self, h: WorkerHandle, entry: _Tracked, obj: dict,
                    blob: bytes, t_mig: float, kv_desc: Optional[dict],
                    read_done: Callable[[], None]) -> None:
        rid = entry.template.request_id
        n_gen = int(obj.get("n_generated", 0))
        if n_gen != len(entry.tokens):
            telemetry.log_event(
                "migrate_token_mismatch", level="warning",
                request_id=entry.template.trace_id or str(rid),
                worker_generated=n_gen, router_streamed=len(entry.tokens))
        digests = [bytes.fromhex(d) for d in obj.get("digests") or ()]
        blob = self._checked_blob(blob, "migrate", rid)
        others = ([w for w in self._phase_pool(self._entry_phase(entry))
                   if w is not h]
                  or [w for w in self._routable() if w is not h])
        if not others:
            # No destination: park the exported pages in the fabric pool
            # (under the digests the export carried), so the
            # grace-window retry's dispatch pulls them back. A
            # descriptor export is read out of the arena first.
            arena = self.arena
            if not blob and kv_desc is not None and arena is not None:
                try:
                    blob = arena.read(kv_desc)
                except shm_arena.ArenaError:
                    blob = b""
            read_done()
            self._fabric_salvage(digests, blob, rid, "migrate")
            self._retry_or_fail(entry)
            return
        dest, hit, _ = self._pick(others, entry.template,
                                  phase=self._entry_phase(entry))
        if ((blob or kv_desc is not None) and digests
                and self.server_cfg.fleet_migrate
                and dest.client is not None):
            try:
                if kv_desc is not None:
                    # The destination reads the slab itself: no KV byte
                    # passes through the router.
                    r = dest.client.rpc(
                        "import-kv", kv_desc=kv_desc,
                        digests=[d.hex() for d in digests],
                        idem=f"i{rid}.{entry.generation}")
                    moved = int(kv_desc.get("len", 0))
                else:
                    with self._lock:
                        self.rpc_blob_bytes["import-kv"] += len(blob)
                    r = dest.client.rpc(
                        "import-kv", blob=blob,
                        digests=[d.hex() for d in digests],
                        idem=f"i{rid}.{entry.generation}")
                    moved = len(blob)
                with self._lock:
                    self.migrated_pages += int(r.get("adopted", 0))
                    self.migrated_bytes += moved
                # The routing span reflects the warmth just imported.
                hit = self._peek_hit(dest, entry.template)
            except (WorkerGone, TimeoutError, RuntimeError) as e:
                telemetry.log_event("migrate_import_failed",
                                    level="warning", error=str(e))
        read_done()
        telemetry.log_event(
            "request_migrated", level="warning",
            request_id=entry.template.trace_id or str(rid),
            source=h.replica, dest=dest.replica,
            pages=len(digests), streamed=len(entry.tokens))
        if self._dispatch(entry, dest, hit):
            self._recorder.add(
                "migrate", entry.template.trace_id or str(rid),
                t_mig, time.perf_counter(), source=h.replica,
                dest=dest.replica, pages=len(digests),
                streamed=len(entry.tokens))
        else:
            self._retry_or_fail(entry, exclude=dest)

    def _on_drained(self, h, client, obj) -> None:
        """Graceful exit notice: its final stats and metrics are the
        restart carry (exact, unlike a kill -9's last periodic scrape).
        The process exits next; the monitor respawns it, and any request
        the drain did not migrate fails over like a kill."""
        if obj.get("metrics") and h.folded_incarnation != h.incarnation:
            h.last_metrics = obj["metrics"]
        if obj.get("stats"):
            h.last_stats = obj["stats"]
        if h.state == UP:
            h.state = DRAINING
        telemetry.log_event(
            "worker_drained", level="info", replica=h.replica,
            migrated_requests=obj.get("migrated_requests", 0))

    def _failover_worker(self, h: WorkerHandle) -> None:
        """Resubmit every request of a dead worker from the router's
        token record (recompute-resume on a survivor); a request with no
        survivor fails "unavailable"."""
        with self._lock:
            victims = [e for e in self._tracked.values() if e.worker is h]
            for e in victims:
                e.generation += 1
                e.worker = e.client = None
                e.attempts += 1
                e.failed_workers.add(h.replica)
                self.retries_attempted += 1
                self.failovers += 1
        for entry in victims:
            if self._quarantine_if_poison(entry):
                continue
            phase = self._entry_phase(entry)
            others = ([w for w in self._phase_pool(phase) if w is not h]
                      or [w for w in self._routable() if w is not h])
            if not others:
                rid = entry.template.request_id
                with self._lock:
                    self._tracked.pop(rid, None)
                    self._release_handoff_desc(entry)
                self._finish_trace(entry, "unavailable")
                ghost = entry.seq_local
                ghost.done, ghost.finish_reason = True, "unavailable"
                ghost.finish_time = time.perf_counter()
                entry.on_finish(ghost)
                continue
            dest, hit, _ = self._pick(others, entry.template, phase=phase)
            telemetry.log_event(
                "request_failover", level="warning",
                request_id=(entry.template.trace_id
                            or str(entry.template.request_id)),
                resubmitted=True, attempts=entry.attempts,
                streamed=len(entry.tokens))
            if not self._dispatch(entry, dest, hit):
                self._retry_or_fail(entry, exclude=dest)

    # ------------------------------------------------------------ chaos

    def apply_chaos(self, body: dict) -> dict:
        """POST /debug/chaos: engine knobs go to the workers over the
        chaos RPC; ``{"replica": i, "kill": "sigkill"|"kill9"}`` SIGKILLs
        a worker and ``{"kill": "sigterm"}`` drains it; ``{"rpc": {...}}``
        retunes transport chaos on both sides (the --chaos-rpc-* knobs),
        restarting the per-replica fault schedules."""
        rpc = body.get("rpc")
        if rpc is not None:
            for k, v in dict(rpc).items():
                if k in self._chaos_rpc_kw and v is not None:
                    self._chaos_rpc_kw[k] = (tuple(v) if k == "verbs"
                                             else v)
            with self._lock:
                self._chaos_policies.clear()
            for h in self.workers:
                if h.client is not None and h.client.alive:
                    h.client.chaos = self._make_chaos(h.replica)
                    try:
                        h.client.rpc("chaos", rpc=dict(rpc))
                    except (WorkerGone, TimeoutError, RuntimeError):
                        pass
            return {"rpc": {k: (list(v) if isinstance(v, tuple) else v)
                            for k, v in self._chaos_rpc_kw.items()}}
        kill = body.get("kill")
        if kill is not None:
            if kill not in ("kill9", "sigkill", "sigterm", "drain"):
                raise ValueError(
                    f"unknown kill chaos {kill!r}: one of "
                    "('kill9', 'sigkill', 'sigterm')")
            idx = int(body["replica"])
            h = self.workers[idx]
            if h.proc is None or h.proc.poll() is not None:
                raise ValueError(f"worker {idx} has no live process")
            sig = (signal.SIGKILL if kill in ("kill9", "sigkill")
                   else signal.SIGTERM)
            os.kill(h.pid, sig)
            return {"replica": idx, "killed": kill, "pid": h.pid}
        replica = body.get("replica")
        targets = (self.workers if replica is None
                   else [self.workers[int(replica)]])
        fields = {k: body[k] for k in ("step_failure_rate",
                                       "step_wedge_s", "page_pressure")
                  if body.get(k) is not None}
        out = []
        for h in self.workers:
            state = {"step_failure_rate": None, "step_wedge_s": None,
                     "page_pressure": None}
            if h.client is not None and h.client.alive:
                try:
                    state = h.client.rpc(
                        "chaos", **(fields if h in targets else {}))
                    state = {k: v for k, v in state.items()
                             if k not in ("id", "ok")}
                except (WorkerGone, TimeoutError, RuntimeError):
                    pass
            out.append(state)
        return {"replicas": out}

    def drain_worker(self, replica: int,
                     migrate: Optional[bool] = None) -> None:
        """Graceful drain of one worker (the SIGTERM path), with
        migration selectable."""
        h = self.workers[replica]
        if h.client is None:
            raise ValueError(f"worker {replica} not running")
        kw = {} if migrate is None else {"migrate": migrate}
        h.client.rpc("drain", **kw)

    # --------------------------------------------------- elastic fleet

    def _add_worker(self, role: str) -> WorkerHandle:
        """A new replica slot (handle, role, routing stats, gauges), not
        booted. The index-keyed lists grow before the worker list, so no
        reader ever sees a replica index out of their range."""
        with self._lock:
            h = WorkerHandle(len(self.workers))
            self.roles.append(role)
            self._route_stats.append({"hits": 0, "cold": 0,
                                      "hit_pages": 0,
                                      "host_hit_pages": 0,
                                      "fabric_hit_pages": 0})
            self.workers.append(h)
        self._register_worker_gauges(h)
        return h

    def _autoscale_tick(self, now: float) -> None:
        """One step of the control loop (the monitor, once a second):
        scale up on a sustained TTFT or TPOT breach, down on a sustained
        lull. The two windows are the hysteresis, one cooldown serves
        both directions, and nothing acts while a worker boots, restarts
        or drains, or while a rollout runs: so a kill -9's respawn and a
        scale-up never spawn twice."""
        scfg = self.server_cfg
        if self._stopping or self._rollout_lock.locked():
            return
        if any(h.state in (BOOTING, RESTARTING, DRAINING)
               for h in self.workers):
            self._breach_since = 0.0
            return
        live = self._live_workers()
        n = len(live)
        max_n = scfg.autoscale_max_replicas or (self.dp + 2)
        min_n = max(1, scfg.autoscale_min_replicas)
        cooled = (now - self._last_scale_t) >= scfg.autoscale_cooldown_s
        breached = False
        ecfg = self.engine_cfg
        if ecfg.slo_ttft_ms:
            # The router-observed TTFT over a rolling horizon: it sees
            # lane park time, and its samples age out, so a finished
            # burst releases the breach.
            horizon = max(5.0 * scfg.autoscale_breach_window_s,
                          2.0 * scfg.autoscale_cooldown_s)
            cut = time.perf_counter() - horizon   # the samples' clock
            with self._lock:
                while self._ttft_obs and self._ttft_obs[0][0] < cut:
                    self._ttft_obs.popleft()
                xs = sorted(v for _, v in self._ttft_obs)
            if xs:
                p95 = xs[min(len(xs) - 1, int(0.95 * len(xs)))]
                breached = p95 > ecfg.slo_ttft_ms / 1000.0
        if not breached and ecfg.slo_tpot_ms and self._tracked:
            # TPOT from the workers' pooled rings, only with work in
            # flight (a count-based ring never ages out by itself).
            p95 = self._pooled_slo_quantile("tpot", 0.95)
            if p95 == p95 and p95 > ecfg.slo_tpot_ms / 1000.0:
                breached = True
        if breached:
            self._idle_since = 0.0
            if not self._breach_since:
                self._breach_since = now
            elif (now - self._breach_since >= scfg.autoscale_breach_window_s
                    and cooled and n < max_n):
                self._scale_up("slo_breach")
            return
        self._breach_since = 0.0
        occs = [float((h.last_health or {}).get("ladder_occupancy") or 0.0)
                for h in live if h.state == UP]
        pooled_occ = (sum(occs) / len(occs)) if occs else 1.0
        backlog = any(self._deferred.values())
        if backlog or pooled_occ >= scfg.autoscale_low_watermark:
            self._idle_since = 0.0
            return
        if not self._idle_since:
            self._idle_since = now
        elif (now - self._idle_since >= scfg.autoscale_idle_window_s
                and cooled and n > min_n and n > 1):
            self._scale_down("idle")

    def _scale_up(self, reason: str) -> None:
        t0 = time.perf_counter()
        role = self.server_cfg.autoscale_role or (
            "decode" if self.pd_enabled else "mixed")
        h = self._add_worker(role)
        telemetry.log_event("fleet_scale_up", replica=h.replica,
                            role=role, reason=reason)
        try:
            self._spawn(h)
        except (WorkerGone, TimeoutError, RuntimeError, OSError) as e:
            # A failed boot goes to the supervisor (backoff respawn, then
            # quarantine) like any other.
            h.consecutive_failures += 1
            telemetry.log_event("worker_respawn_failed", level="error",
                                replica=h.replica, error=str(e))
            self._schedule_restart(h)
        with self._lock:
            self.scale_ups += 1
        self._last_scale_t = time.monotonic()
        self._breach_since = 0.0
        tid = f"scale-up-{self.scale_ups}"
        self._recorder.add("scale_up", tid, t0, time.perf_counter(),
                           parent="", replica=h.replica, role=role,
                           reason=reason)
        self._recorder.seal(tid)

    def _scale_down(self, reason: str) -> None:
        t0 = time.perf_counter()
        h = self._retire_candidate()
        if h is None:
            return
        h.retiring = True
        try:
            # The drain exports the live KV as migrate events, the router
            # lands them on survivors, and the exit after it retires the
            # worker (retiring is set) instead of respawning it.
            self.drain_worker(h.replica)
        except (WorkerGone, TimeoutError, RuntimeError, ValueError) as e:
            h.retiring = False
            telemetry.log_event("fleet_scale_down_failed", level="warning",
                                replica=h.replica, error=str(e))
            return
        with self._lock:
            self.scale_downs += 1
        self._last_scale_t = time.monotonic()
        self._idle_since = 0.0
        telemetry.log_event("fleet_scale_down", replica=h.replica,
                            reason=reason)
        tid = f"scale-down-{self.scale_downs}"
        self._recorder.add("scale_down", tid, t0, time.perf_counter(),
                           parent="", replica=h.replica, reason=reason)
        self._recorder.seal(tid)

    def _retire_candidate(self) -> Optional[WorkerHandle]:
        """The coldest UP worker that can leave without emptying a P/D
        phase: fewest requests in flight, then lowest occupancy; ties
        retire the newest index."""
        cands = [h for h in self.workers
                 if h.state == UP and not h.retiring]
        if len(cands) <= 1:
            return None
        if self.pd_enabled:
            def _ok_without(w):
                rest = [self.roles[h.replica] for h in cands if h is not w]
                return (any(r in ("prefill", "mixed") for r in rest)
                        and any(r in ("decode", "mixed") for r in rest))
            cands = [h for h in cands if _ok_without(h)]
            if not cands:
                return None
        return min(cands, key=lambda h: (
            self._fleet_load(h),
            float((h.last_health or {}).get("ladder_occupancy") or 0.0),
            -h.replica))

    def rollout(self) -> dict:
        """A rolling upgrade (POST /debug/rollout): each worker replaced
        in turn under live traffic. The successor boots first, then the
        predecessor drains (its requests migrate) and its exit retires
        it. A successor that fails to boot stops the pass with its
        predecessor still serving; a predecessor whose drain fails is
        skipped. One rollout at a time."""
        self._ensure_started()
        if self._stopping:
            raise ValueError("fleet is stopping")
        if not self._rollout_lock.acquire(blocking=False):
            raise ValueError("a rollout is already in progress")
        t0 = time.perf_counter()
        replaced, failed = [], []
        try:
            targets = [h for h in self.workers
                       if h.state == UP and not h.retiring]
            telemetry.log_event("fleet_rollout_start",
                                targets=[h.replica for h in targets])
            for old in targets:
                if old.state != UP:
                    continue    # died meanwhile: the supervisor owns it
                succ = self._add_worker(self.roles[old.replica])
                try:
                    self._spawn(succ)
                except (WorkerGone, TimeoutError, RuntimeError,
                        OSError) as e:
                    # Never retire a predecessor without a live
                    # successor: stop here, keep serving.
                    succ.state = DEAD
                    failed.append({"replica": old.replica,
                                   "successor": succ.replica,
                                   "error": str(e)})
                    telemetry.log_event("fleet_rollout_spawn_failed",
                                        level="error",
                                        replica=succ.replica, error=str(e))
                    break
                old.retiring = True
                try:
                    self.drain_worker(old.replica)
                except (WorkerGone, TimeoutError, RuntimeError,
                        ValueError) as e:
                    # The predecessor died or restarted under the pass:
                    # the supervisor owns it and its requests failed
                    # over. The successor stays; go on.
                    old.retiring = False
                    telemetry.log_event("fleet_rollout_drain_failed",
                                        level="warning",
                                        replica=old.replica, error=str(e))
                    replaced.append({"old": old.replica,
                                     "new": succ.replica,
                                     "old_state": old.state})
                    continue
                deadline = (time.monotonic()
                            + self.server_cfg.drain_timeout_s + 30.0)
                while (time.monotonic() < deadline
                       and old.state not in (RETIRED, DEAD)
                       and old.retiring):
                    time.sleep(0.05)
                replaced.append({"old": old.replica, "new": succ.replica,
                                 "old_state": old.state})
        finally:
            with self._lock:
                self.rollouts += 1
            tid = f"rollout-{self.rollouts}"
            self._recorder.add("rollout", tid, t0, time.perf_counter(),
                               parent="", replaced=len(replaced),
                               failed=len(failed))
            self._recorder.seal(tid)
            self._rollout_lock.release()
        wall = time.perf_counter() - t0
        telemetry.log_event("fleet_rollout_done", replaced=len(replaced),
                            failed=len(failed), wall_s=round(wall, 3))
        return {"replaced": replaced, "failed": failed,
                "live": len(self._live_workers()),
                "wall_s": round(wall, 3)}

    # ---------------------------------------------------- observability

    def embed_many(self, batch):
        import numpy as np

        routable = self._routable()
        if not routable:
            with self._lock:
                self.requests_unavailable += 1
            raise FleetUnavailable("no routable worker",
                                   self.server_cfg.retry_after_s)
        h, _, _ = self._pick(routable)
        r = h.client.rpc("embed", timeout=600.0, batch=batch)
        return np.asarray(r["embeddings"])

    def supervision_counters(self) -> dict:
        """Fleet decisions, plus sums over the workers' stats as the
        monitor last cached them (refreshed once a second)."""
        stats = [h.last_stats for h in self.workers if h.last_stats]
        with self._lock:
            return {
                "retries_attempted": self.retries_attempted,
                "retries_succeeded": self.retries_succeeded,
                "failovers": self.failovers,
                "requests_shed": self.requests_shed,
                "requests_unavailable": self.requests_unavailable,
                "poison_requests": self.poison_requests,
                "kv_integrity_rejections": self._kv_rejections_total(),
                "route_prefix_hits": self.route_prefix_hits,
                "route_cold": self.route_cold,
                "route_fabric_hits": self.route_fabric_hits,
                "fabric_puts": self.fabric.puts,
                "fabric_hits": self.fabric.hits,
                "preemptions": sum(d.get("preemptions", 0)
                                   for d in stats),
                "recompute_resumes": sum(d.get("recompute_resumes", 0)
                                         for d in stats),
                "states": [h.state for h in self.workers],
                "fleet": "subprocess",
                "worker_restarts": sum(h.restarts for h in self.workers),
                # P/D: the roles, handoffs routed, those that
                # recomputed, adoptions (the workers' cached stats) and
                # the handoff wall.
                "roles": list(self.roles),
                "pd_handoffs": self.pd_handoffs,
                "pd_handoff_recomputes": self._pd_recomputes_total(),
                "pd_adoptions": sum(d.get("pd_adoptions", 0)
                                    for d in stats),
                "phases": {"pd_handoff_s":
                           self._pd_handoff_s_hist.phase_snapshot()},
                "migrations": self.migrations,
                "migrated_pages": self.migrated_pages,
                "migrated_bytes": self.migrated_bytes,
                "resume_resubmits": self.resume_resubmits,
                "resume_recomputed_tokens": self.resume_recomputed_tokens,
                "resume_reused_tokens": self.resume_reused_tokens,
                "swap_in_resumes": sum(d.get("swap_in_resumes", 0)
                                       for d in stats),
                # Elastic fleet.
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "rollouts": self.rollouts,
                "class_preemptions": dict(self.class_preemptions),
                "class_shed": dict(self.class_shed),
                "class_deferred": {c: len(q)
                                   for c, q in self._deferred.items()},
                "worker_reconnects": self.reconnects,
                "rpc_timeouts": self.rpc_timeouts,
                "frame_errors": self.frame_errors,
            }

    def health_snapshot(self) -> dict:
        replicas = []
        for h in self.workers:
            hz = dict(h.last_health) if h.state == UP else {}
            if h.state == UP and h.client is not None:
                try:
                    hz = h.client.rpc("healthz")
                    hz.pop("id", None), hz.pop("ok", None)
                    h.last_health = hz
                except (WorkerGone, TimeoutError, RuntimeError):
                    pass
            d = {
                "state": "healthy" if h.state == UP else h.state,
                "worker_state": h.state,
                "role": self.roles[h.replica],
                "pid": h.pid,
                "uptime_s": (round(time.time() - h.started_unix, 3)
                             if h.started_unix and h.state == UP
                             else 0.0),
                "restarts": h.restarts,
                "incarnation": h.incarnation,
                "routing": dict(self._route_stats[h.replica]),
            }
            for k in ("device", "pool_pressure", "under_pressure",
                      "preemptions", "load", "draining", "host_cache",
                      "swap_in_resumes", "prefill_backlog",
                      "ladder_occupancy", "pd_handoffs", "pd_adoptions",
                      "pd_adopt_fallbacks", "slo",
                      "kv_integrity_rejections",
                      "fabric_published_pages"):
                if k in hz:
                    d[k] = hz[k]
            replicas.append(d)
        # A retired worker left on purpose: it does not make the fleet
        # degraded (a quarantined one does).
        live = [h for h in self.workers if h.state != RETIRED]
        routable = sum(1 for h in live if h.routable)
        if routable == 0:
            status = "unavailable"
        elif routable == len(live):
            status = "ok"
        else:
            status = "degraded"
        return {
            "status": status,
            "fleet": "subprocess",
            "routing": self.server_cfg.routing,
            "replicas": replicas,
            "slo": self._fleet_slo(),
            "fabric": self.fabric.snapshot(),
            "supervision": self.supervision_counters(),
        }

    def stats_snapshot(self) -> dict:
        per = []
        for h in self.workers:
            d = None
            if h.state == UP and h.client is not None:
                try:
                    d = h.client.rpc("stats", timeout=30.0)["stats"]
                    h.last_stats = d
                except (WorkerGone, TimeoutError, RuntimeError):
                    d = None
            if d is None:
                d = dict(h.last_stats) if h.last_stats else None
            if d is not None:
                d = dict(d)
                d["health"] = {"state": h.state, "pid": h.pid,
                               "restarts": h.restarts}
                per.append(d)
        if not per:
            return {"supervision": self.supervision_counters(),
                    "dp": self.dp}
        return aggregate_replica_stats(per, self.supervision_counters())

    def worker_stats(self) -> List[dict]:
        """Each live worker's ``stats`` reply (``worker_stat``)."""
        return [self.worker_stat(h) for h in self.workers
                if h.state == UP and h.client is not None]

    @staticmethod
    def worker_stat(h: WorkerHandle) -> dict:
        """One worker's ``stats`` reply: its scheduler stats, its device,
        its kernels' launch counts and its peak memory (what only the
        worker process can see)."""
        r = h.client.rpc("stats", timeout=30.0)
        return {"replica": h.replica, "pid": h.pid, "restarts": h.restarts,
                "boot_walls_s": list(h.boot_walls),
                **{k: v for k, v in r.items() if k not in ("id", "ok")}}

    def steps_snapshot(self) -> dict:
        """Step-ledger attribution (GET /debug/steps): live per-worker
        reports (a downed worker's cached one, marked stale) and the
        fleet-merged report."""
        reports: Dict[str, dict] = {}
        for h in self.workers:
            d = None
            if h.state == UP and h.client is not None:
                try:
                    d = h.client.rpc("steps", timeout=30.0)["steps"]
                    h.last_steps = d
                except (WorkerGone, TimeoutError, RuntimeError):
                    d = None
            if d is None and h.last_steps:
                d = dict(h.last_steps)
                d["stale"] = True
            if d is not None:
                reports[str(h.replica)] = d
        return {"replicas": reports,
                "fleet": telemetry.merge_steps_reports(
                    list(reports.values()))}

    def blackbox_index(self) -> dict:
        """Flight-recorder captures (GET /debug/blackbox), dead
        incarnations' included (the directory outlives them)."""
        return telemetry.blackbox_index(self.server_cfg.blackbox_dir)

    def prometheus_text(self) -> str:
        groups = []
        for h in self.workers:
            dump = None
            if h.state == UP and h.client is not None:
                try:
                    dump = h.client.rpc("metrics", timeout=30.0)["samples"]
                    h.last_metrics = dump
                except (WorkerGone, TimeoutError, RuntimeError):
                    dump = None
            if dump is None:
                # A dead or booting worker keeps rendering: its last dump
                # until its death is folded, then the carry alone.
                dump = (h.last_metrics
                        if h.folded_incarnation != h.incarnation else [])
            merged = telemetry.apply_carry(h.carry, dump)
            groups.append(({"replica": str(h.replica)},
                           telemetry.registry_from_dump(merged)))
        groups.append(({}, self._fleet_registry))
        return telemetry.render_prometheus(groups)

    def recent_snapshot(self, n: int) -> List[dict]:
        items: List[dict] = []
        for h in self.workers:
            if h.state != UP or h.client is None:
                continue
            try:
                items.extend(h.client.rpc("recent", timeout=10.0,
                                          n=n)["recent"])
            except (WorkerGone, TimeoutError, RuntimeError):
                pass
        items.sort(key=lambda t: t.get("finished_unix", 0.0))
        return items[-n:]

    def _pid_names(self) -> dict:
        return {0: "router",
                **{h.replica + 1: f"replica {h.replica}"
                   for h in self.workers}}

    def trace_snapshot(self, trace_id: str) -> Optional[dict]:
        """One request's cross-process span tree (GET /debug/trace?id=);
        a trace the router never saw finish is pulled from the workers."""
        spans = self._recorder.get_trace(trace_id)
        if spans is None:
            pulled: List[dict] = []
            for h in self.workers:
                if h.state != UP or h.client is None:
                    continue
                try:
                    pulled.extend(h.client.rpc(
                        "trace", timeout=10.0, trace=trace_id)["spans"])
                except (WorkerGone, TimeoutError, RuntimeError):
                    pass
            spans = pulled or None
        if not spans:
            return None
        return telemetry.assemble_trace(trace_id, spans)

    def trace_chrome(self, n: int = 128) -> dict:
        """The recent traces as Chrome trace-event JSON (pid 0 the
        router, pid i+1 replica i)."""
        maintenance: List[dict] = []
        for h in self.workers:
            if h.state != UP or h.client is None:
                continue
            try:
                maintenance.extend(h.client.rpc(
                    "trace", timeout=10.0, n=0)["maintenance"])
            except (WorkerGone, TimeoutError, RuntimeError):
                pass
        return telemetry.spans_to_chrome(
            self._recorder.recent_traces(n), self._pid_names(),
            maintenance=maintenance,
            other_data={"fleet": "subprocess",
                        "spans_dropped": self._recorder.spans_dropped})

    def capture_profile(self, replica: int, seconds: float) -> dict:
        """POST /debug/profile {"seconds": N, "replica": i}: a
        torch.profiler capture in that worker, under the operator's
        profile_dir."""
        h = self.workers[int(replica)]
        if h.state != UP or h.client is None:
            raise ValueError(f"worker {replica} not serving "
                             f"(state={h.state})")
        r = h.client.rpc("profile", timeout=float(seconds) + 120.0,
                         seconds=float(seconds))
        return {k: v for k, v in r.items() if k not in ("id", "ok")}
