"""Engine-worker process: one replica's engine and scheduler per process.

Twin of ``tpu_inference/server/worker.py``. The worker owns one dp
replica, its weights, KV pool, prefix cache and host tier and
its continuous-batching scheduler thread, on the one device the router
names, and serves the framed JSON RPC of ``server/transport.py`` on a
local unix socket:

    request = {"id": n, "verb": ..., ...}        -> {"id": n, "ok": ...}
    event   = {"ev": "token" | "finish" | "handoff" | "spans" | "migrate"
               | "fabric_put" | "drained", ...}

Verbs: ``hello`` (worker and model facts), ``submit`` / ``cancel`` (a
request's tokens and its terminal record stream back as events on the
same connection; token events carry their absolute stream index ``k``;
both verbs take an idempotency token, so a retry over a new connection
replays the recorded reply), ``peek`` (side-effect-free tiered prefix
probe with load and pressure, the router's scoring input), ``stats``
(with the kernels' launch counts and the device's peak memory, which
live in this process), ``metrics``, ``healthz``, ``recent``, ``steps``,
``trace``, ``chaos``, ``embed``, ``profile``, ``drain``, ``import-kv``
(adopt a sibling's drain export into the host tier), ``shutdown`` and
``debug`` (the pool invariants).

KV fabric: with ``fabric_cache_pages`` > 0 the engine's publish hook
sends each settled prefix run to the router as one ``fabric_put`` event
(the pages serialized one by one, their lengths in ``lens``), unless
the router's pool watermark (``fabric_free``, in the boot envelope and
on every ``stats`` call) says it would not fit: then the publish is
skipped and counted (``tpu_inf_fabric_publish_skipped_total``).

The shm plane (``kv_plane="shm"``, ``server/shm_arena.py``): the boot
envelope's ``shm`` names this worker's region of the router's segment.
Then every KV export (fabric publish, handoff, drain migrate) is written
into a slab of that region and its frame carries the slab's descriptor
(``descs`` or ``kv_desc``) instead of the blob; a full region relays
that one payload. ``import-kv`` and a handoff ``submit`` read the
slabs they are given, checked as ``shm_arena.read_slab`` says: a stale
slab recomputes, a corrupt one is counted and its digest reported back
(``rejected_digests``). The router's stats call carries the batched
frees (``arena_free``). A failed attach leaves the worker on the relay
plane and logs ``shm_arena_attach_failed``.

P/D roles: the router names each worker's phase role in its boot
envelope ("prefill", "decode" or "mixed"). A prefill worker prefills,
streams the first token and hands the live sequence off: one
``handoff`` event carrying every KV page of its first ``ctx_len``
tokens, the partial final page included, in the migration wire format
(``engine.export_sequence_kv_live``), then a ``spans`` event with its
sealed spans. A ``submit`` carrying ``handoff`` and that blob is
adopted (``engine.adopt_sequence``): decode resumes with nothing
recomputed. A corrupt blob is rejected and counted; it and every other
failed adoption fall back to a recompute-resume.

Graceful drain (SIGTERM or the drain RPC): the worker stops admitting,
settles its in-flight calls, exports each live sequence's full KV pages
in the migration wire format (``engine.export_sequence_kv``) as one
``migrate`` event per request, broadcasts ``drained`` with its final
stats and metrics (the router's restart carry) and exits. The router
imports the pages into a destination's host tier and resubmits, so the
destination's admission is a swap-in-resume. ``kill -9`` skips all of
this; the router's recompute-resume failover covers it.

The worker builds on exactly the device the envelope names and never
moves to the CPU by itself: a ``cuda`` worker on a machine without a
card fails its boot, so its ``hello`` never answers. It exits when its
router dies (reparented). The module top imports only the standard
library and the frame codec, so the router imports it cheaply.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import queue
import signal
import socket
import sys
import threading
import time
from collections import OrderedDict
from typing import Any, Dict

from tpu_inference_torch.integrity import KVIntegrityError
from tpu_inference_torch.server.transport import (ChaosPolicy,
                                                  ChaosTransport, recv_frame,
                                                  send_frame)


class _Conn:
    """One router connection: a reader thread dispatching verbs and a
    writer thread draining an outbound queue, so engine-thread callbacks
    (token and finish events) never block on socket I/O."""

    def __init__(self, worker: "EngineWorker", sock: socket.socket):
        self.worker = worker
        self.sock = sock
        self.rfile = sock.makefile("rb")
        self.outq: "queue.Queue" = queue.Queue()
        self.alive = True
        self._writer = threading.Thread(target=self._write_loop,
                                        name="worker-conn-writer",
                                        daemon=True)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="worker-conn-reader",
                                        daemon=True)
        self._writer.start()
        self._reader.start()

    def send(self, obj: Dict[str, Any], blob: bytes = b"",
             verb: str = "") -> None:
        """Queue one outbound frame; ``verb`` tags it for the chaos
        shim's filter (replies carry their request's verb, events their
        name)."""
        if self.alive:
            self.outq.put((obj, blob, verb))

    def flush(self, timeout: float = 5.0) -> None:
        """Wait until every frame queued so far is written (a sentinel
        rides the queue behind them)."""
        evt = threading.Event()
        self.outq.put(("__flush__", evt))
        evt.wait(timeout)

    def _write_loop(self) -> None:
        while True:
            item = self.outq.get()
            if item is None:
                return
            if item[0] == "__flush__":
                item[1].set()
                continue
            try:
                # Worker->router frames are the chaos shim's "recv"
                # direction (named from the router's side).
                send_frame(self.sock, item[0], item[1],
                           chaos=self.worker.chaos_rpc,
                           verb=item[2], direction="recv")
            except (OSError, ConnectionError):
                self.alive = False
                return

    def _read_loop(self) -> None:
        try:
            while True:
                obj, blob = recv_frame(self.rfile)
                self.worker.handle(self, obj, blob)
        except (ConnectionError, OSError, json.JSONDecodeError):
            pass
        finally:
            self.alive = False
            self.outq.put(None)
            self.worker.forget_conn(self)


class EngineWorker:
    """One replica's engine and scheduler behind the RPC socket."""

    def __init__(self, cfg, replica: int, socket_path: str, device: str,
                 warmup: bool = True, devices=None):
        """``devices``: the replica's tp x sp devices in mesh order (at
        tp * sp > 1; the first is ``device``)."""
        self.cfg = cfg
        self.replica = replica
        self.socket_path = socket_path
        self.device = device
        self.devices = list(devices or ())
        # Phase role: a "prefill" worker hands each settled prefill off.
        self.role = cfg.engine.role
        self.do_warmup = warmup
        self.warmup_s = 0.0
        self.started_unix = time.time()
        # Orphan guard: reparenting means the router died.
        self._parent_pid = os.getppid()
        self.engine = None
        self.sched = None
        self.draining = False
        self._shutdown = threading.Event()
        self._conns: list = []
        self._conns_lock = threading.Lock()
        # rid -> the connection that submitted it (migrate events go
        # back on it).
        self._req_conn: Dict[int, _Conn] = {}
        self.chaos_rpc = self._build_chaos_rpc()
        # Idempotency replay cache: token -> the recorded reply.
        self._idem: "OrderedDict[str, dict]" = OrderedDict()
        self._idem_lock = threading.Lock()
        # The fabric pool's free-page watermark (publish back-pressure):
        # from the boot envelope, refreshed on every stats call. None
        # publishes freely.
        self._fabric_free = None
        self.fabric_publish_skipped = 0
        # The shm plane's arena (a WorkerArena), None on the relay plane.
        self._arena = None

    def attach_arena(self, spec) -> None:
        """Map the router's segment from the boot envelope's region
        spec. A failure is not fatal: the worker stays on the relay
        plane."""
        if not spec:
            return
        from tpu_inference_torch import telemetry
        from tpu_inference_torch.server import shm_arena
        try:
            self._arena = shm_arena.WorkerArena(spec)
        except Exception as e:  # noqa: BLE001 — relay fallback, not fatal
            self._arena = None
            telemetry.log_event(
                "shm_arena_attach_failed", level="warning",
                replica=self.replica, error=str(e))

    def _arena_blob(self, desc, path: str):
        """A descriptor's payload out of the arena, as (blob, rejected):
        ``rejected`` when the slab failed its integrity check (counted;
        the router drops the descriptor), an empty blob alone when it is
        stale or the arena is not attached (the caller recomputes)."""
        from tpu_inference_torch import telemetry
        from tpu_inference_torch.server import shm_arena
        if self._arena is None or desc is None:
            return b"", False
        try:
            return self._arena.read(desc), False
        except shm_arena.ArenaCorrupt as e:
            self.engine.kv_integrity_rejections += 1
            telemetry.log_event(
                "arena_slab_rejected", level="error", path=path,
                replica=self.replica, reason=e.reason, detail=e.detail)
            return b"", True
        except shm_arena.ArenaError:
            return b"", False

    def _build_chaos_rpc(self, over: Dict[str, Any] = None):
        """The worker's side of transport chaos (config knobs, then the
        chaos verb's overrides). The wedge is router-side only: its
        detector is the router's RPC deadlines."""
        s = self.cfg.server
        kw = {"seed": s.chaos_rpc_seed,
              "corrupt_rate": s.chaos_rpc_corrupt_rate,
              "drop_rate": s.chaos_rpc_drop_rate,
              "delay_rate": s.chaos_rpc_delay_rate,
              "delay_s": s.chaos_rpc_delay_s,
              "truncate_rate": s.chaos_rpc_truncate_rate,
              "verbs": s.chaos_rpc_verbs,
              "direction": s.chaos_rpc_direction}
        for k, v in (over or {}).items():
            if k in kw and v is not None:
                kw[k] = tuple(v) if k == "verbs" else v
        if kw["direction"] not in ("recv", "both"):
            return None
        # Decorrelated from the router side's schedule.
        kw["seed"] = int(kw["seed"]) + 7919 * (self.replica + 1)
        pol = ChaosPolicy(**kw)
        return ChaosTransport(pol) if pol.active else None

    # ------------------------------------------------------------- boot

    def boot(self) -> None:
        from tpu_inference_torch import telemetry
        from tpu_inference_torch.config import framework_config_to_dict
        from tpu_inference_torch.engine.engine import (InferenceEngine,
                                                       resolve_device)
        from tpu_inference_torch.engine.scheduler import EngineScheduler

        cfg = self.cfg
        dev = resolve_device(self.device)
        mesh = None
        if len(self.devices) > 1:
            # This replica's tp x sp shards, driven by this process.
            from tpu_inference_torch.config import ParallelConfig
            from tpu_inference_torch.parallel.mesh import build_mesh
            mesh = build_mesh(ParallelConfig(tp=max(1, cfg.parallel.tp),
                                             sp=max(1, cfg.parallel.sp)),
                              devices=self.devices)
        params = None
        if cfg.checkpoint_path:
            from tpu_inference_torch.models.weights import load_checkpoint
            params = load_checkpoint(cfg.model, cfg.checkpoint_path,
                                     quant=cfg.engine.quant, device=dev,
                                     mesh=mesh)
        self.engine = InferenceEngine(cfg.model, cfg.engine, params=params,
                                      seed=cfg.seed, device=dev, mesh=mesh)
        self.sched = EngineScheduler(self.engine)
        self.engine.telemetry.recorder.replica = self.replica
        if self.role == "prefill":
            self.sched.on_prefill_handoff = self._emit_handoff
        # The fabric's publish hook: settled prefix pages go to the
        # router's pool as fabric_put events.
        if (cfg.server.fabric_cache_pages > 0
                and self.engine.prefix_cache is not None):
            self.engine.fabric_publish = self._publish_fabric
            self.engine.fabric_publish_min_pages = \
                cfg.server.fabric_publish_min_pages
        reg = self.engine.telemetry.registry
        reg.counter(
            "tpu_inf_fabric_publish_skipped_total",
            "fabric publishes skipped by the pool-watermark gate",
            fn=lambda: self.fabric_publish_skipped)
        # The shm plane's traffic (flat zeros on the relay plane, so the
        # two arms' scrapes join).
        reg.counter(
            "tpu_inf_kv_plane_shm_puts_total",
            "KV payloads published into the shm arena",
            fn=lambda: self._arena.puts if self._arena else 0)
        reg.counter(
            "tpu_inf_kv_plane_shm_gets_total",
            "KV payloads adopted out of the shm arena",
            fn=lambda: self._arena.gets if self._arena else 0)
        reg.counter(
            "tpu_inf_kv_plane_shm_bytes_total",
            "bytes moved through the shm arena by direction",
            fn=lambda: self._arena.put_bytes if self._arena else 0,
            op="put")
        reg.counter(
            "tpu_inf_kv_plane_shm_bytes_total",
            "bytes moved through the shm arena by direction",
            fn=lambda: self._arena.get_bytes if self._arena else 0,
            op="get")
        if self.engine.telemetry.enabled:
            # Config-pure labels: identical across restarts, so the
            # router's carry never sees a label change.
            telemetry.emit_build_info(
                self.engine.telemetry.registry, backend=dev.type,
                fleet=cfg.server.fleet, kv_quant=cfg.engine.kv_quant,
                spec_mode=(self.engine.spec_mode
                           if self.engine.spec_enabled else "off"),
                routing=cfg.server.routing)
        # The flight recorder's directory outlives this process, so the
        # router finds a kill -9's last heartbeat there.
        telemetry.attach_flight_recorder(
            self.engine.telemetry, cfg.server.blackbox_dir, self.replica,
            retain=cfg.server.blackbox_retain,
            config=framework_config_to_dict(cfg),
            stats_fn=lambda: self.sched.stats.snapshot(self.engine))
        if self.do_warmup:
            self.warmup_s = self.engine.warmup()
        self.sched.start()

    # ------------------------------------------------------------ serve

    def serve(self) -> None:
        """Listen first (the router's connect succeeds while the engine
        boots; its hello waits), then boot, then accept until shutdown."""
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.socket_path)
        srv.listen(4)
        srv.settimeout(0.25)
        self.boot()
        e = self.engine
        shards = (f", tp {e.tp}" + (f" x sp {e.sp}" if e.sp > 1 else "")
                  + f" on {','.join(str(d) for d in self.devices)}"
                  if len(self.devices) > 1 else "")
        print(f"[worker {self.replica}] pid={os.getpid()} serving on "
              f"{self.socket_path} ({self.engine.device}{shards})",
              file=sys.stderr, flush=True)
        while not self._shutdown.is_set():
            if os.getppid() != self._parent_pid:
                print(f"[worker {self.replica}] router gone (reparented)"
                      " - exiting", file=sys.stderr, flush=True)
                break
            try:
                sock, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conns_lock:
                self._conns.append(_Conn(self, sock))
        try:
            srv.close()
            os.unlink(self.socket_path)
        except OSError:
            pass

    def forget_conn(self, conn: _Conn) -> None:
        with self._conns_lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def _broadcast(self, obj: Dict[str, Any], blob: bytes = b"",
                   verb: str = "") -> None:
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.send(obj, blob, verb)

    def _publish_fabric(self, pairs) -> None:
        """Send settled prefix pages to the router's fabric pool (engine
        thread, from the engine's publish hook), each page serialized on
        its own so the pool's entries evict and verify independently. A
        publish larger than the pool's advertised free pages would evict
        on arrival: it is skipped and counted instead. On the shm plane
        each page goes into a slab and the frame carries descriptors; a
        full region relays the pages that did not fit."""
        from tpu_inference_torch.engine import kv_cache as kvc
        from tpu_inference_torch.server import shm_arena
        free = self._fabric_free
        if free is not None:
            if len(pairs) > free:
                self.fabric_publish_skipped += len(pairs)
                return
            self._fabric_free = free - len(pairs)
        relay = []
        if self._arena is not None:
            hex_descs, descs = [], []
            for d, p in pairs:
                parts = kvc.serialize_host_pages_parts([p])
                try:
                    descs.append(self._arena.publish_parts(parts))
                    hex_descs.append(d.hex())
                except shm_arena.ArenaFull:
                    relay.append((d, b"".join(parts)))
            if descs:
                self._broadcast({"ev": "fabric_put", "digests": hex_descs,
                                 "descs": descs, "replica": self.replica},
                                verb="fabric_put")
        else:
            relay = [(d, kvc.serialize_host_pages([p])) for d, p in pairs]
        if relay:
            self._broadcast({"ev": "fabric_put",
                             "digests": [d.hex() for d, _ in relay],
                             "lens": [len(b) for _, b in relay],
                             "replica": self.replica},
                            b"".join(b for _, b in relay), verb="fabric_put")

    # --------------------------------------------------------- dispatch

    # Verbs that can block for seconds run on their own thread, so the
    # reader keeps answering the router's routing peeks.
    _SLOW_VERBS = ("import_kv", "embed", "shutdown", "profile")
    # Verbs with side effects the router may retry over a new
    # connection: the token replays the recorded reply.
    _IDEM_VERBS = ("submit", "cancel", "import_kv")
    _IDEM_CAP = 512

    def handle(self, conn: _Conn, obj: Dict[str, Any],
               blob: bytes) -> None:
        rid = obj.get("id")
        verb = str(obj.get("verb")).replace("-", "_")
        idem = obj.get("idem") if verb in self._IDEM_VERBS else None

        def run() -> None:
            if idem is not None:
                with self._idem_lock:
                    prev = self._idem.get(idem)
                if prev is not None:
                    out = {"id": rid}
                    out.update(prev)
                    if verb == "submit" and "rid" in prev:
                        # The first submit applied: its stream now goes
                        # to the retrying connection.
                        self._req_conn[int(prev["rid"])] = conn
                    conn.send(out, verb=verb)
                    return
            try:
                fn = getattr(self, "_verb_" + verb, None)
                if fn is None:
                    raise ValueError(f"unknown verb {obj.get('verb')!r}")
                reply = fn(conn, obj, blob)
                if reply is not None:
                    out = {"id": rid, "ok": True}
                    out.update(reply)
                    if idem is not None and out.get("ok"):
                        with self._idem_lock:
                            self._idem[idem] = {k: v for k, v
                                                in out.items()
                                                if k != "id"}
                            while len(self._idem) > self._IDEM_CAP:
                                self._idem.popitem(last=False)
                    conn.send(out, verb=verb)
            except Exception as e:  # noqa: BLE001 — RPC errors reply
                conn.send({"id": rid, "ok": False, "error": str(e),
                           "kind": type(e).__name__}, verb=verb)

        if verb in self._SLOW_VERBS:
            threading.Thread(target=run, name=f"worker-{verb}",
                             daemon=True).start()
        else:
            run()

    # ------------------------------------------------------------ verbs

    def _emit_handoff(self, seq) -> bool:
        """The prefill role's scheduler hook (engine thread): export the
        live sequence and send it to the submitting router connection
        as a ``handoff`` event; the router resumes it on a decode
        worker. False (the sequence decodes here) when the connection is
        gone, the worker drains, or nothing is exportable."""
        from tpu_inference_torch import telemetry
        from tpu_inference_torch.engine import kv_cache as kvc
        conn = self._req_conn.get(seq.request_id)
        if conn is None or not conn.alive or self.draining:
            return False
        t0 = time.perf_counter()
        try:
            digests, pages, ctx_len = \
                self.engine.export_sequence_kv_live(seq)
        except Exception as e:  # noqa: BLE001 — decode here instead
            telemetry.log_event("handoff_export_failed", level="warning",
                                request_id=seq.trace_id
                                or str(seq.request_id), error=str(e))
            return False
        if not pages:
            return False
        parts = kvc.serialize_host_pages_parts(pages)
        # The export span ends before the payload leaves: the arena
        # write (shm) and the frame send (relay) are the data plane, in
        # the handoff window (the router's handoff span).
        t_ser = time.perf_counter()
        kv_desc = None
        if self._arena is not None:
            from tpu_inference_torch.server import shm_arena
            try:
                kv_desc = self._arena.publish_parts(parts)
            except shm_arena.ArenaFull:
                kv_desc = None
        self.engine.telemetry.recorder.add(
            "handoff_export", seq.trace_id or str(seq.request_id), t0,
            t_ser, pages=len(pages), bytes=sum(len(p) for p in parts),
            ctx_len=ctx_len, plane="shm" if kv_desc else "relay")
        self._req_conn.pop(seq.request_id, None)
        ev = {"ev": "handoff", "rid": seq.request_id,
              "n_generated": len(seq.generated), "ctx_len": ctx_len,
              "export_s": round(time.perf_counter() - t0, 6),
              "digests": [d.hex() for d in digests]}
        if kv_desc is not None:
            ev["kv_desc"] = kv_desc
            conn.send(ev, verb="handoff")
        else:
            conn.send(ev, b"".join(parts), verb="handoff")
        return True

    def _verb_hello(self, conn, obj, blob) -> dict:
        e = self.engine
        return {
            "pid": os.getpid(),
            "replica": self.replica,
            "role": self.role,
            "device": str(e.device),
            "uptime_s": round(time.time() - self.started_unix, 3),
            "warmup_s": round(self.warmup_s, 3),
            "n_params": e.n_params,
            "weight_bytes": e.weight_bytes,
            "attn_backend": e.attn_backend,
            "ladder": list(e.ladder),
            "swa_evict": e.swa_evict,
            "prefix_cache": e.prefix_cache is not None,
            "host_cache_pages": (e.host_pool.capacity
                                 if e.host_pool is not None else 0),
            "spec_mode": e.spec_mode if e.spec_enabled else None,
            "spec_draft": bool(e.spec_draft),
        }

    def _verb_submit(self, conn, obj, blob) -> dict:
        if self.draining:
            return {"ok": False, "kind": "draining",
                    "error": "worker draining"}
        from tpu_inference_torch.engine.engine import Sequence
        s = obj["seq"]
        seq = Sequence(
            request_id=int(s["request_id"]),
            prompt_tokens=list(s["prompt_tokens"]),
            max_new_tokens=int(s["max_new_tokens"]),
            temperature=float(s.get("temperature", 0.0)),
            top_p=float(s.get("top_p", 1.0)),
            top_k=s.get("top_k"),
            seed=s.get("seed"),
            repeat_penalty=float(s.get("repeat_penalty", 1.0)),
            repeat_last_n=int(s.get("repeat_last_n", 64)),
            eos_token_id=s.get("eos_token_id"),
            trace_id=s.get("trace_id", ""),
            priority_class=s.get("class", "interactive"),
            attempt=int(s.get("attempt", 0)))
        seq.routed_replica = self.replica
        seq.route_hit_pages = int(s.get("route_hit_pages", 0))
        seq.route_host_hit_pages = int(s.get("route_host_hit_pages", 0))
        seq.route_fabric_hit_pages = int(s.get("route_fabric_hit_pages", 0))
        generated = s.get("generated") or []
        if generated:
            # Recompute-resume from the router's token record: prefill
            # covers prompt + generated (host-tier hits from a drain
            # import make it a swap-in-resume) and decode continues.
            seq.generated = list(generated)
            seq.resume_base = len(generated)
        handoff = s.get("handoff")
        if handoff and not blob and handoff.get("kv_desc") is not None:
            # The shm plane: the export is in the prefill worker's slab.
            # A stale or corrupt one leaves the blob empty, and the
            # adoption falls back to a recompute-resume below.
            blob, _ = self._arena_blob(handoff["kv_desc"], "handoff")
        if handoff and generated:
            # A P/D handoff: admission adopts the blob's pages (the
            # partial final page included) and nothing is recomputed.
            # A missing, corrupt or malformed blob recompute-resumes.
            from tpu_inference_torch.engine import kv_cache as kvc
            pages = []
            try:
                # Views over the blob: the adoption copies them to the
                # pool once.
                pages = (kvc.deserialize_host_pages(blob, copy=False)
                         if blob else [])
            except KVIntegrityError:
                self.engine.kv_integrity_rejections += 1
            except Exception as e:  # noqa: BLE001 — recompute-resume
                from tpu_inference_torch import telemetry
                telemetry.log_event("handoff_blob_unreadable",
                                    level="warning", request_id=seq.trace_id
                                    or str(seq.request_id), error=repr(e))
            if pages:
                seq.adopt_kv = (pages, int(handoff.get("ctx_len", 0)))
            else:
                self.engine.adopt_fallbacks += 1
        if self.role == "prefill" and seq.adopt_kv is None:
            # Every prefill settled here is handed off (an adoption runs
            # no prefill, so one that lands here decodes here).
            seq.handoff_after_prefill = True
        rid = seq.request_id

        # A resubmitted rid must never leave two live attempts: cancel
        # the ghost and wait for the engine loop to reap it.
        def _rid_live() -> bool:
            with self.sched._lock:
                return (rid in self.sched._callbacks or any(
                    p.seq.request_id == rid for p in self.sched._waiting))

        if _rid_live():
            self.sched.cancel(rid)
            deadline = time.monotonic() + 5.0
            while _rid_live() and time.monotonic() < deadline:
                time.sleep(0.005)
            if _rid_live():
                return {"error": f"request {rid} still draining "
                                 "its previous attempt"}
        self._req_conn[rid] = conn
        # "k" is the token's absolute stream index, counted here from
        # the resume prefix (a burst of buffered tokens must not share
        # one index).
        knext = itertools.count(len(seq.generated))

        def on_token(sq, tok: int) -> None:
            conn.send({"ev": "token", "rid": rid, "t": int(tok),
                       "k": next(knext)}, verb="token")

        def on_finish(sq) -> None:
            self._req_conn.pop(rid, None)
            tid = sq.trace_id or str(rid)
            spans = self.engine.telemetry.recorder.export_recent(tid)
            if sq.finish_reason == "handoff":
                # The handoff event continues the stream: a finish frame
                # would end it. The spans, sealed after the handoff
                # frame left, go on their own event.
                if spans:
                    conn.send({"ev": "spans", "rid": rid, "trace": tid,
                               "spans": spans}, verb="spans")
                return
            fin = sq.finish_time or time.perf_counter()
            first = sq.first_token_time or fin
            start = sq.prefill_start or first
            conn.send({
                "ev": "finish", "rid": rid,
                "reason": sq.finish_reason or "stop",
                "n_generated": len(sq.generated),
                "cached_tokens": sq.cached_tokens,
                "host_restored_pages": sq.host_restored_pages,
                "preemptions": sq.preemptions,
                "resume_base": sq.resume_base,
                "prefill_s": round(max(0.0, first - start), 6),
                "decode_s": round(max(0.0, fin - first), 6),
                "trace": tid,
                "spans": spans,
            }, verb="finish")

        self.sched.submit(seq, on_token, on_finish)
        return {"rid": rid}

    def _verb_cancel(self, conn, obj, blob) -> dict:
        self.sched.cancel(int(obj["rid"]))
        self._req_conn.pop(int(obj["rid"]), None)
        return {}

    def _verb_peek(self, conn, obj, blob) -> dict:
        """Router scoring probe: tiered prefix peek, load and pressure
        (side-effect-free on the cache)."""
        digests = [bytes.fromhex(d) for d in obj.get("digests") or ()]
        hbm = host = 0
        pc = self.engine.prefix_cache
        if pc is not None and digests:
            hbm, host = pc.peek_digests_tiered(digests)
        return {"hbm": hbm, "host": host, "load": self.sched.load,
                "pressure": bool(self.engine.under_pressure),
                # P/D routing inputs.
                "role": self.role, "backlog": len(self.sched._waiting),
                "occupancy": self._ladder_occupancy()}

    def _ladder_occupancy(self) -> float:
        e = self.engine
        return round(sum(s is not None for s in e.slots)
                     / max(e.ladder[-1], 1), 4)

    def _verb_stats(self, conn, obj, blob) -> dict:
        """The scheduler's stats snapshot, plus what only this process
        can see: its kernels' launch counts, the device's peak allocated
        memory and the fabric publish hook's totals. The router's call
        carries the fabric pool's free-page watermark and the arena slab
        frees the router batched for this region."""
        import torch

        from tpu_inference_torch.kernels import (paged_attention,
                                                 prefill_attention)
        ff = obj.get("fabric_free")
        if ff is not None:
            self._fabric_free = int(ff)
        frees = obj.get("arena_free")
        if frees and self._arena is not None:
            for off in frees:
                self._arena.free(int(off))
        dev = self.engine.device
        return {
            "stats": self.sched.stats.snapshot(self.engine),
            "device": str(dev),
            "kernels": {
                "decode": dict(paged_attention.launches_by_variant),
                "prefill": dict(prefill_attention.launches_by_variant),
                "decode_by_batch": {
                    str(b): n for b, n in
                    sorted(paged_attention.launches_by_batch.items())},
                "prefill_by_len": {
                    str(q): n for q, n in
                    sorted(prefill_attention.launches_by_len.items())},
                "prefill_by_path": dict(
                    sorted(prefill_attention.launches_by_path.items()))},
            # This replica's mesh and its prefill chunks by attention
            # path (sp_ring / sp_ulysses / paged: the prefill kernel).
            "parallel": {"tp": self.engine.tp, "sp": self.engine.sp},
            "prefill_paths": dict(self.engine.prefill_paths),
            # By a tp shard's "Hq/Hkv" (the full heads at tp 1).
            "kernels_by_heads": {
                "decode": dict(paged_attention.launches_by_heads),
                "prefill": dict(prefill_attention.launches_by_heads)},
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else 0),
            "fabric": {"published_pages": self.engine.fabric_published_pages,
                       "publish_s": round(self.engine.fabric_publish_s, 6),
                       "publish_skipped": self.fabric_publish_skipped},
            "arena": self._arena_stats(),
        }

    def _arena_stats(self):
        """This worker's side of the shm plane (None on the relay
        plane): its traffic and its region's allocator books."""
        a = self._arena
        if a is None:
            return None
        w = a.writer
        return {"region": a.region, "epoch": w.epoch, "puts": a.puts,
                "gets": a.gets, "put_bytes": a.put_bytes,
                "get_bytes": a.get_bytes, "slabs_used": w.slabs_used,
                "bytes_used": w.bytes_used,
                "alloc_failures": w.alloc_failures}

    def _verb_steps(self, conn, obj, blob) -> dict:
        return {"steps": self.engine.telemetry.steps_report()}

    def _verb_metrics(self, conn, obj, blob) -> dict:
        from tpu_inference_torch import telemetry
        return {"samples": telemetry.dump_registry(
            self.engine.telemetry.registry)}

    def _verb_healthz(self, conn, obj, blob) -> dict:
        e = self.engine
        out = {
            "pid": os.getpid(),
            "device": str(e.device),
            "uptime_s": round(time.time() - self.started_unix, 3),
            "draining": self.draining,
            "load": self.sched.load,
            "pool_pressure": round(e.pool_pressure, 4),
            "under_pressure": e.under_pressure,
            "preemptions": e.preemptions_total,
            "swap_in_resumes": e.swap_in_resumes,
            # P/D: where a handoff stall shows (the prefill side's
            # backlog, the decode side's occupancy) and the churn.
            "role": self.role,
            "prefill_backlog": len(self.sched._waiting),
            "ladder_occupancy": self._ladder_occupancy(),
            "pd_handoffs": self.sched.stats.pd_handoffs,
            "pd_adoptions": e.adoptions_in,
            "pd_adopt_fallbacks": e.adopt_fallbacks,
            # Corrupt KV blobs rejected at import (never adopted).
            "kv_integrity_rejections": e.kv_integrity_rejections,
            # Settled prefix pages this worker published to the fabric.
            "fabric_published_pages": e.fabric_published_pages,
        }
        if e.telemetry.slo is not None:
            out["slo"] = e.telemetry.slo.snapshot(include_window=False)
        if e.host_pool is not None:
            out["host_cache"] = {
                "capacity_pages": e.host_pool.capacity,
                "pages_used": e.host_pool.used,
                "offloaded": e.host_pool.offloaded_total,
                "restored": e.host_pool.restored_total,
                "imported": e.host_pool.imported_total,
                "evicted": e.host_pool.evicted_total,
                "swap_in_resumes": e.swap_in_resumes,
                "swap_out_s_total": round(e.host_pool.swap_out_s_total, 6),
                "swap_in_s_total": round(e.host_pool.swap_in_s_total, 6),
            }
        return out

    def _verb_recent(self, conn, obj, blob) -> dict:
        return {"recent": self.sched.recent_snapshot(int(obj.get("n", 50)))}

    def _verb_trace(self, conn, obj, blob) -> dict:
        """One trace's spans by id (under "trace": "id" is the RPC's own
        correlation id), or the recent traces and maintenance spans."""
        rec = self.engine.telemetry.recorder
        tid = obj.get("trace")
        if tid:
            return {"spans": rec.get_trace(str(tid)) or []}
        return {"traces": rec.recent_traces(int(obj.get("n", 64))),
                "maintenance": rec.maintenance_spans()}

    def _verb_profile(self, conn, obj, blob) -> dict:
        """A torch.profiler capture of this worker for ``seconds`` under
        the operator's profile_dir (serving continues meanwhile)."""
        from tpu_inference_torch import telemetry
        return telemetry.capture_torch_profile(
            self.cfg.server.profile_dir, self.replica,
            float(obj.get("seconds", 3.0)))

    def _verb_chaos(self, conn, obj, blob) -> dict:
        e = self.engine
        rate = obj.get("step_failure_rate")
        wedge = obj.get("step_wedge_s")
        pressure = obj.get("page_pressure")
        if rate is not None:
            e.chaos_step_failure_rate = float(rate)
        if wedge is not None:
            e.chaos_step_wedge_s = float(wedge)
        if pressure is not None:
            e.request_page_pressure(int(pressure))
        rpc = obj.get("rpc")
        if rpc is not None:
            self.chaos_rpc = self._build_chaos_rpc(rpc)
        t = e._pressure_target
        return {"step_failure_rate": e.chaos_step_failure_rate,
                "step_wedge_s": e.chaos_step_wedge_s,
                "page_pressure": (e.chaos_page_pressure if t is None
                                  else t),
                "rpc": (self.chaos_rpc.policy.snapshot()
                        if self.chaos_rpc is not None else None)}

    def _verb_embed(self, conn, obj, blob) -> dict:
        vecs = self.engine.embed_many([list(b) for b in obj["batch"]])
        return {"embeddings": vecs.tolist()}

    def _verb_import_kv(self, conn, obj, blob) -> dict:
        """Adopt KV pages into the host tier: a sibling's drain export,
        a fabric pull or a warm boot. Replies once the engine loop
        applied them, so the router's resubmit sees the pages. The pages
        come as one blob (relay plane), as per-page arena descriptors
        (``descs``: fabric pulls and warm boots on the shm plane) or as
        one multi-page descriptor (``kv_desc``: a drain migrate on the
        shm plane). A corrupt blob or slab is rejected and counted,
        never adopted."""
        from tpu_inference_torch.engine import kv_cache as kvc
        descs = obj.get("descs")
        if descs is not None:
            return self._import_kv_descs(obj.get("digests") or (), descs)
        digests = [bytes.fromhex(d) for d in obj.get("digests") or ()]
        # The import's parts, in the reply: the slab read (its checks
        # and copy), the payload's deserialize (with its CRC) and the
        # wait for the engine loop to apply the pages.
        parts = {"read": 0.0, "deserialize": 0.0, "apply": 0.0}
        t = time.perf_counter()
        if not blob and obj.get("kv_desc") is not None:
            blob, rejected = self._arena_blob(obj["kv_desc"], "migrate")
            if not blob:
                return {"offered": 0, "applied": False, "adopted": 0,
                        "rejected": ("arena slab corrupt" if rejected
                                     else "arena slab unreadable")}
        parts["read"] = time.perf_counter() - t
        t = time.perf_counter()
        try:
            pages = kvc.deserialize_host_pages(blob) if blob else []
        except KVIntegrityError as e:
            self.engine.kv_integrity_rejections += 1
            return {"offered": 0, "applied": False, "adopted": 0,
                    "rejected": str(e)}
        parts["deserialize"] = time.perf_counter() - t
        n = min(len(digests), len(pages))
        t = time.perf_counter()
        done = self.engine.request_import_host(
            list(zip(digests[:n], pages[:n])))
        self.sched.kick()
        applied = done.wait(timeout=10.0)
        parts["apply"] = time.perf_counter() - t
        return {"offered": n, "applied": bool(applied),
                "adopted": done.adopted, "parts_s": parts}

    def _import_kv_descs(self, hex_digests, descs) -> dict:
        """The descriptor-list import: each per-page slab read from the
        arena and deserialized, the survivors offered to the host tier.
        A slab or page that fails its integrity check is counted and
        its digest reported back (``rejected_digests``), so the router
        drops that pool entry; a stale slab is skipped. The reply's
        ``parts_s`` are as in ``_verb_import_kv``, summed over the
        slabs."""
        from tpu_inference_torch.engine import kv_cache as kvc
        offers, rejected_hex = [], []
        parts = {"read": 0.0, "deserialize": 0.0, "apply": 0.0}
        for hexd, desc in zip(hex_digests, descs):
            t = time.perf_counter()
            pblob, rejected = self._arena_blob(desc, "fabric_pull")
            parts["read"] += time.perf_counter() - t
            if not pblob:
                if rejected:
                    rejected_hex.append(hexd)
                continue
            t = time.perf_counter()
            try:
                pgs = kvc.deserialize_host_pages(pblob)
            except KVIntegrityError:
                self.engine.kv_integrity_rejections += 1
                rejected_hex.append(hexd)
                continue
            finally:
                parts["deserialize"] += time.perf_counter() - t
            if pgs:
                offers.append((bytes.fromhex(hexd), pgs[0]))
        if not offers:
            return {"offered": 0, "applied": False, "adopted": 0,
                    "rejected_digests": rejected_hex, "parts_s": parts}
        t = time.perf_counter()
        done = self.engine.request_import_host(offers)
        self.sched.kick()
        applied = done.wait(timeout=10.0)
        parts["apply"] = time.perf_counter() - t
        return {"offered": len(offers), "applied": bool(applied),
                "adopted": done.adopted, "rejected_digests": rejected_hex,
                "parts_s": parts}

    def _verb_drain(self, conn, obj, blob) -> dict:
        migrate = obj.get("migrate")
        if migrate is None:
            migrate = self.cfg.server.fleet_migrate
        threading.Thread(target=self.drain, args=(bool(migrate),),
                         name="worker-drain", daemon=True).start()
        return {"draining": True}

    def _verb_debug(self, conn, obj, blob) -> dict:
        """Pool-invariant snapshot (meaningful when idle); ``clear``
        empties the prefix cache first so "fully reclaimable" can be
        checked."""
        e = self.engine
        cache = e.prefix_cache
        out = {"pipeline_pending": bool(e.pipeline_pending),
               "preempted_uncollected": len(e._preempted_out)}
        if cache is not None and cache.host_pool is not None:
            pool = cache.host_pool
            out["host_used_matches_entries"] = pool.used == len(cache._host)
            out["host_bytes_match"] = (pool.bytes_resident == sum(
                en.nbytes for en in cache._host.values()))
            out["host_within_capacity"] = 0 <= pool.used <= pool.capacity
            out["tier_overlap"] = len(set(cache._host) & set(cache._table))
        if obj.get("clear"):
            e.set_page_pressure(0)
            if cache is not None:
                cache.clear()
        alloc = e.allocator
        out.update({
            "num_free": alloc.num_free,
            "num_pages": alloc.num_pages,
            "refs_held": sum(1 for p in range(1, alloc.num_pages)
                             if alloc._refs[p] > 0),
            "evictable_count": alloc.evictable_count,
            "slots_bound": sum(s is not None for s in e.slots),
            "host_used": (cache.host_pool.used
                          if cache is not None
                          and cache.host_pool is not None else 0),
        })
        return out

    def _verb_shutdown(self, conn, obj, blob) -> dict:
        self.draining = True
        self.sched.stop(drain=bool(obj.get("drain", True)),
                        timeout=float(obj.get("timeout_s", 30.0)))
        self._shutdown.set()
        return {"stopped": True}

    # ------------------------------------------------------------ drain

    def drain(self, migrate: bool) -> None:
        """Graceful wind-down: freeze the scheduler (in-flight calls
        settle and deliver), export every live request (its KV pages
        when migration is on) as a ``migrate`` event, broadcast
        ``drained`` with the final stats and metrics, exit."""
        if self.draining:
            return
        self.draining = True
        from tpu_inference_torch import telemetry
        from tpu_inference_torch.engine import kv_cache as kvc
        t0 = time.monotonic()
        budget = max(1.0, self.cfg.server.drain_timeout_s)
        engine, sched = self.engine, self.sched
        telemetry.log_event("worker_drain", level="warning",
                            replica=self.replica, migrate=migrate,
                            load=sched.load)
        if engine.telemetry.flight is not None:
            # The last capture before teardown (drain ends in os._exit,
            # so the exit hook will not run).
            engine.telemetry.flight.capture("sigterm", min_interval_s=0.0)
        sched.freeze(timeout=budget)
        with sched._lock:
            pendings = (list(sched._callbacks.values())
                        + list(sched._waiting))
        migrated = 0
        for pending in pendings:
            seq = pending.seq
            if seq.done:
                continue
            tid = seq.trace_id or str(seq.request_id)
            digests, host_pages = [], []
            t_exp = time.perf_counter()
            if migrate and seq.pages and time.monotonic() - t0 < budget:
                try:
                    digests, host_pages = engine.export_sequence_kv(seq)
                except Exception:  # noqa: BLE001 — recompute covers it
                    digests, host_pages = [], []
            if host_pages:
                engine.telemetry.recorder.add(
                    "drain_export", tid, t_exp, time.perf_counter(),
                    pages=len(host_pages))
            ev = {"ev": "migrate", "rid": seq.request_id,
                  "n_generated": len(seq.generated),
                  "digests": [d.hex() for d in digests],
                  # The request continues elsewhere: its spans so far
                  # travel with it.
                  "trace": tid,
                  "spans": engine.telemetry.recorder.export_open(tid)}
            parts = (kvc.serialize_host_pages_parts(host_pages)
                     if host_pages else [])
            if parts and self._arena is not None:
                # The shm plane: the export outlives this process in the
                # router's segment, and only its descriptor rides the
                # event. A full region relays the blob.
                from tpu_inference_torch.server import shm_arena
                try:
                    ev["kv_desc"] = self._arena.publish_parts(parts)
                    parts = []
                except shm_arena.ArenaFull:
                    pass
            blob = b"".join(parts)
            target = self._req_conn.get(seq.request_id)
            if target is not None and target.alive:
                target.send(ev, blob, verb="migrate")
                migrated += 1
        self._broadcast({
            "ev": "drained", "replica": self.replica,
            "migrated_requests": migrated,
            "stats": sched.stats.snapshot(engine),
            "metrics": telemetry.dump_registry(engine.telemetry.registry),
        }, verb="drained")
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.flush(timeout=max(1.0, budget - (time.monotonic() - t0)))
        self._shutdown.set()
        # Everything worth saving has left.
        os._exit(0)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="tpu_inference_torch engine-worker process (one dp "
                    "replica behind the fleet router). Reads a JSON "
                    "config envelope from stdin.")
    ap.add_argument("--socket", required=True,
                    help="unix socket path to serve the RPC on")
    ap.add_argument("--replica", type=int, default=0)
    ap.add_argument("--config", default=None,
                    help="config envelope path (default: stdin)")
    args = ap.parse_args()
    if args.config:
        with open(args.config) as f:
            envelope = json.load(f)
    else:
        envelope = json.load(sys.stdin)

    from tpu_inference_torch.config import framework_config_from_dict

    cfg = framework_config_from_dict(envelope["config"])
    role = envelope.get("role")
    if role:
        # This worker's entry of the router's resolved roles.
        cfg.engine = dataclasses.replace(cfg.engine, role=role)
    nice = int(envelope.get("nice") or 0)
    if nice and hasattr(os, "nice"):
        # The prefill tier's priority on a shared host (decode cadence
        # stays flat under prefill bursts); a refused increment serves
        # at the current priority.
        try:
            os.nice(nice)
        except OSError as e:
            print(f"[worker {args.replica}] os.nice({nice}) refused: "
                  f"{e}; serving at current priority", file=sys.stderr)
    worker = EngineWorker(cfg, replica=args.replica,
                          socket_path=args.socket,
                          device=envelope["device"],
                          warmup=bool(envelope.get("warmup", True)),
                          devices=envelope.get("devices"))
    # This worker's arena region (the shm plane) and the fabric pool's
    # free pages at boot (publish back-pressure).
    worker.attach_arena(envelope.get("shm"))
    ff = envelope.get("fabric_free")
    if ff is not None:
        worker._fabric_free = int(ff)

    def _sigterm(signum, frame):
        # Signal context: the drain thread does the blocking work.
        threading.Thread(target=worker.drain,
                         args=(worker.cfg.server.fleet_migrate,),
                         name="worker-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _sigterm)
    worker.serve()


if __name__ == "__main__":
    main()
