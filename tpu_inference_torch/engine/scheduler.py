"""Continuous-batching scheduler: the host loop that feeds the card.

Twin of ``tpu_inference/engine/scheduler.py`` at the default path:

- One engine thread runs the device loop; the HTTP server submits
  requests from any thread, and token/finish callbacks fire on the
  engine thread.
- FCFS admission (class-aware: interactive before batch before
  background). "reserve" admission charges a request its prompt plus
  its full generation budget; "optimistic" its prompt plus a little
  headroom, with preemption (``_requeue_preempted``: preempted requests
  go back to the head of the queue and recompute-resume) as the safety
  net. Past the base ladder rung, ``ladder_admit_headroom_pages`` must
  stay reclaimable. The head of the queue prefetches its host-tier
  pages while it waits.
- Join/leave at step boundaries: same-bucket arrivals batch into one
  prefill dispatch; a multi-chunk prompt prefills one chunk per loop
  iteration so decode keeps running in between, or, with hybrid steps,
  rides the decode call (``_hybrid_active``).
- Latency mode: with at most ``latency_decode_threshold`` sequences
  decoding and nothing queued or in flight, one step per call so every
  token streams as it is sampled; otherwise K fused steps per call
  through the dispatch-ahead pipeline (``decode_steps_pipelined``).
  Under speculative decoding every call is a spec round (no latency
  mode, no hybrid steps).
- Supervision: ``step_inflight_since`` marks the dispatch in progress
  for the replica's step watchdog; a failed dispatch (an injected
  ``ChaosStepError`` included) fails its requests with reason "error",
  drops the calls in flight, leaves a ``step_error`` flight-recorder
  capture and feeds the health machine. Page-pressure requests from
  other threads apply at the top of each loop iteration, and the flight
  recorder's heartbeat refreshes there.
- P/D handoff: on a prefill-role worker ``on_prefill_handoff`` takes
  each settled prefill (finish reason "handoff"); a request that
  arrives with a handoff's pages (``seq.adopt_kv``) is admitted alone
  through ``engine.adopt_sequence``, with no prefill, and falls back to
  a recompute-resume when the adoption fails.
- Request observability at finish: the phase histograms, the
  ``queue_wait``/``prefill``/``decode`` spans (the engine records the
  ``prefill_chunk`` and ``kv_swap_in`` children; an adoption records
  ``handoff_adopt`` in place of ``prefill``), the rolling SLO
  windows, and one timeline in ``recent`` (GET /debug/requests).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import traceback
from typing import Callable, Deque, Dict, List, Optional

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import class_rank
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence

# on_token(seq, token_id); on_finish(seq)
TokenCallback = Callable[[Sequence, int], None]
FinishCallback = Callable[[Sequence], None]


@dataclasses.dataclass
class SchedulerStats:
    """Server-side counters (scheduler snapshot, /metrics)."""

    steps: int = 0
    prefills: int = 0
    # Settled prefills handed off to a decode worker (P/D).
    pd_handoffs: int = 0
    tokens_generated: int = 0
    tokens_prefix_cached: int = 0
    requests_finished: int = 0
    requests_rejected: int = 0
    step_failures: int = 0
    preemptions: int = 0               # sequences evicted for pool pressure
    batch_occupancy_sum: float = 0.0
    peak_pages_in_use: int = 0
    # Ring of recent decode-call host walls (seconds); a fixed list and
    # index, so /metrics reads never race the engine thread's writes.
    decode_call_s: List[float] = dataclasses.field(
        default_factory=lambda: [0.0] * 512)
    decode_calls: int = 0

    def record_decode_call(self, seconds: float) -> None:
        self.decode_call_s[self.decode_calls % len(self.decode_call_s)] = \
            seconds
        self.decode_calls += 1

    def _decode_call_percentiles(self, pipelined: bool) -> Optional[Dict]:
        n = min(self.decode_calls, len(self.decode_call_s))
        if n == 0:
            return None
        xs = sorted(self.decode_call_s[:n])
        pick = lambda p: xs[min(n - 1, int(p * n))]  # noqa: E731
        # With depth > 1 a call returns after a non-blocking dispatch:
        # the percentiles then measure the dispatch, not the decode.
        return {"p50": round(pick(0.50), 6), "p99": round(pick(0.99), 6),
                "measures": "dispatch" if pipelined else "call"}

    def snapshot(self, engine: InferenceEngine) -> Dict:
        total = engine.engine_cfg.num_pages - 1
        ecfg = engine.engine_cfg
        out = {
            "steps": self.steps,
            "prefills": self.prefills,
            "tokens_generated": self.tokens_generated,
            "tokens_prefix_cached": self.tokens_prefix_cached,
            "requests_finished": self.requests_finished,
            "requests_rejected": self.requests_rejected,
            "step_failures": self.step_failures,
            "admission": engine.admission,
            "preemptions": engine.preemptions_total,
            "recompute_resumes": engine.resumes_total,
            "swap_in_resumes": engine.swap_in_resumes,
            # Drain-time KV migration: pages exported at drain and
            # imported from a sibling replica's drain.
            "migrate_out_pages": engine.migrate_out_pages,
            "migrate_in_pages": engine.migrate_in_pages,
            # P/D: this worker's role, prefills handed off, handoffs
            # adopted here and received ones that fell back to a
            # recompute-resume.
            "role": engine.role,
            "pd_handoffs": self.pd_handoffs,
            "pd_adoptions": engine.adoptions_in,
            "pd_adopt_fallbacks": engine.adopt_fallbacks,
            "hybrid_prefill": ecfg.hybrid_prefill,
            "hybrid_steps": engine.hybrid_steps_total,
            "pool_pressure": round(engine.pool_pressure, 4),
            "mean_batch_occupancy": (self.batch_occupancy_sum / self.steps
                                     if self.steps else 0.0),
            "decode_ladder": list(engine.ladder),
            "decode_rung": engine.decode_rung,
            "rung_peak": engine.rung_peak,
            "rung_switches": engine.rung_switches_total,
            "rung_calls": {str(r): n for r, n
                           in sorted(engine.rung_calls.items())},
            "lane_occupancy": round(
                sum(s is not None for s in engine.slots)
                / max(engine.ladder[-1], 1), 4),
            # The MFU gauge's EWMA (None with telemetry off).
            "mfu_estimate": engine.telemetry.mfu_estimate(),
            "kv_pages_total": total,
            "kv_pages_in_use": total - engine.allocator.num_free,
            "peak_pages_in_use": self.peak_pages_in_use,
            "model_params": engine.n_params,
            # ~2 FLOPs per parameter per decoded token.
            "approx_flops_per_token": 2 * engine.n_params,
            "attn_backend": engine.attn_backend,
            "quant": ecfg.quant,
            "kv_quant": ecfg.kv_quant,
            "decode_pipeline_depth": ecfg.decode_pipeline_depth,
            "decode_call_s": self._decode_call_percentiles(
                ecfg.decode_pipeline_depth > 1),
            "device": str(engine.device),
            "phases": engine.telemetry.phase_snapshot(),
        }
        if engine.prefix_cache is not None:
            out["prefix_cache"] = engine.prefix_cache.stats()
        if engine.spec_enabled:
            d, a = engine.spec_drafted, engine.spec_accepted
            out["speculative"] = {
                # Proposal source and configured γ; the n-gram round mix:
                # verify rounds, plain-call fallbacks (no lane proposed)
                # and γ=0 throttles.
                "mode": engine.spec_mode,
                "gamma": ecfg.num_speculative_tokens,
                "drafted": d, "accepted": a,
                "acceptance_rate": (a / d) if d else 0.0,
                "rounds": engine.spec_rounds_total,
                "fallback_rounds": engine.spec_fallback_rounds,
                "throttles": engine.spec_throttles_total,
            }
        # Exact windowed TTFT/TPOT quantiles and breach counts, with the
        # raw windows (absent with telemetry off).
        if engine.telemetry.slo is not None:
            out["slo"] = engine.telemetry.slo.snapshot()
        return out


@dataclasses.dataclass
class _Pending:
    seq: Sequence
    on_token: TokenCallback
    on_finish: FinishCallback


class EngineScheduler:
    """Threaded continuous-batching loop around an InferenceEngine."""

    # Loop pause while requests wait for pages or slots.
    IDLE_SLEEP_S = 0.001

    def __init__(self, engine: InferenceEngine):
        self.engine = engine
        # A burst of arrivals shares one [P, S] prefill dispatch.
        self.max_prefills_per_step = engine.engine_cfg.max_prefill_batch
        self.stats = SchedulerStats()
        engine.telemetry.bind_scheduler(self)
        # The last 256 finished requests' timelines (/debug/requests).
        self.recent: Deque[dict] = collections.deque(maxlen=256)
        # The engine thread's native id (what a profiler trace names it
        # by), set when the loop starts.
        self.thread_native_id: Optional[int] = None
        self._waiting: Deque[_Pending] = collections.deque()
        self._callbacks: Dict[int, _Pending] = {}
        # At most one multi-chunk prompt prefills incrementally.
        self._prefilling: Optional[_Pending] = None
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Supervision hooks (set by EngineGroup), fired on the engine
        # thread after every dispatch. step_inflight_since is the
        # monotonic start of the dispatch in progress (None between
        # dispatches); the step watchdog reads it from its own thread (a
        # plain attribute store).
        self.step_inflight_since: Optional[float] = None
        self.on_step_ok: Optional[Callable[[], None]] = None
        self.on_step_error: Optional[Callable[[BaseException], None]] = None
        # P/D hook (a prefill-role worker sets it): called on the engine
        # thread when a sequence flagged handoff_after_prefill settles its
        # prefill, its first token delivered. True when the handoff left:
        # the sequence then finishes here with reason "handoff" and
        # resumes on a decode worker; False keeps it decoding here.
        self.on_prefill_handoff: Optional[Callable[[Sequence], bool]] = None

    # -------------------------------------------------- submission API

    @property
    def load(self) -> int:
        """Queued + admitted (not yet finished) requests."""
        return len(self._waiting) + len(self._callbacks)

    def submit(self, seq: Sequence, on_token: TokenCallback,
               on_finish: FinishCallback) -> None:
        """Queue a request; callbacks fire on the engine thread."""
        if len(self._waiting) >= self.engine.engine_cfg.max_queue_len:
            self.stats.requests_rejected += 1
            seq.done, seq.finish_reason = True, "queue_full"
            on_finish(seq)
            return
        if not self.engine.can_ever_admit(seq):
            self.stats.requests_rejected += 1
            seq.done, seq.finish_reason = True, "too_large"
            on_finish(seq)
            return
        seq.enqueue_time = time.perf_counter()
        with self._lock:
            # Insert before any strictly-lower class; FCFS within a class.
            rank = class_rank(seq.priority_class)
            idx = len(self._waiting)
            while idx > 0 and class_rank(
                    self._waiting[idx - 1].seq.priority_class) > rank:
                idx -= 1
            self._waiting.insert(idx, _Pending(seq, on_token, on_finish))
        self._work.set()

    def cancel(self, request_id: int) -> None:
        """Cancel a queued or running request (client disconnect)."""
        with self._lock:
            for p in list(self._waiting):
                if p.seq.request_id == request_id:
                    self._waiting.remove(p)
                    p.seq.done, p.seq.finish_reason = True, "cancelled"
                    return
            p = self._callbacks.get(request_id)
            if p is not None and not p.seq.done:
                p.seq.done = True
                p.seq.finish_reason = "cancelled"

    # -------------------------------------------------- engine loop

    def kick(self) -> None:
        """Wake an idle loop (a queued import waits for its next pass)."""
        self._work.set()

    def start(self) -> "EngineScheduler":
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, name="engine-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful shutdown; with drain=True finish in-flight work first.
        Requests still unfinished at the deadline end with
        ``finish_reason="shutdown"``, so no client stream hangs."""
        if drain:
            deadline = time.monotonic() + timeout
            while (time.monotonic() < deadline
                   and (self._waiting or self._prefilling is not None
                        or self._callbacks
                        or self.engine.active_sequences())):
                time.sleep(0.01)
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self.engine.pipeline_pending:
            # Settle queued calls before their pages are released.
            self._deliver(self._drain_safely())
            self._poll_hybrid_prefill()
        self._requeue_preempted()
        self._cancel_stragglers()

    def freeze(self, timeout: float = 30.0) -> None:
        """Stop the loop and leave every request where it is (a draining
        worker exports them): the thread joins, queued calls settle and
        deliver their tokens, preempted sequences go back to the queue.
        Nothing is finished."""
        self._stop.set()
        self._work.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        if self.engine.pipeline_pending:
            self._deliver(self._drain_safely())
            self._poll_hybrid_prefill()
        self._requeue_preempted()

    def _cancel_stragglers(self) -> None:
        with self._lock:
            stragglers = list(self._waiting) + list(self._callbacks.values())
            for p in self._waiting:
                self._callbacks[p.seq.request_id] = p
            self._waiting.clear()
        for p in stragglers:
            if not p.seq.done:
                p.seq.done, p.seq.finish_reason = True, "shutdown"
                p.seq.finish_time = time.perf_counter()
            self._finish(p.seq)

    def _note_ok(self) -> None:
        if self.on_step_ok is not None:
            self.on_step_ok()

    def _step_failed(self, phase: str, exc: BaseException,
                     seqs: List[Sequence]) -> None:
        """One structured error record and one flight-recorder capture
        per failed dispatch; the affected requests finish with reason
        "error"."""
        self.stats.step_failures += 1
        telemetry.log_event(
            "step_error", level="error", phase=phase, error=repr(exc),
            request_ids=[s.trace_id or str(s.request_id) for s in seqs],
            traceback="".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__, limit=8)))
        flight = self.engine.telemetry.flight
        if flight is not None:
            # Evidence first, while the failed step's records are the
            # newest in the ledger.
            flight.capture("step_error")
        if self.on_step_error is not None:
            self.on_step_error(exc)
        for s in seqs:
            if not s.done:
                s.done, s.finish_reason = True, "error"
                s.finish_time = time.perf_counter()
            self._finish(s)

    def _hybrid_active(self) -> bool:
        """True when the in-progress incremental prefill advances through
        hybrid steps (fused into the decode call): hybrid_prefill is on,
        speculative decoding is off (its rounds are calls of their own),
        and there are decode lanes to fuse with."""
        return (self.engine.engine_cfg.hybrid_prefill
                and not self.engine.spec_enabled
                and self._prefilling is not None
                and bool(self.engine.active_sequences()))

    def _needs_chunking(self, seq: Sequence) -> bool:
        """The prompt (on a resume: prompt + generated) spans several
        chunks, so it prefills incrementally."""
        ecfg = self.engine.engine_cfg
        base = len(self.engine._prefill_tokens(seq))
        return min(base, ecfg.max_context - 1) > ecfg.chunk_tokens_cap

    def _prefill_done(self, pending: _Pending) -> None:
        seq = pending.seq
        self.stats.prefills += 1
        self.stats.tokens_generated += 1
        self.engine.telemetry.note_tokens(1)
        if not seq.resume_base:
            # A resume reuses pages this request published itself.
            self.stats.tokens_prefix_cached += seq.cached_tokens
            if seq.enqueue_time:
                self.engine.telemetry.queue_wait_s.observe(
                    max(0.0, seq.prefill_start - seq.enqueue_time))
        pending.on_token(seq, seq.generated[-1])
        if (not seq.done and seq.handoff_after_prefill
                and self.on_prefill_handoff is not None
                and self.on_prefill_handoff(seq)):
            self.stats.pd_handoffs += 1
            seq.done, seq.finish_reason = True, "handoff"
            seq.finish_time = time.perf_counter()
        if seq.done:
            self._finish(seq)

    def _step_incremental_prefill(self) -> None:
        """Advance the in-progress multi-chunk prefill by ONE chunk."""
        pending = self._prefilling
        seq = pending.seq
        if seq.done:                          # cancelled mid-prefill
            self._prefilling = None
            self._finish(seq)
            return
        self.step_inflight_since = time.monotonic()
        try:
            finished = self.engine.prefill_step(seq)
        except Exception as exc:  # noqa: BLE001 — keep the engine loop alive
            self._prefilling = None
            self._step_failed("incremental_prefill", exc, [seq])
            return
        finally:
            self.step_inflight_since = None
        self._note_ok()
        if finished:
            self._prefilling = None
            self._prefill_done(pending)

    def _admit(self) -> None:
        """Admit up to max_prefills_per_step waiting requests in one
        batched prefill; a multi-chunk prompt starts an incremental
        prefill instead (one at a time)."""
        if self._prefilling is not None and not self._hybrid_active():
            # With hybrid steps active the chunk rides the decode call
            # later this iteration instead.
            seq = self._prefilling.seq
            if seq.done and self.engine.pipeline_pending:
                # Cancelled with chained hybrid chunks in flight: settle
                # their writes before the pages are released.
                self._deliver(self._drain_safely())
            self._poll_hybrid_prefill()   # completed at an earlier sync?
            if self._prefilling is not None:
                if not (not seq.done and seq.prefill_prompt is not None
                        and seq.prefill_offset >= len(seq.prefill_prompt)):
                    # (Otherwise every chunk is already staged into
                    # in-flight hybrid calls: nothing to run serially.)
                    self._step_incremental_prefill()
        batch: List[_Pending] = []
        start_chunked: Optional[_Pending] = None
        start_adopt: Optional[_Pending] = None
        reserved = 0
        engine = self.engine
        with self._lock:
            free_slots = len(engine.free_slots())
            bound = sum(s is not None for s in engine.slots)
            base_rung = engine.ladder[0]
            headroom = engine.engine_cfg.ladder_admit_headroom_pages
            while (len(batch) < self.max_prefills_per_step
                   and len(batch) < free_slots and self._waiting):
                pending = self._waiting[0]
                if pending.seq.done:          # cancelled while queued
                    self._waiting.popleft()
                    continue
                need = engine._pages_for_admission(pending.seq)
                if engine._free_plus_evictable() < reserved + need:
                    break
                # Batch-ladder guard: growing past the base rung must
                # leave ``headroom`` reclaimable pages behind.
                if (headroom > 0
                        and bound + len(batch) + 1 > base_rung
                        and engine._free_plus_evictable()
                        < reserved + need + headroom):
                    break
                if pending.seq.adopt_kv is not None:
                    # A P/D handoff: restored alone below, with no
                    # prefill (before _needs_chunking, which would read
                    # prompt + generated as a prompt to chunk).
                    if batch:
                        break
                    self._waiting.popleft()
                    self._callbacks[pending.seq.request_id] = pending
                    start_adopt = pending
                    break
                if self._needs_chunking(pending.seq):
                    if self._prefilling is not None or batch:
                        break
                    self._waiting.popleft()
                    self._callbacks[pending.seq.request_id] = pending
                    start_chunked = pending
                    reserved += need
                    break
                self._waiting.popleft()
                # Register before releasing the lock so cancel() always
                # finds the request in _waiting or _callbacks.
                self._callbacks[pending.seq.request_id] = pending
                reserved += need
                batch.append(pending)
        # Queue-wait swap-in: the head request's host-tier pages restore
        # into cache-owned pages while it waits.
        if engine.host_pool is not None:
            with self._lock:
                head = self._waiting[0] if self._waiting else None
            # A handoff's KV comes with its blob, not from the host tier.
            if (head is not None and not head.seq.done
                    and head.seq.adopt_kv is None):
                try:
                    engine.prefetch_host_hits(head.seq)
                except Exception as exc:  # noqa: BLE001 — keep loop alive
                    telemetry.log_event(
                        "step_error", level="error", phase="host_prefetch",
                        error=repr(exc),
                        request_ids=[head.seq.trace_id
                                     or str(head.seq.request_id)])
        if start_adopt is not None:
            self._adopt(start_adopt)
            return
        if start_chunked is not None:
            try:
                engine.prefill_begin(start_chunked.seq)
            except Exception as exc:  # noqa: BLE001
                self._step_failed("prefill_begin", exc, [start_chunked.seq])
                return
            self._prefilling = start_chunked
            if self._hybrid_active():
                return    # the first chunk rides this iteration's call
            self._step_incremental_prefill()
            return
        if not batch:
            return
        self.step_inflight_since = time.monotonic()
        try:
            engine.prefill_many([p.seq for p in batch])
        except Exception as exc:  # noqa: BLE001 — keep the engine loop alive
            self._step_failed("batched_prefill", exc, [p.seq for p in batch])
            return
        finally:
            self.step_inflight_since = None
        self._note_ok()
        for pending in batch:
            self._prefill_done(pending)

    def _adopt(self, pending: _Pending) -> None:
        """Restore a P/D handoff's pages and resume decode (no token is
        delivered: the client has every token in seq.generated). A
        malformed export or a pool shortfall is logged and counted, and
        the request goes back to the head of the queue without its KV,
        to recompute-resume through the ordinary prefill."""
        seq = pending.seq
        t0 = time.perf_counter()
        self.step_inflight_since = time.monotonic()
        try:
            self.engine.adopt_sequence(seq)
        except Exception as exc:  # noqa: BLE001 — keep the loop alive
            telemetry.log_event(
                "step_error", level="error", phase="handoff_adopt",
                error=repr(exc),
                request_ids=[seq.trace_id or str(seq.request_id)])
            self.engine.adopt_fallbacks += 1
            seq.adopt_kv = None
            with self._lock:
                self._callbacks.pop(seq.request_id, None)
                self._waiting.appendleft(pending)
            return
        finally:
            self.step_inflight_since = None
        self._note_ok()
        # Stands in for the prefill span; it ends at first_token_time
        # (the adoption instant), where the decode span begins.
        self.engine.telemetry.recorder.add(
            "handoff_adopt", seq.trace_id or str(seq.request_id), t0,
            seq.first_token_time or time.perf_counter(),
            ctx_len=seq.ctx_len, pages=len(seq.pages))
        if seq.done:                  # cancelled while queued
            self._finish(seq)

    def _drain_safely(self) -> Dict[int, List[int]]:
        """drain_pipeline under the loop's keep-alive contract: a device
        error that surfaces at a sync fails the affected requests with
        "error" instead of killing the engine thread."""
        engine = self.engine
        try:
            return engine.drain_pipeline()
        except Exception as exc:  # noqa: BLE001 — keep the loop alive
            victims = engine.active_sequences()
            pending = self._prefilling
            if pending is not None:
                self._prefilling = None
                if pending.seq not in victims:
                    victims = victims + [pending.seq]
            engine.abort_pipeline()
            engine.take_preempted()
            self._step_failed("drain", exc, victims)
            return {}

    def _poll_hybrid_prefill(self) -> None:
        """A hybrid prefill completes at a sync (the final chunk's token
        folds in the engine's _sync_oldest): detect it and run the
        post-prefill bookkeeping."""
        pending = self._prefilling
        if pending is None or pending.seq.prefill_prompt is not None:
            return
        self._prefilling = None
        self._prefill_done(pending)

    def _requeue_preempted(self) -> None:
        """Move sequences the engine preempted back to the HEAD of the
        queue (admitted before anything still waiting) for recompute-
        resume; their entries leave _callbacks until re-admitted. Runs
        after _deliver: tokens folded before a preemption reach the
        client first."""
        preempted = self.engine.take_preempted()
        if not preempted:
            return
        self.stats.preemptions += len(preempted)
        cancelled: List[Sequence] = []
        with self._lock:
            for seq in reversed(preempted):
                pending = self._callbacks.get(seq.request_id)
                if pending is None:
                    continue
                if seq.done:          # cancelled while being preempted
                    cancelled.append(seq)
                    continue
                del self._callbacks[seq.request_id]
                self._waiting.appendleft(pending)
        for seq in cancelled:
            self._finish(seq)

    def _finish(self, seq: Sequence) -> None:
        with self._lock:
            if seq.reaped:
                return
            seq.reaped = True
            pending = self._callbacks.pop(seq.request_id, None)
        self.engine.release(seq)
        self.stats.requests_finished += 1
        self._observe_finish(seq)
        with self._lock:
            self.recent.append(self._timeline(seq))
        if pending is not None:
            pending.on_finish(seq)

    def _observe_finish(self, seq: Sequence) -> None:
        """Fold one finished request into the phase histograms, its
        spans and SLO windows, and the structured log. The phases come
        from the timestamps of the /debug/requests timeline, so queue +
        prefill + decode sums to e2e."""
        tel = self.engine.telemetry
        tel.request_finished(seq.finish_reason)
        fin = seq.finish_time or time.perf_counter()
        first = seq.first_token_time or fin
        start = seq.prefill_start or fin
        enq = seq.enqueue_time or start
        if seq.enqueue_time:
            tel.prefill_phase_s.observe(max(0.0, first - start))
            tel.decode_phase_s.observe(max(0.0, fin - first))
            tel.ttft_s.observe(max(0.0, first - enq))
            tel.e2e_s.observe(max(0.0, fin - enq))
        self._observe_trace(seq, enq, start, first, fin)
        telemetry.log_event(
            "request_finish", level="info",
            request_id=seq.trace_id or str(seq.request_id),
            reason=seq.finish_reason, attempt=seq.attempt,
            routed_replica=seq.routed_replica,
            route_hit_pages=seq.route_hit_pages,
            route_host_hit_pages=seq.route_host_hit_pages,
            route_fabric_hit_pages=seq.route_fabric_hit_pages,
            host_restored_pages=seq.host_restored_pages,
            preemptions=seq.preemptions,
            prompt_tokens=len(seq.prompt_tokens),
            output_tokens=len(seq.generated),
            queue_wait_s=round(max(0.0, start - enq), 6),
            prefill_s=round(max(0.0, first - start), 6),
            decode_s=round(max(0.0, fin - first), 6),
            e2e_s=round(max(0.0, fin - enq), 6))

    def _observe_trace(self, seq: Sequence, enq: float, start: float,
                       first: float, fin: float) -> None:
        """Record the request's phase spans, seal its trace, and fold its
        TTFT/TPOT into the rolling SLO windows.

        Spans: queue_wait covers enqueue -> prefill start (admission
        included); prefill covers prefill start -> first token (its
        prefill_chunk children were recorded by the engine; an adopted
        sequence's handoff_adopt span stands in for it); decode covers
        first token -> finish, and is skipped on a "handoff" finish (no
        decode ran here). Sealing moves the trace into the recorder's
        recent ring, where /debug/trace reads it."""
        tel = self.engine.telemetry
        rec = tel.recorder
        tid = seq.trace_id or str(seq.request_id)
        if rec.enabled and seq.enqueue_time:
            rec.add("queue_wait", tid, enq, max(enq, start),
                    admission=self.engine.admission)
            if not seq.adopted:
                rec.add("prefill", tid, start, max(start, first),
                        cached_tokens=seq.cached_tokens,
                        host_restored_pages=seq.host_restored_pages,
                        attempt=seq.attempt)
            if seq.finish_reason != "handoff":
                attrs = {"output_tokens": len(seq.generated),
                         "reason": seq.finish_reason,
                         "preemptions": seq.preemptions}
                if seq.spec_rounds:
                    attrs["spec_rounds"] = seq.spec_rounds
                    attrs["spec_accepted_tokens"] = seq.spec_accepted_toks
                rec.add("decode", tid, first, max(first, fin), **attrs)
        rec.seal(tid)
        # TTFT counts only on a fresh first attempt (attempt 0, no
        # resume, a first token, no error): a resume's local gap is not
        # what the client waited. TPOT only where decode steps ran here:
        # the first token is `first`, so decoded - 1 gaps follow it (on
        # an adopted sequence `first` is the adoption instant, and every
        # decoded token follows it).
        slo = tel.slo
        if slo is None or not seq.enqueue_time:
            return
        ttft = (max(0.0, first - enq)
                if not seq.resume_base and seq.attempt == 0
                and seq.first_token_time
                and seq.finish_reason != "error" else None)
        decoded = len(seq.generated) - seq.resume_base
        gaps = decoded if seq.adopted else decoded - 1
        tpot = (max(0.0, fin - first) / gaps
                if gaps > 0 and seq.finish_reason != "handoff"
                else None)
        slo.observe(ttft, tpot)

    def recent_snapshot(self, n: int) -> List[dict]:
        """A copy of the last ``n`` request timelines (the deque is
        appended on the engine thread)."""
        with self._lock:
            items = list(self.recent)
        return items[-n:]

    @staticmethod
    def _timeline(seq: Sequence) -> dict:
        """One request's lifecycle as durations (seconds), with the
        reference's keys."""
        fin = seq.finish_time or time.perf_counter()
        first = seq.first_token_time or fin
        n_out = len(seq.generated)
        return {
            "request_id": seq.request_id,
            "trace_id": seq.trace_id,
            "attempt": seq.attempt,
            "routed_replica": seq.routed_replica,
            "route_hit_pages": seq.route_hit_pages,
            "route_host_hit_pages": seq.route_host_hit_pages,
            "route_fabric_hit_pages": seq.route_fabric_hit_pages,
            "finished_unix": round(time.time(), 3),
            "prompt_tokens": len(seq.prompt_tokens),
            "cached_tokens": seq.cached_tokens,
            "host_restored_pages": seq.host_restored_pages,
            "output_tokens": n_out,
            "preemptions": seq.preemptions,
            "finish_reason": seq.finish_reason,
            "queue_wait_s": round(max(0.0, (seq.prefill_start or fin)
                                      - seq.enqueue_time), 6),
            "prefill_s": round(max(0.0, first - (seq.prefill_start or first)),
                               6),
            "decode_s": round(max(0.0, fin - first), 6),
            "e2e_s": round(max(0.0, fin - (seq.enqueue_time
                                           or seq.prefill_start or fin)), 6),
            "ttft_s": round(max(0.0, first - (seq.enqueue_time or first)), 6),
            "dispatch_wall_s": round(seq.dispatch_wall_s, 6),
            "bubble_s": round(seq.bubble_s, 6),
            "tpot_s": round((fin - first) / (n_out - 1), 6)
            if n_out > 1 else None,
        }

    def _deliver(self, new_tokens: Dict[int, List[int]]) -> None:
        for rid, toks in new_tokens.items():
            pending = self._callbacks.get(rid)
            if pending is not None:
                for tok in toks:
                    pending.on_token(pending.seq, tok)

    def _reapable(self) -> List[Sequence]:
        """Finished sequences the loop may finish now (a sequence still
        owned by the incremental prefill is finished by that path)."""
        own = self._prefilling.seq if self._prefilling is not None else None
        return [s for s in self.engine.slots
                if s is not None and s.done and s is not own]

    def run(self) -> None:
        engine = self.engine
        self.thread_native_id = threading.get_native_id()
        while not self._stop.is_set():
            # Re-read each iteration: the recorder may be attached after
            # the loop starts.
            flight = engine.telemetry.flight
            if flight is not None:
                # The heartbeat capture a kill -9 leaves behind.
                flight.maybe_periodic()
            # Cross-thread page-pressure requests (/debug/chaos) apply
            # here: the allocator is engine-thread only.
            engine.apply_pending_page_pressure()
            # Migrated KV lands in the host tier before admission, so a
            # resubmitted request swaps it in.
            engine.apply_pending_imports()
            self._admit()
            active = engine.active_sequences()
            if not active:
                # Flush dispatch-ahead calls, then reap even when idle.
                if engine.pipeline_pending:
                    self._deliver(self._drain_safely())
                    self._poll_hybrid_prefill()
                for s in self._reapable():
                    self._finish(s)
                self._requeue_preempted()
                if self._prefilling is not None:
                    continue          # next iteration runs the next chunk
                if not self._waiting:
                    self._work.clear()
                    self._work.wait(timeout=0.1)
                else:
                    time.sleep(self.IDLE_SLEEP_S)
                continue
            hybrid_pf = self._prefilling if self._hybrid_active() else None
            if hybrid_pf is not None and hybrid_pf.seq.done:
                # Cancelled mid-hybrid-prefill: settle in-flight chunk
                # writes before its pages are released.
                self._deliver(self._drain_safely())
                self._prefilling = None
                self._finish(hybrid_pf.seq)
                hybrid_pf = None
            thresh = engine.engine_cfg.latency_decode_threshold
            t_call = time.perf_counter()
            self.step_inflight_since = time.monotonic()
            try:
                if hybrid_pf is not None:
                    new_tokens = engine.hybrid_step_pipelined(hybrid_pf.seq)
                elif (0 < len(active) <= thresh and not self._waiting
                        and self._prefilling is None
                        and not engine.pipeline_pending
                        and not engine.spec_enabled):
                    # Latency mode; a spec round has its own cadence.
                    new_tokens = engine.decode_steps(max_steps=1)
                else:
                    new_tokens = engine.decode_steps_pipelined()
                self.stats.record_decode_call(time.perf_counter() - t_call)
            except Exception as exc:  # noqa: BLE001 — keep the loop alive
                victims = list(active)
                if hybrid_pf is not None:
                    # The failed call carried a chunk: its request fails
                    # with the batch.
                    self._prefilling = None
                    victims.append(hybrid_pf.seq)
                # Stale in-flight state would poison reused slots; drop
                # mid-call preemptions too (they fail with the batch).
                engine.abort_pipeline()
                engine.take_preempted()
                self._step_failed("hybrid" if hybrid_pf is not None
                                  else "decode", exc, victims)
                continue
            finally:
                self.step_inflight_since = None
            self._note_ok()
            self.stats.steps += 1
            self.stats.batch_occupancy_sum += len(active)
            if self._reapable() and engine.pipeline_pending:
                # A finish releases pages a newer in-flight call may still
                # write: drain first, and deliver the drained tokens too.
                for rid, toks in self._drain_safely().items():
                    new_tokens.setdefault(rid, []).extend(toks)
            n_new = sum(len(toks) for toks in new_tokens.values())
            self.stats.tokens_generated += n_new
            engine.telemetry.note_tokens(n_new)
            in_use = (engine.engine_cfg.num_pages - 1
                      - engine.allocator.num_free)
            self.stats.peak_pages_in_use = max(self.stats.peak_pages_in_use,
                                               in_use)
            self._deliver(new_tokens)
            self._poll_hybrid_prefill()
            self._requeue_preempted()
            for s in self._reapable():
                self._finish(s)
