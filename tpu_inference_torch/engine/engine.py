"""The inference engine: bucketed prefill + K-step batched decode.

Twin of ``tpu_inference/engine/engine.py`` on one card, in eager
PyTorch:

- **Prefill** runs one [P, S_bucket] forward for up to
  ``max_prefill_batch`` same-bucket prompts (dummy lanes write only the
  trash page); prompts longer than the chunk cap prefill chunk by chunk
  (``prefill_begin``/``prefill_step``), each chunk attending to itself
  plus every cached token.
- **Decode** runs K steps per call with the sampled tokens fed back on
  the device; the scheduler's latency mode runs the K=1 route.
- **Decode batch ladder** (``decode_ladder``): the slot array holds the
  top rung's lanes; each call runs at the smallest rung covering the
  occupied slots, and slots compact down when occupancy drops. The
  kernels' per-lane arithmetic does not depend on the batch width
  (kernels/paged_attention.py split_plan).
- **Dispatch-ahead pipeline** (``decode_pipeline_depth`` > 1): up to
  depth K-step calls stay queued on the stream, each staged from the
  host state plus the predicted advance of the calls still in flight
  and fed the newest in-flight call's last tokens on the device. Every
  host array reaches the card through pinned memory and a non-blocking
  copy, each call's tokens come back through a non-blocking copy and a
  CUDA event, and the host waits on the oldest call's event only.
- **Hybrid steps** (``hybrid_prefill``): one call runs a [1, S_bucket]
  chunk of a long prompt through the prefill kernel, then the [B] K-step
  decode through the decode kernel; the two touch disjoint pages, so the
  result is the serial order's.
- **Optimistic admission and preemption** (``admission="optimistic"``):
  requests are charged their prompt plus a little headroom; under
  pressure the newest lanes are preempted (pages published to the prefix
  cache, slot freed) and later recompute-resume over prompt + generated
  tokens.
- **Host KV tier** (``host_cache_pages``): prefix-cache eviction demotes
  pages to pinned host memory; lookups and the queue-wait prefetch
  restore them into fresh device pages.
- Attention goes through ``make_paged_attn``: K/V are written into the
  paged pool first, then the Hopper kernels (``"kernel"``; their plain
  versions for CPU tensors) or the dense gather path (``"dense"``) read
  them back. The pool is updated in place (kv_cache.write_kv), which is
  what the reference's buffer donation achieves under XLA.
- **Speculative decoding** (``spec_mode``, ``num_speculative_tokens``;
  engine/speculative.py): "ngram" proposes from each sequence's own
  history on the host and verifies γ+1 positions in one target forward
  (the prefill kernel at S = γ+1), with adaptive per-sequence γ, rounds
  at every ladder rung and through the dispatch-ahead pipeline, and the
  plain K-step call when no lane proposes; "draft" runs a draft model
  (its own pool, the target pool's positional twin) for γ+1 steps, then
  the target verify, both on the dense gather path as the reference
  builds them.
- **Fault injection** (``chaos_*``): every prefill/decode dispatch entry
  runs ``_chaos_step_gate`` (a sleep, then a random ``ChaosStepError``),
  and ``set_page_pressure`` holds real pages out of the pool; both can
  be armed from another thread (the page pressure applies on the engine
  thread).
- ``EngineConfig.quant`` stores the matmul weights as int8 or int4 codes
  with scales (models/quant.py); ``kv_quant`` makes the pool int8 or
  packed int4 with per-(token, head) scales, which both kernels
  dequantize as they load each page. The reference's boot gate for int4
  KV on a TPU (``int4_mosaic_validated``) has no counterpart: on the
  card, chip_smoke.py holds the int4 variants of both kernels against
  their plain versions on every run.
- **Step ledger**: every dispatch pushes one record (kind, rung, lanes,
  tokens, device and host walls, cache reads, swap bytes) into
  ``telemetry.step_ledger`` (``_ledger_push``); pipelined calls push at
  their sync with the fields captured when they were staged.
- **Embeddings** (``embed_many``): mean-pooled hidden states from dense,
  cache-free forwards, apart from the pool and the scheduler.
- **Drain and import** (the process fleet): ``export_sequence_kv``
  copies a live sequence's full pages off the pool for migration, and
  ``request_import_host`` / ``apply_pending_imports`` adopt another
  replica's export into the host tier on the engine thread.
- **P/D roles** (``EngineConfig.role``): a "prefill" engine warms only
  the prefill shapes, a "decode" engine only the decode calls and verify
  widths. ``export_sequence_kv_live`` copies every page of a live
  sequence's first ``ctx_len`` tokens, the partial final page included;
  ``adopt_sequence`` restores such an export into fresh pages and
  resumes decode with nothing recomputed.

Index ranges the reference gets for free from XLA's clamping gathers
are kept in range explicitly: positions clamp at ``max_context - 1``
before they pick a block-table column, embedding ids clamp into the
table (inactive lanes carry stale ids), and the kernels bounds-check
page ids.
"""

from __future__ import annotations

import dataclasses
import random as _chaos_random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import (WORKER_ROLES, EngineConfig,
                                        ModelConfig, validate_spec_config)
from tpu_inference_torch.engine import kv_cache as kvc
from tpu_inference_torch.engine.autosize import validate_ladder
from tpu_inference_torch.engine.kv_cache import PageAllocator
from tpu_inference_torch.engine.prefix_cache import PrefixCache, _chain_hashes
from tpu_inference_torch.engine.sampling import (
    PENALTY_WINDOW,
    SamplingParams,
    roll_window,
    sample,
)
from tpu_inference_torch.engine.speculative import (NGRAM_SCAN_CAP,
                                                     ngram_propose,
                                                     spec_round,
                                                     verify_round)
from tpu_inference_torch.models.common import (dense_causal_attention,
                                               make_dense_attn)
from tpu_inference_torch.models.quant import QuantizedArray, quantize_params
from tpu_inference_torch.models.registry import build_model, get_model_fns

class ImportDone(threading.Event):
    """Set once a queued migration import was applied; ``adopted`` is the
    pages it added to the host tier (imports queued side by side are
    applied in one pass, so a counter's delta would mix them)."""

    adopted = 0


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; CUDA asked for and missing
    raises (the port never continues on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def make_paged_attn(cfg: ModelConfig, page_size: int,
                    block_tables: torch.Tensor, positions: torch.Tensor,
                    valid: torch.Tensor, q_offset: torch.Tensor,
                    kv_len: torch.Tensor, attn_backend: str = "dense"):
    """AttentionFn that writes new K/V into the paged pool, then attends.

    block_tables [B, MP] int32; positions/valid [B, S]; q_offset/kv_len
    [B] int32. ``"kernel"`` routes one-token queries to the decode kernel
    and longer ones to the prefill kernel; ``"dense"`` gathers the pages
    and runs dense causal attention. The slot map is shared by every
    layer of the forward.
    """
    from tpu_inference_torch.kernels.paged_attention import paged_attention
    from tpu_inference_torch.kernels.prefill_attention import (
        paged_prefill_attention)

    slots = kvc.slot_mapping(block_tables, positions, valid, page_size)
    win = cfg.sliding_window

    def attn(layer_idx, q, k, v, kv: kvc.KVPages):
        kv = kvc.write_kv(kv, layer_idx, k, v, slots)
        ks, vs = ((kv.k_scale[layer_idx], kv.v_scale[layer_idx])
                  if kv.quantized else (None, None))
        if attn_backend == "kernel" and q.shape[1] == 1:
            out = paged_attention(q[:, 0].contiguous(), kv.k[layer_idx],
                                  kv.v[layer_idx], block_tables, kv_len,
                                  ks, vs, sliding_window=win)
            return out[:, None], kv
        if attn_backend == "kernel":
            return paged_prefill_attention(
                q.contiguous(), kv.k[layer_idx], kv.v[layer_idx],
                block_tables, kv_len, q_offset, ks, vs,
                sliding_window=win), kv
        k_all, v_all = kvc.gather_kv(kv, layer_idx, block_tables)
        out = dense_causal_attention(q, k_all, v_all, q_offset=q_offset,
                                     kv_len=kv_len, sliding_window=win)
        return out, kv

    return attn


class ChaosStepError(RuntimeError):
    """Injected engine-step failure (EngineConfig.chaos_step_failure_rate):
    a type of its own so tests tell injected faults from real ones; the
    scheduler treats both alike (any step exception feeds the replica
    health machine)."""


@dataclasses.dataclass
class Sequence:
    """Host-side state for one running sequence (one decode slot)."""

    request_id: int
    prompt_tokens: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: Optional[int] = None            # None = engine default
    seed: Optional[int] = None             # None = engine generator
    repeat_penalty: float = 1.0            # Ollama options (1.0 = off)
    repeat_last_n: int = 64
    eos_token_id: Optional[int] = None
    # Filled by the engine:
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    # Bumped whenever ``pages`` is replaced wholesale (each prefill
    # setup): part of the staging buffers' block-table key, so a resumed
    # sequence in the same slot never reuses a stale row.
    pages_version: int = 0
    ctx_len: int = 0                       # tokens currently in KV
    # SWA eviction cursor: pages[:evicted_pages] are behind the window,
    # freed, and replaced by the trash page in the block table.
    evicted_pages: int = 0
    cached_tokens: int = 0                 # prefix-cache hit length
    # Host KV tier: pages this request's prefills restored from host
    # memory, and whether the queue-wait prefetch already ran for it.
    host_restored_pages: int = 0
    host_prefetched: bool = False
    prefix_digests: Optional[List[bytes]] = None
    # Digests of the resume stream (prompt + tokens generated before a
    # preemption), kept apart from prefix_digests; cleared at each
    # preemption.
    resume_digests: Optional[List[bytes]] = None
    # Preemption / recompute-resume: preemptions so far (the starvation
    # guard compares it with preempt_max_per_request); resume_base =
    # generated tokens present at the last (re)prefill; admit_idx =
    # admission order (the newest is preempted first).
    preemptions: int = 0
    resume_base: int = 0
    admit_idx: int = -1
    # Incremental multi-chunk prefill state (prefill_begin/prefill_step).
    prefill_prompt: Optional[List[int]] = None
    prefill_offset: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: str = ""
    # Set under the scheduler lock by EngineScheduler._finish so the
    # terminal path runs exactly once.
    reaped: bool = False
    enqueue_time: float = 0.0
    prefill_start: float = 0.0
    first_token_time: float = 0.0
    finish_time: float = 0.0
    # The client-visible request id (X-Request-Id): it keys the
    # request's spans and structured logs. attempt counts failover
    # resubmissions.
    trace_id: str = ""
    attempt: int = 0
    priority_class: str = "interactive"
    # Routing: the replica this attempt was dispatched to (-1 when
    # submitted to a scheduler directly) and the prefix-cache pages the
    # router counted on, of them host-tier ones, and pages pulled from a
    # fleet KV fabric (always 0: the port has none).
    routed_replica: int = -1
    route_hit_pages: int = 0
    route_host_hit_pages: int = 0
    route_fabric_hit_pages: int = 0
    # Exposure accrued by the engine: the wall of every dispatch this
    # request took part in, and its share of the host bubbles between
    # decode calls (a shared dispatch accrues to each participant).
    dispatch_wall_s: float = 0.0
    bubble_s: float = 0.0
    # Adaptive γ of n-gram speculation: the current γ (-1 = not yet
    # chosen, 0 = throttled), the acceptance EWMA (starts mildly
    # optimistic), the countdown to a throttled lane's next probe and the
    # probe interval (doubling per failed probe, capped at 8x
    # spec_probe_every). Survives preemption: a stream's echo statistics
    # do not change when its pages do.
    spec_gamma: int = -1
    spec_accept_ewma: float = 0.5
    spec_probe_countdown: int = 0
    spec_probe_interval: int = 0
    # Speculative rounds this sequence proposed in, positions accepted.
    spec_rounds: int = 0
    spec_accepted_toks: int = 0
    # P/D handoff. Outbound: on a prefill-role worker the scheduler hands
    # the settled prefill off instead of decoding it. Inbound: adopt_kv =
    # (host pages, ctx_len) of a received handoff, restored at admission
    # (adopt_sequence); adopted marks an attempt that ran no prefill.
    handoff_after_prefill: bool = False
    adopt_kv: Optional[tuple] = None
    adopted: bool = False

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.prompt_tokens[-1]


class InferenceEngine:
    """Owns device state (params, KV pool) and the prefill/decode steps."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[dict] = None, seed: int = 0,
                 attn_backend: Optional[str] = None, device="cuda",
                 draft_cfg: Optional[ModelConfig] = None,
                 draft_params: Optional[dict] = None):
        """``draft_cfg`` (with ``spec_mode="draft"`` and
        ``num_speculative_tokens`` > 0) turns on draft-model speculation;
        its weights are ``draft_params`` or random from ``seed + 1``."""
        self.device = resolve_device(device)
        model_cfg.validate()
        if engine_cfg.role not in WORKER_ROLES:
            raise ValueError(f"unknown engine role {engine_cfg.role!r}; "
                             f"one of {WORKER_ROLES}")
        if engine_cfg.admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission mode "
                             f"{engine_cfg.admission!r}; "
                             "one of ('reserve', 'optimistic')")
        # Speculative decoding: "draft" = a draft model proposes (its own
        # pool, so several compositions below are gated off); "ngram" =
        # host-side self-drafting, no draft pool, so the ladder, the host
        # tier, SWA eviction and the repetition penalty all stay on.
        if engine_cfg.spec_mode not in ("draft", "ngram"):
            raise ValueError(f"unknown spec_mode {engine_cfg.spec_mode!r}; "
                             "one of ('draft', 'ngram')")
        if engine_cfg.spec_mode == "ngram":
            validate_spec_config("ngram", engine_cfg.num_speculative_tokens,
                                 engine_cfg.ngram_window,
                                 draft_cfg is not None)
        spec_draft = (engine_cfg.spec_mode == "draft"
                      and draft_cfg is not None
                      and engine_cfg.num_speculative_tokens > 0)
        self.spec_draft = spec_draft
        self.spec_ngram = engine_cfg.spec_mode == "ngram"
        self.spec_enabled = spec_draft or self.spec_ngram
        self.spec_mode = "ngram" if self.spec_ngram else "draft"
        self.ladder = validate_ladder(engine_cfg.ladder_rungs,
                                      engine_cfg.max_batch_size)
        if spec_draft and len(self.ladder) > 1:
            # The draft-model round runs at the full batch (the
            # reference compiles it once, at the top rung).
            print(f"[engine] {model_cfg.name}: draft-model speculative "
                  "decoding - decode ladder collapsed to the top rung")
            self.ladder = (engine_cfg.max_batch_size,)
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.mod = get_model_fns(model_cfg)
        backend = attn_backend or engine_cfg.attn_backend
        if backend == "auto":
            backend = "kernel"
        if backend not in ("dense", "kernel"):
            raise ValueError(f"unknown attn_backend {backend!r}; "
                             "expected 'auto', 'dense' or 'kernel'")
        self.attn_backend = backend
        if params is None:
            # With a quant mode, leaf-by-leaf init + quantize: peak card
            # memory stays near the quantized model's size.
            params, _ = build_model(model_cfg, seed=seed, device=self.device,
                                    quant=engine_cfg.quant)
        # No-op on leaves already quantized (init above, or a caller's).
        self.params = quantize_params(params, engine_cfg.quant)
        # Quantized leaves count their codes and their scales.
        leaves = _leaves(self.params)
        self.n_params = int(sum(t.numel() for t in leaves))
        self.weight_bytes = int(sum(t.numel() * t.element_size()
                                    for t in leaves))
        self.kv = kvc.alloc_kv_pages(model_cfg, engine_cfg,
                                     device=self.device)
        self.allocator = PageAllocator(engine_cfg.num_pages)
        # Batch ladder state: the rung of the latest decode call, the
        # highest reached, and calls that changed rung.
        self.decode_rung = self.ladder[0]
        self.rung_peak = self.ladder[0]
        self.rung_switches_total = 0
        self.rung_calls: Dict[int, int] = {}   # decode calls per rung
        # Step-ledger scratch (telemetry.StepLedger): rungs and prefill
        # buckets dispatched before (compile_event marks the first
        # dispatch of each), the staging and bubble walls the next push
        # takes, and the swap-byte watermark that turns the cumulative
        # swap counters into per-record deltas.
        self._rungs_seen: set = set()
        self._prefill_buckets_seen: set = set()
        self._pending_bubble = 0.0
        self._last_staging_s = 0.0
        self._last_swap_bytes_total = 0.0
        self._last_compile_event = False
        self._last_verify_dt = 0.0
        self._last_verify_kv_read = 0
        self.admission = engine_cfg.admission
        self.preemptions_total = 0        # sequences evicted for pressure
        self.resumes_total = 0            # recompute-resume prefills
        self.swap_in_resumes = 0          # resumes that restored KV pages
        # Drain-time KV migration (the process fleet): pages and bytes
        # exported to, and adopted from, sibling replicas.
        self.migrate_out_pages = 0
        self.migrate_out_bytes = 0
        self.migrate_in_pages = 0
        self.migrate_in_bytes = 0
        # Corrupt KV blobs this replica rejected at import (counted,
        # never adopted; the request recomputes).
        self.kv_integrity_rejections = 0
        # P/D: the phase role (specializes warmup), live handoffs
        # exported and adopted, and received handoffs that fell back to
        # recompute-resume (a malformed blob, a pool shortfall).
        self.role = engine_cfg.role
        self.handoffs_out = 0
        self.adoptions_in = 0
        self.adopt_fallbacks = 0
        # Migration imports queued by another thread, applied by the
        # engine loop before admission: (entries, done event).
        self._pending_imports: List[tuple] = []
        self._pending_imports_lock = threading.Lock()
        self.hybrid_steps_total = 0       # fused prefill+decode calls
        self._admit_counter = 0
        # Sequences preempted since the caller last collected them.
        self._preempted_out: List[Sequence] = []
        self.telemetry = telemetry.EngineTelemetry(self)
        # perf_counter at the end of the last decode call; None when the
        # decode streak broke (idle or an interleaved prefill).
        self._last_decode_end: Optional[float] = None
        # Fault injection, copied out of the frozen config so the
        # /debug/chaos handler can arm and disarm it at run time.
        self.chaos_step_failure_rate = engine_cfg.chaos_step_failure_rate
        self.chaos_step_wedge_s = engine_cfg.chaos_step_wedge_s
        # chaos_page_pressure holds real pages out of the pool. Another
        # thread only stores a target (_pressure_target, a plain store);
        # the engine thread applies it (the allocator is engine-thread
        # only).
        self._pressure_pages: List[int] = []
        self.chaos_page_pressure = 0
        self._pressure_target: Optional[int] = None
        if engine_cfg.chaos_page_pressure > 0:
            self.set_page_pressure(engine_cfg.chaos_page_pressure)
        # The window only binds when the serving context can exceed it.
        swa_binds = bool(model_cfg.sliding_window) and (
            engine_cfg.max_context > model_cfg.sliding_window)
        self.prefix_cache: Optional[PrefixCache] = None
        self.host_pool: Optional[kvc.HostPagePool] = None
        if engine_cfg.enable_prefix_cache and not swa_binds:
            # SWA models run without the prefix cache (as the reference):
            # behind-window pages are evicted while a sequence runs.
            # Cached pages hold valid rows in both pools under draft
            # speculation (the draft pool is the target's positional
            # twin), but the host tier copies the target pool only, so
            # it stays off there.
            if engine_cfg.host_cache_pages > 0 and not spec_draft:
                self.host_pool = kvc.HostPagePool(
                    engine_cfg.host_cache_pages)
                self.telemetry.bind_host_pool(self.host_pool)
            elif engine_cfg.host_cache_pages > 0:
                print(f"[engine] {model_cfg.name}: host KV tier disabled "
                      "- speculative decoding's draft pool has no host "
                      "twin to restore")
            self.prefix_cache = PrefixCache(self.allocator,
                                            engine_cfg.page_size,
                                            host_pool=self.host_pool,
                                            offload_fn=self._offload_pages)
            self.prefix_cache.bind_telemetry(self.telemetry)
        # Behind-window eviction is off under draft speculation: the
        # window-less draft attends the full context. (n-gram verify
        # queries sit at or after plain decode's positions, so eviction
        # composes.)
        self.swa_evict = (swa_binds and self.prefix_cache is None
                          and not spec_draft)
        if swa_binds and spec_draft:
            print(f"[engine] {model_cfg.name}: SWA + speculative decoding"
                  " - behind-window eviction off (the window-less draft"
                  " attends the full context)")
        self.max_pages = engine_cfg.max_pages_per_seq
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.slots: List[Optional[Sequence]] = [None] * engine_cfg.max_batch_size
        self._prefill_batch_sizes = sorted(
            {1, max(1, engine_cfg.max_prefill_batch)})
        # Host staging reuse: per-rung persistent arrays refreshed row by
        # row; every call hands the card its own copy.
        self._stage_reuse = engine_cfg.stage_host_reuse
        self._stage_bufs: Dict[int, dict] = {}
        # Dispatch-ahead decode pipeline: calls queued on the stream,
        # oldest first (decode_steps_pipelined).
        self._inflight: List[dict] = []
        # Speculative decoding counters: positions proposed and accepted;
        # n-gram verify rounds, rounds that ran the plain call (no lane
        # proposed) and lanes throttled to γ=0.
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rounds_total = 0
        self.spec_fallback_rounds = 0
        self.spec_throttles_total = 0
        if self.spec_enabled:
            self.telemetry.bind_spec(self)
        if self.spec_ngram:
            # Verify widths: the full γ+1 round and a narrow 2-wide probe
            # round, so a throttled lane re-checks its echo at near-plain
            # cost. Every (rung, width) is warmed.
            gamma = engine_cfg.num_speculative_tokens
            self._spec_widths = sorted({2, gamma + 1})
        if spec_draft:
            if draft_cfg.vocab_size != model_cfg.vocab_size:
                raise ValueError("draft and target must share a "
                                 "tokenizer/vocab")
            draft_cfg.validate()
            self.draft_cfg = draft_cfg
            self.draft_mod = get_model_fns(draft_cfg)
            if draft_params is None:
                draft_params, _ = build_model(draft_cfg, seed=seed + 1,
                                              device=self.device,
                                              quant=engine_cfg.quant)
            self.draft_params = quantize_params(draft_params,
                                                engine_cfg.quant)
            self.draft_kv = kvc.alloc_kv_pages(draft_cfg, engine_cfg,
                                               device=self.device)

    # ------------------------------------------------------------------
    # Host <-> device transfers
    # ------------------------------------------------------------------

    def _to_device(self, arr) -> torch.Tensor:
        """A device copy of a host array (a device tensor passes as is).
        On the card the copy goes through pinned memory without blocking:
        the host never waits for the calls already queued, and the
        snapshot it copies from is its own, so the staging arrays may
        change at once."""
        if isinstance(arr, torch.Tensor):
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.clone()
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host_async(self, *tensors):
        """Host copies of device tensors (None passes) and the event the
        host waits on before reading them: pinned memory and
        non-blocking copies on the card, plain copies on the CPU."""
        if self.device.type != "cuda":
            return [None if t is None else t.clone() for t in tensors], None
        out = []
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return out, event

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------

    def _sampling(self, st: dict) -> SamplingParams:
        return SamplingParams(temperature=self._to_device(st["temps"]),
                              top_p=self._to_device(st["top_ps"]),
                              top_k=self._to_device(st["top_ks"]),
                              seed=np.asarray(st["seeds"]))

    @torch.no_grad()
    def _prefill_fn(self, st: dict) -> torch.Tensor:
        """Lanes ``st["tokens"]`` [P, S_bucket] right-padded; lane i's new
        tokens occupy positions [prefix_len[i], prefix_len[i] +
        prompt_len[i]). Returns the sampled first tokens [P] int32 on
        the device."""
        cfg, dev = self.model_cfg, self.device
        hidden, self.kv = self._chunk_forward(st, cfg, self.mod, self.params,
                                              self.kv)
        plen = self._to_device(st["prompt_len"])
        lanes = torch.arange(hidden.shape[0], device=dev)
        last = hidden[lanes, (plen - 1).long()]                 # [P, D]
        logits = self.mod.unembed(self.params, cfg, last)       # [P, V]
        use_pen = bool(np.any(np.asarray(st["rpens"]) != 1.0))
        return sample(logits, self._sampling(st), self._generator,
                      ctx=st["prefix_len"] + st["prompt_len"],
                      all_greedy=bool(np.all(np.asarray(st["temps"]) <= 0.0)),
                      penalty_window=self._to_device(st["windows"])
                      if use_pen else None,
                      repeat_penalty=self._to_device(st["rpens"]),
                      repeat_last_n=self._to_device(st["rlasts"]))

    def _chunk_forward(self, st: dict, cfg: ModelConfig, mod, params, kv):
        """The forward of the prefill lanes ``st`` through one model
        (the target's, or the draft's into its own pool); returns
        (hidden [P, S, D], kv)."""
        ecfg, dev = self.engine_cfg, self.device
        toks = self._to_device(st["tokens"])
        plen = self._to_device(st["prompt_len"])
        pref = self._to_device(st["prefix_len"])
        bts = self._to_device(st["bts"])
        s = st["tokens"].shape[1]
        ar = torch.arange(s, device=dev, dtype=torch.int32)[None, :]
        positions = (pref[:, None] + ar).clamp(max=ecfg.max_context - 1)
        attn = make_paged_attn(cfg, ecfg.page_size, bts, positions,
                               ar < plen[:, None], q_offset=pref,
                               kv_len=pref + plen,
                               attn_backend=self.attn_backend)
        return mod.forward_hidden(params, cfg, toks, positions, kv, attn)

    @torch.no_grad()
    def _draft_prefill_fn(self, st: dict) -> None:
        """Write the prompt chunk's KV into the draft model's pool (no
        sampling): the lanes and pages of ``_prefill_fn``."""
        _, self.draft_kv = self._chunk_forward(
            st, self.draft_cfg, self.draft_mod, self.draft_params,
            self.draft_kv)

    @torch.no_grad()
    def _spec_round_fn(self, st: dict, cap, active):
        """One draft-model round over staged arrays ``st`` (tokens, ctx,
        bts and the sampling rows); returns (emitted, n_accepted) on the
        device."""
        temps = np.asarray(st["temps"])
        out = spec_round(
            self, self.params, self.draft_params, self.kv, self.draft_kv,
            self._to_device(st["tokens"]), self._to_device(st["ctx"]),
            self._to_device(st["bts"]), self._to_device(cap),
            self._to_device(active), self._generator,
            self._to_device(temps), self._to_device(st["top_ps"]),
            self._to_device(st["top_ks"]),
            all_greedy=bool(np.all(temps <= 0.0)))
        self.kv, self.draft_kv = out.kv, out.draft_kv
        return out.emitted, out.n_accepted

    @torch.no_grad()
    def _verify_fn(self, st: dict, cap, active, drafts, n_prop):
        """One n-gram verify round over staged arrays ``st``; returns
        (emitted, n_accepted) on the device."""
        temps = np.asarray(st["temps"])
        use_pen = bool(np.any(np.asarray(st["rpens"]) != 1.0))
        out = verify_round(
            self, self.params, self.kv, self._to_device(st["tokens"]),
            self._to_device(st["ctx"]), self._to_device(st["bts"]),
            self._to_device(cap), self._to_device(active),
            self._to_device(drafts), self._to_device(n_prop),
            self._generator, self._to_device(temps),
            self._to_device(st["top_ps"]), self._to_device(st["top_ks"]),
            self._to_device(st["rpens"]), self._to_device(st["rlasts"]),
            self._to_device(st["windows"]) if use_pen else None,
            all_greedy=bool(np.all(temps <= 0.0)))
        self.kv = out.kv
        return out.emitted, out.n_accepted

    @torch.no_grad()
    def _decode_multi_fn(self, st: dict, k_steps: int):
        """K decode steps under one call, tokens fed back on the device.

        ``st``: [B] arrays ``tokens, ctx, bts ([B, MP]), allowed, eos,
        temps, top_ps, top_ks, seeds, rpens, rlasts, windows ([B, W])``;
        ``tokens`` and ``windows`` may be device tensors (an in-flight
        call's carry). ``allowed`` is the steps each slot may advance
        (budget, context cap and page headroom folded in). Returns
        (outs [K, B] int32 with -1 where a slot produced nothing, final
        carry tokens [B], final penalty window [B, W] or None when no
        lane has a penalty), all on the device."""
        cfg, ecfg = self.model_cfg, self.engine_cfg
        tok = self._to_device(st["tokens"])
        ctx = self._to_device(st["ctx"])
        bts = self._to_device(st["bts"])
        allow = self._to_device(st["allowed"])
        eos = self._to_device(st["eos"])
        sp = self._sampling(st)
        all_greedy = bool(np.all(np.asarray(st["temps"]) <= 0.0))
        use_pen = bool(np.any(np.asarray(st["rpens"]) != 1.0))
        win = self._to_device(st["windows"]) if use_pen else None
        rpen, rlast = self._to_device(st["rpens"]), self._to_device(
            st["rlasts"])
        ctx_host = np.asarray(st["ctx"])
        alive = torch.ones(tok.shape, dtype=torch.bool, device=self.device)
        outs = []
        for s in range(k_steps):
            act = alive & (allow > s)
            positions = ctx.clamp(max=ecfg.max_context - 1)[:, None]
            attn = make_paged_attn(cfg, ecfg.page_size, bts, positions,
                                   act[:, None], q_offset=ctx,
                                   kv_len=ctx + 1,
                                   attn_backend=self.attn_backend)
            hidden, self.kv = self.mod.forward_hidden(
                self.params, cfg, tok[:, None], positions, self.kv, attn)
            logits = self.mod.unembed(self.params, cfg, hidden[:, 0])
            # The sampled token sits at absolute index ctx + 1: for an
            # active lane that is ctx_lens + s + 1, known on the host.
            new = sample(logits, sp, self._generator,
                         ctx=ctx_host + s + 1,
                         all_greedy=all_greedy, penalty_window=win,
                         repeat_penalty=rpen, repeat_last_n=rlast)
            new = torch.where(act, new, tok)
            if use_pen:
                win = roll_window(win, new, act)
            outs.append(torch.where(act, new, torch.full_like(new, -1)))
            alive = alive & ((new != eos) | ~act)
            ctx = ctx + act.int()
            tok = new
        return torch.stack(outs), tok, win

    def _hybrid_step_fn(self, chunk: dict, st: dict, k_steps: int):
        """One hybrid step: a [1, S_bucket] prefill chunk (the prefill
        kernel) AND the [B] K-step decode (the decode kernel) in one
        call. The halves touch disjoint pages (the chunk writes and reads
        its own sequence's pages, each lane its own), so this computes
        what the two serial calls compute. Returns (chunk's sampled
        token [1], then _decode_multi_fn's outputs)."""
        p_tok = self._prefill_fn(chunk)
        return (p_tok,) + self._decode_multi_fn(st, k_steps)

    def _decode_warm_arrays(self, b: int) -> dict:
        """Decode operands at rung ``b`` whose lanes all sit still
        (allowed 0: every write lands on the trash page)."""
        zb = np.zeros((b,), np.int32)
        return {"tokens": zb, "ctx": zb,
                "bts": np.zeros((b, self.max_pages), np.int32),
                "allowed": zb, "eos": np.full((b,), -1, np.int32),
                **self._lane_arrays([], b)}

    def _spec_warm_arrays(self, b: int, width: int) -> tuple:
        """Spec-round operands at rung ``b`` whose lanes are all inactive
        (every write lands on the trash page): (st, cap, active, drafts,
        n_prop) with ``width - 1`` proposal columns."""
        zb = np.zeros((b,), np.int32)
        return (self._decode_warm_arrays(b), zb, np.zeros((b,), bool),
                np.zeros((b, width - 1), np.int32), zb)

    def warmup(self) -> float:
        """Build and load the kernels (CUDA, kernel backend), then run
        every shape serving meets: the prefill at every bucket and lane
        count (and the draft model's prefill), the decode call (K steps
        and the one-step route) at every ladder rung, the n-gram verify
        round at every (rung, width) or the draft-model round at the top
        rung, and with hybrid steps the hybrid call at every reachable
        bucket and rung. All writes land on the trash page. A
        prefill-role engine warms only the prefills, a decode-role engine
        only the decode calls and verify rounds (the other phase still
        runs if a degraded fleet routes it there). Returns seconds
        spent."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self.attn_backend == "kernel":
            from tpu_inference_torch.kernels import build_kernels
            build_kernels()
        ecfg = self.engine_cfg
        warm_prefill = self.role != "decode"
        warm_decode = self.role != "prefill"

        def chunk_arrays(p: int, bucket: int) -> dict:
            return {"tokens": np.zeros((p, bucket), np.int32),
                    "prompt_len": np.ones((p,), np.int32),
                    "prefix_len": np.zeros((p,), np.int32),
                    "bts": np.zeros((p, self.max_pages), np.int32),
                    **self._lane_arrays([], p)}

        buckets = [b for b in ecfg.prefill_buckets if b <= ecfg.max_context]
        for p in (self._prefill_batch_sizes if warm_prefill else ()):
            for bucket in buckets:
                self._prefill_fn(chunk_arrays(p, bucket))
                if self.spec_draft:
                    self._draft_prefill_fn(chunk_arrays(p, bucket))
        k = max(1, ecfg.decode_steps_per_call)
        if warm_decode and self.spec_draft:
            # Every decode call of this mode is a spec round (top rung).
            st, cap, act, _, _ = self._spec_warm_arrays(
                ecfg.max_batch_size, 1)
            self._spec_round_fn(st, cap, act)
        elif warm_decode:
            for b in self.ladder:
                for steps in sorted({1, k}):
                    self._decode_multi_fn(self._decode_warm_arrays(b),
                                          steps)
        if self.spec_ngram and warm_decode:
            # Fallback rounds run the decode calls warmed above.
            for b in self.ladder:
                for width in self._spec_widths:
                    self._verify_fn(*self._spec_warm_arrays(b, width))
        if (ecfg.hybrid_prefill and not self.spec_enabled and warm_prefill
                and warm_decode):
            cap = ecfg.bucket_for(min(ecfg.chunk_tokens_cap,
                                      ecfg.max_context))
            for bucket in (b for b in buckets if b <= cap):
                for b in self.ladder:
                    self._hybrid_step_fn(chunk_arrays(1, bucket),
                                         self._decode_warm_arrays(b), k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def embed(self, token_ids: List[int]) -> np.ndarray:
        """Mean-pooled final hidden state of one token sequence (the
        /api/embeddings backing); see embed_many."""
        return self.embed_many([token_ids])[0]

    # Rows per embedding forward; lane counts pad to powers of two, so an
    # /api/embed list never builds an unbounded [N, S] forward.
    EMBED_CHUNK = 16

    @torch.no_grad()     # grad mode is per thread: HTTP threads call this
    def embed_many(self, batch: List[List[int]]) -> np.ndarray:
        """Mean-pooled final hidden states of N token sequences: dense,
        cache-free [n, S] forwards of at most EMBED_CHUNK rows (n padded
        to a power of two, S the bucket of the chunk's longest row), each
        row pooled under its length mask (padding sits causally after
        the valid tokens). Rows keep their last min(max_context - 1,
        largest bucket) ids; an empty row embeds [0]. The pad rows go
        through the forward too, so Mixtral's expert capacity sees the
        reference's shape. Returns [N, d_model] float32."""
        ecfg, cfg, dev = self.engine_cfg, self.model_cfg, self.device
        if not batch:
            return np.zeros((0, cfg.d_model), np.float32)
        cap = min(ecfg.max_context - 1, ecfg.prefill_buckets[-1])
        rows = [list(ids)[-cap:] or [0] for ids in batch]
        out = []
        for at in range(0, len(rows), self.EMBED_CHUNK):
            chunk = rows[at:at + self.EMBED_CHUNK]
            bucket = ecfg.bucket_for(max(len(r) for r in chunk))
            n = 1 << (len(chunk) - 1).bit_length()     # pad lanes to 2^k
            toks = np.zeros((n, bucket), np.int32)
            lengths = np.zeros((n,), np.int32)
            for i, r in enumerate(chunk):
                toks[i, :len(r)] = r
                lengths[i] = len(r)
            lengths_d = self._to_device(lengths)
            ar = torch.arange(bucket, dtype=torch.int32, device=dev)
            pos = ar[None].expand(n, bucket).contiguous()
            hidden, _ = self.mod.forward_hidden(
                self.params, cfg, self._to_device(toks), pos, None,
                make_dense_attn(cfg.sliding_window))
            mask = (ar[None, :] < lengths_d[:, None])[..., None]
            pooled = ((hidden * mask).sum(dim=1)
                      / lengths_d.clamp(min=1)[:, None])
            out.append(pooled.float().cpu().numpy()[:len(chunk)])
        return np.concatenate(out, axis=0)

    @torch.no_grad()
    def check_numerics(self) -> None:
        """Numerics check for a freshly loaded model (``--check-numerics``).

        Raises FloatingPointError naming every non-finite parameter leaf;
        then runs one dense forward over [1, 8] zero tokens and raises
        naming the first layer whose output is non-finite (the check
        after each layer is the counterpart of the reference's checkify'd
        forward), or the logits."""
        bad = [path for path, t in _named_leaves(self.params)
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        if bad:
            raise FloatingPointError(f"non-finite values in params at {bad}")
        cfg = self.model_cfg

        def check_layer(i: int, x: torch.Tensor) -> None:
            if not bool(torch.isfinite(x).all()):
                raise FloatingPointError(
                    f"{cfg.name}: non-finite output at layer {i} of the "
                    "numerics-check forward")

        toks = torch.zeros((1, 8), dtype=torch.int32, device=self.device)
        pos = torch.arange(8, dtype=torch.int32, device=self.device)[None]
        hidden, _ = self.mod.forward_hidden(
            self.params, cfg, toks, pos, None,
            make_dense_attn(cfg.sliding_window), on_layer=check_layer)
        if not bool(torch.isfinite(self.mod.unembed(self.params, cfg,
                                                    hidden)).all()):
            raise FloatingPointError(f"{cfg.name}: non-finite logits in the "
                                     "numerics-check forward")

    # ------------------------------------------------------------------
    # Host-side orchestration
    # ------------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _prefill_tokens(self, seq: Sequence) -> List[int]:
        """Token stream the next (re)prefill puts into KV: the prompt,
        plus on a recompute-resume every token generated before the
        preemption."""
        if seq.resume_base:
            return seq.prompt_tokens + seq.generated[:seq.resume_base]
        return seq.prompt_tokens

    def _pages_reserved(self, seq: Sequence) -> int:
        """Worst-case page need (capped at the per-sequence maximum).
        With behind-window eviction, live pages peak at the prompt plus
        the dispatch-ahead burst, then hold the window's span."""
        ecfg = self.engine_cfg
        base = self._prefill_tokens(seq)
        total = len(base) + seq.max_new_tokens - seq.resume_base
        need = kvc.pages_needed(total, ecfg.page_size)
        if self.swa_evict:
            ahead = (ecfg.decode_steps_per_call
                     * max(1, ecfg.decode_pipeline_depth))
            window_span = -(-(self.model_cfg.sliding_window + ahead)
                            // ecfg.page_size) + 2
            peak = min(len(base), ecfg.max_context)
            transient = kvc.pages_needed(
                min(peak + ahead, ecfg.max_context), ecfg.page_size)
            need = min(need, max(window_span, transient))
        return min(need, self.max_pages)

    def _pages_for_admission(self, seq: Sequence) -> int:
        """Pages a request is charged at admission: the worst case under
        "reserve" (and once past the starvation guard), the prompt plus
        ``optimistic_headroom_pages`` under "optimistic"."""
        full = self._pages_reserved(seq)
        if (self.admission != "optimistic"
                or seq.preemptions >= self.engine_cfg.preempt_max_per_request):
            return full
        ecfg = self.engine_cfg
        prompt_pages = kvc.pages_needed(
            min(len(self._prefill_tokens(seq)), ecfg.max_context),
            ecfg.page_size)
        need = max(1, prompt_pages + ecfg.optimistic_headroom_pages)
        return min(full, need, self.max_pages)

    def _free_plus_evictable(self) -> int:
        n = self.allocator.num_free
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable
        return n

    def peek_prefix_pages(self, tokens: Sequence[int]) -> Tuple[int, int]:
        """(hit_pages, prompt_pages): full pages of ``tokens`` the prefix
        cache holds (either tier) and pages the prompt needs, under the
        prefill's truncation and final-token recompute. No side
        effects."""
        ecfg = self.engine_cfg
        prompt_len = min(len(tokens), ecfg.max_context - 1)
        prompt_pages = kvc.pages_needed(prompt_len, ecfg.page_size)
        if self.prefix_cache is None or prompt_len <= 1:
            return 0, prompt_pages
        prompt = (tokens[-prompt_len:] if len(tokens) > prompt_len
                  else tokens)
        return (self.prefix_cache.peek(prompt, max_tokens=prompt_len - 1),
                prompt_pages)

    @property
    def pool_pressure(self) -> float:
        """1 - (free+evictable)/total: 0 = fully reclaimable."""
        total = self.engine_cfg.num_pages - 1
        return 1.0 - self._free_plus_evictable() / max(total, 1)

    @property
    def under_pressure(self) -> bool:
        """Below the preemption low watermark."""
        return (self._free_plus_evictable()
                < self.engine_cfg.preempt_watermark_pages)

    def _allocate_reclaiming(self, n: int) -> List[int]:
        """Allocate n pages, evicting LRU prefix-cache pages on pressure
        (demoting them to the host tier when there is one, at least a
        swap batch at a time, at most the tier's capacity)."""
        short = n - self.allocator.num_free
        if short > 0 and self.prefix_cache is not None:
            if self.host_pool is not None:
                short = max(short, min(kvc.SWAP_CHUNK,
                                       self.host_pool.capacity))
            self.prefix_cache.evict(short)
        return self.allocator.allocate(n)

    # ------------------------------------------------------------------
    # Host KV tier: device <-> host page swaps
    # ------------------------------------------------------------------

    def _offload_pages(self, pages: List[int]) -> List[kvc.HostKVPage]:
        """The prefix cache's demote copy, with swap telemetry."""
        t0 = time.perf_counter()
        out = kvc.offload_pages(self.kv, pages)
        t1 = time.perf_counter()
        if out:
            if self.host_pool is not None:
                self.host_pool.note_swap_wall("out", t1 - t0)
            tel = self.telemetry
            tel.kv_swap_s.observe(t1 - t0)
            tel.kv_offload_pages.inc(len(out))
            nbytes = sum(hp.nbytes for hp in out)
            tel.kv_offload_bytes.inc(nbytes)
            # An eviction batch mixes victims: no request owns the span.
            tel.recorder.add_maintenance("kv_swap_out", t0, t1,
                                         pages=len(out), bytes=nbytes)
        return out

    def _restore_batch(self, fresh: List[int],
                       entries: List[kvc.HostKVPage],
                       trace_id: str = "") -> None:
        """Scatter host copies into freshly allocated pages (queued on
        the stream, the following prefill runs behind it). The swap-in
        span goes to ``trace_id``'s trace, or to the maintenance lane
        when it is empty."""
        t0 = time.perf_counter()
        self.kv = kvc.restore_pages(self.kv, fresh, entries)
        t1 = time.perf_counter()
        if self.host_pool is not None:
            self.host_pool.note_swap_wall("in", t1 - t0)
        tel = self.telemetry
        tel.kv_swap_s.observe(t1 - t0)
        tel.kv_restore_pages.inc(len(fresh))
        nbytes = sum(e.nbytes for e in entries)
        tel.kv_restore_bytes.inc(nbytes)
        if trace_id:
            tel.recorder.add("kv_swap_in", trace_id, t0, t1,
                             pages=len(fresh), bytes=nbytes)
        else:
            tel.recorder.add_maintenance("kv_swap_in", t0, t1,
                                         pages=len(fresh), bytes=nbytes)

    def _restore_host_entries(self, pages: List[Optional[int]],
                              host_entries,
                              trace_id: str = "") -> List[int]:
        """Fill the host-tier slots of a tiered lookup: allocate fresh
        pages, swap the copies in, publish them back in the device tier.
        On allocation failure every reference the lookup took is undone
        and the MemoryError propagates."""
        if not host_entries:
            return list(pages)
        try:
            fresh = self._allocate_reclaiming(len(host_entries))
        except MemoryError:
            self.allocator.free([p for p in pages if p is not None])
            self.prefix_cache.readmit_host(
                [(d, e) for _, d, e in host_entries])
            raise
        self._restore_batch(fresh, [e for _, _, e in host_entries],
                            trace_id=trace_id)
        out = list(pages)
        for (i, digest, _), page in zip(host_entries, fresh):
            out[i] = page
            self.prefix_cache.promote(digest, page)
        return out

    def _seq_digests(self, seq: Sequence, prompt: List[int]) -> List[bytes]:
        """Chain digests of the prefill stream ``prompt``, computed once
        per request (resume streams hash into their own slot, valid until
        the next preemption)."""
        if seq.resume_base:
            if seq.resume_digests is None:
                seq.resume_digests = _chain_hashes(
                    prompt, self.engine_cfg.page_size)
            return seq.resume_digests
        if seq.prefix_digests is None:
            seq.prefix_digests = _chain_hashes(prompt,
                                               self.engine_cfg.page_size)
        return seq.prefix_digests

    def prefetch_host_hits(self, seq: Sequence) -> int:
        """Queue-wait swap-in: restore a WAITING request's host-tier pages
        into cache-owned device pages, so its admission sees device hits.
        Uses only free pages (never evicts), keeps the front of the run
        when the free list is short (the request stays eligible for
        another pass). Returns pages promoted."""
        if (self.prefix_cache is None or self.host_pool is None
                or seq.host_prefetched or seq.done):
            return 0
        free = self.allocator.num_free
        if free <= 0:
            return 0
        ecfg = self.engine_cfg
        prompt = self._prefill_tokens(seq)[-(ecfg.max_context - 1):]
        if len(prompt) <= 1:
            seq.host_prefetched = True
            return 0
        digests = self._seq_digests(seq, prompt)
        limit = (len(prompt) - 1) // ecfg.page_size
        taken = self.prefix_cache.take_host_matches(digests, limit)
        if not taken:
            seq.host_prefetched = True
            return 0
        complete = len(taken) <= free
        if not complete:
            self.prefix_cache.readmit_host(taken[free:])
            taken = taken[:free]
        fresh = self.allocator.allocate(len(taken))
        self._restore_batch(fresh, [e for _, e in taken],
                            trace_id=seq.trace_id or str(seq.request_id))
        for (digest, _), page in zip(taken, fresh):
            self.prefix_cache.adopt(digest, page)
        if complete:
            seq.host_prefetched = True
        return len(taken)

    # ------------------------------------------------------------------

    def _grant_decode_steps(self, seq: Sequence, k_steps: int,
                            pred_ctx: Optional[int] = None,
                            pred_done: Optional[int] = None) -> int:
        """Steps this lane may advance in one call (generation budget,
        context cap, KV-page headroom); allocates the pages it needs.
        ``pred_*`` stand for ctx/generated while dispatch-ahead calls are
        in flight."""
        ecfg = self.engine_cfg
        ctx = seq.ctx_len if pred_ctx is None else pred_ctx
        done = len(seq.generated) if pred_done is None else pred_done
        budget = seq.max_new_tokens - done
        room = ecfg.max_context - 1 - ctx
        steps = max(0, min(k_steps, budget, room))
        if steps > 0:
            need = kvc.pages_needed(steps, ecfg.page_size, already=ctx)
            grantable = self._free_plus_evictable()
            if need > grantable:
                slack = len(seq.pages) * ecfg.page_size - ctx
                steps = min(steps, slack + grantable * ecfg.page_size)
                need = (kvc.pages_needed(steps, ecfg.page_size, already=ctx)
                        if steps > 0 else 0)
            if need > 0:
                seq.pages.extend(self._allocate_reclaiming(need))
        return steps

    def _fold_lane(self, seq: Sequence, toks) -> List[int]:
        """Fold device-produced tokens (-1 = none) into host state."""
        got: List[int] = []
        for tok in toks:
            if seq.done or tok < 0:
                break
            seq.ctx_len += 1
            seq.generated.append(tok)
            if seq.first_token_time == 0.0:
                seq.first_token_time = time.perf_counter()
            self._maybe_finish(seq, tok)
            got.append(tok)
        return got

    def can_admit(self, seq: Sequence) -> bool:
        return bool(self.free_slots()) and (
            self._free_plus_evictable() >= self._pages_for_admission(seq))

    def can_ever_admit(self, seq: Sequence) -> bool:
        """False if the request exceeds the pool even when fully idle."""
        return self._pages_reserved(seq) <= self.engine_cfg.num_pages - 1

    def _block_table_array(self, pages: List[int]) -> np.ndarray:
        bt = np.zeros((self.max_pages,), np.int32)
        bt[:len(pages)] = pages
        return bt

    def _prefill_setup(self, seq: Sequence, slot: int) -> List[int]:
        """Allocate pages (reusing prefix-cache hits from either tier),
        bind the slot, and return the (possibly truncated) prompt to
        prefill; on a resume the prompt is prompt + generated."""
        ecfg = self.engine_cfg
        # Keep the most recent tokens of over-long prompts (room for at
        # least one generated token).
        prompt = self._prefill_tokens(seq)[-(ecfg.max_context - 1):]
        seq.admit_idx = self._admit_counter
        self._admit_counter += 1
        if seq.resume_base:
            self.resumes_total += 1
        shared: List[int] = []
        n_restored = 0
        if self.prefix_cache is not None:
            # Always recompute the final prompt token: its logits seed
            # the first sampled token.
            pages, host_entries, seq.cached_tokens = self.prefix_cache.lookup(
                prompt, max_tokens=len(prompt) - 1,
                digests=self._seq_digests(seq, prompt))
            shared = self._restore_host_entries(
                pages, host_entries,
                trace_id=seq.trace_id or str(seq.request_id))
            n_restored = len(host_entries)
        n_new = kvc.pages_needed(len(prompt), ecfg.page_size) - len(shared)
        try:
            seq.pages = shared + self._allocate_reclaiming(n_new)
        except MemoryError:
            self.allocator.free(shared)
            raise
        seq.pages_version += 1
        seq.host_restored_pages += n_restored
        if seq.resume_base and seq.cached_tokens:
            self.swap_in_resumes += 1
        seq.slot = slot
        seq.prefill_start = time.perf_counter()
        return prompt

    def _prefill_finish(self, seq: Sequence, prompt: List[int],
                        first: int) -> None:
        seq.ctx_len = len(prompt)
        seq.generated.append(first)
        if seq.first_token_time == 0.0:
            # A resume keeps the original first-token time.
            seq.first_token_time = time.perf_counter()
        self.slots[seq.slot] = seq
        self._maybe_finish(seq, first)

    def _sampling_arrays(self, seq: Sequence) -> Tuple[int, int]:
        """(top_k, seed) with engine defaults; negative seeds mean none."""
        top_k = self.engine_cfg.top_k if seq.top_k is None else seq.top_k
        top_k = max(0, min(int(top_k), 2**31 - 1))
        seed = -1 if seq.seed is None or seq.seed < 0 else (
            int(seq.seed) & 0x7FFFFFFF)
        return top_k, seed

    def _penalty_arrays(self, seq: Sequence) -> Tuple[float, int]:
        """(repeat_penalty, repeat_last_n): last_n < 0 = whole context,
        clamped to the static window; 0 disables. Under draft-model
        speculation the penalty is off entirely, prefill included (the
        q/p acceptance ratio needs both distributions unmodified); n-gram
        speculation composes (verify_round penalizes each position)."""
        if self.spec_draft:
            return 1.0, 0
        rlast = int(seq.repeat_last_n)
        if rlast < 0:
            rlast = PENALTY_WINDOW
        return float(seq.repeat_penalty), min(rlast, PENALTY_WINDOW)

    @staticmethod
    def _penalty_window_row(seq: Sequence) -> np.ndarray:
        """Last W known tokens, newest at the high end, -1 padded."""
        row = np.full((PENALTY_WINDOW,), -1, np.int64)
        hist = (seq.prompt_tokens + seq.generated)[-PENALTY_WINDOW:]
        if hist:
            row[-len(hist):] = hist
        return row

    def _lane_arrays(self, lanes: List[Tuple[int, Sequence]], n: int
                     ) -> Dict[str, np.ndarray]:
        """Per-lane sampling/penalty arrays for ``n`` lanes; unlisted lanes
        keep greedy, unseeded, penalty-off defaults."""
        a = {"temps": np.zeros((n,), np.float32),
             "top_ps": np.ones((n,), np.float32),
             "top_ks": np.zeros((n,), np.int64),
             "seeds": np.full((n,), -1, np.int64),
             "rpens": np.ones((n,), np.float32),
             "rlasts": np.zeros((n,), np.int64),
             "windows": np.full((n, PENALTY_WINDOW), -1, np.int64)}
        for i, seq in lanes:
            a["temps"][i] = seq.temperature
            a["top_ps"][i] = seq.top_p
            a["top_ks"][i], a["seeds"][i] = self._sampling_arrays(seq)
            a["rpens"][i], a["rlasts"][i] = self._penalty_arrays(seq)
            if a["rpens"][i] != 1.0:
                a["windows"][i] = self._penalty_window_row(seq)
        return a

    def _run_prefill(self, st: dict) -> Tuple[np.ndarray, float]:
        """One prefill call with telemetry; returns (the sampled tokens
        [P] on the host, the call's wall: it syncs)."""
        t0 = time.perf_counter()
        self._last_decode_end = None     # prefill breaks the decode streak
        out = self._prefill_fn(st)
        if self.spec_draft:
            # Mirror the chunk into the draft model's pool (same pages).
            self._draft_prefill_fn(st)
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        self.telemetry.prefill_dispatch_s.observe(dt)
        self.telemetry.prefill_dispatches.inc()
        return out, dt

    def _stage_chunk_arrays(self, seq: Sequence, prompt: List[int],
                            offset: int, chunk_cap: int) -> dict:
        """Host arrays of one prefill chunk at ``offset``: the one staging
        point of the serial chunk and the hybrid chunk, so the two modes
        cannot drift apart. Only the final chunk's sampled token is kept,
        so its penalty window is the prompt tail."""
        chunk = prompt[offset:offset + chunk_cap]
        bucket = self.engine_cfg.bucket_for(len(chunk))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(chunk)] = chunk
        return {"seq": seq, "prompt": prompt, "chunk_tokens": len(chunk),
                "bucket": bucket, "tokens": toks,
                "prompt_len": np.asarray([len(chunk)], np.int32),
                "prefix_len": np.asarray([offset], np.int32),
                "bts": self._block_table_array(seq.pages)[None],
                **self._lane_arrays([(0, seq)], 1)}

    def _prefill_one_chunk(self, seq: Sequence, prompt: List[int],
                           offset: int) -> Tuple[int, int]:
        """Run one prefill chunk at ``offset``; returns (next_offset,
        sampled token)."""
        st = self._stage_chunk_arrays(seq, prompt, offset,
                                      self.engine_cfg.chunk_tokens_cap)
        # Active decode lanes wait behind this serial chunk (the stall
        # hybrid steps remove); mid-prefill sequences are not active.
        stalled = bool(self.active_sequences())
        t0 = time.perf_counter()
        out, dt = self._run_prefill(st)      # syncs on the chunk's token
        if stalled:
            self.telemetry.decode_stall_during_prefill_s.observe(dt)
        if self.telemetry.enabled:
            seq.dispatch_wall_s += dt
            # A child of the request's prefill span: a long prompt's
            # chunk cadence on the trace.
            self.telemetry.recorder.add(
                "prefill_chunk", seq.trace_id or str(seq.request_id),
                t0, t0 + dt, parent="prefill",
                offset=int(offset), tokens=int(st["chunk_tokens"]))
            c = st["chunk_tokens"]
            self._ledger_push(
                "prefill_chunk", rung=0, slots=1,
                tokens=1 if offset + c >= len(prompt) else 0,
                chunk_tokens=c, device_s=dt,
                kv_read=_chunk_kv_read(c, offset),
                compile_event=st["bucket"]
                not in self._prefill_buckets_seen)
            self._prefill_buckets_seen.add(st["bucket"])
        return offset + st["chunk_tokens"], int(out[0])

    def _prefill_chunked(self, seq: Sequence, prompt: List[int]) -> None:
        """Serial one-lane prefill, chunked past the largest bucket; only
        the final chunk's sampled token is kept."""
        offset, tok = seq.cached_tokens, -1
        while offset < len(prompt):
            offset, tok = self._prefill_one_chunk(seq, prompt, offset)
        self._prefill_finish(seq, prompt, tok)

    def prefill_begin(self, seq: Sequence, slot: Optional[int] = None) -> int:
        """Set up an incremental prefill; drive it with prefill_step()
        (or hybrid_step_pipelined). The slot binds here, so admission
        between chunks cannot hand it out twice; active_sequences()
        skips mid-prefill slots."""
        if slot is None:
            slot = self.free_slots()[0]
        seq.prefill_prompt = self._prefill_setup(seq, slot)
        seq.prefill_offset = seq.cached_tokens
        self.slots[slot] = seq
        return slot

    def prefill_step(self, seq: Sequence) -> bool:
        """Run ONE chunk of an incremental prefill; True when complete."""
        prompt = seq.prefill_prompt
        if prompt is None:
            raise RuntimeError("prefill_step without prefill_begin")
        self._chaos_step_gate()
        seq.prefill_offset, tok = self._prefill_one_chunk(
            seq, prompt, seq.prefill_offset)
        if seq.prefill_offset < len(prompt):
            return False
        self._prefill_finish(seq, prompt, tok)
        seq.prefill_prompt = None
        return True

    def prefill(self, seq: Sequence, slot: Optional[int] = None) -> int:
        """Admit one sequence: pages, prefill (chunked when needed), first
        token. Returns the slot index."""
        if slot is None:
            slot = self.free_slots()[0]
        prompt = self._prefill_setup(seq, slot)
        self._prefill_chunked(seq, prompt)
        return slot

    def _prefill_run_batched(self, group: List[Tuple[Sequence, List[int]]],
                             bucket: int) -> None:
        """One multi-lane prefill call: P sequences, same bucket. Lanes
        pad to a batch size of the set; dummy lanes carry prompt_len=1
        and an all-zero block table, so their one write lands on the
        trash page and their token is discarded."""
        p = next(s for s in self._prefill_batch_sizes if s >= len(group))
        st = {"tokens": np.zeros((p, bucket), np.int32),
              "prompt_len": np.ones((p,), np.int32),
              "prefix_len": np.zeros((p,), np.int32),
              "bts": np.zeros((p, self.max_pages), np.int32),
              **self._lane_arrays([(i, s) for i, (s, _) in enumerate(group)],
                                  p)}
        for i, (seq, prompt) in enumerate(group):
            chunk = prompt[seq.cached_tokens:]
            st["tokens"][i, :len(chunk)] = chunk
            st["prompt_len"][i] = len(chunk)
            st["prefix_len"][i] = seq.cached_tokens
            st["bts"][i] = self._block_table_array(seq.pages)
        out, dt = self._run_prefill(st)
        if self.telemetry.enabled:
            for seq, _ in group:
                seq.dispatch_wall_s += dt
            n = len(group)
            plen, pref = st["prompt_len"][:n], st["prefix_len"][:n]
            self._ledger_push(
                "prefill_chunk", rung=0, slots=n, tokens=n,
                chunk_tokens=int(plen.sum()), device_s=dt,
                kv_read=int(_chunk_kv_read(plen, pref).sum()),
                compile_event=(bucket, p) not in self._prefill_buckets_seen)
            self._prefill_buckets_seen.add((bucket, p))
        for i, (seq, prompt) in enumerate(group):
            self._prefill_finish(seq, prompt, int(out[i]))

    def prefill_many(self, seqs: List[Sequence]) -> None:
        """Admit several sequences, batching same-bucket single-chunk
        prefills into one [P, S] call; multi-chunk prompts run the
        serial chunked path."""
        self._chaos_step_gate()
        ecfg = self.engine_cfg
        slots = self.free_slots()
        if len(slots) < len(seqs):
            raise RuntimeError(f"prefill_many: {len(seqs)} sequences but "
                               f"only {len(slots)} free slots")
        staged = [(seq, self._prefill_setup(seq, slot))
                  for seq, slot in zip(seqs, slots)]
        groups: Dict[int, List[Tuple[Sequence, List[int]]]] = {}
        for seq, prompt in staged:
            rest = len(prompt) - seq.cached_tokens
            if rest <= ecfg.chunk_tokens_cap:
                groups.setdefault(ecfg.bucket_for(rest), []).append(
                    (seq, prompt))
            else:
                self._prefill_chunked(seq, prompt)
        cap = self._prefill_batch_sizes[-1]
        for bucket, group in groups.items():
            for i in range(0, len(group), cap):
                self._prefill_run_batched(group[i:i + cap], bucket)

    def _chaos_step_gate(self) -> None:
        """Engine-level fault injection at the top of every prefill and
        decode dispatch entry: the wedge sleeps before the failure roll,
        so a wedged-and-failing replica meets the watchdog first, like a
        hung call that is then killed."""
        if self.chaos_step_wedge_s > 0:
            time.sleep(self.chaos_step_wedge_s)
        if (self.chaos_step_failure_rate > 0
                and _chaos_random.random() < self.chaos_step_failure_rate):
            raise ChaosStepError("chaos: injected engine step failure")

    def set_page_pressure(self, n_pages: int) -> int:
        """Arm/disarm chaos_page_pressure: hold ``n_pages`` real pages out
        of the pool (clamped to what is free now). Engine thread only
        (other threads use request_page_pressure). Returns the pages
        held."""
        self.allocator.free(self._pressure_pages)
        self._pressure_pages = []
        n = max(0, min(int(n_pages), self.allocator.num_free))
        if n > 0:
            self._pressure_pages = self.allocator.allocate(n)
        self.chaos_page_pressure = len(self._pressure_pages)
        return self.chaos_page_pressure

    def request_page_pressure(self, n_pages: int) -> int:
        """Thread-safe arm/disarm request: stores the target; the
        scheduler loop applies it on the engine thread within one
        iteration. Returns the requested target."""
        n = max(0, int(n_pages))
        self._pressure_target = n
        return n

    def apply_pending_page_pressure(self) -> None:
        """Apply a cross-thread pressure request (engine thread only)."""
        target = self._pressure_target
        if target is not None:
            self._pressure_target = None
            self.set_page_pressure(target)

    def _maybe_finish(self, seq: Sequence, tok: int) -> None:
        if seq.eos_token_id is not None and tok == seq.eos_token_id:
            seq.done, seq.finish_reason = True, "stop"
        elif len(seq.generated) >= seq.max_new_tokens:
            seq.done, seq.finish_reason = True, "length"
        elif seq.ctx_len + 1 >= self.engine_cfg.max_context:
            seq.done, seq.finish_reason = True, "length"
        if seq.done:
            seq.finish_time = time.perf_counter()
        elif self.swa_evict:
            self._evict_behind_window(seq)

    def _evict_behind_window(self, seq: Sequence) -> None:
        """Free KV pages wholly behind the sliding window; their block-
        table entries become the trash page. No windowed reader touches
        them (in-flight calls staged at a later predicted ctx have later
        windows still)."""
        win = self.model_cfg.sliding_window
        first_needed = max(0, seq.ctx_len - win) // self.engine_cfg.page_size
        j = seq.evicted_pages
        while j < min(first_needed, len(seq.pages)):
            if seq.pages[j]:
                self.allocator.free([seq.pages[j]])
                seq.pages[j] = 0
            j += 1
        seq.evicted_pages = j

    def _tokens_in_kv(self, seq: Sequence, drop_last: bool = False
                      ) -> List[int]:
        """Tokens resident in the sequence's KV pages, in page order:
        the prefill stream (truncated as prefilled) plus the generated
        suffix (``drop_last``: without the just-sampled token, which is
        not in KV yet)."""
        base = self._prefill_tokens(seq)[-(self.engine_cfg.max_context
                                           - 1):]
        gen = seq.generated[seq.resume_base:]
        return base + (gen[:-1] if drop_last else gen)

    def export_sequence_kv(self, seq: Sequence
                           ) -> Tuple[List[bytes], List[kvc.HostKVPage]]:
        """Drain-time migration export: (chain digests, host page copies)
        of the sequence's full, settled KV pages (prompt plus generated
        so far), the stream a destination's recompute-resume prefill
        hashes, so the import lands as host-tier hits there and admission
        is a swap-in-resume. Only the run of full, non-evicted pages from
        page 0 exports; the partial last page recomputes. Call with the
        scheduler stopped and the pipeline drained. The copies have
        landed when this returns (the stream is synchronized)."""
        if not seq.pages or seq.ctx_len <= 0:
            return [], []
        ecfg = self.engine_cfg
        in_kv = self._tokens_in_kv(seq)[:seq.ctx_len]
        digests = _chain_hashes(in_kv, ecfg.page_size)
        n = min(len(digests), len(seq.pages))
        run = 0
        while run < n and seq.pages[run] != 0:
            run += 1
        if run == 0:
            return [], []
        host = self._offload_pages(seq.pages[:run])
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.migrate_out_pages += len(host)
        self.migrate_out_bytes += sum(hp.nbytes for hp in host)
        return digests[:run], host

    def export_sequence_kv_live(self, seq: Sequence
                                ) -> Tuple[List[bytes], List[kvc.HostKVPage],
                                           int]:
        """P/D handoff export: (full-page chain digests, host page copies,
        ctx_len) of a live sequence. Unlike the drain export, the pages
        cover every page holding the first ctx_len tokens, the partial
        final page included: the destination restores it verbatim (no
        reader past ctx_len touches its trailing rows) and resumes decode
        with nothing recomputed. The digests cover only the full pages.
        ([], [], 0) when nothing is exportable (no KV, or a window
        evicted a page): the caller then keeps decoding locally. Engine
        thread; the copies have landed when this returns."""
        if not seq.pages or seq.ctx_len <= 0:
            return [], [], 0
        ecfg = self.engine_cfg
        n_pages = -(-seq.ctx_len // ecfg.page_size)
        pages = seq.pages[:n_pages]
        if len(pages) < n_pages or any(p == 0 for p in pages):
            return [], [], 0
        in_kv = self._tokens_in_kv(seq)[:seq.ctx_len]
        digests = _chain_hashes(in_kv, ecfg.page_size)
        host = self._offload_pages(pages)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.handoffs_out += 1
        return digests[:seq.ctx_len // ecfg.page_size], host, seq.ctx_len

    def adopt_sequence(self, seq: Sequence) -> int:
        """P/D handoff adoption (engine thread, at admission): restore
        ``seq.adopt_kv``'s pages, the partial final page included, into
        fresh pages, bind a slot and resume decode. No prefill runs, so
        nothing is recomputed and greedy decode continues exactly as on
        the exporting engine (the same pool bytes, the same last token).
        Raises on a malformed export or a pool shortfall; the scheduler
        then recompute-resumes through the ordinary prefill. Returns the
        slot."""
        host_pages, ctx_len = seq.adopt_kv
        ecfg = self.engine_cfg
        expected = -(-ctx_len // ecfg.page_size)
        if ctx_len <= 0 or len(host_pages) != expected:
            raise ValueError(
                f"handoff blob has {len(host_pages)} pages for "
                f"ctx_len={ctx_len} (need {expected})")
        slot = self.free_slots()[0]
        seq.admit_idx = self._admit_counter
        self._admit_counter += 1
        fresh = self._allocate_reclaiming(len(host_pages))
        try:
            self._restore_batch(fresh, host_pages,
                                trace_id=seq.trace_id or str(seq.request_id))
        except BaseException:
            self.allocator.free(fresh)
            raise
        seq.pages = fresh
        seq.pages_version += 1
        seq.ctx_len = ctx_len
        seq.slot = slot
        seq.adopt_kv = None
        # The whole resume stream arrived as settled KV or recorded
        # tokens: report it as cached (the router's reused-vs-recomputed
        # accounting).
        seq.cached_tokens = min(ctx_len + seq.resume_base,
                                ecfg.max_context - 1)
        seq.host_restored_pages += len(host_pages)
        now = time.perf_counter()
        seq.prefill_start = seq.prefill_start or now
        seq.first_token_time = now
        seq.adopted = True
        self.adoptions_in += 1
        self.swap_in_resumes += 1
        self.slots[slot] = seq
        return slot

    def request_import_host(self, entries) -> "ImportDone":
        """Queue migrated (digest, HostKVPage) entries for adoption into
        the host tier. Any thread; the returned event is set once the
        engine loop applied them (the worker's import-kv RPC replies only
        then, so the resubmitted request's prefill sees the pages), with
        the pages this request adopted in ``adopted``."""
        done = ImportDone()
        with self._pending_imports_lock:
            self._pending_imports.append((list(entries), done))
        return done

    def apply_pending_imports(self) -> None:
        """Adopt queued migration imports (engine thread, before
        admission). Without a host tier nothing is adopted, but every
        event is still set so no RPC waits."""
        with self._pending_imports_lock:
            pending, self._pending_imports = self._pending_imports, []
        for entries, done in pending:
            try:
                if (self.prefix_cache is not None
                        and self.host_pool is not None):
                    # The pool's byte delta: import_host skips resident
                    # digests anywhere in the list.
                    before = self.host_pool.import_bytes_total
                    done.adopted = self.prefix_cache.import_host(entries)
                    self.migrate_in_pages += done.adopted
                    self.migrate_in_bytes += (
                        self.host_pool.import_bytes_total - before)
            finally:
                done.set()

    def _publish_to_cache(self, seq: Sequence) -> None:
        """Publish a sequence's full pages (prompt + generated history) to
        the prefix cache, so a follow-up turn, or this sequence's own
        resume after a preemption, reuses them."""
        if self.prefix_cache is None or not seq.pages:
            return
        in_kv = self._tokens_in_kv(seq, drop_last=True)
        digests = None if seq.resume_base else seq.prefix_digests
        self.prefix_cache.insert(in_kv[:seq.ctx_len], seq.pages,
                                 digests=digests)

    def release(self, seq: Sequence) -> None:
        """Free a finished sequence's pages and slot, publishing its full
        pages to the prefix cache first."""
        self._publish_to_cache(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.prefill_prompt = None          # cancel/error mid-prefill
        if seq.slot >= 0 and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
        self._stage_forget(seq)

    # ------------------------------------------------------------------
    # Preemption + recompute-resume (admission="optimistic")
    # ------------------------------------------------------------------

    def preempt(self, seq: Sequence) -> None:
        """Evict a running sequence under pool pressure: publish its pages
        to the prefix cache, free them and the slot, keep its tokens; a
        later re-admission prefills prompt + generated (token-identical
        under greedy decoding) and reuses whatever pages survived."""
        assert all(seq.slot not in call["allowed"]
                   for call in self._inflight), \
            "preempt of a sequence with dispatch-ahead calls in flight"
        self._publish_to_cache(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        if seq.slot >= 0 and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None
        self._stage_forget(seq)
        seq.slot = -1
        seq.ctx_len = 0
        seq.evicted_pages = 0
        seq.cached_tokens = 0
        seq.prefill_prompt = None
        # The published pages may demote under this very pressure:
        # re-arm the queue-wait prefetch.
        seq.host_prefetched = False
        seq.resume_digests = None
        seq.resume_base = len(seq.generated)
        seq.preemptions += 1
        self.preemptions_total += 1
        self._preempted_out.append(seq)
        telemetry.log_event(
            "request_preempted", level="info",
            request_id=seq.trace_id or str(seq.request_id),
            preemptions=seq.preemptions,
            generated_tokens=len(seq.generated),
            free_plus_evictable=self._free_plus_evictable())

    def take_preempted(self) -> List[Sequence]:
        """Sequences preempted since the last call, in preemption order;
        the caller requeues them at the head of its wait queue."""
        out, self._preempted_out = self._preempted_out, []
        return out

    def _preempt_victim(self, cands: List[Sequence]) -> Optional[Sequence]:
        """Most recently admitted candidate with preemption budget left
        (sequences past the starvation guard are exempt)."""
        limit = self.engine_cfg.preempt_max_per_request
        eligible = [s for s in cands if s.preemptions < limit]
        return max(eligible, key=lambda s: s.admit_idx) if eligible else None

    def _preempt_for_pressure(self, active_seqs: List[Sequence],
                              k_steps: int) -> List[Sequence]:
        """Before decode grants under optimistic admission: while the
        coming round's page needs exceed free+evictable AND that is below
        the low watermark, preempt the newest sequences. Returns the
        surviving active list."""
        if self.admission != "optimistic":
            return active_seqs
        ecfg = self.engine_cfg
        active = list(active_seqs)
        while len(active) > 1:
            need = sum(
                kvc.pages_needed(
                    min(k_steps,
                        max(0, s.max_new_tokens - len(s.generated)),
                        max(0, ecfg.max_context - 1 - s.ctx_len)),
                    ecfg.page_size, already=s.ctx_len)
                for s in active)
            avail = self._free_plus_evictable()
            if need <= avail or avail >= ecfg.preempt_watermark_pages:
                break
            victim = self._preempt_victim(active)
            if victim is None:
                break
            self.preempt(victim)
            active.remove(victim)
        return active

    def _starved(self, seq: Sequence) -> None:
        """A lane with no page slack and no grantable page: preempted
        under optimistic admission (budget allowing), else it fails with
        "oom" (reserve admission makes that exceptional)."""
        if (self.admission == "optimistic"
                and seq.preemptions < self.engine_cfg.preempt_max_per_request):
            self.preempt(seq)
            return
        seq.done, seq.finish_reason = True, "oom"
        seq.finish_time = time.perf_counter()

    def active_sequences(self) -> List[Sequence]:
        """Sequences decode may advance: bound, unfinished, not mid-prefill."""
        return [s for s in self.slots
                if s is not None and not s.done and s.prefill_prompt is None]

    # ------------------------------------------------------------------
    # Batch ladder: rung selection, slot compaction, staging buffers
    # ------------------------------------------------------------------

    def _rung_for_slots(self, seqs: List[Sequence]) -> int:
        """Smallest rung covering every slot in ``seqs``."""
        hi = max((s.slot for s in seqs), default=-1) + 1
        for r in self.ladder:
            if r >= hi:
                return r
        return self.ladder[-1]

    def _note_rung(self, rung: int) -> None:
        """Count the call at its rung and flag the rung's first call for
        the step ledger (compile_event)."""
        self.rung_calls[rung] = self.rung_calls.get(rung, 0) + 1
        self._last_compile_event = rung not in self._rungs_seen
        self._rungs_seen.add(rung)
        if rung != self.decode_rung:
            self.rung_switches_total += 1
            self.decode_rung = rung
            self.rung_peak = max(self.rung_peak, rung)

    def _compact_slots(self) -> None:
        """Move bound sequences out of high slots into lower free ones so
        the next call can run a smaller rung (host bookkeeping only: block
        tables ship per call, KV pages never move). Only while no
        dispatch-ahead call is in flight: those address lanes by slot."""
        if len(self.ladder) == 1 or self._inflight:
            return
        bound = [i for i, s in enumerate(self.slots) if s is not None]
        if not bound:
            return
        target = next(r for r in self.ladder if r >= len(bound))
        if bound[-1] < target:
            return
        free = [i for i in range(target) if self.slots[i] is None]
        for i in reversed(bound):
            if i < target or not free:
                break
            j = free.pop(0)
            seq = self.slots[i]
            self.slots[j], self.slots[i] = seq, None
            seq.slot = j

    def _stage_buffers(self, rung: int) -> dict:
        """Persistent per-rung staging arrays: tokens and ctx refresh
        every call, sampling params when the slot's occupant changes,
        the block-table row when its (version, len, evicted) key moves."""
        buf = self._stage_bufs.get(rung)
        if buf is None:
            buf = {"tokens": np.zeros((rung,), np.int32),
                   "ctx": np.zeros((rung,), np.int32),
                   "bts": np.zeros((rung, self.max_pages), np.int32),
                   **self._lane_arrays([], rung),
                   "owner": [None] * rung, "bt_key": [None] * rung}
            self._stage_bufs[rung] = buf
        return buf

    def _stage_forget(self, seq: Sequence) -> None:
        """Drop a departing sequence's staging rows (every rung), so the
        buffers never pin finished sequences."""
        for buf in self._stage_bufs.values():
            owner = buf["owner"]
            for i, s in enumerate(owner):
                if s is seq:
                    owner[i] = None
                    buf["bt_key"][i] = None

    _STAGED = ("tokens", "ctx", "bts", "temps", "top_ps", "top_ks", "seeds",
               "rpens", "rlasts", "windows")

    def _stage_batch(self, active_seqs: List[Sequence], rung: int) -> dict:
        """The per-slot host arrays of a decode call at ``rung`` (copies:
        the buffers change at the next call). Rows of freed slots go
        stale, which is harmless: their ``allowed`` is 0, so every write
        lands on the trash page and their token is discarded. Its wall
        is the step ledger's staging_s."""
        t_stage = time.perf_counter()
        if not self._stage_reuse:
            st = {"tokens": np.zeros((rung,), np.int32),
                  "ctx": np.zeros((rung,), np.int32),
                  "bts": np.zeros((rung, self.max_pages), np.int32),
                  **self._lane_arrays([(s.slot, s) for s in active_seqs],
                                      rung)}
            for seq in active_seqs:
                st["tokens"][seq.slot] = seq.last_token
                st["ctx"][seq.slot] = seq.ctx_len
                st["bts"][seq.slot] = self._block_table_array(seq.pages)
            self._last_staging_s = time.perf_counter() - t_stage
            return st
        buf = self._stage_buffers(rung)
        owner, bt_key = buf["owner"], buf["bt_key"]
        for seq in active_seqs:
            i = seq.slot
            buf["tokens"][i] = seq.last_token
            buf["ctx"][i] = seq.ctx_len
            if owner[i] is not seq:
                owner[i] = seq
                bt_key[i] = None
                buf["temps"][i] = seq.temperature
                buf["top_ps"][i] = seq.top_p
                buf["top_ks"][i], buf["seeds"][i] = \
                    self._sampling_arrays(seq)
                buf["rpens"][i], buf["rlasts"][i] = \
                    self._penalty_arrays(seq)
            key = (seq.pages_version, len(seq.pages), seq.evicted_pages)
            if bt_key[i] != key:
                bt_key[i] = key
                n = len(seq.pages)
                buf["bts"][i, :n] = seq.pages
                buf["bts"][i, n:] = 0
            if buf["rpens"][i] != 1.0:
                buf["windows"][i] = self._penalty_window_row(seq)
        st = {k: buf[k].copy() for k in self._STAGED}
        self._last_staging_s = time.perf_counter() - t_stage
        return st

    # ------------------------------------------------------------------
    # Synchronous decode
    # ------------------------------------------------------------------

    def decode_step(self) -> Dict[int, int]:
        """One batched decode step; {request_id: token}."""
        return {rid: toks[0]
                for rid, toks in self.decode_steps(max_steps=1).items()}

    def decode_steps(self, max_steps: Optional[int] = None
                     ) -> Dict[int, List[int]]:
        """Up to ``decode_steps_per_call`` decode steps in ONE call with
        one host sync. Returns {request_id: [tokens, in order]}.
        ``max_steps`` caps every lane (1 = the latency route). Calls
        still in flight are drained first (their tokens land in each
        sequence's ``generated``). Under speculative decoding one
        call is one spec round (n-gram: the plain call when no lane
        proposes)."""
        self._chaos_step_gate()
        if self._inflight:
            self.drain_pipeline()
        if self.spec_draft:
            return self._spec_decode_steps(max_steps)
        if self.spec_ngram:
            return self._ngram_decode_steps(max_steps)
        return self._plain_decode_steps(max_steps)

    def _plain_decode_steps(self, max_steps: Optional[int] = None
                            ) -> Dict[int, List[int]]:
        """The K-step decode call (decode_steps' body); also the call
        an n-gram round degrades to when no lane proposes."""
        ecfg = self.engine_cfg
        k_steps = max(1, ecfg.decode_steps_per_call)
        if max_steps is not None:
            k_steps = min(k_steps, max_steps)
        self._compact_slots()             # step the ladder down
        active = self.active_sequences()
        if not active:
            return {}
        # Under optimistic admission pressure preempts the newest lanes
        # before any grant, so the survivors advance at full K.
        active = self._preempt_for_pressure(active, k_steps)
        allowed_by_slot: Dict[int, int] = {}
        for seq in active:
            steps = self._grant_decode_steps(seq, k_steps)
            if steps <= 0:
                self._starved(seq)
                continue
            allowed_by_slot[seq.slot] = steps
        active = [s for s in active if not s.done and s.slot >= 0]
        if not active:
            return {}
        b = self._rung_for_slots(active)
        self._note_rung(b)
        st = self._stage_batch(active, b)
        st["allowed"] = np.zeros((b,), np.int32)
        st["eos"] = np.full((b,), -1, np.int32)
        for seq in active:
            st["allowed"][seq.slot] = allowed_by_slot[seq.slot]
            if seq.eos_token_id is not None:
                st["eos"][seq.slot] = seq.eos_token_id
        t0 = self._note_decode_entry(active)
        outs, _, _ = self._decode_multi_fn(st, k_steps)
        outs = outs.cpu().numpy()                      # [K, B]: one sync
        dt = self._note_decode_exit(t0, active)
        kv_read = sum(s.ctx_len for s in active) * k_steps
        result: Dict[int, List[int]] = {}
        for seq in active:
            got = self._fold_lane(seq, (int(outs[s, seq.slot])
                                        for s in range(k_steps)))
            if got:
                result[seq.request_id] = got
        if self.telemetry.enabled:
            n_tokens = sum(len(t) for t in result.values())
            self.telemetry.tokens_per_dispatch.observe(n_tokens)
            self._ledger_push("decode", rung=b, slots=len(active),
                              tokens=n_tokens, steps=k_steps,
                              device_s=dt, kv_read=kv_read)
        return result

    # ------------------------------------------------------------------
    # Dispatch-ahead pipeline and hybrid steps
    # ------------------------------------------------------------------

    def _hybrid_chunk_cap(self, decode_tokens: int) -> int:
        """Chunk-token cap of one hybrid step: the serial chunk cap,
        bounded by ``step_token_budget`` minus the decode tokens granted
        in this call, floored at page_size so the prefill advances."""
        ecfg = self.engine_cfg
        cap = ecfg.chunk_tokens_cap
        budget = ecfg.step_token_budget
        if budget > 0:
            cap = min(cap, max(ecfg.page_size, budget - decode_tokens))
        return cap

    def _stage_hybrid_chunk(self, seq: Sequence,
                            decode_tokens: int) -> Optional[dict]:
        """Host arrays of ``seq``'s next chunk. Advances
        ``prefill_offset`` at stage time, so chunk N+1 can be staged
        while chunk N is in flight (the stream runs them in order).
        None once the whole prompt is staged."""
        prompt = seq.prefill_prompt
        if prompt is None or seq.done or seq.prefill_offset >= len(prompt):
            return None
        offset = seq.prefill_offset
        st = self._stage_chunk_arrays(seq, prompt, offset,
                                      self._hybrid_chunk_cap(decode_tokens))
        seq.prefill_offset = offset + st["chunk_tokens"]
        st["final"] = seq.prefill_offset >= len(prompt)
        return st

    def _chunk_record(self, chunk: dict, p_tok: torch.Tensor) -> dict:
        return {"seq": chunk["seq"], "prompt": chunk["prompt"],
                "final": chunk["final"], "tok": p_tok}

    def _stage_chunk_only_call(self, chunk: dict) -> dict:
        """Queue one staged chunk with no decode half (no lane can
        advance in this call), as a pipeline call."""
        t0 = time.perf_counter()
        self._last_decode_end = None   # prefill breaks the decode streak
        p_tok = self._prefill_fn(chunk)
        (p_host,), event = self._to_host_async(p_tok)
        dt = time.perf_counter() - t0
        self.telemetry.prefill_dispatch_s.observe(dt)
        self.telemetry.prefill_dispatches.inc()
        call = {"outs": None, "final": None, "final_window": None,
                "event": event, "allowed": {}, "seqs": {}, "rung": 0,
                "prefill": self._chunk_record(chunk, p_host)}
        if self.telemetry.enabled:
            chunk["seq"].dispatch_wall_s += dt
            c = chunk["chunk_tokens"]
            call["ledger"] = {
                "kind": "prefill_chunk", "rung": 0, "slots": 1,
                "tokens": 1 if chunk["final"] else 0,
                "chunk_tokens": c, "steps": 1, "dispatch_s": dt,
                "staging_s": 0.0, "bubble_s": 0.0,
                "kv_read": _chunk_kv_read(c, int(chunk["prefix_len"][0])),
                "compile": chunk["bucket"]
                not in self._prefill_buckets_seen}
            self._prefill_buckets_seen.add(chunk["bucket"])
        return call

    def _stage_decode_call(self, prefill_seq: Optional[Sequence] = None
                           ) -> Optional[dict]:
        """Stage one K-step decode call from host state plus the ctx the
        in-flight calls will have added (predicted ctx), and queue it.
        With ``prefill_seq`` (mid-incremental-prefill), its next chunk
        rides the same call (hybrid). Returns None when nothing can
        advance. Lanes that stop mid-flight (EOS) waste at most their
        staged steps, whose tokens the sync discards."""
        ecfg = self.engine_cfg
        k_steps = max(1, ecfg.decode_steps_per_call)
        if not self._inflight:
            self._compact_slots()
        ahead: Dict[int, int] = {}
        for call in self._inflight:
            for slot, steps in call["allowed"].items():
                ahead[slot] = ahead.get(slot, 0) + steps
        active = self.active_sequences()
        if not active and prefill_seq is None:
            return None
        allowed_by_slot: Dict[int, int] = {}
        staged: List[Sequence] = []
        for seq in active:
            lag = ahead.get(seq.slot, 0)
            steps = self._grant_decode_steps(
                seq, k_steps, pred_ctx=seq.ctx_len + lag,
                pred_done=len(seq.generated) + lag)
            if steps <= 0:
                if lag == 0:
                    # No in-flight call touches it and the pool has no
                    # slack: preempt (optimistic) or fail it.
                    self._starved(seq)
                continue                      # in-flight calls may emit
            allowed_by_slot[seq.slot] = steps
            staged.append(seq)
        # The chunk is staged after the grants: the token budget counts
        # only the lanes this call advances.
        chunk = None
        if prefill_seq is not None:
            chunk = self._stage_hybrid_chunk(
                prefill_seq, sum(allowed_by_slot.values()))
        if not staged and chunk is None:
            return None
        if not staged:
            return self._stage_chunk_only_call(chunk)
        active = [s for s in active if not s.done and s.slot >= 0]
        # Never below an in-flight call's rung: the carry folds are
        # element-wise over [rung] tensors (growth drains first).
        b = self._rung_for_slots(active)
        for call in self._inflight:
            b = max(b, call["rung"])
        self._note_rung(b)
        st = self._stage_batch(active, b)
        st["allowed"] = np.zeros((b,), np.int32)
        st["eos"] = np.full((b,), -1, np.int32)
        for seq in staged:
            st["allowed"][seq.slot] = allowed_by_slot[seq.slot]
            st["ctx"][seq.slot] = seq.ctx_len + ahead.get(seq.slot, 0)
            if seq.eos_token_id is not None:
                st["eos"][seq.slot] = seq.eos_token_id
        use_pen = bool(np.any(st["rpens"] != 1.0))
        tokens_d = self._to_device(st["tokens"])
        window_d = self._to_device(st["windows"]) if use_pen else None
        # A continuing lane takes the carry token (and window) of the
        # NEWEST in-flight call that advanced it; lanes in no in-flight
        # call (fresh prefills) keep their host-known state.
        for call in self._inflight:
            if call["final"] is None:
                continue          # chunk-only call: no decode half
            carried = np.zeros((b,), bool)
            for slot in call["allowed"]:
                carried[slot] = True
            carried_d = self._to_device(carried)
            tokens_d = torch.where(carried_d, call["final"], tokens_d)
            if use_pen and call["final_window"] is not None:
                window_d = torch.where(carried_d[:, None],
                                       call["final_window"], window_d)
        st["tokens"], st["windows"] = tokens_d, window_d
        t0 = self._note_decode_entry(staged)
        if chunk is None:
            outs, final, final_window = self._decode_multi_fn(st, k_steps)
            p_tok = None
        else:
            p_tok, outs, final, final_window = self._hybrid_step_fn(
                chunk, st, k_steps)
            self.hybrid_steps_total += 1
            self.telemetry.hybrid_steps.inc()
        (outs_h, p_host), event = self._to_host_async(outs, p_tok)
        # Non-blocking: this wall is the host's dispatch; the device
        # wait shows in decode_sync_s at _sync_oldest.
        dispatch_dt = self._note_decode_exit(t0, staged)
        if chunk is not None and self.telemetry.enabled:
            dt = time.perf_counter() - t0
            self.telemetry.hybrid_dispatch_s.observe(dt)
            chunk["seq"].dispatch_wall_s += dt
        call = {"outs": outs_h, "final": final,
                "final_window": final_window, "event": event,
                "allowed": allowed_by_slot, "rung": b,
                "seqs": {s.slot: s for s in staged}}
        if chunk is not None:
            call["prefill"] = self._chunk_record(chunk, p_host)
        if self.telemetry.enabled:
            # The ledger fields known at stage time (this dispatch's
            # staging and bubble walls); the record is pushed at sync
            # with device_s = dispatch + sync wall and the folded tokens.
            kv_read = sum(int(st["ctx"][s.slot]) * allowed_by_slot[s.slot]
                          for s in staged)
            compile_ev = self._last_compile_event
            self._last_compile_event = False
            if chunk is not None:
                kv_read += _chunk_kv_read(chunk["chunk_tokens"],
                                          int(chunk["prefix_len"][0]))
                hkey = ("hybrid", chunk["bucket"])
                compile_ev = compile_ev or (
                    hkey not in self._prefill_buckets_seen)
                self._prefill_buckets_seen.add(hkey)
            call["ledger"] = {
                "kind": "decode" if chunk is None else "hybrid",
                "rung": b, "slots": len(staged),
                # the final chunk's sampled first token folds at sync
                "tokens": 1 if chunk is not None and chunk["final"]
                else 0,
                "chunk_tokens": 0 if chunk is None
                else chunk["chunk_tokens"],
                "steps": k_steps, "dispatch_s": dispatch_dt,
                "staging_s": self._last_staging_s,
                "bubble_s": self._pending_bubble,
                "kv_read": kv_read, "compile": compile_ev}
            self._last_staging_s = 0.0
            self._pending_bubble = 0.0
        return call

    def _sync_oldest(self) -> Dict[int, List[int]]:
        """Wait for the oldest in-flight call and fold its tokens into
        host state; tokens of lanes that finished in an earlier call are
        discarded."""
        call = self._inflight.pop(0)
        if call.get("spec"):
            return self._sync_spec_call(call)
        t0 = time.perf_counter()
        if call["event"] is not None:
            call["event"].synchronize()
        sync_dt = time.perf_counter() - t0
        if self.telemetry.enabled:
            if call["outs"] is not None:
                self.telemetry.decode_sync_s.observe(sync_dt)
            pf = call.get("prefill")
            if pf is not None:
                # The chunk's request waited on the same sync.
                pf["seq"].dispatch_wall_s += sync_dt
            for seq in call["seqs"].values():
                if not seq.done and self.slots[seq.slot] is seq:
                    seq.dispatch_wall_s += sync_dt
        # The wait was device time: the next bubble counts host work only.
        self._last_decode_end = (
            time.perf_counter()
            if any(s is not None and not s.done for s in self.slots)
            else None)
        result: Dict[int, List[int]] = {}
        if call["outs"] is not None:
            outs = call["outs"].numpy()                 # [K, B]
            for slot, seq in call["seqs"].items():
                if seq.done or self.slots[seq.slot] is not seq:
                    continue
                got = self._fold_lane(
                    seq, (int(outs[s, slot]) for s in range(outs.shape[0])))
                if got:
                    result[seq.request_id] = got
            self.telemetry.tokens_per_dispatch.observe(
                sum(len(t) for t in result.values()))
        pf = call.get("prefill")
        if pf is not None:
            # Only the FINAL chunk has host work left; a cancel that
            # landed mid-flight skips the fold (the scheduler reaps it).
            seq = pf["seq"]
            if (pf["final"] and not seq.done
                    and seq.prefill_prompt is not None
                    and seq.slot >= 0 and self.slots[seq.slot] is seq):
                self._prefill_finish(seq, pf["prompt"],
                                     int(pf["tok"].numpy()[0]))
                seq.prefill_prompt = None
        led = call.get("ledger")
        if led is not None:
            tokens = led["tokens"]
            if led["kind"] != "prefill_chunk":
                tokens += sum(len(t) for t in result.values())
            self._push_staged(led, tokens, sync_dt)
        return result

    def _pressure_settle_round(self) -> Dict[int, List[int]]:
        """Optimistic admission under watermark pressure: drain the
        in-flight calls (they hold predicted-ctx grants), then run one
        synchronous round, which preempts as needed."""
        result = self.drain_pipeline()
        for rid, toks in self.decode_steps().items():
            result.setdefault(rid, []).extend(toks)
        return result

    def _pipeline_rung_blocked(self) -> bool:
        """True when staging now needs a bigger rung than the in-flight
        decode calls were staged at (the pipeline must settle first)."""
        if not self._inflight or len(self.ladder) == 1:
            return False
        rungs = [call["rung"] for call in self._inflight
                 if call["final"] is not None]
        if not rungs:
            return False
        cap = max(rungs)
        if cap >= self.ladder[-1]:
            return False
        active = self.active_sequences()
        if not active:
            return False
        return self._rung_for_slots(active) > cap

    def decode_steps_pipelined(self) -> Dict[int, List[int]]:
        """Dispatch-ahead serving step: keep up to
        ``decode_pipeline_depth`` K-step calls in flight and sync only
        the oldest; tokens arrive depth-1 calls after their dispatch.
        Depth <= 1 (and draft-model speculation) is the synchronous
        ``decode_steps``; n-gram speculation keeps one verify round in
        flight (``_ngram_steps_pipelined``)."""
        depth = self.engine_cfg.decode_pipeline_depth
        if depth <= 1 or self.spec_draft:
            return self.decode_steps()           # the gate runs inside
        if self.admission == "optimistic" and self.under_pressure:
            return self._pressure_settle_round()
        self._chaos_step_gate()
        if self.spec_ngram:
            return self._ngram_steps_pipelined()
        result: Dict[int, List[int]] = {}
        if self._pipeline_rung_blocked():
            result = self.drain_pipeline()     # settle, then grow the rung
        call = self._stage_decode_call()
        if call is not None:
            self._inflight.append(call)
        if not self._inflight:
            return result
        if len(self._inflight) >= depth or call is None:
            for rid, toks in self._sync_oldest().items():
                result.setdefault(rid, []).extend(toks)
        return result

    def hybrid_step_pipelined(self, seq: Sequence) -> Dict[int, List[int]]:
        """Serving step while ``seq`` is mid-incremental-prefill: its next
        chunk AND the decode lanes in ONE call (hybrid_prefill), chained
        into the same pipeline as plain decode calls (with depth <= 1 it
        syncs at once). Once the prompt is fully staged, calls degrade to
        plain decode staging; the final chunk's token folds at its sync
        (completion shows as ``seq.prefill_prompt is None``). Returns the
        decode tokens folded by this call. Not under speculative
        decoding (the scheduler never asks then)."""
        if self.spec_enabled:
            raise RuntimeError("hybrid steps do not compose with "
                               "speculative decoding")
        depth = max(1, self.engine_cfg.decode_pipeline_depth)
        if (self.admission == "optimistic" and self.under_pressure
                and self.active_sequences()):
            # Settle (drain + one preempting round), then advance the
            # chunk serially: its pages were allocated at prefill_begin.
            result = self._pressure_settle_round()
            if seq.prefill_prompt is not None and not seq.done:
                self.prefill_step(seq)
            return result
        self._chaos_step_gate()
        result: Dict[int, List[int]] = {}
        if self._pipeline_rung_blocked():
            result = self.drain_pipeline()
        call = self._stage_decode_call(prefill_seq=seq)
        if call is not None:
            self._inflight.append(call)
        if not self._inflight:
            return result
        if depth <= 1 or len(self._inflight) >= depth or call is None:
            for rid, toks in self._sync_oldest().items():
                result.setdefault(rid, []).extend(toks)
        return result

    @property
    def pipeline_pending(self) -> bool:
        return bool(self._inflight)

    def abort_pipeline(self) -> None:
        """Drop the in-flight calls without folding (after a call
        failed): their outputs are suspect, and stale entries would
        poison the ctx prediction of whatever reuses those slots."""
        self._inflight.clear()

    def drain_pipeline(self) -> Dict[int, List[int]]:
        """Sync every in-flight call (idle/finish/shutdown path)."""
        result: Dict[int, List[int]] = {}
        while self._inflight:
            for rid, toks in self._sync_oldest().items():
                result.setdefault(rid, []).extend(toks)
        return result

    def decode_steps_chained(self, n_calls: int) -> Dict[int, List[int]]:
        """``n_calls`` K-step calls back to back, each fed the previous
        call's last tokens on the device, with ONE host sync at the end
        (fixed-length batch mode: pages are provisioned for the whole run
        up front, and EOS/budget do not stop lanes early, so the caller
        keeps n_calls * K within every lane's budget and room)."""
        ecfg = self.engine_cfg
        k_steps = max(1, ecfg.decode_steps_per_call)
        if self._inflight:
            self.drain_pipeline()
        active = self.active_sequences()
        if not active:
            return {}
        total = n_calls * k_steps
        for seq in active:
            budget = seq.max_new_tokens - len(seq.generated)
            room = ecfg.max_context - 1 - seq.ctx_len
            if total > min(budget, room):
                raise ValueError(
                    f"decode_steps_chained: n_calls*K={total} exceeds "
                    f"seq {seq.request_id}'s budget={budget} or context "
                    f"room={room}")
            need = kvc.pages_needed(total, ecfg.page_size,
                                    already=seq.ctx_len)
            if need > 0:
                seq.pages.extend(self._allocate_reclaiming(need))
        self._compact_slots()
        b = self._rung_for_slots(active)
        self._note_rung(b)
        st = self._stage_batch(active, b)
        st["allowed"] = np.zeros((b,), np.int32)
        for seq in active:
            st["allowed"][seq.slot] = k_steps
        st["eos"] = np.full((b,), -1, np.int32)
        ctx0 = st["ctx"].copy()
        outs_all = []
        kv_read = sum(s.ctx_len for s in active) * total
        dispatch_wall = 0.0
        for c in range(n_calls):
            st["ctx"] = ctx0 + c * st["allowed"]
            t0 = self._note_decode_entry(active)
            outs, st["tokens"], st["windows"] = self._decode_multi_fn(
                st, k_steps)
            if st["windows"] is None:
                st["windows"] = np.full((b, PENALTY_WINDOW), -1, np.int64)
            outs_all.append(outs)
            dispatch_wall += self._note_decode_exit(t0, active)
        t_sync = time.perf_counter()
        outs_all = torch.cat(outs_all).cpu().numpy()   # the one sync
        sync_dt = time.perf_counter() - t_sync
        self.telemetry.decode_sync_s.observe(sync_dt)
        self._last_decode_end = time.perf_counter()
        result: Dict[int, List[int]] = {}
        for seq in active:
            got = [int(t) for t in outs_all[:, seq.slot] if t >= 0]
            seq.ctx_len += len(got)
            seq.generated.extend(got)
            if seq.first_token_time == 0.0:
                seq.first_token_time = time.perf_counter()
            result[seq.request_id] = got
            self._maybe_finish(seq, seq.last_token)
        if self.telemetry.enabled:
            # One record for the chained run (one sync).
            self._ledger_push(
                "decode", rung=b, slots=len(active),
                tokens=sum(len(t) for t in result.values()), steps=total,
                device_s=dispatch_wall + sync_dt, kv_read=kv_read)
        return result

    # ------------------------------------------------------------------
    # Speculative decoding (engine/speculative.py)
    # ------------------------------------------------------------------

    def _spec_grant(self, active_seqs: List[Sequence], s_len: int,
                    max_steps: Optional[int]
                    ) -> Tuple[List[Sequence], Dict[int, int]]:
        """Per-slot emission caps and page grants for one spec round: the
        device writes KV for up to ``s_len`` positions, so provision pages
        for what fits and clamp emissions to written capacity. Pages are
        charged against the pages held, not ctx (a partly accepted round
        leaves rows past ctx in pages already held). Starved lanes
        preempt (optimistic) or fail. Returns (surviving sequences,
        {slot: emit cap})."""
        ecfg = self.engine_cfg
        emit_by_slot: Dict[int, int] = {}
        for seq in active_seqs:
            budget = seq.max_new_tokens - len(seq.generated)
            room = ecfg.max_context - 1 - seq.ctx_len
            emit_cap = max(0, min(s_len, budget, room))
            if max_steps is not None:
                emit_cap = min(emit_cap, max_steps)
            want = min(s_len, room)
            total_pages = kvc.pages_needed(seq.ctx_len + want,
                                           ecfg.page_size)
            need = max(0, min(total_pages, self.max_pages)
                       - len(seq.pages))
            grantable = self._free_plus_evictable()
            if need > grantable:
                slack = len(seq.pages) * ecfg.page_size - seq.ctx_len
                emit_cap = min(emit_cap,
                               slack + grantable * ecfg.page_size)
                need = min(need, grantable)
            if emit_cap <= 0:
                self._starved(seq)
                continue
            if need > 0:
                seq.pages.extend(self._allocate_reclaiming(need))
            emit_by_slot[seq.slot] = emit_cap
        return ([s for s in active_seqs if not s.done and s.slot >= 0],
                emit_by_slot)

    def _spec_stage(self, active_seqs: List[Sequence], b: int) -> tuple:
        """(staged arrays, cap, active) of a spec round at rung ``b``:
        cap = provisioned token capacity per slot (writes at or past it
        land on the trash page)."""
        st = self._stage_batch(active_seqs, b)
        cap = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        for seq in active_seqs:
            cap[seq.slot] = len(seq.pages) * self.engine_cfg.page_size
            active[seq.slot] = True
        return st, cap, active

    def _spec_decode_steps(self, max_steps: Optional[int] = None
                           ) -> Dict[int, List[int]]:
        """One draft-model round: the draft proposes γ tokens, the target
        verifies them in one forward, rejection sampling keeps an
        exact-distribution prefix; 1..γ+1 tokens per sequence. Seeds and
        repetition penalties do not reach the round (the acceptance
        ratio needs the unmodified distributions, and the rejection
        sampler draws at a data-dependent rate)."""
        ecfg = self.engine_cfg
        gamma = ecfg.num_speculative_tokens
        s_len = gamma + 1
        active_seqs = self.active_sequences()
        if not active_seqs:
            return {}
        active_seqs = self._preempt_for_pressure(active_seqs, s_len)
        active_seqs, emit_by_slot = self._spec_grant(active_seqs, s_len,
                                                     max_steps)
        if not active_seqs:
            return {}
        b = ecfg.max_batch_size       # draft spec runs at the top rung
        st, cap, active = self._spec_stage(active_seqs, b)
        t0 = self._note_decode_entry(active_seqs)
        emitted, n_acc = self._spec_round_fn(st, cap, active)
        emitted, n_acc = emitted.cpu().numpy(), n_acc.cpu().numpy()
        dt = self._note_decode_exit(t0, active_seqs)
        # The verify forward read the cache at the ctx the lanes entered
        # the round with.
        kv_read = sum(s.ctx_len for s in active_seqs) * s_len
        acc0 = self.spec_accepted
        result: Dict[int, List[int]] = {}
        for seq in active_seqs:
            got = self._fold_lane(seq, (int(t) for t in emitted[
                seq.slot, :emit_by_slot[seq.slot]]))
            # Count only the draft positions the host could emit (the cap
            # truncates a round when budget or context run out), and
            # clamp accepted to them, so capped rounds cannot drift the
            # rate.
            drafted = min(gamma, emit_by_slot[seq.slot])
            accepted = min(int(n_acc[seq.slot]), drafted)
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            if drafted > 0:
                self.telemetry.spec_accept_rate.observe(accepted / drafted)
                seq.spec_rounds += 1
                seq.spec_accepted_toks += accepted
            if got:
                result[seq.request_id] = got
        if self.telemetry.enabled:
            n_toks = sum(len(t) for t in result.values())
            self.telemetry.tokens_per_dispatch.observe(n_toks)
            self._ledger_push(
                "spec_verify", rung=b, slots=len(active_seqs),
                tokens=n_toks, device_s=dt, kv_read=kv_read,
                spec_accepted=self.spec_accepted - acc0)
        return result

    # N-gram speculation: the host proposes continuations by suffix-
    # matching each sequence's own history, and a verify round scores γ+1
    # positions in one target forward. A per-sequence acceptance EWMA
    # throttles cold streams to γ=0; rounds where nothing proposes run
    # the plain K-step call.

    def _seq_spec_gamma(self, seq: Sequence) -> int:
        """Current adaptive γ of one sequence, ticking a throttled lane's
        probe countdown. A fresh stream earns the full width: its first
        proposal rides the narrow γ=1 round, and one clean accept
        promotes it."""
        gamma = self.engine_cfg.num_speculative_tokens
        if seq.spec_gamma < 0:
            seq.spec_gamma = 1 if gamma > 1 else gamma
        if seq.spec_gamma == 0:
            seq.spec_probe_countdown -= 1
            if seq.spec_probe_countdown <= 0:
                seq.spec_gamma = 1               # probe on the narrow width
        return seq.spec_gamma

    def _spec_update_adaptive(self, seq: Sequence, drafted: int,
                              accepted: int) -> None:
        """Fold one round's acceptance into the sequence's EWMA and
        throttle or restore its γ; consecutive failed probes double the
        probe interval (capped at 8x spec_probe_every)."""
        if drafted <= 0:
            return
        ecfg = self.engine_cfg
        rate = accepted / drafted
        seq.spec_accept_ewma += ecfg.spec_ewma_alpha * (
            rate - seq.spec_accept_ewma)
        self.telemetry.spec_accept_rate.observe(rate)
        seq.spec_rounds += 1
        seq.spec_accepted_toks += accepted
        thr = ecfg.spec_throttle_below
        if thr > 0 and seq.spec_accept_ewma < thr:
            if seq.spec_gamma != 0:
                self.spec_throttles_total += 1
            base = max(1, ecfg.spec_probe_every)
            seq.spec_probe_interval = min(
                8 * base, max(base, seq.spec_probe_interval * 2))
            seq.spec_gamma = 0
            seq.spec_probe_countdown = seq.spec_probe_interval
        else:
            seq.spec_gamma = ecfg.num_speculative_tokens
            seq.spec_probe_interval = 0

    def _ngram_proposals(self, active_seqs: List[Sequence]
                         ) -> Dict[int, np.ndarray]:
        """Prompt-lookup proposals of every lane not throttled: {slot:
        proposed tokens (1..γ)}. Probe alignment: when any lane's probe
        is due, every throttled lane probes in the same round (the batch
        pays one verify, not one per lane's countdown)."""
        ecfg = self.engine_cfg
        gammas = [self._seq_spec_gamma(seq) for seq in active_seqs]
        if any(g > 0 and s.spec_probe_interval > 0
               for s, g in zip(active_seqs, gammas)):
            gammas = [1 if g == 0 else g for g in gammas]
        props: Dict[int, np.ndarray] = {}
        for seq, gamma in zip(active_seqs, gammas):
            if gamma <= 0:
                continue
            # Slice before concatenating: the proposer reads only the
            # trailing NGRAM_SCAN_CAP tokens.
            hist = seq.generated[-NGRAM_SCAN_CAP:]
            if len(hist) < NGRAM_SCAN_CAP:
                hist = (seq.prompt_tokens[len(hist) - NGRAM_SCAN_CAP:]
                        + hist)
            prop = ngram_propose(hist, gamma, ecfg.ngram_window)
            if prop.size:
                props[seq.slot] = prop
            elif seq.spec_probe_interval > 0:
                # A probing lane with nothing to propose goes back to
                # sleep (no new evidence: the interval does not double).
                seq.spec_gamma = 0
                seq.spec_probe_countdown = seq.spec_probe_interval
        return props

    def _gate_mixed_batch(self, active_seqs: List[Sequence],
                          proposals: Dict[int, np.ndarray]
                          ) -> Dict[int, np.ndarray]:
        """With K > 1 a verify round advances a lane that proposed nothing
        by one token where the plain call advances it by up to K: verify
        only when the proposers' expected accepted tokens (EWMA-weighted)
        cover one token per bystander; otherwise return {} (the plain
        call). K == 1 has no bystander deficit."""
        k_steps = max(1, self.engine_cfg.decode_steps_per_call)
        if k_steps <= 1 or not proposals:
            return proposals
        by_slot = {s.slot: s for s in active_seqs}
        expected = sum(by_slot[slot].spec_accept_ewma * len(p)
                       for slot, p in proposals.items() if slot in by_slot)
        bystanders = len(active_seqs) - len(proposals)
        return proposals if expected >= bystanders else {}

    def _spec_width_for(self, proposals: Dict[int, np.ndarray]) -> int:
        """Smallest verify width (γ+1) covering the round's longest
        proposal: probe-only rounds run the narrow width."""
        longest = max(len(p) for p in proposals.values())
        for w in self._spec_widths:
            if w >= longest + 1:
                return w
        return self._spec_widths[-1]

    def _dispatch_verify(self, active_seqs: List[Sequence],
                         proposals: Dict[int, np.ndarray], s_len: int):
        """Stage and queue one verify round at the smallest rung covering
        the batch and width ``s_len`` (non-blocking). Per-request seeds
        do not reach spec rounds; greedy rows are unaffected. Returns
        ((emitted, n_accepted) on the device, {slot: n proposed},
        rung)."""
        gamma = s_len - 1
        b = self._rung_for_slots(active_seqs)
        self._note_rung(b)
        st, cap, act = self._spec_stage(active_seqs, b)
        drafts = np.zeros((b, gamma), np.int32)
        n_prop = np.zeros((b,), np.int32)
        for seq in active_seqs:
            prop = proposals.get(seq.slot)
            if prop is not None and prop.size:
                n = min(len(prop), gamma)
                drafts[seq.slot, :n] = prop[:n]
                n_prop[seq.slot] = n
        t0 = self._note_decode_entry(active_seqs)
        out = self._verify_fn(st, cap, act, drafts, n_prop)
        # The dispatch wall and the cache reads, for whichever caller
        # pushes this round's ledger record (after the fold, or at sync).
        self._last_verify_dt = self._note_decode_exit(t0, active_seqs)
        self._last_verify_kv_read = (
            sum(s.ctx_len for s in active_seqs) * s_len)
        self.spec_rounds_total += 1
        full = self.engine_cfg.num_speculative_tokens
        gammas = [s.spec_gamma if s.spec_gamma >= 0 else full
                  for s in active_seqs]
        self.telemetry.spec_gamma_g.set(sum(gammas) / len(gammas))
        return out, {s.slot: int(n_prop[s.slot]) for s in active_seqs}, b

    def _fold_spec_emissions(self, seqs: Dict[int, Sequence],
                             emit_by_slot: Dict[int, int],
                             prop_by_slot: Dict[int, int],
                             emitted: np.ndarray, n_acc: np.ndarray
                             ) -> Dict[int, List[int]]:
        """Fold one verify round's emissions into host state (the sync and
        the dispatch-ahead paths): emit caps truncate, EOS stops a lane
        mid-round, each lane's acceptance updates its adaptive γ. Lanes
        cancelled or preempted while the round was in flight are
        skipped."""
        result: Dict[int, List[int]] = {}
        for slot, seq in seqs.items():
            if seq.done or seq.slot != slot or self.slots[slot] is not seq:
                continue
            cap = emit_by_slot.get(slot, 0)
            got = self._fold_lane(seq, (int(t) for t in emitted[slot, :cap]))
            drafted = min(prop_by_slot.get(slot, 0), cap)
            accepted = min(int(n_acc[slot]), drafted)
            self.spec_drafted += drafted
            self.spec_accepted += accepted
            self._spec_update_adaptive(seq, drafted, accepted)
            if got:
                result[seq.request_id] = got
        self.telemetry.tokens_per_dispatch.observe(
            sum(len(t) for t in result.values()))
        return result

    def _ngram_active(self) -> List[Sequence]:
        """The lanes of the next n-gram round (ladder compacted, pressure
        preemptions done)."""
        self._compact_slots()
        active_seqs = self.active_sequences()
        if not active_seqs:
            return []
        active_seqs = self._preempt_for_pressure(
            active_seqs, self.engine_cfg.num_speculative_tokens + 1)
        return [s for s in active_seqs if not s.done and s.slot >= 0]

    def _ngram_decode_steps(self, max_steps: Optional[int] = None
                            ) -> Dict[int, List[int]]:
        """One synchronous n-gram round: propose (host numpy), verify and
        accept (one target forward at the current rung), fold. A round
        where no lane proposes runs the plain K-step call instead."""
        active_seqs = self._ngram_active()
        if not active_seqs:
            return {}
        proposals = self._gate_mixed_batch(
            active_seqs, self._ngram_proposals(active_seqs))
        if not proposals:
            self.spec_fallback_rounds += 1
            return self._plain_decode_steps(max_steps)
        s_len = self._spec_width_for(proposals)
        active_seqs, emit_by_slot = self._spec_grant(active_seqs, s_len,
                                                     max_steps)
        if not active_seqs:
            return {}
        (emitted, n_acc), prop_by_slot, rung = self._dispatch_verify(
            active_seqs, proposals, s_len)
        acc0 = self.spec_accepted
        result = self._fold_spec_emissions(
            {s.slot: s for s in active_seqs}, emit_by_slot, prop_by_slot,
            emitted.cpu().numpy(), n_acc.cpu().numpy())
        if self.telemetry.enabled:
            self._ledger_push(
                "spec_verify", rung=rung, slots=len(active_seqs),
                tokens=sum(len(t) for t in result.values()),
                device_s=self._last_verify_dt,
                kv_read=self._last_verify_kv_read,
                spec_accepted=self.spec_accepted - acc0)
        return result

    def _stage_ngram_call(self) -> Optional[dict]:
        """Stage one n-gram round without blocking, as a pipeline call:
        the host overlaps its device time with scheduler work and the
        next round's matching. A round with no proposals stages the plain
        K-step call. The caller guarantees the pipeline is empty
        (proposals need the previous round's accepted tokens)."""
        active_seqs = self._ngram_active()
        if not active_seqs:
            return None
        proposals = self._gate_mixed_batch(
            active_seqs, self._ngram_proposals(active_seqs))
        if not proposals:
            self.spec_fallback_rounds += 1
            return self._stage_decode_call()
        s_len = self._spec_width_for(proposals)
        active_seqs, emit_by_slot = self._spec_grant(active_seqs, s_len,
                                                     None)
        if not active_seqs:
            return None
        (emitted, n_acc), prop_by_slot, rung = self._dispatch_verify(
            active_seqs, proposals, s_len)
        (emitted_h, n_acc_h), event = self._to_host_async(emitted, n_acc)
        call = {"spec": True, "emitted": emitted_h, "n_accepted": n_acc_h,
                "event": event, "allowed": dict(emit_by_slot),
                "n_prop": prop_by_slot,
                "seqs": {s.slot: s for s in active_seqs},
                "rung": rung, "outs": None, "final": None,
                "final_window": None}
        if self.telemetry.enabled:
            # Stage-time fields ride on the call; the record is pushed at
            # sync with the dispatch + sync wall (_sync_spec_call).
            call["ledger"] = {
                "kind": "spec_verify", "rung": rung,
                "slots": len(active_seqs), "chunk_tokens": 0, "steps": 1,
                "dispatch_s": self._last_verify_dt,
                "staging_s": self._last_staging_s,
                "bubble_s": self._pending_bubble,
                "kv_read": self._last_verify_kv_read,
                "compile": self._last_compile_event}
            self._last_staging_s = 0.0
            self._pending_bubble = 0.0
            self._last_compile_event = False
        return call

    def _sync_spec_call(self, call: dict) -> Dict[int, List[int]]:
        """Wait for an in-flight verify round and fold its emissions (the
        _sync_oldest arm of ``spec`` calls)."""
        t0 = time.perf_counter()
        if call["event"] is not None:
            call["event"].synchronize()
        sync_dt = time.perf_counter() - t0
        if self.telemetry.enabled:
            self.telemetry.decode_sync_s.observe(sync_dt)
            for seq in call["seqs"].values():
                if (not seq.done and seq.slot >= 0
                        and self.slots[seq.slot] is seq):
                    seq.dispatch_wall_s += sync_dt
        # The wait was device time: the next bubble counts host work only.
        self._last_decode_end = (
            time.perf_counter()
            if any(s is not None and not s.done for s in self.slots)
            else None)
        acc0 = self.spec_accepted
        result = self._fold_spec_emissions(
            call["seqs"], call["allowed"], call["n_prop"],
            call["emitted"].numpy(), call["n_accepted"].numpy())
        led = call.get("ledger")
        if led is not None:
            self._push_staged(led, sum(len(t) for t in result.values()),
                              sync_dt, self.spec_accepted - acc0)
        return result

    def _ngram_steps_pipelined(self) -> Dict[int, List[int]]:
        """Dispatch-ahead step of n-gram speculation: sync the round in
        flight (its accepted tokens seed the next proposals; spec rounds
        cannot chain blind like plain decode carries), then stage the
        next one without blocking."""
        result: Dict[int, List[int]] = {}
        if self._inflight:
            for rid, toks in self._sync_oldest().items():
                result.setdefault(rid, []).extend(toks)
        call = self._stage_ngram_call()
        if call is not None:
            self._inflight.append(call)
        return result

    # ------------------------------------------------------------------

    def _note_decode_entry(self, active_seqs: List[Sequence]) -> float:
        """Observe the host bubble since the last decode call ended (while
        the decode streak lasts; the step ledger's bubble_s), accrue it to
        the lanes of this call, and return the call's start."""
        now = time.perf_counter()
        self._pending_bubble = 0.0
        if self._last_decode_end is not None and self.telemetry.enabled:
            gap = now - self._last_decode_end
            self.telemetry.dispatch_bubble_s.observe(gap)
            self._pending_bubble = gap
            for seq in active_seqs:
                seq.bubble_s += gap
        return now

    def _note_decode_exit(self, t0: float,
                          active_seqs: List[Sequence]) -> float:
        """Observe one decode call's host wall, accrue it to the call's
        lanes, and return it."""
        now = time.perf_counter()
        dt = now - t0
        if self.telemetry.enabled:
            self.telemetry.decode_dispatch_s.observe(dt)
            self.telemetry.decode_dispatches.inc()
            for seq in active_seqs:
                seq.dispatch_wall_s += dt
        self._last_decode_end = (
            now if any(s is not None and not s.done for s in self.slots)
            else None)
        return dt

    def _ledger_push(self, kind: str, *, rung: int, slots: int,
                     tokens: int, chunk_tokens: int = 0, steps: int = 1,
                     device_s: float = 0.0, kv_read: int = 0,
                     spec_accepted: int = 0,
                     staging_s: Optional[float] = None,
                     bubble_s: Optional[float] = None,
                     compile_event: Optional[bool] = None) -> None:
        """Push one dispatch's record into the step ledger, with the
        staged bubble and staging walls (unless the caller captured them
        at stage time: pipelined calls push at sync, when the scratch
        belongs to a newer dispatch) and the KV-swap bytes since the
        previous record. Callers push only while telemetry is on (the
        swap counters are NULL_METRIC otherwise).

        compile_event marks the first dispatch of a rung, prefill bucket
        or hybrid bucket, the reference's rule. Eager PyTorch compiles
        nothing; on the card it marks the first launch of that shape,
        where cuBLAS picks its kernels and the caching allocator grows."""
        tel = self.telemetry
        swap_total = (tel.kv_offload_bytes.value
                      + tel.kv_restore_bytes.value)
        swap = max(0.0, swap_total - self._last_swap_bytes_total)
        self._last_swap_bytes_total = swap_total
        if staging_s is None:
            staging_s = self._last_staging_s
            self._last_staging_s = 0.0
        if bubble_s is None:
            bubble_s = self._pending_bubble
            self._pending_bubble = 0.0
        if compile_event is None:
            compile_event = self._last_compile_event
            self._last_compile_event = False
        tel.step_ledger.push(
            kind, rung, slots, tokens, chunk_tokens, steps, device_s,
            staging_s, bubble_s, kv_read, swap, spec_accepted,
            compile_event)

    def _push_staged(self, led: dict, tokens: int, sync_dt: float,
                     spec_accepted: int = 0) -> None:
        """A pipelined call's record, pushed at its sync: the fields
        captured at stage time (``led``) with device_s = the dispatch
        wall + the sync wall."""
        self._ledger_push(
            led["kind"], rung=led["rung"], slots=led["slots"],
            tokens=tokens, chunk_tokens=led["chunk_tokens"],
            steps=led["steps"], device_s=led["dispatch_s"] + sync_dt,
            kv_read=led["kv_read"], staging_s=led["staging_s"],
            bubble_s=led["bubble_s"], compile_event=led["compile"],
            spec_accepted=spec_accepted)

    def check_pool_clean(self) -> None:
        """The page-leak invariant, for tests and chip_smoke.py: with no
        call in flight and every request finished, the host tier's books
        agree with its entries (no digest in both tiers), and once the
        prefix cache drops its references every page is free with no
        refcount and no slot is bound. Clears the prefix cache; raises
        AssertionError naming what leaked. Disarms chaos page pressure
        first."""
        assert not self._inflight, \
            "dispatch-ahead calls still in flight; drain before checking"
        assert not self._preempted_out, \
            "preempted sequences never collected (take_preempted)"
        self.set_page_pressure(0)
        cache = self.prefix_cache
        if cache is not None and cache.host_pool is not None:
            pool = cache.host_pool
            assert pool.used == len(cache._host), (
                f"host-tier page accounting drifted: pool says {pool.used},"
                f" table holds {len(cache._host)}")
            assert pool.bytes_resident == sum(
                e.nbytes for e in cache._host.values()), \
                "host-tier byte accounting drifted"
            assert 0 <= pool.used <= pool.capacity, (
                f"host pool over capacity: {pool.used}/{pool.capacity}")
            overlap = set(cache._host) & set(cache._table)
            assert not overlap, \
                f"digests resident in BOTH tiers: {len(overlap)}"
        if cache is not None:
            cache.clear()
            if cache.host_pool is not None:
                assert cache.host_pool.used == 0, \
                    "host pool pages leaked after clear"
                assert cache.host_pool.bytes_resident == 0, \
                    "host pool bytes leaked after clear"
        alloc = self.allocator
        expected = alloc.num_pages - 1          # page 0 = trash page
        leaked = [p for p in range(1, alloc.num_pages) if alloc._refs[p] > 0]
        assert alloc.num_free == expected, (
            f"KV page leak: {expected - alloc.num_free} pages never freed "
            f"(refs held on pages {leaked[:16]})")
        assert not leaked, f"pages with stale refcounts: {leaked[:16]}"
        assert alloc.evictable_count == 0, (
            f"evictable counter drifted: {alloc.evictable_count} after "
            "clear")
        bound = [i for i, s in enumerate(self.slots) if s is not None]
        assert not bound, f"decode slots still bound after drain: {bound}"

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 temperature: float = 0.0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Generate for a batch of token-id prompts; returns generated ids."""
        seqs = [Sequence(request_id=i, prompt_tokens=list(p),
                         max_new_tokens=max_new_tokens,
                         temperature=temperature, top_p=top_p,
                         eos_token_id=eos_token_id)
                for i, p in enumerate(prompts)]
        for s in seqs:
            if not self.can_ever_admit(s):
                raise ValueError(
                    f"request {s.request_id} needs {self._pages_reserved(s)}"
                    f" pages; pool holds {self.engine_cfg.num_pages - 1}")
        results: Dict[int, List[int]] = {}
        pending = list(seqs)
        while pending or self.active_sequences():
            while pending and self.free_slots() and self.can_admit(pending[0]):
                self.prefill(pending.pop(0))
            self.decode_steps()
            # Optimistic admission may have preempted sequences: requeue
            # them at the head for recompute-resume.
            pending[0:0] = self.take_preempted()
            for s in [s for s in self.slots if s is not None and s.done]:
                results[s.request_id] = s.generated
                self.release(s)
        return [results[i] for i in range(len(seqs))]


def _chunk_kv_read(c, offset):
    """(query, context token) pairs a causal chunk of ``c`` tokens at
    ``offset`` attends: each query reads the cache before it and the
    chunk up to itself (the step ledger's kv_read; numpy arrays
    elementwise)."""
    return c * offset + c * (c + 1) // 2


def _named_leaves(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, paths spelled as the reference's
    ``jax.tree_util.keystr`` (``['blocks']['wq'].scale``); a quantized
    leaf gives its codes and its scales."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{path}['{k}']")]
    if isinstance(tree, QuantizedArray):
        return [(f"{path}.q", tree.q), (f"{path}.scale", tree.scale)]
    return [(path, tree)]


def _leaves(tree) -> List[torch.Tensor]:
    return [t for _, t in _named_leaves(tree)]
