"""The inference engine: bucketed prefill + K-step batched decode.

Twin of ``tpu_inference/engine/engine.py`` cut to the default one-card
path, in eager PyTorch:

- **Prefill** runs one [P, S_bucket] forward for up to
  ``max_prefill_batch`` same-bucket prompts (dummy lanes write only the
  trash page); prompts longer than the chunk cap prefill chunk by chunk
  (``prefill_begin``/``prefill_step``), each chunk attending to itself
  plus every cached token.
- **Decode** runs K steps per call with the sampled tokens fed back on
  the device and ONE host sync per call (the [K, B] token block); the
  scheduler's latency mode runs the K=1 route.
- Attention goes through ``make_paged_attn``: K/V are written into the
  paged pool first, then the Hopper kernels (``"kernel"``; their plain
  versions for CPU tensors) or the dense gather path (``"dense"``) read
  them back.
- The pool is updated in place (engine/kv_cache.py write_kv), which is
  what the reference's buffer donation achieves under XLA.
- ``EngineConfig.quant`` stores the matmul weights as int8 or int4 codes
  with scales (models/quant.py); ``kv_quant`` makes the pool int8 or
  packed int4 with per-(token, head) scales, which both kernels
  dequantize as they load each page. The reference's boot gate for int4
  KV on a TPU (``int4_mosaic_validated``, which reads records of Mosaic
  validation runs) has no counterpart: on the card, chip_smoke.py holds
  the int4 variants of both kernels against their plain versions on
  every run.

Index ranges the reference gets for free from XLA's clamping gathers
are kept in range explicitly: positions clamp at ``max_context - 1``
before they pick a block-table column, embedding ids clamp into the
table (inactive lanes carry stale ids), and the kernels bounds-check
page ids.

Features outside this slice raise ``NotImplementedError`` naming their
ROADMAP item (``_UNPORTED``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import EngineConfig, ModelConfig
from tpu_inference_torch.engine import kv_cache as kvc
from tpu_inference_torch.engine.kv_cache import PageAllocator
from tpu_inference_torch.engine.prefix_cache import PrefixCache, _chain_hashes
from tpu_inference_torch.engine.sampling import (
    PENALTY_WINDOW,
    SamplingParams,
    roll_window,
    sample,
)
from tpu_inference_torch.models.common import dense_causal_attention
from tpu_inference_torch.models.quant import QuantizedArray, quantize_params
from tpu_inference_torch.models.registry import build_model, get_model_fns

# EngineConfig fields this slice does not serve: a value other than the
# default raises NotImplementedError naming the ROADMAP item.
_UNPORTED = {
    "decode_ladder": "1.13 (engine breadth: decode batch ladder)",
    "ladder_admit_headroom_pages": "1.13 (engine breadth: decode batch "
                                   "ladder)",
    "decode_pipeline_depth": "1.13 (engine breadth: dispatch-ahead "
                             "pipeline)",
    "hybrid_prefill": "1.13 (engine breadth: hybrid prefill-decode steps)",
    "step_token_budget": "1.13 (engine breadth: hybrid prefill-decode "
                         "steps)",
    "num_speculative_tokens": "1.13 (engine breadth: speculative decoding)",
    "spec_mode": "1.13 (engine breadth: speculative decoding)",
    "host_cache_pages": "1.13 (engine breadth: host KV tier)",
    "admission": "1.13 (engine breadth: preemption and optimistic "
                 "admission)",
    "chaos_page_pressure": "1.13 (engine breadth: fault injection)",
    "chaos_step_failure_rate": "1.13 (engine breadth: fault injection)",
    "chaos_step_wedge_s": "1.13 (engine breadth: fault injection)",
    "slo_ttft_ms": "1.18 (observability: SLO gauges)",
    "slo_tpot_ms": "1.18 (observability: SLO gauges)",
    "role": "1.15 (process fleet: P/D worker roles)",
}


def check_engine_config(engine_cfg: EngineConfig) -> None:
    """Raise NotImplementedError for any knob this slice does not serve."""
    default = EngineConfig()
    for name, item in _UNPORTED.items():
        value = getattr(engine_cfg, name)
        if value != getattr(default, name):
            raise NotImplementedError(
                f"EngineConfig.{name}={value!r} is not ported yet (ROADMAP "
                f"{item}); the port serves the default")


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
    ctx_len: int = 0                       # tokens currently in KV
    # SWA eviction cursor: pages[:evicted_pages] are behind the window,
    # freed, and replaced by the trash page in the block table.
    evicted_pages: int = 0
    cached_tokens: int = 0                 # prefix-cache hit length
    prefix_digests: Optional[List[bytes]] = None
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
    trace_id: str = ""
    priority_class: str = "interactive"

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.prompt_tokens[-1]


class InferenceEngine:
    """Owns device state (params, KV pool) and the prefill/decode steps."""

    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[dict] = None, seed: int = 0,
                 attn_backend: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        model_cfg.validate()
        check_engine_config(engine_cfg)
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
        self.telemetry = telemetry.EngineTelemetry(self)
        # perf_counter at the end of the last decode call; None when the
        # decode streak broke (idle or an interleaved prefill).
        self._last_decode_end: Optional[float] = None
        self.admission = engine_cfg.admission
        # The window only binds when the serving context can exceed it.
        swa_binds = bool(model_cfg.sliding_window) and (
            engine_cfg.max_context > model_cfg.sliding_window)
        self.prefix_cache: Optional[PrefixCache] = None
        if engine_cfg.enable_prefix_cache and not swa_binds:
            # SWA models run without the prefix cache (as the reference):
            # behind-window pages are evicted while a sequence runs.
            self.prefix_cache = PrefixCache(self.allocator,
                                            engine_cfg.page_size)
            self.prefix_cache.bind_telemetry(self.telemetry)
        self.swa_evict = swa_binds and self.prefix_cache is None
        self.max_pages = engine_cfg.max_pages_per_seq
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self.slots: List[Optional[Sequence]] = [None] * engine_cfg.max_batch_size
        self._prefill_batch_sizes = sorted(
            {1, max(1, engine_cfg.max_prefill_batch)})

    # ------------------------------------------------------------------
    # Device steps
    # ------------------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _sampling(self, temps, top_ps, top_ks, seeds) -> SamplingParams:
        return SamplingParams(temperature=self._to_device(temps),
                              top_p=self._to_device(top_ps),
                              top_k=self._to_device(top_ks),
                              seed=np.asarray(seeds))

    @torch.no_grad()
    def _prefill_fn(self, tokens: np.ndarray, prompt_len: np.ndarray,
                    prefix_len: np.ndarray, block_table: np.ndarray,
                    temps, top_ps, top_ks, seeds, rpens, rlasts,
                    window: np.ndarray) -> torch.Tensor:
        """Lanes [P, S_bucket] right-padded; lane i's new tokens occupy
        positions [prefix_len[i], prefix_len[i] + prompt_len[i]). Returns
        the sampled first tokens [P] int32 on the device."""
        cfg, ecfg, dev = self.model_cfg, self.engine_cfg, self.device
        toks = self._to_device(tokens)
        plen = self._to_device(prompt_len)
        pref = self._to_device(prefix_len)
        bts = self._to_device(block_table)
        s = tokens.shape[1]
        ar = torch.arange(s, device=dev, dtype=torch.int32)[None, :]
        positions = (pref[:, None] + ar).clamp(max=ecfg.max_context - 1)
        valid = ar < plen[:, None]
        total_len = pref + plen
        attn = make_paged_attn(cfg, ecfg.page_size, bts, positions, valid,
                               q_offset=pref, kv_len=total_len,
                               attn_backend=self.attn_backend)
        hidden, self.kv = self.mod.forward_hidden(self.params, cfg, toks,
                                                  positions, self.kv, attn)
        lanes = torch.arange(hidden.shape[0], device=dev)
        last = hidden[lanes, (plen - 1).long()]                 # [P, D]
        logits = self.mod.unembed(self.params, cfg, last)       # [P, V]
        use_pen = bool(np.any(np.asarray(rpens) != 1.0))
        return sample(logits, self._sampling(temps, top_ps, top_ks, seeds),
                      self._generator, ctx=(prefix_len + prompt_len),
                      all_greedy=bool(np.all(np.asarray(temps) <= 0.0)),
                      penalty_window=self._to_device(window) if use_pen
                      else None,
                      repeat_penalty=self._to_device(rpens),
                      repeat_last_n=self._to_device(rlasts))

    @torch.no_grad()
    def _decode_multi_fn(self, tokens, ctx_lens, block_tables, allowed,
                         eos_ids, temps, top_ps, top_ks, seeds, rpens,
                         rlasts, window, k_steps: int) -> torch.Tensor:
        """K decode steps under one call, tokens fed back on the device.

        Host arrays in, [B] each (window [B, W]); ``allowed`` is the steps
        each slot may advance (budget, context cap and page headroom
        folded in). Returns [K, B] int32 on the device, -1 where a slot
        produced nothing; the caller syncs once for the whole block.
        """
        cfg, ecfg = self.model_cfg, self.engine_cfg
        tok = self._to_device(tokens)
        ctx = self._to_device(ctx_lens)
        bts = self._to_device(block_tables)
        allow = self._to_device(allowed)
        eos = self._to_device(eos_ids)
        sp = self._sampling(temps, top_ps, top_ks, seeds)
        all_greedy = bool(np.all(np.asarray(temps) <= 0.0))
        use_pen = bool(np.any(np.asarray(rpens) != 1.0))
        win = self._to_device(window) if use_pen else None
        rpen, rlast = self._to_device(rpens), self._to_device(rlasts)
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
                         ctx=np.asarray(ctx_lens) + s + 1,
                         all_greedy=all_greedy, penalty_window=win,
                         repeat_penalty=rpen, repeat_last_n=rlast)
            new = torch.where(act, new, tok)
            if use_pen:
                win = roll_window(win, new, act)
            outs.append(torch.where(act, new, torch.full_like(new, -1)))
            alive = alive & ((new != eos) | ~act)
            ctx = ctx + act.int()
            tok = new
        return torch.stack(outs)

    def warmup(self) -> float:
        """Build and load the kernels (CUDA, kernel backend), then run one
        prefill and one decode step whose writes land on the trash page.
        Returns seconds spent."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self.attn_backend == "kernel":
            from tpu_inference_torch.kernels import build_kernels
            build_kernels()
        ecfg = self.engine_cfg
        one = np.ones((1,), np.int32)
        zero = np.zeros((1,), np.int32)
        self._prefill_fn(
            np.zeros((1, ecfg.prefill_buckets[0]), np.int32), one, zero,
            np.zeros((1, self.max_pages), np.int32),
            np.zeros((1,), np.float32), np.ones((1,), np.float32), zero,
            np.full((1,), -1, np.int64), np.ones((1,), np.float32), zero,
            np.full((1, PENALTY_WINDOW), -1, np.int32))
        b = ecfg.max_batch_size
        zb = np.zeros((b,), np.int32)
        self._decode_multi_fn(
            zb, zb, np.zeros((b, self.max_pages), np.int32), zb,
            np.full((b,), -1, np.int32), np.zeros((b,), np.float32),
            np.ones((b,), np.float32), zb, np.full((b,), -1, np.int64),
            np.ones((b,), np.float32), zb,
            np.full((b, PENALTY_WINDOW), -1, np.int32), k_steps=1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Host-side orchestration
    # ------------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _pages_reserved(self, seq: Sequence) -> int:
        """Worst-case page need for admission control (capped at the
        per-sequence maximum). With behind-window eviction, live pages
        peak at the prompt during prefill, then hold the window's span."""
        ecfg = self.engine_cfg
        total = len(seq.prompt_tokens) + seq.max_new_tokens
        need = kvc.pages_needed(total, ecfg.page_size)
        if self.swa_evict:
            ahead = ecfg.decode_steps_per_call
            window_span = -(-(self.model_cfg.sliding_window + ahead)
                            // ecfg.page_size) + 2
            peak = min(len(seq.prompt_tokens), ecfg.max_context)
            transient = kvc.pages_needed(
                min(peak + ahead, ecfg.max_context), ecfg.page_size)
            need = min(need, max(window_span, transient))
        return min(need, self.max_pages)

    def _free_plus_evictable(self) -> int:
        n = self.allocator.num_free
        if self.prefix_cache is not None:
            n += self.prefix_cache.evictable
        return n

    @property
    def pool_pressure(self) -> float:
        """1 - (free+evictable)/total: 0 = fully reclaimable."""
        total = self.engine_cfg.num_pages - 1
        return 1.0 - self._free_plus_evictable() / max(total, 1)

    def _allocate_reclaiming(self, n: int) -> List[int]:
        """Allocate n pages, evicting LRU prefix-cache pages on pressure."""
        short = n - self.allocator.num_free
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.allocator.allocate(n)

    def _grant_decode_steps(self, seq: Sequence, k_steps: int) -> int:
        """Steps this lane may advance in one call (generation budget,
        context cap, KV-page headroom); allocates the pages it needs."""
        ecfg = self.engine_cfg
        ctx = seq.ctx_len
        budget = seq.max_new_tokens - len(seq.generated)
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
            self._free_plus_evictable() >= self._pages_reserved(seq))

    def can_ever_admit(self, seq: Sequence) -> bool:
        """False if the request exceeds the pool even when fully idle."""
        return self._pages_reserved(seq) <= self.engine_cfg.num_pages - 1

    def _block_table_array(self, pages: List[int]) -> np.ndarray:
        bt = np.zeros((self.max_pages,), np.int32)
        bt[:len(pages)] = pages
        return bt

    def _seq_digests(self, seq: Sequence, prompt: List[int]) -> List[bytes]:
        if seq.prefix_digests is None:
            seq.prefix_digests = _chain_hashes(prompt,
                                               self.engine_cfg.page_size)
        return seq.prefix_digests

    def _prefill_setup(self, seq: Sequence, slot: int) -> List[int]:
        """Allocate pages (with prefix-cache reuse), bind the slot, and
        return the (possibly truncated) prompt to prefill."""
        ecfg = self.engine_cfg
        # Keep the most recent tokens of over-long prompts (room for at
        # least one generated token).
        prompt = seq.prompt_tokens[-(ecfg.max_context - 1):]
        shared: List[int] = []
        if self.prefix_cache is not None:
            # Always recompute the final prompt token: its logits seed
            # the first sampled token.
            shared, seq.cached_tokens = self.prefix_cache.lookup(
                prompt, max_tokens=len(prompt) - 1,
                digests=self._seq_digests(seq, prompt))
        n_new = kvc.pages_needed(len(prompt), ecfg.page_size) - len(shared)
        try:
            seq.pages = shared + self._allocate_reclaiming(n_new)
        except MemoryError:
            self.allocator.free(shared)
            raise
        seq.slot = slot
        seq.prefill_start = time.perf_counter()
        return prompt

    def _prefill_finish(self, seq: Sequence, prompt: List[int],
                        first: int) -> None:
        seq.ctx_len = len(prompt)
        seq.generated.append(first)
        if seq.first_token_time == 0.0:
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

    @staticmethod
    def _penalty_arrays(seq: Sequence) -> Tuple[float, int]:
        """(repeat_penalty, repeat_last_n): last_n < 0 = whole context,
        clamped to the static window; 0 disables."""
        rlast = int(seq.repeat_last_n)
        if rlast < 0:
            rlast = PENALTY_WINDOW
        return float(seq.repeat_penalty), min(rlast, PENALTY_WINDOW)

    @staticmethod
    def _penalty_window_row(seq: Sequence) -> np.ndarray:
        """Last W known tokens, newest at the high end, -1 padded."""
        row = np.full((PENALTY_WINDOW,), -1, np.int32)
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
             "window": np.full((n, PENALTY_WINDOW), -1, np.int64)}
        for i, seq in lanes:
            a["temps"][i] = seq.temperature
            a["top_ps"][i] = seq.top_p
            a["top_ks"][i], a["seeds"][i] = self._sampling_arrays(seq)
            a["rpens"][i], a["rlasts"][i] = self._penalty_arrays(seq)
            if a["rpens"][i] != 1.0:
                a["window"][i] = self._penalty_window_row(seq)
        return a

    def _run_prefill(self, seqs: List[Sequence], tokens: np.ndarray,
                     prompt_len: np.ndarray, prefix_len: np.ndarray,
                     bts: np.ndarray) -> np.ndarray:
        """One prefill dispatch with telemetry; returns the sampled tokens
        [P] on the host."""
        a = self._lane_arrays(list(enumerate(seqs)), tokens.shape[0])
        t0 = time.perf_counter()
        self._last_decode_end = None     # prefill breaks the decode streak
        tok = self._prefill_fn(tokens, prompt_len, prefix_len, bts,
                               a["temps"], a["top_ps"], a["top_ks"],
                               a["seeds"], a["rpens"], a["rlasts"],
                               a["window"])
        out = tok.cpu().numpy()
        dt = time.perf_counter() - t0
        self.telemetry.prefill_dispatch_s.observe(dt)
        self.telemetry.prefill_dispatches.inc()
        return out

    def _prefill_one_chunk(self, seq: Sequence, prompt: List[int],
                           offset: int) -> Tuple[int, int]:
        """Run one prefill chunk at ``offset``; returns (next_offset,
        sampled token)."""
        ecfg = self.engine_cfg
        chunk = prompt[offset:offset + ecfg.chunk_tokens_cap]
        toks = np.zeros((1, ecfg.bucket_for(len(chunk))), np.int32)
        toks[0, :len(chunk)] = chunk
        out = self._run_prefill(
            [seq], toks, np.asarray([len(chunk)], np.int32),
            np.asarray([offset], np.int32),
            self._block_table_array(seq.pages)[None])
        return offset + len(chunk), int(out[0])

    def _prefill_chunked(self, seq: Sequence, prompt: List[int]) -> None:
        """Serial one-lane prefill, chunked past the largest bucket; only
        the final chunk's sampled token is kept."""
        offset, tok = seq.cached_tokens, -1
        while offset < len(prompt):
            offset, tok = self._prefill_one_chunk(seq, prompt, offset)
        self._prefill_finish(seq, prompt, tok)

    def prefill_begin(self, seq: Sequence, slot: Optional[int] = None) -> int:
        """Set up an incremental prefill; drive it with prefill_step().
        The slot binds here, so admission between chunks cannot hand it
        out twice; active_sequences() skips mid-prefill slots."""
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
        """One multi-lane prefill dispatch: P sequences, same bucket. Lanes
        pad to a batch size of the set; dummy lanes carry prompt_len=1
        and an all-zero block table, so their one write lands on the
        trash page and their token is discarded."""
        p = next(s for s in self._prefill_batch_sizes if s >= len(group))
        toks = np.zeros((p, bucket), np.int32)
        plen = np.ones((p,), np.int32)
        pref = np.zeros((p,), np.int32)
        bts = np.zeros((p, self.max_pages), np.int32)
        for i, (seq, prompt) in enumerate(group):
            chunk = prompt[seq.cached_tokens:]
            toks[i, :len(chunk)] = chunk
            plen[i] = len(chunk)
            pref[i] = seq.cached_tokens
            bts[i] = self._block_table_array(seq.pages)
        out = self._run_prefill([s for s, _ in group], toks, plen, pref, bts)
        for i, (seq, prompt) in enumerate(group):
            self._prefill_finish(seq, prompt, int(out[i]))

    def prefill_many(self, seqs: List[Sequence]) -> None:
        """Admit several sequences, batching same-bucket single-chunk
        prefills into one [P, S] dispatch; multi-chunk prompts run the
        serial chunked path."""
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
        them: the kernels' page walks start at the window's first page,
        and the dense path gathers then masks."""
        win = self.model_cfg.sliding_window
        first_needed = max(0, seq.ctx_len - win) // self.engine_cfg.page_size
        j = seq.evicted_pages
        while j < min(first_needed, len(seq.pages)):
            if seq.pages[j]:
                self.allocator.free([seq.pages[j]])
                seq.pages[j] = 0
            j += 1
        seq.evicted_pages = j

    def _publish_to_cache(self, seq: Sequence) -> None:
        """Publish a sequence's full pages (prompt + generated history) to
        the prefix cache, so a follow-up turn reuses them."""
        if self.prefix_cache is None or not seq.pages:
            return
        base = seq.prompt_tokens[-(self.engine_cfg.max_context - 1):]
        # The just-sampled token is not in KV yet.
        in_kv = base + seq.generated[:-1]
        self.prefix_cache.insert(in_kv[:seq.ctx_len], seq.pages,
                                 digests=seq.prefix_digests)

    def release(self, seq: Sequence) -> None:
        """Free a finished sequence's pages and slot, publishing its full
        pages to the prefix cache first."""
        self._publish_to_cache(seq)
        self.allocator.free(seq.pages)
        seq.pages = []
        seq.prefill_prompt = None          # cancel/error mid-prefill
        if seq.slot >= 0 and self.slots[seq.slot] is seq:
            self.slots[seq.slot] = None

    def active_sequences(self) -> List[Sequence]:
        """Sequences decode may advance: bound, unfinished, not mid-prefill."""
        return [s for s in self.slots
                if s is not None and not s.done and s.prefill_prompt is None]

    def decode_steps(self, max_steps: Optional[int] = None
                     ) -> Dict[int, List[int]]:
        """Up to ``decode_steps_per_call`` decode steps in ONE call with one
        host sync. Returns {request_id: [tokens, in order]}. ``max_steps``
        caps every lane (1 = the latency route)."""
        ecfg = self.engine_cfg
        k_steps = max(1, ecfg.decode_steps_per_call)
        if max_steps is not None:
            k_steps = min(k_steps, max_steps)
        allowed_by_slot: Dict[int, int] = {}
        for seq in self.active_sequences():
            steps = self._grant_decode_steps(seq, k_steps)
            if steps <= 0:
                # Reserve-mode admission makes a starved lane exceptional.
                seq.done, seq.finish_reason = True, "oom"
                seq.finish_time = time.perf_counter()
                continue
            allowed_by_slot[seq.slot] = steps
        active = [s for s in self.active_sequences()
                  if s.slot in allowed_by_slot]
        if not active:
            return {}
        b = ecfg.max_batch_size
        tokens = np.zeros((b,), np.int32)
        ctx_lens = np.zeros((b,), np.int32)
        bts = np.zeros((b, self.max_pages), np.int32)
        allowed = np.zeros((b,), np.int32)
        eos_ids = np.full((b,), -1, np.int32)
        for seq in active:
            i = seq.slot
            tokens[i] = seq.last_token
            ctx_lens[i] = seq.ctx_len
            bts[i] = self._block_table_array(seq.pages)
            allowed[i] = allowed_by_slot[i]
            if seq.eos_token_id is not None:
                eos_ids[i] = seq.eos_token_id
        a = self._lane_arrays([(s.slot, s) for s in active], b)
        t0 = self._note_decode_entry()
        outs = self._decode_multi_fn(
            tokens, ctx_lens, bts, allowed, eos_ids, a["temps"],
            a["top_ps"], a["top_ks"], a["seeds"], a["rpens"], a["rlasts"],
            a["window"], k_steps=k_steps)
        outs = outs.cpu().numpy()                      # [K, B]: one sync
        self._note_decode_exit(t0)
        result: Dict[int, List[int]] = {}
        for seq in active:
            got = self._fold_lane(seq, (int(outs[s, seq.slot])
                                        for s in range(k_steps)))
            if got:
                result[seq.request_id] = got
        self.telemetry.tokens_per_dispatch.observe(
            sum(len(t) for t in result.values()))
        return result

    def decode_steps_pipelined(self) -> Dict[int, List[int]]:
        """The scheduler's throughput route. Dispatch-ahead depth is 1 in
        this slice (deeper pipelines raise at construction, ROADMAP
        1.13), where the reference's pipelined step is decode_steps."""
        return self.decode_steps()

    def _note_decode_entry(self) -> float:
        now = time.perf_counter()
        if self._last_decode_end is not None:
            self.telemetry.dispatch_bubble_s.observe(
                now - self._last_decode_end)
        return now

    def _note_decode_exit(self, t0: float) -> None:
        now = time.perf_counter()
        self.telemetry.decode_dispatch_s.observe(now - t0)
        self.telemetry.decode_dispatches.inc()
        self._last_decode_end = (
            now if any(s is not None and not s.done for s in self.slots)
            else None)

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
            for s in [s for s in self.slots if s is not None and s.done]:
                results[s.request_id] = s.generated
                self.release(s)
        return [results[i] for i in range(len(seqs))]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, QuantizedArray):
        return [tree.q, tree.scale]
    return [tree]
