"""Typed configuration for models, engine, parallelism, and server.

Twin of ``tpu_inference/config.py`` with ``ModelConfig.dtype`` as a
``torch.dtype``. Every dataclass keeps the reference's field names and
defaults, so one config dict (``framework_config_to_dict``) boots either
package: the dtype travels by name, and the reference's
``attn_backend="pallas"`` reads here as ``"kernel"`` (the hand-written
Hopper kernels).

Fields the port does not serve yet are still accepted here, so a
reference config parses; the server raises ``NotImplementedError``
naming the ROADMAP item when a non-default value asks for one of them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3.1 "llama3" rope frequency rescale (static, per-channel):
    long-wavelength channels divide their frequency by ``factor``, short
    ones keep it, the band between interpolates (models/common.py
    rope_frequencies)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_len: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for a decoder-only transformer."""

    name: str = "llama"
    family: str = "llama"  # "llama" | "mixtral" | "gpt2"
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_experts: int = 0
    n_experts_per_tok: int = 2
    expert_capacity_factor: float = 2.0
    # Sliding-window attention (Mistral): each token attends to itself
    # and the window-1 tokens before it. 0 = full causal attention.
    sliding_window: int = 0
    use_learned_pos: bool = False
    use_bias: bool = False
    # Qwen2: bias terms on the q/k/v projections only.
    qkv_bias: bool = False
    # Gemma: RMSNorm weights stored as offsets from 1 (applied in f32).
    norm_offset: float = 0.0
    # FFN gate activation: "silu" (Llama/Qwen) | "gelu_tanh" (Gemma).
    hidden_act: str = "silu"
    # Gemma scales token embeddings by sqrt(d_model) in cfg.dtype.
    embed_scale: bool = False
    # Decoupled head_dim (Gemma-7B); 0 = d_model // n_heads.
    head_dim_override: int = 0
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def n_rep(self) -> int:
        """Query heads per KV head (GQA group size)."""
        return self.n_heads // self.n_kv_heads

    def validate(self) -> None:
        if not self.head_dim_override and self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not divisible by "
                             f"n_kv_heads {self.n_kv_heads}")
        if self.n_experts and self.n_experts_per_tok > self.n_experts:
            raise ValueError("n_experts_per_tok exceeds n_experts")


# ---------------------------------------------------------------------------
# Presets (the reference's, one for one). Tiny variants are for tests.
# ---------------------------------------------------------------------------

def llama3_8b() -> ModelConfig:
    return ModelConfig(
        name="llama-3-8b", family="llama", vocab_size=128256, d_model=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_seq_len=8192, rope_theta=500000.0,
    )


def llama3_70b() -> ModelConfig:
    return ModelConfig(
        name="llama-3-70b", family="llama", vocab_size=128256, d_model=8192,
        n_layers=80, n_heads=64, n_kv_heads=8, d_ff=28672,
        max_seq_len=8192, rope_theta=500000.0,
    )


def llama31_8b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.1-8b", family="llama", vocab_size=128256, d_model=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_seq_len=131072, rope_theta=500000.0, rope_scaling=RopeScaling(),
    )


def mixtral_8x7b() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="mixtral", vocab_size=32000, d_model=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_seq_len=8192, rope_theta=1000000.0, n_experts=8,
        n_experts_per_tok=2,
    )


def mistral_7b() -> ModelConfig:
    return ModelConfig(
        name="mistral-7b", family="llama", vocab_size=32000, d_model=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
        max_seq_len=8192, rope_theta=10000.0, sliding_window=4096,
    )


def qwen2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="llama", vocab_size=152064, d_model=3584,
        n_layers=28, n_heads=28, n_kv_heads=4, d_ff=18944,
        max_seq_len=8192, rope_theta=1000000.0, norm_eps=1e-6,
        qkv_bias=True,
    )


def phi3_mini() -> ModelConfig:
    return ModelConfig(
        name="phi-3-mini", family="llama", vocab_size=32064, d_model=3072,
        n_layers=32, n_heads=32, n_kv_heads=32, d_ff=8192,
        max_seq_len=4096, rope_theta=10000.0, sliding_window=2047,
    )


def gemma_7b() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="llama", vocab_size=256000, d_model=3072,
        n_layers=28, n_heads=16, n_kv_heads=16, d_ff=24576,
        max_seq_len=8192, rope_theta=10000.0, norm_eps=1e-6,
        tie_embeddings=True, norm_offset=1.0, hidden_act="gelu_tanh",
        embed_scale=True, head_dim_override=256,
    )


def gpt2_small() -> ModelConfig:
    return ModelConfig(
        name="gpt2", family="gpt2", vocab_size=50257, d_model=768,
        n_layers=12, n_heads=12, n_kv_heads=12, d_ff=3072,
        max_seq_len=1024, norm_eps=1e-5, use_learned_pos=True, use_bias=True,
        tie_embeddings=True,
    )


def tiny_llama(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="tiny-llama", family="llama", vocab_size=vocab_size, d_model=128,
        n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=1024,
        rope_theta=10000.0, dtype=torch.float32,
    )


def tiny_llama_fatkv(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="tiny-llama-fatkv", family="llama", vocab_size=vocab_size,
        d_model=128, n_layers=4, n_heads=8, n_kv_heads=8, d_ff=256,
        max_seq_len=1024, rope_theta=10000.0, head_dim_override=64,
        dtype=torch.float32,
    )


def tiny_mixtral(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="tiny-mixtral", family="mixtral", vocab_size=vocab_size,
        d_model=128, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256,
        max_seq_len=1024, rope_theta=10000.0, n_experts=4,
        n_experts_per_tok=2, dtype=torch.float32,
    )


def tiny_mistral(vocab_size: int = 512) -> ModelConfig:
    return dataclasses.replace(tiny_llama(vocab_size), name="tiny-mistral",
                               sliding_window=64)


def tiny_qwen2(vocab_size: int = 512) -> ModelConfig:
    return dataclasses.replace(tiny_llama(vocab_size), name="tiny-qwen2",
                               qkv_bias=True)


def tiny_gemma(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="tiny-gemma", family="llama", vocab_size=vocab_size, d_model=128,
        n_layers=2, n_heads=4, n_kv_heads=2, d_ff=256, max_seq_len=1024,
        rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
        norm_offset=1.0, hidden_act="gelu_tanh", embed_scale=True,
        head_dim_override=48, dtype=torch.float32,
    )


def tiny_phi3(vocab_size: int = 512) -> ModelConfig:
    return dataclasses.replace(tiny_llama(vocab_size), name="tiny-phi3",
                               sliding_window=8)


def tiny_gpt2(vocab_size: int = 512) -> ModelConfig:
    return ModelConfig(
        name="tiny-gpt2", family="gpt2", vocab_size=vocab_size, d_model=128,
        n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256, max_seq_len=512,
        use_learned_pos=True, use_bias=True, tie_embeddings=True,
        dtype=torch.float32,
    )


PRESETS = {
    "llama-3-8b": llama3_8b,
    "llama-3.1-8b": llama31_8b,
    "llama-3-70b": llama3_70b,
    "mixtral-8x7b": mixtral_8x7b,
    "mistral-7b": mistral_7b,
    "qwen2-7b": qwen2_7b,
    "gemma-7b": gemma_7b,
    "phi-3-mini": phi3_mini,
    "gpt2": gpt2_small,
    "tiny-llama": tiny_llama,
    "tiny-llama-fatkv": tiny_llama_fatkv,
    "tiny-qwen2": tiny_qwen2,
    "tiny-gemma": tiny_gemma,
    "tiny-mixtral": tiny_mixtral,
    "tiny-mistral": tiny_mistral,
    "tiny-phi3": tiny_phi3,
    "tiny-gpt2": tiny_gpt2,
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh axes (dp, tp, sp). The port serves 1 x 1 x 1 only."""

    dp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp * self.sp


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs: paging, batching, bucketing. Field meanings
    are the reference's (tpu_inference/config.py EngineConfig)."""

    page_size: int = 16               # tokens per KV page
    num_pages: int = 512              # pool size (per card, per model)
    max_pages_per_seq: int = 64       # => max context = page_size * this
    max_batch_size: int = 8           # decode slots
    decode_ladder: tuple[int, ...] = ()
    max_queue_len: int = 512
    # Prompts right-pad to the nearest bucket (bounded set of shapes).
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024)
    chunked_prefill_size: int = 0     # 0 = whole-prompt prefill
    # Same-bucket single-chunk prefills batched into one [P, S] forward.
    max_prefill_batch: int = 4
    # "auto" | "kernel" (the Hopper kernels; their plain versions on CPU
    # tensors) | "dense" (gather + dense causal attention).
    attn_backend: str = "auto"
    quant: str = "none"
    kv_quant: str = "none"
    sp_attn: str = "ring"
    # Decode steps per engine call; the host syncs once per call.
    decode_steps_per_call: int = 8
    # Latency mode: at most this many decoding sequences (and nothing
    # queued) -> one step per call so every token streams as sampled.
    latency_decode_threshold: int = 1
    decode_pipeline_depth: int = 1
    hybrid_prefill: bool = False
    step_token_budget: int = 0
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => disabled
    top_p: float = 1.0
    max_new_tokens: int = 1024
    num_speculative_tokens: int = 0
    spec_mode: str = "draft"
    ngram_window: int = 3
    spec_ewma_alpha: float = 0.4
    spec_throttle_below: float = 0.35
    spec_probe_every: int = 48
    enable_prefix_cache: bool = True
    host_cache_pages: int = 0
    admission: str = "reserve"
    optimistic_headroom_pages: int = 2
    preempt_watermark_pages: int = 4
    preempt_max_per_request: int = 3
    chaos_page_pressure: int = 0
    chaos_step_failure_rate: float = 0.0
    chaos_step_wedge_s: float = 0.0
    stage_host_reuse: bool = True
    ladder_admit_headroom_pages: int = 0
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    step_ledger_depth: int = 256
    role: str = "mixed"

    @property
    def max_context(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @property
    def ladder_rungs(self) -> tuple:
        """The decode ladder in effect: ``decode_ladder`` or the single
        rung at ``max_batch_size`` (validated by the engine)."""
        return tuple(self.decode_ladder) or (self.max_batch_size,)

    @property
    def chunk_tokens_cap(self) -> int:
        """``chunked_prefill_size`` clamped to the largest bucket; 0 means
        the largest bucket governs."""
        cap = self.chunked_prefill_size or self.prefill_buckets[-1]
        return min(cap, self.prefill_buckets[-1])

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return self.prefill_buckets[-1]


def validate_spec_config(spec_mode: str, num_speculative_tokens: int,
                         ngram_window: int,
                         has_draft_model: bool) -> None:
    """Speculative-decoding knob validation shared by the engine and the
    CLI, so a bad combination fails as a usage error before any weights
    load. Raises ValueError with the reference's messages (they name the
    flags)."""
    if spec_mode not in ("draft", "ngram"):
        raise ValueError(f"--spec-mode {spec_mode!r}: one of "
                         "('draft', 'ngram')")
    if spec_mode == "ngram" and has_draft_model:
        raise ValueError(
            "--spec-mode ngram does not take --draft-model: n-gram "
            "self-drafting proposes from the sequence's own history "
            "(drop the draft model, or use --spec-mode draft)")
    if num_speculative_tokens > 0 or spec_mode == "ngram":
        if not (1 <= num_speculative_tokens <= 16):
            raise ValueError(
                f"--num-speculative-tokens {num_speculative_tokens}: "
                "must be in [1, 16] when speculative decoding is on "
                "(γ drafts verify in one γ+1-position forward; huge γ "
                "only compiles wider graphs to reject more)")
    if spec_mode == "ngram" and not (1 <= ngram_window <= 8):
        raise ValueError(
            f"--ngram-window {ngram_window}: must be in [1, 8] "
            "(longest suffix n-gram matched against the history)")


# Worker phase roles (P/D disaggregation): "prefill" workers hand each
# settled prefill off to a "decode" worker; "mixed" runs both phases.
WORKER_ROLES = ("prefill", "decode", "mixed")

# Request priority classes, best-first (the X-Priority header).
PRIORITY_CLASSES = ("interactive", "batch", "background")


def class_rank(priority_class: str) -> int:
    """Scheduling rank of a class (0 = most latency-sensitive); unknown
    names rank as interactive."""
    try:
        return PRIORITY_CLASSES.index(priority_class)
    except ValueError:
        return 0


def resolve_worker_roles(dp: int, worker_roles, default_role: str = "mixed"
                         ) -> tuple:
    """The one role rule of the fleet router and the CLI: ``worker_roles``
    (one entry per dp replica, or () for ``default_role`` everywhere) as
    a validated dp-length tuple. Raises ValueError on an unknown role or
    a length mismatch; a one-sided split is served (the other phase runs
    on the off-role workers)."""
    roles = tuple(worker_roles or ())
    if not roles:
        roles = (default_role,) * max(1, dp)
    if len(roles) != max(1, dp):
        raise ValueError(
            f"--roles needs exactly one role per dp replica: got "
            f"{len(roles)} for dp={dp}")
    for r in roles:
        if r not in WORKER_ROLES:
            raise ValueError(f"unknown worker role {r!r}: one of "
                             f"{WORKER_ROLES}")
    return roles


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """HTTP server config (Ollama-protocol endpoint). Field meanings are
    the reference's; the fleet, routing and chaos-RPC fields are accepted
    so a reference config parses, and serve nothing at dp=1 in-process."""

    host: str = "127.0.0.1"
    port: int = 11434
    model_name: str = "tiny-llama"
    tokenizer: str = "byte"
    request_timeout_s: float = 600.0
    warmup: bool = True
    defer_headers_until_first_token: bool = True
    enable_debug: bool = False
    # Where POST /debug/profile writes torch.profiler traces.
    profile_dir: str = "/tmp/torch-trace"
    blackbox_dir: str = ""
    blackbox_retain: int = 8
    chaos_failure_rate: float = 0.0
    chaos_delay_s: float = 0.0
    step_watchdog_s: float = 0.0
    quarantine_after_failures: int = 3
    quarantine_cooldown_s: float = 30.0
    failover_max_retries: int = 1
    admission_queue_depth: int = 0
    retry_after_s: float = 1.0
    routing: str = "prefix_affinity"
    route_hit_weight: float = 1.0
    route_host_hit_weight: float = 0.5
    route_load_pages: float = 1.0
    fabric_cache_pages: int = 0
    fabric_publish_min_pages: int = 1
    fabric_warmboot_pages: int = 64
    route_fabric_hit_weight: float = 0.25
    fleet: str = "in-process"
    kv_plane: str = "relay"
    shm_arena_bytes: int = 256 * 1024 * 1024
    worker_restart_max: int = 3
    worker_restart_backoff_s: float = 0.5
    drain_timeout_s: float = 10.0
    fleet_migrate: bool = True
    worker_roles: tuple[str, ...] = ()
    route_peek_timeout_s: float = 2.0
    route_occupancy_pages: float = 8.0
    pd_prefill_nice: int = 0
    autoscale: bool = False
    autoscale_min_replicas: int = 1
    autoscale_max_replicas: int = 0
    autoscale_breach_window_s: float = 3.0
    autoscale_cooldown_s: float = 10.0
    autoscale_low_watermark: float = 0.25
    autoscale_idle_window_s: float = 5.0
    autoscale_role: str = ""
    default_class: str = "interactive"
    class_queue_depth: int = 0
    rpc_deadline_fast_s: float = 10.0
    rpc_deadline_slow_s: float = 60.0
    poison_max_workers: int = 3
    chaos_rpc_seed: int = 0
    chaos_rpc_corrupt_rate: float = 0.0
    chaos_rpc_drop_rate: float = 0.0
    chaos_rpc_delay_rate: float = 0.0
    chaos_rpc_delay_s: float = 0.02
    chaos_rpc_truncate_rate: float = 0.0
    chaos_rpc_wedge_after: int = 0
    chaos_rpc_wedge_replica: int = 0
    chaos_rpc_verbs: tuple[str, ...] = ()
    chaos_rpc_direction: str = "both"


@dataclasses.dataclass
class FrameworkConfig:
    """Top-level bundle used by the CLI and server entry point."""

    model: ModelConfig = dataclasses.field(default_factory=tiny_llama)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    server: ServerConfig = dataclasses.field(default_factory=ServerConfig)
    checkpoint_path: Optional[str] = None  # None = random init
    seed: int = 0


# ---------------------------------------------------------------------------
# JSON envelope, shared with the reference: dtype by name, tuples as
# lists, and the reference's "pallas" backend name read as "kernel".
# ---------------------------------------------------------------------------

_TUPLE_FIELDS = ("decode_ladder", "prefill_buckets")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def model_config_to_dict(m: ModelConfig) -> dict:
    d = dataclasses.asdict(m)
    d["dtype"] = dtype_name(m.dtype)
    return d


def model_config_from_dict(d: dict) -> ModelConfig:
    d = dict(d)
    dtype = d.get("dtype")
    if isinstance(dtype, str):
        d["dtype"] = _DTYPES[dtype]
    rs = d.get("rope_scaling")
    if isinstance(rs, dict):
        d["rope_scaling"] = RopeScaling(**rs)
    return ModelConfig(**d)


def framework_config_to_dict(cfg: FrameworkConfig) -> dict:
    return {
        "model": model_config_to_dict(cfg.model),
        "engine": dataclasses.asdict(cfg.engine),
        "parallel": dataclasses.asdict(cfg.parallel),
        "server": dataclasses.asdict(cfg.server),
        "checkpoint_path": cfg.checkpoint_path,
        "seed": cfg.seed,
    }


def framework_config_from_dict(d: dict) -> FrameworkConfig:
    eng = dict(d.get("engine") or {})
    for k in _TUPLE_FIELDS:
        if k in eng and eng[k] is not None:
            eng[k] = tuple(eng[k])
    if eng.get("attn_backend") == "pallas":
        eng["attn_backend"] = "kernel"
    srv = dict(d.get("server") or {})
    for k in ("worker_roles", "chaos_rpc_verbs"):
        if srv.get(k) is not None:
            srv[k] = tuple(srv[k])
    return FrameworkConfig(
        model=model_config_from_dict(d["model"]),
        engine=EngineConfig(**eng),
        parallel=ParallelConfig(**(d.get("parallel") or {})),
        server=ServerConfig(**srv),
        checkpoint_path=d.get("checkpoint_path"),
        seed=d.get("seed", 0),
    )
