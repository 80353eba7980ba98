"""Memory-aware engine sizing: derive batch, KV pool and host tier from
the card and the machine.

Twin of ``tpu_inference/engine/autosize.py`` (same names, same
arithmetic). ``--max-batch-size auto --num-pages auto`` size the decode
batch and the KV pool from the card's memory after the weights:

    usable  = (1 - reserve_frac) * device_memory
    budget  = usable - weights/tp - activation_headroom
    tokens  = budget // (kv_bytes_per_token / tp)
    pages   = tokens // page_size      (capped at 4 x batch_cap x seq pages)
    batch   = min(batch_cap, tokens // target_ctx)

The card's memory is ``torch.cuda.get_device_properties(dev).total_memory``
(``detect_hbm_bytes``), which is the total, not what is free: the
``reserve_frac`` and the activation headroom stand for what the CUDA
context, the caching allocator and the activations take. Off the card
the caller passes ``hbm_bytes``; nothing here carries a table of
accelerator sizes. ``detect_peak_flops``/``detect_peak_hbm_bw`` read the
card's published bf16 peak and memory rate (the MFU gauge's and the step
ledger's denominators). ``decode_ladder_rungs``/``parse_decode_ladder`` give
the decode batch ladder, ``auto_host_cache_pages`` sizes the host-RAM KV
tier from ``/proc/meminfo``, ``pd_worker_roles`` the prefill:decode worker
split of ``--pd-ratio``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def estimate_param_count(model_cfg) -> int:
    """Parameter count from the architecture config (norms elided)."""
    d, f, L, V = (model_cfg.d_model, model_cfg.d_ff, model_cfg.n_layers,
                  model_cfg.vocab_size)
    kv_w = model_cfg.n_kv_heads * model_cfg.head_dim
    embed = V * d * (1 if model_cfg.tie_embeddings else 2)
    attn = 2 * d * d + 2 * d * kv_w
    if model_cfg.n_experts:
        ffn = model_cfg.n_experts * 3 * d * f + d * model_cfg.n_experts
    else:
        ffn = 3 * d * f
    return embed + L * (attn + ffn)


def weight_bytes(model_cfg, quant: str = "none") -> int:
    """Resident weight bytes. int8 stores matmul weights as one byte plus
    per-output-channel float32 scales (budgeted as 1%); int4 as half a
    byte plus one float32 scale per GROUP_SIZE codes; embeddings stay in
    the model dtype (models/quant.py quantizes matmuls only)."""
    n = estimate_param_count(model_cfg)
    itemsize = 2  # bf16 serving dtype
    if quant in ("int8", "int4"):
        d, V = model_cfg.d_model, model_cfg.vocab_size
        embed = V * d * (1 if model_cfg.tie_embeddings else 2)
        matmul = n - embed
        if quant == "int4":
            from tpu_inference_torch.models.quant import GROUP_SIZE
            return embed * itemsize + int(matmul * (0.5 + 4 / GROUP_SIZE))
        return embed * itemsize + int(matmul * 1.01)
    return n * itemsize


def kv_bytes_per_token(model_cfg, kv_quant: str = "none") -> int:
    """Pool bytes one token occupies across all layers (K and V): bf16
    elements, or int8 codes / nibble-packed int4 codes plus a float32
    scale per (token, kv-head) (engine/kv_cache.py layouts)."""
    L = model_cfg.n_layers
    hkv = model_cfg.n_kv_heads
    d = model_cfg.head_dim
    if kv_quant == "int8":
        return 2 * L * hkv * (d + 4)
    if kv_quant == "int4":
        return 2 * L * hkv * (d // 2 + 4)
    return 2 * L * hkv * d * 2


@dataclasses.dataclass(frozen=True)
class AutoSizing:
    max_batch_size: int
    num_pages: int
    # Where the budget went, for logs.
    hbm_bytes: int
    weight_bytes_per_chip: int
    kv_pool_bytes_per_chip: int
    kv_bytes_per_token: int
    target_ctx: int


def auto_size(model_cfg, *, hbm_bytes: Optional[float] = None,
              quant: str = "none", kv_quant: str = "none", tp: int = 1,
              page_size: int = 16, max_pages_per_seq: int = 64,
              target_ctx: Optional[int] = None, batch_cap: int = 32,
              reserve_frac: float = 0.15,
              activation_headroom: int = 512 << 20,
              speculative: bool = False) -> AutoSizing:
    """Size ``max_batch_size`` and ``num_pages`` for a device of
    ``hbm_bytes`` (read from the card when None).

    Raises ValueError when the weights alone exceed the budget or when
    the KV budget cannot hold one full-length sequence."""
    hbm = float(hbm_bytes if hbm_bytes is not None else detect_hbm_bytes())
    wb = weight_bytes(model_cfg, quant)
    per_chip_w = wb // tp
    usable = (1.0 - reserve_frac) * hbm
    budget = usable - per_chip_w - activation_headroom
    if budget <= 0:
        raise ValueError(
            f"{model_cfg.name}: weights (~{per_chip_w / 1e9:.1f} GB/card, "
            f"quant={quant}, tp={tp}) + {activation_headroom >> 20} MB "
            f"activation headroom exceed {usable / 1e9:.1f} GB usable "
            f"device memory ({hbm / 1e9:.0f} GB card); use --quant int8 "
            "or a bigger card")
    kv_tok = kv_bytes_per_token(model_cfg, kv_quant)
    tokens = int(budget // (kv_tok / tp))
    num_pages = tokens // page_size
    # Do not hoard memory a small model can never address: every slot
    # holding a full-length sequence, with 4x slack for the prefix cache.
    num_pages = min(num_pages, 4 * batch_cap * max_pages_per_seq)
    # Page 0 is the trash page: admission grants num_pages - 1.
    tokens = min(tokens, (num_pages - 1) * page_size)
    if num_pages < max_pages_per_seq + 1:
        raise ValueError(
            f"{model_cfg.name}: KV budget ({budget / 1e9:.2f} GB/card) "
            f"holds only {num_pages} pages < one full sequence "
            f"({max_pages_per_seq}); lower --max-pages-per-seq or "
            "shrink the pool bytes with --kv-quant int8 (or int4)")
    ctx = int(target_ctx) if target_ctx else (page_size * max_pages_per_seq
                                              // 2)
    ctx = max(1, min(ctx, page_size * max_pages_per_seq))
    win = getattr(model_cfg, "sliding_window", 0)
    if win and not speculative:
        # Behind-window eviction caps a running SWA sequence's live KV
        # at about the window: batch against that, not the context.
        ctx = min(ctx, win + 2 * page_size)
    batch = max(1, min(batch_cap, tokens // ctx))
    return AutoSizing(
        max_batch_size=batch, num_pages=num_pages, hbm_bytes=int(hbm),
        weight_bytes_per_chip=int(per_chip_w),
        kv_pool_bytes_per_chip=int(num_pages * page_size * kv_tok // tp),
        kv_bytes_per_token=kv_tok, target_ctx=ctx)


def detect_host_ram_bytes() -> int:
    """Available host RAM: /proc/meminfo MemAvailable, else half of the
    sysconf total. The host KV tier's sizing input."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    import os

    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) // 2
    except (ValueError, OSError, AttributeError):
        return 8 << 30


def auto_host_cache_pages(model_cfg, *, kv_quant: str = "none",
                          page_size: int = 16,
                          host_ram_bytes: Optional[int] = None,
                          fraction: float = 0.5,
                          reserve_bytes: int = 2 << 30) -> int:
    """``--host-cache-pages auto``: ``fraction`` of (available RAM -
    reserve) over one page's bytes in the serving kv_quant layout; 0
    when the machine has no headroom. Capacity is a cap: RAM is taken
    only as pages demote."""
    avail = (detect_host_ram_bytes() if host_ram_bytes is None
             else int(host_ram_bytes))
    budget = max(0, int((avail - reserve_bytes) * fraction))
    per_page = page_size * kv_bytes_per_token(model_cfg, kv_quant)
    return budget // max(per_page, 1)


def detect_hbm_bytes(device=None) -> int:
    """Total memory of the CUDA card ``device`` (default: the current
    one). Raises when no card is visible: off the card the caller
    passes ``hbm_bytes``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "auto sizing reads the card's memory, but torch.cuda."
            "is_available() is False; pass integer --max-batch-size and "
            "--num-pages (or hbm_bytes) off the card")
    dev = torch.device("cuda" if device is None else device)
    return int(torch.cuda.get_device_properties(dev).total_memory)


# Per-card dense bf16 peak FLOP/s and memory rate (bytes/s), keyed by
# torch.cuda.get_device_name(): NVIDIA's published H100 figures (SXM at
# 700 W; PCIe). They are the denominators of the MFU gauge and of the
# step ledger's roofline verdicts (telemetry.StepCostModel). The CPU and
# unknown cards report against the H100 SXM entry, so both always
# render (as the reference reports unknown chips against its default).
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS_BY_DEVICE_KIND = {
    H100_SXM: 989.4e12,
    "NVIDIA H100 PCIe": 756e12,
}
PEAK_HBM_BW_BY_DEVICE_KIND = {
    H100_SXM: 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def _device_kind(device=None) -> str:
    """The card's name (the tables' key); H100 SXM off the card."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return H100_SXM
    if not torch.cuda.is_available():
        return H100_SXM
    return torch.cuda.get_device_name(device)


def detect_peak_flops(device=None) -> float:
    """Dense bf16 peak FLOP/s of the card ``device`` (default: the
    current one; H100 SXM for the CPU and unknown cards)."""
    return PEAK_FLOPS_BY_DEVICE_KIND.get(_device_kind(device),
                                         PEAK_FLOPS_BY_DEVICE_KIND[H100_SXM])


def detect_peak_hbm_bw(device=None) -> float:
    """Memory rate (bytes/s) of the card ``device``, same stance as
    detect_peak_flops."""
    return PEAK_HBM_BW_BY_DEVICE_KIND.get(
        _device_kind(device), PEAK_HBM_BW_BY_DEVICE_KIND[H100_SXM])


def decode_ladder_rungs(top: int, base: int = 8) -> tuple:
    """Doubling rungs from ``base`` strictly below ``top``, plus ``top``:
    top=32 -> (8, 16, 32); top=24 -> (8, 16, 24); top=8 -> (8,)."""
    top = int(top)
    if top <= 0:
        raise ValueError(f"decode ladder needs a positive top, got {top}")
    rungs = []
    r = base
    while r < top:
        rungs.append(r)
        r *= 2
    rungs.append(top)
    return tuple(rungs)


def validate_ladder(rungs, top: int) -> tuple:
    """The ladder invariant: strictly increasing positive rungs ending
    at ``top`` (the engine's slot count). Shared by parse_decode_ladder
    and the engine's constructor."""
    rungs = tuple(rungs)
    if (not rungs or list(rungs) != sorted(set(rungs)) or rungs[0] < 1
            or rungs[-1] != top):
        raise ValueError(
            f"decode_ladder {list(rungs)} must be strictly increasing, "
            f"positive, and end at max_batch_size ({top})")
    return rungs


def parse_decode_ladder(spec: str, top: int) -> tuple:
    """The --decode-ladder grammar: 'auto' (doubling rungs up to
    ``top``), 'off' (one rung at ``top``), or comma rungs like
    '8,16,32' ending at ``top``. Raises ValueError."""
    if spec == "auto":
        return decode_ladder_rungs(top)
    if spec == "off":
        return (top,)
    try:
        rungs = tuple(int(r) for r in spec.split(","))
    except ValueError:
        raise ValueError(
            f"--decode-ladder {spec!r}: expected 'auto', 'off', or "
            "comma-separated rungs like '8,16,32'")
    return validate_ladder(rungs, top)


# Card-seconds of one decode token against one prefill token in the P/D
# split: decode streams every weight per token, prefill amortizes the
# stream over the prompt.
PD_DECODE_COST_FACTOR = 4.0


def pd_worker_roles(dp: int, spec: str,
                    prompt_token_rate: Optional[float] = None,
                    decode_token_rate: Optional[float] = None) -> tuple:
    """The prefill:decode worker split of ``--pd-ratio``: a dp-length
    tuple ``("prefill",)*P + ("decode",)*D``. ``spec`` is ``"P:D"``
    (scaled to dp, each side at least one worker) or ``"auto"`` (each
    phase's share of card-seconds from the offered prompt and decode
    token rates, 512 and 128 tokens/s when not given, decode tokens
    weighted PD_DECODE_COST_FACTOR). Raises ValueError."""
    if dp < 2:
        raise ValueError(
            f"--pd-ratio needs dp >= 2 (got dp={dp}): the split puts "
            "prefill and decode on different workers")
    if spec == "auto":
        p_rate = float(prompt_token_rate) if prompt_token_rate else 512.0
        d_rate = float(decode_token_rate) if decode_token_rate else 128.0
        share = p_rate / (p_rate + PD_DECODE_COST_FACTOR * d_rate)
    else:
        try:
            p_part, d_part = (int(x) for x in spec.split(":"))
        except ValueError:
            raise ValueError(
                f"--pd-ratio {spec!r}: expected 'auto' or 'P:D' "
                "(e.g. '1:1', '1:3')")
        if p_part < 1 or d_part < 1:
            raise ValueError(
                f"--pd-ratio {spec!r}: both sides must be >= 1")
        share = p_part / (p_part + d_part)
    n_prefill = max(1, min(dp - 1, round(dp * share)))
    return ("prefill",) * n_prefill + ("decode",) * (dp - n_prefill)


def int_or_auto(v: str):
    """argparse type for --max-batch-size/--num-pages/--host-cache-pages:
    an int or the literal 'auto'."""
    import argparse

    if v == "auto":
        return v
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}")


def resolve_sizing_args(args) -> tuple:
    """Turn 'auto' in ``args.max_batch_size`` / ``args.num_pages`` into
    card-derived values (no-op when both are ints). Reads model, quant,
    kv_quant, page_size, max_pages_per_seq, device and the optional
    checkpoint/tp/target_ctx/batch_cap/draft_model attributes. Returns
    (max_batch_size, num_pages)."""
    mbs, pages = args.max_batch_size, args.num_pages
    if "auto" not in (mbs, pages):
        return mbs, pages
    mcfg = resolve_model_config(args.model, getattr(args, "checkpoint", None))
    sz = auto_size(
        mcfg, hbm_bytes=detect_hbm_bytes(getattr(args, "device", None)),
        quant=args.quant, kv_quant=args.kv_quant,
        tp=getattr(args, "tp", 1), page_size=args.page_size,
        max_pages_per_seq=args.max_pages_per_seq,
        target_ctx=getattr(args, "target_ctx", 0) or None,
        batch_cap=getattr(args, "batch_cap", 32),
        speculative=bool(getattr(args, "draft_model", None)))
    if mbs == "auto":
        mbs = sz.max_batch_size
    if pages == "auto":
        pages = sz.num_pages
    import sys

    print(f"[autosize] {mcfg.name}: batch={mbs} num_pages={pages} "
          f"(card {sz.hbm_bytes / 1e9:.0f} GB, weights "
          f"{sz.weight_bytes_per_chip / 1e9:.2f} GB, kv pool "
          f"{sz.kv_pool_bytes_per_chip / 1e9:.2f} GB, target ctx "
          f"{sz.target_ctx})", file=sys.stderr)
    return mbs, pages


def resolve_model_and_checkpoint(model: str,
                                 checkpoint: Optional[str] = None):
    """(model config, checkpoint path) from a preset name, a local HF
    checkpoint directory, or "auto" with ``checkpoint`` set. The one
    model-resolution rule: build_server and the sizing path both call
    it, so the model that is sized is the model that boots."""
    import os

    from tpu_inference_torch.config import PRESETS

    if model in PRESETS:
        return PRESETS[model](), checkpoint
    src = checkpoint if (model == "auto" and checkpoint) else model
    if not (isinstance(src, str)
            and os.path.exists(os.path.join(src, "config.json"))):
        raise ValueError(
            f"unknown model {model!r}: not a preset "
            f"({', '.join(sorted(PRESETS))}) and not a HF checkpoint "
            f"directory with a config.json")
    from tpu_inference_torch.models.weights import config_from_hf

    return config_from_hf(src), (checkpoint or src)


def resolve_model_config(model: str, checkpoint: Optional[str] = None):
    """Model config only (see resolve_model_and_checkpoint)."""
    return resolve_model_and_checkpoint(model, checkpoint)[0]
