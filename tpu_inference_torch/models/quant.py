"""Weight-only int8/int4 quantization (PyTorch twin of
``tpu_inference/models/quant.py``).

- ``QuantizedArray`` holds narrow-int codes ``q`` and float32 ``scale``.
  int8: one scale per output channel, ``scale [..., 1, out]`` (the
  contraction dim, axis -2 of every ``[in, out]`` weight, reduced). int4:
  the contraction dim splits into groups of ``GROUP_SIZE`` with one scale
  per (group, output channel), ``scale [..., G, out]``.
- Grouped int4 codes are stored packed, two per **int8** byte along the
  contraction dim (rows 2i, 2i+1 -> low, high nibble; arithmetic shifts
  unpack them). A contraction dim not divisible by ``GROUP_SIZE`` keeps
  one code per byte and one group. This is not the KV pool's int4
  packing (engine/kv_cache.py: uint8, halves of head_dim).
- ``qdot`` is the contraction every weight matmul of the models calls;
  it takes plain tensors too. The reference leaves these products to
  XLA outside any Pallas kernel; here they go to ``torch.matmul`` (a
  fused dequant GEMM is later work), which converts the int8 codes to
  the activation dtype first, so an int8 weight costs more device bytes
  per call than a bf16 one until that GEMM exists.

Codes and scales are byte-identical to the reference's
(tests/test_torch_quant.py). ``qeinsum`` is the batched twin of
``qdot`` for the MoE expert contractions (models/mixtral.py).
"""

from __future__ import annotations

import math

import torch

QUANT_MODES = ("none", "int8", "int4")

# int4 group size along the contraction dim.
GROUP_SIZE = 128

# Params-tree leaf names eligible for quantization: the large matmul
# weights. Norm scales, biases and embeddings (gather tables) stay in the
# model dtype.
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
    "w_qkv", "w_proj", "w_fc", "w_out",
})


class QuantizedArray:
    """Narrow-int weight + float32 scale. Indexing slices both along
    their leading (layer) axes, so stacked weights give per-layer views."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, idx) -> "QuantizedArray":
        return QuantizedArray(self.q[idx], self.scale[idx])

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype

    def to(self, device) -> "QuantizedArray":
        return QuantizedArray(self.q.to(device), self.scale.to(device))


def _check_mode(mode: str) -> None:
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {mode!r}; one of {QUANT_MODES}")


def _groups_for(in_dim: int, mode: str) -> int:
    """Scale groups along the contraction dim for a quant mode."""
    if mode == "int8" or in_dim % GROUP_SIZE:
        return 1
    return in_dim // GROUP_SIZE


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes [..., in, out] (values in [-7, 7]) -> packed int8
    [..., in // 2, out]: row 2i in the low nibble, row 2i+1 in the high.
    ``hi << 4`` wraps within int8, as in the reference."""
    *lead, in_dim, out = codes.shape
    pairs = codes.reshape(*lead, in_dim // 2, 2, out)
    lo, hi = pairs[..., 0, :], pairs[..., 1, :]
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., in // 2, out] -> sign-extended int8 codes
    [..., in, out], by arithmetic shifts on int8."""
    *lead, half, out = packed.shape
    lo = (packed << 4) >> 4                      # sign-extend low nibble
    hi = packed >> 4                             # arithmetic: sign-extends
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half, out)


def quantize_array(w: torch.Tensor, mode: str = "int8") -> QuantizedArray:
    """Symmetric quantization along the contraction dim (axis -2): int8
    per output channel, int4 per (group, channel), packed when grouped."""
    wf = w.float()
    if mode == "int4":
        in_dim, out = w.shape[-2], w.shape[-1]
        ngrp = _groups_for(in_dim, mode)
        wg = wf.reshape(*w.shape[:-2], ngrp, in_dim // ngrp, out)
        amax = wg.abs().amax(dim=-2, keepdim=True)
        scale = amax.clamp_min(1e-8) / 7.0
        q = torch.round(wg / scale).clamp(-7, 7).to(torch.int8)
        q = q.reshape(w.shape)
        if ngrp > 1:
            q = pack_int4(q)
        return QuantizedArray(q, scale[..., 0, :])       # [..., G, out]
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return QuantizedArray(q, scale)


def dequantize(w: QuantizedArray,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    ngrp = w.scale.shape[-2]
    if ngrp == 1:
        return (w.q.float() * w.scale).to(dtype)
    codes = unpack_int4(w.q)
    in_dim, out = codes.shape[-2], codes.shape[-1]
    wg = codes.reshape(*codes.shape[:-2], ngrp, in_dim // ngrp, out)
    full = wg.float() * w.scale[..., :, None, :]
    return full.reshape(codes.shape).to(dtype)


def _mm(x: torch.Tensor, w: torch.Tensor, f32_product: bool
        ) -> torch.Tensor:
    """``x @ w`` in float32. With ``f32_product`` a bf16/f16 product is
    not rounded to x's dtype: one GEMM with a float32 result on the card
    (``torch.mm(..., out_dtype=torch.float32)``), widened operands on the
    CPU."""
    if not f32_product or x.dtype == torch.float32:
        return torch.matmul(x, w).float()
    if x.device.type != "cuda":
        return torch.matmul(x.float(), w.float())
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _grouped(xg: torch.Tensor, qg: torch.Tensor, f32_product: bool
             ) -> torch.Tensor:
    """``einsum("...gi,gio->...go")`` in float32 (int4 groups), the
    product kept in float32 as ``_mm``'s with ``f32_product``."""
    if not f32_product or xg.dtype == torch.float32:
        return torch.einsum("...gi,gio->...go", xg, qg).float()
    lead, (g, i) = xg.shape[:-2], xg.shape[-2:]
    x3 = xg.reshape(-1, g, i).transpose(0, 1)                  # [g, N, i]
    if xg.device.type != "cuda":
        y = torch.bmm(x3.float(), qg.float())
    else:
        y = torch.bmm(x3, qg, out_dtype=torch.float32)
    return y.transpose(0, 1).reshape(*lead, g, qg.shape[-1])


def qdot(x: torch.Tensor, w, f32_product: bool = False) -> torch.Tensor:
    """``x @ w`` returned in float32; w: [in, out] or a QuantizedArray.

    int8 (one group): the codes convert to x's dtype, one matmul, then
    the per-channel scale multiplies the float32 result. Grouped int4:
    unpack, one contraction per group, partials folded with their
    scales in float32. Float32 operands multiply in float32; bf16
    operands multiply on the tensor cores with float32 accumulation and
    a bf16-rounded product (the reference keeps that product in float32
    before the scale). ``f32_product`` keeps it in float32 too: a tp
    shard's row-parallel partial sum (parallel/tp.py), which is added
    to the other shards' before any rounding, as the reference's
    all-reduce adds its float32 dot outputs."""
    if isinstance(w, QuantizedArray):
        ngrp = w.scale.shape[-2]
        # One group of unpacked codes; packed int4 codes hold half the
        # contraction rows (a tp shard of a grouped leaf may keep a
        # single group, still packed).
        if ngrp == 1 and w.q.shape[-2] == x.shape[-1]:
            return _mm(x, w.q.to(x.dtype), f32_product) * w.scale[..., 0, :]
        codes = unpack_int4(w.q)
        gsz = codes.shape[-2] // ngrp
        xg = x.reshape(*x.shape[:-1], ngrp, gsz)
        qg = codes.reshape(ngrp, gsz, codes.shape[-1]).to(x.dtype)
        return (_grouped(xg, qg, f32_product) * w.scale).sum(dim=-2)
    return _mm(x, w, f32_product)


def _contract_dtype(a: torch.Tensor) -> torch.dtype:
    """Operand dtype of the grouped (int4) contractions: bf16 on the card
    (tensor cores), float32 for bf16 operands on the CPU, as the
    reference contracts off its TPU."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.float32
    return a.dtype


# The expert contractions qeinsum serves: [E, C, in] x [E, in, out].
_EXPERT_EQS = ("ecd,edf->ecf", "ecf,efd->ecd")


def qeinsum(eq: str, a: torch.Tensor, w) -> torch.Tensor:
    """``einsum(eq, a, w)`` returned in float32, for the MoE expert
    contractions ``ecd,edf->ecf`` and ``ecf,efd->ecd`` (a [E, C, in], w
    [E, in, out] or a QuantizedArray of that shape). Both are one batched
    matmul over the expert axis.

    int8 (one group): the codes convert to a's dtype, one batched matmul,
    then the [E, 1, out] scale multiplies the float32 result. Grouped
    int4: unpack, one batched contraction per group, the partials folded
    with their [E, G, out] scales in float32."""
    if eq not in _EXPERT_EQS:
        raise ValueError(f"qeinsum serves the MoE expert contractions "
                         f"{_EXPERT_EQS}, got {eq!r}")
    if not isinstance(w, QuantizedArray):
        return torch.bmm(a, w).float()
    ngrp = w.scale.shape[-2]
    if ngrp == 1 and w.q.shape[-2] == a.shape[-1]:
        return torch.bmm(a, w.q.to(a.dtype)).float() * w.scale
    codes = unpack_int4(w.q)                              # [E, in, out]
    e, in_dim, out = codes.shape
    gsz = in_dim // ngrp
    ct = _contract_dtype(a)
    a4 = a.reshape(e, a.shape[1], ngrp, gsz).to(ct)         # [E, C, G, g]
    q4 = codes.reshape(e, ngrp, gsz, out).to(ct)            # [E, G, g, out]
    y = torch.einsum("ecgi,egio->egco", a4, q4).float()     # [E, G, C, out]
    return (y * w.scale[:, :, None, :]).sum(dim=1)


def _map_named(tree: dict, fn) -> dict:
    """Apply fn(name, leaf) to every leaf of a nested dict."""
    return {k: _map_named(v, fn) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


def quantize_params(params: dict, mode: str = "int8") -> dict:
    """Quantize the QUANT_KEYS leaves of a params dict; leaves already
    quantized stay as they are."""
    if mode == "none":
        return params
    _check_mode(mode)

    def maybe_quant(name, leaf):
        if name in QUANT_KEYS and not isinstance(leaf, QuantizedArray):
            return quantize_array(leaf, mode)
        return leaf

    return _map_named(params, maybe_quant)


def quantize_slabs(lead: tuple, slabs, mode: str) -> QuantizedArray:
    """Quantize ``[in, out]`` slabs, one at a time, into one stacked
    QuantizedArray with leading dims ``lead`` (the slabs in row-major
    order over them). Codes and scales are allocated at the first slab,
    so one full-precision slab is alive at a time; the scales reduce
    over axis -2 only, so the codes equal the whole stack's."""
    total = math.prod(lead)
    q = scale = None
    for i, slab in enumerate(slabs):
        part = quantize_array(slab, mode)
        if q is None:
            q = part.q.new_empty((total, *part.q.shape))
            scale = part.scale.new_empty((total, *part.scale.shape))
        q[i].copy_(part.q)
        scale[i].copy_(part.scale)
    return QuantizedArray(q.reshape(*lead, *q.shape[1:]),
                          scale.reshape(*lead, *scale.shape[1:]))


def init_quantized_params(model_cfg, seed: int = 0, mode: str = "int8",
                          device="cuda") -> dict:
    """Random init + quantize one layer slab at a time.

    Initializing the whole model in its dtype and then quantizing peaks
    at the full-precision tree plus the quantized copy; here each
    QUANT_KEYS leaf is drawn (float32, rounded to the model dtype, as the
    reference draws) and quantized one ``[in, out]`` slab at a time into
    preallocated codes and scales, so peak device memory is the
    quantized model plus one float32 slab. Norm scales are ones,
    everything else the same 0.02-std normal. Values differ from
    ``build_model``'s; shapes, dtypes and determinism per seed are what
    matter for random weights."""
    if mode == "none":
        raise ValueError("init_quantized_params needs a quant mode; use "
                         "build_model for full-precision init")
    _check_mode(mode)
    from tpu_inference_torch.models.registry import get_model_fns

    mod = get_model_fns(model_cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = model_cfg.dtype

    def draw(shape) -> torch.Tensor:
        return (0.02 * torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=device)).to(dtype)

    def quantized(shape) -> QuantizedArray:
        return quantize_slabs(shape[:-2], (draw(shape[-2:]) for _ in
                                           range(math.prod(shape[:-2]))),
                              mode)

    def leaf(name, shape):
        if name in QUANT_KEYS:
            return quantized(shape)
        if "norm" in name:
            return torch.ones(shape, dtype=dtype, device=device)
        return draw(shape)

    return _map_named(mod.param_shapes(model_cfg), leaf)
