"""The KV pool operand rules both attention kernels share.

A pool is one of three kinds, told apart by its dtype as in the
reference (engine/kv_cache.py):

- float: float32 or bfloat16, q's dtype, ``[P, pg, Hkv, D]``, no scales;
- int8: codes ``[P, pg, Hkv, D]`` with float32 scales ``[P, pg, Hkv]``;
- packed int4: uint8 ``[P, pg, Hkv, D/2]`` (byte j = code j low nibble,
  code j + D/2 high nibble) with the same scales.

Anything else raises. ``check_pool`` applies these rules on every
device (the plain versions need them as much as the kernels);
``check_kernel_alignment`` adds what only the CUDA page loads need.
"""

from __future__ import annotations

from typing import Optional

import torch

# Variant name -> the kernels' kv_kind argument (csrc/attention_common.cuh).
KV_KINDS = {"f32": 0, "bf16": 0, "int8": 1, "int4": 2}
VARIANTS = tuple(KV_KINDS)
# q dtype -> the kernels' dtype argument.
Q_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FLOAT_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_pool(what: str, q: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor, k_scale: Optional[torch.Tensor],
               v_scale: Optional[torch.Tensor]) -> str:
    """Validate q against the pools and scales; return the variant name
    (``f32``, ``bf16``, ``int8`` or ``int4``)."""
    if q.dtype not in Q_DTYPE_CODES:
        raise TypeError(f"{what}: q dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    if k_pages.dtype != v_pages.dtype:
        raise TypeError(f"{what}: K pool {k_pages.dtype} and V pool "
                        f"{v_pages.dtype} differ")
    d = q.shape[-1]
    pool = k_pages.dtype
    if pool in _FLOAT_NAMES:
        if pool != q.dtype:
            raise TypeError(f"{what}: a float pool must have q's dtype "
                            f"({q.dtype}), got {pool}")
        if k_scale is not None or v_scale is not None:
            raise TypeError(f"{what}: a float pool takes no scales")
        variant, d_pool = _FLOAT_NAMES[pool], d
    elif pool in (torch.int8, torch.uint8):
        if k_scale is None or v_scale is None:
            raise TypeError(f"{what}: an {pool} pool needs both k_scale "
                            "and v_scale")
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32
                    or tuple(s.shape) != tuple(k_pages.shape[:3])):
                raise TypeError(
                    f"{what}: scales must be float32 "
                    f"{tuple(k_pages.shape[:3])}, got {s.dtype} "
                    f"{tuple(s.shape)}")
        packed = pool == torch.uint8
        if packed and d % 2:
            raise ValueError(f"{what}: packed int4 needs an even head_dim, "
                             f"got {d}")
        variant, d_pool = ("int4", d // 2) if packed else ("int8", d)
    else:
        raise TypeError(f"{what}: pool dtype {pool} not supported (q's "
                        "float dtype, int8 codes, or uint8 packed int4)")
    hkv = k_pages.shape[2]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d_pool
            or q.shape[-2] % hkv):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)} ({variant} pool)")
    return variant


def check_kernel_alignment(what: str, variant: str,
                           k_pages: torch.Tensor,
                           v_pages: torch.Tensor) -> None:
    """The CUDA page load reads 16 bytes per thread: the stored row
    length must be a multiple of 16 bytes and both pools 16-byte
    aligned."""
    d_pool = k_pages.shape[3]
    vec = 16 // k_pages.element_size()
    if d_pool % vec:
        per_byte = 2 if variant == "int4" else 1
        raise ValueError(f"{what}: head_dim {d_pool * per_byte} must be a "
                         f"multiple of {vec * per_byte} for 16-byte page "
                         f"loads of a {variant} pool")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{what}: pools must be 16-byte aligned")
