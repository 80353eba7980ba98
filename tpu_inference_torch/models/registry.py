"""Model family registry: ModelConfig.family -> module of plain functions
(the reference's three families: llama, mixtral, gpt2).
"""

from __future__ import annotations

import types
from typing import Tuple

import torch

from tpu_inference_torch.config import ModelConfig


def get_model_fns(cfg: ModelConfig) -> types.ModuleType:
    from tpu_inference_torch.models import gpt2, llama, mixtral

    families = {"llama": llama, "mixtral": mixtral, "gpt2": gpt2}
    if cfg.family not in families:
        raise ValueError(f"unknown model family {cfg.family!r}; one of "
                         f"{sorted(families)}")
    return families[cfg.family]


def build_model(cfg: ModelConfig, seed: int = 0, device="cuda",
                quant: str = "none") -> Tuple[dict, types.ModuleType]:
    """Random-init params (from a generator seeded with ``seed`` on
    ``device``) + family module. With ``quant`` "int8"/"int4" the matmul
    weights are drawn and quantized one layer slab at a time
    (models/quant.py init_quantized_params), so peak device memory stays
    near the quantized model's size."""
    mod = get_model_fns(cfg)
    if quant != "none":
        from tpu_inference_torch.models.quant import init_quantized_params
        return init_quantized_params(cfg, seed, quant, device=device), mod
    gen = torch.Generator(device=device).manual_seed(seed)
    return mod.init_params(cfg, gen, device=device), mod
