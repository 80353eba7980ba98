"""Model family registry: ModelConfig.family -> module of plain functions.

The port serves the llama family; the reference's mixtral and gpt2
families raise until ROADMAP item 1.14 lands.
"""

from __future__ import annotations

import types
from typing import Tuple

import torch

from tpu_inference_torch.config import ModelConfig


def get_model_fns(cfg: ModelConfig) -> types.ModuleType:
    if cfg.family != "llama":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (ROADMAP 1.14: "
            "Mixtral and GPT-2); the port serves the llama family")
    from tpu_inference_torch.models import llama

    return llama


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
