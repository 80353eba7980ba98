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


def build_model(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Tuple[dict, types.ModuleType]:
    """Random-init params (from a generator seeded with ``seed`` on
    ``device``) + family module."""
    mod = get_model_fns(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    return mod.init_params(cfg, gen, device=device), mod
