"""Parameter transport into the port.

``params_from_numpy`` takes the reference package's parameter tree as
nested dicts of numpy arrays (blocks stacked ``[L, ...]``, matrices
``[in, out]``) and returns the port's parameter dict on ``device`` in
``cfg.dtype``. The caller produces the numpy tree; this module never
touches the reference package. Checkpoint loading (safetensors) is
ROADMAP item 1.9.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inference_torch.config import ModelConfig


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors (copies)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=device, dtype=cfg.dtype)

    return conv(tree)
