"""Parameter transport into the port.

``params_from_numpy`` takes the reference package's parameter tree as
nested dicts of numpy arrays (blocks stacked ``[L, ...]``, matrices
``[in, out]``) and returns the port's parameter dict on ``device``.
Float leaves take ``cfg.dtype``; a quantized leaf (any object with ``q``
and ``scale`` arrays, as the reference's ``QuantizedArray`` is) becomes
a port ``QuantizedArray`` with its codes in their own integer dtype and
float32 scales. The caller produces the tree; this module never touches
the reference package. Checkpoint loading (safetensors) is ROADMAP item
1.9.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models.quant import QuantizedArray


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors (copies)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            codes = np.asarray(node.q)
            if codes.dtype not in (np.int8, np.uint8):
                raise TypeError(f"quantized leaf with {codes.dtype} codes; "
                                "expected int8 or uint8")
            scale = np.asarray(node.scale, dtype=np.float32)
            return QuantizedArray(
                torch.from_numpy(codes.copy()).to(device),
                torch.from_numpy(scale.copy()).to(device))
        arr = np.asarray(node, dtype=np.float32)
        return torch.from_numpy(arr.copy()).to(device=device, dtype=cfg.dtype)

    return conv(tree)
