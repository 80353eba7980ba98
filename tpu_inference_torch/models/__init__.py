"""Plain-function PyTorch model definitions over parameter dicts.

Each family module exposes ``init_params(cfg, generator, device)`` and
``forward(params, cfg, tokens, positions, kv, attn) -> (logits, kv)``,
with attention injected by the caller (tpu_inference_torch/models/common.py).
"""

from tpu_inference_torch.models.registry import build_model, get_model_fns  # noqa: F401
