"""``--debug-nans``: a NaN check on every serving forward, the port's
twin of the reference's ``jax_debug_nans``.

The reference's flag calls ``jax.config.update("jax_debug_nans", True)``
before the engine is built: from then on a jitted step whose output holds
a NaN re-runs op by op and raises FloatingPointError at its source. Here
``set_debug_nans(True)`` turns on a process-wide switch under which every
serving forward (prefill chunks, fused decode steps, hybrid steps, draft
and verify rounds; at tp > 1 the sharded forward) checks each layer's
output through ``forward_hidden``'s ``on_layer`` hook, then the logits,
and raises FloatingPointError naming the model, the layer (or "logits")
and the step kind (a hybrid step's prefill half says "hybrid", its
decode half "decode"). The error takes the engine's step-error path like
any other. Off (the default) the hook is None and nothing syncs.

Like ``jax.config.update``, the switch belongs to this process: the
process fleet's workers do not inherit it, as the reference's workers do
not inherit ``jax_debug_nans`` (its worker envelope does not carry it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

_enabled = False


def set_debug_nans(on: bool) -> bool:
    """Turn the check on or off for this process; returns the previous
    setting."""
    global _enabled
    previous, _enabled = _enabled, bool(on)
    return previous


def debug_nans() -> bool:
    return _enabled


def layer_check(cfg, kind: str
                ) -> Optional[Callable[[int, torch.Tensor], None]]:
    """The ``on_layer`` hook of one ``kind`` of step of model ``cfg``:
    None while the switch is off."""
    if not _enabled:
        return None

    def check(i: int, x: torch.Tensor) -> None:
        if bool(torch.isnan(x).any()):
            raise FloatingPointError(
                f"{cfg.name}: NaN in the output of layer {i} in a {kind} "
                "step (--debug-nans)")

    return check


def check_logits(cfg, kind: str, logits: torch.Tensor) -> None:
    """Raise when the switch is on and ``logits`` hold a NaN."""
    if _enabled and bool(torch.isnan(logits).any()):
        raise FloatingPointError(f"{cfg.name}: NaN in the logits of a "
                                 f"{kind} step (--debug-nans)")
