"""Model families: everything in the harness that depends on a model's
architecture, one module a family, found by the configuration file's
``model_type`` key as ``families/<model_type>.py``. A new family is a
new module here; no other module of the harness names an architecture.

A family module gives:

- ``shape(config) -> dict``: the sizes the other modules read, from the
  configuration's published keys. Every family's shape holds ``family``
  (the ``model_type``), ``vocab``, ``d``, ``layers``, ``eps``,
  ``max_context`` and ``dtype``; the rest is the family's own.
- ``port_fields(shape, config) -> dict``: the keyword arguments of the
  port's ``ModelConfig`` but ``name`` and ``dtype``. A family module
  imports nothing of the port (``port.py`` alone does).
- ``layer_leaves(shape, layer)`` and ``top_leaves(shape)``: (name,
  shape, drawn) of each weight of one layer, or of the embedding, final
  norm and head, in the order they are drawn (weights.py). Layers may
  differ from each other.
- ``port_groups(shape)``: (key, layer indices) pairs; the port's tree
  stacks the leaves of those layers along a leading axis under ``key``.
  The layers of one group have the same leaves.
- ``reference_layer(shape, layer, weights, precision)``: the plain
  reference's layer ``layer``, a callable on the residual stream x [T, d]
  in float32, built from the shared blocks of ``reference/model.py``.
- ``costs(shape)``: one dict a layer, which flops.py sums over layers:
  ``matmul_params`` (parameters one position multiplies through),
  ``pair_flops`` (operations a (query, key) pair costs), ``kv_bytes``
  (cached bytes a token, read once a decode step), ``window`` (keys a
  query sees; 0: all) and ``qo_bytes`` (a decode step's query and
  output bytes).
- ``DECODE_KERNEL``: part of the name of the port's kernel that runs one
  layer's decode attention, once a layer a step.
"""

from __future__ import annotations

import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
# Directories searched for ``<model_type>.py``, in order.
DIRS = [HERE]
_LOADED: dict = {}


def load(model_type: str):
    """The family module of ``model_type``. Raises LookupError naming the
    file to add where no directory of DIRS holds one."""
    for d in DIRS:
        path = os.path.join(d, f"{model_type}.py")
        if not os.path.isfile(path):
            continue
        if path not in _LOADED:
            spec = importlib.util.spec_from_file_location(
                f"h100bench_family_{model_type}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _LOADED[path] = mod
        return _LOADED[path]
    raise LookupError(
        f"no model family for model_type {model_type!r}: add "
        f"h100bench/families/{model_type}.py (families/__init__.py says "
        f"what it gives)")


def of_config(config: dict):
    """The family of a configuration file's contents."""
    if "model_type" not in config:
        raise LookupError(f"configuration {config.get('name')!r} has no "
                          f"model_type key")
    return load(config["model_type"])


def of(shape: dict):
    """The family of a shape that ``shape(config)`` made."""
    return load(shape["family"])
