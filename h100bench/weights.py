"""Random weights from the run's seed, made on the device in the type
they are served in.

The benchmark makes the weights, hands them to the port in the port's
layout (every per-layer leaf stacked along a leading layer axis,
matrices ``[in, out]``) and makes them again, one layer at a time, for
the plain reference once the port's state is freed. Each layer's leaves
come from a generator of their own, seeded by (seed, layer), so one
layer is made again without the others: the same calls on the same
device give the same values.

Normal draws with std 0.02 (the published configs' initializer_range),
norm weights 1, in the configuration's ``torch_dtype`` (``shape["dtype"]``).
"""

from __future__ import annotations

import torch

STD = 0.02
_TOP = -1          # the layer index of the embedding, final norm and head
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _layer_seed(seed: int, layer: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15
            + (layer + 2) * 0xBF58476D1CE4E5B9) % (1 << 63)


def layer_leaves(shape: dict) -> list:
    """(name, shape, drawn) of one layer's leaves, in the order they are
    drawn; ``drawn`` False for a norm weight (ones)."""
    d, hd = shape["d"], shape["head_dim"]
    q, kv, f, e = shape["heads"] * hd, shape["kv_heads"] * hd, \
        shape["d_ff"], shape["experts"]
    leaves = [("attn_norm", (d,), False), ("wq", (d, q), True),
              ("wk", (d, kv), True), ("wv", (d, kv), True),
              ("wo", (q, d), True), ("ffn_norm", (d,), False)]
    if e:
        leaves += [("w_router", (d, e), True), ("w_gate", (e, d, f), True),
                   ("w_up", (e, d, f), True), ("w_down", (e, f, d), True)]
    else:
        leaves += [("w_gate", (d, f), True), ("w_up", (d, f), True),
                   ("w_down", (f, d), True)]
    return leaves


def top_leaves(shape: dict) -> list:
    d, v = shape["d"], shape["vocab"]
    return [("embed", (v, d), True), ("final_norm", (d,), False),
            ("lm_head", (d, v), True)]


def _fill(out: dict, leaves: list, seed: int, layer: int) -> None:
    gen = torch.Generator(device=next(iter(out.values())).device)
    gen.manual_seed(_layer_seed(seed, layer))
    for name, _, drawn in leaves:
        if drawn:
            out[name].normal_(0.0, STD, generator=gen)
        else:
            out[name].fill_(1.0)


def layer_weights(shape: dict, seed: int, layer: int, device) -> dict:
    """One layer's leaves (``layer`` -1: the embedding, final norm and
    head), made afresh."""
    dtype = DTYPES[shape["dtype"]]
    leaves = layer_leaves(shape) if layer != _TOP else top_leaves(shape)
    out = {n: torch.empty(s, dtype=dtype, device=device)
           for n, s, _ in leaves}
    _fill(out, leaves, seed, layer)
    return out


def top_weights(shape: dict, seed: int, device) -> dict:
    return layer_weights(shape, seed, _TOP, device)


def port_params(shape: dict, seed: int, device) -> dict:
    """Every weight in the port's parameter tree (models/llama.py and
    models/mixtral.py ``param_shapes``): the same values that
    ``layer_weights``/``top_weights`` make."""
    n_layers, dtype = shape["layers"], DTYPES[shape["dtype"]]
    leaves = layer_leaves(shape)
    blocks = {n: torch.empty((n_layers, *s), dtype=dtype, device=device)
              for n, s, _ in leaves}
    for i in range(n_layers):
        _fill({n: t[i] for n, t in blocks.items()}, leaves, seed, i)
    params = top_weights(shape, seed, device)
    params["blocks"] = blocks
    return params
