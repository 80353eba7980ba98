"""Sharding specs for model params and the paged KV pool (PyTorch twin
of ``tpu_inference/parallel/shardings.py``).

Megatron-style tensor parallelism, as in the reference:

- QKV projections shard the *head* (output) dim; the attention output
  projection shards its *input* dim: one reduction per attention block.
- SwiGLU gate/up shard the hidden (f) dim; down shards its input: one
  reduction per FFN.
- Mixtral experts shard the *expert* dim over the same ``tp`` axis
  (expert parallelism).
- Embedding and lm_head shard the vocab dim (vocab-parallel logits).
- KV pages shard the kv-head dim, so a shard's pool slice lines up with
  its head-sharded K/V projections.

The reference annotates ``jax.sharding.PartitionSpec``s and lets GSPMD
place the collectives. There is no PartitionSpec here: ``P`` is a small
tuple of axis names, one per dim, and ``shard_params`` narrows every
leaf along it into one parameter dict per tp shard (``ShardedParams``),
which parallel/tp.py drives. A documented difference: GPT-2's packed
``w_qkv``/``b_qkv`` carry ``packed=3``, so q, k and v are each split by
heads (the reference splits the packed dim contiguously and lets GSPMD
reshard around the q/k/v split; the function is the same).
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models.quant import QUANT_KEYS, QuantizedArray
from tpu_inference_torch.parallel.mesh import Mesh


class P(tuple):
    """A partition spec: one entry per leading dim, an axis name
    (``"tp"``) or None; dims past the entries are replicated.
    ``packed`` > 1 marks a dim that packs that many equal projections,
    each split over the axis on its own."""

    def __new__(cls, *entries, packed: int = 1):
        self = super().__new__(cls, entries)
        self.packed = packed
        return self


class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec


def _llama_specs(cfg: ModelConfig) -> dict:
    specs = {
        "embed": P("tp", None),
        "blocks": {
            "attn_norm": P(),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "ffn_norm": P(),
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        },
        "final_norm": P(),
    }
    if cfg.qkv_bias:
        # Qwen2 q/k/v biases follow their projection's head (output) dim.
        specs["blocks"]["bq"] = P(None, "tp")
        specs["blocks"]["bk"] = P(None, "tp")
        specs["blocks"]["bv"] = P(None, "tp")
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "tp")
    return specs


def _mixtral_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": P("tp", None),
        "blocks": {
            "attn_norm": P(),
            "wq": P(None, None, "tp"),
            "wk": P(None, None, "tp"),
            "wv": P(None, None, "tp"),
            "wo": P(None, "tp", None),
            "ffn_norm": P(),
            "w_router": P(),
            # Expert parallelism: experts distributed over the tp axis.
            "w_gate": P(None, "tp", None, None),
            "w_up": P(None, "tp", None, None),
            "w_down": P(None, "tp", None, None),
        },
        "final_norm": P(),
        "lm_head": P(None, "tp"),
    }


def _gpt2_specs(cfg: ModelConfig) -> dict:
    # w_qkv packs [q|k|v] along the output dim: each of the three is
    # split by heads (packed=3), so a shard holds [q_i|k_i|v_i].
    return {
        "embed": P("tp", None),
        "pos_embed": P(),
        "blocks": {
            "ln1_w": P(), "ln1_b": P(),
            "w_qkv": P(None, None, "tp", packed=3),
            "b_qkv": P(None, "tp", packed=3),
            "w_proj": P(None, "tp", None),
            "b_proj": P(),
            "ln2_w": P(), "ln2_b": P(),
            "w_fc": P(None, None, "tp"),
            "b_fc": P(None, "tp"),
            "w_out": P(None, "tp", None),
            "b_out": P(),
        },
        "ln_f_w": P(), "ln_f_b": P(),
    }


def validate_tp(cfg: ModelConfig, tp: int) -> None:
    """Fail fast (with a named dimension) when tp can't evenly shard the
    model, before any weight is materialized."""
    checks = [
        ("n_heads", cfg.n_heads),
        ("n_kv_heads", cfg.n_kv_heads),
        ("d_ff", cfg.d_ff),
        ("vocab_size", cfg.vocab_size),
    ]
    if cfg.n_experts:
        checks.append(("n_experts", cfg.n_experts))
    for name, dim in checks:
        if dim % tp != 0:
            raise ValueError(
                f"tp={tp} does not divide {name}={dim} for model "
                f"{cfg.name!r}; choose tp from the divisors of {name}")


def param_specs(cfg: ModelConfig) -> dict:
    """Spec tree with the same structure as the family's params."""
    fam = {"llama": _llama_specs, "mixtral": _mixtral_specs,
           "gpt2": _gpt2_specs}[cfg.family]
    return fam(cfg)


def _scale_spec(spec: P, q_ndim: int, n_groups: int) -> P:
    """Spec for a QuantizedArray's scale: the weight's, except that an
    int8 scale's size-1 contraction dim is replicated; an int4 scale's
    G groups follow the weight's contraction-dim split."""
    entries = list(spec) + [None] * (q_ndim - len(spec))
    if n_groups == 1:
        entries[q_ndim - 2] = None
    return P(*entries, packed=spec.packed)


def _map_specs(fn, specs, params):
    """fn(spec, leaf) over the spec tree and the params tree together
    (a structure mismatch raises)."""
    if isinstance(specs, P):
        return fn(specs, params)
    if set(specs) != set(params):
        raise ValueError(f"spec and params trees differ: "
                         f"{sorted(specs)} vs {sorted(params)}")
    return {k: _map_specs(fn, specs[k], params[k]) for k in specs}


def _check_groups(spec: P, leaf: QuantizedArray, sspec: P,
                  mesh: Mesh) -> None:
    ngrp = leaf.scale.shape[-2]
    nd = leaf.q.ndim
    axis = sspec[nd - 2] if len(sspec) >= nd - 1 else None
    if ngrp > 1 and axis is not None:
        n = int(mesh.shape.get(axis, 1))
        if ngrp % n:
            raise ValueError(
                f"int4 grouped scales: {ngrp} groups on a "
                f"contraction dim sharded over {axis}={n} don't "
                f"divide evenly; use a tp that divides the group "
                f"count (dim/{2 * leaf.q.shape[-2] // ngrp}, "
                "codes nibble-packed) or --quant int8")


def param_shardings(cfg: ModelConfig, mesh: Mesh,
                    params: Optional[dict] = None) -> Any:
    """NamedSharding tree for the family's params.

    Without ``params`` the tree mirrors ``param_specs`` (plain leaves).
    With ``params`` (possibly holding ``QuantizedArray`` leaves) it
    mirrors the params tree: the codes take the weight's spec, the scale
    the same spec with an int8 scale's contraction dim replicated."""
    validate_tp(cfg, mesh.shape.get("tp", 1))
    specs = param_specs(cfg)
    if params is None:
        return _map_specs(lambda s, _: NamedSharding(mesh, s), specs,
                          specs)

    return _map_specs(lambda spec, leaf: leaf_sharding(spec, leaf, mesh),
                      specs, params)


def leaf_sharding(spec: P, leaf: Any, mesh: Mesh):
    """One leaf's NamedSharding (a QuantizedArray of two for a quantized
    leaf); raises when an int4 leaf's scale groups do not split evenly.
    ``leaf`` may be a meta tensor of the unsharded shape."""
    if isinstance(leaf, QuantizedArray):
        sspec = _scale_spec(spec, leaf.q.ndim, leaf.scale.shape[-2])
        _check_groups(spec, leaf, sspec, mesh)
        return QuantizedArray(NamedSharding(mesh, spec),
                              NamedSharding(mesh, sspec))
    return NamedSharding(mesh, spec)


def shard_dim(spec: P) -> Optional[int]:
    """The dim a spec splits over tp, or None when replicated."""
    return spec.index("tp") if "tp" in spec else None


def narrow(t: torch.Tensor, spec: P, shard: int, n: int) -> torch.Tensor:
    """Shard ``shard`` of ``n`` of ``t`` along ``spec`` (a view, except
    for a packed dim, whose pieces are concatenated)."""
    dim = shard_dim(spec)
    if dim is None or n == 1:
        return t
    size = t.shape[dim]
    if spec.packed > 1:
        part = size // spec.packed
        c = part // n
        return torch.cat([t.narrow(dim, p * part + shard * c, c)
                          for p in range(spec.packed)], dim=dim)
    c = size // n
    return t.narrow(dim, shard * c, c)


def unnarrow(pieces: List[torch.Tensor], spec: P) -> torch.Tensor:
    """The full tensor whose ``narrow`` along ``spec`` gives ``pieces``
    (shard order); a replicated spec gives the first piece."""
    dim = shard_dim(spec)
    if dim is None or len(pieces) == 1:
        return pieces[0]
    if spec.packed > 1:
        c = pieces[0].shape[dim] // spec.packed
        return torch.cat([t.narrow(dim, p * c, c) for p in
                          range(spec.packed) for t in pieces], dim=dim)
    return torch.cat(pieces, dim=dim)


def shard_shape(shape, spec: P, n: int) -> tuple:
    """The shape of one of ``n`` shards of a ``shape`` tensor cut along
    ``spec`` (``narrow``'s result shape)."""
    out = list(shape)
    dim = shard_dim(spec)
    if dim is not None and n > 1:
        out[dim] //= n
    return tuple(out)


class ShardedParams:
    """One parameter dict per tp shard (shard ``i`` on the mesh's tp
    device ``i``), with the NamedSharding tree they were cut along (for
    global counts: a replicated leaf counts once)."""

    def __init__(self, shards: List[dict], shardings: Any):
        self.shards = shards
        self.shardings = shardings

    def __len__(self) -> int:
        return len(self.shards)

    def named_tensors(self):
        """(path, tensor, replicated) for every tensor of every shard
        (quantized leaves give their codes and scales)."""
        for j, tree in enumerate(self.shards):
            yield from _named(tree, self.shardings, f"shard{j}/")

    def global_totals(self) -> tuple:
        """(elements, bytes) of the unsharded model: sharded tensors sum
        over the shards, replicated ones count once."""
        n = nbytes = 0
        for path, t, replicated in self.named_tensors():
            if replicated and not path.startswith("shard0/"):
                continue
            n += t.numel()
            nbytes += t.numel() * t.element_size()
        return n, nbytes


def _named(tree, shardings, prefix: str):
    for k, v in tree.items():
        sh = shardings[k]
        if isinstance(v, dict):
            yield from _named(v, sh, f"{prefix}{k}/")
        elif isinstance(v, QuantizedArray):
            yield (f"{prefix}{k}.q", v.q, shard_dim(sh.q.spec) is None)
            yield (f"{prefix}{k}.scale", v.scale,
                   shard_dim(sh.scale.spec) is None)
        else:
            yield f"{prefix}{k}", v, shard_dim(sh.spec) is None


def _place(t: torch.Tensor, device) -> torch.Tensor:
    if t.is_meta or t.device == torch.device(device):
        return t
    return t.to(device)


def shard_params(params: dict, cfg: ModelConfig, mesh: Mesh
                 ) -> ShardedParams:
    """Cut a params dict into one dict per tp shard along
    ``param_specs``, each placed on its shard's device. On the device
    the params already live on, a shard's leaves are views of the full
    ones (no copy), except GPT-2's packed q/k/v. Meta tensors stay meta
    (an abstract sharded template, models/weights.py ``load_native``)."""
    return cut_params(params, param_shardings(cfg, mesh, params),
                      mesh.tp_devices())


def cut_params(params: dict, shardings: Any, devices: list
               ) -> ShardedParams:
    """``params`` cut along the NamedSharding tree ``shardings``, shard
    ``j`` placed on ``devices[j]`` (shard_params's body)."""
    n = len(devices)

    def cut(tree, sh, j):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = cut(v, sh[k], j)
            elif isinstance(v, QuantizedArray):
                out[k] = QuantizedArray(
                    _place(narrow(v.q, sh[k].q.spec, j, n), devices[j]),
                    _place(narrow(v.scale, sh[k].scale.spec, j, n),
                           devices[j]))
            else:
                out[k] = _place(narrow(v, sh[k].spec, j, n), devices[j])
        return out

    return ShardedParams([cut(params, shardings, j) for j in range(n)],
                         shardings)


def unquantized_matmuls(params: ShardedParams) -> List[str]:
    """QUANT_KEYS leaves of shard 0 that hold plain tensors."""
    out = []

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            elif k in QUANT_KEYS and not isinstance(v, QuantizedArray):
                out.append(prefix + k)

    walk(params.shards[0], "")
    return out


def kv_spec() -> P:
    """KV pool [L, pages, page_size, Hkv, head_dim]: kv heads on tp."""
    return P(None, None, None, "tp", None)


def kv_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, kv_spec())


def kv_scale_sharding(mesh: Mesh) -> NamedSharding:
    """Scale pool [L, pages, page_size, Hkv] (quantized KV): heads on
    tp, aligned with the code pool."""
    return NamedSharding(mesh, P(None, None, None, "tp"))
