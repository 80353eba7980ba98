"""The sharded forward: tensor and expert parallelism driven by one
process.

In the reference, GSPMD does this job: the weights and the KV pool carry
``NamedSharding``s (parallel/shardings.py) and XLA splits the one jitted
forward over the mesh, placing an all-reduce on the output of every
row-parallel matmul. It has no module to twin. Here ``TPModel`` wraps a
family module (models/llama.py, mixtral.py, gpt2.py) and exposes its
interface (``embed_tokens``, ``forward_hidden``, ``unembed``,
``forward``), so the engine's call sites stay as they are, over a
``ShardedParams`` and a ``ShardedKVPages``. Per layer:

- the attention half of every shard runs in turn (projections, RoPE,
  the engine's paged attention over that shard's pool with its kv
  heads, ``wo``) and returns a float32 partial, its product not rounded
  to the activations' dtype (models/quant.py qdot ``f32_product``);
- the partials are summed once, in float32, before the cast and the
  residual add: where the reference's all-reduce sits on the dot
  output. Every shard then reads the same bits;
- the FFN half does the same (SwiGLU over a d_ff slice, Mixtral's
  experts of one slice, or GPT-2's MLP);
- the embedding is vocab-parallel (a masked lookup per shard, then the
  sum), and ``unembed`` concatenates the shards' vocab slices into the
  full logits, so sampling runs once, on them.

Collectives: shards on one device reduce with ``torch.add`` and gather
with ``torch.cat``. Shards on several cards reduce onto the first shard's
card and broadcast back (``torch.cuda.comm``); that branch has not run on
a card yet (ROADMAP 1.16b). These are collectives, not kernels: the
attention kernels run unchanged, once per shard per layer, at the
shard's head counts.
"""

from __future__ import annotations

import types
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tpu_inference_torch.config import ModelConfig
from tpu_inference_torch.models.common import (AttentionFn, residual,
                                               rope_tables)
from tpu_inference_torch.models.llama import layer_params
from tpu_inference_torch.parallel.shardings import ShardedParams


def _unique(devices) -> List[torch.device]:
    out: List[torch.device] = []
    for d in devices:
        if d not in out:
            out.append(d)
    return out


class TPModel:
    """A family module's interface over tp shards (see the module
    docstring). ``devices`` are the shards' devices, in shard order; the
    first is the engine's."""

    def __init__(self, mod: types.ModuleType, devices):
        self.mod = mod
        self.devices = [torch.device(d) for d in devices]
        self.tp = len(self.devices)
        self.home = self.devices[0]
        self._spots = _unique(self.devices)

    # -------------------------------------------------------- collectives

    def spread(self, t: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
        """``t`` (on the home device) on every device a shard sits on."""
        if len(self._spots) == 1:
            return {self.home: t}
        if all(d.type == "cuda" for d in self._spots):
            copies = torch.cuda.comm.broadcast(t, [d.index
                                                   for d in self._spots])
            return dict(zip(self._spots, copies))
        return {d: t.to(d) for d in self._spots}

    def reduce(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Sum of the shards' float32 partials, on the home device; the
        partials of one device are added in shard order."""
        sums: Dict[torch.device, torch.Tensor] = {}
        for p in parts:
            sums[p.device] = p if p.device not in sums else sums[p.device] + p
        if len(sums) == 1:
            return sums[parts[0].device]
        if all(d.type == "cuda" for d in sums):
            return torch.cuda.comm.reduce_add(list(sums.values()),
                                              destination=self.home.index)
        total = sums[self.home]
        for d, s in sums.items():
            if d != self.home:
                total = total + s.to(self.home)
        return total

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' slices concatenated along the last dim, on the
        home device."""
        if len(self._spots) == 1:
            return torch.cat(parts, dim=-1)
        return torch.cat([p.to(self.home) for p in parts], dim=-1)

    # ---------------------------------------------------------- forward

    def _lookup(self, shards: List[dict], cfg: ModelConfig,
                tokens: torch.Tensor) -> torch.Tensor:
        """Vocab-parallel embedding rows: each shard looks up the ids in
        its slice of the table (the global id clamped first, others
        zero), and the rows sum."""
        ids = tokens.clamp(0, cfg.vocab_size - 1)
        on = self.spread(ids)
        parts = []
        for j, p in enumerate(shards):
            tab = p["embed"]
            n = tab.shape[0]
            local = on[self.devices[j]] - j * n
            own = (local >= 0) & (local < n)
            rows = tab[local.clamp(0, n - 1)]
            parts.append(torch.where(own[..., None], rows,
                                     torch.zeros((), dtype=rows.dtype,
                                                 device=rows.device)))
        return self.reduce(parts)

    def embed_tokens(self, params: ShardedParams, cfg: ModelConfig,
                     tokens: torch.Tensor,
                     positions: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Token ids -> the first layer's input (Gemma's scale and
        GPT-2's positions applied once, after the sum)."""
        rows = self._lookup(params.shards, cfg, tokens)
        return self.mod.embed_rows(params.shards[0], cfg, rows, positions)

    def forward_hidden(self, params: ShardedParams, cfg: ModelConfig,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       kv: Any, attn: AttentionFn,
                       on_layer: Optional[Callable[[int, torch.Tensor],
                                                   None]] = None
                       ) -> Tuple[torch.Tensor, Any]:
        """Token ids -> final hidden states on the home device. ``kv``
        is a ShardedKVPages (or None for cache-free attention); ``attn``
        is called with each shard's pool."""
        mod, shards = self.mod, params.shards
        x = self.embed_tokens(params, cfg, tokens, positions)
        rope = ({d: None for d in self._spots} if not mod.USES_ROPE else
                self._spread_pair(rope_tables(positions, cfg.head_dim,
                                              cfg.rope_theta,
                                              cfg.rope_scaling)))
        pools = list(kv.shards) if kv is not None else [None] * self.tp
        n_local = (cfg.n_experts // self.tp) if cfg.family == "mixtral" \
            else 0
        # Row-parallel products stay float32 until the sum (GSPMD's
        # all-reduce adds float32 dot outputs); Mixtral's experts are
        # whole on their shard.
        ffn_kw = [{"expert_lo": j * n_local} if n_local
                  else {"f32_product": True} for j in range(self.tp)]
        for i in range(cfg.n_layers):
            lps = [layer_params(p, i) for p in shards]
            h = self.spread(mod.attn_norm(cfg, lps[0], x))
            parts = []
            for j, lp in enumerate(lps):
                d = self.devices[j]
                part, pools[j] = mod.attn_partial(cfg, i, lp, h[d], pools[j],
                                                  attn, rope[d],
                                                  f32_product=True)
                parts.append(part)
            x = residual(x, self.reduce(parts), _bias(lps[0], mod.ATTN_BIAS))
            h = self.spread(mod.ffn_norm(cfg, lps[0], x))
            parts = [mod.ffn_partial(cfg, lp, h[self.devices[j]],
                                     **ffn_kw[j])
                     for j, lp in enumerate(lps)]
            x = residual(x, self.reduce(parts), _bias(lps[0], mod.FFN_BIAS))
            if on_layer is not None:
                on_layer(i, x)
        return mod.final_norm(shards[0], cfg, x), kv

    def _spread_pair(self, pair):
        cos, sin = (self.spread(t) for t in pair)
        return {d: (cos[d], sin[d]) for d in self._spots}

    def unembed(self, params: ShardedParams, cfg: ModelConfig,
                hidden: torch.Tensor) -> torch.Tensor:
        """Hidden states -> full float32 logits: each shard's vocab
        slice, concatenated."""
        on = self.spread(hidden)
        return self.gather([self.mod.unembed(p, cfg, on[self.devices[j]])
                            for j, p in enumerate(params.shards)])

    def forward(self, params: ShardedParams, cfg: ModelConfig,
                tokens: torch.Tensor, positions: torch.Tensor, kv: Any,
                attn: AttentionFn) -> Tuple[torch.Tensor, Any]:
        hidden, kv = self.forward_hidden(params, cfg, tokens, positions, kv,
                                         attn)
        return self.unembed(params, cfg, hidden), kv


def _bias(lp: dict, key: Optional[str]):
    return lp[key] if key is not None else None
