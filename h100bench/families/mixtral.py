"""Mixtral-8x7B (``model_type`` "mixtral"): Mistral's attention with a
sparse MoE FFN, served by the port's mixtral path.

Written from the Mixtral paper (arXiv:2401.04088) and ``config.json``:
the router's top-k logits (``num_experts_per_tok``) are softmaxed into
weights that sum to 1, and each token's output is the weighted sum of
its k experts' SwiGLU MLPs, every routed pair computed (the published
model drops none; the configuration sets the port's capacity so that it
drops none either).
"""

from __future__ import annotations

import torch

from h100bench import families
from h100bench.reference import model

mistral = families.load("mistral")
DECODE_KERNEL = mistral.DECODE_KERNEL


def shape(config: dict) -> dict:
    return {**mistral.shape(config),
            "experts": int(config["num_local_experts"]),
            "top_k": int(config["num_experts_per_tok"])}


def port_fields(s: dict, config: dict) -> dict:
    port = config.get("port", {})
    return {**mistral.port_fields(s, config), "family": "mixtral",
            "n_experts": s["experts"], "n_experts_per_tok": s["top_k"],
            "expert_capacity_factor": float(port.get(
                "expert_capacity_factor", 2.0))}


def layer_leaves(s: dict, layer: int) -> list:
    d, f, e = s["d"], s["d_ff"], s["experts"]
    return mistral.attn_leaves(s) + [
        ("w_router", (d, e), True), ("w_gate", (e, d, f), True),
        ("w_up", (e, d, f), True), ("w_down", (e, f, d), True)]


top_leaves = mistral.top_leaves
port_groups = mistral.port_groups


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """(expert ids [T, k], weights [T, k]): the weights are the softmax
    over the k largest router logits."""
    logits = x @ w_router.float()
    vals, idx = torch.topk(logits, top_k, dim=-1)
    return idx, torch.softmax(vals, dim=-1)


def moe(x, idx, wts, experts: list) -> torch.Tensor:
    """Each token's routed experts' outputs, weighted: ``experts`` holds
    each expert's (gate, up, down)."""
    out = torch.zeros_like(x)
    for e, mats in enumerate(experts):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            out.index_add_(0, rows, model.swiglu(x[rows], *mats)
                           * wts[rows, slot][:, None])
    return out


class Layer(mistral.Layer):
    def init_ffn(self, w: dict) -> None:
        self.w_router = w["w_router"].float()
        self.experts = [
            tuple(model.Linear(w[n][e], self.precision)
                  for n in ("w_gate", "w_up", "w_down"))
            for e in range(self.s["experts"])]

    def ffn(self, x):
        idx, wts = route(x, self.w_router, self.s["top_k"])
        return moe(x, idx, wts, self.experts)


def reference_layer(s: dict, layer: int, w: dict, precision: str):
    return Layer(s, w, precision)


def costs(s: dict) -> list:
    """The top-k experts' MLPs and the router: active parameters only."""
    c = mistral.attn_costs(s)
    c["matmul_params"] += (3 * s["d"] * s["d_ff"] * s["top_k"]
                           + s["d"] * s["experts"])
    return [c] * s["layers"]
