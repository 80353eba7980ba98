"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn
from the seed and with the longest of them in it, goes through the
plain reference once each: the prompt followed by the served tokens.
At each position where the port served a token, the gap is the
reference's best logit minus the reference's logit of the served token
(0 where the port served the reference's own choice). That holds for
greedy tokens only, and every request of the benchmark is greedy. A
cell compares one statistic of the gaps over the sample (``STATS``): the
widest, or, where the widest swings by its nature, their mean.

The control reads the same gaps for the token that the float8 reference
(``model.forward_logits(precision="fp8")``) puts first at the same
positions; the bf16 witness for the token that the reference computed
as a bf16 server computes puts first.
"""

from __future__ import annotations

import random

import torch

from h100bench.reference import model

STATS = {
    "max": lambda g: max(g),
    "mean": lambda g: sum(g) / len(g),
}


def pick_sample(finished: list, seed: int, min_tokens: int,
                max_requests: int) -> list:
    """Requests of ``finished`` (dicts with ``prompt_ids`` and
    ``generated``) to compare: the longest (prompt and served tokens),
    then others in an order drawn from ``seed`` until ``min_tokens``
    served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)), key=lambda i: (
        -(len(finished[i]["prompt_ids"]) + len(finished[i]["generated"])),
        i))
    first, rest = order[0], sorted(order[1:])
    random.Random(seed).shuffle(rest)
    picked, served = [first], len(finished[first]["generated"])
    for i in rest:
        if served >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(i)
        served += len(finished[i]["generated"])
    return [finished[i] for i in picked]


def _inputs(sample: list) -> list:
    """Token lists the reference reads: the prompt and every served
    token but the last (whose logits nothing was sampled from)."""
    return [list(r["prompt_ids"]) + list(r["generated"][:-1])
            for r in sample]


def _served_rows(sample: list, n: int, lo: int, rows: int):
    """(row indices into a block of ``rows`` logits starting at position
    ``lo`` of sequence n, served token ids, their index among the
    sequence's served tokens) for the served positions in the block."""
    p = len(sample[n]["prompt_ids"])
    first = max(lo, p - 1)
    last = min(lo + rows, p - 1 + len(sample[n]["generated"]))
    pos = list(range(first, last))
    toks = [sample[n]["generated"][q - (p - 1)] for q in pos]
    return [q - lo for q in pos], toks, [q - (p - 1) for q in pos]


def summary(gaps: list) -> dict:
    """Every statistic of STATS over ``gaps``, and the share of positions
    where the token was not the reference's best."""
    if not gaps:
        return {}
    out = {k: f(gaps) for k, f in STATS.items()}
    out["mismatch_share"] = sum(1 for g in gaps if g > 0) / len(gaps)
    return out


def reference_gaps(shape: dict, seed: int, sample: list, device,
                   keep_logits: bool = False) -> dict:
    """The gaps of the served tokens below the float32 reference's best
    logit (``gaps``, one per served token; ``summary``), and with
    ``keep_logits`` the reference's logits at each served position,
    keyed (request, served index), for the control."""
    out = {"gaps": [], "logits": {}}

    def on_logits(n, lo, logits):
        rows, toks, js = _served_rows(sample, n, lo, logits.shape[0])
        if not rows:
            return
        sel = logits[torch.as_tensor(rows, device=logits.device)]
        t = torch.as_tensor(toks, device=logits.device)
        gap = sel.max(dim=-1).values - sel.gather(1, t[:, None])[:, 0]
        out["gaps"] += gap.tolist()
        if keep_logits:
            for r, j in enumerate(js):
                out["logits"][(n, j)] = sel[r].clone()

    model.forward_logits(shape, seed, _inputs(sample), device,
                         on_logits=on_logits)
    out["summary"] = summary(out["gaps"])
    return out


def rival_gaps(shape: dict, seed: int, sample: list, device, ref: dict,
               precision: str) -> dict:
    """The gaps, below the float32 reference's best, of the tokens that
    the reference computed in ``precision`` puts first at the served
    positions (``ref``: reference_gaps with ``keep_logits``)."""
    gaps = []

    def on_logits(n, lo, logits):
        rows, _, js = _served_rows(sample, n, lo, logits.shape[0])
        if not rows:
            return
        pick = logits[torch.as_tensor(rows, device=logits.device)].argmax(-1)
        for r, j in enumerate(js):
            row = ref["logits"][(n, j)]
            gaps.append(float(row.max() - row[pick[r]]))

    model.forward_logits(shape, seed, _inputs(sample), device,
                         precision=precision, on_logits=on_logits)
    return summary(gaps)


def control_gaps(shape: dict, seed: int, sample: list, device) -> dict:
    """The port's statistics, the float8 control's and the bf16
    witness's, over one sample."""
    ref = reference_gaps(shape, seed, sample, device, keep_logits=True)
    return {"port": ref["summary"],
            "control_fp8": rival_gaps(shape, seed, sample, device, ref,
                                      "fp8"),
            "witness_bf16": rival_gaps(shape, seed, sample, device, ref,
                                       "bf16"),
            "tokens": len(ref["gaps"])}
