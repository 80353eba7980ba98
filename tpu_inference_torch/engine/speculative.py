"""Speculative decoding: propose, target-model verify, exact acceptance.

Twin of ``tpu_inference/engine/speculative.py``. Two proposal sources
share the verify/accept machinery:

- **Draft model** (``spec_mode="draft"``, ``spec_round``): a draft model
  scans γ+1 sequential decode steps, then the target verifies all γ+1
  positions in one forward (Leviathan et al. 2023).
- **N-gram self-drafting** (``spec_mode="ngram"``, ``ngram_propose`` +
  ``verify_round``): the host matches the sequence's last n tokens
  against its own history and proposes the continuation of the most
  recent match (prompt lookup, Saxena 2023). Proposals are one-hot, so
  greedy acceptance is an exact argmax match and sampled acceptance
  stays exact (accept iff u < q_i(d_i); the residual is q with d_i
  zeroed, renormalized).

Both rounds are plain functions of tensors. Attention follows the
reference: ``verify_round`` runs through the engine's backend (on the
card, the prefill kernel at S = γ+1 over the paged context), while
``spec_round`` builds its attention with ``make_paged_attn``'s default,
the dense gather path, for both the draft scan and the target verify,
as the reference does. No KV rollback: rows written for rejected
proposals are dead KV, masked by ``kv_len`` (the host's ctx) and
overwritten when real tokens reach those positions. The pool is
updated in place (kv_cache.write_kv); the returned ``kv`` is the same
object.

Randomness: sampled rows draw from the engine's ``torch.Generator``
(Gumbel-max over log-probabilities), so a run reproduces within the port
from its seed; the draws cannot match the reference's threefry keys.
Greedy rows (temperature <= 0) draw nothing: their probability rows are
one-hot at the argmax and every choice is the argmax.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SpecRoundOut(NamedTuple):
    kv: object               # target KVPages
    draft_kv: object         # draft KVPages
    emitted: torch.Tensor    # [B, gamma+1] int32, -1 padded
    n_accepted: torch.Tensor  # [B] int32 (drafts accepted, excl. bonus)


class VerifyRoundOut(NamedTuple):
    kv: object               # target KVPages
    emitted: torch.Tensor    # [B, gamma+1] int32, -1 padded
    n_accepted: torch.Tensor  # [B] int32 (proposals accepted, excl. final)


# The n-gram proposer scans at most this many trailing history tokens:
# matching is O(scan * n) numpy per sequence per round, and a match far
# behind a long context rarely predicts the present.
NGRAM_SCAN_CAP = 8192


def ngram_propose(history, gamma: int, max_n: int,
                  min_n: int = 1) -> np.ndarray:
    """Prompt-lookup proposal: match the last n tokens of ``history`` (n
    from ``max_n`` down to ``min_n``) against the rest of the history and
    return up to ``gamma`` continuation tokens of the MOST RECENT match.
    The match hypothesis is "the stream repeats with period length -
    start", so the proposal tiles past the end of the history. Host
    numpy; returns an int32 array of length 0..gamma (empty = no
    match)."""
    hist = np.asarray(history[-NGRAM_SCAN_CAP:], dtype=np.int32)
    length = len(hist)
    if gamma <= 0 or length < min_n + 1:
        return np.empty((0,), np.int32)
    for n in range(min(max_n, length - 1), min_n - 1, -1):
        pattern = hist[-n:]
        # Candidate starts 0..length-n-1: the match must end before the
        # final position so at least one continuation token exists.
        windows = np.lib.stride_tricks.sliding_window_view(hist[:-1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + n             # most recent match
            period = length - start
            idx = start + np.arange(gamma) % period
            return hist[idx].astype(np.int32, copy=True)
    return np.empty((0,), np.int32)


def _probs(logits: torch.Tensor, temperature: torch.Tensor,
           top_p: torch.Tensor, top_k: torch.Tensor,
           all_greedy: bool = False) -> torch.Tensor:
    """The engine's sampling distribution per row (temperature + top-k +
    top-p filtered, renormalized); temperature <= 0 is one-hot at the
    argmax. ``all_greedy`` (the host's view of every row) skips the
    filtered branch, whose rows would all be discarded. logits [B, V]
    float32; temperature/top_p [B]; top_k [B]."""
    from tpu_inference_torch.engine.sampling import apply_filters

    vocab = logits.shape[-1]
    greedy = torch.nn.functional.one_hot(
        torch.argmax(logits, -1), vocab).float()
    if all_greedy:
        return greedy
    temp = temperature.clamp_min(1e-6)[:, None]
    scaled = apply_filters(logits / temp, top_k, top_p)
    soft = torch.softmax(scaled, dim=-1)
    return torch.where((temperature <= 0.0)[:, None], greedy, soft)


def _sample_from(probs: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Categorical over probability rows (one-hot rows return their hot
    index). Gumbel-max over ``log(p + 1e-30)``; the uniforms are kept
    above 1e-20, so the noise spread (under 21) never overturns the gap
    of 69 between a one-hot row's hot entry and the rest. ``generator``
    None: every row is one-hot (all greedy), no draw is made."""
    logp = torch.log(probs + 1e-30)
    if generator is None:
        return torch.argmax(logp, dim=-1).int()
    u = torch.rand(probs.shape, generator=generator, device=probs.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logp + gumbel, dim=-1).int()


def _rows_at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows [B, N, ...] -> rows[b, idx[b]] [B, ...]."""
    lanes = torch.arange(rows.shape[0], device=rows.device)
    return rows[lanes, idx.long()]


def _emit(drafts: torch.Tensor, n_acc: torch.Tensor, final: torch.Tensor,
          active: torch.Tensor) -> torch.Tensor:
    """emitted[b] = accepted drafts ++ [final token] ++ -1 padding;
    inactive lanes all -1. drafts [B, g]; n_acc/final/active [B]."""
    b, gamma = drafts.shape
    dev = drafts.device
    slot = torch.arange(gamma + 1, device=dev)[None, :]
    pad = torch.cat([drafts.int(), torch.zeros((b, 1), dtype=torch.int32,
                                               device=dev)], dim=1)
    neg = torch.full_like(pad, -1)
    emitted = torch.where(slot < n_acc[:, None], pad, neg)
    emitted = torch.where(slot == n_acc[:, None], final.int()[:, None],
                          emitted)
    return torch.where(active[:, None], emitted, neg)


@torch.no_grad()
def spec_round(engine, params, draft_params, kv, draft_kv, tokens,
               ctx_lens, block_tables, cap, active, generator, temperature,
               top_p, top_k, all_greedy: bool) -> SpecRoundOut:
    """One propose/verify/accept round of draft-model speculation.

    tokens [B] last sampled (unwritten) token; ctx_lens [B]; cap [B] =
    provisioned token capacity per slot (writes at positions >= cap go to
    the trash page); active [B] bool; temperature/top_p/top_k [B];
    ``all_greedy``: the host's view of ``temperature <= 0`` for every row
    (no draw is made then). Both pools are written in place."""
    from tpu_inference_torch.engine.engine import make_paged_attn

    ecfg = engine.engine_cfg
    gamma = ecfg.num_speculative_tokens
    dev = tokens.device
    gen = None if all_greedy else generator

    # ---------------------------------------------------------- draft
    # gamma+1 steps: the extra step's write (input d_gamma at position
    # ctx+gamma) is what matters: on a full accept that row becomes part
    # of the permanent context and no later step revisits it. Its
    # sampled token and probabilities are discarded.
    tok, ctx = tokens, ctx_lens
    drafts, p_rows = [], []
    for _ in range(gamma + 1):
        positions = ctx.clamp(max=ecfg.max_context - 1)[:, None]
        valid = active[:, None] & (positions < cap[:, None])
        attn = make_paged_attn(engine.draft_cfg, ecfg.page_size,
                               block_tables, positions, valid,
                               q_offset=ctx, kv_len=ctx + 1)
        hidden, draft_kv = engine.draft_mod.forward_hidden(
            draft_params, engine.draft_cfg, tok[:, None], positions,
            draft_kv, attn)
        logits = engine.draft_mod.unembed(draft_params, engine.draft_cfg,
                                          hidden[:, 0])
        p_row = _probs(logits, temperature, top_p, top_k, all_greedy)
        tok = _sample_from(p_row, gen)
        drafts.append(tok)
        p_rows.append(p_row)
        ctx = ctx + 1
    drafts_t = torch.stack(drafts[:gamma], dim=1)             # [B, g]
    p_rows_t = torch.stack(p_rows[:gamma], dim=1)             # [B, g, V]

    # ---------------------------------------------------------- verify
    s_len = gamma + 1
    tokens_in = torch.cat([tokens[:, None], drafts_t], dim=1)
    ar = torch.arange(s_len, device=dev, dtype=torch.int32)[None, :]
    positions = (ctx_lens[:, None] + ar).clamp(max=ecfg.max_context - 1)
    valid = active[:, None] & (positions < cap[:, None])
    attn = make_paged_attn(engine.model_cfg, ecfg.page_size, block_tables,
                           positions, valid, q_offset=ctx_lens,
                           kv_len=ctx_lens + s_len)
    hidden, kv = engine.mod.forward_hidden(params, engine.model_cfg,
                                           tokens_in, positions, kv, attn)
    logits_all = engine.mod.unembed(params, engine.model_cfg, hidden)
    q_rows = torch.stack([_probs(logits_all[:, i], temperature, top_p,
                                 top_k, all_greedy)
                          for i in range(s_len)], dim=1)      # [B, g+1, V]

    # ---------------------------------------------------------- accept
    d_idx = drafts_t.long()[..., None]                        # [B, g, 1]
    q_d = torch.gather(q_rows[:, :gamma], -1, d_idx)[..., 0]
    p_d = torch.gather(p_rows_t, -1, d_idx)[..., 0]           # [B, g]
    if gen is None:
        u = torch.zeros_like(q_d)
    else:
        u = torch.rand(q_d.shape, generator=gen, device=dev)
    accept = u < q_d / p_d.clamp_min(1e-30)
    n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1).int()  # 0..g

    # Correction distribution at the first rejected row; the bonus row
    # when every draft was accepted.
    row = _rows_at(q_rows, n_acc)                             # [B, V]
    p_row_at = _rows_at(p_rows_t, n_acc.clamp(max=gamma - 1))
    resid = (row - p_row_at).clamp_min(0.0)
    resid_sum = resid.sum(dim=-1, keepdim=True)
    corr = torch.where(resid_sum > 1e-12, resid / (resid_sum + 1e-30), row)
    final_dist = torch.where((n_acc == gamma)[:, None], row, corr)
    final_tok = _sample_from(final_dist, gen)
    emitted = _emit(drafts_t, n_acc, final_tok, active)
    return SpecRoundOut(kv=kv, draft_kv=draft_kv, emitted=emitted,
                        n_accepted=torch.where(active, n_acc,
                                               torch.zeros_like(n_acc)))


@torch.no_grad()
def verify_round(engine, params, kv, tokens, ctx_lens, block_tables, cap,
                 active, drafts, n_prop, generator, temperature, top_p,
                 top_k, rpen, rlast, window, all_greedy: bool
                 ) -> VerifyRoundOut:
    """Verify-only round for host-proposed (one-hot) drafts: the
    ``spec_mode="ngram"`` device work, at any ladder rung (B) and any
    width (γ+1 = drafts.shape[1] + 1).

    ``drafts`` [B, gamma] int32, of which only the first ``n_prop[b]``
    are real; the rest are padding and forced rejections, so n_acc <=
    n_prop. The repetition penalty composes: position i's target row is
    penalized against the window rolled with d_1..d_i (``window`` None:
    no lane has a penalty). All-greedy rounds (``all_greedy``) skip the
    filtered softmax and draw nothing. With n_prop == 0 a round is one
    plain decode step (one forward, one emitted token)."""
    from tpu_inference_torch.engine.engine import make_paged_attn
    from tpu_inference_torch.engine.sampling import (apply_repeat_penalty,
                                                     roll_window)

    ecfg = engine.engine_cfg
    gamma = drafts.shape[1]
    s_len = gamma + 1
    dev = tokens.device
    vocab = engine.model_cfg.vocab_size

    # ------------------------------------------------------- verify
    tokens_in = torch.cat([tokens[:, None], drafts], dim=1)
    ar = torch.arange(s_len, device=dev, dtype=torch.int32)[None, :]
    positions = (ctx_lens[:, None] + ar).clamp(max=ecfg.max_context - 1)
    valid = active[:, None] & (positions < cap[:, None])
    attn = make_paged_attn(engine.model_cfg, ecfg.page_size, block_tables,
                           positions, valid, q_offset=ctx_lens,
                           kv_len=ctx_lens + s_len,
                           attn_backend=engine.attn_backend)
    hidden, kv = engine.mod.forward_hidden(params, engine.model_cfg,
                                           tokens_in, positions, kv, attn)
    logits_all = engine.mod.unembed(params, engine.model_cfg, hidden)

    if window is not None:
        # window_i = base window rolled with d_1..d_i: the state the
        # sequential decode would hold if those drafts were its samples
        # (position i's row only matters when they were all accepted).
        rows, win = [], window
        for i in range(s_len):
            rows.append(apply_repeat_penalty(logits_all[:, i], win, rpen,
                                             rlast))
            if i < gamma:
                win = roll_window(win, drafts[:, i], active)
        logits_all = torch.stack(rows, dim=1)

    # ------------------------------------------------------- accept
    if all_greedy:
        # One-hot target rows: accept iff the draft is the argmax, and
        # the final token is the argmax at the first rejected (or bonus)
        # position; the reference's one-hot arithmetic, without the
        # [B, g+1, V] rows.
        best = torch.argmax(logits_all, dim=-1).int()        # [B, g+1]
        accept_d = best[:, :gamma] == drafts
        gen = None
    else:
        q_rows = torch.stack([_probs(logits_all[:, i], temperature, top_p,
                                     top_k) for i in range(s_len)], dim=1)
        q_d = torch.gather(q_rows[:, :gamma], -1,
                           drafts.long()[..., None])[..., 0]
        u = torch.rand(q_d.shape, generator=generator, device=dev)
        accept_d = u < q_d
        gen = generator
    proposed = (torch.arange(gamma, device=dev)[None, :]
                < n_prop[:, None])
    accept = proposed & accept_d
    n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1).int()

    # Final token: at the first rejected PROPOSED position, a draw from
    # the residual q with the rejected draft zeroed; with every proposal
    # accepted (n_acc == n_prop, padding included) the row at n_prop is
    # the model's next-token distribution, the bonus draw.
    if gen is None:
        final_tok = _rows_at(best, n_acc)
    else:
        row = _rows_at(q_rows, n_acc)                         # [B, V]
        d_at = _rows_at(drafts, n_acc.clamp(max=gamma - 1))
        one_hot = torch.nn.functional.one_hot(d_at.long(), vocab).float()
        resid = (row - one_hot).clamp_min(0.0)
        resid_sum = resid.sum(dim=-1, keepdim=True)
        corr = torch.where(resid_sum > 1e-12, resid / (resid_sum + 1e-30),
                           row)
        final_dist = torch.where((n_acc < n_prop)[:, None], corr, row)
        final_tok = _sample_from(final_dist, gen)
    emitted = _emit(drafts, n_acc, final_tok, active)
    return VerifyRoundOut(kv=kv, emitted=emitted,
                          n_accepted=torch.where(active, n_acc,
                                                 torch.zeros_like(n_acc)))
