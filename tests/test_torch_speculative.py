"""The port's speculative-decoding functions and its draft-model mode
against the reference's (tests/test_speculative.py and
tests/test_ngram_spec.py cases, port beside reference).

Function level, on the same seeded inputs and params: ``ngram_propose``
byte-equal over random and echo histories; ``verify_round`` (greedy
rows, repetition-penalty windows included) and ``spec_round`` (greedy
rows) emit the same tokens and acceptance counts, and the verify
forward's logits agree within the model tests' tolerance. Engine level,
draft mode on tiny-llama float32: the port's speculative tokens equal
the reference's and the port's plain tokens, through ``generate``, the
scheduler (the ladder collapses to the top rung, depth 2 falls back to
the synchronous round), optimistic admission with preemption and
recompute-resume, and the prefix cache; a draft equal to the target
accepts every proposal. The port runs its "kernel" backend (plain
versions on CPU tensors) where the reference passes its backend, the
reference its dense backend.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_ladder import VOCAB, pair, port_engine, ref_engine
from tests.test_torch_ladder import sched_run
from tpu_inference import config as jcfg
from tpu_inference.engine import speculative as jspec
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.engine.engine import make_paged_attn as j_attn
from tpu_inference.models import build_model as j_build
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import speculative as tspec
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.engine import make_paged_attn as t_attn
from tpu_inference_torch.engine.sampling import PENALTY_WINDOW
from tpu_inference_torch.models.weights import params_from_numpy

ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=4, prefill_buckets=(16, 32, 64))


# ---------------------------------------------------------------- proposer

def _histories():
    rng = np.random.default_rng(11)
    out = [rng.integers(0, 12, size=n).tolist() for n in (0, 1, 2, 7, 40)]
    out += [rng.integers(0, VOCAB, size=n).tolist() for n in (30, 300)]
    cycle = rng.integers(0, VOCAB, size=9).tolist()
    out += [cycle * 5, (cycle * 3)[:-2], [4, 4, 4, 4],
            rng.integers(0, VOCAB, size=20).tolist() + cycle * 2]
    # Longer than the scan cap: only the trailing NGRAM_SCAN_CAP count.
    out.append(rng.integers(0, 50, size=tspec.NGRAM_SCAN_CAP + 37).tolist())
    return out


@pytest.mark.parametrize("gamma,max_n,min_n", [(4, 3, 1), (1, 1, 1),
                                               (16, 8, 1), (5, 3, 2),
                                               (0, 3, 1)])
def test_ngram_propose_matches_reference(gamma, max_n, min_n):
    assert tspec.NGRAM_SCAN_CAP == jspec.NGRAM_SCAN_CAP
    for hist in _histories():
        got = tspec.ngram_propose(hist, gamma, max_n, min_n)
        want = jspec.ngram_propose(hist, gamma, max_n, min_n)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes(), (hist[-12:], got, want)


# ------------------------------------------------------------ verify_round

def _prefilled(gamma: int, penalty: bool):
    """Port and reference n-gram engines on the same weights with three
    lanes prefilled (slot 3 idle), plus the plain greedy continuation of
    each lane (the oracle proposals)."""
    cfg = dict(ENGINE, spec_mode="ngram", num_speculative_tokens=gamma)
    t, j = port_engine(**cfg), ref_engine(**cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (5, 13, 22)]
    plain = port_engine(**ENGINE).generate(prompts, max_new_tokens=gamma + 2)
    tseqs, jseqs = [], []
    for i, p in enumerate(prompts):
        kw = dict(request_id=i, prompt_tokens=list(p), max_new_tokens=32,
                  repeat_penalty=1.3 if penalty and i != 2 else 1.0,
                  repeat_last_n=16)
        ts, js = Sequence(**kw), JSequence(**kw)
        t.prefill(ts)
        j.prefill(js)
        for s in (ts, js):       # pages for the round's γ+1 rows
            s.pages.extend(
                (t if s is ts else j).allocator.allocate(2))
        tseqs.append(ts)
        jseqs.append(js)
    return t, j, tseqs, jseqs, plain


def _round_arrays(eng, seqs, gamma, plain, penalty):
    b = eng.engine_cfg.max_batch_size
    a = {"tokens": np.zeros((b,), np.int32), "ctx": np.zeros((b,), np.int32),
         "bts": np.zeros((b, eng.max_pages), np.int32),
         "cap": np.zeros((b,), np.int32), "active": np.zeros((b,), bool),
         "drafts": np.zeros((b, gamma), np.int32),
         "n_prop": np.zeros((b,), np.int32),
         "temps": np.zeros((b,), np.float32),
         "top_ps": np.ones((b,), np.float32),
         "top_ks": np.zeros((b,), np.int32),
         "rpens": np.ones((b,), np.float32),
         "rlasts": np.zeros((b,), np.int32),
         "windows": np.full((b, PENALTY_WINDOW), -1, np.int32)}
    for seq in seqs:
        i = seq.slot
        a["tokens"][i] = seq.last_token
        a["ctx"][i] = seq.ctx_len
        a["bts"][i, :len(seq.pages)] = seq.pages
        a["cap"][i] = len(seq.pages) * eng.engine_cfg.page_size
        a["active"][i] = True
        if penalty and seq.repeat_penalty != 1.0:
            a["rpens"][i], a["rlasts"][i] = seq.repeat_penalty, 16
            hist = (seq.prompt_tokens + seq.generated)[-PENALTY_WINDOW:]
            a["windows"][i, -len(hist):] = hist
    # Lane 0: the plain continuation (every proposal right); lane 1: one
    # right, then wrong ones; lane 2: no proposal (a plain step).
    s0, s1 = seqs[0].slot, seqs[1].slot
    a["drafts"][s0] = plain[0][1:1 + gamma]
    a["n_prop"][s0] = gamma
    a["drafts"][s1, :1] = plain[1][1:2]
    a["drafts"][s1, 1:] = (np.asarray(plain[1][2:1 + gamma]) + 1) % VOCAB
    a["n_prop"][s1] = gamma
    return a


def _ref_logits(j, a, s_len):
    ecfg = j.engine_cfg
    toks = jnp.concatenate([jnp.asarray(a["tokens"])[:, None],
                            jnp.asarray(a["drafts"])], axis=1)
    pos = jnp.minimum(jnp.asarray(a["ctx"])[:, None]
                      + jnp.arange(s_len)[None, :], ecfg.max_context - 1)
    valid = (jnp.asarray(a["active"])[:, None]
             & (pos < jnp.asarray(a["cap"])[:, None]))
    attn = j_attn(j.model_cfg, ecfg.page_size, jnp.asarray(a["bts"]), pos,
                  valid, q_offset=jnp.asarray(a["ctx"]),
                  kv_len=jnp.asarray(a["ctx"]) + s_len)
    hidden, _ = j.mod.forward_hidden(j.params, j.model_cfg, toks, pos, j.kv,
                                     attn)
    return np.asarray(j.mod.unembed(j.params, j.model_cfg, hidden))


def _port_logits(t, a, s_len):
    ecfg = t.engine_cfg
    toks = torch.cat([torch.from_numpy(a["tokens"])[:, None],
                      torch.from_numpy(a["drafts"])], dim=1)
    ctx = torch.from_numpy(a["ctx"])
    pos = (ctx[:, None] + torch.arange(s_len, dtype=torch.int32)[None, :]
           ).clamp(max=ecfg.max_context - 1)
    valid = (torch.from_numpy(a["active"])[:, None]
             & (pos < torch.from_numpy(a["cap"])[:, None]))
    attn = t_attn(t.model_cfg, ecfg.page_size, torch.from_numpy(a["bts"]),
                  pos, valid, q_offset=ctx, kv_len=ctx + s_len,
                  attn_backend="kernel")
    hidden, _ = t.mod.forward_hidden(t.params, t.model_cfg, toks, pos, t.kv,
                                     attn)
    return t.mod.unembed(t.params, t.model_cfg, hidden).numpy()


@pytest.mark.parametrize("penalty", [False, True], ids=["plain", "penalty"])
@pytest.mark.parametrize("gamma", [1, 4])
def test_verify_round_matches_reference(gamma, penalty):
    t, j, tseqs, jseqs, plain = _prefilled(gamma, penalty)
    a = _round_arrays(t, tseqs, gamma, plain, penalty)
    assert a["bts"].tolist() == _round_arrays(
        j, jseqs, gamma, plain, penalty)["bts"].tolist()
    s_len = gamma + 1
    jout = jspec.verify_round(
        j, j.params, j.kv, *(jnp.asarray(a[k]) for k in (
            "tokens", "ctx", "bts", "cap", "active", "drafts", "n_prop")),
        jax.random.PRNGKey(0),
        *(jnp.asarray(a[k]) for k in ("temps", "top_ps", "top_ks", "rpens",
                                      "rlasts", "windows")))
    j.kv = jout.kv
    tt = {k: torch.from_numpy(v) for k, v in a.items()}
    tout = tspec.verify_round(
        t, t.params, t.kv, tt["tokens"], tt["ctx"], tt["bts"], tt["cap"],
        tt["active"], tt["drafts"], tt["n_prop"], None, tt["temps"],
        tt["top_ps"], tt["top_ks"], tt["rpens"], tt["rlasts"],
        tt["windows"].long() if penalty else None, all_greedy=True)
    want_emit = np.asarray(jout.emitted)
    want_acc = np.asarray(jout.n_accepted)
    assert tout.emitted.numpy().tolist() == want_emit.tolist()
    assert tout.n_accepted.numpy().tolist() == want_acc.tolist()
    s0, s1, s2 = (s.slot for s in tseqs)
    if not penalty:
        # The oracle lane accepts everything, the half-right lane one.
        assert want_acc[s0] == gamma and want_acc[s1] == min(1, gamma)
    assert want_acc[s2] == 0 and (want_emit[3] == -1).all()
    np.testing.assert_allclose(_port_logits(t, a, s_len),
                               _ref_logits(j, a, s_len), rtol=1e-4,
                               atol=1e-4)


def test_verify_round_sampled_reproduces_by_seed():
    """Sampled rows draw from the engine's generator: the same seed
    gives the same round (reproducible within the port; the draws cannot
    match threefry)."""
    outs = []
    for _ in range(2):
        t, _, tseqs, _, plain = _prefilled(4, False)
        a = _round_arrays(t, tseqs, 4, plain, False)
        a["temps"][:] = 0.8
        tt = {k: torch.from_numpy(v) for k, v in a.items()}
        g = torch.Generator().manual_seed(1)
        out = tspec.verify_round(
            t, t.params, t.kv, tt["tokens"], tt["ctx"], tt["bts"],
            tt["cap"], tt["active"], tt["drafts"], tt["n_prop"], g,
            tt["temps"], tt["top_ps"], tt["top_ks"], tt["rpens"],
            tt["rlasts"], None, all_greedy=False)
        outs.append((out.emitted.tolist(), out.n_accepted.tolist()))
        em = out.emitted.numpy()
        assert ((em >= -1) & (em < VOCAB)).all()
    assert outs[0] == outs[1]


# -------------------------------------------------------------- spec_round

def _draft_cfgs():
    jm, _, tm, _ = pair()
    kw = dict(name="draft", family="llama", vocab_size=VOCAB, d_model=64,
              n_layers=1, n_heads=2, n_kv_heads=2, d_ff=128,
              max_seq_len=1024, rope_theta=10000.0)
    return (jcfg.ModelConfig(dtype=jm.dtype, **kw),
            tcfg.ModelConfig(dtype=tm.dtype, **kw))


def _draft_pair(draft_equals_target: bool = False, **kw):
    """Port and reference draft-mode engines on the same target and draft
    weights (the draft: a 1-layer model from seed 9, or the target
    itself)."""
    jm, jparams, tm, tparams = pair()
    if draft_equals_target:
        jd, jdp, td, tdp = jm, jparams, tm, tparams
    else:
        jd, td = _draft_cfgs()
        jdp, _ = j_build(jd, seed=9)
        tdp = params_from_numpy(jax.device_get(jdp), td, device="cpu")
    cfg = dict(ENGINE, num_speculative_tokens=3)
    cfg.update(kw)
    t = InferenceEngine(tm, tcfg.EngineConfig(**cfg), params=tparams,
                        attn_backend="kernel", device="cpu", draft_cfg=td,
                        draft_params=tdp)
    j = JEngine(jm, jcfg.EngineConfig(**cfg), params=jparams,
                attn_backend="dense", draft_cfg=jd, draft_params=jdp)
    return t, j


def test_spec_round_matches_reference():
    t, j = _draft_pair()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (6, 17, 30)]
    tseqs, jseqs = [], []
    for i, p in enumerate(prompts):
        ts = Sequence(request_id=i, prompt_tokens=list(p), max_new_tokens=9)
        js = JSequence(request_id=i, prompt_tokens=list(p), max_new_tokens=9)
        t.prefill(ts)
        j.prefill(js)
        ts.pages.extend(t.allocator.allocate(1))
        js.pages.extend(j.allocator.allocate(1))
        tseqs.append(ts)
        jseqs.append(js)
    a = _round_arrays(t, tseqs, 3, [[0] * 5] * 3, False)
    jout = jspec.spec_round(
        j, j.params, j.draft_params, j.kv, j.draft_kv,
        *(jnp.asarray(a[k]) for k in ("tokens", "ctx", "bts", "cap",
                                      "active")),
        jax.random.PRNGKey(0),
        *(jnp.asarray(a[k]) for k in ("temps", "top_ps", "top_ks")))
    tt = {k: torch.from_numpy(v) for k, v in a.items()}
    tout = tspec.spec_round(
        t, t.params, t.draft_params, t.kv, t.draft_kv, tt["tokens"],
        tt["ctx"], tt["bts"], tt["cap"], tt["active"], None, tt["temps"],
        tt["top_ps"], tt["top_ks"], all_greedy=True)
    assert tout.emitted.tolist() == np.asarray(jout.emitted).tolist()
    assert tout.n_accepted.tolist() == np.asarray(jout.n_accepted).tolist()
    assert (np.asarray(jout.emitted)[3] == -1).all()


# ------------------------------------------------------- draft-mode engine

def test_draft_engine_tokens_match_reference_and_plain():
    t, j = _draft_pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).tolist() for n in (5, 13, 22)]
    want = port_engine(**ENGINE).generate(prompts, max_new_tokens=20)
    got = t.generate(prompts, max_new_tokens=20)
    assert got == want == j.generate(prompts, max_new_tokens=20)
    assert t.spec_draft and t.spec_drafted > 0
    assert (t.spec_drafted, t.spec_accepted) == (j.spec_drafted,
                                                 j.spec_accepted)
    t.check_pool_clean()


def test_perfect_draft_accepts_everything():
    t, _ = _draft_pair(draft_equals_target=True)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8]]
    want = port_engine(**ENGINE).generate(prompts, max_new_tokens=16)
    assert t.generate(prompts, max_new_tokens=16) == want
    assert t.spec_drafted > 0 and t.spec_accepted == t.spec_drafted
    t.check_pool_clean()


@pytest.mark.parametrize("extra", [
    {"max_batch_size": 16, "decode_ladder": (4, 8, 16)},
    {"decode_pipeline_depth": 2},
    {"admission": "optimistic", "num_pages": 12,
     "optimistic_headroom_pages": 1, "preempt_watermark_pages": 4},
], ids=["ladder", "depth2", "preemption"])
def test_draft_scheduler_matches_reference(extra):
    """Draft mode through both schedulers: the ladder collapses to the
    top rung, depth 2 runs the synchronous round, a tight optimistic
    pool preempts and resumes; tokens equal the reference's and the
    plain engine's."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, size=8).tolist() for _ in range(6)]
    cfg = dict(ENGINE, max_pages_per_seq=8, **extra)
    plain, _ = sched_run(port_engine(**dict(cfg, num_pages=64,
                                            admission="reserve")),
                         prompts, 16)
    t, j = _draft_pair(**cfg)
    want, _ = sched_run(j, prompts, 16, ref=True)
    got, seqs = sched_run(t, prompts, 16)
    assert got == want == plain
    assert all(s.finish_reason == "length" for s in seqs)
    assert t.ladder == j.ladder == (cfg["max_batch_size"],)
    assert t.preemptions_total == j.preemptions_total
    if "admission" in extra:
        assert t.preemptions_total >= 1
    t.check_pool_clean()


def test_draft_composes_with_prefix_cache():
    """The draft pool is the target pool's positional twin: a repeated
    request hits the cache and repeats its tokens and its acceptance."""
    t, _ = _draft_pair(num_pages=128, max_pages_per_seq=8,
                       num_speculative_tokens=2, host_cache_pages=16)
    assert t.prefix_cache is not None and t.host_pool is None
    prompt = [list(range(3, 20))]
    cold = t.generate(prompt, max_new_tokens=8)
    cold_acc = (t.spec_accepted, t.spec_drafted)
    hits0 = t.prefix_cache.hits_hbm.value
    warm = t.generate(prompt, max_new_tokens=8)
    assert t.prefix_cache.hits_hbm.value > hits0 and cold == warm
    assert (t.spec_accepted - cold_acc[0],
            t.spec_drafted - cold_acc[1]) == cold_acc
    t.check_pool_clean()


def test_draft_mode_turns_repeat_penalty_off():
    t, j = _draft_pair()
    kw = dict(request_id=0, prompt_tokens=[1], max_new_tokens=1,
              repeat_penalty=1.3, repeat_last_n=32)
    assert t._penalty_arrays(Sequence(**kw)) == j._penalty_arrays(
        JSequence(**kw)) == (1.0, 0)


def test_draft_warmup_writes_only_the_trash_page():
    t, _ = _draft_pair()
    assert t.warmup() >= 0.0
    for pool in (t.kv, t.draft_kv):
        assert not pool.k[:, 1:].any() and not pool.v[:, 1:].any()


def test_draft_vocab_must_match():
    _, _, tm, tparams = pair()
    bad = dataclasses.replace(_draft_cfgs()[1], vocab_size=VOCAB * 2)
    with pytest.raises(ValueError, match="vocab"):
        InferenceEngine(tm, tcfg.EngineConfig(**ENGINE,
                                              num_speculative_tokens=2),
                        params=tparams, device="cpu", draft_cfg=bad)
