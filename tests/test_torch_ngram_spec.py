"""The port's n-gram speculation (``spec_mode="ngram"``) against the
reference's (tests/test_ngram_spec.py cases, port beside reference), on
tiny-llama float32 with the same weights.

Pinned: greedy tokens equal to the reference's speculative tokens and to
the port's plain tokens, through ``generate`` and through the scheduler
at every ladder rung, at pipeline depth 2, under optimistic admission
with preemption, recompute-resume and the host tier, and with the prefix
cache; the speculation counters equal to the reference's; the
repetition penalty composing (oracle proposals); the adaptive-γ
trajectory (γ per round, throttles, probe intervals) equal to the
reference's on an adversarial and on an echo stream; the verify widths,
the probe width and the mixed-batch gate; warmup over every (rung,
width); the config and CLI errors; the stats block and the metric
series; the pool clean after every mix.
"""

import numpy as np
import pytest

from tests.test_torch_ladder import (VOCAB, port_engine, ref_engine,
                                     sched_run)
from tpu_inference import config as jcfg
from tpu_inference.engine import engine as jengine_mod
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.engine.scheduler import EngineScheduler as JScheduler
from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.engine import engine as tengine_mod
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler


def _cfg(gamma=4, spec=True, **kw) -> dict:
    base = dict(page_size=8, num_pages=512, max_pages_per_seq=16,
                max_batch_size=4, prefill_buckets=(16, 32, 64))
    if spec:
        base.update(spec_mode="ngram", num_speculative_tokens=gamma)
    base.update(kw)
    return base


def _counters(eng) -> tuple:
    return (eng.spec_drafted, eng.spec_accepted, eng.spec_rounds_total,
            eng.spec_fallback_rounds, eng.spec_throttles_total)


def _prompts(n, seed, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, size=length).tolist() for _ in range(n)]


def test_greedy_identity_engine_matches_reference():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, size=n).tolist()
               for n in (5, 13, 22, 40)]
    want = port_engine(**_cfg(spec=False)).generate(prompts,
                                                    max_new_tokens=48)
    t, j = port_engine(**_cfg()), ref_engine(**_cfg())
    got = t.generate(prompts, max_new_tokens=48)
    assert got == want == j.generate(prompts, max_new_tokens=48)
    assert t.spec_drafted > 0 and t.spec_accepted > 0
    assert t.spec_rounds_total > 0
    assert _counters(t) == _counters(j)
    t.check_pool_clean()


def test_scheduler_every_rung_matches_reference():
    """12 requests through both schedulers with the ladder (4, 8, 16):
    the reference's tokens, the base-rung plain engine's tokens, and the
    ladder really climbed while speculating."""
    prompts = _prompts(12, 7, 6)
    ladder = dict(max_batch_size=16, max_pages_per_seq=8,
                  decode_ladder=(4, 8, 16))
    base, _ = sched_run(port_engine(**_cfg(spec=False, max_pages_per_seq=8)),
                        prompts, 24)
    want, _ = sched_run(ref_engine(**_cfg(**ladder)), prompts, 24, ref=True)
    t = port_engine(**_cfg(**ladder))
    got, _ = sched_run(t, prompts, 24)
    assert got == want == base
    assert t.rung_peak == 16 and t.spec_drafted > 0
    assert t.ladder == (4, 8, 16)
    t.check_pool_clean()


def test_dispatch_ahead_matches_reference():
    """Verify rounds staged into the pipeline (depth 2: sync the round in
    flight, then stage the next) stream the plain tokens."""
    prompts = _prompts(6, 9, 8)
    want = port_engine(**_cfg(spec=False)).generate(prompts,
                                                    max_new_tokens=32)
    cfg = _cfg(decode_pipeline_depth=2, latency_decode_threshold=0)
    ref, _ = sched_run(ref_engine(**cfg), prompts, 32, ref=True)
    t = port_engine(**cfg)
    got, _ = sched_run(t, prompts, 32)
    assert [got[i] for i in range(6)] == want
    assert got == ref
    assert t.spec_rounds_total > 0
    t.check_pool_clean()


def test_preemption_host_tier_matches_reference():
    """A tight optimistic pool with the host tier under n-gram rounds:
    preemption fires, every request resumes and finishes with the plain
    tokens, as in the reference."""
    prompts = _prompts(12, 3, 8)
    want = port_engine(**_cfg(spec=False, max_pages_per_seq=8)).generate(
        prompts, max_new_tokens=16)
    cfg = _cfg(max_batch_size=8, decode_ladder=(2, 4, 8),
               max_pages_per_seq=8, num_pages=16, admission="optimistic",
               optimistic_headroom_pages=1, preempt_watermark_pages=4,
               host_cache_pages=64)
    ref, _ = sched_run(ref_engine(**cfg), prompts, 16, ref=True)
    t = port_engine(**cfg)
    assert t.host_pool is not None
    got, seqs = sched_run(t, prompts, 16)
    assert all(s.finish_reason == "length" for s in seqs)
    assert [got[i] for i in range(12)] == want
    assert got == ref
    assert t.preemptions_total >= 1
    t.check_pool_clean()


def test_prefix_cache_matches_reference():
    """A repeated prompt hits the prefix cache; the warm run repeats the
    cold run's tokens and speculation counts in both packages."""
    prompt = [list(range(3, 40))]
    t, j = port_engine(**_cfg()), ref_engine(**_cfg())
    out = []
    for eng in (t, j):
        cold = eng.generate(prompt, max_new_tokens=24)
        c0 = _counters(eng)
        warm = eng.generate(prompt, max_new_tokens=24)
        assert cold == warm
        out.append((cold, c0, tuple(b - a for a, b in
                                    zip(c0, _counters(eng)))))
    assert out[0] == out[1]
    assert t.prefix_cache.hits_hbm.value > 0
    t.check_pool_clean()


def test_repeat_penalty_composes(monkeypatch):
    """Penalized greedy n-gram output equals the penalized plain output
    and the reference's, first with the real proposer, then with oracle
    proposals of the plain continuation (accepted only when the verify
    rows are penalized as sequential decode penalizes them)."""
    prompts = _prompts(3, 3, 9)

    def run(eng, seq_cls):
        seqs = [seq_cls(request_id=i, prompt_tokens=list(p),
                        max_new_tokens=32, repeat_penalty=1.3,
                        repeat_last_n=32) for i, p in enumerate(prompts)]
        for s in seqs:
            eng.prefill(s)
        while eng.active_sequences():
            eng.decode_steps()
        out = [list(s.generated) for s in seqs]
        for s in seqs:
            eng.release(s)
        return out

    want = run(port_engine(**_cfg(spec=False, decode_steps_per_call=1)),
               Sequence)
    cfg = _cfg(decode_steps_per_call=1)
    t = port_engine(**cfg)
    assert run(t, Sequence) == want == run(ref_engine(**cfg), JSequence)
    assert t.spec_drafted > 0
    ref = {tuple(p): w for p, w in zip(prompts, want)}

    def oracle(hist, gamma, max_n, min_n=1):
        for p, w in ref.items():
            if tuple(hist[:len(p)]) == p:
                done = len(hist) - len(p)
                return np.asarray(w[done:done + gamma], np.int32)
        return np.empty((0,), np.int32)

    monkeypatch.setattr(tengine_mod, "ngram_propose", oracle)
    monkeypatch.setattr(jengine_mod, "ngram_propose", oracle)
    t2, j2 = port_engine(**cfg), ref_engine(**cfg)
    assert run(t2, Sequence) == want == run(j2, JSequence)
    assert t2.spec_accepted >= 0.8 * t2.spec_drafted > 0
    assert _counters(t2) == _counters(j2)
    t2.check_pool_clean()


def _trajectory(eng, seq_cls, prompt, max_new):
    s = seq_cls(request_id=0, prompt_tokens=list(prompt),
                max_new_tokens=max_new)
    eng.prefill(s)
    rounds = []
    while eng.active_sequences():
        eng.decode_steps()
        rounds.append((s.spec_gamma, s.spec_probe_interval,
                       s.spec_probe_countdown,
                       round(s.spec_accept_ewma, 9)) + _counters(eng))
    eng.release(s)
    return list(s.generated), rounds


@pytest.mark.parametrize("stream", ["adversarial", "echo"])
def test_adaptive_gamma_trajectory_matches_reference(stream, monkeypatch):
    """γ, probe interval, countdown and EWMA after every round, and the
    engine counters, equal to the reference's: on an adversarial stream
    (every proposal wrong) the lane throttles to γ=0, probes on the
    narrow width and backs off; on an echo stream it earns and keeps the
    full γ. Tokens equal the plain run's throughout."""
    if stream == "adversarial":
        prompt, max_new = [1, 2, 3, 4, 5, 6], 50
        wrong = (lambda hist, gamma, max_n, min_n=1:
                 np.full((gamma,), 7, np.int32))
        monkeypatch.setattr(tengine_mod, "ngram_propose", wrong)
        monkeypatch.setattr(jengine_mod, "ngram_propose", wrong)
    else:
        # The tiny model falls into a cycle on this prompt.
        prompt = np.random.default_rng(5).integers(0, VOCAB, 12).tolist()
        max_new = 40
    cfg = _cfg(spec_probe_every=8)
    want = port_engine(**_cfg(spec=False)).generate([prompt],
                                                    max_new_tokens=max_new)
    t_tok, t_traj = _trajectory(port_engine(**cfg), Sequence, prompt,
                                max_new)
    j_tok, j_traj = _trajectory(ref_engine(**cfg), JSequence, prompt,
                                max_new)
    assert t_tok == j_tok == want[0]
    assert t_traj == j_traj
    gamma, interval, _, ewma, drafted, accepted, _, fallback, throttles = \
        t_traj[-1]
    if stream == "adversarial":
        assert gamma == 0 and ewma < 0.35 and throttles >= 1
        assert fallback >= 1 and accepted == 0 and interval >= 8
    else:
        assert accepted > 0 and throttles == 0


def test_widths_probe_and_mixed_gate_match_reference():
    t = port_engine(**_cfg(gamma=5, decode_steps_per_call=8))
    j = ref_engine(**_cfg(gamma=5, decode_steps_per_call=8))
    assert t._spec_widths == j._spec_widths == [2, 6]
    for prop in ([9], [9, 9], [9] * 5):
        p = {0: np.array(prop, np.int32)}
        assert t._spec_width_for(p) == j._spec_width_for(p)
    kw = dict(request_id=0, prompt_tokens=[1], max_new_tokens=4,
              spec_gamma=0, spec_probe_countdown=1, spec_probe_interval=48)
    assert t._seq_spec_gamma(Sequence(**kw)) == j._seq_spec_gamma(
        JSequence(**kw)) == 1
    got = []
    for eng, cls in ((t, Sequence), (j, JSequence)):
        seqs = []
        for i in range(4):
            s = cls(request_id=i, prompt_tokens=[1 + i, 2, 3],
                    max_new_tokens=8)
            eng.prefill(s)
            seqs.append(s)
        res = []
        for ewma, props in ((0.5, {seqs[0].slot: [7]}),
                            (0.5, {s.slot: [7, 7, 7] for s in seqs}),
                            (1.0, {seqs[0].slot: [7] * 5})):
            seqs[0].spec_accept_ewma = ewma
            props = {k: np.asarray(v, np.int32) for k, v in props.items()}
            res.append(sorted(eng._gate_mixed_batch(seqs, props)))
        got.append(res)
        for s in seqs:
            s.done = True
            eng.release(s)
    assert got[0] == got[1] == [[], [0, 1, 2, 3], [0]]
    t.check_pool_clean()


def test_warmup_runs_every_rung_and_width(monkeypatch):
    eng = port_engine(**_cfg(max_batch_size=16, decode_ladder=(4, 8, 16),
                             max_pages_per_seq=8))
    shapes = []
    real = eng._verify_fn

    def spy(st, cap, active, drafts, n_prop):
        shapes.append(drafts.shape)
        return real(st, cap, active, drafts, n_prop)

    monkeypatch.setattr(eng, "_verify_fn", spy)
    eng.warmup()
    assert sorted(shapes) == sorted((b, w - 1) for b in (4, 8, 16)
                                    for w in (2, 5))
    assert not eng.kv.k[:, 1:].any() and not eng.kv.v[:, 1:].any()


@pytest.mark.parametrize("args", [
    ("ngram", 4, 3, False), ("draft", 4, 3, True), ("draft", 0, 3, False),
    ("ngram", 4, 3, True), ("ngram", 0, 3, False), ("ngram", 17, 3, False),
    ("ngram", 4, 0, False), ("ngram", 4, 9, False), ("banana", 4, 3, False),
    ("draft", 17, 3, True)])
def test_validate_spec_config_matches_reference(args):
    outcomes = []
    for fn in (tcfg.validate_spec_config, jcfg.validate_spec_config):
        try:
            fn(*args)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_engine_rejects_bad_spec_config():
    with pytest.raises(ValueError, match="spec_mode"):
        port_engine(**_cfg(spec=False, spec_mode="banana"))
    with pytest.raises(ValueError, match="num-speculative-tokens"):
        port_engine(**_cfg(gamma=0))
    from tests.test_torch_speculative import _draft_cfgs
    from tests.test_torch_ladder import pair
    from tpu_inference_torch.engine.engine import InferenceEngine
    _, _, tm, tp = pair()
    with pytest.raises(ValueError, match="draft-model"):
        InferenceEngine(tm, tcfg.EngineConfig(**_cfg()), params=tp,
                        device="cpu", draft_cfg=_draft_cfgs()[1])


@pytest.mark.parametrize("flags,want", [
    ([], ("draft", 0)),
    (["--spec-mode", "ngram"], ("ngram", 4)),
    (["--spec-mode", "ngram", "--num-speculative-tokens", "6",
      "--ngram-window", "5"], ("ngram", 6)),
    (["--draft-model", "tiny-llama"], ("draft", 4)),
    (["--spec-mode", "draft", "--draft-model", "tiny-llama",
      "--num-speculative-tokens", "2"], ("draft", 2)),
    (["--spec-mode", "off"], ("draft", 0)),
    (["--spec-mode", "draft"], "--spec-mode draft requires --draft-model"),
    (["--spec-mode", "off", "--draft-model", "tiny-llama"],
     "--spec-mode off conflicts with --draft-model"),
    (["--spec-mode", "ngram", "--draft-model", "tiny-llama"],
     "--spec-mode ngram does not take --draft-model"),
    (["--spec-mode", "ngram", "--num-speculative-tokens", "0"],
     "--num-speculative-tokens 0: must be in [1, 16]"),
    (["--spec-mode", "ngram", "--ngram-window", "9"],
     "--ngram-window 9: must be in [1, 8]"),
    # As the reference's CLI: the draft's checkpoint is read at boot.
    (["--draft-model", "tiny-llama", "--draft-checkpoint", "/x"],
     ("draft", 4)),
])
def test_cli_spec_mode_resolution(flags, want, capsys):
    """--spec-mode resolves and fails as the reference's CLI does
    ("auto" = draft with --draft-model, else off; γ 0 when off)."""
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    resolve_engine_args)
    p = build_parser()
    args = p.parse_args(flags + ["--host-cache-pages", "0"])
    if isinstance(want, str):
        with pytest.raises(SystemExit):
            resolve_engine_args(args, p)
        assert want in capsys.readouterr().err
        return
    ea = resolve_engine_args(args, p)
    assert (ea["spec_mode"], ea["num_speculative_tokens"]) == want
    tcfg.EngineConfig(**ea)


def test_spec_stats_snapshot_and_metrics():
    eng = port_engine(**_cfg())
    sched = EngineScheduler(eng)
    assert len(eng.generate([[1, 2, 3] * 4], max_new_tokens=12)[0]) == 12
    jeng = ref_engine(**_cfg())
    jsched = JScheduler(jeng)
    jeng.generate([[1, 2, 3] * 4], max_new_tokens=12)
    spec = sched.stats.snapshot(eng)["speculative"]
    assert spec == jsched.stats.snapshot(jeng)["speculative"]
    assert spec["mode"] == "ngram" and spec["gamma"] == 4
    assert spec["rounds"] + spec["fallback_rounds"] > 0
    assert "speculative" not in EngineScheduler(
        port_engine(**_cfg(spec=False))).stats.snapshot(
        port_engine(**_cfg(spec=False)))
    text = telemetry.render_prometheus([({}, eng.telemetry.registry)])
    for name in ("tpu_inf_spec_drafted_total",
                 "tpu_inf_spec_accepted_total",
                 "tpu_inf_spec_acceptance_rate",
                 "tpu_inf_spec_gamma",
                 "tpu_inf_spec_rounds_total",
                 "tpu_inf_spec_fallback_rounds_total",
                 "tpu_inf_spec_throttles_total"):
        assert f"\n{name}" in text or text.startswith(name), name


def test_hybrid_steps_stay_off_under_spec():
    """hybrid_prefill is inert under speculation, as in the reference:
    the scheduler never fuses a chunk, the engine refuses to, and the
    tokens are the plain ones."""
    prompts = [list(range(1, 60)), [5, 6, 7]]
    cfg = _cfg(hybrid_prefill=True, chunked_prefill_size=16,
               prefill_buckets=(16, 32))
    eng = port_engine(**cfg)
    got, _ = sched_run(eng, prompts, 12)
    want = port_engine(**_cfg(spec=False, chunked_prefill_size=16,
                              prefill_buckets=(16, 32))).generate(
        prompts, max_new_tokens=12)
    assert [got[0], got[1]] == want
    assert eng.hybrid_steps_total == 0
    with pytest.raises(RuntimeError, match="speculative"):
        eng.hybrid_step_pipelined(Sequence(request_id=9, prompt_tokens=[1],
                                           max_new_tokens=1))
    eng.check_pool_clean()
