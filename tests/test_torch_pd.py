"""P/D disaggregation in the port on the CPU, held against the reference
(twins of tests/test_fleet.py's P/D cases).

- The role rule (``resolve_worker_roles``), the ``--pd-ratio`` sizing
  (``pd_worker_roles``) and the CLI's flag resolution equal the
  reference's, errors included; the in-process fleet refuses roles with
  the reference's ValueError.
- Engine level: a live sequence's export (every page of its first
  ``ctx_len`` tokens, the partial final page included) gives the
  reference's tokens, digests and pages in every pool kind; it adopts
  on a decode-role engine with no prefill and the mixed engine's
  tokens; a malformed export recompute-resumes; role-specialized warmup
  dispatches only its own phase.
- Process level: a 1 prefill + 1 decode worker fleet booted from a
  checkpoint the test writes (its weights carry the JAX engine, the
  oracle): tokens equal the oracle's through the handoff and through a
  kill -9 of the decode worker, the surfaces show roles and handoffs,
  the client's trace id reaches both workers' logs, one span tree spans
  three processes, and a corrupt handoff blob is rejected and counted.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from tests import _prom
from tests._leak import assert_pool_clean
# The fleet tests' checkpoint and its JAX oracle (module fixtures).
from tests.test_torch_fleet import (ENGINE_KW, _cfg, _finish,  # noqa: F401
                                    _submit, _wait_states, _want, ckpt,
                                    oracle)
from tpu_inference import config as jcfg
from tpu_inference.engine import autosize as jauto
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import autosize as tauto
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler

# 13 tokens: two KV pages at page_size 8, the second partial (the page
# the drain path recomputes and the live handoff moves verbatim).
PD_PROMPT = [5, 9, 2, 7, 3, 8, 1, 6, 4, 2, 9, 1, 7]


def _outcome(fn, *args, **kw):
    """("ok", value) or ("error", message) of one call."""
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", str(e))


# ------------------------------------------------- the role rule, sizing


@pytest.mark.parametrize("dp,roles,default", [
    (1, (), "mixed"), (3, (), "decode"), (2, ("prefill", "decode"), "mixed"),
    (3, ("prefill", "decode", "decode"), "mixed"), (2, ["decode"] * 2, "x"),
    (2, ("prefill",), "mixed"), (1, ("prefill", "decode"), "mixed"),
    (2, ("prefill", "encode"), "mixed"), (0, (), "prefill"),
    (2, (), "bogus")])
def test_resolve_worker_roles_matches_reference(dp, roles, default):
    assert (_outcome(tcfg.resolve_worker_roles, dp, roles, default)
            == _outcome(jcfg.resolve_worker_roles, dp, roles, default))


@pytest.mark.parametrize("dp,spec,p_rate,d_rate", [
    (2, "1:1", None, None), (4, "1:3", None, None), (5, "2:3", None, None),
    (3, "5:1", None, None), (8, "auto", None, None), (4, "auto", 1e4, 10.0),
    (6, "auto", 50.0, 900.0), (2, "auto", None, None), (1, "1:1", None, None),
    (4, "0:2", None, None), (4, "1-3", None, None), (4, "x:y", None, None)])
def test_pd_worker_roles_matches_reference(dp, spec, p_rate, d_rate):
    assert tauto.PD_DECODE_COST_FACTOR == jauto.PD_DECODE_COST_FACTOR
    assert (_outcome(tauto.pd_worker_roles, dp, spec, p_rate, d_rate)
            == _outcome(jauto.pd_worker_roles, dp, spec, p_rate, d_rate))


_ROLE_FLAGS = ("role", "roles", "pd_ratio", "pd_prompt_rate",
               "pd_decode_rate", "pd_prefill_nice")


@pytest.mark.parametrize("argv", [
    [], ["--dp", "2", "--roles", "prefill,decode"],
    ["--dp", "3", "--role", "decode"],
    ["--dp", "4", "--pd-ratio", "1:3", "--pd-prefill-nice", "5"],
    ["--dp", "4", "--pd-ratio", "auto", "--pd-prompt-rate", "900",
     "--pd-decode-rate", "40"],
    ["--dp", "2", "--roles", "prefill, decode", "--role", "decode"]])
def test_cli_role_flags_match_reference(argv, monkeypatch):
    """The P/D flags parse to the reference's values, and the roles
    resolve by the reference's order: --roles over --pd-ratio over
    --role."""
    from tests.test_torch_server import _reference_parser
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    server_overrides,
                                                    worker_roles_from_args)
    want = _reference_parser(monkeypatch).parse_args(argv)
    got = build_parser().parse_args(argv)
    for name in _ROLE_FLAGS:
        assert getattr(got, name) == getattr(want, name), name
    if want.roles:
        ref = jcfg.resolve_worker_roles(
            want.dp, tuple(r.strip() for r in want.roles.split(",")))
    elif want.pd_ratio:
        ref = jauto.pd_worker_roles(want.dp, want.pd_ratio,
                                    prompt_token_rate=want.pd_prompt_rate,
                                    decode_token_rate=want.pd_decode_rate)
    elif want.role != "mixed":
        ref = jcfg.resolve_worker_roles(want.dp, (), default_role=want.role)
    else:
        ref = ()
    assert worker_roles_from_args(got) == ref
    scfg = tcfg.ServerConfig(**server_overrides(got))
    assert (scfg.worker_roles, scfg.pd_prefill_nice) == \
        (ref, want.pd_prefill_nice)


@pytest.mark.parametrize("argv,message", [
    (["--dp", "2", "--roles", "prefill,decode", "--pd-ratio", "1:1"],
     "pick one"),
    (["--dp", "2", "--roles", "prefill,encode"], "unknown worker role"),
    (["--dp", "3", "--roles", "prefill,decode"], "one role per dp replica"),
    (["--pd-ratio", "1:1"], "needs dp >= 2"),
    (["--dp", "2", "--pd-ratio", "1-1"], "expected 'auto' or 'P:D'"),
    (["--dp", "2", "--roles", "prefill,decode"], "need --fleet subprocess"),
    (["--role", "decode"], "need --fleet subprocess")])
def test_cli_role_errors_are_usage_errors(argv, message, capsys):
    """A bad split is a usage error before any model loads, with the
    reference's message."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    with pytest.raises(SystemExit):
        boot_server(p.parse_args(["--device", "cpu", "--no-warmup",
                                  *argv]), p)
    assert message in capsys.readouterr().err


def test_cli_boots_a_pd_fleet_and_names_its_roles(capsys):
    """The ``--pd-ratio`` split reaches the router (the engine config
    stays mixed: each worker's role and nice increment ride its boot
    envelope), and the split is printed."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    server, _ = boot_server(p.parse_args(
        ["--device", "cpu", "--no-warmup", "--dp", "2", "--fleet",
         "subprocess", "--pd-ratio", "1:1", "--pd-prefill-nice", "3",
         "--num-pages", "64", "--max-pages-per-seq", "8"]), p)
    try:
        group = server.group
        assert group.roles == ["prefill", "decode"] and group.pd_enabled
        assert server.cfg.engine.role == "mixed"
        assert [group._envelope(i)["role"] for i in (0, 1)] == \
            ["prefill", "decode"]
        assert [group._envelope(i)["nice"] for i in (0, 1)] == [3, 0]
    finally:
        server.group.stop(drain=False)
    assert "[pd] worker roles: ['prefill', 'decode']" in \
        capsys.readouterr().err


def test_in_process_fleet_refuses_roles_as_reference(ckpt):
    """Roles need worker processes: the in-process backend raises the
    reference's ValueError, through build_engine_group and build_server;
    the subprocess backend takes them."""
    from tpu_inference.server.http import \
        build_engine_group as j_build_engine_group
    from tpu_inference_torch.server.http import (build_engine_group,
                                                 build_server)

    jref = jcfg.FrameworkConfig(
        model=jcfg.tiny_llama(vocab_size=512),
        engine=jcfg.EngineConfig(**ENGINE_KW),
        server=jcfg.ServerConfig(worker_roles=("prefill",)))
    with pytest.raises(ValueError) as want:
        j_build_engine_group(jref)
    for kw, ekw in (({"worker_roles": ("prefill", "decode")}, {}),
                    ({}, {"role": "decode"})):
        cfg = _cfg(ckpt, fleet="in-process", **kw)
        cfg.engine = tcfg.EngineConfig(**ENGINE_KW, **ekw)
        with pytest.raises(ValueError) as got:
            build_engine_group(cfg, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="need --fleet subprocess"):
        build_server("tiny-llama", warmup=False, device="cpu",
                     role="decode")
    group = build_engine_group(
        _cfg(ckpt, worker_roles=("prefill", "decode")), device="cpu")
    assert group.roles == ["prefill", "decode"]
    group.stop(drain=False)
    with pytest.raises(ValueError, match="unknown engine role"):
        InferenceEngine(tcfg.tiny_llama(vocab_size=512),
                        tcfg.EngineConfig(**ENGINE_KW, role="encode"),
                        device="cpu")


# ------------------------------------------------------- engine level


def _run_sched(sched_cls, engine, seq, hook=None, timeout=120.0):
    """One request through a scheduler; (streamed tokens, finished seq,
    scheduler) after a hard stop."""
    sched = sched_cls(engine)
    if hook is not None:
        sched.on_prefill_handoff = hook
    sched.start()
    toks, done, box = [], threading.Event(), {}
    try:
        sched.submit(seq, lambda s, t: toks.append(t),
                     lambda s: (box.update(seq=s), done.set()))
        assert done.wait(timeout), "request did not finish"
    finally:
        sched.stop(drain=False)
    return toks, box["seq"], sched


def _pd_engine(quant, role, **kw):
    return InferenceEngine(
        tcfg.tiny_llama(vocab_size=512),
        tcfg.EngineConfig(**{**ENGINE_KW, "kv_quant": quant, "role": role}),
        device="cpu", **kw)


def _handoff(engine, sched_cls, seq_cls, prompt, max_new, **seq_kw):
    """Prefill ``prompt`` with handoff_after_prefill and capture the live
    export: (first tokens, finished seq, (digests, pages, ctx_len))."""
    captured = {}

    def hook(s):
        captured["export"] = engine.export_sequence_kv_live(s)
        return bool(captured["export"][1])

    seq = seq_cls(request_id=1, prompt_tokens=list(prompt),
                  max_new_tokens=max_new, **seq_kw)
    seq.handoff_after_prefill = True
    toks, fin, _ = _run_sched(sched_cls, engine, seq, hook)
    return toks, fin, captured["export"]


def _resume(engine, sched_cls, seq_cls, prompt, max_new, toks, adopt_kv):
    seq = seq_cls(request_id=2, prompt_tokens=list(prompt),
                  max_new_tokens=max_new)
    seq.generated = list(toks)
    seq.resume_base = len(toks)
    seq.adopt_kv = adopt_kv
    return _run_sched(sched_cls, engine, seq)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_live_export_matches_reference(quant):
    """The same prompt and weights through the reference's engine and the
    port's: the same first token, the same full-page digests, pages
    within float32 tolerance (quantized codes equal, scales within
    tolerance), and after adoption on each side's decode engine the
    same greedy tokens."""
    from tests.test_torch_ladder import pair
    from tpu_inference.engine import kv_cache as rkvc
    from tpu_inference.engine.engine import InferenceEngine as JEngine
    from tpu_inference.engine.engine import Sequence as JSequence
    from tpu_inference.engine.scheduler import EngineScheduler as JSched

    jm, params, tm, tp = pair()
    kw = {**ENGINE_KW, "kv_quant": quant}

    def jengine(role):
        return JEngine(jm, jcfg.EngineConfig(**kw, role=role),
                       params=params, attn_backend="dense")

    def tengine(role):
        return InferenceEngine(tm, tcfg.EngineConfig(**kw, role=role),
                               params=tp, device="cpu")

    j_toks, _, (j_dig, j_pages, j_ctx) = _handoff(
        jengine("prefill"), JSched, JSequence, PD_PROMPT, 16)
    t_toks, _, (t_dig, t_pages, t_ctx) = _handoff(
        tengine("prefill"), EngineScheduler, Sequence, PD_PROMPT, 16)
    assert t_toks == j_toks and len(t_toks) == 1
    assert (t_dig, t_ctx) == (j_dig, j_ctx) == (t_dig, len(PD_PROMPT))
    assert len(t_dig) == 1 and len(t_pages) == len(j_pages) == 2
    for p, q in zip(t_pages, j_pages):
        for f in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(p, f), getattr(q, f)
            if b is None:
                assert a is None
                continue
            a, b = a.numpy(), np.asarray(b)
            if quant != "none" and f in ("k", "v"):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # Each side's export through its own wire format, then adopted.
    j_blob = rkvc.serialize_host_pages(j_pages)
    t_blob = tkvc.serialize_host_pages(t_pages)
    j_rest, _, _ = _resume(jengine("decode"), JSched, JSequence, PD_PROMPT,
                           16, j_toks,
                           (rkvc.deserialize_host_pages(j_blob), j_ctx))
    t_rest, fin, sched = _resume(tengine("decode"), EngineScheduler,
                                 Sequence, PD_PROMPT, 16, t_toks,
                                 (tkvc.deserialize_host_pages(t_blob),
                                  t_ctx))
    assert t_rest == j_rest and sched.stats.prefills == 0
    assert t_toks + t_rest == jengine("mixed").generate(
        [list(PD_PROMPT)], max_new_tokens=16)[0]


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_live_handoff_export_adopt_bit_exact(quant):
    """A live sequence's export on a prefill-role engine, the partial
    final page included, crosses the wire format and adopts on a
    decode-role engine: the adopted pages are byte-equal to the export,
    no prefill runs, nothing is recomputed, and the greedy stream equals
    a mixed engine's, in every pool kind; both pools clean after."""
    src = _pd_engine(quant, "prefill")
    toks_src, fin_src, (digests, pages, ctx) = _handoff(
        src, EngineScheduler, Sequence, PD_PROMPT, 24)
    assert fin_src.finish_reason == "handoff"
    assert len(toks_src) == 1 and src.handoffs_out == 1
    # Every page of ctx_len tokens (13 % 8 != 0: the last one partial);
    # the digests cover the full pages only.
    assert ctx == len(PD_PROMPT) and len(pages) == 2 and len(digests) == 1
    blob = tkvc.serialize_host_pages(pages)
    wire = tkvc.deserialize_host_pages(blob)

    dst = _pd_engine(quant, "decode")
    probe = Sequence(request_id=9, prompt_tokens=list(PD_PROMPT),
                     max_new_tokens=4, adopt_kv=(wire, ctx))
    probe.generated, probe.resume_base = list(toks_src), 1
    dst.adopt_sequence(probe)
    back = tkvc.serialize_host_pages(tkvc.offload_pages(dst.kv, probe.pages))
    assert back == blob
    dst.release(probe)

    toks_dst, fin_dst, sched_dst = _resume(
        dst, EngineScheduler, Sequence, PD_PROMPT, 24, toks_src,
        (tkvc.deserialize_host_pages(blob), ctx))
    assert fin_dst.finish_reason == "length"
    assert sched_dst.stats.prefills == 0
    assert dst.adoptions_in == 2 and dst.swap_in_resumes == 2
    assert fin_dst.adopted and fin_dst.cached_tokens == len(PD_PROMPT) + 1
    want = _pd_engine(quant, "mixed").generate([list(PD_PROMPT)],
                                              max_new_tokens=24)[0]
    assert toks_src + toks_dst == want
    assert_pool_clean(src)
    assert_pool_clean(dst)


def test_handoff_adopt_malformed_blob_recomputes():
    """A handoff whose page list does not match its ctx_len fails to
    adopt: the scheduler counts it, clears the adoption and
    recompute-resumes through the ordinary prefill, with the mixed
    engine's tokens."""
    src = _pd_engine("none", "prefill")
    toks_src, _, (_, pages, ctx) = _handoff(
        src, EngineScheduler, Sequence, PD_PROMPT, 16)
    dst = _pd_engine("none", "decode")
    toks_dst, fin_dst, sched_dst = _resume(
        dst, EngineScheduler, Sequence, PD_PROMPT, 16, toks_src,
        (pages[:-1], ctx))
    assert fin_dst.finish_reason == "length" and not fin_dst.adopted
    assert dst.adoptions_in == 0 and dst.adopt_fallbacks == 1
    assert sched_dst.stats.prefills == 1          # the recompute-resume
    want = _pd_engine("none", "mixed").generate([list(PD_PROMPT)],
                                               max_new_tokens=16)[0]
    assert toks_src + toks_dst == want
    assert_pool_clean(dst)


def _warmup_dispatches(role: str, **ekw) -> dict:
    """Dispatches by kind during one warmup of a ``role`` engine (the
    port has no compile step: each warmup dispatch stands for one shape
    the reference compiles)."""
    eng = InferenceEngine(
        tcfg.tiny_llama(vocab_size=512),
        tcfg.EngineConfig(**{**ENGINE_KW, "max_batch_size": 4,
                             "decode_ladder": (2, 4), **ekw, "role": role}),
        device="cpu")
    counts, depth = {}, [0]
    for name in ("_prefill_fn", "_decode_multi_fn", "_verify_fn",
                 "_hybrid_step_fn"):
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _name=name, **k):
            # Warmup's own dispatches only (a hybrid call runs the
            # others inside it).
            if depth[0] == 0:
                counts[_name] = counts.get(_name, 0) + 1
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1
        setattr(eng, name, counted)
    eng.warmup()
    return counts


@pytest.mark.parametrize("ekw", [
    {}, {"spec_mode": "ngram", "num_speculative_tokens": 2},
    {"hybrid_prefill": True}], ids=["plain", "ngram", "hybrid"])
def test_role_specialized_warmup_shrinks_compile_set(ekw):
    """A prefill-role warmup dispatches only prefills, a decode-role one
    only decode calls and verify rounds; each is strictly smaller than
    the mixed set and the two together cover it (hybrid calls, which
    need both phases, only on a mixed engine)."""
    mixed = _warmup_dispatches("mixed", **ekw)
    pre = _warmup_dispatches("prefill", **ekw)
    dec = _warmup_dispatches("decode", **ekw)
    assert set(pre) == {"_prefill_fn"}
    assert set(dec) <= {"_decode_multi_fn", "_verify_fn"}
    assert 0 < sum(pre.values()) < sum(mixed.values())
    assert 0 < sum(dec.values()) < sum(mixed.values())
    both = {k: pre.get(k, 0) + dec.get(k, 0) for k in set(pre) | set(dec)}
    mixed_no_hybrid = {k: n for k, n in mixed.items()
                       if k != "_hybrid_step_fn"}
    assert both == mixed_no_hybrid
    if ekw.get("hybrid_prefill"):
        assert mixed["_hybrid_step_fn"] > 0


# ------------------------------------------------------ process level


@pytest.fixture(scope="module")
def pd_fleet(ckpt):
    """1 prefill + 1 decode worker, the smallest split topology."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(
        _cfg(ckpt, worker_roles=("prefill", "decode")), device="cpu")
    group.start()
    yield group
    group.stop(drain=False)
    assert all(h.proc.poll() is not None for h in group.workers)


def test_pd_fleet_handoff_byte_identity_and_surfaces(pd_fleet, oracle):
    """New prompts admit to the prefill worker, settle, hand off and
    decode on the decode worker with the oracle's tokens and no
    recompute; roles, backlog, occupancy and the handoff counters show
    in /healthz, stats and the Prometheus scrape; the prefill worker
    launched no decode step and the decode worker no prefill."""
    _wait_states(pd_fleet)
    handoffs0 = pd_fleet.pd_handoffs
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [4, 4, 4, 4], PD_PROMPT]
    pend = [_submit(pd_fleet, 6000 + i, p, 16)
            for i, p in enumerate(prompts)]
    for (toks, done, box), p in zip(pend, prompts):
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, p, 16)
    assert pd_fleet.pd_handoffs >= handoffs0 + len(prompts)
    assert pd_fleet.pd_handoff_recomputes == 0

    sup = pd_fleet.stats_snapshot()["supervision"]
    assert sup["roles"] == ["prefill", "decode"]
    assert sup["pd_handoffs"] >= len(prompts)
    assert sup["pd_adoptions"] >= len(prompts)
    assert sup["pd_handoff_recomputes"] == 0
    assert sup["phases"]["pd_handoff_s"]["count"] >= len(prompts)
    hs = pd_fleet.health_snapshot()
    assert [r["role"] for r in hs["replicas"]] == ["prefill", "decode"]
    for r in hs["replicas"]:
        assert "prefill_backlog" in r and "ladder_occupancy" in r
    assert hs["replicas"][0]["pd_handoffs"] >= len(prompts)
    assert hs["replicas"][1]["pd_adoptions"] >= len(prompts)
    assert hs["replicas"][1]["pd_adopt_fallbacks"] == 0
    pt = pd_fleet.prometheus_text()
    assert 'tpu_inf_worker_role_info{replica="0",role="prefill"}' in pt
    assert 'tpu_inf_worker_role_info{replica="1",role="decode"}' in pt
    assert "tpu_inf_pd_handoffs_total" in pt
    assert "tpu_inf_pd_handoff_recomputes_total 0" in pt
    assert "tpu_inf_pd_handoff_seconds_bucket" in pt
    # Role separation: no decode call on the prefill worker, no prefill
    # on the decode worker.
    prefill, decode = (w["stats"] for w in pd_fleet.worker_stats())
    assert (prefill["role"], decode["role"]) == ("prefill", "decode")
    assert prefill["prefills"] >= len(prompts) and prefill["steps"] == 0
    assert decode["prefills"] == 0 and decode["steps"] > 0


def test_pd_handoff_races_decode_restart(pd_fleet, oracle):
    """kill -9 the decode worker after it adopted a handoff and streamed
    tokens: the kept blob is stale, so the failover recompute-resumes
    (on the prefill worker, the only one routable) with the oracle's
    tokens and counts the recompute; the decode worker comes back under
    its replica label and role."""
    _wait_states(pd_fleet)
    recomputes0 = pd_fleet.pd_handoff_recomputes
    prompt = [8, 1, 8, 2, 8, 3]
    toks, done, box = _submit(pd_fleet, 7000, prompt, 40)
    deadline = time.monotonic() + 60
    while len(toks) < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(toks) >= 6
    with pd_fleet._lock:
        holder = pd_fleet._tracked[7000].worker.replica
    assert holder == 1
    pd_fleet.apply_chaos({"replica": 1, "kill": "kill9"})

    fin = _finish(done, box)
    assert fin.finish_reason == "length"
    assert toks == _want(oracle, prompt, 40)
    assert pd_fleet.pd_handoff_recomputes > recomputes0
    _wait_states(pd_fleet)
    assert pd_fleet.health_snapshot()["replicas"][1]["restarts"] >= 1
    assert pd_fleet.health_snapshot()["replicas"][1]["role"] == "decode"
    pt = pd_fleet.prometheus_text()
    assert 'tpu_inf_worker_role_info{replica="1",role="decode"} 1' in pt
    # The restarted decode worker adopts again.
    toks, done, box = _submit(pd_fleet, 7001, PD_PROMPT, 8)
    assert _finish(done, box).finish_reason == "length"
    assert toks == _want(oracle, PD_PROMPT, 8)


def test_retry_on_the_sending_worker_does_not_block_its_reader(ckpt):
    """A finish the router retries may go back to the worker that sent
    it (here the only one, as a handoff goes back to the prefill worker
    while the decode worker is down): the resubmit runs off that
    connection's reader thread, so its reply arrives instead of the RPC
    deadline passing."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=1), device="cpu")
    group.start()
    try:
        group.apply_chaos({"step_failure_rate": 1.0})
        t0 = time.monotonic()
        toks, done, box = _submit(group, 9100, [1, 2, 3], 4)
        assert _finish(done, box, timeout=30.0).finish_reason == "error"
        assert time.monotonic() - t0 < 20.0
        assert group.retries_attempted == 1 and group.rpc_timeouts == 0
    finally:
        group.stop(drain=False)


def test_handoff_trace_id_in_worker_logs(ckpt, oracle, tmp_path):
    """The client's trace id appears in both workers' structured logs
    for a handed-off request (the prefill worker's request_finish with
    reason "handoff", the decode worker's terminal one) and in both
    workers' /debug/requests timelines. The workers inherit fd 2, here a
    file, so the test reads their real stderr."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    log_path = tmp_path / "workers.stderr"
    log_fd = os.open(str(log_path), os.O_CREAT | os.O_WRONLY, 0o600)
    saved = os.dup(2)
    prior = os.environ.get("TPU_INF_LOG")
    os.environ["TPU_INF_LOG"] = "info"
    try:
        os.dup2(log_fd, 2)
        try:
            group = ProcessEngineGroup(
                _cfg(ckpt, worker_roles=("prefill", "decode")),
                device="cpu")
            group.start()
        finally:
            os.dup2(saved, 2)
    finally:
        os.close(saved)
        os.close(log_fd)
        if prior is None:
            os.environ.pop("TPU_INF_LOG", None)
        else:
            os.environ["TPU_INF_LOG"] = prior
    tid = "cli-e2e-7f3a"
    try:
        _wait_states(group)
        toks, done, box = [], threading.Event(), {}
        group.submit(Sequence(request_id=8000, prompt_tokens=list(PD_PROMPT),
                              max_new_tokens=12, trace_id=tid),
                     lambda s, t: toks.append(t),
                     lambda s: (box.update(seq=s), done.set()))
        assert _finish(done, box).finish_reason == "length"
        assert toks == _want(oracle, PD_PROMPT, 12)
        deadline = time.monotonic() + 30
        lines, reasons = [], set()
        while time.monotonic() < deadline:
            lines = [ln for ln in log_path.read_text().splitlines()
                     if '"request_finish"' in ln and tid in ln]
            reasons = {json.loads(ln)["reason"] for ln in lines}
            if {"handoff", "length"} <= reasons:
                break
            time.sleep(0.1)
        assert {"handoff", "length"} <= reasons, \
            log_path.read_text()[-2000:]
        for line in lines:
            assert json.loads(line)["request_id"] == tid
        recent = [t for t in group.recent_snapshot(50)
                  if t["trace_id"] == tid]
        assert {t["finish_reason"] for t in recent} == {"handoff", "length"}
    finally:
        group.stop(drain=False)


def test_handoff_span_tree_three_processes(pd_fleet, oracle):
    """One span tree under the client's trace id from three processes
    (router, prefill worker, decode worker), the handoff export and
    adopt spans adjacent to, and not overlapping, prefill and decode."""
    _wait_states(pd_fleet)
    tid = "cli-span-9b1c"
    toks, done, box = [], threading.Event(), {}
    pd_fleet.submit(Sequence(request_id=8200, prompt_tokens=list(PD_PROMPT),
                             max_new_tokens=12, trace_id=tid),
                    lambda s, t: toks.append(t),
                    lambda s: (box.update(seq=s), done.set()))
    assert _finish(done, box).finish_reason == "length"
    assert toks == _want(oracle, PD_PROMPT, 12)

    snap = pd_fleet.trace_snapshot(tid)
    assert snap is not None
    assert snap["replicas"] == [-1, 0, 1]
    spans = {s["name"]: s for s in snap["spans"]}
    for name in ("request", "route", "handoff", "prefill",
                 "handoff_export", "handoff_adopt", "decode"):
        assert name in spans, (name, sorted(spans))
    assert spans["prefill"]["replica"] == 0
    assert spans["handoff_export"]["replica"] == 0
    assert spans["handoff_adopt"]["replica"] == 1
    assert spans["decode"]["replica"] == 1
    assert snap["tree"]["name"] == "request"

    def end(s):
        return s["ts"] + s["dur"]

    # prefill -> export (one process), -> adopt (across processes: the
    # reference's 5 ms allowance for the per-process clock anchors),
    # -> decode (one process).
    assert end(spans["prefill"]) <= spans["handoff_export"]["ts"] + 1e-6
    assert end(spans["handoff_export"]) \
        <= spans["handoff_adopt"]["ts"] + 5e-3
    assert end(spans["handoff_adopt"]) <= spans["decode"]["ts"] + 1e-6
    pulled = pd_fleet.workers[1].client.rpc("trace", timeout=10.0,
                                            trace=tid)["spans"]
    assert {"handoff_adopt", "decode"} <= {s["name"] for s in pulled}


def test_pd_fleet_scrape_catalog_slo_and_build_info(pd_fleet):
    """The P/D fleet's aggregated scrape parses under the strict parser
    with no duplicate series and carries the SLO and build_info series
    per replica and fleet-level."""
    _wait_states(pd_fleet)
    toks, done, box = _submit(pd_fleet, 8100, [3, 1, 4, 1, 5], 8)
    _finish(done, box)
    pd_fleet._refresh_caches()

    meta, samples = _prom.parse(pd_fleet.prometheus_text())
    seen = set()
    for name, labels, _ in samples:
        key = (name, tuple(sorted(labels.items())))
        assert key not in seen, f"duplicate series {key}"
        seen.add(key)
    assert meta["tpu_inf_slo_ttft_seconds"]["type"] == "gauge"
    assert meta["tpu_inf_slo_tpot_seconds"]["type"] == "gauge"
    assert meta["tpu_inf_slo_breaches_total"]["type"] == "counter"
    assert meta["tpu_inf_build_info"]["type"] == "gauge"
    assert meta["tpu_inf_worker_role_info"]["type"] == "gauge"
    assert meta["tpu_inf_pd_handoffs_total"]["type"] == "counter"

    def rows(name):
        return [(labels, v) for n, labels, v in samples if n == name]

    slo = rows("tpu_inf_slo_ttft_seconds")
    assert len(slo) == 6
    assert {lb.get("q") for lb, _ in slo} == {"0.5", "0.95"}
    fleet_p95 = next(v for lb, v in slo
                     if "replica" not in lb and lb["q"] == "0.95")
    assert fleet_p95 > 0
    binfo = rows("tpu_inf_build_info")
    assert len(binfo) == 3
    for labels, v in binfo:
        assert v == 1.0 and labels["fleet"] == "subprocess"
        assert set(labels) >= {"version", "backend", "kv_quant",
                               "spec_mode", "routing"}
    assert len(rows("tpu_inf_slo_breaches_total")) == 6


def test_corrupt_handoff_blob_rejected_counted_and_recomputed(ckpt, oracle):
    """A handoff blob whose digest fails is rejected and counted by the
    worker, never adopted; the request recompute-resumes with the
    oracle's tokens. (The router's own digest gate is the migration
    path's, tests/test_torch_fleet.py.)"""
    from tpu_inference_torch.server.worker import EngineWorker

    class Conn:
        alive = True

        def __init__(self):
            self.events = []

        def send(self, obj, blob=b"", verb=""):
            self.events.append(obj)

    cfg = _cfg(ckpt, dp=1)
    cfg.engine = dataclasses.replace(cfg.engine, role="decode")
    worker = EngineWorker(cfg, replica=0, socket_path="unused",
                          device="cpu", warmup=False)
    worker.boot()
    try:
        src = InferenceEngine(cfg.model, dataclasses.replace(
            cfg.engine, role="prefill"), params=worker.engine.params,
            device="cpu")
        first, _, (_, pages, ctx) = _handoff(
            src, EngineScheduler, Sequence, PD_PROMPT, 10)
        blob = bytearray(tkvc.serialize_host_pages(pages))
        blob[-3] ^= 0x5A
        conn = Conn()
        worker._verb_submit(conn, {"seq": {
            "request_id": 1, "prompt_tokens": list(PD_PROMPT),
            "max_new_tokens": 10, "generated": first,
            "handoff": {"ctx_len": ctx}}}, bytes(blob))
        deadline = time.monotonic() + 60
        while (not any(e.get("ev") == "finish" for e in conn.events)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        fin = next(e for e in conn.events if e.get("ev") == "finish")
        assert fin["reason"] == "length"
        e = worker.engine
        assert (e.kv_integrity_rejections, e.adopt_fallbacks,
                e.adoptions_in) == (1, 1, 0)
        toks = first + [ev["t"] for ev in conn.events
                        if ev.get("ev") == "token"]
        assert toks == _want(oracle, PD_PROMPT, 10)
        health = worker._verb_healthz(conn, {}, b"")
        assert (health["role"], health["pd_adopt_fallbacks"],
                health["kv_integrity_rejections"]) == ("decode", 1, 1)
    finally:
        worker.sched.stop(drain=False)
