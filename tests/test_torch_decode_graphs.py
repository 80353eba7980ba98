"""Greedy decode calls replayed from captured graphs
(engine/decode_graphs.py), on the CPU, where ``EagerReplay`` stands in
for ``torch.cuda.CUDAGraph``: the static-input path's tokens equal the
eager path's at every ladder rung, K 1 and 8, through ``decode_steps``,
``decode_steps_pipelined`` at depth 2 and ``decode_steps_chained``; the
eligibility rule sends sampled, seeded, penalty, ``--debug-nans``, tp 2
and dense-backend calls to the eager path; the two counters; and the
benchmark's readers of them."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest

from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.engine import decode_graphs, numerics
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.models.registry import build_model

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB = 256
K = 8
ENGINE = dict(page_size=8, num_pages=512, max_pages_per_seq=8,
              max_batch_size=16, decode_ladder=(4, 8, 16),
              prefill_buckets=(16, 32), decode_steps_per_call=K)
# Lanes admitted -> the rung their calls run at.
LANES_RUNG = ((3, 4), (8, 8), (13, 16))


@functools.lru_cache(maxsize=None)
def _model(preset: str):
    cfg = getattr(tcfg, preset)(vocab_size=VOCAB)
    params, _ = build_model(cfg, seed=0, device="cpu")
    return cfg, params


def _engine(preset="tiny_llama", graphs=True, **kw) -> InferenceEngine:
    cfg, params = _model(preset)
    eng = InferenceEngine(cfg, tcfg.EngineConfig(**{**ENGINE, **kw}),
                          params=params, device="cpu")
    if graphs:
        assert eng.capture_decode_graphs(decode_graphs.EagerReplay) is None
    return eng


def _admit(eng, n: int, **seq_kw) -> list:
    rng = np.random.default_rng(n)
    seqs = []
    for i in range(n):
        seq = Sequence(request_id=i, max_new_tokens=40,
                       prompt_tokens=rng.integers(0, VOCAB,
                                                  size=3 + i % 7).tolist(),
                       **seq_kw)
        eng.prefill(seq)
        seqs.append(seq)
    return seqs


def _drive(eng, path: str) -> None:
    if path == "decode_steps":
        for _ in range(3):
            eng.decode_steps(max_steps=1)
            eng.decode_steps()
    elif path.startswith("pipelined"):
        for _ in range(5):
            eng.decode_steps_pipelined()
        eng.drain_pipeline()
    else:
        eng.decode_steps_chained(2)
        eng.decode_steps_chained(1)


def _replays(eng) -> dict:
    return {k: n for k, n in eng._decode_graphs.replays.items() if n}


PATH_K = {"decode_steps": (1, K), "pipelined_depth2": (K,),
          "pipelined_depth3": (K,), "chained": (K,)}


@pytest.mark.parametrize("lanes,rung", LANES_RUNG)
@pytest.mark.parametrize("path", sorted(PATH_K))
def test_replay_tokens_equal_eager(path, lanes, rung):
    """Chained calls read a carry after the next replay (the clone)."""
    depth = int(path[-1]) if path.startswith("pipelined") else 1
    engines = [_engine(graphs=g, decode_pipeline_depth=depth)
               for g in (True, False)]
    got = []
    for eng in engines:
        seqs = _admit(eng, lanes)
        _drive(eng, path)
        got.append([list(s.generated) for s in seqs])
    assert got[0] == got[1]
    assert all(len(t) > 1 for t in got[0])
    graph, eager = engines
    assert _replays(graph).keys() == {(rung, k) for k in PATH_K[path]}
    assert graph.telemetry.decode_graph_eager.value == 0
    assert (graph.telemetry.decode_graph_replays.value
            == sum(_replays(graph).values()))
    assert eager._decode_graphs is None
    assert eager.telemetry.decode_graph_replays.value == 0


@pytest.mark.parametrize("preset,kv_quant", [("tiny_mistral", "none"),
                                             ("tiny_mixtral", "none"),
                                             ("tiny_llama", "int8"),
                                             ("tiny_llama", "int4")])
def test_replay_tokens_equal_eager_across_families(preset, kv_quant):
    got = []
    for g in (True, False):
        eng = _engine(preset, graphs=g, kv_quant=kv_quant)
        seqs = _admit(eng, 6)
        _drive(eng, "decode_steps")
        got.append([list(s.generated) for s in seqs])
        if g:
            assert _replays(eng).keys() == {(8, 1), (8, K)}
    assert got[0] == got[1]


def test_capture_covers_every_rung_and_k():
    eng = _engine()
    assert sorted(eng._decode_graphs.graphs) == [
        (b, k) for b in (4, 8, 16) for k in (1, K)]
    stats = eng.decode_graph_stats()
    assert stats["decode_graphs"] == 6
    assert stats["decode_graph_capture_s"] > 0.0
    assert stats["decode_graph_pool_bytes"] == 0     # no card pool here
    assert _engine(graphs=False).decode_graph_stats() == {
        "decode_graphs": 0, "decode_graph_capture_s": 0.0,
        "decode_graph_pool_bytes": 0}


# A row of each kind beside greedy ones.
ROW_BARS = {"sampled": ({"temperature": 0.8}, "sampled rows"),
            "seeded": ({"temperature": 0.7, "seed": 5}, "sampled rows"),
            "penalty": ({"repeat_penalty": 1.3}, "repetition penalty")}


@pytest.mark.parametrize("kind", sorted(ROW_BARS) + ["debug_nans"])
def test_ineligible_calls_run_eager(kind):
    eng = _engine()
    seqs = _admit(eng, 3)
    if kind == "debug_nans":
        previous = numerics.set_debug_nans(True)
        want = "debug-nans"
    else:
        kw, want = ROW_BARS[kind]
        odd = Sequence(request_id=99, prompt_tokens=[5, 6, 7],
                       max_new_tokens=40, **kw)
        eng.prefill(odd)
        seqs.append(odd)
    try:
        st = eng._stage_batch(seqs, 4)
        assert decode_graphs.call_bar(st) == want
        eng.decode_steps()
    finally:
        if kind == "debug_nans":
            numerics.set_debug_nans(previous)
    tel = eng.telemetry
    assert tel.decode_graph_replays.value == 0
    assert tel.decode_graph_eager.value == 0        # not eligible
    # Once the odd row leaves (its staging row goes back to greedy and
    # no penalty), the greedy batch replays.
    if kind != "debug_nans":
        eng.release(seqs.pop())
    assert decode_graphs.call_bar(eng._stage_batch(seqs, 4)) is None
    eng.decode_steps()
    assert tel.decode_graph_replays.value == 1


@pytest.mark.parametrize("kind", ["dense", "tp2", "cpu", "draft"])
def test_engines_that_capture_nothing(kind):
    if kind == "dense":
        eng = _engine(graphs=False, attn_backend="dense")
        want = "attention backend 'dense'"
    elif kind == "tp2":
        from tpu_inference_torch.parallel import build_mesh
        cfg, params = _model("tiny_llama")
        eng = InferenceEngine(cfg, tcfg.EngineConfig(**ENGINE),
                              params=params, device="cpu",
                              mesh=build_mesh(tcfg.ParallelConfig(tp=2),
                                              platform="cpu"))
        want = "sharded over tp 2"
    elif kind == "draft":
        cfg, params = _model("tiny_llama")
        eng = InferenceEngine(cfg, tcfg.EngineConfig(
            **ENGINE, num_speculative_tokens=2), params=params,
            device="cpu", draft_cfg=cfg, draft_params=params)
        want = "draft-model"
    else:
        eng = _engine(graphs=False)
        assert eng.capture_decode_graphs() == ("device cpu is not a CUDA "
                                               "card")
        eng.warmup()                  # warm-up captures on the card only
        assert eng._decode_graphs is None
        return
    why = eng.capture_decode_graphs(decode_graphs.EagerReplay)
    assert want in why
    assert eng._decode_graphs is None
    seqs = _admit(eng, 2)
    eng.decode_steps()
    assert all(s.generated for s in seqs)
    assert eng.telemetry.decode_graph_replays.value == 0


def test_counters_and_their_series():
    eng = _engine()
    _admit(eng, 3)
    eng.decode_steps()
    eng.decode_steps(max_steps=1)
    eng.decode_steps(max_steps=3)      # no (4, 3) graph: eligible, eager
    tel = eng.telemetry
    assert tel.decode_graph_replays.value == 2
    assert tel.decode_graph_eager.value == 1
    assert tel.decode_dispatches.value == 3
    text = telemetry.render_prometheus([({}, tel.registry)])
    assert "tpu_inf_decode_graph_replays_total 2" in text
    assert "tpu_inf_decode_graph_eager_total 1" in text
    for name in ("tpu_inf_decode_graph_replays_total",
                 "tpu_inf_decode_graph_eager_total"):
        assert name in telemetry.PORT_SERIES


def test_counters_off_with_telemetry(monkeypatch):
    monkeypatch.setenv("TPU_INF_TELEMETRY", "0")
    eng = _engine()
    _admit(eng, 3)
    eng.decode_steps()
    assert eng.telemetry.decode_graph_replays is telemetry.NULL_METRIC
    assert _replays(eng) == {(4, K): 1}


def _reader(name):
    path = ROOT / "h100bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "hb_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("cell", ["serve", "batch"])
def test_graph_share_reader(cell):
    read = _reader(f"decode_graph_share.{cell}")
    before = {"tpu_inf_decode_dispatches_total": 10.0,
              "tpu_inf_decode_graph_replays_total": 4.0}
    after = {"tpu_inf_decode_dispatches_total": 210.0,
             "tpu_inf_decode_graph_replays_total": 194.0}
    ctx = {"clean": (100.0, 120.0), "counters": (before, after)}
    assert read(ctx) == pytest.approx(95.0)
    # A program without the counter (the parent) reads nothing.
    parent = {"tpu_inf_decode_dispatches_total": 210.0}
    assert read({**ctx, "counters": (before, parent)}) is None
    idle = dict(after, tpu_inf_decode_dispatches_total=10.0)
    assert read({**ctx, "counters": (before, idle)}) is None
