"""Tensor and expert parallelism in the port on the CPU, held against the
reference's tp meshes (twins of tests/test_parallel.py's tp cases, over
the 8 virtual CPU devices tests/conftest.py sets).

The port drives its tp shards from one process (parallel/tp.py); on the
CPU every shard lives on the one CPU device. The same weights cross from
the reference by ``params_from_numpy``:

- forward logits at tp 4 (llama, Qwen2 with random biases, Mixtral's
  EP) against the reference's GSPMD-sharded forward, f32 within 1e-4;
- every leaf of every family has a spec; indivisible tp names the dim;
- engine greedy tokens at tp 4 / EP 4 (and GPT-2 and Gemma) equal the
  reference's tp engine's; pipelined decode at tp 4; int8 and grouped
  int4 weights over int8/int4 pools at tp 2; draft speculation at tp 2;
- the host tier and the P/D export keep the full-head page layout: a
  tp 2 engine's pages are byte-equal to a tp 1 engine's and adopt on
  either side with the same tokens;
- ``load_checkpoint(mesh=...)`` equals ``shard_params`` of the unsharded
  load, quantized or not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._leak import assert_pool_clean
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.models import quant as jq
from tpu_inference.parallel import build_mesh as j_mesh
from tpu_inference.parallel import shard_params as j_shard
from tpu_inference.parallel import validate_tp as j_validate
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkvc
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models.quant import QuantizedArray
from tpu_inference_torch.models.registry import build_model, get_model_fns
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.parallel import (build_mesh, param_shardings,
                                          shard_params, validate_tp)
from tpu_inference_torch.parallel import shardings as shd
from tpu_inference_torch.parallel.tp import TPModel

ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32))
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14, 15, 16, 17]]


def _tp_fields(mod, family="llama", **kw):
    """tests/test_parallel.py's tp configs (8 heads, 4 kv heads), in
    either package."""
    dt = jnp.float32 if mod is jcfg else torch.float32
    base = dict(name=f"tp-{family}", family=family, vocab_size=512,
                d_model=128, n_layers=2, n_heads=8, n_kv_heads=4, d_ff=256,
                max_seq_len=512, rope_theta=10000.0, dtype=dt)
    if family == "mixtral":
        base.update(n_experts=4, n_experts_per_tok=2)
    base.update(kw)
    return mod.ModelConfig(**base)


def _gpt2(mod):
    return mod.tiny_gpt2()


CONFIGS = {
    "llama": lambda m: _tp_fields(m),
    "qwen2": lambda m: _tp_fields(m, name="tp-qwen2", qkv_bias=True),
    "mixtral": lambda m: _tp_fields(m, "mixtral"),
    "gpt2": _gpt2,
    "gemma": lambda m: m.tiny_gemma(),
}


def _pair(name, quant="none"):
    """(reference config, its params, port config, the same params on
    the CPU); Qwen2's biases randomized, as the reference's test does."""
    jm, tm = CONFIGS[name](jcfg), CONFIGS[name](tcfg)
    params, _ = j_build(jm, seed=0)
    if jm.qkv_bias:
        from tests.conftest import randomize_qkv_biases
        randomize_qkv_biases(params, seed=11)
    if quant != "none":
        params = jq.quantize_params(params, quant)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


def _mesh(tp):
    return build_mesh(tcfg.ParallelConfig(tp=tp), platform="cpu")


def _dense_logits(mod, params, cfg, tokens):
    positions = torch.arange(tokens.shape[1])[None].expand(tokens.shape)
    logits, _ = mod.forward(params, cfg, tokens, positions, None,
                            tc.make_dense_attn())
    return logits


@pytest.mark.parametrize("name", ["llama", "qwen2", "mixtral"])
def test_tp_forward_matches_reference_tp(name):
    """tests/test_parallel.py:62's twin: the port's tp 4 logits against
    the reference's GSPMD tp 4 logits on the same weights."""
    jm, params, tm, tparams = _pair(name)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0,
                                jm.vocab_size)
    jmod = __import__(f"tpu_inference.models.{jm.family}",
                      fromlist=["forward"])
    from tpu_inference.models.common import make_dense_attn

    def jfwd(p, t):
        pos = jnp.broadcast_to(jnp.arange(t.shape[1]), t.shape)
        return jmod.forward(p, jm, t, pos, None, make_dense_attn())[0]

    want = jax.jit(jfwd)(j_shard(params, jm, j_mesh(jcfg.ParallelConfig(
        tp=4))), tokens)
    mesh = _mesh(4)
    sharded = shard_params(tparams, tm, mesh)
    got = _dense_logits(TPModel(get_model_fns(tm), mesh.tp_devices()),
                        sharded, tm, torch.from_numpy(np.asarray(tokens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # And the port's own unsharded forward.
    plain = _dense_logits(get_model_fns(tm), tparams, tm,
                          torch.from_numpy(np.asarray(tokens)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["llama", "tied", "mixtral", "gpt2"])
def test_param_shardings_cover_tree(name):
    """tests/test_parallel.py:81's twin: every leaf of every family has
    a spec (a structure mismatch raises), each shard's leaves are the
    spec's slices, and the global counts equal the unsharded model's."""
    cfg = (dataclasses.replace(_tp_fields(tcfg), tie_embeddings=True)
           if name == "tied" else CONFIGS[name](tcfg))
    params, _ = build_model(cfg, seed=0, device="cpu")
    mesh = _mesh(4)
    tree = param_shardings(cfg, mesh)
    assert set(tree) == set(params)
    assert set(tree["blocks"]) == set(params["blocks"])
    sharded = shard_params(params, cfg, mesh)
    assert len(sharded) == 4
    total = sum(t.numel() for t in _all_tensors(params))
    nbytes = sum(t.numel() * t.element_size() for t in _all_tensors(params))
    assert sharded.global_totals() == (total, nbytes)
    emb = sharded.shards[2]["embed"]
    torch.testing.assert_close(emb, params["embed"][256:384], rtol=0,
                               atol=0)


def _all_tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _all_tensors(v)
        elif isinstance(v, QuantizedArray):
            yield from (v.q, v.scale)
        else:
            yield v


def test_gpt2_packed_qkv_split_by_heads():
    """A documented difference in the spec: GPT-2's packed w_qkv/b_qkv
    shard q, k and v each by heads (a shard holds [q_i|k_i|v_i])."""
    cfg = tcfg.tiny_gpt2()
    params, _ = build_model(cfg, seed=0, device="cpu")
    assert shd.param_specs(cfg)["blocks"]["w_qkv"].packed == 3
    d = cfg.d_model
    w = params["blocks"]["w_qkv"]
    part = shard_params(params, cfg, _mesh(2)).shards[1]["blocks"]["w_qkv"]
    want = torch.cat([w[..., p * d + d // 2:(p + 1) * d] for p in range(3)],
                     dim=-1)
    assert torch.equal(part, want)


def test_validate_tp_rejects_indivisible():
    """tests/test_parallel.py:97's twin, with the reference's message."""
    with pytest.raises(ValueError, match="n_kv_heads") as got:
        validate_tp(_tp_fields(tcfg), 8)
    with pytest.raises(ValueError) as want:
        j_validate(_tp_fields(jcfg), 8)
    assert str(got.value) == str(want.value)


def test_int4_grouped_scales_refuse_an_uneven_split():
    """param_shardings' grouped-scale check names the leaf's groups, as
    the reference's does."""
    cfg = dataclasses.replace(_tp_fields(tcfg), d_ff=384)  # 3 groups
    params, _ = build_model(cfg, seed=0, device="cpu", quant="int4")
    with pytest.raises(ValueError, match="3 groups"):
        param_shardings(cfg, _mesh(2), params)


def test_mesh_shapes():
    """tests/test_parallel.py:175's twin: axis sizes, tp contiguous, and
    too few explicit devices raises."""
    mesh = build_mesh(tcfg.ParallelConfig(dp=2, tp=2, sp=2),
                      platform="cpu")
    assert mesh.shape == {"dp": 2, "tp": 2, "sp": 2}
    with pytest.raises(ValueError, match="only 8 given"):
        build_mesh(tcfg.ParallelConfig(dp=4, tp=4), devices=["cpu"] * 8)
    names = [f"cuda:{i}" for i in range(8)]
    grid = build_mesh(tcfg.ParallelConfig(dp=2, tp=2, sp=2), devices=names)
    assert [str(d) for d in grid.tp_devices(1)] == ["cuda:4", "cuda:5"]


def _jengine(jm, params, tp, **kw):
    mesh = j_mesh(jcfg.ParallelConfig(tp=tp)) if tp > 1 else None
    return JEngine(jm, jcfg.EngineConfig(**{**ENGINE, **kw}), params=params,
                   mesh=mesh, attn_backend="dense")


def _tengine(tm, tparams, tp, **kw):
    return InferenceEngine(tm, tcfg.EngineConfig(**{**ENGINE, **kw}),
                           params=tparams, device="cpu",
                           mesh=_mesh(tp) if tp > 1 else None)


@pytest.mark.parametrize("name,tp", [("llama", 4), ("qwen2", 4),
                                     ("mixtral", 4), ("gpt2", 4),
                                     ("gemma", 2)])
def test_tp_engine_matches_reference_tp_engine(name, tp):
    """tests/test_parallel.py:105/:122's twins (and GPT-2, Gemma): greedy
    tokens of the port's tp (EP for Mixtral) engine equal the
    reference's tp engine's on the same weights; the pool clean after."""
    jm, params, tm, tparams = _pair(name)
    want = _jengine(jm, params, tp).generate(PROMPTS, max_new_tokens=8)
    eng = _tengine(tm, tparams, tp)
    assert eng.tp == tp and isinstance(eng.kv, tkvc.ShardedKVPages)
    assert eng.kv.shards[0].k.shape[3] == tm.n_kv_heads // tp
    assert eng.generate(PROMPTS, max_new_tokens=8) == want
    assert_pool_clean(eng)


def test_tp_engine_pipelined_decode_matches():
    """tests/test_parallel.py:255's twin: dispatch-ahead decode at tp 4
    equals the reference's synchronous unsharded engine."""
    jm, params, tm, tparams = _pair("llama")
    kw = dict(max_batch_size=2, prefill_buckets=(16,),
              decode_steps_per_call=4)
    want = _jengine(jm, params, 1, **kw).generate(PROMPTS[:2],
                                                  max_new_tokens=12)
    eng = _tengine(tm, tparams, 4, decode_pipeline_depth=2, **kw)
    seqs = [Sequence(request_id=i, prompt_tokens=p, max_new_tokens=12)
            for i, p in enumerate(PROMPTS[:2])]
    for s in seqs:
        eng.prefill(s)
    for _ in range(20):
        eng.decode_steps_pipelined()
        if all(s.done for s in seqs) and not eng.pipeline_pending:
            break
    eng.drain_pipeline()
    assert [s.generated for s in seqs] == want


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_tp2_matches_reference_tp2(quant):
    """int8 weights over an int8 pool, and grouped int4 weights (w_down's
    two groups split one per shard) over an int4 pool, at tp 2 against
    the reference's tp 2 engine; codes and scales of every shard are the
    slices of the unsharded quantized leaves."""
    jm, params, tm, tparams = _pair("llama", quant)
    want = _jengine(jm, params, 2, quant=quant, kv_quant=quant).generate(
        PROMPTS, max_new_tokens=8)
    eng = _tengine(tm, tparams, 2, quant=quant, kv_quant=quant)
    down = eng.params.shards[1]["blocks"]["w_down"]
    full = tparams["blocks"]["w_down"]
    if quant == "int4":
        assert full.scale.shape[-2] == 2 and down.scale.shape[-2] == 1
    rows = full.q.shape[-2] // 2
    assert torch.equal(down.q, full.q[:, rows:])
    assert eng.generate(PROMPTS, max_new_tokens=8) == want
    assert_pool_clean(eng)


def test_draft_speculation_tp2_matches_unsharded():
    """A draft-model engine at tp 2 (draft weights sharded, its pool
    split over kv heads) gives the unsharded draft engine's tokens and
    the reference's plain greedy tokens."""
    jm, params, tm, tparams = _pair("llama")
    draft = tcfg.tiny_llama()
    kw = dict(spec_mode="draft", num_speculative_tokens=3)
    plain = _jengine(jm, params, 1).generate(PROMPTS, max_new_tokens=8)
    dparams, _ = build_model(draft, seed=5, device="cpu")
    got = []
    for tp in (1, 2):
        eng = InferenceEngine(tm, tcfg.EngineConfig(**{**ENGINE, **kw}),
                              params=tparams, device="cpu",
                              draft_cfg=draft, draft_params=dparams,
                              mesh=_mesh(tp) if tp > 1 else None)
        got.append(eng.generate(PROMPTS, max_new_tokens=8))
        assert eng.spec_drafted > 0
    assert got[0] == got[1] == plain
    assert isinstance(eng.draft_kv, tkvc.ShardedKVPages)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_tp2_pages_keep_the_full_head_layout(quant):
    """A tp 2 engine's live export has a tp 1 engine's wire layout
    (shapes, dtypes, values within f32 rounding: the shards' partial
    sums round apart), each side's export adopts on the other, the
    adopted pages read back byte-equal to the blob (restore scatters the
    heads to their shards, offload concatenates them back), and decode
    gives the plain engine's tokens."""
    jm, params, tm, tparams = _pair("llama")
    prompt = list(range(3, 16))                        # 13: 2 pages
    want = _tengine(tm, tparams, 1, kv_quant=quant).generate(
        [prompt], max_new_tokens=10)[0]
    # Fresh pools: the partial final page's unused slots read zero on
    # both sides.
    engines = {tp: _tengine(tm, tparams, tp, kv_quant=quant)
               for tp in (1, 2)}
    blobs, exports = {}, {}
    for tp, eng in engines.items():
        seq = Sequence(request_id=1, prompt_tokens=list(prompt),
                       max_new_tokens=10)
        eng.prefill(seq)
        _, pages, ctx = eng.export_sequence_kv_live(seq)
        host = tkvc.offload_pages(eng.kv, seq.pages)
        assert tkvc.serialize_host_pages(host) == \
            tkvc.serialize_host_pages(pages)
        blobs[tp] = tkvc.serialize_host_pages(pages)
        exports[tp] = (list(seq.generated), ctx)
        eng.release(seq)
    assert exports[1] == exports[2]
    for a, b in zip(*(tkvc.deserialize_host_pages(blobs[tp])
                      for tp in (1, 2))):
        for f in ("k", "v", "k_scale", "v_scale"):
            x, y = getattr(a, f), getattr(b, f)
            if x is None:
                assert y is None
                continue
            assert (x.shape, x.dtype) == (y.shape, y.dtype)
            if x.is_floating_point():
                torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
            else:
                codes = (tkvc.unpack_int4_kv(x) - tkvc.unpack_int4_kv(y)
                         if quant == "int4" else x.int() - y.int())
                assert int(codes.abs().max()) <= 1
    for src, dst in ((2, 1), (1, 2)):
        eng = engines[dst]
        first, ctx = exports[src]
        seq = Sequence(request_id=2, prompt_tokens=list(prompt),
                       max_new_tokens=10,
                       adopt_kv=(tkvc.deserialize_host_pages(blobs[src]),
                                 ctx))
        seq.generated, seq.resume_base = list(first), len(first)
        eng.adopt_sequence(seq)
        back = tkvc.offload_pages(eng.kv, seq.pages)
        assert tkvc.serialize_host_pages(back) == blobs[src]
        while not seq.done:
            eng.decode_steps()
        assert seq.generated == want
        eng.release(seq)
    for eng in engines.values():
        assert_pool_clean(eng)


def test_host_tier_round_trip_at_tp2():
    """The host tier under a tp 2 engine: prefix pages demote to host
    memory in the full-head layout and promote back into the shards,
    and a repeated prompt after the demote gives the same tokens."""
    jm, params, tm, tparams = _pair("llama")
    eng = _tengine(tm, tparams, 2, num_pages=12, host_cache_pages=16)
    base = _tengine(tm, tparams, 1)
    a = list(range(3, 35))
    b = list(range(100, 140))
    c = list(range(200, 240))
    want = base.generate([a, b, c, a], max_new_tokens=6)
    got = [eng.generate([p], max_new_tokens=6)[0] for p in (a, b, c, a)]
    assert got == want
    assert eng.host_pool.offloaded_total > 0
    assert eng.host_pool.restored_total > 0
    assert_pool_clean(eng)


def _write_ckpt(tmp_path, name):
    """A local safetensors checkpoint from the test_torch_weights
    helpers: (port config, directory)."""
    from tests.test_torch_weights import (_hf_gpt2_and_mixtral,
                                          _random_llama_sd, _write_sharded)

    if name == "llama":
        tm = tcfg.tiny_llama(vocab_size=96)
        sd = _random_llama_sd(tm, np.random.default_rng(3))
        _write_sharded(sd, str(tmp_path))
        return tm, str(tmp_path)
    (g, _, gdir), (m, _, mdir) = _hf_gpt2_and_mixtral(tmp_path)
    return (g[1], gdir) if name == "gpt2" else (m[1], mdir)


def _same_sharded(got, want):
    assert len(got) == len(want)
    a, b = list(got.named_tensors()), list(want.named_tensors())
    assert [p for p, _, _ in a] == [p for p, _, _ in b]
    for (path, x, rx), (_, y, ry) in zip(a, b):
        assert rx == ry, path
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.mark.parametrize("name,quant", [("llama", "none"),
                                        ("llama", "int8"),
                                        ("llama", "int4"),
                                        ("gpt2", "none"),
                                        ("mixtral", "int8")])
def test_load_checkpoint_per_shard_equals_shard_params(name, quant,
                                                       tmp_path):
    """``load_checkpoint(mesh=...)`` streams each slab onto its shards
    and equals ``shard_params`` of the unsharded load (quantized slabs
    quantized whole, then cut), global counts included."""
    from tpu_inference_torch.models.weights import load_checkpoint

    tm, path = _write_ckpt(tmp_path, name)
    mesh = _mesh(2)
    got = load_checkpoint(tm, path, quant=quant, device="cpu", mesh=mesh)
    full = load_checkpoint(tm, path, quant=quant, device="cpu")
    want = shard_params(full, tm, mesh)
    _same_sharded(got, want)
    assert got.global_totals() == want.global_totals()
    eng = InferenceEngine(tm, tcfg.EngineConfig(**{**ENGINE,
                                                   "quant": quant}),
                          params=got, device="cpu", mesh=mesh)
    ref = InferenceEngine(tm, tcfg.EngineConfig(**{**ENGINE,
                                                   "quant": quant}),
                          params=full, device="cpu")
    prompts = [[5, 9, 2, 7, 1], list(range(3, 40))]
    assert eng.generate(prompts, 6) == ref.generate(prompts, 6)
    assert (eng.n_params, eng.weight_bytes) == (ref.n_params,
                                                ref.weight_bytes)


def test_engine_refuses_mismatched_shards_and_sp():
    tm = tcfg.tiny_llama()
    params, _ = build_model(tm, seed=0, device="cpu")
    cut = shard_params(params, tm, _mesh(2))
    with pytest.raises(ValueError, match="2 shards"):
        InferenceEngine(tm, tcfg.EngineConfig(**ENGINE), params=cut,
                        device="cpu")
    with pytest.raises(ValueError, match="quantized before"):
        InferenceEngine(tm, tcfg.EngineConfig(**ENGINE, quant="int8"),
                        params=cut, device="cpu", mesh=_mesh(2))
    # sp is served since 1.16b: what stays refused is the reference's
    # Ulysses head split that does not divide (n_heads 4 over tp*sp 8).
    ekw = dict(ENGINE, sp_attn="ulysses")
    with pytest.raises(ValueError) as want:
        JEngine(jcfg.tiny_llama(), jcfg.EngineConfig(**ekw), seed=0,
                mesh=j_mesh(jcfg.ParallelConfig(tp=2, sp=4)))
    with pytest.raises(ValueError, match="use sp_attn='ring'") as got:
        InferenceEngine(tm, tcfg.EngineConfig(**ekw), device="cpu",
                        mesh=build_mesh(tcfg.ParallelConfig(tp=2, sp=4),
                                        platform="cpu"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_kv_heads"):
        InferenceEngine(tm, tcfg.EngineConfig(**ENGINE), device="cpu",
                        mesh=_mesh(4))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_f32_product_keeps_a_partial_unrounded(quant):
    """A tp shard's row-parallel partial (``qdot(..., f32_product=True)``)
    is the float32 product of its operands, not rounded to bf16; the
    default stays the bf16-rounded product of tp 1."""
    from tpu_inference_torch.models import quant as tq

    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 256), generator=g).to(torch.bfloat16)
    w = 0.05 * torch.randn((256, 64), generator=g)
    leaf = (w.to(torch.bfloat16) if quant == "none"
            else tq.quantize_array(w, quant))
    # The same contraction over float32 operands (codes exact in any
    # float dtype, scales applied after the product).
    want = (x.float() @ leaf.float() if quant == "none"
            else tq.qdot(x.float(), leaf))
    got = tq.qdot(x, leaf, f32_product=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rounded = tq.qdot(x, leaf)
    if quant == "none":
        torch.testing.assert_close(rounded, want.to(torch.bfloat16).float(),
                                   rtol=0, atol=0)


def test_bf16_tp2_forward_stays_within_bf16_of_tp1():
    """bf16 activations at tp 2: the partials sum in float32 before the
    one cast, so the logits stay within bf16 tolerance of tp 1's."""
    cfg = dataclasses.replace(_tp_fields(tcfg), dtype=torch.bfloat16)
    params, _ = build_model(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    mesh = _mesh(2)
    want = _dense_logits(get_model_fns(cfg), params, cfg, tokens)
    got = _dense_logits(TPModel(get_model_fns(cfg), mesh.tp_devices()),
                        shard_params(params, cfg, mesh), cfg, tokens)
    err = (got - want).abs().max().item()
    assert err <= 2e-2 * want.abs().max().item(), err
