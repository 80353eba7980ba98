"""Sequence parallelism in the port on the CPU, held against the
reference's (twins of tests/test_kernels.py's ring and Ulysses cases,
tests/test_parallel.py's sp engines, tests/test_kv_quant.py's sp x int8
KV case and tests/test_sliding_window.py's windowed sp engines), over
the 8 virtual CPU devices tests/conftest.py sets.

The port drives the sp slices from one process: on the CPU every slice
lives on the one CPU device and the ring's chunk moves are no-ops. The
same inputs come from a numpy seed; the same weights cross from the
reference by ``params_from_numpy``. Tolerances, as the reference's
tests state them: float32 ring/Ulysses outputs within 2e-5 (abs and
rel) of the reference's and of dense attention, bfloat16 within 5e-2 of
dense attention; engines give the reference sp engine's greedy tokens
exactly.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from tests._leak import assert_pool_clean
# The fleet tests' checkpoint, its JAX oracle and helpers.
from tests.test_torch_fleet import (_cfg, _finish, _submit,  # noqa: F401
                                    _want, ckpt, oracle)
from tests.test_torch_parallel import _tp_fields
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.engine.engine import Sequence as JSequence
from tpu_inference.kernels.ring_attention import ring_attention as j_ring
from tpu_inference.kernels.ulysses_attention import (
    ulysses_attention as j_ulysses)
from tpu_inference.models import build_model as j_build
from tpu_inference.parallel import build_mesh as j_mesh
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.kernels.ring_attention import ring_attention
from tpu_inference_torch.kernels.ulysses_attention import (
    ulysses_attention, ulysses_attention_local)
from tpu_inference_torch.models import common as tc
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.parallel import build_mesh
from tpu_inference_torch.parallel.mesh import Mesh

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=5e-2, atol=5e-2)
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32))
PROMPTS = [list(range(1, 29)), [7, 8, 9], list(range(100, 117))]


def _sp_mesh(sp: int) -> Mesh:
    devs = np.empty(sp, dtype=object)
    devs[:] = [torch.device("cpu")] * sp
    return Mesh(devs, ("sp",))


def _qkv(seed, b, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]


def _port(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _ref(fn, arrays, sp, dtype=jnp.float32, **kw):
    mesh = JMesh(np.array(jax.devices()[:sp]), ("sp",))
    out = fn(*(jnp.asarray(a, dtype) for a in arrays), mesh=mesh, **kw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("sp,hq,hkv", [(4, 4, 4), (8, 8, 2)])
def test_ring_attention_matches_reference(sp, hq, hkv):
    """tests/test_kernels.py:197's twin: the port's ring at the same
    (sp, Hq, Hkv) equals the reference's ring and dense attention."""
    arrays = _qkv(4, 2, 8 * sp, hq, hkv, 16)
    q, k, v = _port(arrays)
    got = ring_attention(q, k, v, mesh=_sp_mesh(sp)).numpy()
    np.testing.assert_allclose(got, _ref(j_ring, arrays, sp), **F32)
    np.testing.assert_allclose(
        got, tc.dense_causal_attention(q, k, v).numpy(), **F32)


def test_ring_attention_bf16():
    """tests/test_kernels.py:215's twin: bf16 inputs stay bf16 and land
    within bf16 tolerance of dense attention and of the reference."""
    arrays = _qkv(5, 1, 32, 4, 4, 32)
    q, k, v = _port(arrays, torch.bfloat16)
    got = ring_attention(q, k, v, mesh=_sp_mesh(4))
    assert got.dtype == torch.bfloat16
    want = tc.dense_causal_attention(q, k, v).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    np.testing.assert_allclose(
        got.float().numpy(), _ref(j_ring, arrays, 4, jnp.bfloat16), **BF16)


@pytest.mark.parametrize("sp,hq,hkv", [(4, 4, 4), (4, 8, 4), (2, 8, 2)])
def test_ulysses_attention_matches_reference(sp, hq, hkv):
    """tests/test_kernels.py:233's twin, GQA ratios included."""
    arrays = _qkv(6, 2, 8 * sp, hq, hkv, 16)
    q, k, v = _port(arrays)
    got = ulysses_attention(q, k, v, mesh=_sp_mesh(sp)).numpy()
    np.testing.assert_allclose(got, _ref(j_ulysses, arrays, sp), **F32)
    np.testing.assert_allclose(
        got, tc.dense_causal_attention(q, k, v).numpy(), **F32)


def test_ulysses_matches_ring():
    """tests/test_kernels.py:252's twin: the two schemes agree."""
    q, k, v = _port(_qkv(7, 1, 32, 4, 4, 32))
    mesh = _sp_mesh(4)
    np.testing.assert_allclose(ulysses_attention(q, k, v, mesh=mesh).numpy(),
                               ring_attention(q, k, v, mesh=mesh).numpy(),
                               **F32)


@pytest.mark.parametrize("window", [5, 8, 20])
def test_sp_attention_sliding_window_matches_reference(window):
    """tests/test_kernels.py:272's twin: ring at sp 4 (8-token slices:
    window 5 puts whole chunks behind every window, the skip fires) and
    Ulysses at sp 2 against the reference's and the window-masked dense
    attention; the window binds."""
    arrays = _qkv(9, 2, 32, 4, 2, 16)
    q, k, v = _port(arrays)
    want = tc.dense_causal_attention(q, k, v, sliding_window=window).numpy()
    for name, fn, jfn, sp in (("ring", ring_attention, j_ring, 4),
                              ("ulysses", ulysses_attention, j_ulysses, 2)):
        got = fn(q, k, v, mesh=_sp_mesh(sp), sliding_window=window).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **F32)
        np.testing.assert_allclose(
            got, _ref(jfn, arrays, sp, sliding_window=window),
            err_msg=name, **F32)
    assert not np.allclose(want, tc.dense_causal_attention(q, k, v).numpy())


def test_ulysses_attention_bf16():
    """tests/test_kernels.py:303's twin: bf16 across the regroupings."""
    arrays = _qkv(8, 1, 32, 4, 4, 32)
    q, k, v = _port(arrays, torch.bfloat16)
    got = ulysses_attention(q, k, v, mesh=_sp_mesh(4))
    assert got.dtype == torch.bfloat16
    want = tc.dense_causal_attention(q, k, v).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)
    np.testing.assert_allclose(
        got.float().numpy(), _ref(j_ulysses, arrays, 4, jnp.bfloat16),
        **BF16)


def test_ulysses_refuses_indivisible_heads_and_runs_dense_at_sp1():
    """Heads that do not divide fail with the reference's assertion
    text; one slice is plain dense attention."""
    q, k, v = _port(_qkv(3, 1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="ulysses needs head counts "
                       "divisible by the sp axis: Hq=4, Hkv=2, sp=4"):
        ulysses_attention(q, k, v, mesh=_sp_mesh(4))
    (one,) = ulysses_attention_local([(q, k, v)], sliding_window=3)
    np.testing.assert_array_equal(
        one.numpy(), tc.dense_causal_attention(q, k, v,
                                               sliding_window=3).numpy())


def _pair(cfg_fn):
    """(reference config, its params, port config, the same params)."""
    jm, tm = cfg_fn(jcfg), cfg_fn(tcfg)
    params, _ = j_build(jm, seed=0)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


def _engines(jm, params, tm, tparams, tp, sp, ekw):
    """The reference's engine on a (tp, sp) mesh of the virtual CPU
    devices and the port's on a CPU mesh of the same shape."""
    jeng = JEngine(jm, jcfg.EngineConfig(**ekw), params=params,
                   mesh=j_mesh(jcfg.ParallelConfig(tp=tp, sp=sp)),
                   attn_backend="dense")
    teng = InferenceEngine(tm, tcfg.EngineConfig(**ekw), params=tparams,
                           device="cpu",
                           mesh=build_mesh(tcfg.ParallelConfig(tp=tp, sp=sp),
                                           platform="cpu"))
    return jeng, teng


@pytest.mark.parametrize("sp_attn,tp,sp", [("ring", 2, 4),
                                           ("ulysses", 2, 2),
                                           ("ring", 1, 2)])
def test_sp_engine_matches_reference_sp_engine(sp_attn, tp, sp):
    """tests/test_parallel.py:137 (ring, tp 2 x sp 4) and :283 (Ulysses,
    tp 2 x sp 2)'s twins, and ring at tp 1 x sp 2 (the unsharded model,
    only the attention split): greedy tokens equal the reference sp
    engine's on the same mesh shape, every fresh prompt took the sp path,
    the pool is clean after."""
    jm, params, tm, tparams = _pair(_tp_fields)
    ekw = dict(ENGINE, sp_attn=sp_attn)
    jeng, eng = _engines(jm, params, tm, tparams, tp, sp, ekw)
    assert (eng.tp, eng.sp) == (tp, sp) and jeng.sp == sp
    assert (eng.mesh is None) == (tp == 1)
    want = jeng.generate(PROMPTS, max_new_tokens=8)
    assert eng.generate(PROMPTS, max_new_tokens=8) == want
    assert eng.prefill_paths == {f"sp_{sp_attn}": len(PROMPTS)}
    assert_pool_clean(eng)


def test_sp_prefill_many_groups_by_bucket_and_sp():
    """The batched prefill groups by (bucket, sp or not), as the
    reference's ``prefill_many``: a prompt over a cached prefix takes the
    paged path (the prefill kernel's plain version here), fresh ones the
    ring; then a prompt past the chunk cap prefills chunk by chunk on the
    paged path. Tokens equal the reference sp engine's call for call."""
    jm, params, tm, tparams = _pair(_tp_fields)
    ekw = dict(ENGINE, num_pages=96, max_pages_per_seq=16,
               chunked_prefill_size=32)
    jeng, eng = _engines(jm, params, tm, tparams, 2, 2, ekw)
    base = list(range(40, 64))                 # 3 full pages of 8
    mix = [base + [5, 6, 7], list(range(1, 29)), [9, 8, 7],
           list(range(200, 213))]
    long = list(range(300, 340))               # past the chunk cap

    def run(engine, seq_cls, batches):
        out = []
        for batch in batches:
            seqs = [seq_cls(request_id=i, prompt_tokens=p, max_new_tokens=6)
                    for i, p in enumerate(batch)]
            engine.prefill_many(seqs)
            while not all(s.done for s in seqs):
                engine.decode_steps()
            out.append([s.generated for s in seqs])
            for s in seqs:
                engine.release(s)
        return out

    batches = [[base + [1]], mix, [long]]
    want = run(jeng, JSequence, batches)
    eng.prefill_paths.clear()
    assert run(eng, Sequence, batches) == want
    # Chunks by path: on the ring, base and the mix's three fresh
    # prompts (the two of bucket 16 in one call); paged, the cached
    # prompt and the long prompt's two chunks.
    assert eng.prefill_paths == {"sp_ring": 4, "paged": 3}
    assert_pool_clean(eng)


def test_sp_ulysses_rejects_indivisible_heads():
    """tests/test_parallel.py:303's twin: n_kv_heads 4 cannot split over
    tp*sp = 8; the port raises the reference's ValueError, message and
    all, before any weight is built."""
    jm, tm = _tp_fields(jcfg), _tp_fields(tcfg)
    ekw = dict(ENGINE, max_batch_size=2, prefill_buckets=(16,),
               sp_attn="ulysses")
    with pytest.raises(ValueError, match="ulysses") as want:
        JEngine(jm, jcfg.EngineConfig(**ekw), seed=0,
                mesh=j_mesh(jcfg.ParallelConfig(tp=2, sp=4)))
    with pytest.raises(ValueError) as got:
        InferenceEngine(tm, tcfg.EngineConfig(**ekw), device="cpu",
                        mesh=build_mesh(tcfg.ParallelConfig(tp=2, sp=4),
                                        platform="cpu"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="sp_attn='tree'"):
        InferenceEngine(tm, tcfg.EngineConfig(**dict(ekw, sp_attn="tree")),
                        device="cpu",
                        mesh=build_mesh(tcfg.ParallelConfig(sp=2),
                                        platform="cpu"))


@pytest.mark.slow   # 2k-token ring prefill, as the reference's twin
def test_sp_long_context_prefill():
    """tests/test_parallel.py:157's twin: a 2k-token prompt through the
    ring at tp 2 x sp 4, then paged decode, the reference sp engine's
    tokens."""
    jm, params, tm, tparams = _pair(_tp_fields)
    ekw = dict(page_size=16, num_pages=320, max_pages_per_seq=160,
               max_batch_size=2, prefill_buckets=(256, 2048))
    prompt = [(7 * i + 3) % jm.vocab_size for i in range(2048)]
    jeng, eng = _engines(jm, params, tm, tparams, 2, 4, ekw)
    assert (eng.generate([prompt], max_new_tokens=4)
            == jeng.generate([prompt], max_new_tokens=4))


def _tiny(mod):
    return mod.tiny_llama()


def test_sp_ring_prefill_with_kv_int8():
    """tests/test_kv_quant.py:240's twin: the ring prefill at tp 2 x sp 2
    writes the chunk's K/V into the int8 pool and attends the raw K/V;
    decode reads the codes. Tokens equal the reference sp engine's."""
    jm, params, tm, tparams = _pair(_tiny)
    ekw = dict(num_pages=64, max_batch_size=2, prefill_buckets=(64,),
               kv_quant="int8")
    prompt = [list(range(1, 33))]              # 32 % sp == 0
    jeng, eng = _engines(jm, params, tm, tparams, 2, 2, ekw)
    assert eng.sp == 2 and eng.kv.quantized
    assert (eng.generate(prompt, max_new_tokens=8)
            == jeng.generate(prompt, max_new_tokens=8))
    assert eng.prefill_paths == {"sp_ring": 1}


def _swa8(mod):
    return dataclasses.replace(mod.tiny_llama(vocab_size=256),
                               name="tiny-swa", sliding_window=8)


@pytest.mark.parametrize("sp_attn", ["ring", "ulysses"])
def test_swa_sp_engine_matches_reference(sp_attn):
    """tests/test_sliding_window.py:204's twin: the window-8 dialect at
    sp 2 (the ring at tp 2, Ulysses at tp 1: n_kv_heads 2 must divide
    tp*sp), prompts spanning both slices and longer than the window;
    behind-window eviction on; the reference sp engine's tokens."""
    jm, params, tm, tparams = _pair(_swa8)
    ekw = dict(page_size=8, num_pages=96, max_pages_per_seq=8,
               max_batch_size=2, prefill_buckets=(16, 32), sp_attn=sp_attn)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in (21, 13)]
    tp = 2 if sp_attn == "ring" else 1
    jeng, eng = _engines(jm, params, tm, tparams, tp, 2, ekw)
    assert eng.sp == 2 and eng.swa_evict
    assert (eng.generate(prompts, max_new_tokens=10)
            == jeng.generate(prompts, max_new_tokens=10))
    assert_pool_clean(eng)


def test_build_server_sp2_answers_with_the_sp1_text():
    """``build_server(sp=2)`` (ring, and Ulysses with warmup) answers
    ``/api/generate`` with the sp 1 server's greedy text; ``/healthz``
    keeps the reference's shape."""
    from tests.test_torch_server import _get, _post
    from tpu_inference_torch.server.http import build_server

    body = {"model": "m", "prompt": "Hello sequence shards",
            "temperature": 0.0, "max_tokens": 10, "stream": False}
    out = {}
    for sp, attn, warm in ((1, "ring", False), (2, "ring", False),
                           (2, "ulysses", True)):
        server = build_server("tiny-llama", warmup=warm, device="cpu",
                              num_pages=64, page_size=8,
                              max_pages_per_seq=16, max_batch_size=4,
                              prefill_buckets=(16, 32), sp=sp, sp_attn=attn)
        try:
            port = server.start(host="127.0.0.1", port=0)
            server.engine.prefill_paths.clear()
            status, _, raw = _post(port, body)
            assert status == 200
            health = json.loads(_get(port, "/healthz")[2])
            assert health["status"] == "ok" and len(health["replicas"]) == 1
            assert (server.engine.tp, server.engine.sp) == (1, sp)
            out[(sp, attn)] = json.loads(raw)["response"]
            assert server.engine.prefill_paths == {
                ("paged" if sp == 1 else f"sp_{attn}"): 1}
        finally:
            server.shutdown(timeout=30.0)
    assert out[(2, "ring")] == out[(2, "ulysses")] == out[(1, "ring")]


@pytest.mark.parametrize("fleet,sp_attn", [("in-process", "ring"),
                                           ("subprocess", "ulysses")])
def test_dp2_sp2_fleet_gives_the_oracle_tokens(fleet, sp_attn, ckpt,
                                               oracle):
    """dp 2 x sp 2 from the checkpoint on both backends: each replica
    (a worker process on the subprocess fleet) owns two sp devices, its
    fresh prompts take the sp path, and the tokens are the reference dp
    1 oracle's."""
    from tpu_inference_torch.server.http import build_engine_group

    cfg = _cfg(ckpt, fleet=fleet)
    cfg.engine = dataclasses.replace(cfg.engine, sp_attn=sp_attn)
    cfg.parallel = tcfg.ParallelConfig(dp=2, sp=2)
    group = build_engine_group(cfg, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8],
               list(range(20, 33))]
    try:
        group.start()
        pend = [_submit(group, i, p, 10) for i, p in enumerate(prompts)]
        outs = []
        for toks, done, box in pend:
            assert _finish(done, box).finish_reason == "length"
            outs.append(toks)
        assert outs == [_want(oracle, p, 10) for p in prompts]
        if fleet == "subprocess":
            stats = [h.client.rpc("stats") for h in group.workers]
            assert [s["parallel"] for s in stats] == [{"tp": 1, "sp": 2}] * 2
            paths = [s["prefill_paths"] for s in stats]
        else:
            paths = [e.prefill_paths for e in group.engines]
        assert sum(p.get(f"sp_{sp_attn}", 0) for p in paths) == len(prompts)
        assert not any(p.get("paged") for p in paths)
    finally:
        group.stop(drain=False)
