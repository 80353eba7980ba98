"""Port twin of the quantized half of engine/kv_cache.py and of the
kernels' int8 / packed-int4 pool branches, against the JAX reference.

KV quantization (``quantize_kv``, ``quantize_kv_int4``, ``unpack_int4_kv``)
is byte-identical to the reference's functions; quantized pools write
and gather exactly as the reference's do. The kernels' plain versions
(what a CPU tensor runs, and what the CUDA kernels are held to on the
card) read the same codes and scales as the reference's Pallas kernels
in interpret mode and agree within tests/test_kernels.py's float32
tolerance (rtol = atol = 2e-5); bfloat16 q within 2e-2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as jkv
from tpu_inference.kernels.paged_attention import paged_attention as j_decode
from tpu_inference.kernels.prefill_attention import (
    paged_prefill_attention as j_prefill)
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkv
from tpu_inference_torch.kernels import paged_attention as pa
from tpu_inference_torch.kernels import prefill_attention as pfa


def _x(shape, seed=0, scale=2.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 3, 16), (1, 7, 2, 64),
                                   (3, 4, 1, 128)])
def test_quantize_kv_byte_identical(shape):
    x = _x(shape)
    x[0, 0, 0] = 0.0                       # an all-zero row: scale floor
    for t_fn, j_fn in ((tkv.quantize_kv, jkv.quantize_kv),
                       (tkv.quantize_kv_int4, jkv.quantize_kv_int4)):
        q, s = t_fn(torch.from_numpy(x))
        qj, sj = j_fn(jnp.asarray(x))
        assert q.dtype == {np.int8: torch.int8, np.uint8: torch.uint8}[
            np.asarray(qj).dtype.type]
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


def test_unpack_int4_kv_byte_identical():
    every = np.arange(256, dtype=np.uint8).reshape(4, 2, 32)
    got = tkv.unpack_int4_kv(torch.from_numpy(every))
    want = jkv.unpack_int4_kv(jnp.asarray(every))
    assert got.dtype == torch.int32 and got.shape == (4, 2, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Byte i holds code i (low nibble) and code i + D/2 (high nibble).
    codes = np.random.default_rng(2).integers(-7, 8, (3, 16)).astype(
        np.float32)
    q, _ = tkv.quantize_kv_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(tkv.unpack_int4_kv(q).numpy(),
                                  np.rint(codes / (np.abs(codes).max(-1,
                                          keepdims=True) / 7)))


def _cfgs(mode, L=2, H=2, D=32, P=24, pg=4):
    t = (tcfg.ModelConfig(n_layers=L, n_kv_heads=H, d_model=16, n_heads=2,
                          head_dim_override=D, dtype=torch.float32),
         tcfg.EngineConfig(page_size=pg, num_pages=P, kv_quant=mode))
    j = (jcfg.ModelConfig(n_layers=L, n_kv_heads=H, d_model=16, n_heads=2,
                          head_dim_override=D, dtype=jnp.float32),
         jcfg.EngineConfig(page_size=pg, num_pages=P, kv_quant=mode))
    return t, j


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_pool_alloc_matches_reference(mode):
    (tm, te), (jm, je) = _cfgs(mode)
    kv_t = tkv.alloc_kv_pages(tm, te, device="cpu")
    kv_j = jkv.alloc_kv_pages(jm, je)
    assert kv_t.quantized and kv_t.packed_int4 == (mode == "int4")
    assert tuple(kv_t.k.shape) == kv_j.k.shape
    assert str(kv_t.k.dtype).split(".")[-1] == str(kv_j.k.dtype)
    assert tuple(kv_t.k_scale.shape) == kv_j.k_scale.shape
    assert kv_t.k_scale.dtype == torch.float32
    plain = tkv.alloc_kv_pages(tm, tcfg.EngineConfig(page_size=4,
                                                     num_pages=24),
                               device="cpu")
    assert not plain.quantized and plain.k_scale is None


def test_quantized_pool_validation_raises_value_error():
    odd = tcfg.ModelConfig(n_layers=1, n_kv_heads=1, d_model=16, n_heads=1,
                           head_dim_override=15, dtype=torch.float32)
    with pytest.raises(ValueError, match="even head_dim"):
        tkv.alloc_kv_pages(odd, tcfg.EngineConfig(kv_quant="int4"),
                           device="cpu")
    with pytest.raises(ValueError, match="unknown kv_quant"):
        tkv.alloc_kv_pages(tcfg.tiny_llama(),
                           tcfg.EngineConfig(kv_quant="fp8"), device="cpu")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_write_then_gather_matches_reference(mode):
    """Two writes (the second over the first's slots) into a quantized
    pool: codes and scales of every real page, and the dequantized
    gather, equal the reference's exactly."""
    (tm, te), (jm, je) = _cfgs(mode)
    kv_t = tkv.alloc_kv_pages(tm, te, device="cpu")
    kv_j = jkv.alloc_kv_pages(jm, je)
    rng = np.random.default_rng(1)
    b, s, layer = 3, 6, 1
    bt = rng.permutation(np.arange(1, 24))[:b * 5].reshape(b, 5).astype(
        np.int32)
    pos = (rng.integers(0, 20 - s, size=(b, 1))
           + np.arange(s)[None]).astype(np.int32)
    valid = rng.random((b, s)) < 0.7
    for step in range(2):
        k = _x((b, s, 2, 32), seed=10 + step)
        v = _x((b, s, 2, 32), seed=20 + step)
        slots_t = tkv.slot_mapping(torch.from_numpy(bt),
                                   torch.from_numpy(pos + step),
                                   torch.from_numpy(valid), 4)
        slots_j = jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos + step),
                                   jnp.asarray(valid), 4)
        out = tkv.write_kv(kv_t, layer, torch.from_numpy(k),
                           torch.from_numpy(v), slots_t)
        assert out.k is kv_t.k and out.k_scale is kv_t.k_scale   # in place
        kv_j = jkv.write_kv(kv_j, layer, jnp.asarray(k), jnp.asarray(v),
                            slots_j)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(kv_t, name).numpy()[:, 1:],
                                      np.asarray(getattr(kv_j, name))[:, 1:])
    gk_t, gv_t = tkv.gather_kv(kv_t, layer, torch.from_numpy(bt))
    gk_j, gv_j = jkv.gather_kv(kv_j, layer, jnp.asarray(bt))
    assert gk_t.dtype == torch.float32 and gk_t.shape[-1] == 32
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(gv_t.numpy(), np.asarray(gv_j))


def _quantized_pool(rng, mode, num_pages, pg, hkv, d, b, mp):
    """Random codes and scales (as a written pool holds them), a block
    table of distinct non-trash pages."""
    if mode == "int8":
        shape = (num_pages, pg, hkv, d)
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        shape = (num_pages, pg, hkv, d // 2)
        k = rng.integers(0, 256, shape).astype(np.uint8)
        v = rng.integers(0, 256, shape).astype(np.uint8)
    ks = rng.uniform(0.002, 0.03, (num_pages, pg, hkv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (num_pages, pg, hkv)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))[:b * mp]
    return (k, v, ks, vs), perm.reshape(b, mp).astype(np.int32)


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a.copy()) for a in arrs])


def _q(rng, shape, dt):
    q = rng.standard_normal(shape).astype(np.float32)
    if dt == "bf16":
        jq = jnp.asarray(q, jnp.bfloat16)
        return jq, torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def _close(got, want, dt):
    tol = 2e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode,dt,hq,hkv,kv_lens,window", [
    ("int8", "f32", 8, 2, None, 0),
    ("int4", "f32", 8, 2, None, 0),
    ("int8", "f32", 4, 4, (1, 1, 1), 0),          # MHA, softmax of one
    ("int8", "f32", 8, 2, (30, 9, 17), 8),        # sliding window
    ("int4", "f32", 8, 2, (30, 3, 32), 12),
    ("int8", "bf16", 8, 2, None, 0),
    ("int4", "bf16", 8, 2, (30, 9, 17), 8),
])
def test_quantized_decode_plain_matches_pallas(mode, dt, hq, hkv, kv_lens,
                                               window):
    rng = np.random.default_rng(0)
    b, d, pg, npg, mp = 3, 64, 8, 32, 4
    pool, bt = _quantized_pool(rng, mode, npg, pg, hkv, d, b, mp)
    jq, tq = _q(rng, (b, hq, d), dt)
    if kv_lens is None:
        kv_lens = rng.integers(1, pg * mp + 1, size=b)
    kl = np.asarray(kv_lens, np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _both(pool)
    got = pa.paged_attention(tq, tk, tv, torch.from_numpy(bt),
                             torch.from_numpy(kl), tks, tvs,
                             sliding_window=window)
    want = j_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(kl), jks, jvs,
                    interpret=True, sliding_window=window)
    assert got.dtype == tq.dtype and got.shape == (b, hq, d)
    _close(got, want, dt)


@pytest.mark.parametrize("mode,dt,s,hq,hkv,q_offsets,prompts,window", [
    ("int8", "f32", 32, 8, 2, (5, 0), (20, 32), 0),
    ("int4", "f32", 32, 8, 2, (0, 13), (20, 32), 0),
    ("int8", "f32", 24, 4, 4, (0,), (24,), 0),       # MHA, S not 2^k
    ("int4", "f32", 32, 8, 2, (5, 0), (20, 32), 6),  # sliding window
    ("int8", "f32", 24, 8, 2, (16, 40), (24, 10), 9),
    ("int4", "f32", 1, 8, 2, (0, 7), (1, 1), 0),     # one-token chunks
    ("int8", "bf16", 32, 8, 2, (5, 0), (20, 32), 0),
])
def test_quantized_prefill_plain_matches_pallas(mode, dt, s, hq, hkv,
                                                q_offsets, prompts, window):
    rng = np.random.default_rng(7)
    d, pg, npg, mp = 64, 8, 64, 8
    b = len(prompts)
    pool, bt = _quantized_pool(rng, mode, npg, pg, hkv, d, b, mp)
    jq, tq = _q(rng, (b, s, hq, d), dt)
    q_off = np.asarray(q_offsets, np.int32)
    kl = q_off + np.asarray(prompts, np.int32)
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _both(pool)
    got = pfa.paged_prefill_attention(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(kl),
        torch.from_numpy(q_off), tks, tvs, sliding_window=window)
    want = j_prefill(jq, jk, jv, jnp.asarray(bt), jnp.asarray(kl),
                     jnp.asarray(q_off), jks, jvs, interpret=True,
                     sliding_window=window)
    assert got.dtype == tq.dtype and got.shape == (b, s, hq, d)
    _close(got, want, dt)


def test_wrappers_reject_bad_pool_operands():
    """An int8 or uint8 pool without both scales, a float pool with
    scales or in another dtype than q, and wrong scale shapes raise on
    every device, before any kernel or plain version runs."""
    q = torch.zeros((1, 4, 32))
    codes = torch.zeros((4, 8, 2, 32), dtype=torch.int8)
    packed = torch.zeros((4, 8, 2, 16), dtype=torch.uint8)
    scale = torch.ones((4, 8, 2))
    bt = torch.tensor([[1]], dtype=torch.int32)
    one = torch.tensor([1], dtype=torch.int32)
    off = torch.tensor([0], dtype=torch.int32)
    bad = [
        ((codes, codes, None, None), TypeError, "needs both"),
        ((packed, packed, scale, None), TypeError, "needs both"),
        ((codes.float(), codes.float(), scale, scale), TypeError,
         "takes no scales"),
        ((codes.bfloat16(), codes.bfloat16(), None, None), TypeError,
         "q's dtype"),
        ((codes, codes, scale[:, :, :1], scale), TypeError, "scales must"),
        ((codes, codes, scale.double(), scale), TypeError, "scales must"),
        ((codes.short(), codes.short(), scale, scale), TypeError,
         "not supported"),
        ((packed[..., :8], packed[..., :8], scale, scale), ValueError,
         "shapes"),
    ]
    for (k, v, ks, vs), exc, msg in bad:
        with pytest.raises(exc, match=msg):
            pa.paged_attention(q, k, v, bt, one, ks, vs)
        with pytest.raises(exc, match=msg):
            pfa.paged_prefill_attention(q[:, None], k, v, bt, one, off,
                                        ks, vs)


def test_kernel_alignment_rule_per_pool_kind():
    """The CUDA page load takes 16 bytes per thread: a stored row must be
    a multiple of 16 bytes, so head_dim % 16 for int8 codes, % 32 for
    packed int4, % 8 for bf16 (checked before any CUDA launch)."""
    from tpu_inference_torch.kernels import _pool

    def pool(d_pool, dtype):
        return torch.zeros((2, 4, 1, d_pool), dtype=dtype)

    ok = [("int8", pool(48, torch.int8)), ("int4", pool(32, torch.uint8)),
          ("bf16", pool(24, torch.bfloat16))]
    bad = [("int8", pool(40, torch.int8), 16),
           ("int4", pool(24, torch.uint8), 32),
           ("bf16", pool(20, torch.bfloat16), 8)]
    for variant, p in ok:
        _pool.check_kernel_alignment("k", variant, p, p)
    for variant, p, mult in bad:
        with pytest.raises(ValueError, match=f"multiple of {mult} "):
            _pool.check_kernel_alignment("k", variant, p, p)
