"""The kernels' plain versions against the reference's Pallas kernels,
run the way tests/test_kernels.py runs them on the CPU (interpret mode).

On CPU tensors the wrappers take their plain versions, so these tests
hold the plain arithmetic the CUDA kernels are compared with on the card
(chip_smoke.py) to the TPU kernels' semantics: float32 within 1e-5
(decode) and 2e-5 (prefill), bfloat16 within 2e-2.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_inference.kernels.paged_attention import paged_attention as j_decode
from tpu_inference.kernels.prefill_attention import (
    paged_prefill_attention as j_prefill)
from tpu_inference_torch.kernels import _build
from tpu_inference_torch.kernels import paged_attention as pa
from tpu_inference_torch.kernels import prefill_attention as pfa

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _pool(rng, num_pages, pg, hkv, d, b, mp):
    k = rng.standard_normal((num_pages, pg, hkv, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, pg, hkv, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))[:b * mp]
    return k, v, perm.reshape(b, mp).astype(np.int32)


def _both(arr, dt):
    """(jax array, torch tensor) of the same values in dtype ``dt``; the
    torch copy goes through float32 of the jax-rounded values, so bf16
    inputs are bit-identical."""
    j = jnp.asarray(arr, JDT[dt])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dt])
    return j, t


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dt,hq,hkv,kv_lens,window", [
    ("f32", 8, 2, None, 0),
    ("bf16", 8, 2, None, 0),
    ("f32", 8, 2, (1, 1, 1), 0),          # softmax of one
    ("f32", 4, 4, None, 0),               # MHA
    ("f32", 8, 2, (30, 9, 17), 8),        # sliding window
    ("bf16", 8, 2, (30, 3, 32), 12),
])
def test_decode_plain_matches_pallas(dt, hq, hkv, kv_lens, window):
    rng = np.random.default_rng(0)
    b, d, pg, npg, mp = 3, 64, 8, 32, 4
    k, v, bt = _pool(rng, npg, pg, hkv, d, b, mp)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    if kv_lens is None:
        kv_lens = rng.integers(1, pg * mp + 1, size=b)
    kl = np.asarray(kv_lens, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dt) for x in (q, k, v))
    got = pa.paged_attention(tq, tk, tv, torch.from_numpy(bt),
                             torch.from_numpy(kl), sliding_window=window)
    want = j_decode(jq, jk, jv, jnp.asarray(bt), jnp.asarray(kl),
                    sliding_window=window)
    assert got.dtype == TDT[dt] and got.shape == (b, hq, d)
    _close(got, want, 1e-5 if dt == "f32" else 2e-2)


@pytest.mark.parametrize("dt,s,hq,hkv,q_offsets,prompts,window", [
    ("f32", 32, 8, 2, (5, 0), (20, 32), 0),     # test_kernels.py shapes
    ("f32", 32, 8, 2, (0, 13), (20, 32), 0),
    ("f32", 24, 4, 4, (0,), (24,), 0),          # non-power-of-two S, MHA
    ("bf16", 32, 8, 2, (5, 0), (20, 32), 0),
    ("f32", 32, 8, 2, (5, 0), (20, 32), 6),     # sliding window
    ("f32", 24, 8, 2, (16, 40), (24, 10), 9),
    ("f32", 1, 8, 2, (0, 7), (1, 1), 0),        # one-token chunks
])
def test_prefill_plain_matches_pallas(dt, s, hq, hkv, q_offsets, prompts,
                                      window):
    rng = np.random.default_rng(7)
    d, pg, npg, mp = 64, 8, 64, 8
    b = len(prompts)
    k, v, bt = _pool(rng, npg, pg, hkv, d, b, mp)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    q_off = np.asarray(q_offsets, np.int32)
    kl = q_off + np.asarray(prompts, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dt) for x in (q, k, v))
    got = pfa.paged_prefill_attention(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(kl),
        torch.from_numpy(q_off), sliding_window=window)
    want = j_prefill(jq, jk, jv, jnp.asarray(bt), jnp.asarray(kl),
                     jnp.asarray(q_off), sliding_window=window)
    assert got.dtype == TDT[dt] and got.shape == (b, s, hq, d)
    _close(got, want, 2e-5 if dt == "f32" else 2e-2)


def test_page_ids_out_of_range_clamp_into_the_pool():
    """A corrupt block-table entry reads a page inside the pool (clamped,
    as the reference's gather clamps) instead of faulting."""
    rng = np.random.default_rng(3)
    k, v, bt = _pool(rng, 16, 8, 2, 32, 1, 2)
    q = torch.from_numpy(rng.standard_normal((1, 4, 32)).astype(np.float32))
    kl = torch.tensor([12], dtype=torch.int32)
    bad = bt.copy()
    bad[0, 1] = 999
    clamped = bt.copy()
    clamped[0, 1] = 15
    args = (torch.from_numpy(k), torch.from_numpy(v))
    torch.testing.assert_close(
        pa.paged_attention(q, *args, torch.from_numpy(bad), kl),
        pa.paged_attention(q, *args, torch.from_numpy(clamped), kl))


def test_cpu_path_never_builds_or_counts(monkeypatch):
    """The kernel modules import and serve CPU tensors on a machine with
    neither nvcc nor a GPU: the plain versions run, nothing builds, the
    launch counters stay put."""
    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    before = (pa.launches, pfa.launches)
    q = torch.zeros((1, 2, 16))
    pool = torch.zeros((4, 8, 1, 16))
    bt = torch.tensor([[1]], dtype=torch.int32)
    one = torch.tensor([1], dtype=torch.int32)
    pa.paged_attention(q, pool, pool, bt, one)
    pfa.paged_prefill_attention(q[:, None], pool, pool, bt, one,
                                torch.tensor([0], dtype=torch.int32))
    assert (pa.launches, pfa.launches) == before


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("paged_attention")


# ---------------------------------------------------------------------------
# The decode kernel's split-KV design, on the CPU: the host's split plan
# (shapes only), and the split-and-combine arithmetic emulated in PyTorch
# (partials over page ranges, log-sum-exp merge), held to the plain version
# and to the Pallas kernel.

@pytest.mark.parametrize("batch,hkv,mp,pg,window", [
    (8, 8, 128, 16, 0),        # the main path: batch 8, 128 pages
    (1, 8, 128, 16, 0),
    (3, 8, 128, 16, 0),
    (64, 8, 128, 16, 0),       # enough blocks without splitting
    (8, 8, 128, 16, 256),      # a window bounds the pages read
    (8, 8, 128, 16, 4000),     # a window wider than the table
    (1, 2, 7, 16, 0),
    (2, 1, 1, 16, 0),
    (1, 8, 4096, 1, 0),        # one-token pages
    (1, 8, 0, 16, 0),          # an empty block table
])
def test_split_plan_covers_the_readable_pages(batch, hkv, mp, pg, window):
    # The plan reads the table width, page size and window only: the
    # batch and head count of each case play no part in it.
    ns, pps = pa.split_plan(mp, pg, window)
    span = max(min(mp, -(-window // pg) + 1) if window else mp, 1)
    assert ns >= 1 and pps >= 1
    assert ns * pps >= span > (ns - 1) * pps   # covered, none without pages
    min_pages = -(-pa.MIN_SPLIT_TOKENS // pg)
    assert pps == min(span, min_pages)          # MIN_SPLIT_TOKENS pieces
    assert ns == -(-span // min_pages)


def test_split_plan_main_path_and_batch_scaling():
    import inspect
    # Llama-3-8B over 128 pages of 16: 8 splits of 16 pages, at every
    # batch width (the grid grows with the batch; the splits do not).
    assert pa.split_plan(128, 16) == (8, 16)
    assert "batch" not in inspect.signature(pa.split_plan).parameters
    # So a lane's row is the same arithmetic at every batch: the same
    # lane placed in batches of 1, 3 and 8 gives the same output row.
    rng = np.random.default_rng(5)
    k, v, bt = _pool(rng, 40, 8, 2, 64, 8, 4)
    q = torch.from_numpy(rng.standard_normal((8, 8, 64)).astype(np.float32))
    kl = torch.from_numpy(rng.integers(1, 33, size=8).astype(np.int32))
    tk, tv, tbt = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bt)
    rows = [pa.paged_attention(q[:n], tk, tv, tbt[:n], kl[:n])[0]
            for n in (1, 3, 8)]
    assert all(torch.equal(rows[0], r) for r in rows[1:])


def _split_tokens(kv_len, split, pg, mp, window, pps):
    """Token range [t_lo, t_hi) of one sequence's split, as split_plan's
    docstring assigns pages (``pps`` each from the window's first page, or
    from page 0), cut to kv_len and the window; empty when t_lo >= t_hi."""
    len_c = min(kv_len, mp * pg)
    win_lo = max(kv_len - window, 0) if window else 0
    p_lo = win_lo // pg + split * pps
    return max(p_lo * pg, win_lo), min((p_lo + pps) * pg, len_c)


def _split_emulation(q, k_pages, v_pages, bt, kv_len, k_scale, v_scale,
                     window, num_splits, pps):
    """Decode attention the way the kernel splits it: one float32 partial
    (m, l, acc) per non-empty split of each sequence's pages, merged by
    the log-sum-exp rule; splits past kv_len (or before the window) are
    empty and take no part."""
    from tpu_inference_torch.engine.kv_cache import gather_pages
    b, hq, d = q.shape
    pg, hkv = k_pages.shape[1], k_pages.shape[2]
    mp = bt.shape[1]
    k = gather_pages(k_pages, k_scale, bt).float()      # [B, T, Hkv, D]
    v = gather_pages(v_pages, v_scale, bt).float()
    out = torch.zeros(b, hkv, hq // hkv, d)
    empty = 0
    for i in range(b):
        qi = q[i].float().reshape(hkv, hq // hkv, d)
        parts = []
        for s in range(num_splits):
            t_lo, t_hi = _split_tokens(int(kv_len[i]), s, pg, mp, window,
                                       pps)
            if t_lo >= t_hi:           # nothing to read: no partial
                empty += 1
                continue
            sc = (torch.einsum("hrd,thd->hrt", qi, k[i, t_lo:t_hi])
                  / math.sqrt(d))
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hrt,thd->hrd", p, v[i, t_lo:t_hi])))
        if parts:
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            w = [torch.exp(m - mx) for m, _, _ in parts]
            den = sum(l * wi for (_, l, _), wi in zip(parts, w))
            out[i] = sum(a * wi for (_, _, a), wi in zip(parts, w)) / den
    return out.reshape(b, hq, d).to(q.dtype), empty


@pytest.mark.parametrize("mode,window,splits", [
    ("float", 0, (4, 2)),
    ("float", 0, (3, 3)),       # the last split shorter
    ("float", 12, (3, 1)),      # window: splits from its first page
    ("int8", 0, (4, 2)),
    ("int8", 12, (2, 2)),
])
def test_split_combine_matches_plain_and_pallas(mode, window, splits):
    from tests.test_torch_kv_quant import _quantized_pool
    rng = np.random.default_rng(11)
    b, hq, hkv, d, pg, npg, mp = 3, 8, 2, 64, 8, 32, 8
    kv_lens = np.asarray([1, 17, 64], np.int32)    # later splits empty
    if mode == "float":
        k, v, bt = _pool(rng, npg, pg, hkv, d, b, mp)
        jpool = [jnp.asarray(k), jnp.asarray(v), None, None]
        tpool = [torch.from_numpy(k), torch.from_numpy(v), None, None]
    else:
        pool, bt = _quantized_pool(rng, "int8", npg, pg, hkv, d, b, mp)
        jpool = [jnp.asarray(a) for a in pool]
        tpool = [torch.from_numpy(a.copy()) for a in pool]
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    tq, tbt, tkl = (torch.from_numpy(x) for x in (q, bt, kv_lens))
    tk, tv, tks, tvs = tpool
    got, empty = _split_emulation(tq, tk, tv, tbt, tkl, tks, tvs, window,
                                  *splits)
    assert empty > 0
    plain = pa.paged_attention_plain(tq, tk, tv, tbt, tkl, tks, tvs,
                                     sliding_window=window)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    jk, jv, jks, jvs = jpool
    want = j_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                    jnp.asarray(kv_lens), jks, jvs, interpret=True,
                    sliding_window=window)
    _close(got, want, 2e-5)
