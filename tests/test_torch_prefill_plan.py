"""The prefill kernel's plan and its long-query path, on the CPU.

``prefill_plan`` picks the kernel path from shapes alone; these tests
hold its threshold and tiles for every pool kind and q dtype, show that
the wrapper's plan never depends on the batch or ``kv_len``, check that
the key walk every CUDA path shares (csrc/prefill_attention.cu: from
the window start of a tile's first query to min(kv_len, last query + 1)
in 64-key tiles) reads every readable key of a row tile exactly once,
and emulate the wgmma path's arithmetic in PyTorch (bf16 Q, K and V
exact in bf16 (codes for quantized pools, with K scales on the float32
scores, V scales on the float32 P and P into P.V as two bf16 halves),
online softmax over 64-key tiles) against the plain version and the
reference's Pallas kernel in interpret mode, within the bf16 tolerance
the card holds the kernel to (2e-2).
"""

import inspect
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_kernels import _pool as _float_pool
from tests.test_torch_kv_quant import _quantized_pool
from tpu_inference.kernels.prefill_attention import (
    paged_prefill_attention as j_prefill)
from tpu_inference_torch.engine.kv_cache import gather_pages
from tpu_inference_torch.kernels import prefill_attention as pfa

BF16, F32 = torch.bfloat16, torch.float32
KINDS = [("bf16", BF16), ("f32", F32), ("int8", BF16), ("int8", F32),
         ("int4", BF16), ("int4", F32)]
KEYS = 64   # keys per tile on every tiled path


def test_plan_reads_shapes_only(monkeypatch):
    """The plan's inputs are S, n_rep, head_dim, the pool kind and q's
    dtype; the wrapper hands the kernel the same plan for a lane whatever
    batch it rides in and whatever the lanes' lengths."""
    assert list(inspect.signature(pfa.prefill_plan).parameters) == [
        "s", "n_rep", "d", "variant", "q_dtype"]
    seen = []
    monkeypatch.setattr(pfa, "_launch",
                        lambda plan, q, *a: seen.append(plan) or q)
    pool = torch.empty((40, 16, 8, 128), dtype=BF16, device="meta")
    for lens in ([600], [600, 1, 2000, 37], [5] * 8, [1500] * 32):
        b = len(lens)
        q = torch.empty((b, 512, 32, 128), dtype=BF16, device="meta")
        i32 = dict(dtype=torch.int32, device="meta")
        pfa.paged_prefill_attention(q, pool, pool, torch.empty((b, 94), **i32),
                                    torch.empty((b,), **i32),
                                    torch.empty((b,), **i32))
    assert len(seen) == 4 and all(p == seen[0] for p in seen)
    assert seen[0] == {"path": "wgmma", "code": 2, "tile_rows": 128}


@pytest.mark.parametrize("variant,q_dtype", KINDS)
@pytest.mark.parametrize("n_rep", [1, 4, 8])
def test_plan_threshold_and_tiles(variant, q_dtype, n_rep):
    # A bf16 pool's threshold is one full 128-row tile; a quantized
    # pool's is every call.
    min_rows = {"bf16": 128, "int8": 1, "int4": 1, "f32": None}[variant]
    if min_rows is not None:
        assert pfa.WGMMA_MIN_ROWS[variant] == min_rows
    edge = 128 // n_rep                      # S whose rows fill one tile
    for d in (32, 48, 64, 128, 256, 320):
        for s in (1, 2, 5, edge - 1, edge, edge + 1, 512, 2048):
            plan = pfa.prefill_plan(s, n_rep, d, variant, q_dtype)
            rows = s * n_rep
            if d > 256:
                want, tile = "wide", max(1, 64 // n_rep) * n_rep
            elif q_dtype == F32:
                want, tile = "simt", 64
            elif d in (64, 128) and rows >= min_rows:
                want, tile = "wgmma", 128
            else:
                want, tile = "mma", 64
            assert plan == {"path": want, "code": pfa.PATHS[want],
                            "tile_rows": tile}, (s, d)
    # The main path's chunk takes the new kernel in every bf16-q pool
    # kind; a bf16 pool's verify rounds keep the short-query kernel.
    if q_dtype == BF16 and n_rep == 4:
        assert pfa.prefill_plan(512, 4, 128, variant, q_dtype)["path"] == \
            "wgmma"
        for s in (2, 5):
            assert pfa.prefill_plan(s, 4, 128, variant, q_dtype)["path"] == \
                ("mma" if variant == "bf16" else "wgmma")


def test_plan_refuses_unknown_kinds():
    for variant, q_dtype in (("fp8", BF16), ("bf16", torch.float16),
                             ("f32", BF16), ("bf16", F32)):
        with pytest.raises(ValueError, match="pool kind"):
            pfa.prefill_plan(512, 4, 128, variant, q_dtype)


def _key_tiles(row0, n_real, n_rep, q_off, kv_len, window, max_keys):
    """The key tiles one row tile reads, in the kernels' arithmetic."""
    length = min(kv_len, max_keys)
    q_lo = q_off + row0 // n_rep
    q_hi = q_off + (row0 + n_real - 1) // n_rep
    k_first = max(q_lo - window + 1, 0) if window > 0 else 0
    k_end = min(length, q_hi + 1)
    n = -(-(k_end - k_first) // KEYS) if k_end > k_first else 0
    return [range(k_first + i * KEYS, min(k_first + (i + 1) * KEYS, k_end))
            for i in range(n)]


@pytest.mark.parametrize("s,n_rep,q_off,prompt,window,max_keys", [
    (512, 4, 1024, 512, 0, 1536),      # the main path's chunk
    (512, 4, 0, 300, 0, 512),          # a lane shorter than the chunk
    (2048, 4, 2048, 2048, 0, 4096),
    (33, 4, 37, 33, 0, 80),            # rows just past one tile, mid-page
    (31, 4, 37, 31, 0, 80),            # just under
    (129, 1, 5, 129, 100, 160),        # window cutting mid-tile
    (17, 8, 1000, 17, 0, 1024),
    (5, 4, 900, 5, 0, 1024),           # a verify round
    (5, 4, 0, 5, 0, 16),               # an inactive verify lane
    (77, 2, 300, 77, 48, 384),
    (1, 1, 0, 1, 0, 16),
])
def test_key_tiles_cover_every_readable_key_once(s, n_rep, q_off, prompt,
                                                 window, max_keys):
    kv_len = q_off + prompt
    for path in ("wgmma", "mma", "simt"):
        rows = pfa.TILE_ROWS[path]
        for row0 in range(0, s * n_rep, rows):
            n_real = min(rows, s * n_rep - row0)
            walked = [k for t in _key_tiles(row0, n_real, n_rep, q_off,
                                            kv_len, window, max_keys)
                      for k in t]
            readable = set()
            for g in range(row0, row0 + n_real):
                qp = q_off + g // n_rep
                lo = max(qp - window + 1, 0) if window else 0
                readable |= set(range(lo, min(qp + 1, kv_len, max_keys)))
            assert len(walked) == len(set(walked))
            assert set(walked) == readable, (path, row0)


def _long_query_emulation(q, k, v, ks, vs, bt, kv_len, q_off, window, kind):
    """The wgmma path in PyTorch: 128-row tiles of (query, head) rows per
    (lane, kv-head), 64-key tiles from the window start of the tile's
    first query; bf16 operands with float32 products: Q, K and V (codes
    for quantized pools, exact in bf16; K's scales on the scores, V's on
    P, and P as hi = bf16(p) plus lo = bf16(p - hi)) and P."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    quant = kind != "bf16"
    kc = gather_pages(k, None, bt).float()     # [B, T, Hkv, D] codes/values
    vc = gather_pages(v, None, bt).float()
    kscale = gather_pages(ks[..., None], None, bt)[..., 0] if quant else None
    vscale = gather_pages(vs[..., None], None, bt)[..., 0] if quant else None
    kb, vb = kc.to(BF16).float(), vc.to(BF16).float()
    qb = q.to(BF16).float()
    out = torch.zeros((b, s, hq, d))
    scale = 1.0 / math.sqrt(d)
    for lane in range(b):
        for h in range(hkv):
            rows = qb[lane, :, h * n_rep:(h + 1) * n_rep].reshape(-1, d)
            qpos = int(q_off[lane]) + torch.arange(s * n_rep) // n_rep
            for row0 in range(0, s * n_rep, 128):
                n_real = min(128, s * n_rep - row0)
                qt, qp = rows[row0:row0 + n_real], qpos[row0:row0 + n_real]
                m = torch.full((n_real,), -1e30)
                l = torch.zeros(n_real)
                o = torch.zeros((n_real, d))
                for t in _key_tiles(row0, n_real, n_rep, int(q_off[lane]),
                                    int(kv_len[lane]), window, kc.shape[1]):
                    keys = torch.tensor(list(t))
                    x = qt @ kb[lane, keys, h].T * scale
                    if quant:
                        x = x * kscale[lane, keys, h]
                    ok = (keys[None] <= qp[:, None]) & (
                        keys[None] < int(kv_len[lane]))
                    if window:
                        ok &= keys[None] > qp[:, None] - window
                    x = torch.where(ok, x, torch.tensor(-1e30))
                    m_new = torch.maximum(m, x.amax(1))
                    p = torch.where(ok, torch.exp(x - m_new[:, None]),
                                    torch.tensor(0.0))
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(1)
                    if quant:
                        p = p * vscale[lane, keys, h][None]
                    hi = p.to(BF16).float()
                    if quant:                     # P's two bf16 halves
                        hi = hi + (p - hi).to(BF16).float()
                    o = o * alpha[:, None] + hi @ vb[lane, keys, h]
                    m = m_new
                o = torch.where(l[:, None] > 0,
                                o / l.clamp_min(1e-30)[:, None],
                                torch.tensor(0.0))
                g = torch.arange(row0, row0 + n_real)
                out[lane, g // n_rep, h * n_rep + g % n_rep] = o
    return out


@pytest.mark.parametrize("kind,window,hq,hkv,d", [
    ("bf16", 0, 8, 2, 64),
    ("bf16", 20, 8, 2, 64),     # a window cutting mid-tile
    ("int8", 0, 8, 2, 64),
    ("int8", 20, 4, 4, 64),     # MHA
    ("int4", 0, 16, 2, 64),     # n_rep 8
])
def test_long_query_emulation_matches_plain_and_pallas(kind, window, hq,
                                                       hkv, d):
    rng = np.random.default_rng(5)
    pg, npg, mp = 8, 32, 10
    s, q_offsets, prompts = 40, (0, 37, 0), (40, 40, 40)  # 2 x 128-row tiles
    b = len(prompts)
    if kind == "bf16":
        k, v, bt = _float_pool(rng, npg, pg, hkv, d, b, mp)
        k, v = (x.astype(jnp.bfloat16).astype(np.float32) for x in (k, v))
        pool = (k, v, None, None)
    else:
        pool, bt = _quantized_pool(rng, kind, npg, pg, hkv, d, b, mp)
    bt[2] = 0                    # an inactive lane: the trash page only
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    q_off = np.asarray(q_offsets, np.int32)
    kl = q_off + np.asarray(prompts, np.int32)
    tk, tv, tks, tvs = (None if x is None else torch.from_numpy(x.copy())
                        for x in pool)
    tq, tbt, tkl, toff = (torch.from_numpy(x) for x in (q, bt, kl, q_off))
    got = _long_query_emulation(tq, tk, tv, tks, tvs, tbt, tkl, toff, window,
                                kind)
    tpool = (tk.to(BF16), tv.to(BF16)) if kind == "bf16" else (tk, tv)
    plain = pfa.paged_prefill_attention_plain(
        tq.to(BF16), *tpool, tbt, tkl, toff, tks, tvs,
        sliding_window=window).float()
    scale = plain.abs().max().item()
    assert (got - plain).abs().max().item() <= 2e-2 * min(1.0, scale)
    jk, jv = (jnp.asarray(x, jnp.bfloat16) if kind == "bf16"
              else jnp.asarray(x) for x in pool[:2])
    jscales = [None if x is None else jnp.asarray(x) for x in pool[2:]]
    want = j_prefill(jnp.asarray(q, jnp.bfloat16), jk, jv, jnp.asarray(bt),
                     jnp.asarray(kl), jnp.asarray(q_off), *jscales,
                     sliding_window=window)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert (got - want).abs().max().item() <= 2e-2 * min(1.0, scale)
