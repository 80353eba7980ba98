"""Port twin of engine/kv_cache.py (device half + PageAllocator) and of
engine/prefix_cache.py against the JAX reference: slot maps, pool
contents and gathers equal exactly; allocator and cache invariants."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as jkv
from tpu_inference.engine import prefix_cache as jpc
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkv
from tpu_inference_torch.engine import prefix_cache as tpc


def _setup(rng, b=3, s=6, pg=4, mp=5, num_pages=24):
    bt = rng.permutation(np.arange(1, num_pages))[:b * mp].reshape(
        b, mp).astype(np.int32)
    pos = (rng.integers(0, pg * mp - s, size=(b, 1))
           + np.arange(s)[None]).astype(np.int32)
    valid = rng.random((b, s)) < 0.7
    return bt, pos, valid


def test_slot_mapping_matches_reference():
    rng = np.random.default_rng(0)
    bt, pos, valid = _setup(rng)
    got = tkv.slot_mapping(torch.from_numpy(bt), torch.from_numpy(pos),
                           torch.from_numpy(valid), 4)
    want = jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos),
                            jnp.asarray(valid), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("layer", [0, 1])
def test_write_then_gather_matches_reference(layer):
    rng = np.random.default_rng(1)
    L, P, pg, H, D = 2, 24, 4, 2, 8
    b, s = 3, 6
    mcfg_t = tcfg.ModelConfig(n_layers=L, n_kv_heads=H, d_model=16,
                              n_heads=2, head_dim_override=D,
                              dtype=torch.float32)
    ecfg_t = tcfg.EngineConfig(page_size=pg, num_pages=P)
    mcfg_j = jcfg.ModelConfig(n_layers=L, n_kv_heads=H, d_model=16,
                              n_heads=2, head_dim_override=D,
                              dtype=jnp.float32)
    ecfg_j = jcfg.EngineConfig(page_size=pg, num_pages=P)
    kv_t = tkv.alloc_kv_pages(mcfg_t, ecfg_t, device="cpu")
    kv_j = jkv.alloc_kv_pages(mcfg_j, ecfg_j)
    assert tuple(kv_t.k.shape) == kv_j.k.shape
    bt, pos, valid = _setup(rng, b=b, s=s, pg=pg, mp=5, num_pages=P)
    for step in range(2):     # two writes: the second lands on the first
        k = rng.standard_normal((b, s, H, D)).astype(np.float32)
        v = rng.standard_normal((b, s, H, D)).astype(np.float32)
        slots_t = tkv.slot_mapping(torch.from_numpy(bt),
                                   torch.from_numpy(pos + step),
                                   torch.from_numpy(valid), pg)
        slots_j = jkv.slot_mapping(jnp.asarray(bt), jnp.asarray(pos + step),
                                   jnp.asarray(valid), pg)
        out = tkv.write_kv(kv_t, layer, torch.from_numpy(k),
                           torch.from_numpy(v), slots_t)
        assert out.k is kv_t.k               # updated in place
        kv_j = jkv.write_kv(kv_j, layer, jnp.asarray(k), jnp.asarray(v),
                            slots_j)
    # Page 0 (trash) takes every invalid token; its contents are
    # unspecified in both packages. Every real page matches exactly.
    np.testing.assert_array_equal(kv_t.k.numpy()[:, 1:],
                                  np.asarray(kv_j.k)[:, 1:])
    np.testing.assert_array_equal(kv_t.v.numpy()[:, 1:],
                                  np.asarray(kv_j.v)[:, 1:])
    gk_t, gv_t = tkv.gather_kv(kv_t, layer, torch.from_numpy(bt))
    gk_j, gv_j = jkv.gather_kv(kv_j, layer, jnp.asarray(bt))
    np.testing.assert_array_equal(gk_t.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(gv_t.numpy(), np.asarray(gv_j))


@pytest.mark.parametrize("n,pg,already", [(0, 4, 0), (1, 4, 0), (4, 4, 0),
                                          (5, 4, 3), (9, 16, 7), (3, 4, 4)])
def test_pages_needed_matches_reference(n, pg, already):
    assert tkv.pages_needed(n, pg, already) == jkv.pages_needed(n, pg,
                                                                already)


def test_page_allocator_tracks_reference_op_for_op():
    """A random op sequence on both allocators: same pages handed out,
    same free counts and refcounts, trash page never allocated."""
    rng = np.random.default_rng(2)
    t, j = tkv.PageAllocator(32), jkv.PageAllocator(32)
    held: list = []
    for _ in range(400):
        op = rng.integers(0, 3)
        if op == 0 and t.num_free:
            n = int(rng.integers(1, min(4, t.num_free) + 1))
            got = t.allocate(n)
            assert got == j.allocate(n)
            assert 0 not in got
            held += got
        elif op == 1 and held:
            p = held[int(rng.integers(0, len(held)))]
            assert t.share(p) == j.share(p)
            held.append(p)
        elif op == 2 and held:
            p = held.pop(int(rng.integers(0, len(held))))
            t.free([p])
            j.free([p])
        assert t.num_free == j.num_free
        assert all(t.refcount(p) == j.refcount(p) for p in range(32))
    with pytest.raises(MemoryError):
        t.allocate(t.num_free + 1)


def test_page_allocator_evictable_accounting():
    a = tkv.PageAllocator(8)
    flips = []
    a.on_evictable = lambda page, up: flips.append((page, up))
    (p,) = a.allocate(1)
    a.share(p)                 # cache reference
    a.mark_cached(p)
    assert a.evictable_count == 0          # a sequence still holds it
    a.free([p])                            # sequence releases
    assert a.evictable_count == 1 and flips == [(p, True)]
    a.share(p)                             # a new hit pins it again
    assert a.evictable_count == 0 and flips[-1] == (p, False)
    a.free([p])
    a.unmark_cached(p)
    a.free([p])
    assert a.num_free == 7 and a.evictable_count == 0
    a.free([0])                            # the trash page is ignored
    with pytest.raises(AssertionError, match="double free"):
        a.free([p])


@pytest.mark.parametrize("n_tokens", [0, 7, 16, 45])
def test_chain_hashes_match_reference(n_tokens):
    toks = np.random.default_rng(3).integers(0, 50000, n_tokens).tolist()
    assert tpc._chain_hashes(toks, 8) == jpc._chain_hashes(toks, 8)
    assert tpc.extend_chain_hashes(toks, 8, tpc._chain_hashes(toks[:9], 8)) \
        == jpc._chain_hashes(toks, 8)


def test_prefix_cache_lookup_insert_evict():
    a = tkv.PageAllocator(16)
    cache = tpc.PrefixCache(a, 4)
    toks = list(range(100, 111))                 # 2 full pages + 3
    pages = a.allocate(3)
    assert cache.insert(toks, pages) == 2        # full pages only
    assert len(cache) == 2
    a.free(pages)                                # the sequence ends
    assert cache.evictable == 2
    hit, host, n = cache.lookup(toks + [5], max_tokens=len(toks))
    assert hit == pages[:2] and host == [] and n == 8
    assert cache.evictable == 0                  # pinned by the hit
    a.free(hit)
    assert cache.evict(1) == 1 and len(cache) == 1
    miss, host, n = cache.lookup([1, 2, 3, 4, 5])
    assert miss == [] and host == [] and n == 0
    cache.clear()
    assert a.num_free == 15 and cache.evictable == 0
