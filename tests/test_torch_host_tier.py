"""The port's host-RAM KV tier against the reference's (tests/
test_host_tier.py cases, port beside reference): offload and restore
bit-identical for every pool kind, with host copies byte-equal to the
reference's; the tiered prefix cache's demote/lookup/readmit/drop
behaviour and accounting equal to the reference's under the same
operations; host capacity never exceeded; generation under tier churn,
swap-in resume and the queue-wait prefetch giving the tokens of a cold
run."""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_ladder import VOCAB, port_engine, ref_engine
from tpu_inference import config as jcfg
from tpu_inference.engine import kv_cache as jkv
from tpu_inference.engine import prefix_cache as jpc
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import kv_cache as tkv
from tpu_inference_torch.engine import prefix_cache as tpc
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.engine.scheduler import EngineScheduler


def _cfg(**kw) -> dict:
    base = dict(page_size=8, num_pages=14, max_pages_per_seq=8,
                max_batch_size=2, prefill_buckets=(16, 32, 64),
                decode_steps_per_call=4, host_cache_pages=64)
    base.update(kw)
    return base


@pytest.mark.parametrize("kv_quant,dtype", [
    ("none", "float32"), ("none", "bfloat16"), ("int8", "float32"),
    ("int4", "float32")])
def test_offload_restore_roundtrip_bit_identical(kv_quant, dtype):
    """Random K/V written into pages of both packages' pools: the port's
    host copies hold the reference's bytes, and restoring them into
    other page ids reproduces the stored pages bit for bit."""
    rng = np.random.default_rng(0)
    jm = jcfg.tiny_llama(vocab_size=VOCAB)
    tm = tcfg.tiny_llama(vocab_size=VOCAB)
    ekw = dict(page_size=4, num_pages=16, max_pages_per_seq=4,
               max_batch_size=2, kv_quant=kv_quant)
    jdt = {"float32": np.float32, "bfloat16": "bfloat16"}[dtype]
    jk = jkv.alloc_kv_pages(jm, jcfg.EngineConfig(**ekw),
                            dtype=None if dtype == "float32" else jdt)
    tk = tkv.alloc_kv_pages(tm, tcfg.EngineConfig(**ekw),
                            dtype=getattr(torch, dtype), device="cpu")
    bt = np.zeros((1, 4), np.int32)
    bt[0, :3] = [1, 2, 3]
    s = 10                                       # 2.5 pages of 4
    pos = np.arange(s, dtype=np.int32)[None]
    valid = np.ones((1, s), bool)
    shape = (1, s, tm.n_kv_heads, tm.head_dim)
    k_new = rng.standard_normal(shape).astype(np.float32)
    v_new = rng.standard_normal(shape).astype(np.float32)
    jslots = jkv.slot_mapping(bt, pos, valid, 4)
    tslots = tkv.slot_mapping(torch.from_numpy(bt), torch.from_numpy(pos),
                              torch.from_numpy(valid), 4)
    for layer in range(tm.n_layers):
        jk = jkv.write_kv(jk, layer, k_new * (layer + 1), v_new, jslots)
        tk = tkv.write_kv(tk, layer,
                          torch.from_numpy(k_new * (layer + 1)).to(
                              getattr(torch, dtype)),
                          torch.from_numpy(v_new).to(getattr(torch, dtype)),
                          tslots)
    jhost = jkv.offload_pages(jk, [1, 2, 3])
    thost = tkv.offload_pages(tk, [1, 2, 3])
    fields = ("k", "v", "k_scale", "v_scale") if tk.quantized else ("k", "v")
    for jp, tp in zip(jhost, thost):
        assert jp.nbytes == tp.nbytes
        for f in fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(jp, f)).astype(np.float32),
                getattr(tp, f).float().numpy())
    tk = tkv.restore_pages(tk, [7, 9, 12], thost)
    for src, dst in ((1, 7), (2, 9), (3, 12)):
        for pool in ([tk.k, tk.v, tk.k_scale, tk.v_scale] if tk.quantized
                     else [tk.k, tk.v]):
            assert torch.equal(pool[:, src], pool[:, dst])


def _fake_offload(host_mod):
    """offload_fn of one tiny distinct page copy per page, so byte
    accounting runs without a device pool."""
    if host_mod is tkv:
        return lambda pages: [tkv.HostKVPage(
            k=torch.full((1, 2), p, dtype=torch.int8),
            v=torch.full((1, 2), -p, dtype=torch.int8)) for p in pages]
    return lambda pages: [jkv.HostKVPage(
        k=np.full((1, 2), p, np.int8), v=np.full((1, 2), -p, np.int8))
        for p in pages]


def _caches(capacity, num_pages=16, page_size=4):
    out = []
    for kv_mod, pc_mod in ((tkv, tpc), (jkv, jpc)):
        alloc = kv_mod.PageAllocator(num_pages)
        pool = kv_mod.HostPagePool(capacity)
        out.append((alloc, pool, pc_mod.PrefixCache(
            alloc, page_size, host_pool=pool,
            offload_fn=_fake_offload(kv_mod))))
    return out


def _state(alloc, pool, cache):
    return (alloc.num_free, alloc.evictable_count, len(cache),
            len(cache._host), pool.used, pool.bytes_resident,
            pool.offloaded_total, pool.restored_total, pool.evicted_total,
            list(cache._host), list(cache._table))


def test_tiered_cache_matches_reference_under_churn():
    """A random mix of publishes, lookups (with restores and failed
    restores), evictions and releases on both packages' caches: the
    same state after every operation."""
    rng = np.random.default_rng(1)
    convs = [rng.integers(0, 50, size=int(n)).tolist()
             for n in rng.integers(8, 40, size=6)]
    pair = _caches(capacity=6, num_pages=24)
    held = [[], []]
    for step in range(120):
        op = rng.integers(0, 4)
        conv = convs[int(rng.integers(0, len(convs)))]
        n_evict = int(rng.integers(1, 6))
        for side, (alloc, pool, cache) in enumerate(pair):
            if op == 0 and alloc.num_free >= 12:        # a sequence ends
                pages = alloc.allocate(-(-len(conv) // 4))
                cache.insert(conv, pages)
                alloc.free(pages)
            elif op == 1:                               # a returning prompt
                pages, host, n = cache.lookup(conv,
                                              max_tokens=len(conv) - 1)
                if host and alloc.num_free >= len(host) and step % 3:
                    fresh = alloc.allocate(len(host))
                    for (i, d, _), p in zip(host, fresh):
                        cache.promote(d, p)
                    alloc.free(fresh)
                elif host:
                    cache.readmit_host([(d, e) for _, d, e in host])
                held[side].append([p for p in pages if p is not None])
            elif op == 2:
                cache.evict(n_evict)
            elif held[side]:
                alloc.free(held[side].pop(0))
        assert _state(*pair[0]) == _state(*pair[1]), step
    for side, (alloc, pool, cache) in enumerate(pair):
        for pages in held[side]:
            alloc.free(pages)
        cache.clear()
        assert pool.used == 0 and pool.bytes_resident == 0
        assert alloc.num_free == alloc.num_pages - 1


def test_evict_demotes_and_lookup_restores_ownership():
    for alloc, pool, cache in _caches(capacity=8):
        tokens = list(range(12))                 # 3 full pages
        pages = alloc.allocate(3)
        cache.insert(tokens, pages)
        alloc.free(pages)
        assert cache.evict(3) == 3               # all demote
        assert alloc.num_free == 15 and len(cache) == 0
        assert pool.used == 3 and len(cache._host) == 3
        got, host_entries, n = cache.lookup(tokens)
        assert n == 12 and got == [None, None, None]
        assert [i for i, _, _ in host_entries] == [0, 1, 2]
        assert pool.used == 0 and len(cache._host) == 0
        cache.readmit_host([(d, e) for _, d, e in host_entries])
        assert pool.used == 3 and len(cache._host) == 3
        assert cache.peek_digests_tiered(
            tpc._chain_hashes(tokens, 4)) == (0, 3)
        cache.clear()
        assert pool.used == 0 and pool.bytes_resident == 0


def test_readmit_never_exceeds_host_capacity():
    for alloc, pool, cache in _caches(capacity=2):
        a, b = list(range(8)), list(range(100, 108))
        for toks in (a, b):
            pages = alloc.allocate(2)
            cache.insert(toks, pages)
            alloc.free(pages)
        cache.evict(2)                           # a's pages demote
        _, host, _ = cache.lookup(a)             # taken out of the tier
        assert pool.used == 0
        cache.evict(2)                           # b's pages fill the tier
        assert pool.used == 2
        cache.readmit_host([(d, e) for _, d, e in host])
        assert pool.used <= pool.capacity == 2
        cache.clear()
        assert pool.used == 0


def test_zero_host_capacity_degrades_to_free_on_evict():
    for alloc, pool, cache in _caches(capacity=0):
        pages = alloc.allocate(3)
        cache.insert(list(range(12)), pages)
        alloc.free(pages)
        assert cache.evict(3) == 3
        assert pool.used == 0 and not cache._host
        assert alloc.num_free == 15


def test_second_tier_eviction_when_host_runs_dry():
    for alloc, pool, cache in _caches(capacity=2):
        for base in (0, 100):
            pages = alloc.allocate(2)
            cache.insert(list(range(base, base + 8)), pages)
            alloc.free(pages)
            cache.evict(2)
        assert pool.used == 2 and pool.evicted_total == 2
        cache.clear()


def test_oversized_victim_batch_never_flushes_host_tier():
    """A victim batch larger than the tier keeps its newest victims and
    drops no more of the tier than it can use."""
    for alloc, pool, cache in _caches(capacity=3, num_pages=32):
        pages = alloc.allocate(6)
        cache.insert(list(range(24)), pages)
        alloc.free(pages)
        assert cache.evict(6) == 6
        assert pool.used == 3
        assert sorted(cache._host) == sorted(
            tpc._chain_hashes(list(range(24)), 4)[3:])
        cache.clear()


def test_tier_invariant_publish_supersedes_host():
    for alloc, pool, cache in _caches(capacity=8):
        toks = list(range(8))
        pages = alloc.allocate(2)
        cache.insert(toks, pages)
        alloc.free(pages)
        cache.evict(2)
        assert len(cache._host) == 2
        pages = alloc.allocate(2)
        cache.insert(toks, pages)                # recomputed elsewhere
        assert not (set(cache._host) & set(cache._table))
        assert pool.used == 0
        alloc.free(pages)
        cache.clear()


def test_generation_byte_identical_under_tier_churn():
    """Working set beyond the device pool: outputs equal a cold engine's
    while pages demote and restore; the counters agree with the
    reference's under the same traffic."""
    eng, jeng = port_engine(**_cfg()), ref_engine(**_cfg())
    cold = port_engine(**_cfg(num_pages=64, host_cache_pages=0,
                              enable_prefix_cache=False))
    prompts = [list(range(i * 7, i * 7 + 30)) for i in range(5)]
    want = [cold.generate([p], max_new_tokens=6)[0] for p in prompts]
    for _ in range(3):
        for i, p in enumerate(prompts):
            assert eng.generate([p], max_new_tokens=6)[0] == want[i]
            assert jeng.generate([p], max_new_tokens=6)[0] == want[i]
    st, jst = eng.prefix_cache.stats(), jeng.prefix_cache.stats()
    assert st["offloaded_pages"] > 0 and st["restored_pages"] > 0
    for k in ("entries", "host_entries", "host_pages_used",
              "offloaded_pages", "restored_pages", "host_evictions",
              "host_bytes_resident"):
        assert st[k] == jst[k], k
    tel = eng.telemetry
    assert tel.kv_offload_pages.value == st["offloaded_pages"]
    assert tel.kv_restore_pages.value > 0
    assert tel.kv_offload_bytes.value > 0 and tel.kv_restore_bytes.value > 0
    eng.check_pool_clean()


def test_preempt_then_swap_in_resume_byte_identical():
    """A preempted sequence whose published pages demoted restores them
    at resume instead of re-prefilling, with the cold tokens."""
    prompt = list(range(1, 13))
    big = dict(num_pages=40, max_pages_per_seq=16, max_batch_size=4)
    want = port_engine(**_cfg(**big, host_cache_pages=0)).generate(
        [prompt], max_new_tokens=16)[0]
    eng = port_engine(**_cfg(**big, admission="optimistic"))
    seq = Sequence(request_id=0, prompt_tokens=list(prompt),
                   max_new_tokens=16)
    eng.prefill(seq)
    while len(seq.generated) < 6:
        eng.decode_steps(max_steps=1)
    eng.preempt(seq)
    assert eng.take_preempted() == [seq]
    assert eng.prefix_cache.evict(100) > 0
    assert len(eng.prefix_cache) == 0
    assert eng.prefix_cache.stats()["host_entries"] > 0
    eng.prefill(seq)                              # resume
    assert seq.host_restored_pages > 0 and seq.cached_tokens > 0
    assert eng.swap_in_resumes == 1
    while eng.active_sequences():
        eng.decode_steps()
    assert seq.generated == want
    eng.release(seq)
    eng.check_pool_clean()


def test_queue_wait_prefetch_promotes_host_pages():
    eng = port_engine(**_cfg(num_pages=24))
    prompt = list(range(40, 70))                  # 3 full pages of 8
    want = eng.generate([prompt], max_new_tokens=6)[0]
    assert eng.prefix_cache.evict(100) > 0
    seq = Sequence(request_id=1, prompt_tokens=list(prompt),
                   max_new_tokens=6)
    promoted = eng.prefetch_host_hits(seq)
    assert promoted >= 3 and seq.host_prefetched
    assert eng.prefetch_host_hits(seq) == 0      # idempotent
    assert eng.allocator.evictable_count >= promoted
    eng.prefill(seq)
    assert seq.cached_tokens >= promoted * 8 - 8
    assert seq.host_restored_pages == 0
    while eng.active_sequences():
        eng.decode_steps()
    assert seq.generated == want
    eng.release(seq)
    eng.check_pool_clean()


def test_prefetch_without_free_pages_retries_later():
    eng = port_engine(**_cfg(num_pages=12))
    prompt = list(range(40, 70))
    eng.generate([prompt], max_new_tokens=6)
    eng.prefix_cache.evict(100)
    hold = eng.allocator.allocate(eng.allocator.num_free)
    seq = Sequence(request_id=2, prompt_tokens=list(prompt),
                   max_new_tokens=4)
    assert eng.prefetch_host_hits(seq) == 0
    assert not seq.host_prefetched
    eng.allocator.free(hold)
    assert eng.prefetch_host_hits(seq) > 0
    eng.prefix_cache.clear()
    eng.check_pool_clean()


def test_scheduler_prefetches_during_queue_wait():
    """Through the scheduler: a request waiting for the one slot gets its
    host-tier pages promoted while queued, and its tokens are the warm
    run's."""
    eng = port_engine(**_cfg(num_pages=40, max_batch_size=1))
    warm = list(range(40, 70))
    want = eng.generate([warm], max_new_tokens=6)[0]
    eng.prefix_cache.evict(100)
    sched = EngineScheduler(eng).start()
    outs, events = {}, {}
    try:
        for rid, prompt, toks in ((0, list(range(200, 230)), 24),
                                  (1, warm, 6)):
            ev = threading.Event()
            events[rid] = ev
            sched.submit(Sequence(request_id=rid, prompt_tokens=prompt,
                                  max_new_tokens=toks),
                         lambda s, t: outs.setdefault(
                             s.request_id, []).append(t),
                         lambda s, ev=ev: ev.set())
        for ev in events.values():
            assert ev.wait(90)
    finally:
        sched.stop(drain=True, timeout=10)
    assert outs[1] == want
    assert eng.prefix_cache.host_pool.restored_total > 0
    eng.check_pool_clean()


def test_host_tier_metrics_exposed():
    from tpu_inference_torch import telemetry
    eng = port_engine(**_cfg())
    for i in range(4):
        eng.generate([list(range(i * 7, i * 7 + 30))], max_new_tokens=4)
    text = telemetry.render_prometheus([({}, eng.telemetry.registry)])
    for name in ("tpu_inf_kv_offload_pages_total",
                 "tpu_inf_kv_restore_pages_total",
                 "tpu_inf_kv_offload_bytes_total",
                 "tpu_inf_kv_restore_bytes_total",
                 "tpu_inf_kv_host_pages_total", "tpu_inf_kv_host_pages_used",
                 "tpu_inf_kv_host_evictions_total",
                 "tpu_inf_kv_swap_seconds_count"):
        assert f"\n{name}" in text, name
    assert "tpu_inf_kv_host_pages_total 64" in text
