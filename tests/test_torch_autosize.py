"""The port's sizing arithmetic (engine/autosize.py) against the
reference's twin: every function gives the same answer on the same
inputs, across presets, quant modes, KV pool kinds, card sizes and
ladders, errors included. Memory sizes are passed in, as the tests of
both packages do off the card."""

import argparse

import pytest

from tpu_inference import config as jcfg
from tpu_inference.engine import autosize as jauto
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import autosize as tauto

PRESETS = sorted(set(jcfg.PRESETS) & set(tcfg.PRESETS))
QUANTS = ("none", "int8", "int4")


def test_presets_shared():
    assert PRESETS == sorted(tcfg.PRESETS)


@pytest.mark.parametrize("preset", PRESETS)
def test_param_and_byte_counts_match(preset):
    jm, tm = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    assert tauto.estimate_param_count(tm) == jauto.estimate_param_count(jm)
    for q in QUANTS:
        assert tauto.weight_bytes(tm, q) == jauto.weight_bytes(jm, q)
        assert (tauto.kv_bytes_per_token(tm, q)
                == jauto.kv_bytes_per_token(jm, q))


def _sizing(mod, cfg, **kw):
    try:
        return mod.auto_size(cfg, **kw)
    except ValueError as e:
        return ("ValueError", str(e).split(":")[0])


@pytest.mark.parametrize("preset", ["llama-3-8b", "mistral-7b",
                                    "mixtral-8x7b", "tiny-llama",
                                    "gemma-7b", "phi-3-mini"])
@pytest.mark.parametrize("hbm", [16e9, 80e9, 85_899_345_920])
def test_auto_size_matches(preset, hbm):
    if preset not in PRESETS:
        pytest.skip(f"{preset} is not a shared preset")
    jm, tm = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
    for quant in QUANTS:
        for kv in QUANTS:
            for kw in ({}, {"max_pages_per_seq": 128, "batch_cap": 32},
                       {"target_ctx": 512, "batch_cap": 64, "tp": 2},
                       {"speculative": True, "max_pages_per_seq": 256}):
                got = _sizing(tauto, tm, hbm_bytes=hbm, quant=quant,
                              kv_quant=kv, **kw)
                want = _sizing(jauto, jm, hbm_bytes=hbm, quant=quant,
                               kv_quant=kv, **kw)
                if isinstance(want, tuple):
                    assert got == want
                else:
                    assert got == tauto.AutoSizing(**want.__dict__)


def test_reference_chip_config_sizing_on_80gb():
    """llama-3-8b, int8 weights + int8 KV, 128 pages per sequence, batch
    cap 32 on an 80 GB card: the ladder tops out at 32 over a pool of
    4 x 32 x 128 pages (the cap)."""
    sz = tauto.auto_size(tcfg.PRESETS["llama-3-8b"](), hbm_bytes=80e9,
                         quant="int8", kv_quant="int8",
                         max_pages_per_seq=128, batch_cap=32)
    assert sz.max_batch_size == 32 and sz.num_pages == 16384
    assert tauto.decode_ladder_rungs(sz.max_batch_size) == (8, 16, 32)


@pytest.mark.parametrize("avail", [0, 1 << 30, 3 << 30, 64 << 30, 96 << 30])
@pytest.mark.parametrize("kv", QUANTS)
def test_auto_host_cache_pages_matches(avail, kv):
    for preset in ("llama-3-8b", "tiny-llama"):
        jm, tm = jcfg.PRESETS[preset](), tcfg.PRESETS[preset]()
        for pg in (8, 16):
            assert (tauto.auto_host_cache_pages(tm, kv_quant=kv, page_size=pg,
                                                host_ram_bytes=avail)
                    == jauto.auto_host_cache_pages(jm, kv_quant=kv,
                                                   page_size=pg,
                                                   host_ram_bytes=avail))


def test_detect_host_ram_matches():
    # Both read /proc/meminfo MemAvailable; the two reads may straddle an
    # allocation elsewhere on the machine, so they agree within 1 GiB.
    assert abs(tauto.detect_host_ram_bytes()
               - jauto.detect_host_ram_bytes()) < (1 << 30)


@pytest.mark.parametrize("top", [1, 4, 8, 9, 16, 24, 32, 33, 64, 100])
def test_ladder_rungs_match(top):
    assert tauto.decode_ladder_rungs(top) == jauto.decode_ladder_rungs(top)
    for spec in ("auto", "off"):
        assert (tauto.parse_decode_ladder(spec, top)
                == jauto.parse_decode_ladder(spec, top))


@pytest.mark.parametrize("spec,top", [
    ("8,16,32", 32), ("4,8,16", 16), ("2,4", 4), ("32", 32),
    ("16,8,32", 32), ("8,8,32", 32), ("8,16", 32), ("0,32", 32),
    ("a,b", 32), ("8;16;32", 32), ("", 32),
])
def test_parse_decode_ladder_matches(spec, top):
    def run(mod):
        try:
            return mod.parse_decode_ladder(spec, top)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tauto) == run(jauto)


@pytest.mark.parametrize("rungs,top", [((4, 8, 16), 16), ((16,), 16),
                                       ((16, 8), 16), ((), 8), ((4, 8), 16),
                                       ((0, 8), 8)])
def test_validate_ladder_matches(rungs, top):
    def run(mod):
        try:
            return mod.validate_ladder(rungs, top)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tauto) == run(jauto)


def test_decode_ladder_rungs_rejects_nonpositive():
    for mod in (tauto, jauto):
        with pytest.raises(ValueError, match="positive"):
            mod.decode_ladder_rungs(0)


@pytest.mark.parametrize("v", ["auto", "8", "-3", "x", "8.5"])
def test_int_or_auto_matches(v):
    def run(mod):
        try:
            return mod.int_or_auto(v)
        except argparse.ArgumentTypeError as e:
            return ("ArgumentTypeError", str(e))
    assert run(tauto) == run(jauto)


def test_resolve_sizing_args_noop_on_ints():
    args = argparse.Namespace(max_batch_size=12, num_pages=300,
                              model="llama-3-8b", quant="int8",
                              kv_quant="int8", page_size=16,
                              max_pages_per_seq=128, device="cpu")
    assert tauto.resolve_sizing_args(args) == (12, 300)


def test_resolve_sizing_args_auto_reads_the_card(monkeypatch):
    """'auto' sizes from the card's total memory (here a stand-in of
    80 GB) with the reference's arithmetic."""
    monkeypatch.setattr(tauto, "detect_hbm_bytes", lambda device=None: 80e9)
    args = argparse.Namespace(max_batch_size="auto", num_pages="auto",
                              model="llama-3-8b", quant="int8",
                              kv_quant="int8", page_size=16,
                              max_pages_per_seq=128, device="cuda",
                              batch_cap=32, target_ctx=0)
    want = jauto.auto_size(jcfg.PRESETS["llama-3-8b"](), hbm_bytes=80e9,
                           quant="int8", kv_quant="int8",
                           max_pages_per_seq=128, batch_cap=32)
    assert tauto.resolve_sizing_args(args) == (want.max_batch_size,
                                               want.num_pages)


def test_detect_hbm_bytes_needs_the_card():
    import torch
    if torch.cuda.is_available():
        assert tauto.detect_hbm_bytes() > 0
        return
    with pytest.raises(RuntimeError, match="is_available"):
        tauto.detect_hbm_bytes()
