"""The port's native checkpoint tier (models/weights.py ``save_native`` /
``load_native``) against the reference's Orbax pair, on the CPU.

Twins of tests/test_weights.py:344 and tests/test_model_parity.py:276,
:294, then the reference beside the port:

- bit-exact round trips, node types and dtypes kept, for the three
  families in float32 and bfloat16 and as int8 and grouped int4 trees,
  restored into the saved tree and into a meta template;
- the reference's Orbax save -> restore of a tiny int8 llama, carried
  into the port by ``params_from_numpy``, equals the port's save ->
  restore of the same carried tree, and the port engine on the restore
  gives the reference engine's greedy tokens;
- a restore straight into a tp 2 / tp 4 layout equals ``shard_params``
  of the plain restore (codes and scales included), on one device as
  views of one copy and through the per-shard path as copies; a saved
  ShardedParams restores at any tp; a tp 2 engine on a restore gives the
  reference's GSPMD tp 2 tokens (tests/test_torch_parallel.py's
  oracle);
- a template that differs from the checkpoint raises ValueError naming
  the leaf.
"""

import dataclasses
import os

import pytest
import torch

import jax

from tests.test_torch_ladder import pair
from tests.test_torch_parallel import (PROMPTS, _jengine, _mesh, _pair,
                                       _same_sharded, _tengine)
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import quant as jq
from tpu_inference.models import weights as jw
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models import weights as tw
from tpu_inference_torch.models.quant import QuantizedArray, quantize_params
from tpu_inference_torch.models.registry import build_model
from tpu_inference_torch.models.weights import (load_native,
                                                params_from_numpy,
                                                save_native)
from tpu_inference_torch.parallel import shard_params

ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=2, prefill_buckets=(16,))
FAMILIES = {"llama": tcfg.tiny_llama, "mixtral": tcfg.tiny_mixtral,
            "gpt2": tcfg.tiny_gpt2}


def _meta(tree):
    """The abstract twin of a params tree (jax.ShapeDtypeStruct's)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, QuantizedArray):
        return QuantizedArray(_meta(tree.q), _meta(tree.scale))
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_tree(g, w)
            continue
        assert type(g) is type(w), k
        pairs = ((g.q, w.q), (g.scale, w.scale)) \
            if isinstance(w, QuantizedArray) else ((g, w),)
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.device.type == "cpu" and torch.equal(a, b), k


def _tree(family: str, kind: str) -> tuple:
    cfg = FAMILIES[family]()
    if kind == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params, _ = build_model(cfg, seed=3, device="cpu")
    if kind in ("int8", "int4"):
        params = quantize_params(params, kind)
    return cfg, params


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("family", ["llama", "mixtral", "gpt2"])
def test_round_trip_is_bit_exact(family, kind, tmp_path):
    """tests/test_model_parity.py:276/:294's twins for every family: the
    restore equals the saved tree leaf for leaf, QuantizedArray nodes and
    dtypes kept, into the tree itself and into a meta template."""
    _, params = _tree(family, kind)
    path = str(tmp_path / "native")
    save_native(params, path)
    assert os.listdir(path) == [tw.NATIVE_FILE]
    _assert_same_tree(load_native(path, params, device="cpu"), params)
    restored = load_native(path, _meta(params), device="cpu")
    _assert_same_tree(restored, params)
    if kind in ("int8", "int4"):
        wq = restored["blocks"]["w_qkv" if family == "gpt2" else "wq"]
        assert isinstance(wq, QuantizedArray) and wq.q.dtype == torch.int8


def test_quantized_restore_serves_without_requantizing(tmp_path):
    """tests/test_weights.py:344's twin: an int8 tree restored from its
    native checkpoint serves the tokens of the tree it was saved from,
    grouped int4 too."""
    for quant in ("int8", "int4"):
        _, _, tm, tparams = pair()
        qp = quantize_params(tparams, quant)
        path = str(tmp_path / quant)
        save_native(qp, path)
        got = load_native(path, _meta(qp), device="cpu")
        runs = [InferenceEngine(tm, tcfg.EngineConfig(**ENGINE, quant=quant),
                                params=p, device="cpu").generate(
                                    PROMPTS, max_new_tokens=8)
                for p in (qp, got)]
        assert runs[0] == runs[1]


def test_reference_orbax_round_trip_carries_into_the_port(tmp_path):
    """The reference's Orbax save -> restore of a tiny int8 llama,
    carried in by params_from_numpy, equals the port's save -> restore
    of the same carried tree; the port engine on it gives the reference
    engine's greedy tokens."""
    jm, params, tm, _ = pair()
    qp = jq.quantize_params(params, "int8")
    jw.save_native(qp, str(tmp_path / "orbax"))
    jrestored = jw.load_native(str(tmp_path / "orbax"), qp)
    from_orbax = params_from_numpy(jax.device_get(jrestored), tm,
                                   device="cpu")
    carried = params_from_numpy(jax.device_get(qp), tm, device="cpu")
    save_native(carried, str(tmp_path / "native"))
    got = load_native(str(tmp_path / "native"), _meta(carried),
                      device="cpu")
    _assert_same_tree(got, from_orbax)
    kw = dict(ENGINE, quant="int8", kv_quant="int8")
    want = JEngine(jm, jcfg.EngineConfig(**kw), params=jrestored,
                   attn_backend="dense").generate(PROMPTS, max_new_tokens=8)
    eng = InferenceEngine(tm, tcfg.EngineConfig(**kw), params=got,
                          device="cpu")
    assert eng.generate(PROMPTS, max_new_tokens=8) == want


@pytest.mark.parametrize("name,quant,tp", [("llama", "none", 2),
                                           ("llama", "none", 4),
                                           ("llama", "int8", 4),
                                           ("llama", "int4", 2),
                                           ("qwen2", "none", 2),
                                           ("mixtral", "int8", 4),
                                           ("gpt2", "none", 4)])
def test_tp_restore_equals_shard_params(name, quant, tp, tmp_path,
                                        monkeypatch):
    """A restore into a tp layout (a template cut by shard_params) equals
    shard_params of the plain restore, codes and scales included and
    global counts alike: on one device the shards are views of one copy
    (shard_params's layout), and the per-shard path of distinct devices
    (slab by slab, cut on the host) gives the same tensors as copies."""
    _, _, tm, tparams = _pair(name, quant)
    path = str(tmp_path / "native")
    save_native(tparams, path)
    mesh = _mesh(tp)
    want = shard_params(load_native(path, _meta(tparams), device="cpu"),
                        tm, mesh)
    template = shard_params(_meta(tparams), tm, mesh)
    got = load_native(path, template)
    _same_sharded(got, want)
    assert got.global_totals() == want.global_totals()
    if name != "gpt2":          # packed q/k/v are concatenated copies
        first, second = (got.shards[j]["blocks"]["wo"] for j in (0, 1))
        if isinstance(first, QuantizedArray):
            first, second = first.q, second.q
        assert (first.untyped_storage().data_ptr()
                == second.untyped_storage().data_ptr())
    monkeypatch.setattr(tw, "_shards_share_a_device", lambda devices: False)
    copies = load_native(path, template)
    _same_sharded(copies, want)
    assert copies.global_totals() == want.global_totals()


@pytest.mark.parametrize("name,quant", [("llama", "int8"), ("gpt2", "none"),
                                        ("mixtral", "none")])
def test_sharded_save_restores_at_any_tp(name, quant, tmp_path):
    """A ShardedParams is saved in the full-head layout: restored at tp 1
    it is the unsharded tree, at another tp shard_params of it."""
    _, _, tm, tparams = _pair(name, quant)
    path = str(tmp_path / "native")
    save_native(shard_params(tparams, tm, _mesh(2)), path)
    _assert_same_tree(load_native(path, _meta(tparams), device="cpu"),
                      tparams)
    mesh = _mesh(4)
    _same_sharded(load_native(path, shard_params(_meta(tparams), tm, mesh)),
                  shard_params(tparams, tm, mesh))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_tp2_engine_on_a_restore_matches_reference_tp2(quant, tmp_path):
    """The tp 2 engine on a restore into the tp 2 layout gives the
    reference's GSPMD tp 2 engine's greedy tokens."""
    jm, params, tm, tparams = _pair("llama", quant)
    want = _jengine(jm, params, 2, quant=quant, kv_quant=quant).generate(
        PROMPTS, max_new_tokens=8)
    path = str(tmp_path / "native")
    save_native(tparams, path)
    got = load_native(path, shard_params(_meta(tparams), tm, _mesh(2)))
    eng = _tengine(tm, got, 2, quant=quant, kv_quant=quant)
    assert eng.generate(PROMPTS, max_new_tokens=8) == want


def _swap(tree, path, leaf):
    out = {k: (_swap(v, path[1:], leaf) if k == path[0] and len(path) > 1
               else v) for k, v in tree.items()}
    if len(path) == 1:
        if leaf is None:
            del out[path[0]]
        else:
            out[path[0]] = leaf
    return out


@pytest.mark.parametrize("change,leaf", [
    ("shape", "blocks/wq"), ("dtype", "embed"), ("kind", "blocks/w_up"),
    ("scale dtype", "blocks/wo"), ("missing", "final_norm"),
    ("extra", "blocks/bq"), ("tp shape", "blocks/wk")])
def test_mismatched_template_names_the_leaf(change, leaf, tmp_path):
    _, _, tm, tparams = _pair("llama", "int8")
    path = str(tmp_path / "native")
    save_native(tparams, path)
    meta = _meta(tparams)
    keys = leaf.split("/")
    node = meta
    for k in keys[:-1]:
        node = node[k]
    old = node.get(keys[-1])
    if change == "shape":
        new = QuantizedArray(torch.empty(2, 128, 64, dtype=torch.int8,
                                         device="meta"), old.scale)
    elif change == "dtype":
        new = torch.empty(old.shape, dtype=torch.bfloat16, device="meta")
    elif change == "kind":
        new = torch.empty(old.q.shape, dtype=torch.float32, device="meta")
    elif change == "scale dtype":
        new = QuantizedArray(old.q, torch.empty(old.scale.shape,
                                                dtype=torch.bfloat16,
                                                device="meta"))
    elif change == "extra":
        new = torch.empty(2, 128, device="meta")
    else:
        new = None if change == "missing" else old
    template = _swap(meta, keys, new)
    if change == "tp shape":
        # A template cut for tp 2 restored onto a tp 4 mesh.
        template = shard_params(template, tm, _mesh(2))
        with pytest.raises(ValueError, match="shards, mesh tp 4"):
            load_native(path, template, mesh=_mesh(4))
        bad = template.shards[1]["blocks"]
        bad["wk"] = QuantizedArray(
            torch.empty(2, 128, 64, dtype=torch.int8, device="meta"),
            bad["wk"].scale)
        with pytest.raises(ValueError, match="'blocks/wk.q'"):
            load_native(path, template)
        return
    with pytest.raises(ValueError, match=leaf):
        load_native(path, template, device="cpu")


def test_not_a_native_checkpoint_and_plain_template_on_a_mesh(tmp_path):
    from safetensors.torch import save_file

    _, _, tm, tparams = _pair("llama")
    os.makedirs(tmp_path / "hf")
    save_file({"x": torch.zeros(2)}, str(tmp_path / "hf" / tw.NATIVE_FILE))
    with pytest.raises(ValueError, match="not a native checkpoint"):
        load_native(str(tmp_path / "hf"), tparams, device="cpu")
    save_native(tparams, str(tmp_path / "native"))
    with pytest.raises(ValueError, match="sharded template"):
        load_native(str(tmp_path / "native"), tparams, device="cpu",
                    mesh=_mesh(2))
