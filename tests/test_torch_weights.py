"""Checkpoint loading in the port against the reference's loader
(tests/test_weights.py's cases, port beside reference). Every checkpoint
is written here, into ``tmp_path``, from seeded random arrays (or from
HF's own GPT-2 and Mixtral classes, built in-process): the converters,
the streaming loader over index and single-file layouts, Qwen2 biases,
Phi-3's fused tensors, quantize-at-load, and ``config_from_hf`` must
give the reference's trees and configs. Then the CLI: a tiny-llama
checkpoint served through ``--checkpoint --check-numerics``, and a
planted NaN that ``check_numerics`` names."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import weights as jw
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models import weights as tw
from tpu_inference_torch.models.quant import QuantizedArray

from safetensors.numpy import save_file  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_llama_sd(cfg, rng):
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.standard_normal((v, d)),
          "model.norm.weight": rng.standard_normal((d,)),
          "lm_head.weight": rng.standard_normal((v, d))}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": rng.standard_normal((d,)),
            p + "self_attn.q_proj.weight": rng.standard_normal((hq * hd, d)),
            p + "self_attn.k_proj.weight": rng.standard_normal((hkv * hd, d)),
            p + "self_attn.v_proj.weight": rng.standard_normal((hkv * hd, d)),
            p + "self_attn.o_proj.weight": rng.standard_normal((d, hq * hd)),
            p + "post_attention_layernorm.weight": rng.standard_normal((d,)),
            p + "mlp.gate_proj.weight": rng.standard_normal((f, d)),
            p + "mlp.up_proj.weight": rng.standard_normal((f, d)),
            p + "mlp.down_proj.weight": rng.standard_normal((d, f)),
        })
        if cfg.qkv_bias:
            sd.update({
                p + "self_attn.q_proj.bias": rng.standard_normal((hq * hd,)),
                p + "self_attn.k_proj.bias": rng.standard_normal((hkv * hd,)),
                p + "self_attn.v_proj.bias": rng.standard_normal((hkv * hd,)),
            })
    return {k: a.astype(np.float32) for k, a in sd.items()}


def _write_sharded(sd, path, n_shards=3):
    """Split a state dict across n_shards files + an HF index.json."""
    keys = sorted(sd)
    weight_map = {}
    for s in range(n_shards):
        part = {k: sd[k] for k in keys[s::n_shards]}
        fname = f"model-{s:05d}-of-{n_shards:05d}.safetensors"
        save_file(part, os.path.join(path, fname))
        weight_map.update({k: fname for k in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def _fuse_phi3(cfg, sd):
    """Rewrite a split llama state dict into Phi-3's fused layout."""
    fused = {k: v for k, v in sd.items()
             if not any(w in k for w in ("q_proj", "k_proj", "v_proj",
                                         "gate_proj", "up_proj"))}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        fused[p + "self_attn.qkv_proj.weight"] = np.concatenate(
            [sd[p + f"self_attn.{w}_proj.weight"] for w in "qkv"], axis=0)
        fused[p + "mlp.gate_up_proj.weight"] = np.concatenate(
            [sd[p + "mlp.gate_proj.weight"], sd[p + "mlp.up_proj.weight"]],
            axis=0)
    return fused


def _assert_same_tree(got, want):
    """Port tree (tensors, QuantizedArray) == reference tree."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (sorted(got), sorted(want))
        for k in want:
            _assert_same_tree(got[k], want[k])
        return
    if hasattr(want, "q"):
        # Codes exact; the reference's jitted amax / 127 may sit 1 ulp
        # from eager (tests/test_weights.py holds it to rtol 1e-6 too).
        assert isinstance(got, QuantizedArray)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_allclose(got.scale.numpy(),
                                   np.asarray(want.scale), rtol=1e-6)
        return
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def _cfgs(preset, **kw):
    jm = getattr(jcfg, preset)(**kw)
    tm = getattr(tcfg, preset)(**kw)
    return jm, tm


@pytest.mark.parametrize("preset", ["tiny_llama", "tiny_qwen2"])
def test_converter_and_loader_match_reference(preset, tmp_path):
    """Sharded index layout; Qwen2's q/k/v biases stream like weights."""
    jm, tm = _cfgs(preset, vocab_size=128)
    sd = _random_llama_sd(jm, np.random.default_rng(4))
    _write_sharded(sd, str(tmp_path))
    want = jw.convert_state_dict(jm, sd)
    _assert_same_tree(tw.convert_state_dict(tm, sd, device="cpu"), want)
    got = tw.load_checkpoint(tm, str(tmp_path), device="cpu")
    assert ("bq" in got["blocks"]) == jm.qkv_bias
    _assert_same_tree(got, jw.load_checkpoint(jm, str(tmp_path)))
    _assert_same_tree(got, want)


def test_converter_takes_torch_tensors_in_bf16():
    jm, tm = _cfgs("tiny_llama", vocab_size=64)
    jm, tm = (dataclasses.replace(jm, dtype=jax.numpy.bfloat16),
              dataclasses.replace(tm, dtype=torch.bfloat16))
    sd = _random_llama_sd(jm, np.random.default_rng(8))
    got = tw.convert_state_dict(
        tm, {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()},
        device="cpu")
    want = jw.convert_state_dict(jm, sd)
    assert got["blocks"]["wq"].dtype == torch.bfloat16
    _assert_same_tree(got, want)


def test_phi3_fused_split_matches_reference(tmp_path):
    jm, tm = _cfgs("tiny_phi3", vocab_size=128)
    assert jm.n_heads != jm.n_kv_heads        # unequal q/k/v row spans
    sd_split = _random_llama_sd(jm, np.random.default_rng(7))
    sd = _fuse_phi3(jm, sd_split)
    _write_sharded(sd, str(tmp_path))
    want = jw.convert_state_dict(jm, sd_split)
    _assert_same_tree(tw.convert_state_dict(tm, sd, device="cpu"), want)
    _assert_same_tree(tw.load_checkpoint(tm, str(tmp_path), device="cpu"),
                      want)


def test_single_file_layout(tmp_path):
    jm, tm = _cfgs("tiny_llama", vocab_size=128)
    sd = _random_llama_sd(jm, np.random.default_rng(2))
    save_file(sd, os.path.join(str(tmp_path), "model.safetensors"))
    _assert_same_tree(tw.load_checkpoint(tm, str(tmp_path), device="cpu"),
                      jw.load_checkpoint(jm, str(tmp_path)))


def _hf_gpt2_and_mixtral(tmp_path):
    """(config pairs, directories) of a GPT-2 and a Mixtral checkpoint
    written from HF's own classes (random init, seed 0)."""
    transformers = pytest.importorskip("transformers")
    g = _cfgs("tiny_gpt2", vocab_size=96)
    hf_g = transformers.GPT2Config(
        vocab_size=96, n_positions=g[0].max_seq_len, n_embd=g[0].d_model,
        n_layer=g[0].n_layers, n_head=g[0].n_heads, n_inner=g[0].d_ff)
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in
          transformers.GPT2LMHeadModel(hf_g).state_dict().items()
          if not k.endswith((".attn.masked_bias", ".attn.bias"))
          and k != "lm_head.weight"}
    gdir = tmp_path / "gpt2"
    gdir.mkdir()
    _write_sharded(sd, str(gdir), n_shards=2)
    m = _cfgs("tiny_mixtral", vocab_size=96)
    hf_m = transformers.MixtralConfig(
        vocab_size=96, hidden_size=m[0].d_model,
        intermediate_size=m[0].d_ff, num_hidden_layers=m[0].n_layers,
        num_attention_heads=m[0].n_heads,
        num_key_value_heads=m[0].n_kv_heads,
        num_local_experts=m[0].n_experts,
        num_experts_per_tok=m[0].n_experts_per_tok,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    msd = {k: v.numpy() for k, v in
           transformers.MixtralForCausalLM(hf_m).state_dict().items()}
    mdir = tmp_path / "mixtral"
    mdir.mkdir()
    _write_sharded(msd, str(mdir), n_shards=2)
    return ((g, sd, str(gdir)), (m, msd, str(mdir)))


def test_gpt2_and_mixtral_match_reference(tmp_path):
    """Conv1D weights (no transpose) and the nested expert stacks."""
    for (jm, tm), sd, path in _hf_gpt2_and_mixtral(tmp_path):
        want = jw.convert_state_dict(jm, sd)
        _assert_same_tree(tw.convert_state_dict(tm, sd, device="cpu"), want)
        _assert_same_tree(tw.load_checkpoint(tm, path, device="cpu"),
                          jw.load_checkpoint(jm, path))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantize_at_load_matches_reference(quant, tmp_path):
    """Codes and scales of every matmul leaf equal the reference's
    quantize-at-load (experts included); embeddings and norms stay
    float."""
    for (jm, tm), _, path in _hf_gpt2_and_mixtral(tmp_path):
        got = tw.load_checkpoint(tm, path, quant=quant, device="cpu")
        assert isinstance(got["blocks"]["w_up" if tm.family == "mixtral"
                                        else "w_fc"], QuantizedArray)
        assert not isinstance(got["embed"], QuantizedArray)
        _assert_same_tree(got, jw.load_checkpoint(jm, path, quant=quant))


def test_checkpoint_serves_the_reference_tokens(tmp_path):
    """The loaded trees generate the reference engine's greedy tokens."""
    ecfg = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                max_batch_size=4, prefill_buckets=(16, 32))
    prompts = [[5, 9, 2, 7, 1], list(range(3, 40))]
    for (jm, tm), _, path in _hf_gpt2_and_mixtral(tmp_path):
        want = JEngine(jm, jcfg.EngineConfig(**ecfg),
                       params=jw.load_checkpoint(jm, path),
                       attn_backend="dense").generate(prompts, 8)
        got = InferenceEngine(tm, tcfg.EngineConfig(**ecfg),
                              params=tw.load_checkpoint(tm, path,
                                                        device="cpu"),
                              device="cpu").generate(prompts, 8)
        assert got == want, tm.family


def _write_config(tmp_path, cfg: dict) -> str:
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    return str(tmp_path)


def _same_config(path: str):
    """config_from_hf of both packages agree field by field; returns the
    port's."""
    want = dataclasses.asdict(jw.config_from_hf(path))
    got = tcfg.model_config_to_dict(tw.config_from_hf(path))
    assert jcfg.jnp.dtype(want.pop("dtype")).name == got.pop("dtype")
    assert got == want
    return tw.config_from_hf(path)


QWEN2 = {"model_type": "qwen2", "vocab_size": 1024, "hidden_size": 128,
         "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 256,
         "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
         "sliding_window": 4096, "use_sliding_window": False,
         "tie_word_embeddings": True}


@pytest.mark.parametrize("over,window", [
    ({}, 0),
    ({"use_sliding_window": True}, 0),            # absent mwl = 28 >= 2
    ({"use_sliding_window": True, "max_window_layers": 0}, 4096),
    ({"use_sliding_window": True, "max_window_layers": 2}, 0),
    ({"use_sliding_window": True, "max_window_layers": 1,
      "sliding_window": None}, 0),
])
def test_config_from_hf_qwen2(tmp_path, over, window):
    cfg = _same_config(_write_config(tmp_path, {**QWEN2, **over}))
    assert cfg.family == "llama" and cfg.qkv_bias
    assert cfg.sliding_window == window and cfg.tie_embeddings


def test_config_from_hf_rejects_what_the_reference_rejects(tmp_path):
    cases = [
        ({**QWEN2, "use_sliding_window": True, "max_window_layers": 1},
         "max_window_layers"),
        ({"model_type": "phi3", "vocab_size": 64, "hidden_size": 64,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "intermediate_size": 128,
          "rope_scaling": {"type": "longrope", "short_factor": [1.0],
                           "long_factor": [1.0]}}, "LongRoPE"),
        ({"model_type": "llama", "vocab_size": 64, "hidden_size": 64,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "intermediate_size": 128,
          "rope_scaling": {"rope_type": "yarn", "factor": 4.0}}, "yarn"),
        ({"model_type": "bert"}, "unsupported model_type"),
    ]
    for hf, match in cases:
        path = _write_config(tmp_path, hf)
        with pytest.raises(ValueError, match=match):
            jw.config_from_hf(path)
        with pytest.raises(ValueError, match=match):
            tw.config_from_hf(path)


def test_config_from_hf_gemma_phi3_mixtral_gpt2(tmp_path):
    gemma = {"model_type": "gemma", "vocab_size": 2048, "hidden_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 1, "intermediate_size": 512,
             "head_dim": 48, "rms_norm_eps": 1e-6,
             "hidden_act": "gelu_pytorch_tanh"}
    cfg = _same_config(_write_config(tmp_path, gemma))
    assert cfg.norm_offset == 1.0 and cfg.hidden_act == "gelu_tanh"
    assert cfg.embed_scale and cfg.head_dim == 48 and cfg.tie_embeddings
    phi = {"model_type": "phi3", "vocab_size": 32064, "hidden_size": 3072,
           "num_hidden_layers": 32, "num_attention_heads": 32,
           "num_key_value_heads": 32, "intermediate_size": 8192,
           "rope_theta": 10000.0, "sliding_window": 2047,
           "max_position_embeddings": 4096, "rope_scaling": None,
           "tie_word_embeddings": False, "torch_dtype": "float32"}
    cfg = _same_config(_write_config(tmp_path, phi))
    assert cfg.sliding_window == 2047 and cfg.dtype == torch.float32
    mixtral = {"model_type": "mixtral", "vocab_size": 32000,
               "hidden_size": 4096, "num_hidden_layers": 32,
               "num_attention_heads": 32, "num_key_value_heads": 8,
               "intermediate_size": 14336, "rope_theta": 1e6,
               "num_local_experts": 8, "num_experts_per_tok": 2,
               "max_position_embeddings": 32768, "torch_dtype": "float16"}
    cfg = _same_config(_write_config(tmp_path, mixtral))
    assert cfg.family == "mixtral" and cfg.n_experts == 8
    assert cfg.dtype == torch.bfloat16
    gpt2 = {"model_type": "gpt2", "vocab_size": 50257, "n_embd": 768,
            "n_layer": 12, "n_head": 12, "n_positions": 1024,
            "layer_norm_epsilon": 1e-5}
    cfg = _same_config(_write_config(tmp_path, gpt2))
    assert (cfg.family, cfg.d_ff, cfg.max_seq_len) == ("gpt2", 3072, 1024)
    assert cfg == dataclasses.replace(tcfg.gpt2_small(), name=cfg.name)


@pytest.mark.parametrize("rs,want", [
    (None, None),
    ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
     tcfg.RopeScaling(8.0, 1.0, 4.0, 8192)),
    ({"type": "llama3", "factor": 4.0, "low_freq_factor": 1.0,
      "high_freq_factor": 2.0, "original_max_position_embeddings": 4096},
     tcfg.RopeScaling(4.0, 1.0, 2.0, 4096)),
])
def test_config_from_hf_rope_scaling(tmp_path, rs, want):
    base = {"model_type": "llama", "vocab_size": 1024, "hidden_size": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "intermediate_size": 256,
            "rope_theta": 500000.0, "rope_scaling": rs}
    assert _same_config(_write_config(tmp_path, base)).rope_scaling == want


# -------------------------------------------------------------- the CLI


def _tiny_llama_checkpoint(path, nan_leaf=None) -> str:
    """tiny-llama's dims as an HF directory (config.json + one
    safetensors file, float32, seed 0)."""
    m = tcfg.tiny_llama(vocab_size=512)
    sd = _random_llama_sd(m, np.random.default_rng(0))
    sd = {k: (0.05 * v).astype(np.float32) for k, v in sd.items()}
    if nan_leaf is not None:
        sd[nan_leaf][0, 0] = np.nan
    os.makedirs(path, exist_ok=True)
    save_file(sd, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "vocab_size": m.vocab_size,
                   "hidden_size": m.d_model,
                   "num_hidden_layers": m.n_layers,
                   "num_attention_heads": m.n_heads,
                   "num_key_value_heads": m.n_kv_heads,
                   "intermediate_size": m.d_ff, "rope_theta": m.rope_theta,
                   "max_position_embeddings": m.max_seq_len,
                   "torch_dtype": "float32"}, f)
    return path


def _cli(args, timeout=240):
    """``python -m tpu_inference_torch.server --device cpu`` with args,
    until it prints its "serving" line (then SIGTERM) or exits."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_inference_torch.server", "--device",
         "cpu", "--port", "0", "--no-warmup", "--host-cache-pages", "0",
         "--num-pages", "64", "--max-pages-per-seq", "8",
         "--prefill-buckets", "16,32", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                proc.terminate()
                break
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, "".join(lines) + out, err


def test_cli_serves_a_checkpoint_after_the_numerics_check(tmp_path):
    path = _tiny_llama_checkpoint(str(tmp_path / "ckpt"))
    rc, out, err = _cli(["--model", "auto", "--checkpoint", path,
                         "--check-numerics"])
    assert "numerics check passed" in out, (out, err)
    assert f"serving auto on http" in out, (out, err)
    assert rc in (0, -15), err


def test_check_numerics_names_a_planted_nan(tmp_path):
    key = "model.layers.1.mlp.down_proj.weight"
    path = _tiny_llama_checkpoint(str(tmp_path / "nan"), nan_leaf=key)
    rc, out, err = _cli(["--model", "auto", "--checkpoint", path,
                         "--check-numerics"])
    assert rc != 0 and "serving" not in out
    assert "FloatingPointError" in err
    assert "['blocks']['w_down']" in err
    # The forward check names the first layer gone non-finite when the
    # parameters themselves pass (an overflow, not a bad leaf).
    from tpu_inference_torch.server.http import build_server
    server = build_server("auto", checkpoint=_tiny_llama_checkpoint(
        str(tmp_path / "big")), device="cpu", warmup=False, num_pages=64,
        max_pages_per_seq=8, prefill_buckets=(16,))
    try:
        # Finite weights whose gate x up product overflows float32.
        for name in ("w_gate", "w_up"):
            server.engine.params["blocks"][name][1] *= 1e25
        with pytest.raises(FloatingPointError, match="at layer 1 "):
            server.engine.check_numerics()
    finally:
        server.shutdown()
