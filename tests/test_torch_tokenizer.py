"""The port's HF tokenizer adapter against the reference's
(tests/test_tokenizer.py's metaspace and chat-template cases): a small
BPE tokenizer trained here and saved into ``tmp_path`` (no network),
loaded by both packages; ids, decoded text, streamed spacing and the
rendered chat template must agree. Then ``build_tokenizer`` and
``build_server(tokenizer="auto")`` pick it up from a directory."""

import json

import pytest

from tpu_inference.server.tokenizer import HFTokenizer as JHFTokenizer
from tpu_inference_torch.server.tokenizer import (HFTokenizer,
                                                  IncrementalDecoder,
                                                  build_tokenizer)

tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("transformers")


def _train(path, corpus) -> str:
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    trainer = trainers.BpeTrainer(vocab_size=400,
                                  special_tokens=["<s>", "</s>"])
    tok.train_from_iterator(corpus * 20, trainer)
    tok.save(str(path / "tokenizer.json"))
    with open(path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>"}, f)
    return str(path)


def test_metaspace_spacing_matches_reference(tmp_path):
    path = _train(tmp_path, ["hello world how is the weather today",
                             "the quick brown fox jumps over the lazy dog"])
    hf, ref = HFTokenizer(path), JHFTokenizer(path)
    assert (hf.vocab_size, hf.bos_token_id, hf.eos_token_id) == (
        ref.vocab_size, ref.bos_token_id, ref.eos_token_id)
    text = "hello world how is the weather"
    ids = hf.encode(text)
    assert ids == ref.encode(text) and ids[0] == hf.bos_token_id
    assert hf.encode(text, add_bos=False) == ref.encode(text, add_bos=False)
    assert hf.decode(ids) == ref.decode(ids) == text
    dec = IncrementalDecoder(hf)
    assert "".join(dec.push(i) for i in ids) + dec.flush() == text
    # Seeded with the prompt's tail, the first piece keeps its space.
    dec = IncrementalDecoder(hf, prompt_tail=hf.encode("hello world",
                                                       add_bos=False))
    cont = hf.encode(" how is", add_bos=False)
    assert "".join(dec.push(i) for i in cont) + dec.flush() == " how is"


def test_chat_template_matches_reference(tmp_path):
    path = _train(tmp_path, ["user assistant hello there"])
    hf, ref = HFTokenizer(path), JHFTokenizer(path)
    msgs = [{"role": "user", "content": "hello"}]
    assert hf.apply_chat_template(msgs) is None is ref.apply_chat_template(
        msgs)
    template = ("{{ bos_token }}{% for m in messages %}[{{ m.role }}] "
                "{{ m.content }}\n{% endfor %}assistant:")
    hf._tok.chat_template = ref._tok.chat_template = template
    out = hf.apply_chat_template(msgs)
    assert out == ref.apply_chat_template(msgs) == "[user] hello\nassistant:"
    ids = hf.encode(out)
    assert ids == ref.encode(out)
    assert ids[0] == hf.bos_token_id and ids[1] != hf.bos_token_id
    # A template that fails to render falls back (None), as the
    # reference's does.
    hf._tok.chat_template = "{{ raise_exception('no') }}"
    assert hf.apply_chat_template(msgs) is None


def test_build_tokenizer_and_server_take_a_directory(tmp_path):
    """build_tokenizer reads a local directory; build_server with
    tokenizer="auto" and a checkpoint directory holding tokenizer files
    serves that tokenizer (and bytes when the directory has none)."""
    import numpy as np
    from safetensors.numpy import save_file

    from tests.test_torch_weights import _random_llama_sd
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.server.http import build_server

    path = _train(tmp_path, ["hello world how is the weather today"])
    tok = build_tokenizer(path, vocab_size=512)
    assert isinstance(tok, HFTokenizer) and tok.vocab_size <= 400
    m = tcfg.tiny_llama(vocab_size=512)
    save_file(_random_llama_sd(m, np.random.default_rng(0)),
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": 512, "hidden_size": m.d_model,
        "num_hidden_layers": m.n_layers, "num_attention_heads": m.n_heads,
        "num_key_value_heads": m.n_kv_heads, "intermediate_size": m.d_ff,
        "torch_dtype": "float32"}))
    server = build_server("auto", tokenizer="auto", checkpoint=path,
                          device="cpu", warmup=False, num_pages=32,
                          max_pages_per_seq=8, prefill_buckets=(16,))
    try:
        assert isinstance(server.tokenizer, HFTokenizer)
        assert server.cfg.checkpoint_path == path
        assert server.tags()["models"][0]["details"]["family"] == "llama"
    finally:
        server.shutdown()
