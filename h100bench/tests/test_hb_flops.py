"""flops.py against shapes worked by hand."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from h100bench import flops, spec  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def _shape(name):
    return spec.model_shape(spec.read_json(os.path.join(CONFIGS,
                                                        name + ".json")))


def test_mixtral_decode_step_counts_active_parameters_only():
    s = _shape("mixtral-8x7b-bf16-16l")
    d, f, v = 4096, 14336, 32000
    attn = 4096 * 4096 * 2 + 4096 * 1024 * 2        # wq, wo; wk, wv
    ffn = 2 * 3 * d * f                             # top-2 of 8 experts
    router = d * 8
    per_layer = attn + ffn + router
    assert flops.matmul_params(s) == 16 * per_layer
    kv_len = 1000
    expect = (2 * (16 * per_layer + d * v)
              + 4 * 32 * 128 * kv_len * 16)
    assert flops.decode_flops(s, kv_len) == expect
    # About 6.5 B active parameters a token, 13 GFLOP a decode step.
    assert 12.5e9 < flops.decode_flops(s, 1) < 13.5e9


def test_decode_attention_bytes_stop_at_the_window():
    s = _shape("mistral-7b-bf16")
    per_token = 2 * 32 * 2 * 8 * 128                # bf16 K and V, 32 layers
    qo = 2 * 32 * 2 * 32 * 128                      # q and output
    assert flops.decode_attn_bytes(s, 1000) == per_token * 1000 + qo
    assert flops.decode_attn_bytes(s, 4096) == per_token * 4096 + qo
    assert flops.decode_attn_bytes(s, 8000) == per_token * 4096 + qo
    m = _shape("mixtral-8x7b-bf16-16l")             # no window
    assert flops.decode_attn_bytes(m, 8000) == \
        2 * 16 * 2 * 8 * 128 * 8000 + 2 * 16 * 2 * 32 * 128


def test_prefill_pairs_are_causal_and_windowed():
    assert flops.prefill_pairs(0, 4) == 1 + 2 + 3 + 4
    assert flops.prefill_pairs(0, 4, cached=2) == 3 + 4
    assert flops.prefill_pairs(3, 5) == 1 + 2 + 3 + 3 + 3
    # The closed form against the sum it replaces, query by query.
    for window in (0, 1, 2, 3, 7, 64):
        for prompt in range(40):
            for cached in range(prompt + 1):
                assert flops.prefill_pairs(window, prompt, cached) == sum(
                    min(q + 1, window or q + 1)
                    for q in range(cached, prompt))


def test_prefill_logits_only_for_the_last_position():
    s = _shape("mistral-7b-bf16")
    one = flops.prefill_flops(s, 1)
    two = flops.prefill_flops(s, 2)
    layer = 2 * flops.matmul_params(s)
    assert two - one == layer + 4 * 32 * 128 * 2 * 32
