"""The port's CLI beside the reference's, and ``--debug-nans``, on the CPU.

- every flag of the reference's parser (tpu_inference/server/__main__.py,
  read as text) is accepted by the port's ``build_parser``, but for the
  named JAX-only differences;
- ``--failover-retries``, ``--routing``, ``--route-hit-weight`` and
  ``--route-host-hit-weight`` reach ServerConfig with the reference's
  defaults; a dp 2 group booted through the CLI at ``--route-hit-weight
  8`` routes as tests/test_torch_failover.py:300 expects at 8.0 (and
  at the default 1.0 the other way); ``python -m tpu_inference_torch.
  server ... --routing least_loaded --dp 2`` boots and ``/healthz`` says
  ``least_loaded``;
- ``--debug-nans`` (engine/numerics.py) with a NaN planted in layer 1
  of a tiny llama: the reference engine under ``jax.debug_nans(True)``
  and the port engine with the switch on both raise FloatingPointError
  on the first prefill, the port's naming layer 1 (at tp 2 too); later
  steps name their kind; through a dp 2 group the request fails with
  reason "error"; with clean weights the tokens with the switch on equal
  those with it off, in every serving mode.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_ladder import pair
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine import numerics
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.server import replicas as trep
from tpu_inference_torch.server.__main__ import (boot_server, build_parser,
                                                 server_overrides)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Reference flags with no twin: JAX device selection (the port has
# --device).
NO_TWIN = {"--platform", "--cpu-devices"}
ROUTING = {"failover_max_retries": ("--failover-retries", "2"),
           "routing": ("--routing", "least_loaded"),
           "route_hit_weight": ("--route-hit-weight", "8"),
           "route_host_hit_weight": ("--route-host-hit-weight", "0.25")}
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
              max_batch_size=2, prefill_buckets=(16,))
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9]]


def _reference_flags() -> set:
    with open(os.path.join(REPO, "tpu_inference", "server",
                           "__main__.py")) as f:
        return set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                              f.read()))


def test_every_reference_flag_is_accepted():
    ref = _reference_flags()
    assert len(ref) > 90 and "--routing" in ref
    port = {o for a in build_parser()._actions for o in a.option_strings}
    assert sorted(ref - port - NO_TWIN) == []
    assert NO_TWIN <= ref


def test_routing_and_failover_flags_reach_server_config():
    parser = build_parser()
    defaults = server_overrides(parser.parse_args([]))
    ref, port = jcfg.ServerConfig(), tcfg.ServerConfig()
    for field in ROUTING:
        assert defaults[field] == getattr(ref, field) \
            == getattr(port, field), field
    argv = [x for flag, value in ROUTING.values() for x in (flag, value)]
    got = server_overrides(parser.parse_args(argv))
    assert {f: got[f] for f in ROUTING} == {
        "failover_max_retries": 2, "routing": "least_loaded",
        "route_hit_weight": 8.0, "route_host_hit_weight": 0.25}
    with pytest.raises(SystemExit):
        parser.parse_args(["--routing", "round_robin"])


def _submit_and_wait(group, rid, prompt, max_new, timeout=60.0):
    tokens, done, box = [], threading.Event(), {}
    seq = Sequence(request_id=rid, prompt_tokens=list(prompt),
                   max_new_tokens=max_new)
    group.submit(seq, lambda s, t: tokens.append(t),
                 lambda s: (box.setdefault("seq", s), done.set()))
    assert done.wait(timeout), "request did not finish"
    return tokens, box["seq"]


def _boot(extra):
    parser = build_parser()
    args = parser.parse_args([
        "--device", "cpu", "--model", "tiny-llama", "--dp", "2",
        "--page-size", "8", "--num-pages", "64", "--max-pages-per-seq",
        "16", "--max-batch-size", "2", "--prefill-buckets", "16",
        "--host-cache-pages", "0", "--no-warmup", "--port", "0", *extra])
    return boot_server(args, parser)[0]


@pytest.mark.parametrize("hit_weight,expect_warm", [("1", False),
                                                    ("8", True)])
def test_cli_route_hit_weight_reaches_the_group(hit_weight, expect_warm):
    """tests/test_torch_failover.py:300's scenario through a dp 2 group
    the CLI booted: a warm replica under pool pressure loses to a cold
    idle one at the default weight and wins at --route-hit-weight 8."""
    server = _boot(["--route-hit-weight", hit_weight])
    group = server.group.start()
    try:
        assert group.server_cfg.route_hit_weight == float(hit_weight)
        t1 = list(range(50, 64))
        rep1, s1 = _submit_and_wait(group, 600, t1, 6)
        warm = s1.routed_replica
        eng = group.engines[warm]
        eng.request_page_pressure(eng.allocator.num_free
                                  - max(0, 3 - eng.prefix_cache.evictable))
        deadline = time.monotonic() + 5
        while not eng.under_pressure and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.under_pressure
        _, s2 = _submit_and_wait(group, 601, t1 + rep1 + [7, 7], 2)
        assert (s2.routed_replica == warm) is expect_warm
    finally:
        group.stop(drain=False, timeout=5.0)


def test_cli_boots_least_loaded_dp2_and_healthz_says_so():
    """The acceptance command: the four flags at dp 2 through ``python -m
    tpu_inference_torch.server``; /healthz reports the routing."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpu_inference_torch.server", "--device",
         "cpu", "--routing", "least_loaded", "--failover-retries", "2",
         "--route-hit-weight", "8", "--route-host-hit-weight", "0.25",
         "--dp", "2", "--port", "0", "--no-warmup", "--host-cache-pages",
         "0"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("serving "):
                break
        port = int(re.search(r"http://[^:]+:(\d+)", line).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["routing"] == "least_loaded", health
        assert "dp=2" in line
    finally:
        proc.terminate()
        try:
            proc.communicate(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture
def debug_nans():
    previous = numerics.set_debug_nans(True)
    try:
        yield
    finally:
        numerics.set_debug_nans(previous)


def _poison_layer1(tree):
    """One row of layer 1's wo set to NaN (a copy)."""
    blocks = dict(tree["blocks"])
    wo = blocks["wo"].clone()
    wo[1, 3] = float("nan")
    blocks["wo"] = wo
    return {**tree, "blocks": blocks}


def test_reference_and_port_raise_on_the_first_prefill(debug_nans):
    """The reference under jax.debug_nans(True) (a context manager: no
    global state leaks) and the port with the switch on both raise
    FloatingPointError on the first prefill; the port names layer 1."""
    jm, params, tm, tparams = pair()
    wo = np.array(params["blocks"]["wo"])
    wo[1, 3] = np.nan
    jparams = {**params, "blocks": {**params["blocks"],
                                    "wo": jax.numpy.asarray(wo)}}
    jeng = JEngine(jm, jcfg.EngineConfig(**ENGINE), params=jparams,
                   attn_backend="dense")
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jeng.prefill(JSequence(request_id=0, prompt_tokens=PROMPTS[0],
                                   max_new_tokens=4))
    eng = InferenceEngine(tm, tcfg.EngineConfig(**ENGINE),
                          params=_poison_layer1(tparams),
                          attn_backend="kernel", device="cpu")
    with pytest.raises(FloatingPointError,
                       match=r"tiny-llama: NaN in the output of layer 1 "
                             r"in a prefill step"):
        eng.prefill(Sequence(request_id=0, prompt_tokens=PROMPTS[0],
                             max_new_tokens=4))


from tpu_inference.engine.engine import Sequence as JSequence  # noqa: E402


def test_tp2_forward_raises_naming_layer_1(debug_nans):
    from tpu_inference_torch.parallel import build_mesh
    _, _, tm, tparams = pair()
    eng = InferenceEngine(tm, tcfg.EngineConfig(**ENGINE),
                          params=_poison_layer1(tparams), device="cpu",
                          mesh=build_mesh(tcfg.ParallelConfig(tp=2),
                                          platform="cpu"))
    with pytest.raises(FloatingPointError, match="layer 1 in a prefill"):
        eng.generate(PROMPTS, max_new_tokens=4)


def _warm_chunk(eng) -> dict:
    """One idle prefill lane of the first bucket (warmup's operands)."""
    bucket = eng.engine_cfg.prefill_buckets[0]
    return {"tokens": np.zeros((1, bucket), np.int32),
            "prompt_len": np.ones((1,), np.int32),
            "prefix_len": np.zeros((1,), np.int32),
            "bts": np.zeros((1, eng.max_pages), np.int32),
            **eng._lane_arrays([], 1)}


@pytest.mark.parametrize("kind", ["decode", "verify", "hybrid"])
def test_a_nan_after_prefill_names_the_step_kind(kind, debug_nans):
    """Weights poisoned after a clean prefill: the next step raises
    naming its kind (a fused decode step; an n-gram verify round and a
    hybrid step on warmup's operands)."""
    _, _, tm, tparams = pair()
    mode = ({"spec_mode": "ngram", "num_speculative_tokens": 3}
            if kind == "verify" else {})
    eng = InferenceEngine(tm, tcfg.EngineConfig(**ENGINE, **mode),
                          params=tparams, attn_backend="kernel",
                          device="cpu")
    eng.prefill(Sequence(request_id=0, prompt_tokens=PROMPTS[0],
                         max_new_tokens=8))
    eng.params = _poison_layer1(eng.params)
    with pytest.raises(FloatingPointError,
                       match=f"layer 1 in a {kind} step"):
        if kind == "decode":
            eng.decode_steps()
        elif kind == "verify":
            eng._verify_fn(*eng._spec_warm_arrays(eng.ladder[0], 4))
        else:
            eng._hybrid_step_fn(_warm_chunk(eng),
                                eng._decode_warm_arrays(eng.ladder[0]), 1)


def test_group_fails_the_request_through_the_step_error_path(debug_nans):
    """In a dp 2 group a poisoned step fails its request with reason
    "error", as any other step error does, and counts the failure."""
    _, _, tm, tparams = pair()
    bad = _poison_layer1(tparams)
    engines = [InferenceEngine(tm, tcfg.EngineConfig(**ENGINE), params=bad,
                               attn_backend="kernel", device="cpu")
               for _ in range(2)]
    group = trep.EngineGroup(engines, tcfg.ServerConfig()).start()
    try:
        tokens, seq = _submit_and_wait(group, 1, PROMPTS[0], 4)
        assert seq.finish_reason == "error" and tokens == []
        assert sum(s.stats.step_failures for s in group.schedulers) >= 1
    finally:
        group.stop(drain=False, timeout=5.0)


@pytest.mark.parametrize("mode", [
    {}, {"decode_steps_per_call": 4, "decode_pipeline_depth": 2},
    {"hybrid_prefill": True}, {"spec_mode": "ngram",
                               "num_speculative_tokens": 3}])
def test_clean_tokens_are_the_same_with_the_switch_on(mode):
    _, _, tm, tparams = pair()
    prompts = PROMPTS + [[5, 6, 7, 5, 6, 7, 5, 6] * 3]
    runs = []
    for on in (False, True):
        previous = numerics.set_debug_nans(on)
        try:
            eng = InferenceEngine(tm, tcfg.EngineConfig(**ENGINE, **mode),
                                  params=tparams, attn_backend="kernel",
                                  device="cpu")
            group = trep.EngineGroup([eng], tcfg.ServerConfig()).start()
            try:
                runs.append([_submit_and_wait(group, i, p, 12)[0]
                             for i, p in enumerate(prompts)])
            finally:
                group.stop(drain=True, timeout=10.0)
        finally:
            numerics.set_debug_nans(previous)
    assert runs[0] == runs[1] and all(len(t) == 12 for t in runs[0])


def test_flag_sets_the_switch_before_the_engine_is_built():
    previous = numerics.set_debug_nans(False)
    seen = {}
    original = InferenceEngine.__init__

    def spy(self, *a, **kw):
        seen.setdefault("on", numerics.debug_nans())
        original(self, *a, **kw)

    try:
        InferenceEngine.__init__ = spy
        server = _boot(["--debug-nans"])
        server.shutdown()
        assert seen["on"] is True and numerics.debug_nans()
    finally:
        InferenceEngine.__init__ = original
        numerics.set_debug_nans(previous)
    assert not build_parser().parse_args([]).debug_nans
