"""The port's Ollama server, booted on the CPU on an ephemeral port: the
NDJSON wire contract of /api/generate (streamed and unary), the aux
routes, and greedy ``context`` equal to the JAX InferenceServer's on the
same weights. Every blocking call has its own timeout and the server is
shut down in a finalizer."""

import asyncio
import http.client
import json

import pytest

import jax
from aiohttp.test_utils import TestClient, TestServer

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.server.http import InferenceServer as JServer
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.server.http import InferenceServer

TIMEOUT = 60
FINAL_FIELDS = {"model", "created_at", "response", "done", "done_reason",
                "context", "total_duration", "load_duration",
                "prompt_eval_count", "prompt_eval_duration", "eval_count",
                "eval_duration"}
ENGINE = dict(page_size=8, num_pages=128, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32, 64))
PROMPTS = ["Hello GPU", "determinism", "x" * 40]


@pytest.fixture(scope="module")
def weights():
    params, _ = j_build(jcfg.tiny_llama(vocab_size=512), seed=0)
    return params


@pytest.fixture(scope="module")
def port_server(weights):
    mcfg = tcfg.tiny_llama(vocab_size=512)
    cfg = tcfg.FrameworkConfig(
        model=mcfg, engine=tcfg.EngineConfig(**ENGINE),
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte"))
    engine = InferenceEngine(
        mcfg, cfg.engine, device="cpu",
        params=params_from_numpy(jax.device_get(weights), mcfg, "cpu"))
    server = InferenceServer(cfg, engine=engine)
    port = server.start(host="127.0.0.1", port=0)
    yield server, port
    server.shutdown(timeout=TIMEOUT)


def _post(port, body, path="/api/generate"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_streaming_ndjson_contract(port_server):
    _, port = port_server
    status, headers, raw = _post(port, {
        "model": "tiny-llama", "prompt": "Hello GPU", "temperature": 0.0,
        "max_tokens": 8, "stream": True})
    assert status == 200
    assert headers["Content-Type"].startswith("application/x-ndjson")
    assert headers["Transfer-Encoding"] == "chunked"
    lines = [json.loads(x) for x in raw.splitlines()]
    assert len(lines) >= 2
    for line in lines[:-1]:
        assert line["done"] is False
        assert set(line) == {"model", "created_at", "response", "done"}
        assert line["model"] == "tiny-llama"
    final = lines[-1]
    assert final["done"] is True and FINAL_FIELDS <= set(final)
    assert final["eval_count"] == 8 or final["done_reason"] == "stop"
    assert final["prompt_eval_count"] == len("Hello GPU") + 1     # +BOS
    assert final["prompt_eval_duration"] > 0
    assert final["total_duration"] > 0
    assert len(final["context"]) == (final["prompt_eval_count"]
                                     + final["eval_count"])
    assert final["request_id"] == headers["X-Request-Id"]


def test_unary_single_object(port_server):
    _, port = port_server
    status, headers, raw = _post(port, {"prompt": "abc", "stream": False,
                                        "options": {"num_predict": 5}})
    assert status == 200 and headers["Content-Type"] == "application/json"
    body = json.loads(raw)
    assert body["done"] is True and isinstance(body["response"], str)
    assert FINAL_FIELDS <= set(body)
    assert body["eval_count"] == 5 or body["done_reason"] == "stop"


def test_aux_routes_and_bad_requests(port_server):
    _, port = port_server
    status, _, raw = _get(port, "/api/tags")
    assert status == 200
    assert json.loads(raw)["models"][0]["details"]["family"] == "llama"
    status, _, raw = _get(port, "/api/version")
    assert status == 200 and "version" in json.loads(raw)
    status, _, raw = _get(port, "/healthz")
    assert status == 200 and json.loads(raw)["status"] == "ok"
    status, headers, raw = _get(port, "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    text = raw.decode()
    assert "# TYPE tpu_inf_ttft_seconds histogram" in text
    assert 'tpu_inf_kv_pages_total{replica="0"} 127' in text
    status, _, raw = _get(port, "/metrics?format=json")
    assert status == 200 and json.loads(raw)["attn_backend"] == "kernel"
    assert _post(port, {"stream": False})[0] == 400          # no prompt
    assert _post(port, {"prompt": "a", "options": [1]})[0] == 400
    assert _post(port, {"prompt": "a", "context": [1, 99999]})[0] == 400
    status, _, raw = _post(port, {"prompt": ""})             # load probe
    assert status == 200 and json.loads(raw)["done_reason"] == "load"
    assert _get(port, "/nope")[0] == 404


def test_stop_sequence_cuts_the_stream(port_server):
    _, port = port_server
    _, _, raw = _post(port, {"prompt": "stop probe", "stream": False,
                             "max_tokens": 12, "temperature": 0.0})
    full = json.loads(raw)["response"]
    assert len(full) >= 2          # fixed weights: a fixed greedy text
    stop = full[1]
    _, _, raw = _post(port, {"prompt": "stop probe", "stream": True,
                             "max_tokens": 12, "options": {"stop": stop}})
    lines = [json.loads(x) for x in raw.splitlines()]
    text = "".join(x["response"] for x in lines)
    assert stop not in text and lines[-1]["done_reason"] == "stop"


def test_greedy_context_matches_reference_server(port_server, weights):
    """Same weights, same prompts: the port's greedy context equals the
    JAX InferenceServer's, streamed and unary."""
    _, port = port_server
    jm = jcfg.tiny_llama(vocab_size=512)
    jcfg_all = jcfg.FrameworkConfig(
        model=jm, engine=jcfg.EngineConfig(**ENGINE),
        server=jcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte",
                                 warmup=False))
    jserver = JServer(jcfg_all, engine=JEngine(jm, jcfg_all.engine,
                                               params=weights,
                                               attn_backend="dense"))

    async def reference(bodies):
        async with TestClient(TestServer(jserver.make_app())) as client:
            out = []
            for body in bodies:
                resp = await asyncio.wait_for(
                    client.post("/api/generate", json=body), TIMEOUT)
                raw = await asyncio.wait_for(resp.read(), TIMEOUT)
                out.append(json.loads(raw.splitlines()[-1])["context"])
            return out

    bodies = [{"prompt": p, "max_tokens": 10, "temperature": 0.0,
               "stream": stream}
              for p in PROMPTS for stream in (True, False)]
    want = asyncio.run(reference(bodies))
    got = [json.loads(_post(port, b)[2].splitlines()[-1])["context"]
           for b in bodies]
    assert got == want


def test_client_disconnect_cancels_the_request(port_server):
    """A client that hangs up mid-stream leaves nothing behind (the
    request is cancelled at the failed write, or finishes first) and the
    server keeps serving."""
    import socket
    import time

    server, port = port_server
    sched = server.group.schedulers[0]
    sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    body = json.dumps({"prompt": "hang up", "max_tokens": 60,
                       "stream": True}).encode()
    sock.sendall(b"POST /api/generate HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    assert sock.recv(64).startswith(b"HTTP/1.1 200")   # first token out
    sock.close()
    deadline = time.monotonic() + TIMEOUT
    while sched.load and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sched.load == 0
    assert all(s is None for s in server.engine.slots)
    assert _post(port, {"prompt": "after", "max_tokens": 2,
                        "stream": False})[0] == 200


@pytest.mark.parametrize("quant,level", [("int8", "Q8_0"), ("int4", "Q4_0")])
def test_tags_report_weight_quantization(quant, level):
    """/api/tags reports Ollama's Q8_0/Q4_0 for int8/int4 weights, as the
    reference server does; the quantized server (int8 KV pool beside)
    still answers /api/generate. The unquantized server reports F32."""
    mcfg = tcfg.tiny_llama(vocab_size=512)
    cfg = tcfg.FrameworkConfig(
        model=mcfg,
        engine=tcfg.EngineConfig(**ENGINE, quant=quant, kv_quant="int8"),
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte",
                                 warmup=False))
    server = InferenceServer(cfg, device="cpu")
    port = server.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _get(port, "/api/tags")
        assert status == 200
        details = json.loads(raw)["models"][0]["details"]
        assert details["quantization_level"] == level
        status, _, raw = _post(port, {"prompt": "int", "max_tokens": 3,
                                      "stream": False, "temperature": 0.0})
        body = json.loads(raw)
        assert status == 200 and body["done"] is True
        assert body["eval_count"] == 3 or body["done_reason"] == "stop"
    finally:
        server.shutdown(timeout=TIMEOUT)


def test_tags_report_dtype_when_unquantized(port_server):
    _, port = port_server
    _, _, raw = _get(port, "/api/tags")
    assert json.loads(raw)["models"][0]["details"][
        "quantization_level"] == "F32"


# ----------------------------------------------------------------------
# The reference's sizing and engine flags on the port's CLI
# ----------------------------------------------------------------------

ENGINE_FLAGS = ("max_batch_size", "num_pages", "target_ctx", "batch_cap",
                "decode_ladder", "ladder_admit_headroom_pages",
                "decode_pipeline_depth", "hybrid_prefill",
                "step_token_budget", "host_cache_pages", "admission",
                "optimistic_headroom_pages", "preempt_watermark_pages",
                "preempt_max_per_request", "page_size", "max_pages_per_seq",
                "chunked_prefill_size", "quant", "kv_quant")


def _reference_parser(monkeypatch):
    """The reference CLI's own argparse parser, caught as its main()
    calls parse_args."""
    import argparse

    from tpu_inference.server import __main__ as jmain

    class Caught(Exception):
        pass

    def catch(self, args=None, namespace=None):
        raise Caught(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    try:
        jmain.main()
    except Caught as c:
        parser = c.args[0]
    monkeypatch.undo()
    return parser


def test_cli_flags_parse_with_reference_defaults(monkeypatch):
    """Every sizing and engine flag of the reference's CLI exists on the
    port's with the same default (``--decode-ladder auto``,
    ``--host-cache-pages auto`` among them), and the reference's chip
    configuration parses to the same values on both."""
    from tpu_inference_torch.server.__main__ import build_parser
    ref = _reference_parser(monkeypatch)
    port = build_parser()
    want, got = vars(ref.parse_args([])), vars(port.parse_args([]))
    for name in ENGINE_FLAGS:
        assert got[name] == want[name], name
    assert got["decode_ladder"] == "auto"
    assert got["host_cache_pages"] == "auto"
    chip = ["--model", "llama-3-8b", "--quant", "int8", "--kv-quant",
            "int8", "--max-batch-size", "auto", "--num-pages", "auto",
            "--batch-cap", "32", "--decode-pipeline-depth", "2",
            "--hybrid-prefill", "--step-token-budget", "64",
            "--admission", "optimistic", "--host-cache-pages", "100"]
    want, got = vars(ref.parse_args(chip)), vars(port.parse_args(chip))
    for name in ENGINE_FLAGS:
        assert got[name] == want[name], name


def test_cli_resolves_auto_in_reference_order(monkeypatch):
    """--max-batch-size/--num-pages auto from the card's memory (a stand-
    in of 80 GB here), then the ladder against the batch, then the host
    tier from the machine's RAM: the reference's arithmetic."""
    from tpu_inference.engine import autosize as jauto
    from tpu_inference_torch.engine import autosize as tauto
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    resolve_engine_args)
    monkeypatch.setattr(tauto, "detect_hbm_bytes", lambda device=None: 80e9)
    monkeypatch.setattr(tauto, "detect_host_ram_bytes", lambda: 64 << 30)
    p = build_parser()
    args = p.parse_args(["--model", "llama-3-8b", "--quant", "int8",
                         "--kv-quant", "int8", "--max-batch-size", "auto",
                         "--num-pages", "auto", "--batch-cap", "32",
                         "--max-pages-per-seq", "128",
                         "--decode-pipeline-depth", "2"])
    ea = resolve_engine_args(args, p)
    m = jcfg.PRESETS["llama-3-8b"]()
    sz = jauto.auto_size(m, hbm_bytes=80e9, quant="int8", kv_quant="int8",
                         max_pages_per_seq=128, batch_cap=32)
    assert (ea["max_batch_size"], ea["num_pages"]) == (32, 16384)
    assert (ea["max_batch_size"], ea["num_pages"]) == (sz.max_batch_size,
                                                       sz.num_pages)
    assert ea["decode_ladder"] == (8, 16, 32)
    assert ea["host_cache_pages"] == jauto.auto_host_cache_pages(
        m, kv_quant="int8", page_size=16, host_ram_bytes=64 << 30)
    assert ea["decode_pipeline_depth"] == 2
    tcfg.EngineConfig(**ea)                   # a valid engine config


@pytest.mark.parametrize("flags", [["--decode-ladder", "8,x"],
                                   ["--decode-ladder", "4,16"],
                                   ["--max-batch-size", "nope"]])
def test_cli_rejects_bad_sizing_flags(flags):
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    resolve_engine_args)
    p = build_parser()
    with pytest.raises(SystemExit):
        resolve_engine_args(p.parse_args(flags + ["--host-cache-pages",
                                                  "0"]), p)


def test_metrics_expose_engine_breadth_series(weights):
    """/metrics carries the ladder, pipeline, hybrid, preemption and host-
    tier series under the reference's names, and the stats snapshot the
    new fields."""
    mcfg = tcfg.tiny_llama(vocab_size=512)
    ecfg = tcfg.EngineConfig(**{**ENGINE, "max_batch_size": 8,
                                "num_pages": 24}, decode_ladder=(4, 8),
                             decode_pipeline_depth=2, hybrid_prefill=True,
                             chunked_prefill_size=16, host_cache_pages=32,
                             admission="optimistic")
    cfg = tcfg.FrameworkConfig(
        model=mcfg, engine=ecfg,
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte",
                                 warmup=False))
    engine = InferenceEngine(
        mcfg, ecfg, device="cpu",
        params=params_from_numpy(jax.device_get(weights), mcfg, "cpu"))
    server = InferenceServer(cfg, engine=engine)
    port = server.start(host="127.0.0.1", port=0)
    try:
        for prompt in ("y" * 50, "short", "y" * 50):
            status, _, _ = _post(port, {"prompt": prompt, "max_tokens": 6,
                                        "stream": False})
            assert status == 200
        _, _, raw = _get(port, "/metrics")
        text = raw.decode()
        for name in ("tpu_inf_decode_rung", "tpu_inf_decode_ladder_top",
                     "tpu_inf_rung_switches_total",
                     "tpu_inf_decode_occupancy",
                     "tpu_inf_hybrid_steps_total",
                     "tpu_inf_hybrid_dispatch_seconds_bucket",
                     "tpu_inf_decode_sync_seconds_bucket",
                     "tpu_inf_preemptions_total",
                     "tpu_inf_recompute_resumes_total",
                     "tpu_inf_swap_in_resumes_total",
                     "tpu_inf_kv_offload_pages_total",
                     "tpu_inf_kv_restore_pages_total",
                     "tpu_inf_kv_offload_bytes_total",
                     "tpu_inf_kv_restore_bytes_total",
                     "tpu_inf_kv_host_pages_total",
                     "tpu_inf_kv_host_pages_used",
                     "tpu_inf_kv_host_evictions_total",
                     "tpu_inf_kv_swap_seconds_bucket"):
            assert f"\n{name}" in text, name
        assert 'tpu_inf_decode_ladder_top{replica="0"} 8' in text
        _, _, raw = _get(port, "/metrics?format=json")
        snap = json.loads(raw)
        assert snap["decode_ladder"] == [4, 8]
        assert snap["decode_pipeline_depth"] == 2
        assert snap["hybrid_prefill"] is True
        assert snap["decode_call_s"]["measures"] == "dispatch"
        for key in ("rung_peak", "rung_switches", "rung_calls",
                    "lane_occupancy", "hybrid_steps", "preemptions",
                    "recompute_resumes", "swap_in_resumes"):
            assert key in snap, key
        assert snap["prefix_cache"]["host_capacity_pages"] == 32
    finally:
        server.shutdown(timeout=TIMEOUT)


@pytest.mark.parametrize("kw,check", [
    ({"spec_mode": "ngram", "num_speculative_tokens": 4},
     lambda e: e.spec_ngram and e.engine_cfg.num_speculative_tokens == 4),
    ({"num_speculative_tokens": 2, "draft_model": "tiny-llama"},
     lambda e: e.spec_draft and e.draft_cfg.name == e.model_cfg.name),
    ({"chaos_step_failure_rate": 0.1},
     lambda e: e.chaos_step_failure_rate == 0.1),
    ({"slo_ttft_ms": 100.0},
     lambda e: (e.engine_cfg.slo_ttft_ms == 100.0
                and e.telemetry.slo.ttft_target_s == 0.1))],
    ids=["num_speculative_tokens", "spec_mode", "chaos_step_failure_rate",
         "slo_ttft_ms"])
def test_spec_and_chaos_knobs_through_build_server(kw, check):
    from tpu_inference_torch.server.http import build_server
    server = build_server("tiny-llama", warmup=False, device="cpu", **kw)
    assert check(server.engine)
