"""The port's /api/chat, embeddings and model-card routes against the
reference's (tests/test_server.py test_chat_endpoint and the show/ps half
of test_aux_routes; tests/test_failover.py's chaos gate over chat and
embed, /api/ps semantics and the embed 503 of a wedged dp=1 fleet):
chat greedy token ids equal to the reference server's for the same
messages, through the role-prefix transcript and through a chat template;
``embed_many`` equal to the reference's for tiny llama, gpt2, mixtral and
the 8-expert Mixtral whose calls drop tokens."""

import asyncio
import json
import re

import numpy as np
import pytest

import jax
from aiohttp.test_utils import TestClient, TestServer

from tests.test_torch_mixtral import pair as mixtral_pair
from tests.test_torch_server import TIMEOUT, _get, _post
from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.server.http import InferenceServer as JServer
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.server.http import InferenceServer

ENGINE = dict(page_size=8, num_pages=128, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32, 64))
MSGS = [{"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi"}]


def _cfgs(tokenizer="byte", **server_kw):
    """(reference FrameworkConfig, port FrameworkConfig): tiny llama,
    vocab 512, the same engine and server settings."""
    out = []
    for mod in (jcfg, tcfg):
        out.append(mod.FrameworkConfig(
            model=mod.tiny_llama(vocab_size=512),
            engine=mod.EngineConfig(**ENGINE),
            server=mod.ServerConfig(model_name="tiny-llama",
                                    tokenizer=tokenizer, warmup=False,
                                    **server_kw)))
    return out


def _servers(tokenizer="byte", **server_kw):
    """The reference server and the started port server on the same
    weights; (reference server, port server, port)."""
    jc, tc = _cfgs(tokenizer, **server_kw)
    params, _ = j_build(jc.model, seed=0)
    jsrv = JServer(jc, engine=JEngine(jc.model, jc.engine, params=params,
                                      attn_backend="dense"))
    engine = InferenceEngine(
        tc.model, tc.engine, device="cpu",
        params=params_from_numpy(jax.device_get(params), tc.model, "cpu"))
    srv = InferenceServer(tc, engine=engine)
    return jsrv, srv, srv.start(host="127.0.0.1", port=0)


def _capture_generated(group) -> list:
    """Wrap ``group.submit`` so each finished request's generated ids
    land in the returned list (chat records carry no context)."""
    out: list = []
    submit = group.submit

    def wrapped(seq, on_token, on_finish):
        def finish(s):
            out.append(list(s.generated))
            on_finish(s)
        return submit(seq, on_token, finish)

    group.submit = wrapped
    return out


def _reference_chat(jsrv, bodies) -> list:
    async def go():
        async with TestClient(TestServer(jsrv.make_app())) as client:
            for body in bodies:
                resp = await asyncio.wait_for(
                    client.post("/api/chat", json=body), TIMEOUT)
                assert resp.status == 200
                await asyncio.wait_for(resp.read(), TIMEOUT)
    asyncio.run(go())


def _chat_bodies(msgs):
    return [{"model": "m", "messages": msgs, "stream": stream,
             "options": {"num_predict": 6, "temperature": 0}}
            for stream in (False, True)]


def test_chat_endpoint():
    """Message records, counters, streaming and unary, the load probe,
    400 on malformed messages; greedy ids equal to the reference
    server's through the role-prefix transcript."""
    jsrv, srv, port = _servers()
    try:
        got = _capture_generated(srv.group)
        want = _capture_generated(jsrv.group)
        unary, stream = _chat_bodies(MSGS)
        status, headers, raw = _post(port, unary, "/api/chat")
        assert status == 200
        rec = json.loads(raw)
        assert rec["done"] and rec["message"]["role"] == "assistant"
        assert "context" not in rec and "response" not in rec
        assert rec["eval_count"] == 6
        assert rec["request_id"] == headers["X-Request-Id"]
        status, headers, raw = _post(port, stream, "/api/chat")
        assert headers["Content-Type"].startswith("application/x-ndjson")
        lines = [json.loads(x) for x in raw.splitlines() if x]
        assert all("message" in x and "response" not in x for x in lines)
        assert all(set(x) == {"model", "created_at", "message", "done"}
                   for x in lines[:-1])
        assert lines[-1]["done"] and lines[-1]["eval_count"] == 6
        assert "context" not in lines[-1]
        text = "".join(x["message"]["content"] for x in lines)
        assert text == rec["message"]["content"]
        # The transcript is the generate prompt; "context" is ignored.
        prompt = "system: be brief\nuser: hi\nassistant:"
        _, _, raw = _post(port, {"prompt": prompt, "stream": False,
                                 "options": {"num_predict": 6,
                                             "temperature": 0}})
        assert json.loads(raw)["response"] == rec["message"]["content"]
        _, _, raw = _post(port, dict(unary, context=[1, 2, 3]), "/api/chat")
        assert json.loads(raw)["message"] == rec["message"]
        _reference_chat(jsrv, _chat_bodies(MSGS))
        assert got[:2] == want == [got[0], got[0]]
        assert got[3] == got[0]
        status, _, raw = _post(port, {"model": "m", "messages": []},
                               "/api/chat")
        ping = json.loads(raw)
        assert status == 200 and ping["done"]
        assert ping["done_reason"] == "load" and "message" in ping
        for bad in ("nope", [{"role": "user"}], [1], None):
            assert _post(port, {"model": "m", "messages": bad},
                         "/api/chat")[0] == 400
    finally:
        srv.shutdown(timeout=TIMEOUT)


def _template_dir(tmp_path):
    """tests/test_tokenizer.py's BPE tokenizer with a chat template in
    its tokenizer_config.json."""
    pytest.importorskip("transformers")
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, pre_tokenizers, trainers

    tok = tokenizers.Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    trainer = trainers.BpeTrainer(vocab_size=400,
                                  special_tokens=["<s>", "</s>"])
    tok.train_from_iterator(["user assistant hello there"] * 20, trainer)
    tok.save(str(tmp_path / "tokenizer.json"))
    with open(tmp_path / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "bos_token": "<s>", "eos_token": "</s>",
                   "chat_template":
                       "{{ bos_token }}{% for m in messages %}[{{ m.role }}] "
                       "{{ m.content }}\n{% endfor %}assistant:"}, f)
    return str(tmp_path)


def test_chat_template_matches_reference(tmp_path):
    """Through a checkpoint tokenizer's chat template: the prompt the
    reference renders, and its greedy ids."""
    jsrv, srv, port = _servers(_template_dir(tmp_path))
    try:
        msgs = [{"role": "user", "content": "hello there"}]
        assert (srv.chat_prompt(msgs) == "[user] hello there\nassistant:"
                == jsrv.tokenizer.apply_chat_template(msgs))
        got = _capture_generated(srv.group)
        want = _capture_generated(jsrv.group)
        for body in _chat_bodies(msgs):
            status, _, _ = _post(port, body, "/api/chat")
            assert status == 200
        _reference_chat(jsrv, _chat_bodies(msgs))
        assert got == want and len(got[0]) >= 1
    finally:
        srv.shutdown(timeout=TIMEOUT)


def test_show_ps_and_tags():
    """/api/show and /api/ps: the reference's fields, the engine's
    parameter count and weight bytes, one model copy, never unloading."""
    jsrv, srv, port = _servers()
    try:
        status, _, raw = _post(port, {"model": "m"}, "/api/show")
        assert status == 200
        show = json.loads(raw)
        assert show["details"]["family"] == "llama"
        info = show["model_info"]
        assert info["llama.context_length"] == 64
        assert info["general.parameter_count"] == srv.engine.n_params > 0
        assert info["llama.attention.sliding_window"] == 0
        assert info["serving.swa_eviction"] is False
        assert info["serving.prefix_cache"] is True
        assert info["serving.attn_backend"] == "kernel"

        async def reference():
            async with TestClient(TestServer(jsrv.make_app())) as client:
                s = await (await client.post("/api/show",
                                             json={"model": "m"})).json()
                p = await (await client.get("/api/ps")).json()
                return s, p
        jshow, jps = asyncio.run(reference())
        assert set(jshow["model_info"]) == set(info)
        for key, val in jshow["model_info"].items():
            if key != "serving.attn_backend":     # dense vs kernel here
                assert info[key] == val, key
        assert show["details"] == jshow["details"]
        status, _, raw = _get(port, "/api/ps")
        (entry,) = json.loads(raw)["models"]
        (jentry,) = jps["models"]
        assert set(entry) == set(jentry)
        assert entry["name"] == "tiny-llama" and entry["replicas"] == 1
        assert entry["size"] == int(srv.engine.weight_bytes)
        assert entry["size_vram"] == entry["size"]
        assert entry["expires_at"] == jentry["expires_at"]
        details = entry["details"]
        assert details == jentry["details"]
        assert re.fullmatch(r"\d+(\.\d+)?[BMK]", details["parameter_size"])
        assert details["quantization_level"] == "F32"
        _, _, raw = _get(port, "/api/tags")
        assert json.loads(raw)["models"][0]["details"] == details
    finally:
        srv.shutdown(timeout=TIMEOUT)


def test_chaos_gate_covers_chat_and_embed():
    _, tc = _cfgs(chaos_failure_rate=1.0)
    srv = InferenceServer(tc, device="cpu")
    port = srv.start(host="127.0.0.1", port=0)
    try:
        status, _, raw = _post(port, {"model": "t", "messages": [
            {"role": "user", "content": "x"}]}, "/api/chat")
        assert status == 503 and b"chaos: injected failure" in raw
        for route in ("/api/embed", "/api/embeddings"):
            assert _post(port, {"input": "x"}, route)[0] == 503
    finally:
        srv.shutdown(timeout=TIMEOUT)


def test_embedding_routes():
    """The shape follows the route; the vectors are the engine's; bad
    bodies 400."""
    _, srv, port = _servers()
    try:
        eng = srv.engine
        texts = ["alpha", "a longer piece of text"]
        status, _, raw = _post(port, {"input": texts}, "/api/embed")
        assert status == 200
        body = json.loads(raw)
        assert body["model"] == "tiny-llama"
        want = eng.embed_many([srv.tokenizer.encode(t) for t in texts])
        np.testing.assert_allclose(np.asarray(body["embeddings"]), want,
                                   rtol=1e-6, atol=1e-6)
        status, _, raw = _post(port, {"input": "alpha"}, "/api/embed")
        assert np.asarray(json.loads(raw)["embeddings"]).shape == (
            1, eng.model_cfg.d_model)
        status, _, raw = _post(port, {"prompt": "alpha", "input": ["x"]},
                               "/api/embeddings")
        vec = json.loads(raw)["embedding"]
        np.testing.assert_allclose(vec, want[0], rtol=1e-6, atol=1e-6)
        for route, bad in (("/api/embeddings", {"input": "x"}),
                           ("/api/embed", {"input": []}),
                           ("/api/embed", {"input": [1]}),
                           ("/api/embed", {"prompt": "x"})):
            assert _post(port, bad, route)[0] == 400
    finally:
        srv.shutdown(timeout=TIMEOUT)


def test_wedged_replica_sheds_embeddings_with_503():
    """dp=1 wedge: the watchdog quarantines the replica, and /api/embed
    is shed with 503 and Retry-After, counted as unavailable."""
    _, tc = _cfgs(step_watchdog_s=0.15, quarantine_cooldown_s=3600.0,
                  retry_after_s=1.0)
    srv = InferenceServer(tc, device="cpu")
    srv.engine.chaos_step_wedge_s = 2.0
    port = srv.start(host="127.0.0.1", port=0)
    try:
        status, headers, _ = _post(port, {"prompt": "wedge me",
                                          "stream": False, "max_tokens": 4})
        assert status == 503 and "Retry-After" in headers
        status, headers, raw = _post(port, {"input": "x"}, "/api/embed")
        assert status == 503 and "Retry-After" in headers
        assert b"quarantined" in raw
        stats = json.loads(_get(port, "/metrics?format=json")[2])
        assert stats["step_failures"] == 0
        assert srv.group.requests_unavailable >= 1
        status, _, raw = _get(port, "/healthz")
        assert json.loads(raw)["supervision"]["requests_unavailable"] >= 1
    finally:
        srv.engine.chaos_step_wedge_s = 0.0
        srv.shutdown(timeout=5.0)


# ------------------------------------------------ embed_many vs the JAX one


def _family(preset: str):
    if preset in ("E8", "tiny_mixtral"):
        return mixtral_pair("E8" if preset == "E8" else "tiny_mixtral")
    jm = getattr(jcfg, preset)(vocab_size=256)
    tm = getattr(tcfg, preset)(vocab_size=256)
    params, _ = j_build(jm, seed=0)
    return jm, params, tm, params_from_numpy(jax.device_get(params), tm,
                                             device="cpu")


EMBED_ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                    max_batch_size=4, prefill_buckets=(16, 32))


@pytest.mark.parametrize("preset", ["tiny_llama", "tiny_gpt2",
                                    "tiny_mixtral", "E8"])
def test_embed_many_matches_reference(preset):
    """17 rows (two chunks: 16 lanes, then one; an empty row, rows past
    the 32-token cap) equal to the reference's, row by row."""
    jm, params, tm, tparams = _family(preset)
    jeng = JEngine(jm, jcfg.EngineConfig(**EMBED_ENGINE), params=params,
                   attn_backend="dense")
    eng = InferenceEngine(tm, tcfg.EngineConfig(**EMBED_ENGINE),
                          params=tparams, device="cpu")
    rng = np.random.default_rng(5)
    batch = [rng.integers(0, 256, size=int(n)).tolist()
             for n in rng.integers(1, 50, size=15)] + [[], [7] * 40]
    assert len(batch) == 17
    got, want = eng.embed_many(batch), jeng.embed_many(batch)
    assert got.shape == want.shape == (17, tm.d_model)
    assert got.dtype == np.float32
    for i in range(17):
        np.testing.assert_allclose(got[i], want[i], atol=1e-5, rtol=1e-4,
                                   err_msg=f"row {i}")
    np.testing.assert_allclose(eng.embed(batch[0]), jeng.embed(batch[0]),
                               atol=1e-5, rtol=1e-4)
    assert eng.embed_many([]).shape == (0, tm.d_model)
    if preset == "E8":
        # The 8-expert model drops tokens: capacity follows the padded
        # [16, 32] call, so row 0 alone is another function of it.
        alone = eng.embed_many(batch[:1])[0]
        assert not np.allclose(alone, got[0], atol=1e-5)


def test_embed_many_builds_no_autograd_graph():
    """Grad mode is per thread: an HTTP thread with grad enabled must
    still build no graph (a tensor that needs grad cannot reach numpy,
    so the call would raise)."""
    import threading

    import torch
    _, _, tm, tparams = _family("tiny_llama")
    tparams["embed"].requires_grad_(True)
    eng = InferenceEngine(tm, tcfg.EngineConfig(**EMBED_ENGINE),
                          params=tparams, device="cpu")
    out: list = []

    def http_thread():
        with torch.enable_grad():
            out.append(eng.embed_many([[1, 2, 3]]))

    t = threading.Thread(target=http_thread)
    t.start()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive() and out and out[0].shape == (1, tm.d_model)
