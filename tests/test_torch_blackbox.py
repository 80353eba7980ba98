"""The port's crash flight recorder and the request half of the /debug
routes against the reference's (tests/test_step_ledger.py's flight
recorder cases, port beside reference): capture, retention, the
per-trigger rate limit, the postmortem of a dead heartbeat and the
atomic write on ``tmp_path``; ``blackbox_index`` equal to the
reference's; the scheduler's ``step_error`` and the watchdog's
``watchdog`` captures and the loop's heartbeat; GET /debug/requests,
/debug/trace and /debug/blackbox over HTTP with the reference server's
status codes and bodies, and 404 without ``enable_debug``; the SLO and
blackbox flags parsed to the reference's values."""

import asyncio
import http.client
import json
import os
import tempfile
import threading
import time

import pytest

import jax
from aiohttp.test_utils import TestClient, TestServer

from tests.test_torch_ladder import port_engine
from tests.test_torch_server import _reference_parser
from tpu_inference import config as jcfg
from tpu_inference import telemetry as jtel
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.models import build_model as j_build
from tpu_inference.server.http import InferenceServer as JServer
from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.models.weights import params_from_numpy
from tpu_inference_torch.server.http import InferenceServer
from tpu_inference_torch.server.replicas import EngineGroup
from tpu_inference_torch.telemetry import (EngineTelemetry, FlightRecorder,
                                           attach_flight_recorder,
                                           blackbox_index)

TIMEOUT = 60
ENGINE = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
              max_batch_size=4, prefill_buckets=(16, 32))

# ---------------------------------------------- flight recorder units


@pytest.mark.parametrize("enabled", [True, False])
def test_attach_needs_a_dir_and_telemetry(tmp_path, enabled):
    assert attach_flight_recorder(EngineTelemetry(enabled=enabled),
                                  "", 0) is None
    fr = attach_flight_recorder(EngineTelemetry(enabled=enabled),
                                str(tmp_path), 0)
    assert (fr is not None) == enabled
    assert (fr is not None) == (jtel.attach_flight_recorder(
        jtel.EngineTelemetry(enabled=enabled), str(tmp_path / "j"), 0)
        is not None)


def _recorder_run(mod, root: str) -> list:
    """tests/test_step_ledger.py's capture/retention/rate-limit/restart
    sequence on either package's FlightRecorder; returns what it saw,
    paths relative to ``root``, timestamps and pids dropped."""
    steps = [{"kind": "decode", "tokens": 3}]
    seen = []
    fr = mod.FlightRecorder(root, replica=1, retain=2, config={"dp": 1},
                            steps_fn=lambda: steps,
                            spans_fn=lambda: [{"name": "request"}],
                            stats_fn=lambda: {"ok": True})
    path = fr.capture("step_error", min_interval_s=0.0)
    payload = json.loads(open(path).read())
    seen.append((os.path.relpath(path, root),
                 {k: v for k, v in payload.items() if k not in ("ts",
                                                                "pid")}))
    seen.append(fr.capture("step_error", min_interval_s=60.0))
    for i in range(4):
        seen.append(os.path.basename(fr.capture(f"t{i}",
                                                min_interval_s=0.0)))
    seen.append(sorted(os.listdir(fr.dir)))
    fr.maybe_periodic()
    fr.maybe_periodic()                 # interval-gated: one write
    seen.append(sorted(os.listdir(fr.dir)))
    fr2 = mod.FlightRecorder(root, replica=1, retain=2)
    seen.append(sorted(os.listdir(fr2.dir)))
    pm = json.loads(open(os.path.join(
        fr2.dir, "capture-000005-postmortem.json")).read())
    seen.append((pm["trigger"], pm["steps"], pm["config"]))
    seen.append(os.path.basename(fr2.capture("boot", min_interval_s=0.0)))
    fr3 = mod.FlightRecorder(root, replica=1, retain=8,
                             steps_fn=lambda: 1 / 0)
    p3 = fr3.capture("bad_fn", min_interval_s=0.0)
    seen.append(json.loads(open(p3).read())["steps"])
    return seen


def test_flight_recorder_capture_retention_rate_limit(tmp_path):
    seen = _recorder_run(telemetry, str(tmp_path / "port"))
    assert seen == _recorder_run(jtel, str(tmp_path / "ref"))
    assert seen[0] == ("replica-1/capture-000000-step_error.json", {
        "replica": 1, "trigger": "step_error", "config": {"dp": 1},
        "steps": [{"kind": "decode", "tokens": 3}],
        "spans": [{"name": "request"}], "stats": {"ok": True}})
    assert seen[1] is None
    assert seen[6] == ["capture-000003-t2.json", "capture-000004-t3.json"]
    assert "periodic.json" in seen[7]
    assert "capture-000005-postmortem.json" in seen[8]
    assert "periodic.json" not in seen[8]
    assert seen[9] == ("postmortem", [{"kind": "decode", "tokens": 3}],
                       {"dp": 1})
    assert seen[10] == "capture-000006-boot.json" and seen[11] == []


def test_flight_recorder_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails mid-dump leaves no capture under its final
    name (only a .tmp, which the index skips), the previous capture
    whole, and capture() returns None instead of raising."""
    fr = FlightRecorder(str(tmp_path), replica=0, retain=8,
                        stats_fn=lambda: {"n": 1})
    good = fr.capture("first", min_interval_s=0.0)

    def torn(obj, f, **kw):
        f.write('{"trigger": "torn", "ste')
        raise OSError("disk full")

    monkeypatch.setattr(telemetry.json, "dump", torn)
    assert fr.capture("second", min_interval_s=0.0) is None
    monkeypatch.undo()
    names = sorted(os.listdir(fr.dir))
    assert names == ["capture-000000-first.json",
                     "capture-000001-second.json.tmp"]
    assert json.loads(open(good).read())["stats"] == {"n": 1}
    idx = blackbox_index(str(tmp_path))
    assert [e["file"] for e in idx["captures"]] == \
        ["capture-000000-first.json"]
    assert idx == jtel.blackbox_index(str(tmp_path))


def _index_fixture(mod, root):
    for rep in (0, 1):
        fr = mod.FlightRecorder(root, replica=rep, retain=8,
                                steps_fn=lambda: [{}, {}])
        fr.capture("watchdog", min_interval_s=0.0)
        time.sleep(0.002)


def test_blackbox_index_lists_newest_first(tmp_path):
    root = str(tmp_path)
    assert blackbox_index("") == jtel.blackbox_index("") == \
        {"dir": "", "captures": []}
    assert blackbox_index(str(tmp_path / "nope"))["captures"] == []
    _index_fixture(telemetry, root)
    bad = tmp_path / "replica-0" / "capture-999999-junk.json"
    bad.write_text("{not json")
    (tmp_path / "replica-x").mkdir()
    (tmp_path / "stray.json").write_text("{}")
    idx = blackbox_index(root)
    assert idx == jtel.blackbox_index(root)
    entries = idx["captures"]
    assert {e["replica"] for e in entries} == {0, 1}
    good = [e for e in entries if "error" not in e]
    assert all(e["trigger"] == "watchdog" and e["n_steps"] == 2
               and e["pid"] == os.getpid() for e in good)
    ts = [e["ts"] for e in good]
    assert ts == sorted(ts, reverse=True), "newest first"
    assert any(e.get("error") == "unreadable" for e in entries)


@pytest.mark.parametrize("mod", [telemetry, jtel], ids=["port", "ref"])
def test_attach_flight_recorder_binds_ledger_and_spans(tmp_path, mod):
    tel = mod.EngineTelemetry(enabled=True)
    tel.step_ledger = mod.StepLedger(depth=8)
    tel.step_ledger.push("decode", 4, 1, 7, 0, 1, 0.01, 0.0, 0.0, 0,
                         0.0, 0, False)
    tel.recorder.add("request", "tid-1", 0.0, 1.0, parent="")
    tel.recorder.seal("tid-1")
    tel.recorder.add_maintenance("kv_swap_out", 0.0, 1.0, pages=1)
    fr = mod.attach_flight_recorder(tel, str(tmp_path), 3, retain=4,
                                    config={"x": 1},
                                    stats_fn=lambda: {"n": 1})
    assert fr is not None and tel.flight is fr
    payload = json.loads(open(fr.capture("watchdog",
                                         min_interval_s=0.0)).read())
    assert payload["replica"] == 3 and payload["config"] == {"x": 1}
    assert payload["steps"][0]["tokens"] == 7
    assert [s["name"] for s in payload["spans"]] == ["request",
                                                     "kv_swap_out"]
    assert payload["stats"] == {"n": 1}


# ----------------------------------- captures from the serving path


def _group(root, **server_kw) -> EngineGroup:
    return EngineGroup([port_engine(**ENGINE)],
                       tcfg.ServerConfig(blackbox_dir=root, **server_kw))


def _submit(group, rid, prompt, max_new=4):
    done = threading.Event()
    out = {}

    def fin(s):
        out["seq"] = s
        done.set()
    group.submit(Sequence(request_id=rid, prompt_tokens=prompt,
                          max_new_tokens=max_new),
                 lambda s, t: None, fin)
    assert done.wait(TIMEOUT)
    return out["seq"]


def test_step_error_and_heartbeat_captures(tmp_path):
    """A failed dispatch leaves a step_error capture holding the ledger's
    records, the spans of the requests before it and the stats; the
    engine loop writes the heartbeat; the index lists both."""
    root = str(tmp_path)
    group = _group(root).start()
    try:
        assert _submit(group, 0, [1, 2, 3, 4, 5]).finish_reason == "length"
        group.engine.chaos_step_failure_rate = 1.0
        assert _submit(group, 1, [6, 7, 8]).finish_reason == "error"
        group.engine.chaos_step_failure_rate = 0.0
    finally:
        group.stop(drain=False)
    idx = blackbox_index(root)
    assert idx == group.blackbox_index()
    by = {e["trigger"]: e for e in idx["captures"]}
    # The stop took the exit capture and dropped the exit hook (which
    # would keep the engine alive).
    assert {"step_error", "periodic", "atexit"} <= set(by)
    assert group.engine.telemetry.flight._atexit is None
    err = by["step_error"]
    assert err["n_steps"] > 0 and err["n_spans"] > 0
    assert err["has_config"] and err["has_stats"]
    payload = json.loads(open(err["path"]).read())
    assert payload["config"]["blackbox_dir"] == root
    assert payload["stats"]["step_failures"] == 1
    assert "slo" in payload["stats"]


def test_watchdog_capture(tmp_path):
    root = str(tmp_path)
    group = _group(root, step_watchdog_s=0.2).start()
    try:
        assert _submit(group, 0, [1, 2, 3]).finish_reason == "length"
        group.engine.chaos_step_wedge_s = 1.0
        assert _submit(group, 1, [4, 5, 6]).finish_reason == "unavailable"
    finally:
        group.engine.chaos_step_wedge_s = 0.0
        group.stop(drain=False)
    caps = [e for e in blackbox_index(root)["captures"]
            if e["trigger"] == "watchdog"]
    assert len(caps) == 1 and caps[0]["n_steps"] > 0
    assert group.health[0].wedges == 1
    # The stranded request's trace is sealed with its terminal reason.
    tid = next(t["trace_id"] for t in group.recent_snapshot(5)
               if t["request_id"] == 0)
    assert group.trace_snapshot(tid)["tree"]["attrs"]["reason"] == "length"


def test_no_blackbox_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    group = EngineGroup([port_engine(**ENGINE)], tcfg.ServerConfig())
    assert group.engine.telemetry.flight is None
    assert group.blackbox_index() == {"dir": "", "captures": []}
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- /debug over HTTP


def _servers(tmp_path, debug: bool):
    """The reference server and the started port server on the same
    weights, with enable_debug and each its own blackbox dir."""
    out = []
    for mod, sub in ((jcfg, "ref"), (tcfg, "port")):
        out.append(mod.FrameworkConfig(
            model=mod.tiny_llama(vocab_size=512),
            engine=mod.EngineConfig(**dict(ENGINE, num_pages=128,
                                           prefill_buckets=(16, 32, 64))),
            server=mod.ServerConfig(model_name="tiny-llama",
                                    tokenizer="byte", warmup=False,
                                    enable_debug=debug,
                                    blackbox_dir=str(tmp_path / sub))))
    jc, tc = out
    params, _ = j_build(jc.model, seed=0)
    jsrv = JServer(jc, engine=JEngine(jc.model, jc.engine, params=params,
                                      attn_backend="dense"))
    srv = InferenceServer(tc, engine=InferenceEngine(
        tc.model, tc.engine, device="cpu",
        params=params_from_numpy(jax.device_get(params), tc.model, "cpu")))
    return jsrv, srv, srv.start(host="127.0.0.1", port=0)


def _port_call(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, None if body is None
                     else json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


GENERATE = [({"prompt": "trace this request please", "stream": True,
              "max_tokens": 6, "temperature": 0.0}, "trace-a"),
            ({"prompt": "x" * 40, "stream": False, "max_tokens": 4,
              "temperature": 0.0}, "trace-b")]
# (path, compare the bodies whole): the error bodies are compared whole,
# the success bodies by shape below.
ROUTES = [("/debug/requests?n=abc", True), ("/debug/requests?n=", True),
          ("/debug/requests?n=0", True), ("/debug/requests?n=-3", True),
          ("/debug/trace", True), ("/debug/trace?id=%20", True),
          ("/debug/trace?id=no-such", True),
          ("/debug/trace?format=chrome&n=x", True),
          ("/debug/requests", False), ("/debug/requests?n=1", False),
          ("/debug/trace?id=trace-a", False),
          ("/debug/trace?format=chrome", False),
          ("/debug/trace?format=chrome&n=1", False),
          ("/debug/blackbox", False)]


def _reference_calls(jsrv, calls) -> list:
    async def go():
        out = []
        async with TestClient(TestServer(jsrv.make_app())) as client:
            for method, path, body, headers in calls:
                if method == "POST":
                    resp = await client.post(path, json=body,
                                             headers=headers)
                else:
                    resp = await client.get(path)
                out.append((resp.status, await resp.read()))
        return out
    return asyncio.run(asyncio.wait_for(go(), 4 * TIMEOUT))


def _shape(path: str, body):
    """What must agree between the two servers for a success body."""
    if path.startswith("/debug/requests"):
        return [(sorted(t), t["trace_id"], t["prompt_tokens"],
                 t["output_tokens"], t["finish_reason"], t["attempt"],
                 t["routed_replica"]) for t in body]
    if path == "/debug/blackbox":
        return sorted(body)
    if "format=chrome" in path:
        return sorted((e["name"], e["ph"], e["pid"], e.get("cat"))
                      for e in body["traceEvents"])

    def walk(node):
        return (node["name"], node["replica"],
                sorted(walk(c) for c in node["children"]))
    return (body["trace_id"], body["n_spans"], body["replicas"],
            walk(body["tree"]))


def test_debug_routes_match_reference(tmp_path):
    jsrv, srv, port = _servers(tmp_path, debug=True)
    try:
        calls = [("POST", "/api/generate", body, {"X-Request-Id": tid})
                 for body, tid in GENERATE]
        calls += [("GET", path, None, None) for path, _ in ROUTES]
        want = _reference_calls(jsrv, calls)
        got = [_port_call(port, *c) for c in calls]
    finally:
        srv.shutdown(timeout=TIMEOUT)
    for (path, whole), (status, raw), (jstatus, jraw) in zip(
            ROUTES, got[2:], want[2:]):
        assert status == jstatus, path
        body, jbody = json.loads(raw), json.loads(jraw)
        if whole:
            assert body == jbody, path
        else:
            assert _shape(path, body) == _shape(path, jbody), path
    by_path = {path: json.loads(raw) for (path, _), (_, raw)
               in zip(ROUTES, got[2:])}
    timelines = by_path["/debug/requests"]
    assert [t["trace_id"] for t in timelines] == ["trace-a", "trace-b"]
    for t in timelines:
        assert abs(t["queue_wait_s"] + t["prefill_s"] + t["decode_s"]
                   - t["e2e_s"]) < 1e-3
    tree = by_path["/debug/trace?id=trace-a"]["tree"]
    assert tree["name"] == "request" and {c["name"] for c in
                                          tree["children"]} == {
        "route", "queue_wait", "prefill", "decode"}
    assert by_path["/debug/blackbox"]["dir"] == str(tmp_path / "port")


@pytest.mark.parametrize("path", ["/debug/requests", "/debug/trace",
                                  "/debug/blackbox"])
def test_debug_routes_need_enable_debug(tmp_path, path):
    jsrv, srv, port = _servers(tmp_path, debug=False)
    try:
        (want, _), = _reference_calls(jsrv, [("GET", path, None, None)])
        status, _ = _port_call(port, "GET", path)
    finally:
        srv.shutdown(timeout=TIMEOUT)
    assert status == want == 404


# ------------------------------------------------------------ flags


@pytest.mark.parametrize("flags", [
    [],
    ["--slo-ttft-ms", "250", "--slo-tpot-ms", "40.5", "--blackbox-dir",
     "bb", "--blackbox-retain", "3"],
    ["--blackbox-dir", ""],
])
def test_slo_and_blackbox_flags_match_reference(flags, monkeypatch):
    """The flags parse to the reference's values and reach ServerConfig
    and EngineConfig; the default blackbox root is the reference's
    /tmp/tpu-inf-blackbox where the temp dir is /tmp."""
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    resolve_engine_args,
                                                    server_overrides)
    ref = _reference_parser(monkeypatch)
    monkeypatch.setattr(tempfile, "tempdir", "/tmp")
    p = build_parser()
    want, got = ref.parse_args(flags), p.parse_args(
        flags + ["--host-cache-pages", "0"])
    for name in ("slo_ttft_ms", "slo_tpot_ms", "blackbox_dir",
                 "blackbox_retain"):
        assert getattr(got, name) == getattr(want, name), name
    scfg = tcfg.ServerConfig(**server_overrides(got))
    ecfg = tcfg.EngineConfig(**resolve_engine_args(got, p))
    jscfg = jcfg.ServerConfig(blackbox_dir=want.blackbox_dir,
                              blackbox_retain=want.blackbox_retain)
    jecfg = jcfg.EngineConfig(slo_ttft_ms=want.slo_ttft_ms,
                              slo_tpot_ms=want.slo_tpot_ms)
    assert (scfg.blackbox_dir, scfg.blackbox_retain) == \
        (jscfg.blackbox_dir, jscfg.blackbox_retain)
    assert (ecfg.slo_ttft_ms, ecfg.slo_tpot_ms) == \
        (jecfg.slo_ttft_ms, jecfg.slo_tpot_ms)
    assert tcfg.ServerConfig().blackbox_dir == jcfg.ServerConfig().blackbox_dir
    if not flags:
        assert got.blackbox_dir == "/tmp/tpu-inf-blackbox"


def test_blackbox_default_follows_tmpdir(monkeypatch, tmp_path):
    from tpu_inference_torch.server.__main__ import build_parser
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert build_parser().parse_args([]).blackbox_dir == \
        str(tmp_path / "tpu-inf-blackbox")


def test_cli_boots_with_slo_targets_and_blackbox(tmp_path):
    """--slo-* reach the engine's SLO tracker, --blackbox-dir attaches
    the flight recorder (its heartbeat lands there once the loop runs)."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    args = p.parse_args(["--device", "cpu", "--model", "tiny-llama",
                         "--no-warmup", "--num-pages", "64",
                         "--max-batch-size", "2", "--host-cache-pages", "0",
                         "--slo-ttft-ms", "500", "--slo-tpot-ms", "20",
                         "--blackbox-dir", str(tmp_path),
                         "--blackbox-retain", "2", "--port", "0"])
    srv, engine_args = boot_server(args, p)
    slo = srv.engine.telemetry.slo
    assert (slo.ttft_target_s, slo.tpot_target_s) == (0.5, 0.02)
    assert engine_args["slo_ttft_ms"] == 500.0
    fr = srv.engine.telemetry.flight
    assert fr is not None and fr.retain == 2 and fr.dir == str(
        tmp_path / "replica-0")
    srv.start(host="127.0.0.1", port=0)
    try:
        deadline = time.monotonic() + TIMEOUT
        while not os.path.exists(os.path.join(fr.dir, "periodic.json")):
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        srv.shutdown(timeout=TIMEOUT)
