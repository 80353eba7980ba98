"""The decode call seen from inside the port, on the CPU: the device
clock's accounting on fake CUDA events, the launch split, the prefill
stall and the HTTP stream lag through a tiny-llama server, the
telemetry kill switch, the profiler ranges, and the benchmark's readers
of these series on a made-up context."""

import http.client
import importlib.util
import json
import pathlib
import threading
import time

import pytest

from tpu_inference_torch import config as tcfg
from tpu_inference_torch import telemetry
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.server.http import InferenceServer

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 60
ENGINE = dict(page_size=8, num_pages=256, max_pages_per_seq=32,
              max_batch_size=4, prefill_buckets=(16, 32, 64))
NEW_ENGINE_SERIES = ("tpu_inf_decode_launch_seconds",
                     "tpu_inf_decode_launch_cpu_seconds_total")


# ------------------------------------------------ the device clock


class FakeEvent:
    """A CUDA event whose record time is read off a shared fake clock."""

    def __init__(self, clock):
        self.clock = clock
        self.t = None

    def record(self, stream=None):
        self.t = self.clock["now"]

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3            # ms, as torch's


def _clock(depth=4):
    fake = {"now": 0.0}
    disp, gap = telemetry.Counter("d"), telemetry.Counter("g")
    clock = telemetry.DeviceClock(lambda: FakeEvent(fake), disp, gap,
                                  depth=depth)
    return clock, fake, disp, gap


def _dispatch(clock, fake, t0, t1, bound):
    fake["now"] = t0
    n = clock.start()
    fake["now"] = t1
    clock.stop(n, bound)
    return n


def test_device_clock_sums_dispatches_and_bound_gaps():
    clock, fake, disp, gap = _clock()
    a = _dispatch(clock, fake, 1.0, 1.5, bound=True)
    b = _dispatch(clock, fake, 1.7, 2.0, bound=False)
    c = _dispatch(clock, fake, 5.0, 5.25, bound=True)
    d = _dispatch(clock, fake, 5.5, 6.0, bound=True)
    assert clock.read(a) == pytest.approx(0.5)
    assert clock.read(b) == pytest.approx(0.3)
    assert clock.read(c) == pytest.approx(0.25)
    assert clock.read(d) == pytest.approx(0.5)
    assert disp.value == pytest.approx(1.55)
    # 1.5 -> 1.7 counts (a sequence stayed bound after a), 2.0 -> 5.0
    # does not (none after b), 5.25 -> 5.5 does.
    assert gap.value == pytest.approx(0.2 + 0.25)


def test_device_clock_reads_in_flight_dispatches_in_order():
    """Pipelined calls are read after newer ones started: each keeps its
    own pair, and its gap runs from the end before it."""
    clock, fake, disp, gap = _clock(depth=4)
    ns = [_dispatch(clock, fake, t, t + 0.1, bound=True)
          for t in (0.0, 0.3, 0.6)]
    got = [clock.read(n) for n in ns]
    assert got == pytest.approx([0.1, 0.1, 0.1])
    assert gap.value == pytest.approx(0.2 + 0.2)


def test_device_clock_drops_a_reading_the_ring_overwrote():
    clock, fake, disp, gap = _clock(depth=2)
    n = [_dispatch(clock, fake, t, t + 1.0, bound=True)
         for t in (0.0, 2.0, 4.0, 6.0)]
    assert clock.read(n[0]) is None
    assert disp.value == 0.0 and gap.value == 0.0
    # Dispatch 2 kept its pair; the end of 1 its gap runs from was
    # re-recorded by 3.
    assert clock.read(n[2]) == pytest.approx(1.0)
    assert gap.value == 0.0
    # 3's gap runs from 2's end, still held.
    assert clock.read(n[3]) == pytest.approx(1.0)
    assert gap.value == pytest.approx(1.0)


def test_engine_builds_no_clock_on_the_cpu():
    eng = InferenceEngine(tcfg.tiny_llama(vocab_size=512),
                          tcfg.EngineConfig(**ENGINE), device="cpu")
    assert eng.telemetry.device_clock is None
    text = telemetry.render_prometheus([({}, eng.telemetry.registry)])
    assert "tpu_inf_device_" not in text
    assert all(n in text for n in NEW_ENGINE_SERIES)


# ------------------------------------------------ through the server


def _server():
    mcfg = tcfg.tiny_llama(vocab_size=512)
    cfg = tcfg.FrameworkConfig(
        model=mcfg, engine=tcfg.EngineConfig(**ENGINE),
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte",
                                 warmup=False))
    server = InferenceServer(cfg, engine=InferenceEngine(
        mcfg, cfg.engine, device="cpu"))
    return server, server.start(host="127.0.0.1", port=0)


def _open(port, prompt, n, stream=True, trace_id=""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    body = {"prompt": prompt, "stream": stream, "temperature": 0.0,
            "options": {"num_predict": n}}
    conn.request("POST", "/api/generate", json.dumps(body),
                 {"Content-Type": "application/json",
                  **({"X-Request-Id": trace_id} if trace_id else {})})
    return conn, conn.getresponse()   # headers come with the first token


def _lines(conn, resp):
    try:
        assert resp.status == 200
        return [json.loads(x) for x in resp.read().splitlines() if x]
    finally:
        conn.close()


def _metrics(port):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
    finally:
        conn.close()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            name = head.split("{", 1)[0]
            out[name] = out.get(name, 0.0) + float(value)
    return out


@pytest.fixture(scope="module")
def served():
    server, port = _server()
    yield server, port
    server.shutdown(timeout=TIMEOUT)


def test_server_splits_launches_and_times_its_stream(served):
    """Several streamed requests, one admitted while another decodes: one
    launch per decode call, its CPU within its wall, one lag per token
    line, the batched prefill counted as a stall, the write times on the
    root span."""
    server, port = served
    m0 = _metrics(port)
    long_conn, long_resp = _open(port, "a long reply " * 3, 160,
                                 trace_id="lag-long")
    # The long request decodes (its headers came with its first token);
    # these are admitted behind it, batched into one prefill.
    got = {}

    def short(i):
        got[i] = _lines(*_open(port, f"short {i}", 12))

    threads = [threading.Thread(target=short, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert sorted(got) == [0, 1]
    long_lines = _lines(long_conn, long_resp)
    m1 = _metrics(port)

    def d(name):
        return m1.get(name, 0.0) - m0.get(name, 0.0)

    token_lines = sum(1 for ls in [long_lines, *got.values()]
                      for x in ls if not x["done"])
    assert all(ls[-1]["done"] for ls in [long_lines, *got.values()])
    calls = d("tpu_inf_decode_dispatches_total")
    assert calls > 0
    assert d("tpu_inf_decode_launch_seconds_count") == calls
    cpu = d("tpu_inf_decode_launch_cpu_seconds_total")
    wall = d("tpu_inf_decode_launch_seconds_sum")
    assert 0.0 < cpu <= wall + 1e-3 * calls
    assert d("tpu_inf_stream_lag_seconds_count") == token_lines
    assert d("tpu_inf_stream_lag_seconds_sum") > 0.0
    assert d("tpu_inf_decode_stall_during_prefill_seconds_count") >= 1
    assert d("tpu_inf_decode_stall_during_prefill_seconds_sum") > 0.0
    root = server.group.trace_snapshot("lag-long")["tree"]
    assert root["name"] == "request"
    attrs = root["attrs"]
    assert 0.0 < attrs["first_write_s"] and 0.0 < attrs["max_lag_s"]
    assert attrs["output_tokens"] == len(long_lines) - 1


def test_unary_response_counts_one_lag(served):
    server, port = served
    before = _metrics(port).get("tpu_inf_stream_lag_seconds_count", 0.0)
    (rec,) = _lines(*_open(port, "unary please", 6, stream=False))
    assert rec["done"] and rec["eval_count"] >= 1
    deadline = time.monotonic() + TIMEOUT
    # The observation follows the response's write.
    while (_metrics(port).get("tpu_inf_stream_lag_seconds_count", 0.0)
           < before + 1 and time.monotonic() < deadline):
        time.sleep(0.01)
    assert _metrics(port)["tpu_inf_stream_lag_seconds_count"] == before + 1


def test_telemetry_off_exports_none_of_the_new_series(monkeypatch):
    monkeypatch.setenv("TPU_INF_TELEMETRY", "0")
    server, port = _server()
    try:
        assert server.group.stream_lag_s is telemetry.NULL_METRIC
        assert server.engine.telemetry.device_clock is None
        lines = _lines(*_open(port, "quiet", 6))
        assert lines[-1]["done"]
        text = json.dumps(sorted(_metrics(port)))
    finally:
        server.shutdown(timeout=TIMEOUT)
    for name in telemetry.PORT_SERIES:
        assert name not in text, name


def test_phase_ranges_only_while_a_profiler_records(served, tmp_path):
    assert telemetry.phase_range("launch") is telemetry.phase_range("sync")
    server, port = served
    sched = server.group.schedulers[0]
    box = {}

    def until():
        box["lines"] = _lines(*_open(port, "profile me", 12))

    path = telemetry.torch_trace(str(tmp_path), until)
    assert box["lines"][-1]["done"]
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    ranges = {e["name"] for e in events
              if str(e.get("name", "")).startswith("tpu_inf.")
              and e.get("tid") == sched.thread_native_id}
    assert {"tpu_inf.admit", "tpu_inf.prefill", "tpu_inf.stage",
            "tpu_inf.launch", "tpu_inf.sync", "tpu_inf.deliver",
            "tpu_inf.finish"} <= ranges


# ------------------------------------------------ the readers


def _reader(name):
    path = ROOT / "h100bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "hb_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


BEFORE = {"tpu_inf_decode_launch_seconds_sum": 1.0,
          "tpu_inf_decode_launch_seconds_count": 10.0,
          "tpu_inf_decode_launch_cpu_seconds_total": 0.5,
          "tpu_inf_device_gap_seconds_total": 2.0,
          "tpu_inf_decode_stall_during_prefill_seconds_sum": 1.0,
          "tpu_inf_stream_lag_seconds_sum": 0.01,
          "tpu_inf_stream_lag_seconds_count": 10.0}
AFTER = {"tpu_inf_decode_launch_seconds_sum": 3.0,
         "tpu_inf_decode_launch_seconds_count": 110.0,
         "tpu_inf_decode_launch_cpu_seconds_total": 2.0,
         "tpu_inf_device_gap_seconds_total": 7.0,
         "tpu_inf_decode_stall_during_prefill_seconds_sum": 3.5,
         "tpu_inf_stream_lag_seconds_sum": 0.31,
         "tpu_inf_stream_lag_seconds_count": 160.0}
# Over a clean span of 20 s.
WANT = {"decode_launch_ms": 20.0, "launch_cpu_share": 75.0,
        "device_gap_share": 25.0, "prefill_stall_share": 12.5,
        "stream_lag_ms": 2.0}
# The series whose absence each reader must survive.
NEEDS = {"decode_launch_ms": "tpu_inf_decode_launch_seconds_count",
         "launch_cpu_share": "tpu_inf_decode_launch_cpu_seconds_total",
         "device_gap_share": "tpu_inf_device_gap_seconds_total",
         "prefill_stall_share":
             "tpu_inf_decode_stall_during_prefill_seconds_sum",
         "stream_lag_ms": "tpu_inf_stream_lag_seconds_count"}


@pytest.mark.parametrize("cell", ["serve", "batch"])
@pytest.mark.parametrize("metric", sorted(WANT))
def test_readers_on_a_made_up_context(metric, cell):
    read = _reader(f"{metric}.{cell}")
    ctx = {"clean": (100.0, 120.0), "counters": (BEFORE, AFTER)}
    assert read(ctx) == pytest.approx(WANT[metric])
    gone = {k: v for k, v in AFTER.items() if k != NEEDS[metric]}
    assert read({**ctx, "counters": (BEFORE, gone)}) is None


def test_port_series_are_documented_in_perf_md():
    text = (ROOT / "PERF.md").read_text()
    for name in telemetry.PORT_SERIES:
        assert name in text, name


def test_stream_lag_histogram_loses_no_observation_across_threads():
    """One HTTP handler thread per stream observes the one histogram."""
    import sys

    h = telemetry.stream_lag_histogram(telemetry.Registry(), True)
    n_threads, n_obs = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [h.observe(0.5) for _ in range(n_obs)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert h.cumulative()[-1] == n_threads * n_obs
    assert h.sum == 0.5 * n_threads * n_obs
