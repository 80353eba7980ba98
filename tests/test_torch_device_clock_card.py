"""On the card: the engine's CUDA-event clock through a served tiny-llama.
Both event series advance, and the dispatches' device time plus the
gaps between them fit inside the host wall that spans them. Skipped
where no card is visible (decided inside the test). The file imports
no JAX, so it runs on the card with

    python3 -m pytest -q -p no:cacheprovider --noconftest \\
        tests/test_torch_device_clock_card.py
"""

import http.client
import json
import threading
import time

import pytest

TIMEOUT = 300


def _generate(port, prompt, n, out):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/api/generate", json.dumps(
            {"prompt": prompt, "stream": True, "temperature": 0.0,
             "options": {"num_predict": n}}),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out.append([json.loads(x) for x in resp.read().splitlines() if x])
    finally:
        conn.close()


def _series(server):
    from tpu_inference_torch import telemetry

    text = telemetry.render_prometheus(
        [({}, server.engine.telemetry.registry)])
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            head, _, value = line.rpartition(" ")
            out[head] = float(value)
    return out


def test_event_clock_fits_the_wall_it_spans():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the event clock runs only there")
    from tpu_inference_torch import config as tcfg
    from tpu_inference_torch.engine.engine import InferenceEngine
    from tpu_inference_torch.server.http import InferenceServer

    mcfg = tcfg.tiny_llama(vocab_size=512)
    cfg = tcfg.FrameworkConfig(
        model=mcfg, engine=tcfg.EngineConfig(
            page_size=16, num_pages=512, max_pages_per_seq=32,
            max_batch_size=8, prefill_buckets=(16, 32, 64, 128)),
        server=tcfg.ServerConfig(model_name="tiny-llama", tokenizer="byte"))
    server = InferenceServer(cfg, engine=InferenceEngine(
        mcfg, cfg.engine, device="cuda"))
    port = server.start(host="127.0.0.1", port=0)
    try:
        assert server.engine.telemetry.device_clock is not None
        s0 = _series(server)
        outs: list = []
        t0 = time.perf_counter()
        threads = []
        for i in range(6):
            threads.append(threading.Thread(
                target=_generate,
                args=(port, f"request {i} " * (1 + 3 * i), 40 + 10 * i,
                      outs)))
            threads[-1].start()
            time.sleep(0.02)
        for t in threads:
            t.join(TIMEOUT)
        wall = time.perf_counter() - t0
        s1 = _series(server)
    finally:
        server.shutdown(timeout=60)
    assert len(outs) == 6 and all(o[-1]["done"] for o in outs)

    def d(name):
        return s1.get(name, 0.0) - s0.get(name, 0.0)

    disp = d("tpu_inf_device_dispatch_seconds_total")
    gap = d("tpu_inf_device_gap_seconds_total")
    assert disp > 0.0 and gap > 0.0
    assert disp + gap <= 1.01 * wall, (disp, gap, wall)
    assert d("tpu_inf_decode_launch_seconds_count") == \
        d("tpu_inf_decode_dispatches_total") > 0
    recs = server.engine.telemetry.step_ledger.snapshot()
    assert recs and all(0.0 < r["device_s"] <= wall for r in recs)
