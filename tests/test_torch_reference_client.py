"""The reference's own client, byte for byte, against the port's server.

Twin of tests/test_reference_client_verbatim.py: the vendored client
(tests/fixtures/reference_client_verbatim.py, unchanged) replays the
first rows of data/trace1.csv against the port's ``InferenceServer`` on
the CPU, at that test's engine sizes, with only its module-level
``config`` retargeted. It runs twice: over one engine, and over a
1 prefill + 1 decode subprocess fleet, where each request's first token
(and with it the response headers) comes from the prefill worker and
the rest from the decode worker after the live KV handoff. Each run
asserts what the reference test asserts: one log record per trace row
with the reference's field set (``REFERENCE_LOG_FIELDS``), every request
a success, and the causal order request sent <= headers received <=
first token <= end (the server holds its headers until the first
token).
"""

from __future__ import annotations

import json
import os

import pytest

from tests.test_reference_client_verbatim import (N_TRACE, REFERENCE_LOG_FIELDS,
                                                  REPO,
                                                  _import_reference_client)

# tests/test_reference_client_verbatim.py's sizes: prompts clamp to the
# client's 1024 byte tokens, plus its 200 decode tokens.
ENGINE = dict(page_size=16, num_pages=448, max_pages_per_seq=128,
              max_batch_size=4, prefill_buckets=(256, 1024))


def _start_server(topology: str):
    from tpu_inference_torch.server.http import build_server

    kw = {}
    if topology == "pd":
        kw = dict(dp=2, server_overrides=dict(
            fleet="subprocess", worker_roles=("prefill", "decode"),
            worker_restart_backoff_s=0.1))
    srv = build_server(model="tiny-llama", tokenizer="byte", warmup=False,
                       device="cpu", **ENGINE, **kw)
    return srv, srv.start(host="127.0.0.1", port=0)


@pytest.mark.parametrize("topology", ["engine", "pd"])
def test_reference_client_replays_against_the_port(topology, tmp_path,
                                                   monkeypatch):
    # One interpreter thread per worker process (the test's fleet must
    # not oversubscribe the machine).
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    mod = _import_reference_client()
    srv, port = _start_server(topology)
    log_path = tmp_path / "log.json"
    try:
        # The only permitted change: retarget the module-level config.
        mod.config.update({
            "trace_path": os.path.join(REPO, "data", "trace1.csv"),
            "data_path": os.path.join(REPO, "data", "conversations.json"),
            "max_trace": N_TRACE,
            "url": f"http://127.0.0.1:{port}/api/generate",
            "model": "tiny-llama",
            "save_log": True,
            "log_path": str(log_path),
        })
        # Statement for statement, the client's own __main__ block.
        data = mod.DataLoader().get_data_from_path(
            data_path=mod.config["data_path"])
        schedule = mod.Scheduler().get_schedule_from_trace(
            trace_path=mod.config["trace_path"],
            max_trace=mod.config["max_trace"])
        logger = mod.MetricCollector()
        mod.logger = logger
        generator = mod.TrafficGenerator(data=data, schedule=schedule,
                                         config=mod.config, logger=logger)
        generator.start_profile()
        logger.save(path=mod.config["log_path"])
        if topology == "pd":
            # Every request went through the live handoff, none
            # recomputed.
            group = srv.group
            assert group.pd_handoffs == N_TRACE
            assert group.pd_handoff_recomputes == 0
    finally:
        srv.shutdown()

    saved = json.loads(log_path.read_text())
    assert set(saved) == {str(i) for i in range(N_TRACE)}
    for qid, rec in saved.items():
        assert set(rec) == REFERENCE_LOG_FIELDS, (
            f"query {qid}: log schema mismatch: {sorted(rec)}")
        assert rec["success"] is True, f"query {qid} failed"
        assert (rec["scheduled_start_time"] <= rec["request_start_time"]
                <= rec["response_headers_received_time"]
                <= rec["first_token_arrive_time"]
                <= rec["response_end_time"])
        assert rec["number_of_input_tokens"] > 0
