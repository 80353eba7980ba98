"""``--tp`` through the port's serving surfaces on the CPU: the HTTP
server, the CLI, the in-process group and the process fleet.

- ``build_server(tp=2)`` answers ``/api/generate`` with the tp 1
  server's greedy text and reports the reference's fields (``/api/ps``
  sizes the whole model once, ``/healthz`` as at tp 1);
- ``--tp 2`` parses and boots, so does ``--sp 2``; ``--num-pages auto``
  with shards (tp or sp) sharing a card is a usage error naming why;
- ``check_server_config`` refuses nothing of dp/tp/sp since 1.16b, only
  a fleet backend that does not exist;
- a dp 2 x tp 2 fleet on either backend, booted from a checkpoint the
  test writes, gives the JAX oracle's tokens (each worker process drives
  its two shards).
"""

import json

import pytest

# The fleet tests' checkpoint, its JAX oracle and helpers.
from tests.test_torch_fleet import (_cfg, _finish, _submit,  # noqa: F401
                                    _want, ckpt, oracle)
from tests.test_torch_server import _get, _post
from tpu_inference_torch import config as tcfg

BODY = {"model": "m", "prompt": "Hello shards", "temperature": 0.0,
        "max_tokens": 12, "stream": False}
SMALL = dict(num_pages=64, page_size=8, max_pages_per_seq=16,
             max_batch_size=4, prefill_buckets=(16, 32))


def _serve(**kw):
    from tpu_inference_torch.server.http import build_server

    server = build_server("tiny-llama", warmup=False, device="cpu", **SMALL,
                          **kw)
    return server, server.start(host="127.0.0.1", port=0)


def test_build_server_tp2_answers_with_the_tp1_text():
    out = {}
    for tp in (1, 2):
        server, port = _serve(tp=tp)
        try:
            assert server.engine.tp == tp
            status, _, raw = _post(port, BODY)
            assert status == 200
            body = json.loads(raw)
            assert body["done_reason"] == "length"
            out[tp] = {"text": body["response"],
                       "context": body["context"],
                       "ps": json.loads(_get(port, "/api/ps")[2]),
                       "health": json.loads(_get(port, "/healthz")[2])}
        finally:
            server.shutdown(timeout=30.0)
    assert out[2]["text"] == out[1]["text"]
    assert out[2]["context"] == out[1]["context"]
    # The reference's fields: one model copy's bytes, the replica count.
    assert out[2]["ps"] == out[1]["ps"]
    assert out[2]["health"]["status"] == "ok"
    assert set(out[2]["health"]) == set(out[1]["health"])


def test_cli_tp_flags(capsys):
    from tpu_inference_torch.server.__main__ import (boot_server,
                                                    build_parser)

    p = build_parser()
    args = p.parse_args(["--tp", "2", "--sp-attn", "ulysses"])
    assert (args.tp, args.sp, args.sp_attn) == (2, 1, "ulysses")
    base = ["--device", "cpu", "--model", "tiny-llama", "--no-warmup",
            "--host-cache-pages", "0"]
    with pytest.raises(SystemExit):
        boot_server(p.parse_args(base + ["--sp", "2", "--num-pages",
                                         "auto"]), p)
    assert "sp shards share a card" in capsys.readouterr().err
    server, _ = boot_server(p.parse_args(
        base + ["--sp", "2", "--sp-attn", "ulysses", "--num-pages", "64",
                "--max-pages-per-seq", "16"]), p)
    try:
        assert (server.engine.tp, server.engine.sp) == (1, 2)
        assert server.engine.engine_cfg.sp_attn == "ulysses"
    finally:
        server.shutdown(timeout=30.0)
    with pytest.raises(SystemExit):
        boot_server(p.parse_args(base + ["--tp", "2", "--num-pages",
                                         "auto"]), p)
    assert "tp shards share a card" in capsys.readouterr().err
    server, engine_args = boot_server(p.parse_args(
        base + ["--tp", "2", "--num-pages", "64", "--max-pages-per-seq",
                "16"]), p)
    try:
        assert server.engine.tp == 2 and engine_args["sp_attn"] == "ring"
        assert len(server.engine.kv.shards) == 2
    finally:
        server.shutdown(timeout=30.0)


def test_check_server_config_refuses_only_sp():
    from tpu_inference_torch.server.http import check_server_config

    for dp, tp, sp in ((1, 2, 1), (2, 2, 1), (4, 1, 1), (1, 2, 2),
                       (2, 1, 2)):
        check_server_config(tcfg.FrameworkConfig(
            parallel=tcfg.ParallelConfig(dp=dp, tp=tp, sp=sp)))
    with pytest.raises(ValueError, match="unknown fleet backend"):
        check_server_config(tcfg.FrameworkConfig(
            parallel=tcfg.ParallelConfig(tp=2, sp=2),
            server=tcfg.ServerConfig(fleet="threads")))


@pytest.mark.parametrize("fleet", ["in-process", "subprocess"])
def test_dp2_tp2_fleet_gives_the_oracle_tokens(fleet, ckpt, oracle):
    """dp 2 x tp 2 from the checkpoint on both backends: every replica
    loads its shards per shard (load_checkpoint(mesh=)), the envelope
    names a worker's two shard devices, and the tokens are the dp 1
    oracle's."""
    from tpu_inference_torch.server.http import build_engine_group

    cfg = _cfg(ckpt, fleet=fleet)
    cfg.parallel = tcfg.ParallelConfig(dp=2, tp=2)
    group = build_engine_group(cfg, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5, 4, 3, 2, 1, 9, 8],
               list(range(20, 33))]
    try:
        if fleet == "subprocess":
            assert group._envelope(1)["devices"] == ["cpu", "cpu"]
        else:
            assert all(e.tp == 2 for e in group.engines)
        group.start()
        pend = [_submit(group, i, p, 10) for i, p in enumerate(prompts)]
        outs = []
        for toks, done, box in pend:
            assert _finish(done, box).finish_reason == "length"
            outs.append(toks)
        assert outs == [_want(oracle, p, 10) for p in prompts]
    finally:
        group.stop(drain=False)
