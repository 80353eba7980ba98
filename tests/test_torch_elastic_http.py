"""The elastic fleet's HTTP and CLI surfaces on the CPU against the
reference: ``POST /debug/rollout`` (404 without debug, 400 on the
in-process fleet, 409 while a pass runs, the pass's JSON on the process
fleet); the eight elastic flags parsed as the reference's parser parses
them and carried into ServerConfig; the two ``--autoscale`` usage
errors; and the six elastic series rendered with the reference's names,
types, help text and labels.
"""

import json
import threading

import pytest

from tests import _prom
from tests.test_torch_elastic import _cfg, _wait
from tests.test_torch_fleet import _get, _post
from tests.test_torch_fleet import ckpt  # noqa: F401 — fixture
from tpu_inference_torch import config as tcfg

_ELASTIC_FLAGS = ("autoscale", "autoscale_min", "autoscale_max",
                  "autoscale_breach_window_s", "autoscale_cooldown_s",
                  "autoscale_low_watermark", "autoscale_idle_window_s",
                  "class_queue_depth")


def test_debug_rollout_route(ckpt):
    """404 without debug; 400 naming the process fleet in-process; on the
    process fleet, the pass's JSON, and 409 for a second POST while it
    runs."""
    from tpu_inference_torch.server.http import InferenceServer

    server = InferenceServer(_cfg(ckpt, dp=1, fleet="in-process"),
                             device="cpu")
    port = server.start(host="127.0.0.1", port=0)
    try:
        status, _ = _post(port, {}, "/debug/rollout")
        assert status == 404
    finally:
        server.shutdown(timeout=30.0)
    server = InferenceServer(_cfg(ckpt, dp=1, fleet="in-process",
                                  enable_debug=True), device="cpu")
    port = server.start(host="127.0.0.1", port=0)
    try:
        status, raw = _post(port, {}, "/debug/rollout")
        assert status == 400
        assert json.loads(raw) == {
            "error": "rolling upgrades need --fleet subprocess"}
    finally:
        server.shutdown(timeout=30.0)
    server = InferenceServer(_cfg(ckpt, dp=1, enable_debug=True),
                             device="cpu")
    port = server.start(host="127.0.0.1", port=0)
    try:
        group = server.group
        box = {}
        th = threading.Thread(target=lambda: box.update(
            first=_post(port, {}, "/debug/rollout")))
        th.start()
        _wait(group._rollout_lock.locked, what="the pass under way")
        status, raw = _post(port, {}, "/debug/rollout")
        assert status == 409
        assert json.loads(raw) == {
            "error": "a rollout is already in progress"}
        th.join(timeout=120.0)
        assert not th.is_alive()
        status, raw = box["first"]
        assert status == 200
        res = json.loads(raw)
        assert set(res) == {"replaced", "failed", "live", "wall_s"}
        assert res["failed"] == [] and res["live"] == 1
        assert res["replaced"] == [{"old": 0, "new": 1,
                                    "old_state": "retired"}]
        status, raw = _post(port, {"model": "t", "prompt": "after",
                                   "temperature": 0.0, "max_tokens": 4,
                                   "stream": False})
        assert status == 200 and json.loads(raw)["eval_count"] == 4
        hz = json.loads(_get(port, "/healthz")[1])
        assert hz["status"] == "ok"
        assert [r["worker_state"] for r in hz["replicas"]] == \
            ["retired", "up"]
    finally:
        server.shutdown(timeout=30.0)


@pytest.mark.parametrize("argv", [
    [],
    ["--dp", "2", "--fleet", "subprocess", "--autoscale", "--slo-ttft-ms",
     "800"],
    ["--dp", "2", "--fleet", "subprocess", "--autoscale", "--autoscale-min",
     "2", "--autoscale-max", "3", "--autoscale-breach-window-s", "1",
     "--autoscale-cooldown-s", "3", "--autoscale-low-watermark", "0.1",
     "--autoscale-idle-window-s", "2", "--slo-tpot-ms", "90"],
    ["--admission-queue-depth", "4", "--class-queue-depth", "16",
     "--default-class", "batch"],
])
def test_elastic_flags_match_reference(argv, monkeypatch):
    """The eight elastic flags parse to the reference's defaults and
    values, and reach ServerConfig."""
    from tests.test_torch_server import _reference_parser
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    server_overrides)
    want = _reference_parser(monkeypatch).parse_args(argv)
    got = build_parser().parse_args(argv)
    for name in _ELASTIC_FLAGS + ("default_class",):
        assert getattr(got, name) == getattr(want, name), name
    scfg = tcfg.ServerConfig(**server_overrides(got))
    assert (scfg.autoscale, scfg.autoscale_min_replicas,
            scfg.autoscale_max_replicas, scfg.autoscale_breach_window_s,
            scfg.autoscale_cooldown_s, scfg.autoscale_low_watermark,
            scfg.autoscale_idle_window_s, scfg.class_queue_depth) == \
        tuple(getattr(want, n) for n in _ELASTIC_FLAGS)


@pytest.mark.parametrize("argv,message", [
    (["--autoscale", "--slo-ttft-ms", "500"],
     "--autoscale needs --fleet subprocess"),
    (["--dp", "2", "--fleet", "subprocess", "--autoscale"],
     "--autoscale needs an SLO target to scale on"),
])
def test_autoscale_usage_errors(argv, message, capsys):
    """The reference's two usage errors, before any model loads."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    with pytest.raises(SystemExit):
        boot_server(p.parse_args(["--device", "cpu", "--no-warmup",
                                  *argv]), p)
    assert message in capsys.readouterr().err


def test_cli_boots_an_elastic_fleet():
    """``--autoscale`` and ``--class-queue-depth`` on the process fleet
    are served: the router holds them (no worker boots before start),
    and the in-process fleet takes a class depth without lanes, as the
    reference's does."""
    from tpu_inference_torch.server.__main__ import boot_server, build_parser
    p = build_parser()
    for argv, fleet in (
            (["--dp", "2", "--fleet", "subprocess", "--autoscale",
              "--autoscale-max", "3", "--slo-ttft-ms", "700",
              "--admission-queue-depth", "2", "--class-queue-depth", "8"],
             "subprocess"),
            (["--admission-queue-depth", "2", "--class-queue-depth", "8"],
             "in-process")):
        server, _ = boot_server(p.parse_args(
            ["--device", "cpu", "--no-warmup", "--num-pages", "64",
             "--max-pages-per-seq", "8", *argv]), p)
        try:
            scfg = server.cfg.server
            assert scfg.fleet == fleet and scfg.class_queue_depth == 8
            assert scfg.autoscale == (fleet == "subprocess")
            assert hasattr(server.group, "rollout") == \
                (fleet == "subprocess")
        finally:
            server.group.stop(drain=False)


def test_elastic_series_match_reference():
    """register_fleet_elastic on both sides over the same counts: the
    same six names with the same types, help text, labels and values
    (shed for every class, preempted and deferred for the lower two)."""
    from tpu_inference import telemetry as jtel
    from tpu_inference_torch import telemetry as ttel

    counts = {"preempted": {"batch": 3, "background": 1},
              "deferred": {"batch": 2, "background": 0},
              "shed": {"interactive": 0, "batch": 4, "background": 5}}
    pages = []
    for tel in (jtel, ttel):
        r = tel.Registry()
        tel.register_fleet_elastic(
            r, scale_ups=lambda: 2, scale_downs=lambda: 1,
            rollouts=lambda: 1,
            class_preempted=lambda c: counts["preempted"].get(c, 0),
            class_deferred=lambda c: counts["deferred"].get(c, 0),
            class_shed=lambda c: counts["shed"].get(c, 0))
        meta, samples = _prom.parse(tel.render_prometheus([({}, r)]))
        # The renderer's own timing histogram is not an elastic series.
        keep = lambda n: not n.startswith("tpu_inf_metrics_render")
        pages.append(({n: m for n, m in meta.items() if keep(n)},
                      sorted((n, tuple(sorted(lab.items())), v)
                             for n, lab, v in samples if keep(n))))
    assert pages[1] == pages[0]
    meta, samples = pages[1]
    assert {n for n, _, _ in samples} == {
        "tpu_inf_fleet_scale_ups_total", "tpu_inf_fleet_scale_downs_total",
        "tpu_inf_fleet_rollouts_total", "tpu_inf_class_shed_total",
        "tpu_inf_class_preempted_total", "tpu_inf_class_deferred"}
    assert len(samples) == 10
    assert meta["tpu_inf_class_deferred"]["type"] == "gauge"


def test_elastic_knobs_build_and_the_rest_names_1_15b(ckpt):
    """Autoscale and class lanes build a router on the process fleet, on
    the shm plane too (1.15b is whole: nothing of it is refused), and an
    in-process fleet asked for the shm plane builds on the relay plane.
    The refusal that stays (sp > 1) names 1.16b."""
    from tpu_inference_torch.server.http import build_engine_group

    group = build_engine_group(_cfg(ckpt, autoscale=True,
                                    class_queue_depth=4, kv_plane="shm",
                                    shm_arena_bytes=1 << 20), device="cpu")
    try:
        assert group.server_cfg.autoscale and group.dp == 2
        assert group.server_cfg.class_queue_depth == 4
        assert not group._started
        # Regions for twice the boot-time fleet: a scale-up's worker at
        # replica 2 or 3 still gets one, one past them relays.
        assert group.arena is not None and group.arena.regions == 4
        assert group.arena.region_spec(3)["region"] == 3
        assert group.arena.region_spec(4) is None
        assert group._envelope(1)["shm"]["region"] == 1
    finally:
        group.stop(drain=False)
    group = build_engine_group(_cfg(ckpt, fleet="in-process",
                                    kv_plane="shm"), device="cpu")
    try:
        assert not hasattr(group, "arena")
    finally:
        group.stop(drain=False)
    cfg = _cfg(ckpt, autoscale=True)
    cfg.parallel = tcfg.ParallelConfig(dp=2, sp=2)
    with pytest.raises(NotImplementedError, match=r"ROADMAP 1\.16b\)"):
        build_engine_group(cfg, device="cpu")
