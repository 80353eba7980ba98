"""The port's elastic fleet with real worker processes on the CPU (twins
of tests/test_elastic.py's process cases): a scale-up on a sustained
TTFT breach racing a ``kill -9`` (no second spawn), a lossless
scale-down of the coldest worker, a rolling upgrade under traffic with
a SIGTERM thrown at an original worker, and the worker's cancel verb
freeing a preempted request's pages mid-prefill and mid-decode. Workers
boot from a checkpoint the test writes; the JAX engine on the same
weights is the oracle. After each fleet stops, no worker process of any
incarnation is left.
"""

import os
import re
import threading
import time

import pytest

from tests.test_torch_elastic import _cfg, _finish, _submit, _wait, _want
from tests.test_torch_fleet import ckpt, oracle  # noqa: F401 — fixtures


def _pids(group, seen):
    seen |= {h.pid for h in group.workers if h.pid}
    return seen


def _assert_gone(pids):
    deadline = time.monotonic() + 30
    alive = set(pids)
    while alive and time.monotonic() < deadline:
        for pid in list(alive):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                alive.discard(pid)
        time.sleep(0.05)
    assert not alive, f"worker processes {sorted(alive)} outlived the fleet"


def test_autoscale_up_with_kill9_no_double_spawn(ckpt, oracle):
    """A sustained TTFT breach scales up once; a kill -9 thrown at the
    fleet then restarts its victim (supervision) instead of a second
    scale-up; the stream fails over byte-identically and the counters
    stay monotone."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(
        ckpt, dp=1, autoscale=True, autoscale_breach_window_s=0.5,
        autoscale_cooldown_s=1.0, autoscale_max_replicas=2,
        autoscale_low_watermark=0.0,     # never scale down here
        engine_kw={"slo_ttft_ms": 1}), device="cpu")   # every one breaches
    group.start()
    pids = set()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        for i in range(3):
            toks, done, box = _submit(group, 10 + i, [1, 2, i], 6)
            _finish(done, box)
        _wait(lambda: len(group.workers) == 2
              and group.workers[1].state == "up",
              timeout=90.0, what="scale-up")
        assert group.scale_ups == 1
        assert group.workers[1].boot_walls
        assert group.trace_snapshot("scale-up-1") is not None
        text = group.prometheus_text()
        assert re.search(r"tpu_inf_fleet_scale_ups_total 1\b", text)
        assert re.search(r'tpu_inf_worker_up\{replica="1"\} 1', text)
        _pids(group, pids)

        restarts_before = sum(h.restarts for h in group.workers)
        toks, done, box = _submit(group, 50, [4, 4, 4], 24)
        group.apply_chaos({"replica": 0, "kill": "kill9"})
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, [4, 4, 4], 24)
        _wait(lambda: group.workers[0].state == "up", what="heal")
        _pids(group, pids)
        time.sleep(2.5)   # past the cooldown: the max caps the breach
        assert len(group.workers) == 2     # a restart, not a third spawn
        sup = group.supervision_counters()
        assert sup["scale_ups"] == 1 and sup["scale_downs"] == 0
        assert sum(h.restarts for h in group.workers) > restarts_before
    finally:
        group.stop(drain=False)
    _assert_gone(pids)


def test_scale_down_retires_coldest(ckpt, oracle):
    """A lossless scale-down: the idle worker drains and retires (state
    retired, out of tpu_inf_replicas and of /healthz's status), while
    the busy worker's stream runs to completion."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=2), device="cpu")
    group.start()
    pids = set()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        _pids(group, pids)
        prompt = [2, 4, 6, 8]
        toks, done, box = _submit(group, 1, prompt, 48)
        time.sleep(0.3)
        with group._lock:
            busy = group._tracked[1].worker if 1 in group._tracked else None
        group._scale_down("test")
        retired = [h for h in group.workers
                   if h.retiring or h.state == "retired"]
        assert len(retired) == 1 and retired[0] is not busy
        _wait(lambda: retired[0].state == "retired", what="retire")
        assert retired[0].proc.poll() is not None
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, prompt, 48)
        assert group.scale_downs == 1 and retired[0].restarts == 0
        assert len(group._live_workers()) == 1
        hs = group.health_snapshot()
        assert hs["status"] == "ok"
        assert hs["replicas"][retired[0].replica]["worker_state"] == \
            "retired"
        text = group.prometheus_text()
        assert re.search(r"tpu_inf_fleet_scale_downs_total 1\b", text)
        m = re.search(r"^tpu_inf_replicas (\S+)$", text, re.M)
        assert m and float(m.group(1)) == 1.0
        assert group.trace_snapshot("scale-down-1") is not None
    finally:
        group.stop(drain=False)
    _assert_gone(pids)


def test_rollout_under_traffic_with_sigterm_chaos(ckpt, oracle):
    """A rolling upgrade under traffic with a SIGTERM thrown at an
    original worker mid-pass: the stream completes byte-identically, the
    pass finishes with nothing failed, a second pass meanwhile is
    refused, the successors serve, and no process of any incarnation
    outlives the fleet."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=2), device="cpu")
    group.start()
    pids = set()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        _pids(group, pids)
        prompt = [1, 3, 5, 7, 9]
        toks, done, box = _submit(group, 1, prompt, 48)
        res_box = {}
        th = threading.Thread(
            target=lambda: res_box.update(res=group.rollout()))
        th.start()
        time.sleep(0.3)
        assert group._rollout_lock.locked()
        with pytest.raises(ValueError, match="already in progress"):
            group.rollout()
        try:
            group.apply_chaos({"replica": 0, "kill": "sigterm"})
        except ValueError:
            pass                          # already exited after a drain
        while th.is_alive():
            _pids(group, pids)
            th.join(timeout=0.2)
        res = res_box["res"]
        fin = _finish(done, box)
        assert fin.finish_reason == "length"
        assert toks == _want(oracle, prompt, 48)
        assert res["replaced"] and not res["failed"]
        assert set(res) == {"replaced", "failed", "live", "wall_s"}
        assert group.rollouts == 1
        assert group.trace_snapshot("rollout-1") is not None
        _wait(lambda: any(h.state == "up" and h.replica >= 2
                          for h in group.workers), what="successor up")
        toks2, done2, box2 = _submit(group, 2, [7, 7, 7], 10)
        fin2 = _finish(done2, box2)
        assert fin2.finish_reason == "length"
        assert toks2 == _want(oracle, [7, 7, 7], 10)
        text = group.prometheus_text()
        assert re.search(r"tpu_inf_fleet_rollouts_total 1\b", text)
        _pids(group, pids)
    finally:
        group.stop(drain=False)
    _assert_gone(pids)


@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_worker_cancel_frees_pages(ckpt, when):
    """The cancel a preemption sends, over the RPC, while the worker's
    engine thread is inside a prefill call (held there by the chaos
    wedge) or mid-decode: the worker's pool is clean after."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=1), device="cpu")
    group.start()
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        h = group.workers[0]
        if when == "prefill":
            group.apply_chaos({"step_wedge_s": 0.8})
        toks, done, box = _submit(group, 1, list(range(3, 40)), 24)
        if when == "prefill":
            time.sleep(0.3)
            assert not toks
        else:
            _wait(lambda: len(toks) >= 4, what="decode")
        h.client.rpc("cancel", rid=1)
        group.apply_chaos({"step_wedge_s": 0.0})
        _wait(lambda: h.client.rpc("healthz")["load"] == 0,
              what="the cancelled request reaped")
        snap = h.client.rpc("debug", clear=True)
        assert not snap["pipeline_pending"] and snap["slots_bound"] == 0
        assert snap["refs_held"] == 0 and snap["evictable_count"] == 0
        assert snap["num_free"] == snap["num_pages"] - 1, snap
        assert len(toks) < 24
    finally:
        group.stop(drain=False)


def test_stop_during_a_scale_up_boot_leaves_no_process(ckpt):
    """A fleet stopped while a scale-up's worker boots stops that process
    too (it would otherwise serve on after its hello, unrouted)."""
    from tpu_inference_torch.server.fleet import ProcessEngineGroup

    group = ProcessEngineGroup(_cfg(ckpt, dp=1), device="cpu")
    group.start()
    pids = set()
    th = threading.Thread(target=group._scale_up, args=("test",))
    try:
        _wait(lambda: all(h.state == "up" for h in group.workers),
              what="fleet up")
        _pids(group, pids)
        th.start()
        _wait(lambda: len(group.workers) == 2
              and group.workers[1].proc is not None, what="a boot")
        assert group.workers[1].state == "booting"
        _pids(group, pids)
    finally:
        group.stop(drain=False)
    th.join(timeout=60.0)
    assert not th.is_alive()
    assert group.workers[1].state in ("dead", "restarting")
    _assert_gone(pids)
