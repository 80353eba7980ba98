"""The three port faults found against the reference, each held to the
reference's own behaviour:

- the dp=1 group's supervision series carry the reference EngineGroup's
  names and labels (``tpu_inf_replicas``, ``tpu_inf_replica_routable``,
  ``tpu_inf_replica_quarantines_total``, the retry and failover
  counters), and the port exports no supervision series the reference
  lacks;
- ``tpu_inf_decode_stall_during_prefill_seconds`` is registered, and
  observed for each serial chunked-prefill dispatch that runs while
  decode lanes are active (and only then);
- ``--quarantine-after``, ``--quarantine-cooldown-s`` and
  ``--default-class`` parse to the reference CLI's defaults and reach
  ``ServerConfig``.
"""

import re

import pytest

from tpu_inference import config as jcfg
from tpu_inference.engine.engine import InferenceEngine as JEngine
from tpu_inference.server.replicas import EngineGroup as JGroup
from tpu_inference_torch import config as tcfg
from tpu_inference_torch.engine.engine import Sequence
from tpu_inference_torch.server.replicas import EngineGroup
from tests.test_torch_ladder import pair, port_engine, prompts_of
from tests.test_torch_server import _reference_parser

# Series the reference's EngineGroup exports only with a fleet behind it
# (spans, routing, the KV fabric, poison quarantine, SLO windows, ...):
# nothing of them exists in the port before ROADMAP 1.15/1.18.
SUPERVISION = ("tpu_inf_replicas", "tpu_inf_replica_routable",
               "tpu_inf_replica_quarantines_total",
               "tpu_inf_replica_wedges_total",
               "tpu_inf_retries_attempted_total",
               "tpu_inf_retries_succeeded_total", "tpu_inf_failovers_total",
               "tpu_inf_requests_shed_total",
               "tpu_inf_requests_unavailable_total")

_SAMPLE = re.compile(r"^([a-z_:]+)(\{[^}]*\})? ", re.M)


def _series(text: str, names) -> set:
    """{(name, labels)} of the samples of ``names`` in a /metrics text."""
    return {(m.group(1), m.group(2) or "") for m in _SAMPLE.finditer(text)
            if m.group(1) in names}


def _families(text: str) -> set:
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def test_dp1_supervision_series_match_reference():
    ecfg = dict(page_size=8, num_pages=64, max_pages_per_seq=8,
                max_batch_size=4, prefill_buckets=(16,))
    jm, params, _, _ = pair()
    jgroup = JGroup([JEngine(jm, jcfg.EngineConfig(**ecfg), params=params,
                             attn_backend="dense")], jcfg.ServerConfig())
    group = EngineGroup([port_engine(**ecfg)], tcfg.ServerConfig())
    want_text, got_text = jgroup.prometheus_text(), group.prometheus_text()
    assert _families(want_text) >= set(SUPERVISION)
    assert _series(got_text, SUPERVISION) == _series(want_text, SUPERVISION)
    assert ('tpu_inf_replica_routable', '{replica="0"}') in _series(
        got_text, SUPERVISION)
    # Every series the port's supervision registry exports is one the
    # reference exports too (tpu_inf_replica_healthy is gone).
    fleet = group._fleet_registry
    names = {m.name for m in fleet.collect()}
    assert names <= _families(want_text), names - _families(want_text)
    assert "tpu_inf_replica_healthy" not in got_text


def test_quarantine_counter_moves():
    group = EngineGroup([port_engine(page_size=8, num_pages=64,
                                     max_pages_per_seq=8, max_batch_size=4,
                                     prefill_buckets=(16,))],
                        tcfg.ServerConfig(quarantine_after_failures=2))
    for _ in range(2):
        group.health[0].on_error()
    text = group.prometheus_text()
    assert 'tpu_inf_replica_quarantines_total{replica="0"} 1' in text
    assert 'tpu_inf_replica_routable{replica="0"} 0' in text


def _stall_run(eng, seq_cls) -> list:
    """Stall observations after each phase: a 70-token prompt alone
    (three 32-token chunks, no lane waiting), then two short prompts
    decoding, then another 70-token prompt beside them."""
    hist = eng.telemetry.decode_stall_during_prefill_s
    counts = []
    eng.generate(prompts_of(1, seed=3, length=70), max_new_tokens=2)
    counts.append(sum(hist._counts))
    for i, p in enumerate(prompts_of(2)):
        eng.prefill(seq_cls(request_id=i, prompt_tokens=p,
                            max_new_tokens=40))
    eng.decode_steps()
    assert len(eng.active_sequences()) == 2
    eng.prefill(seq_cls(request_id=9, max_new_tokens=2,
                        prompt_tokens=prompts_of(1, seed=4, length=70)[0]))
    counts.append(sum(hist._counts))
    return counts


def test_decode_stall_observed_for_chunks_beside_active_lanes():
    """Each serial prefill chunk dispatched while decode lanes are active
    is one observation; a prompt prefilled alone makes none. The
    reference engine observes the same."""
    from tpu_inference.engine.engine import Sequence as JSequence

    ecfg = dict(page_size=8, num_pages=64, max_pages_per_seq=16,
                max_batch_size=4, prefill_buckets=(16, 32))
    jm, params, _, _ = pair()
    want = _stall_run(JEngine(jm, jcfg.EngineConfig(**ecfg), params=params,
                              attn_backend="dense"), JSequence)
    eng = port_engine(**ecfg)
    # The second short prompt's one chunk (the first short lane is
    # active by then) and the long prompt's three.
    assert _stall_run(eng, Sequence) == want == [0, 4]
    assert eng.telemetry.decode_stall_during_prefill_s.sum > 0


def test_decode_stall_series_in_metrics_text():
    from tpu_inference_torch import telemetry

    eng = port_engine(page_size=8, num_pages=64, max_pages_per_seq=8,
                      max_batch_size=4, prefill_buckets=(16,))
    text = telemetry.render_prometheus([({}, eng.telemetry.registry)])
    assert "# TYPE tpu_inf_decode_stall_during_prefill_seconds histogram" \
        in text


@pytest.mark.parametrize("flags", [
    [],
    ["--quarantine-after", "5", "--quarantine-cooldown-s", "2.5",
     "--default-class", "batch"],
])
def test_supervision_flags_match_reference_and_reach_server_config(
        flags, monkeypatch):
    from tpu_inference_torch.server.__main__ import (build_parser,
                                                    server_overrides)
    ref = _reference_parser(monkeypatch)
    want, got = ref.parse_args(flags), build_parser().parse_args(flags)
    for name in ("quarantine_after", "quarantine_cooldown_s",
                 "default_class"):
        assert getattr(got, name) == getattr(want, name), name
    cfg = tcfg.ServerConfig(**server_overrides(got))
    assert (cfg.quarantine_after_failures, cfg.quarantine_cooldown_s,
            cfg.default_class) == (want.quarantine_after,
                                   want.quarantine_cooldown_s,
                                   want.default_class)


def test_default_class_flag_rejects_unknown_class():
    from tpu_inference_torch.server.__main__ import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--default-class", "urgent"])
