"""BENCHMARK.json keeps the form its checker reads: the keys, names,
units, bounds, paths and the budget of a full check with 24 cells."""

import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_entry_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    for group, keys in KEYS.items():
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, (group, e["name"])


def test_names_units_and_lines():
    names = []
    for group in KEYS:
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)
    assert len(names) == len(set(names))
    assert all(_line(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_paths_and_files():
    assert BENCH["paths"] == ["h100bench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("h100bench/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank",
                                                     "_size"))


def test_cells_report_enough_and_fit_the_budget():
    e2e = BENCH["end_to_end"]
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        own = [m["name"] for m in e2e
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in own and len(own) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
        assert os.path.exists(os.path.join(
            ROOT, "h100bench/traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            ROOT, "h100bench/cells", w["name"] + ".json"))
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
