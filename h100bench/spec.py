"""Find a cell's configuration, traffic mix, cell parameters and metric
readers by the names that ``BENCHMARK.json`` gives them.

Nothing here imports the port: the reference and the CPU tests read the
same files.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json, the cell's own keys over it
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    names = metric.get("workloads")
    return names is None or cell in names


def load_cell(name: str, bench_path: str = "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark file at ``bench_path``. Raises
    KeyError for a name the file does not hold."""
    bench = read_json(bench_path)
    root = os.path.dirname(os.path.abspath(bench_path))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = read_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    cell_file = os.path.join(HERE, "cells", f"{name}.json")
    if os.path.exists(cell_file):
        traffic = {**traffic, **read_json(cell_file)}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_shape(config: dict) -> dict:
    """The sizes the reference, the flops count and the weights need,
    from a configuration file's published keys (Hugging Face names)."""
    experts = int(config.get("num_local_experts") or 0)
    heads = int(config["num_attention_heads"])
    d = int(config["hidden_size"])
    return {
        "vocab": int(config["vocab_size"]),
        "d": d,
        "layers": int(config["num_hidden_layers"]),
        "heads": heads,
        "kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config.get("head_dim") or d // heads),
        "d_ff": int(config["intermediate_size"]),
        "experts": experts,
        "top_k": int(config.get("num_experts_per_tok") or 0),
        "window": int(config.get("sliding_window") or 0),
        "rope_theta": float(config["rope_theta"]),
        "eps": float(config["rms_norm_eps"]),
        "max_context": int(config["max_position_embeddings"]),
        "dtype": config.get("torch_dtype", "bfloat16"),
    }
