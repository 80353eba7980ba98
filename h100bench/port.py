"""The system under test: the port's HTTP server, built in this process.

The only module of the benchmark that imports ``tpu_inference_torch``.
It maps a configuration file's published keys onto the port's
``ModelConfig`` through the configuration's family (families/), sizes
the engine as the port's CLI does for ``--max-batch-size auto
--num-pages auto --decode-ladder auto`` (engine/autosize.py), and
builds ``InferenceServer`` around an ``InferenceEngine`` given the
benchmark's own weights (weights.py), on 127.0.0.1 at a free port.
"""

from __future__ import annotations

import dataclasses
import urllib.request

from tpu_inference_torch.config import (EngineConfig, FrameworkConfig,
                                        ModelConfig, ServerConfig)
from tpu_inference_torch.engine import autosize
from tpu_inference_torch.engine.engine import InferenceEngine
from tpu_inference_torch.server.http import InferenceServer

from h100bench import families
from h100bench.weights import DTYPES


def model_config(config: dict) -> ModelConfig:
    """The port's ModelConfig of a configuration file: its family's
    fields (families/), its name and its served type."""
    fam = families.of_config(config)
    return ModelConfig(name=config["name"],
                       dtype=DTYPES[config["torch_dtype"]],
                       **fam.port_fields(fam.shape(config), config))


def engine_config(config: dict, mcfg: ModelConfig) -> EngineConfig:
    """The configuration's engine settings, "auto" resolved from the
    card's memory as the CLI resolves it."""
    eng = dict(config["engine"])
    cap = int(eng.pop("batch_cap", 32))     # read by the sizing only
    if "auto" in (eng.get("num_pages"), eng.get("max_batch_size")):
        sz = autosize.auto_size(
            mcfg, quant=eng.get("quant", "none"),
            kv_quant=eng.get("kv_quant", "none"),
            page_size=eng["page_size"],
            max_pages_per_seq=eng["max_pages_per_seq"], batch_cap=cap)
        if eng.get("num_pages") == "auto":
            eng["num_pages"] = sz.num_pages
        if eng.get("max_batch_size") == "auto":
            eng["max_batch_size"] = sz.max_batch_size
    ladder = eng.get("decode_ladder", "off")
    eng["decode_ladder"] = autosize.parse_decode_ladder(
        ladder, eng["max_batch_size"])
    if "prefill_buckets" in eng:
        eng["prefill_buckets"] = tuple(eng["prefill_buckets"])
    return EngineConfig(**eng)


@dataclasses.dataclass
class Served:
    server: InferenceServer
    port: int
    engine_cfg: EngineConfig

    def scrape(self) -> str:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{self.port}/metrics", timeout=60) as r:
            return r.read().decode()

    def close(self) -> None:
        self.server.shutdown()


def serve(config: dict, params: dict, seed: int, device: str) -> Served:
    """Build, warm up and start the server on ``params``."""
    mcfg = model_config(config)
    ecfg = engine_config(config, mcfg)
    engine = InferenceEngine(mcfg, ecfg, params=params, seed=seed,
                             device=device)
    server = InferenceServer(
        FrameworkConfig(model=mcfg, engine=ecfg,
                        server=ServerConfig(model_name=config["name"],
                                            tokenizer="byte", warmup=True),
                        seed=seed),
        engine=engine)
    port = server.start(host="127.0.0.1", port=0)
    return Served(server, port, ecfg)
