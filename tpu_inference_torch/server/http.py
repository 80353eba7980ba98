"""Ollama-protocol HTTP server over the port's engine replicas.

Twin of ``tpu_inference/server/http.py`` on the standard library's
threading HTTP server (one thread per connection; the engine runs on its
own scheduler thread). Wire contract, as the reference's:

- ``POST /api/generate`` with JSON ``{"model", "prompt", "temperature",
  "max_tokens", "stream"}``; ``options.temperature`` /
  ``options.num_predict`` (and top_p, top_k, seed, repeat_penalty,
  repeat_last_n, stop) are honored too.
- stream=true: ``200`` with ``Content-Type: application/x-ndjson`` and
  chunked transfer; one JSON line per text delta
  ``{"model", "created_at", "response", "done": false}``; the terminal
  line adds ``done_reason``, ``context`` (token ids) and the ns-duration
  counters ``total_duration, load_duration, prompt_eval_count,
  prompt_eval_duration, eval_count, eval_duration``.
- stream=false: one JSON object, ``response`` = full text + same counters.
- **Headers are withheld until the first token is ready**, so client-side
  TTFT (first streamed chunk ~ header arrival) measures model latency.

- ``POST /api/chat`` with ``{"model", "messages": [{"role", "content"},
  ...], "stream", "options"}``: the messages render through the
  tokenizer's chat template when it has one, else as the transcript
  ``"role: content\n...\nassistant:"``; records carry ``message``
  (``{"role": "assistant", "content"}``) and no ``response`` or
  ``context``; ``messages: []`` is the load probe.
- ``POST /api/embeddings`` (``{"prompt": str}`` -> ``{"embedding"}``)
  and ``POST /api/embed`` (``{"input": str | [str]}`` -> ``{"model",
  "embeddings"}``): mean-pooled final hidden states (the shape follows
  the route, not the body).
- ``POST /api/show`` (the model card) and ``GET /api/ps`` (the loaded
  model), ``GET /api/tags``, ``/api/version``, ``/healthz`` and
  ``/metrics`` (Prometheus text; ``?format=json`` for the stats
  snapshot).

Fault injection: ``ServerConfig.chaos_delay_s`` / ``chaos_failure_rate``
delay or 503 a generate, chat or embed request before it is parsed
(``chaos_gate``). With ``enable_debug``: ``POST /debug/chaos`` arms the
engine's faults at run time (EngineGroup.apply_chaos; with ``--fleet
subprocess`` also ``{"replica": i, "kill": "sigterm"|"sigkill"}``, a
real drain or ``kill -9`` of that worker, and ``{"rpc": {...}}``, the
transport chaos knobs), ``POST /debug/rollout`` replaces every worker
of the process fleet in turn (400 on the in-process fleet, 409 while a
rollout runs), ``GET
/debug/steps`` serves the step ledger's roofline report, ``POST
/debug/profile`` runs torch.profiler (``{"seconds": N, "replica": i}``,
or ``{"action": "start"|"stop"}``), writing traces only under
``ServerConfig.profile_dir``, ``GET /debug/requests?n=`` the latest
request timelines, ``GET /debug/trace?id=`` one request's span tree
(``?format=chrome&n=``: the latest traces as Chrome trace-event JSON)
and ``GET /debug/blackbox`` the flight recorder's captures. Without
``enable_debug`` every ``/debug/*`` route is 404.
"""

from __future__ import annotations

import datetime
import itertools
import json
import os
import queue
import random
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from tpu_inference_torch import telemetry
from tpu_inference_torch.config import (PRIORITY_CLASSES, EngineConfig,
                                        FrameworkConfig, ParallelConfig,
                                        ServerConfig)
from tpu_inference_torch.engine.engine import InferenceEngine, Sequence
from tpu_inference_torch.engine.sampling import PENALTY_WINDOW
from tpu_inference_torch.server.replicas import (EngineGroup, FleetSaturated,
                                                 FleetUnavailable)
from tpu_inference_torch.server.tokenizer import (IncrementalDecoder,
                                                  StopMatcher,
                                                  build_tokenizer)


def _now_iso() -> str:
    return (datetime.datetime.now(datetime.timezone.utc)
            .strftime("%Y-%m-%dT%H:%M:%S.%f000Z"))


class HTTPError(Exception):
    """An error response: status, JSON body, extra headers."""

    def __init__(self, status: int, error: str,
                 headers: Optional[dict] = None):
        super().__init__(error)
        self.status = status
        self.body = {"error": error}
        self.headers = headers or {}


# Server features of the process fleet this port does not serve yet.
_UNPORTED_FLEET = "ROADMAP 1.15b (KV fabric, shm arena)"


def check_server_config(cfg: FrameworkConfig) -> None:
    """Raise for server configurations the port does not serve:
    NotImplementedError naming the ROADMAP item, ValueError for a fleet
    backend that does not exist or P/D roles outside the process fleet.
    dp > 1 is served by both backends at tp = sp = 1."""
    pcfg, scfg = cfg.parallel, cfg.server
    if pcfg.tp * pcfg.sp > 1:
        raise NotImplementedError(
            f"dp/tp/sp = {pcfg.dp}/{pcfg.tp}/{pcfg.sp}: tensor and "
            "sequence parallelism are not ported yet (ROADMAP 1.16); the "
            "port serves dp replicas of tp = sp = 1")
    if scfg.fleet not in ("in-process", "subprocess"):
        raise ValueError(f"unknown fleet backend {scfg.fleet!r}; one of "
                         "('in-process', 'subprocess')")
    if scfg.fleet == "in-process" and (
            any(r != "mixed" for r in scfg.worker_roles)
            or cfg.engine.role != "mixed"):
        raise ValueError(
            "P/D worker roles (--role/--roles/--pd-ratio) need "
            "--fleet subprocess: the live KV handoff moves pages "
            "between worker PROCESSES (README 'P/D disaggregation'); "
            "the in-process fleet serves every replica mixed")
    unported = {
        "kv_plane": scfg.kv_plane != "relay",
        "fabric_cache_pages": scfg.fabric_cache_pages > 0,
    }
    for name, bad in unported.items():
        if bad:
            raise NotImplementedError(
                f"ServerConfig.{name}={getattr(scfg, name)!r} is not "
                f"ported yet ({_UNPORTED_FLEET})")


def build_engine_group(cfg: FrameworkConfig, device="cuda", draft_cfg=None,
                       draft_checkpoint: Optional[str] = None):
    """The dp replica fleet of ``cfg``: ``fleet="in-process"`` builds dp
    engines in this process behind an EngineGroup, replica i on
    ``replica_device(device, i)`` (``cuda:{i % device_count}``: on one
    card every replica shares it) with the weights of
    ``cfg.checkpoint_path`` or random ones from ``cfg.seed``;
    ``"subprocess"`` returns a ProcessEngineGroup router that spawns one
    worker process per replica at start() (each loads its own weights,
    so a draft model is refused there, as in the reference)."""
    from tpu_inference_torch.engine.engine import resolve_device
    from tpu_inference_torch.models.weights import load_checkpoint
    from tpu_inference_torch.server.replicas import replica_device

    check_server_config(cfg)
    if cfg.server.fleet == "subprocess":
        if draft_cfg is not None:
            raise ValueError(
                "--fleet subprocess does not support draft-model "
                "speculative decoding yet (the worker boots its own "
                "params; use spec_mode='ngram' or the in-process fleet)")
        from tpu_inference_torch.server.fleet import ProcessEngineGroup
        return ProcessEngineGroup(cfg, device=device)
    engines = []
    for i in range(max(1, cfg.parallel.dp)):
        dev = resolve_device(replica_device(device, i))

        def load(mcfg, path, dev=dev):
            return (load_checkpoint(mcfg, path, quant=cfg.engine.quant,
                                    device=dev) if path else None)

        engines.append(InferenceEngine(
            cfg.model, cfg.engine,
            params=load(cfg.model, cfg.checkpoint_path), seed=cfg.seed,
            device=dev, draft_cfg=draft_cfg,
            draft_params=load(draft_cfg, draft_checkpoint)))
    return EngineGroup(engines, cfg.server)


class _HTTPServer(ThreadingHTTPServer):
    """One thread per connection. The listen backlog is aiohttp's (the
    reference server's) 128, not socketserver's 5: a burst of concurrent
    clients must queue, not be reset."""

    daemon_threads = True
    request_queue_size = 128


class InferenceServer:
    """One engine + scheduler + tokenizer behind the Ollama HTTP protocol."""

    def __init__(self, cfg: FrameworkConfig,
                 engine: Optional[InferenceEngine] = None,
                 load_duration_ns: Optional[int] = None,
                 device="cuda", draft_cfg=None,
                 draft_checkpoint: Optional[str] = None, group=None):
        """``engine``: a prebuilt engine, or ``group``: a prebuilt group
        (tests); otherwise ``build_engine_group`` builds the dp replicas
        of ``cfg`` on ``device`` (in this process, or as worker
        processes with ``cfg.server.fleet="subprocess"``) with the
        weights of ``cfg.checkpoint_path`` (streamed onto the card,
        quantized as they land under ``cfg.engine.quant``) or random
        ones from ``cfg.seed``; with ``draft_cfg``, a draft model from
        ``draft_checkpoint`` or random from ``cfg.seed + 1``.
        ``load_duration_ns`` feeds the Ollama ``load_duration`` field."""
        check_server_config(cfg)
        self.cfg = cfg
        self.tokenizer = build_tokenizer(cfg.server.tokenizer,
                                         vocab_size=cfg.model.vocab_size)
        if self.tokenizer.vocab_size > cfg.model.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                f"model vocab ({cfg.model.vocab_size})")
        t0 = time.perf_counter()
        if group is not None:
            self.group = group
        elif engine is not None:
            self.group = EngineGroup([engine], cfg.server)
        else:
            self.group = build_engine_group(cfg, device, draft_cfg,
                                            draft_checkpoint)
        self.load_duration_ns = (load_duration_ns
                                 if load_duration_ns is not None else
                                 int((time.perf_counter() - t0) * 1e9))
        self._ids = itertools.count()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # One profiler at a time: a /debug/profile capture or a started
        # trace holds it (_profiling); _profiler is the started trace.
        self._profile_mutex = threading.Lock()
        self._profiling = False
        self._profiler = None

    @property
    def engine(self):
        """Replica 0's engine (in-process) or the model and engine facts
        of worker 0's hello (process fleet, once started)."""
        return self.group.engine

    # ------------------------------------------------------- lifecycle

    def start(self, host: Optional[str] = None,
              port: Optional[int] = None) -> int:
        """Warm up (when configured), start the scheduler, and serve on a
        background thread. ``port=0`` binds an ephemeral port. Returns
        the bound port."""
        if self.cfg.server.warmup:
            secs = self.group.warmup()
            print(f"engine warmup on {self.engine.device} "
                  f"(attn_backend={self.engine.attn_backend}): {secs:.1f}s",
                  flush=True)
        self.group.start()
        host = self.cfg.server.host if host is None else host
        port = self.cfg.server.port if port is None else port
        self._httpd = _HTTPServer((host, port), _Handler)
        self._httpd.app = self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="http", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop serving and stop the scheduler (unfinished requests end
        with reason "shutdown")."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        self.group.stop(drain=False, timeout=timeout)

    # ------------------------------------------------------- routes

    def _parameter_size(self) -> str:
        n = self.engine.n_params
        for div, suffix in ((1e9, "B"), (1e6, "M"), (1e3, "K")):
            if n >= div:
                return f"{n / div:.1f}{suffix}"
        return str(n)

    def _quantization_level(self) -> str:
        """Ollama quantization_level vocabulary: Q8_0/Q4_0 for int8/int4
        weights, else the serving dtype (BF16, F16, F32)."""
        q = {"int8": "Q8_0", "int4": "Q4_0"}.get(self.cfg.engine.quant)
        if q is not None:
            return q
        import torch
        return {torch.bfloat16: "BF16", torch.float16: "F16"}.get(
            self.cfg.model.dtype, "F32")

    def _details(self) -> dict:
        return {"family": self.cfg.model.family,
                "parameter_size": self._parameter_size(),
                "quantization_level": self._quantization_level()}

    def tags(self) -> dict:
        return {"models": [{
            "name": self.cfg.server.model_name,
            "model": self.cfg.server.model_name,
            "details": self._details(),
        }]}

    def ps(self) -> dict:
        """Ollama GET /api/ps: the one loaded model, never unloaded
        (``expires_at`` is Ollama's zero time); ``size`` is one copy of
        the weights, all on the card."""
        size = int(self.engine.weight_bytes)
        return {"models": [{
            "name": self.cfg.server.model_name,
            "model": self.cfg.server.model_name,
            "size": size,
            "size_vram": size,
            "replicas": len(self.group.engines),
            "details": self._details(),
            "expires_at": "0001-01-01T00:00:00Z",
        }]}

    def show(self) -> dict:
        """Ollama POST /api/show: the loaded model's card, whatever name
        was asked for (a one-model server)."""
        mc, ec = self.cfg.model, self.cfg.engine
        fam = mc.family
        return {
            "modelfile": "",
            "details": {"family": fam, "format": "safetensors",
                        "parameter_size": self._parameter_size(),
                        "quantization_level": self._quantization_level()},
            "model_info": {
                "general.architecture": fam,
                "general.parameter_count": self.engine.n_params,
                f"{fam}.context_length": ec.max_context,
                f"{fam}.embedding_length": mc.d_model,
                f"{fam}.block_count": mc.n_layers,
                f"{fam}.attention.head_count": mc.n_heads,
                f"{fam}.attention.head_count_kv": mc.n_kv_heads,
                f"{fam}.vocab_size": mc.vocab_size,
                # The resolved backend, as /metrics reports it.
                "serving.attn_backend": self.engine.attn_backend,
                "serving.kv_quant": ec.kv_quant,
                f"{fam}.attention.sliding_window": mc.sliding_window or 0,
                "serving.swa_eviction": self.engine.swa_evict,
                "serving.prefix_cache": self.engine.prefix_cache is not None,
            },
        }

    def chat_prompt(self, msgs) -> str:
        """The prompt of /api/chat ``messages``: the tokenizer's chat
        template when it renders, else the role-prefix transcript.
        Raises HTTPError(400) on a malformed list."""
        if (not isinstance(msgs, list) or not msgs
                or not all(isinstance(m, dict) and "content" in m
                           for m in msgs)):
            raise HTTPError(400, "missing 'messages'")
        prompt = None
        if hasattr(self.tokenizer, "apply_chat_template"):
            prompt = self.tokenizer.apply_chat_template(
                [{"role": m.get("role", "user"), "content": m["content"]}
                 for m in msgs])
        if prompt is None:
            prompt = "\n".join(f"{m.get('role', 'user')}: {m['content']}"
                               for m in msgs) + "\nassistant:"
        return prompt

    def embed_texts(self, texts: list) -> list:
        """Embeddings of ``texts`` as lists of floats; FleetUnavailable
        (quarantined replica) becomes a 503 with Retry-After."""
        ids = [self.tokenizer.encode(t) for t in texts]
        try:
            return self.group.embed_many(ids).tolist()
        except FleetUnavailable as e:
            raise HTTPError(503, str(e),
                            self._retry_after_headers(e.retry_after_s))

    def chaos_gate(self) -> None:
        """HTTP-level fault injection (off unless ServerConfig.chaos_* is
        set): a uniform delay up to ``chaos_delay_s``, then a 503 with
        probability ``chaos_failure_rate``. The engine-level counterpart
        (EngineConfig.chaos_step_*) injects below the HTTP layer."""
        scfg = self.cfg.server
        if scfg.chaos_delay_s > 0:
            time.sleep(random.uniform(0, scfg.chaos_delay_s))
        if scfg.chaos_failure_rate > 0:
            if random.random() < scfg.chaos_failure_rate:
                raise HTTPError(503, "chaos: injected failure")

    def _retry_after_headers(self, retry_after_s: float) -> dict:
        return {"Retry-After": str(max(1, int(-(-retry_after_s // 1))))}

    def parse_generate(self, body: dict, headers, chat: bool = False
                       ) -> tuple:
        """Validate a /api/generate body (or /api/chat's, its prompt
        rendered; ``context`` is ignored there, as Ollama's chat emits
        none) -> (Sequence, stream, model name, stop strings, warnings).
        Raises HTTPError(400) on bad input."""
        prompt = body.get("prompt")
        if not isinstance(prompt, str):
            raise HTTPError(400, "missing 'prompt'")
        opts = body.get("options") or {}
        if not isinstance(opts, dict):
            raise HTTPError(400, "'options' must be an object")
        ecfg = self.cfg.engine
        try:
            temperature = float(opts.get(
                "temperature", body.get("temperature", ecfg.temperature)))
            max_tokens = int(opts.get(
                "num_predict", body.get("max_tokens", ecfg.max_new_tokens)))
            max_tokens = max(1, min(max_tokens, ecfg.max_context - 1))
            top_p = float(opts.get("top_p", body.get("top_p", ecfg.top_p)))
            top_k = opts.get("top_k", body.get("top_k"))
            top_k = int(top_k) if top_k is not None else None
            seed = opts.get("seed", body.get("seed"))
            seed = int(seed) if seed is not None else None
            warnings: list = []
            repeat_penalty = float(opts.get("repeat_penalty", 1.0))
            if repeat_penalty <= 0:
                raise ValueError("'repeat_penalty' must be > 0")
            repeat_last_n = int(opts.get("repeat_last_n", 64))
            if repeat_penalty != 1.0 and (repeat_last_n > PENALTY_WINDOW
                                          or repeat_last_n < 0):
                warnings.append(
                    f"repeat_last_n={repeat_last_n} clamped to the static "
                    f"penalty window {PENALTY_WINDOW}")
            if repeat_penalty != 1.0 and self.engine.spec_draft:
                # The q/p acceptance ratio needs both distributions
                # unmodified; n-gram speculation applies the penalty.
                warnings.append(
                    "repeat_penalty ignored: draft-model speculative "
                    "decoding samples from the unmodified target "
                    "distribution")
            stop = opts.get("stop", body.get("stop"))
            if stop is None:
                stop = []
            elif isinstance(stop, str):
                stop = [stop]
            elif not (isinstance(stop, list)
                      and all(isinstance(s, str) for s in stop)):
                raise ValueError("'stop' must be a string or list of strings")
            stop = [s for s in stop if s]
        except (TypeError, ValueError) as e:
            raise HTTPError(400, f"invalid sampling options: {e}")
        prompt_ids = self.tokenizer.encode(prompt)
        # Stateful continuation: a prior response's context ids prepend.
        ctx_ids = body.get("context") if not chat else None
        if ctx_ids is not None:
            if not (isinstance(ctx_ids, list)
                    and all(isinstance(t, int) and not isinstance(t, bool)
                            and 0 <= t for t in ctx_ids)):
                raise HTTPError(400, "'context' must be a list of token ids")
            vocab = self.cfg.model.vocab_size
            if any(t >= vocab for t in ctx_ids):
                raise HTTPError(400, f"'context' token id out of range "
                                     f"(vocab_size={vocab})")
        if ctx_ids:
            if (prompt_ids and self.tokenizer.bos_token_id is not None
                    and prompt_ids[0] == self.tokenizer.bos_token_id):
                prompt_ids = prompt_ids[1:]
            prompt_ids = list(ctx_ids) + prompt_ids
        trace_id = (headers.get("X-Request-Id") or "").strip()
        trace_id = ("".join(c for c in trace_id if c.isprintable())[:64]
                    or uuid.uuid4().hex[:16])
        pcls = (headers.get("X-Priority") or "").strip().lower()
        pcls = pcls or self.cfg.server.default_class
        if pcls not in PRIORITY_CLASSES:
            raise HTTPError(400, f"unknown X-Priority {pcls!r} (expected one "
                                 f"of {', '.join(PRIORITY_CLASSES)})")
        seq = Sequence(request_id=next(self._ids), prompt_tokens=prompt_ids,
                       max_new_tokens=max_tokens, temperature=temperature,
                       top_p=top_p, top_k=top_k, seed=seed,
                       repeat_penalty=repeat_penalty,
                       repeat_last_n=repeat_last_n,
                       eos_token_id=self.tokenizer.eos_token_id,
                       trace_id=trace_id, priority_class=pcls)
        stream = bool(body.get("stream", True))
        model_name = body.get("model") or self.cfg.server.model_name
        return seq, stream, model_name, stop, warnings

    def submit(self, seq: Sequence) -> queue.Queue:
        """Submit; events ("token", id) / ("finish", seq) arrive on the
        returned queue from the engine thread."""
        events: queue.Queue = queue.Queue()
        try:
            self.group.submit(seq,
                              lambda s, tok: events.put(("token", tok)),
                              lambda s: events.put(("finish", s)))
        except FleetSaturated as e:
            raise HTTPError(429, str(e),
                            self._retry_after_headers(e.retry_after_s))
        except FleetUnavailable as e:
            raise HTTPError(503, str(e),
                            self._retry_after_headers(e.retry_after_s))
        telemetry.log_event("request_received", level="info",
                            request_id=seq.trace_id,
                            prompt_tokens=len(seq.prompt_tokens),
                            max_tokens=seq.max_new_tokens)
        return events

    def token_line(self, model_name: str, chunk: str,
                   chat: bool = False) -> dict:
        line = {"model": model_name, "created_at": _now_iso(),
                "done": False}
        if chat:
            line["message"] = {"role": "assistant", "content": chunk}
        else:
            line["response"] = chunk
        return line

    def final_record(self, seq: Sequence, model_name: str, recv_t: float,
                     warnings: Optional[list] = None,
                     chat: bool = False) -> dict:
        now = time.perf_counter()
        prompt_eval_ns = max(0, int((seq.first_token_time - seq.prefill_start)
                                    * 1e9)) if seq.first_token_time else 0
        finish = seq.finish_time or now
        eval_ns = max(0, int((finish - (seq.first_token_time or finish))
                             * 1e9))
        rec = {
            "model": model_name,
            "created_at": _now_iso(),
            "request_id": seq.trace_id,
            "response": "",
            "done": True,
            "done_reason": seq.finish_reason or "stop",
            "context": list(seq.prompt_tokens) + list(seq.generated),
            "total_duration": int((now - recv_t) * 1e9),
            "load_duration": self.load_duration_ns,
            "prompt_eval_count": len(seq.prompt_tokens),
            "prompt_eval_duration": prompt_eval_ns,
            "eval_count": len(seq.generated),
            "eval_duration": eval_ns,
        }
        if warnings:
            rec["warnings"] = list(warnings)
        if chat:
            # Ollama chat records carry `message` and no `context`.
            del rec["response"], rec["context"]
            rec["message"] = {"role": "assistant", "content": ""}
        return rec


    # ------------------------------------------------------- profiler

    def _claim_profiler(self) -> None:
        with self._profile_mutex:
            if self._profiling:
                raise HTTPError(409, "the profiler is already tracing")
            self._profiling = True

    def _release_profiler(self) -> None:
        with self._profile_mutex:
            self._profiling = False

    def profile_capture(self, replica: int, seconds: float) -> dict:
        """POST /debug/profile {"seconds", "replica"}: one capture while
        serving goes on. 409 while another trace runs; a capture that
        fails answers 503 with its error."""
        self._claim_profiler()
        try:
            result = self.group.capture_profile(replica, seconds)
        except Exception as e:  # noqa: BLE001 — the error is the answer
            raise HTTPError(503, f"profile capture failed: {e!r}")
        finally:
            self._release_profiler()
        return {"status": "captured", **result}

    def profile_start(self) -> dict:
        """{"action": "start"}: trace this process until "stop"."""
        self._claim_profiler()
        trace = _TraceThread(self.cfg.server.profile_dir)
        trace.start()
        trace.started.wait()
        if trace.error is not None:      # another profiler in the process
            self._release_profiler()
            raise HTTPError(409, str(trace.error))
        self._profiler = trace
        return {"status": "tracing", "dir": self.cfg.server.profile_dir}

    def profile_stop(self) -> dict:
        """{"action": "stop"}: end the started trace, written under
        profile_dir."""
        with self._profile_mutex:
            trace, self._profiler = self._profiler, None
        if trace is None:
            raise HTTPError(409, "no profiler trace was started")
        try:
            trace.stop.set()
            trace.join(timeout=self.cfg.server.request_timeout_s)
            if trace.error is not None:
                raise HTTPError(503, f"profile trace failed: "
                                     f"{trace.error!r}")
        finally:
            self._release_profiler()
        return {"status": "stopped", "dir": self.cfg.server.profile_dir}


class _TraceThread(threading.Thread):
    """Holds a started torch.profiler trace until ``stop`` is set. The
    start and the stop arrive on different request threads, and torch
    lets only the thread that started a profiler stop it."""

    def __init__(self, trace_dir: str):
        super().__init__(name="profiler", daemon=True)
        self.trace_dir = trace_dir
        self.started = threading.Event()
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        def until() -> None:
            self.started.set()
            self.stop.wait()
        try:
            telemetry.torch_trace(self.trace_dir, until)
        except (RuntimeError, OSError) as e:
            self.error = e
        finally:
            self.started.set()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def app(self) -> InferenceServer:
        return self.server.app

    def log_message(self, format, *args) -> None:   # noqa: A002
        telemetry.log_event("http_access", level="debug",
                            line=format % args)

    # ------------------------------------------------------- plumbing

    def _send_json(self, status: int, obj, headers: Optional[dict] = None
                   ) -> None:
        self._send_body(status, json.dumps(obj).encode(), "application/json",
                        headers)

    def _send_body(self, status: int, data: bytes, ctype: str,
                   headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n > 0 else b""

    @staticmethod
    def _parse_json(raw: bytes) -> dict:
        try:
            body = json.loads(raw or b"null")
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise HTTPError(400, "invalid JSON body")
        if not isinstance(body, dict):
            raise HTTPError(400, "invalid JSON body")
        return body

    # ------------------------------------------------------- routes

    @staticmethod
    def _int_arg(query: dict, name: str, default: int) -> int:
        try:
            return int(query.get(name, [default])[0])
        except ValueError:
            raise HTTPError(400, f"'{name}' must be an integer")

    def _debug_get(self, path: str, query: dict) -> None:
        """GET /debug/requests, /debug/trace and /debug/blackbox: the
        reference's bodies and status codes."""
        group = self.app.group
        if path == "/debug/requests":
            n = self._int_arg(query, "n", 50)
            self._send_json(200, group.recent_snapshot(n) if n > 0 else [])
        elif path == "/debug/blackbox":
            self._send_json(200, group.blackbox_index())
        elif query.get("format") == ["chrome"]:
            self._send_json(200, group.trace_chrome(
                self._int_arg(query, "n", 128)))
        else:
            tid = (query.get("id", [""])[0]).strip()
            if not tid:
                raise HTTPError(400, "pass ?id=<trace_id> or ?format=chrome")
            snap = group.trace_snapshot(tid)
            if snap is None:
                raise HTTPError(404, f"no trace {tid!r} in the recent ring")
            self._send_json(200, snap)

    _DEBUG_GETS = ("/debug/requests", "/debug/trace", "/debug/blackbox")

    def do_GET(self) -> None:   # noqa: N802
        url = urlsplit(self.path)
        app = self.app
        if url.path in self._DEBUG_GETS and app.cfg.server.enable_debug:
            try:
                self._debug_get(url.path,
                                parse_qs(url.query, keep_blank_values=True))
            except HTTPError as e:
                self._send_json(e.status, e.body, e.headers)
        elif url.path == "/api/tags":
            self._send_json(200, app.tags())
        elif url.path == "/api/ps":
            self._send_json(200, app.ps())
        elif url.path == "/debug/steps" and app.cfg.server.enable_debug:
            self._send_json(200, app.group.steps_snapshot())
        elif url.path == "/api/version":
            from tpu_inference_torch import __version__
            self._send_json(200, {"version": __version__})
        elif url.path == "/healthz":
            snap = app.group.health_snapshot()
            if snap["status"] == "unavailable":
                self._send_json(503, snap, app._retry_after_headers(
                    app.cfg.server.retry_after_s))
            else:
                self._send_json(200, snap)
        elif url.path == "/metrics":
            if parse_qs(url.query).get("format") == ["json"]:
                self._send_json(200, app.group.stats_snapshot())
            else:
                self._send_body(200, app.group.prometheus_text().encode(),
                                telemetry.PROMETHEUS_CONTENT_TYPE)
        else:
            self._send_json(404, {"error": f"no route {url.path}"})

    def do_POST(self) -> None:   # noqa: N802
        path = urlsplit(self.path).path
        app = self.app
        try:
            raw = self._read_body()
            if app.cfg.server.enable_debug and path == "/debug/chaos":
                self._chaos(self._parse_json(raw))
            elif app.cfg.server.enable_debug and path == "/debug/profile":
                self._send_json(200, self._profile(self._parse_json(raw)))
            elif app.cfg.server.enable_debug and path == "/debug/rollout":
                self._rollout()
            elif path == "/api/show":
                self._send_json(200, app.show())
            elif path in ("/api/generate", "/api/chat", "/api/embeddings",
                          "/api/embed"):
                # Gate before the body is parsed, as the reference does.
                app.chaos_gate()
                body = self._parse_json(raw)
                if path == "/api/generate":
                    self._generate(body)
                elif path == "/api/chat":
                    self._chat(body)
                else:
                    self._embeddings(path, body)
            else:
                raise HTTPError(404, f"no route {path}")
        except HTTPError as e:
            self._send_json(e.status, e.body, e.headers)

    def _chaos(self, body: dict) -> None:
        """POST /debug/chaos: arm/disarm engine fault injection."""
        try:
            result = self.app.group.apply_chaos(body)
        except (IndexError, TypeError, ValueError, KeyError) as e:
            raise HTTPError(400, f"invalid chaos spec: {e}")
        self._send_json(200, result)

    def _rollout(self) -> None:
        """POST /debug/rollout: a rolling upgrade of the process fleet,
        on this request's own thread (the in-process group has no
        worker processes to roll)."""
        roll = getattr(self.app.group, "rollout", None)
        if roll is None:
            raise HTTPError(400, "rolling upgrades need --fleet subprocess")
        try:
            result = roll()
        except ValueError as e:
            raise HTTPError(409, str(e))
        self._send_json(200, result)

    def _profile(self, body: dict) -> dict:
        """POST /debug/profile: ``{"seconds": N, "replica": i}`` captures
        N seconds (0 < N <= 60); ``{"action": "start"|"stop"}`` brackets
        a trace. A client ``dir`` is ignored."""
        app = self.app
        if body.get("seconds") is not None:
            try:
                seconds = float(body["seconds"])
                replica = int(body.get("replica", 0))
                if not 0 < seconds <= 60:
                    raise ValueError("'seconds' must be in (0, 60]")
                if not 0 <= replica < len(app.group.engines):
                    raise ValueError(f"no replica {replica}")
            except (TypeError, ValueError) as e:
                raise HTTPError(400, str(e))
            return app.profile_capture(replica, seconds)
        action = body.get("action")
        if action == "start":
            return app.profile_start()
        if action == "stop":
            return app.profile_stop()
        raise HTTPError(400, "action must be 'start' or 'stop'")

    def _chat(self, body: dict) -> None:
        """POST /api/chat: the messages' prompt through the generate
        path, answered in chat records."""
        app = self.app
        msgs = body.get("messages")
        if msgs == []:
            # The chat flavour of the load probe: an immediate ack.
            self._send_json(200, {
                "model": body.get("model") or app.cfg.server.model_name,
                "created_at": _now_iso(),
                "message": {"role": "assistant", "content": ""},
                "done": True, "done_reason": "load"})
            return
        self._generate(dict(body, prompt=app.chat_prompt(msgs)), chat=True)

    def _embeddings(self, path: str, body: dict) -> None:
        """POST /api/embeddings ({"prompt": str} -> {"embedding"}) and
        /api/embed ({"input": str | [str]} -> {"model", "embeddings"}).
        The forward runs on this connection's own thread, so it holds up
        no other request (the reference moves it off its event loop)."""
        app = self.app
        legacy = path.endswith("/embeddings")
        if legacy:
            texts = body.get("prompt")
            if not isinstance(texts, str):
                raise HTTPError(400, "missing 'prompt' string")
            texts = [texts]
        else:
            texts = body.get("input")
            if isinstance(texts, str):
                texts = [texts]
            if (not isinstance(texts, list) or not texts
                    or not all(isinstance(t, str) for t in texts)):
                raise HTTPError(400,
                                "missing 'input' string or list of strings")
        vecs = app.embed_texts(texts)
        if legacy:
            self._send_json(200, {"embedding": vecs[0]})
        else:
            self._send_json(200, {"model": app.cfg.server.model_name,
                                  "embeddings": vecs})

    def _generate(self, body: dict, chat: bool = False) -> None:
        app = self.app
        recv_t = time.perf_counter()
        if not chat and body.get("prompt") == "" and not body.get("context"):
            # Ollama load/ping contract: an empty prompt acks at once.
            self._send_json(200, {
                "model": body.get("model") or app.cfg.server.model_name,
                "created_at": _now_iso(), "response": "", "done": True,
                "done_reason": "load"})
            return
        seq, stream, model_name, stop, warnings = app.parse_generate(
            body, self.headers, chat)
        events = app.submit(seq)
        try:
            if stream:
                self._stream(events, seq, model_name, recv_t, stop, warnings,
                             chat)
            else:
                self._unary(events, seq, model_name, recv_t, stop, warnings,
                            chat)
        except (BrokenPipeError, ConnectionResetError):
            app.group.cancel(seq.request_id)     # client went away
            self.close_connection = True

    def _next_event(self, events: queue.Queue, seq: Sequence) -> tuple:
        try:
            return events.get(timeout=self.app.cfg.server.request_timeout_s)
        except queue.Empty:
            self.app.group.cancel(seq.request_id)
            raise HTTPError(504, "request timed out")

    def _stream(self, events, seq, model_name, recv_t, stop, warnings,
                chat):
        app = self.app
        decoder = IncrementalDecoder(app.tokenizer,
                                     prompt_tail=seq.prompt_tokens[-8:])
        matcher = StopMatcher(stop)
        consumed: list = []
        started = False

        def begin() -> None:
            # First token ready -> now send headers (TTFT contract).
            nonlocal started
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", seq.trace_id)
            self.end_headers()
            started = True

        def line(obj) -> None:
            self._write_chunk(json.dumps(obj).encode() + b"\n")

        def finish(fseq: Sequence, stopped: bool) -> None:
            final = app.final_record(fseq, model_name, recv_t, warnings,
                                     chat)
            if stopped:
                # Report only what this handler consumed: the engine may
                # append more before the cancel lands.
                final["done_reason"] = "stop"
                final["eval_count"] = len(consumed)
                if "context" in final:
                    final["context"] = list(seq.prompt_tokens) + consumed
            line(final)
            self._write_chunk(b"")

        while True:
            try:
                kind, payload = self._next_event(events, seq)
            except HTTPError:
                if not started:
                    raise
                self.close_connection = True   # headers out: just end
                return
            if kind == "token":
                consumed.append(payload)
                emit, stopped = matcher.push(decoder.push(payload))
                if not started:
                    begin()
                if stopped:
                    if emit:
                        line(app.token_line(model_name, emit, chat))
                    app.group.cancel(seq.request_id)
                    finish(seq, stopped=True)
                    return
                line(app.token_line(model_name, emit, chat))
                continue
            if (payload.finish_reason in ("error", "unavailable")
                    and not consumed and not started):
                raise HTTPError(503, "replica failure before first token",
                                app._retry_after_headers(
                                    app.cfg.server.retry_after_s))
            if not started:
                begin()
            tail, stopped = matcher.push(decoder.flush())
            if not stopped:
                tail += matcher.flush()
            if tail:
                line(app.token_line(model_name, tail, chat))
            finish(payload, stopped)
            return

    def _unary(self, events, seq, model_name, recv_t, stop, warnings, chat):
        app = self.app
        decoder = IncrementalDecoder(app.tokenizer,
                                     prompt_tail=seq.prompt_tokens[-8:])
        matcher = StopMatcher(stop)
        parts: list = []
        consumed: list = []

        def respond(fseq: Sequence, stopped: bool) -> None:
            final = app.final_record(fseq, model_name, recv_t, warnings,
                                     chat)
            if stopped:
                final["done_reason"] = "stop"
                final["eval_count"] = len(consumed)
                if "context" in final:
                    final["context"] = list(seq.prompt_tokens) + consumed
            text = "".join(parts)
            if chat:
                final["message"] = {"role": "assistant", "content": text}
            else:
                final["response"] = text
            self._send_json(200, final, {"X-Request-Id": seq.trace_id})

        while True:
            kind, payload = self._next_event(events, seq)
            if kind == "token":
                consumed.append(payload)
                emit, stopped = matcher.push(decoder.push(payload))
                parts.append(emit)
                if stopped:
                    app.group.cancel(seq.request_id)
                    respond(seq, stopped=True)
                    return
                continue
            if (payload.finish_reason in ("error", "unavailable")
                    and not consumed):
                raise HTTPError(503, "replica failure before first token",
                                app._retry_after_headers(
                                    app.cfg.server.retry_after_s))
            tail, stopped = matcher.push(decoder.flush())
            parts.append(tail)
            if not stopped:
                parts.append(matcher.flush())
            respond(payload, stopped)
            return


def build_server(model: str = "tiny-llama", tokenizer: str = "byte",
                 checkpoint: Optional[str] = None, warmup: bool = True,
                 device="cuda", seed: int = 0,
                 draft_model: Optional[str] = None,
                 draft_checkpoint: Optional[str] = None,
                 enable_debug: bool = False,
                 server_overrides: Optional[dict] = None, dp: int = 1,
                 **engine_overrides) -> InferenceServer:
    """Convenience constructor used by the CLI, tests and chip_smoke.py.

    ``model``/``draft_model``: a preset name, a local HF checkpoint
    directory (architecture from its config.json), or "auto" with
    ``checkpoint`` set (engine/autosize.py resolve_model_and_checkpoint).
    Without a checkpoint the weights are random from ``seed`` (the
    draft's from ``seed + 1``). ``tokenizer``: "byte", a local HF
    tokenizer directory, or "auto" (the checkpoint directory's tokenizer
    when it has one, else bytes). ``engine_overrides`` are EngineConfig
    fields (``quant``, ``kv_quant``, ``spec_mode``, ...),
    ``server_overrides`` ServerConfig fields (``step_watchdog_s``,
    ``quarantine_after_failures``, ``fleet``, ...); ``dp`` replicas
    (``fleet="subprocess"``: one worker process each)."""
    import os

    from tpu_inference_torch.engine.autosize import (
        resolve_model_and_checkpoint)

    model_cfg, checkpoint = resolve_model_and_checkpoint(model, checkpoint)
    if tokenizer == "auto":
        has_tok = checkpoint and any(
            os.path.exists(os.path.join(checkpoint, f))
            for f in ("tokenizer.json", "tokenizer_config.json"))
        tokenizer = checkpoint if has_tok else "byte"
    draft_cfg = None
    if draft_model:
        draft_cfg, draft_checkpoint = resolve_model_and_checkpoint(
            draft_model, draft_checkpoint)
    if draft_cfg is not None and checkpoint and not draft_checkpoint:
        # A trained target with a random draft accepts almost nothing.
        raise ValueError(
            "--draft-model with --checkpoint requires "
            "--draft-checkpoint: a random-weight draft makes "
            "speculative decoding a pure slowdown")
    cfg = FrameworkConfig(
        model=model_cfg,
        engine=EngineConfig(**engine_overrides),
        parallel=ParallelConfig(dp=dp),
        server=ServerConfig(model_name=model, tokenizer=tokenizer,
                            warmup=warmup, enable_debug=enable_debug,
                            **(server_overrides or {})),
        checkpoint_path=checkpoint, seed=seed)
    return InferenceServer(cfg, device=device, draft_cfg=draft_cfg,
                           draft_checkpoint=draft_checkpoint)
