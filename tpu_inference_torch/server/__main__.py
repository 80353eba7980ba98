"""CLI entry point: ``python -m tpu_inference_torch.server --model llama-3-8b``.

Serves the Ollama protocol on the card (``--device cuda``, the default)
or, for tests and small presets, on the CPU (``--device cpu``). Weights
are random, made from ``--seed``. ``--quant int8 --kv-quant int8`` serves
int8 weights over an int8 KV pool (int4 for either is the other tier).
"""

from __future__ import annotations

import argparse
import signal
import threading

from tpu_inference_torch.config import PRESETS


def _buckets(text: str) -> tuple:
    return tuple(int(x) for x in text.split(",") if x)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="PyTorch/CUDA LLM inference server (Ollama-protocol "
                    "endpoint)")
    p.add_argument("--model", default="tiny-llama",
                   help=f"preset ({', '.join(sorted(PRESETS))})")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=11434)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises when no card is visible) "
                        "or 'cpu'")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--max-pages-per-seq", type=int, default=64)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--prefill-buckets", type=_buckets,
                   default=(64, 128, 256, 512, 1024),
                   help="comma-separated prompt buckets")
    p.add_argument("--chunked-prefill-size", type=int, default=0)
    p.add_argument("--max-prefill-batch", type=int, default=4)
    p.add_argument("--decode-steps-per-call", type=int, default=8)
    p.add_argument("--latency-decode-threshold", type=int, default=1)
    p.add_argument("--attn-backend", default="auto",
                   choices=("auto", "kernel", "dense"))
    p.add_argument("--quant", default="none",
                   choices=("none", "int8", "int4"),
                   help="weight quantization: int8 codes with per-channel "
                        "scales, or int4 codes with group-128 scales")
    p.add_argument("--kv-quant", default="none",
                   choices=("none", "int8", "int4"),
                   help="KV-cache quantization: int8 codes with per-token-"
                        "head scales, or nibble-packed int4")
    p.add_argument("--no-prefix-cache", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--request-timeout-s", type=float, default=600.0)
    p.add_argument("--admission-queue-depth", type=int, default=0)
    args = p.parse_args(argv)

    from tpu_inference_torch.server.http import build_server

    server = build_server(
        model=args.model, warmup=not args.no_warmup, device=args.device,
        seed=args.seed,
        server_overrides={"host": args.host, "port": args.port,
                          "request_timeout_s": args.request_timeout_s,
                          "admission_queue_depth":
                              args.admission_queue_depth},
        page_size=args.page_size, num_pages=args.num_pages,
        max_pages_per_seq=args.max_pages_per_seq,
        max_batch_size=args.max_batch_size,
        prefill_buckets=args.prefill_buckets,
        chunked_prefill_size=args.chunked_prefill_size,
        max_prefill_batch=args.max_prefill_batch,
        decode_steps_per_call=args.decode_steps_per_call,
        latency_decode_threshold=args.latency_decode_threshold,
        attn_backend=args.attn_backend, quant=args.quant,
        kv_quant=args.kv_quant,
        enable_prefix_cache=not args.no_prefix_cache,
        max_new_tokens=args.max_new_tokens)
    port = server.start()
    print(f"serving {args.model} on http://{args.host}:{port} "
          f"(device={server.engine.device}, "
          f"attn_backend={server.engine.attn_backend}, "
          f"quant={args.quant}, kv_quant={args.kv_quant})", flush=True)
    done = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: done.set())
    try:
        done.wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
