"""The knee sweep of an open-loop or sessions cell: one set-up, several
rates (requests or sessions a second).

    python3 -m h100bench.sweep --workload <cell> --seed <n> \\
        --seconds <s> --rates 2,3,4,5

serves the cell's configuration once and drives its traffic at each
mean rate in turn (``traffic.RATE_KEYS`` names the loop's rate key; the
cell's ramp, then a window of ``--seconds``; the seed plus the rate's
index draws its prompts), printing one JSON line a rate: the end-to-end
tails, the tokens per second completed, the generator's lateness, and
the backlog, the median time to first token of the window's last third
over its first third (it grows past 1 where requests queue faster than
they are served); a sessions loop adds its sessions in flight. The
server drains between rates. The knee is the highest rate with no
growing backlog and both tails under the limits PERF.md records; a cell
runs at a fixed rate below it, written in its file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from h100bench import run, stats

DRAIN_LIMIT_S = 300.0


def backlog(log: list, w0: float, w1: float) -> float:
    """Median time to first token of the window's last third of due
    requests over that of its first third."""
    ts = stats.ttfts(log, w0, w1)
    third = max(1, len(ts) // 3)
    return (stats.nearest_rank(ts[-third:], 0.5)
            / stats.nearest_rank(ts[:third], 0.5))


def drain(served) -> None:
    from h100bench.readers import parse_prometheus

    limit = time.monotonic() + DRAIN_LIMIT_S
    while time.monotonic() < limit:
        m = parse_prometheus(served.scrape())
        if not m.get("tpu_inf_active_sequences") and \
                not m.get("tpu_inf_queue_depth"):
            return
        time.sleep(0.5)
    raise RuntimeError("the server did not drain")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from h100bench import spec, traffic

    cell = spec.load_cell(args.workload, os.path.join(run.ROOT,
                                                      "BENCHMARK.json"))
    _, params, served, split = run.setup(cell, args.seed, "cuda")
    run.log(f"set-up: {json.dumps(split)}")
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            # A seed of its own per rate: no prompt repeats across rates.
            key = traffic.RATE_KEYS[cell.traffic["loop"]]
            plan = traffic.build_plan({**cell.traffic, key: rate},
                                      args.seed + i, args.seconds)
            raw = run.drive(cell, served, plan, args.seconds, False)
            w0, w1 = raw["window"]
            log = raw["log"]
            print(json.dumps({
                "rate_rps": rate,
                "due": len(stats.due_in(log, w0, w1)),
                "ttft_p50_s": stats.nearest_rank(stats.ttfts(log, w0, w1),
                                                 0.5),
                "ttft_p90_s": stats.ttft_p90_s(log, w0, w1),
                "tpot_p50_ms": stats.nearest_rank(
                    stats.tpots_ms(log, w0, w1), 0.5),
                "tpot_p90_ms": stats.tpot_p90_ms(log, w0, w1),
                "output_tok_s": stats.output_tok_s(log, w0, w1),
                "backlog": backlog(log, w0, w1),
                "failed": sum(1 for r in log if r["error"]),
                "lateness": stats.lateness(log),
                **(stats.sessions_summary(log, w0, w1, raw["sessions_cut"])
                   if plan["loop"] == "sessions" else {})}), flush=True)
            drain(served)
    finally:
        served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
