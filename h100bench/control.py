"""The readings that a cell's logit-gap limit is set from.

    python3 -m h100bench.control --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as ``run.py`` does (set-up, the window at the cell's own
load, the port's state freed), takes the same sample of finished
requests, and prints one JSON line with two readings of it: the port's
widest gap below the float32 reference's best logit (the lower reading
comes from a dozen seeds or more of these) and the control's, the gap of
the token that the float8 reference puts first at the same positions
(the upper reading: the smallest over three seeds or more), each as
every statistic that a cell may compare (reference/check.py STATS), and
the bf16 witness's beside them. The benchmark's own runs do not run the
control.
"""

from __future__ import annotations

import json
import os
import sys

from h100bench import run


def main(argv=None) -> int:
    args = run.parse_args(argv)
    from h100bench import spec
    from h100bench.reference import check

    cell = spec.load_cell(args.workload, os.path.join(run.ROOT,
                                                      "BENCHMARK.json"))
    import torch

    if not torch.cuda.is_available():
        run.log("needs a CUDA card")
        return 2
    raw = run.execute(cell, args.seed, float(args.seconds), False, "cuda")
    tr = cell.traffic
    sample = check.pick_sample(run.finished(raw), args.seed,
                               int(tr["sample_min_tokens"]),
                               int(tr["sample_max_requests"]))
    got = check.control_gaps(raw["shape"], args.seed, sample, "cuda")
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "requests": len(sample), **got,
                      "stat": tr["logit_gap_stat"],
                      "limit": float(tr["logit_gap_limit"]),
                      "kind": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
