"""On the card, at each cell's own size: the port's reading keeps the
cell's logit-gap limit and the float8 control's fails it. Skipped where
no card is visible (decided inside the test); run on the card with

    python3 -m pytest -q -p no:cacheprovider h100bench/tests/test_hb_card.py
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 4242


@pytest.mark.parametrize("cell", ["mistral7b.chat", "mixtral8x7b.batch",
                                  "mistral7b.sessions"])
def test_control_fails_the_limit_the_port_keeps(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's size runs only there")
    out = subprocess.run(
        [sys.executable, "-m", "h100bench.control", "--workload", cell,
         "--seed", str(SEED), "--seconds", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    stat = got["stat"]
    assert got["port"][stat] <= got["limit"] < got["control_fp8"][stat], got
