"""A short run of each cell on the card, through the command BENCHMARK.json names."""

import json
import os
import subprocess
import sys

import pytest

from gpubench.harness import bench


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(bench.HERE, "run.py"), "--workload", cell, "--seed",
         "4294967311", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=bench.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().split("\n")[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
