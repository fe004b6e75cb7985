"""Every cell on the card (marked `cuda`): a short run of each, untraced
and traced, is correct and reports its metrics."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pfbench import spec

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "pfbench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "5", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    want = {m["name"] for m in spec.load_cell(cell).metrics(bool(trace))}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "gpu"
