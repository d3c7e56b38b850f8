"""On the card: each cell's command, briefly, as the check runs it (run
there with ``python -m pytest benchmark/tests -m gpu``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [p.stem for p in sorted((ROOT / "benchmark/workloads").glob(
    "*.json"))]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, card):
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
