"""On the card: one short run of each cell of BENCHMARK.json through the
command the driver runs, which has to end correct.

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell, cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                        "2147483711", "--seconds", "5", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
