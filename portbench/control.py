"""The check's control on the card: runs of a cell (set-up, ramp, a short
window) that read both the program's numbers and the control's (the
reference itself in the next lower precision in the program's place:
int4 talker matmuls, TF32 vocoder) on the same served requests, one JSON
line per seed, with whether the control's numbers pass the check's own
comparison (`control_correct`, which has to read false).

    python3 portbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Each seed runs in a process of its own (a fresh program, as a benchmark run
has). The limits in the configuration files were set from these readings
(PERF.md). The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def one(workload: str, seed: int, seconds: float) -> None:
    import time

    import torch

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    t0 = time.perf_counter()
    bench = harness.Bench.load(ROOT)
    res = harness.run(bench, workload, seed, seconds, False, torch.device("cuda", 0), t0,
                      log=lambda s: print(s, file=sys.stderr, flush=True), control=True)
    print(json.dumps({"workload": workload, "seed": seed, "correct": res["correct"],
                      "control_correct": res["control_correct"],
                      "program": {k: v["value"] for k, v in res["check"].items()},
                      "control": res["control"], "metrics": res["metrics"]}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.one:
        one(a.workload, a.seeds[0], a.seconds)
        return 0
    rc = 0
    for seed in a.seeds:
        rc |= subprocess.run([sys.executable, __file__, "--one", "--workload", a.workload,
                              "--seconds", str(a.seconds), "--seeds", str(seed)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
