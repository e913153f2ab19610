"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout that holds `BENCHMARK.json`, this folder
and the port (`qwen3_tts_tpu_torch`). Exits non-zero, with no result, where
CUDA is missing or the card count is below the cell's `chips`, or where a
module of JAX or of the JAX package is loaded once the window has closed.
Prints the card (name, count, power limit) and the graph layer's state on
earlier lines, the compared numbers with their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `check`.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _process_start() -> float:
    """The process's start on the perf_counter clock (from /proc where it
    can be read, else this module's first line)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return T_PROCESS


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its kernels into build/kernels/ there itself)."""
    cache = ROOT / "build" / "caches"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_process = _process_start()
    _fixed_caches()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    bench = harness.Bench.load(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"cuda available={torch.cuda.is_available()}, "
              f"count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[card] name={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"smi={smi.stdout.strip().splitlines()[:chips]} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    torch.set_num_threads(4)
    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_process,
                         log=lambda s: print(s, flush=True))
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
