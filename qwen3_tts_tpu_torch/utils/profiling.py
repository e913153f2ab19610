"""Tracing / profiling utilities: stage timers, a first-packet meter and
torch.profiler integration. Counterpart of `qwen3_tts_tpu/utils/profiling.py`.

Usage:
    timers = StageTimers()
    with timers.stage("prefill"):
        ...
        torch.cuda.synchronize()
    print(timers.summary())

    with device_trace("build/trace") as prof:    # Chrome trace into build/trace
        with annotate("generate"):
            run_generation(...)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


@dataclass
class StageTimers:
    """Wall-clock per-stage timers with percentile summaries.

    NOTE on CUDA semantics: PyTorch returns before the card finishes, so a
    stage that only enqueues device work measures the enqueue. Call
    `torch.cuda.synchronize()` inside the `stage` block to time execution.
    """

    records: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.records[name].append(seconds)

    def percentile(self, name: str, q: float) -> float:
        return float(np.percentile(self.records[name], q))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "max_ms": float(arr.max() * 1e3),
            }
        return out

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>6s} {'mean':>9s} {'p50':>9s} "
                 f"{'p95':>9s} {'max':>9s}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:24s} {s['count']:6d} {s['mean_ms']:8.2f}m "
                f"{s['p50_ms']:8.2f}m {s['p95_ms']:8.2f}m {s['max_ms']:8.2f}m")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block (host ops, and CUDA kernels when a card
    is present); writes a Chrome trace `trace.json` into log_dir on exit
    (view in chrome://tracing or Perfetto). Yields the profiler, whose
    `events()` / `key_averages()` the caller may read after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a device trace. With a card, the region also
    comes back among the CUDA events (a device-side range as long as the
    region): leave it out when summing kernel time."""
    with torch.profiler.record_function(name):
        yield


class FirstPacketMeter:
    """Collects first-packet latencies across requests; reports p50/p95."""

    def __init__(self):
        self.latencies_ms: List[float] = []

    def observe(self, seconds: float) -> None:
        self.latencies_ms.append(seconds * 1e3)

    def p50(self) -> Optional[float]:
        if not self.latencies_ms:
            return None
        return float(np.percentile(self.latencies_ms, 50))

    def p95(self) -> Optional[float]:
        if not self.latencies_ms:
            return None
        return float(np.percentile(self.latencies_ms, 95))
