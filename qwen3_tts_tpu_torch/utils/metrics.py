"""Process-local serving metrics (the port's copy of
`qwen3_tts_tpu/utils/metrics.py`'s registry): counters, gauges and
bounded-reservoir timings with p50/p95 at scrape time. Streaming, the
engine and the server record to it under the JAX package's names
(`stream.first_packet_s`, `engine.*`, `server.*`).
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class MetricsRegistry:
    """Process-local metrics: counters (monotonic), gauges (last value),
    and bounded-reservoir timings (for percentiles)."""

    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    gauges: Dict[str, float] = field(default_factory=dict)
    timings: Dict[str, List[float]] = field(default_factory=lambda: defaultdict(list))
    reservoir: int = 4096

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        buf = self.timings[name]
        buf.append(float(seconds))
        if len(buf) > self.reservoir:          # drop oldest half, keep tail
            del buf[:len(buf) // 2]

    def time(self, name: str):
        """Context manager: `with metrics.time("serve.chunk"): ...`"""
        registry = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                registry.observe(name, time.perf_counter() - self.t0)
                return False

        return _Timer()

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view with p50/p95/max for each timing series."""
        out: Dict[str, Any] = {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "timings": {},
        }
        for name, buf in self.timings.items():
            if not buf:
                continue
            s = sorted(buf)
            n = len(s)
            out["timings"][name] = {
                "count": n,
                "p50": s[n // 2],
                "p95": s[min(n - 1, (n * 95) // 100)],
                "max": s[-1],
                "sum": sum(s),
            }
        return out

    def emit(self, stream=None) -> str:
        """Write the snapshot as one JSON line; returns the line."""
        line = json.dumps({"ts": time.time(), **self.snapshot()},
                          separators=(",", ":"))
        print(line, file=stream or sys.stderr)
        return line

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.timings.clear()


_GLOBAL: Optional[MetricsRegistry] = None


def global_metrics() -> MetricsRegistry:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL
