"""Process-local serving counters (the port's copy of the counters of
`qwen3_tts_tpu/utils/metrics.py`'s registry). The engine and the server
count their work under the JAX package's names (`engine.*`, `server.*`),
and the serving path's spans (`utils/profiling.py::Tracer`) add their
milliseconds and counts here. The JAX registry's gauges and reservoir
timings are not ported: nothing read them, and a host timing around
queued device work measured the wait, not the work.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class MetricsRegistry:
    """Process-local monotonic counters."""

    counters: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view: {"counters": {name: value}}."""
        return {"counters": dict(self.counters)}

    def emit(self, stream=None) -> str:
        """Write the snapshot as one JSON line; returns the line."""
        line = json.dumps({"ts": time.time(), **self.snapshot()},
                          separators=(",", ":"))
        print(line, file=stream or sys.stderr)
        return line

    def reset(self) -> None:
        self.counters.clear()


_GLOBAL: Optional[MetricsRegistry] = None


def global_metrics() -> MetricsRegistry:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL
