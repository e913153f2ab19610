"""Tracing and profiling: the serving path's span-and-counter recorder, the
clock its stamps read, and torch.profiler integration.

- `clock()`: the one clock of the port's tracing, the one torch.profiler
  stamps its events with, so a span or a per-request stamp lines up with
  a profiler trace's events.
- `Tracer`: spans of the serving path (`runtime/server.py`,
  `runtime/batching.py`), off unless its engine's `trace_enabled` is set.
  A host span adds its milliseconds and its count to the engine's
  `MetricsRegistry` as `<name>.host_ms` and `<name>.n` and goes into a
  bounded ring (`Tracer.spans`). A device span is a pair of timing events
  recorded around the graph replays inside it, on the stream that runs
  them; once its end event has completed, a later `Tracer.resolve` adds
  `<name>.device_ms`. Off, a span is one shared no-op: no clock read, no
  event, no allocation.
- `device_trace` / `annotate`: torch.profiler over a block, and named
  regions inside it (not used on the serving path: a `record_function`
  range comes back on the card's timeline as an annotation).

Usage:
    with device_trace("build/trace") as prof:    # Chrome trace into build/trace
        with annotate("generate"):
            run_generation(...)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Any, Iterator, List, NamedTuple, Optional

import torch

SPAN_RING = 65536       # host spans kept for `Tracer.spans`, oldest dropped first

_NOOP = contextlib.nullcontext()
_ARMED = threading.local()


def clock() -> float:
    """Seconds since the epoch on the clock of torch.profiler's events:
    Kineto stamps its host events from the system clock (`time.time_ns`),
    not from `time.perf_counter`."""
    return time.time_ns() * 1e-9


class Span(NamedTuple):
    """One host span: its times on `clock()`, the span it ran inside (its
    `id`, None at the top), the request it served where one applies, and
    its self time (its duration less its child spans')."""

    id: int
    name: str
    start: float
    end: float
    parent: Optional[int]
    request_id: Any
    self_ms: float


class _HostSpan:
    __slots__ = ("tracer", "name", "request_id", "id", "parent", "start", "child_s")

    def __init__(self, tracer: "Tracer", name: str, request_id):
        self.tracer, self.name, self.request_id = tracer, name, request_id

    def __enter__(self):
        t = self.tracer
        self.id = t._next_id
        t._next_id += 1
        self.parent = t._open[-1] if t._open else None
        self.child_s = 0.0
        t._open.append(self)
        self.start = clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock()
        t = self.tracer
        if t._open and t._open[-1] is self:
            t._open.pop()
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_s += dur
        t.metrics.count(self.name + ".host_ms", dur * 1e3)
        t.metrics.count(self.name + ".n")
        t._ring.append(Span(self.id, self.name, self.start, end,
                            None if parent is None else parent.id, self.request_id,
                            (dur - self.child_s) * 1e3))
        return False


class _DeviceSpan:
    """Armed on its thread for the block: the graph layer's replays inside
    it call `before` and `after` (`runtime/graphs.py::_Graph.replay`), so
    its events bracket the first replay's start and the last one's end on
    the replaying stream, and no host preparation between them and the
    block's edges."""

    __slots__ = ("tracer", "name", "start", "end", "prev")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.start = self.end = None

    def __enter__(self):
        self.prev = armed()
        _ARMED.span = self
        return self

    def __exit__(self, *exc) -> bool:
        _ARMED.span = self.prev
        if self.end is not None:
            self.tracer._device.append(self)
        return False

    def before(self) -> None:
        """Before a replay: the start event, at the first replay (none
        inside a capture)."""
        if self.start is None and not (torch.cuda.is_available()
                                       and torch.cuda.is_current_stream_capturing()):
            self.start = self.tracer._new_event()
            self.start.record()

    def after(self) -> None:
        """After a replay: the end event, moved to each later replay's end."""
        if self.start is None:
            return
        if self.end is None:
            self.end = self.tracer._new_event()
        self.end.record()


def armed() -> Optional[_DeviceSpan]:
    """The device span this thread's graph replays record into, if any."""
    return getattr(_ARMED, "span", None)


class Tracer:
    """The serving path's spans over a `MetricsRegistry` (module
    docstring). `enabled` is the switch (the engine's `trace_enabled`);
    `event`: a factory of timing events for device spans (None: a
    `torch.cuda.Event(enable_timing=True)`, on CUDA devices only), so a
    test can hand in a double with `record`, `query` and
    `elapsed_time`."""

    def __init__(self, metrics, event=None):
        self.metrics = metrics
        self.enabled = False
        self.event = event
        self._ring: deque = deque(maxlen=SPAN_RING)
        self._open: List[_HostSpan] = []
        self._next_id = 0
        self._device: List[_DeviceSpan] = []

    def span(self, name: str, request_id=None):
        """A host span named `name` over the `with` block."""
        if not self.enabled:
            return _NOOP
        return _HostSpan(self, name, request_id)

    def device_span(self, name: str, device):
        """A device span named `name` over the graph replays of the `with`
        block (work that runs eagerly inside it records nothing)."""
        if not self.enabled or (self.event is None and torch.device(device).type != "cuda"):
            return _NOOP
        return _DeviceSpan(self, name)

    def _new_event(self):
        if self.event is not None:
            return self.event()
        return torch.cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Add `<name>.device_ms` of every recorded device span whose end
        event has completed (`query()`, which does not block); the rest
        wait for a later call."""
        if not self._device:
            return
        pending = []
        for d in self._device:
            if d.end.query():
                self.metrics.count(d.name + ".device_ms", d.start.elapsed_time(d.end))
            else:
                pending.append(d)
        self._device = pending

    def spans(self) -> List[Span]:
        """The host spans recorded since the last call, oldest first (at
        most the ring's size); empties the ring."""
        out = list(self._ring)
        self._ring.clear()
        return out


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
