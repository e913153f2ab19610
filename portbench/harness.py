"""One run of one benchmark cell: set-up, ramp, the measured window, the
check, and the result.

Everything that belongs to one configuration, traffic mix, task or metric
is found by name from `BENCHMARK.json`: `<paths[0]>/traffic/<mix>.json` (its
`generator` names `generators/<kind>.py`, its `task` names `tasks/<task>.py`),
the configuration's `file`, and `metrics/<metric>.py` for every metric (a
reader: `read(run)` returns the number, or None where the run has nothing to
read; `run` holds the configuration as `config` and the mix as `traffic`,
the window's requests, counters, frames and prompts, and in a traced run
its kernels).

The window drives `qwen3_tts_tpu_torch.runtime.server.TTSServer` from this
one thread, the way `ThreadedTTSServer._loop` does without its queues: the
harness is the clients (closed loops), submits through the task's call
(`submit_custom_voice(..., stream=True)`) and advances with `step()`. What
the task's call returns (what the program computed from the request's
inputs) stays on the request as it is, and goes to the check's record as
`served_inputs`, copied to the host after the window for the sampled
requests alone.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench import check, system

RAMP_LIMIT_S = 240.0        # set-up's ramp: every client has finished a request
DRAIN_LIMIT_S = 60.0        # after the window: every window request's first packet
FORBIDDEN = ("jax", "jaxlib", "flax", "qwen3_tts_tpu")
BREAKDOWN_ENTRIES = 10


class Bench:
    """`BENCHMARK.json` and the files it names, under `base`."""

    def __init__(self, spec: Dict[str, Any], base: Path):
        self.spec, self.base = spec, Path(base)
        self.home = self.base / spec["paths"][0]

    @classmethod
    def load(cls, base: Path) -> "Bench":
        with open(Path(base) / "BENCHMARK.json", encoding="utf-8") as f:
            return cls(json.load(f), base)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.base / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return _json(self.home / "traffic" / f"{name}.json")

    def generator(self, kind: str):
        return _module(self.home / "generators" / f"{kind}.py")

    def task(self, name: str):
        return _module(self.home / "tasks" / f"{name}.py")

    def reader(self, metric: str):
        return _module(self.home / "metrics" / f"{metric}.py")

    def metrics(self, cell: str, traced: bool) -> List[Dict[str, Any]]:
        group = self.spec["per_layer"] if traced else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]


def _json(path: Path) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(path: Path):
    name = "portbench_file_" + "_".join(path.with_suffix("").parts[-2:]).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank q-th percentile."""
    v = sorted(values)
    if not v:
        return None
    return float(v[max(0, math.ceil(q / 100 * len(v)) - 1)])


def first_packet_ms(run) -> List[float]:
    """Submit call to first audio packet of each request submitted inside
    the window, in ms; a request with none counts until the harness
    stopped waiting."""
    return [((r.t_first if r.t_first is not None else run.t_stop) - r.t_submit) * 1e3
            for r in run.requests]


class _Record:
    __slots__ = ("uid", "req", "client", "t_submit", "submit_s", "t_first", "frames",
                 "frame_times", "packets", "in_window", "trace", "mf", "served")

    def __init__(self, uid, req, client, mf):
        self.uid, self.req, self.client, self.mf = uid, req, client, mf
        self.t_submit = self.submit_s = self.t_first = None
        self.frames: List[np.ndarray] = []
        self.frame_times: List[tuple] = []
        self.packets: Optional[list] = []
        self.in_window = False
        self.trace: Optional[Dict[str, float]] = None
        self.served = None

    def codes(self) -> np.ndarray:
        return (np.concatenate(self.frames).astype(np.int64) if self.frames
                else np.zeros((0, 1), np.int64))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_process: float, log=print, control: bool = False) -> Dict[str, Any]:
    """One run of cell `cell_name`; returns the result's fields (without
    printing them). `t_process`: the process's start on the
    `time.perf_counter` clock. `control`: the control's readings too, under
    "control", and whether they pass the check under "control_correct"
    (`portbench/control.py`; the benchmark's runs never ask)."""
    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    task = bench.task(mix["task"])
    check.require_limits(cfg, task)
    gen = bench.generator(mix["generator"]).Traffic(mix, seed, cfg, task)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        from qwen3_tts_tpu_torch.ops.cuda import build

        t0 = time.perf_counter()
        build.load_library()
        log(f"[kernels] library loaded in {time.perf_counter() - t0:.3f} s")

    model = task.build_model(cfg, seed, device)
    recs: Dict[int, _Record] = {}
    phase = {"window": False}

    def code_sink(uid, frames):
        r = recs.get(uid)
        if r is not None:
            r.frames.append(np.array(frames, copy=True))
            r.frame_times.append((time.perf_counter(), len(frames)))

    server = system.build_server(model, mix, seed, code_sink)
    warm_s = server.warmup(verbose=True)
    log(f"[warmup] seconds={warm_s:.3f} memory_allocated="
        f"{torch.cuda.memory_allocated(device) if cuda else 0} peak="
        f"{torch.cuda.max_memory_allocated(device) if cuda else 0}")
    log(f"[graphs before ramp] {json.dumps(system.graph_stats(device))}")
    lc = int(server.left_context)
    max_new = int(server.gen_cfg.max_new_tokens)
    up, sr = int(server.up), int(server.sample_rate)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts):     # CUPTI's start-up cost, outside the window
            pass
        span = record_function
    else:
        prof, span = None, None

    def scope(name):
        return span(name) if span is not None else contextlib.nullcontext()

    clients: List[Optional[_Record]] = [None] * gen.clients
    done_once = [False] * gen.clients
    next_k = [0]
    audio = {"frames": 0}
    finished: List[_Record] = []
    longest = [None]
    submitting = [True]

    def submit(c: int) -> None:
        k = next_k[0]
        next_k[0] += 1
        req = gen.request(k)
        r = _Record(k, req, c, min(max_new - 1, int(req["max_frames"])))
        r.in_window = phase["window"]
        recs[k] = r
        clients[c] = r
        with scope("portbench.submit"):
            r.t_submit = time.perf_counter()
            inputs = task.submit(server, k, req["kwargs"])
            r.submit_s = time.perf_counter() - r.t_submit
        r.served = inputs

    def finish(r: _Record) -> None:
        clients[r.client] = None
        done_once[r.client] = True
        finished.append(r)
        keep = r.req["greedy"]
        if not keep and (longest[0] is None or len(r.codes()) > len(longest[0].codes())):
            if longest[0] is not None and not longest[0].req["greedy"]:
                longest[0].packets = None
            longest[0] = r
            keep = True
        if not keep:
            r.packets = None

    def step() -> None:
        for c in range(gen.clients):
            if clients[c] is None and submitting[0]:
                submit(c)
        with scope("portbench.step"):
            events = server.step()
        now = time.perf_counter()
        for ev in events:
            r = recs.get(ev.request_id)
            if r is None:
                continue
            if r.t_first is None:
                r.t_first = now
                if trace and r.in_window:
                    r.trace = server.first_packet_trace(ev.request_id)
            if phase["window"]:
                audio["frames"] += ev.frame_count
            if r.packets is not None:
                r.packets.append((ev.frame_start, ev.frame_count, np.array(ev.wav, copy=True)))
            if ev.final:
                finish(r)

    # ramp: the traffic runs unmeasured until every client has finished a
    # request (every slot has turned over): set-up the traffic needs
    t_ramp = time.perf_counter()
    while not all(done_once):
        step()
        if time.perf_counter() - t_ramp > RAMP_LIMIT_S:
            raise RuntimeError(f"ramp: not every client finished within {RAMP_LIMIT_S} s")
    _sync(device)
    ramp_s = time.perf_counter() - t_ramp
    log(f"[ramp] seconds={ramp_s:.3f} requests={len(finished)}")
    log(f"[graphs before window] {json.dumps(system.graph_stats(device))}")

    if trace:
        system.trace_on(server)
        prof = profile(activities=acts)
        prof.__enter__()
        window_range = span("portbench.window")
        window_range.__enter__()
    c0 = system.counters(server)
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    phase["window"] = True
    while True:
        step()
        now = time.perf_counter()
        if now - t_start >= seconds:
            break
    t_end = now
    phase["window"] = False
    c1 = system.counters(server)
    if trace:
        window_range.__exit__(None, None, None)
    window_s = t_end - t_start

    # after the window: no new requests; every window request's first packet
    submitting[0] = False
    waiting = [r for r in recs.values() if r.in_window and r.t_first is None]
    t_drain = time.perf_counter()
    while waiting and time.perf_counter() - t_drain < DRAIN_LIMIT_S and server.busy:
        step()
        waiting = [r for r in waiting if r.t_first is None]
    t_stop = time.perf_counter()
    _sync(device)
    if trace:   # stopped after the drain: its time counts in no request's wait
        prof.__exit__(None, None, None)
    log(f"[graphs after window] {json.dumps(system.graph_stats(device))}")
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    win = [r for r in recs.values() if r.in_window]
    lat = sorted((r.t_first - r.t_submit) * 1e3 for r in win if r.t_first is not None)
    early = sum(len(r.codes()) < r.mf for r in finished)
    log(f"[window] seconds={t_end - t_start:.3f} requests={len(win)} first_packet_ms "
        + " ".join(f"p{q}={percentile(lat, q):.3f}" for q in (50, 90, 95, 99) if lat)
        + f" mean={sum(lat) / max(len(lat), 1):.3f} finished={len(finished)}"
        + f" ended_before_budget={early}")
    run_view = SimpleNamespace(
        config=cfg, traffic=mix, slots=int(mix["server"]["num_slots"]),
        window_s=window_s, setup_s=setup_s, t_stop=t_stop, audio_s=audio["frames"] * up / sr,
        requests=win, counters={k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in c1},
        frames=[], prompts=[], kernels={}, busy_s=None, gaps=[])
    for r in recs.values():
        T = task.prompt_tokens(r.req)
        t = 0
        for when, n in r.frame_times:
            if t_start <= when <= t_end:
                run_view.frames.extend(T + t + i for i in range(n))
            t += n
        if r.in_window:
            run_view.prompts.append(T)
    if trace:
        _read_trace(prof, run_view)
        prof = None
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        value = bench.reader(m["name"]).read(run_view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    attempted = len(win)
    failed = sum(r.t_first is None for r in win)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"portbench: modules {bad} are loaded after the window")

    # the program's state goes before the reference runs
    min_new = int(server.gen_cfg.min_new_tokens)
    served = [check.served_record(r.req, r.codes(), r.packets, r.mf, lc, min_new, r.served)
              for r in finished]
    tokens, audio_reqs = check.sample(served, seed, int(mix["check_requests"]))
    for rec in tokens + audio_reqs:
        rec["served_inputs"] = check.host_copy(rec["served_inputs"])
    del served
    for r in recs.values():
        r.served = None
    del server, model
    system.free(device)
    t_check = time.perf_counter()
    values = check.readings(cfg, seed, device, task, tokens, audio_reqs)
    _sync(device)
    verdict = check.verdict(cfg, values, tokens, check.names(task))
    log(f"[check] seconds={time.perf_counter() - t_check:.3f} requests={len(tokens)} "
        f"greedy={sum(r['greedy'] for r in tokens)} audio_requests={len(audio_reqs)} "
        f"frames={sum(len(r['frames']) for r in tokens)}")

    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    if trace:
        dev_info.update(busy_s=run_view.busy_s, window_s=window_s)
    result = {"correct": verdict["correct"], "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = {"device_ops": run_view.device_ops,
                               "idle_gaps": run_view.gaps[:BREAKDOWN_ENTRIES]}
    if control:
        t_check = time.perf_counter()
        result["control"] = check.readings(cfg, seed, device, task, tokens, audio_reqs,
                                           control=True)
        result["control_correct"] = check.verdict(cfg, result["control"], tokens,
                                                  check.names(task))["correct"]
        log(f"[control] seconds={time.perf_counter() - t_check:.3f}")
    result["check"] = verdict["table"]
    return result


def _read_trace(prof, view) -> None:
    """Kernel time by name, the device's busy time and its idle gaps, each
    named by the harness's range the host was in, from the profiler, within
    the host's `portbench.window` range (the profiler runs on through the
    drain). A kernel counts where it starts inside the window; busy time is
    clipped to it. The harness's own ranges also appear on the device's
    timeline (as user annotations); they are host ranges and count as no
    device work."""
    from torch.autograd import DeviceType

    def span_s(e):
        a = e.start_ns() * 1e-9
        return a, a + e.duration_ns() * 1e-9

    events = prof.profiler.kineto_results.events()
    wa, wb = next(span_s(e) for e in events
                  if e.name() == "portbench.window" and e.device_type() == DeviceType.CPU)
    dev_spans, host, kern = [], [], {}
    for e in events:
        a, b = span_s(e)
        if e.name().startswith("portbench."):
            if e.name() != "portbench.window":
                host.append((a, b, e.name()))
        elif e.device_type() == DeviceType.CUDA and wa <= a < wb:
            dev_spans.append((a, min(b, wb)))
            n, s = kern.get(e.name(), (0, 0.0))
            kern[e.name()] = (n + 1, s + (b - a))
    from portbench.roofline import union_s

    view.kernels = kern
    view.busy_s = union_s(dev_spans) if dev_spans else 0.0
    view.device_ops = [[n, s] for n, (_, s) in sorted(kern.items(), key=lambda kv: -kv[1][1])
                       ][:BREAKDOWN_ENTRIES]
    gaps = []
    dev_spans.sort()
    host.sort()
    starts = [h[0] for h in host]
    end = None
    for a, b in dev_spans:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            i = bisect.bisect_right(starts, mid) - 1
            name = host[i][2] if i >= 0 and host[i][1] >= mid else "portbench.other"
            gaps.append([name, a - end])
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: -g[1])
    view.gaps = gaps
