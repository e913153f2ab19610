"""The port's profiling utilities (`qwen3_tts_tpu_torch/utils/profiling.py`)
against the JAX package's: the same stage records give the same summary and
report, the same latencies the same percentiles; `device_trace` writes a
Chrome trace on the CPU in which `annotate` regions nest."""

import json

import numpy as np
import pytest
import torch

from qwen3_tts_tpu.utils import profiling as jprof
from qwen3_tts_tpu_torch.utils import profiling as tprof
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


def test_stage_timers_match_jax():
    r = np.random.default_rng(0)
    jt, tt = jprof.StageTimers(), tprof.StageTimers()
    for name in ("prefill", "decode", "vocode"):
        for s in r.uniform(1e-4, 0.2, size=int(r.integers(1, 9))):
            jt.add(name, float(s))
            tt.add(name, float(s))
    assert tt.summary() == jt.summary()
    assert tt.report() == jt.report()
    assert tt.percentile("decode", 90) == jt.percentile("decode", 90)
    with tt.stage("work"):
        torch.ones(64).sum()
    assert tt.summary()["work"]["count"] == 1 and tt.records["work"][0] >= 0


def test_first_packet_meter_matches_jax():
    jm, tm = jprof.FirstPacketMeter(), tprof.FirstPacketMeter()
    assert tm.p50() is None and tm.p95() is None
    for s in np.random.default_rng(1).uniform(0.01, 0.5, size=17):
        jm.observe(float(s))
        tm.observe(float(s))
    assert (tm.p50(), tm.p95()) == (jm.p50(), jm.p95())
    assert tm.latencies_ms == jm.latencies_ms


def test_device_trace_writes_a_trace_with_nested_annotations(tmp_path):
    with tprof.device_trace(str(tmp_path)) as prof:
        with tprof.annotate("outer"):
            with tprof.annotate("inner"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
    assert any(e.name == "inner" for e in prof.events())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("name") in ("outer", "inner")
             and e.get("ph") == "X"}
    assert set(spans) == {"outer", "inner"}
    o, i = spans["outer"], spans["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
