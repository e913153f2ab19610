"""The port's profiling utilities (`qwen3_tts_tpu_torch/utils/profiling.py`):
`device_trace` writes a Chrome trace on the CPU in which `annotate` regions
nest. Its serving-path recorder is tested in tests/test_torch_tracing.py."""

import json

import pytest
import torch

from qwen3_tts_tpu_torch.utils import profiling as tprof
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


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
