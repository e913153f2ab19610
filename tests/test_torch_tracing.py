"""The serving path's tracing (`utils/profiling.py` `Tracer` and `clock`,
the spans and counters of `runtime/batching.py` and `runtime/server.py`)
and the benchmark's readers of them (`portbench/metrics/`), on a tiny CPU
`TTSServer` built as tests/test_torch_serving.py builds it, over a model of
the tiny configuration of tests/test_torch_pipeline.py with random weights
drawn in memory. Device spans need CUDA events, so here they run on an
event double."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import qwen3_tts_tpu_torch.runtime.server as server_mod
from qwen3_tts_tpu_torch.config import CodecV2Config, CodecV2DecoderConfig, TTSModelConfig
from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
from qwen3_tts_tpu_torch.runtime.server import AudioPacket, TTSServer
from qwen3_tts_tpu_torch.utils import profiling
from qwen3_tts_tpu_torch.utils.metrics import MetricsRegistry
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, random_talker_params,
                                               random_vocoder_params)
from tests.test_codec12_decoder import TINY as DEC_TINY
from tests.test_pipeline_parity import MODEL_TINY
from tests.test_torch_pipeline import FakeTokenizer

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

ROOT = Path(__file__).resolve().parents[1]
TEXTS = ["first sample text", "the second one", "and request three", "a fourth, longer one"]
GREEDY = dict(do_sample=False, subtalker_dosample=False)


class FakeEvent:
    """A timing event double: `done` says whether the card has reached it."""

    made = 0

    def __init__(self):
        FakeEvent.made += 1
        self.recorded = 0
        self.done = False

    def record(self, stream=None):
        self.recorded += 1

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return 2.5


@pytest.fixture(scope="module")
def model():
    cfg = TTSModelConfig.from_dict(MODEL_TINY)
    gen = torch.Generator().manual_seed(0)
    dec = CodecV2DecoderConfig(**DEC_TINY)
    tok = Qwen3TTSTokenizer.from_params(
        CodecV2Config(decoder_config=dec, output_sample_rate=1000,
                      decode_upsample_rate=dec.total_upsample),
        dec_params=random_vocoder_params(dec, gen))
    return Qwen3TTSModel(cfg, random_talker_params(cfg.talker_config, gen, dtype=torch.float32),
                         None, tok, FakeTokenizer(), {}, device="cpu")


def _server(model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_bucket", 48)
    kw.setdefault("max_trailing", 32)
    return TTSServer(model, overrides=GREEDY, max_new_tokens=8, metrics=MetricsRegistry(),
                     **kw)


def _submit(srv, rid, i, stream=True, max_frames=None):
    srv.submit_custom_voice(rid, text=TEXTS[i % len(TEXTS)], speaker="vivian",
                            language="english", stream=stream, max_frames=max_frames)


@pytest.fixture(scope="module")
def traced(model):
    """A drained run of a traced server (two streams, one non-streamed
    request, more requests than slots), the shapes of every vocoder call
    it made, its packets, spans and counters."""
    calls = []
    egress, first = server_mod._vocode_rows_compact, server_mod._first_packet_vocode

    def egress_spy(params, cfg, codes, ctx, F_, pcm16=False):
        calls.append(tuple(codes.shape))
        return egress(params, cfg, codes, ctx, F_, pcm16=pcm16)

    def first_spy(params, cfg, aux, rids, B, ticks, Q, F_, T, pcm16=False):
        calls.append((len(rids), Q, T))
        return first(params, cfg, aux, rids, B, ticks, Q, F_, T, pcm16=pcm16)

    mp = pytest.MonkeyPatch()
    mp.setattr(server_mod, "_vocode_rows_compact", egress_spy)
    mp.setattr(server_mod, "_first_packet_vocode", first_spy)
    try:
        srv = _server(model, packet_frames=3)
        srv.engine.trace_enabled = True
        for i, (rid, stream) in enumerate((("a", True), ("b", False), ("c", True))):
            _submit(srv, rid, i, stream)
        events = srv.run_until_drained()
    finally:
        mp.undo()
    return SimpleNamespace(srv=srv, calls=calls, events=events, spans=srv.trace_spans(),
                           counters=dict(srv.metrics.snapshot()["counters"]))


def test_switch_off_records_nothing(model):
    """Tracing off (the default): no span, no stamp, no timing event and
    no span counter, through a whole run; the work counters still count."""
    FakeEvent.made = 0
    srv = _server(model)
    srv.tracer.event = FakeEvent
    for i in range(3):
        _submit(srv, f"r{i}", i)
    srv.run_until_drained()
    counters = srv.metrics.snapshot()["counters"]
    assert srv.trace_spans() == [] and not srv.engine.trace and FakeEvent.made == 0
    assert not [k for k in counters if k.endswith((".host_ms", ".device_ms", ".n"))]
    assert counters["server.vocode_frames_delivered"] > 0
    assert counters["engine.staged_rows"] == 3
    assert srv.tracer.span("x") is srv.tracer.span("y")   # one shared no-op


def test_spans_nest_under_step_with_self_time(traced):
    """Every span but `server.step` and `server.submit` runs inside a step;
    a span's self time is its duration less its children's; each span
    name's counters sum its spans."""
    by_id = {s.id: s for s in traced.spans}
    names = {s.name for s in traced.spans}
    assert {"server.step", "server.submit", "server.fast_first", "server.fast_first_wait",
            "server.egress", "server.egress_wait", "engine.stage", "engine.launch",
            "engine.aux_wait", "engine.attribute"} <= names
    for s in traced.spans:
        assert s.start <= s.end
        if s.name in ("server.step", "server.submit"):
            assert s.parent is None
            continue
        top = s
        while top.parent is not None:
            parent = by_id[top.parent]
            assert parent.start <= top.start and top.end <= parent.end
            top = parent
        assert top.name == "server.step", s
    for name in ("server.egress_wait", "server.fast_first_wait"):
        assert all(by_id[s.parent].name == name.rsplit("_", 1)[0]
                   for s in traced.spans if s.name == name)
    for s in traced.spans:
        kids = sum((k.end - k.start) * 1e3 for k in traced.spans if k.parent == s.id)
        assert s.self_ms == pytest.approx((s.end - s.start) * 1e3 - kids, abs=1e-6)
    submits = [s for s in traced.spans if s.name == "server.submit"]
    assert [s.request_id for s in submits] == ["a", "b", "c"]
    for name in names:
        mine = [s for s in traced.spans if s.name == name]
        assert traced.counters[f"{name}.n"] == len(mine)
        assert traced.counters[f"{name}.host_ms"] == pytest.approx(
            sum((s.end - s.start) * 1e3 for s in mine))
    assert traced.srv.trace_spans() == []   # popped


def test_work_counters_equal_hand_counts(traced):
    """`server.vocode_frames_delivered` is the frames of every packet,
    `server.vocode_frames_computed` rows x frames of every vocoder call
    (the fast first packet's and the egress's), `server.vocode_calls` those
    calls, and the staging counters the requests staged and their padded
    rows."""
    pkts = [e for e in traced.events if isinstance(e, AudioPacket)]
    assert {p.request_id for p in pkts} == {"a", "c"}
    c = traced.counters
    assert c["server.vocode_frames_delivered"] == sum(p.frame_count for p in pkts)
    assert traced.calls and c["server.vocode_frames_computed"] == sum(
        n * t for n, _, t in traced.calls)
    assert c["server.vocode_calls"] == len(traced.calls)
    assert c["engine.staged_rows"] == 3
    assert 3 <= c["engine.staged_rows_padded"] <= 4
    assert c["server.vocode_frames_computed"] > c["server.vocode_frames_delivered"]


def test_clock_brackets_a_profiler_range():
    """Stamps of `clock()` taken around a `record_function` range bracket
    the range's Kineto start and end (the profiler's clock), within 5 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a = profiling.clock()
        with record_function("tracing.probe"):
            torch.ones(64, 64).sum()
        b = profiling.clock()
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "tracing.probe"]
    start = ev.start_ns() * 1e-9
    end = start + ev.duration_ns() * 1e-9
    assert a - 5e-3 <= start <= end <= b + 5e-3
    assert b - a < 1.0


def test_device_spans_resolve_only_once_done():
    """A device span's events bracket the replays inside its block (the
    graph layer's hook: `before`, `after`); `resolve` adds its device
    milliseconds only once the end event reports done, and keeps it
    pending until then. A block with no replay records nothing; off, a
    device span arms nothing."""
    reg = MetricsRegistry()
    tr = profiling.Tracer(reg, event=FakeEvent)
    with tr.device_span("engine.chunk", "cpu"):
        assert profiling.armed() is None
    tr.enabled = True
    with tr.device_span("engine.chunk", "cpu") as span:
        assert profiling.armed() is span
        with tr.device_span("server.vocode", "cpu") as inner:
            assert profiling.armed() is inner
        assert profiling.armed() is span
        for _ in range(3):          # three tick replays
            span.before()
            span.after()
    assert profiling.armed() is None
    assert span.start.recorded == 1 and span.end.recorded == 3
    assert tr._device == [span]     # the inner span saw no replay
    tr.resolve()
    assert "engine.chunk.device_ms" not in reg.counters and tr._device == [span]
    span.end.done = True
    tr.resolve()
    assert reg.counters["engine.chunk.device_ms"] == 2.5 and tr._device == []
    tr.resolve()
    assert reg.counters["engine.chunk.device_ms"] == 2.5


def test_first_packet_trace_of_a_single_final_packet(model):
    """A stream whose first packet is also its last gets its own stamps
    back, not those of another request with a first packet; a second call,
    and a call for an unknown id, give None."""
    srv = _server(model)
    srv.engine.trace_enabled = True
    _submit(srv, "one", 0, max_frames=1)
    _submit(srv, "long", 1)
    got, pkts = {}, []
    while srv.busy:
        for e in srv.step():
            pkts.append(e)
            if e.request_id not in got and e.request_id == "one":
                got[e.request_id] = srv.first_packet_trace(e.request_id)
    one = [p for p in pkts if p.request_id == "one"]
    assert len(one) == 1 and one[0].final and one[0].frame_count == 1
    stamps = got["one"]
    assert set(stamps) == {"submit", "staged", "first_frame", "first_packet"}
    assert stamps["submit"] <= stamps["staged"] <= stamps["first_frame"] <= stamps[
        "first_packet"]
    long_stamps = srv.first_packet_trace("long")
    assert long_stamps is None or long_stamps["submit"] > stamps["submit"]
    assert srv.first_packet_trace("one") is None and srv.first_packet_trace("nobody") is None


def test_stamps_of_cancelled_and_earlier_requests_are_dropped(model):
    """A request submitted before the switch turned on gets no stamps; a
    cancelled request's stamps go with it; a drained server keeps none."""
    srv = _server(model, packet_frames=2)
    _submit(srv, "before", 0)
    srv.step()
    srv.engine.trace_enabled = True
    _submit(srv, "gone", 1)
    _submit(srv, "kept", 2, stream=False)
    before = srv._by_user_id["before"]
    srv.step()
    assert before not in srv.engine.trace and srv.first_packet_trace("before") is None
    gone = srv._by_user_id["gone"]
    assert gone in srv.engine.trace
    assert srv.cancel("gone") and gone not in srv.engine.trace
    srv.run_until_drained()
    assert not srv.engine.trace and not srv._finished_traces


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


RUN_COUNTERS = {
    "engine.ticks": 400.0, "engine.chunk.device_ms": 4400.0,
    "engine.staged_rows": 50.0, "engine.stage.device_ms": 250.0,
    "server.vocode.device_ms": 900.0, "server.fast_first.device_ms": 100.0,
    "server.vocode_frames_computed": 3600.0, "server.vocode_frames_delivered": 1000.0,
    "server.step.host_ms": 3000.0, "server.submit.host_ms": 500.0,
    "server.fast_first_wait.host_ms": 200.0, "engine.aux_wait.host_ms": 1000.0,
    "server.egress_wait.host_ms": 300.0,
}


@pytest.mark.parametrize("name, want", [
    ("tick_device_ms", 11.0),               # 4400 ms over 400 ticks
    ("stage_device_ms", 5.0),               # 250 ms over 50 requests
    ("vocoder_ms_per_audio_s", 10.0),       # (900 + 100) ms over 100 s of audio
    ("vocoder_frames_per_frame", 3.6),      # 3600 frames computed for 1000
    ("host_step_busy_pct", 20.0),           # 3000 + 500 - 1500 ms of a 10 s window
])
def test_metric_readers_on_a_hand_built_run(name, want):
    """Each reader on a hand-built run view, and None on a run whose
    program records none of its counters (the parent of this tracing)."""
    read = _reader(name)
    run = SimpleNamespace(counters=dict(RUN_COUNTERS), window_s=10.0, audio_s=100.0)
    assert read(run) == pytest.approx(want)
    bare = {"engine.ticks": 400.0, "engine.frames": 9000.0}
    assert read(SimpleNamespace(counters=bare, window_s=10.0, audio_s=100.0)) is None
