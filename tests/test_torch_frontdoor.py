"""The port's serving front door on the CPU: `ThreadedTTSServer`, the demo
CLI (`cli/demo.py`: parser, `_HttpDemo` over localhost, `_launch_gradio`
with a stub gradio), `warmup_model` and `Qwen3TTSProcessor`; counterparts
of tests/test_server.py, tests/test_peripherals.py and
tests/test_gradio_ui.py, which need the reference checkout.

The models are the port's, on the tiny checkpoint of
tests/test_torch_pipeline.py (fp32, greedy). Tolerances: audio served
through the engine against `generate_custom_voice` (streaming text layout):
atol 1e-5 (the same codes; the vocoder runs other batch shapes), as
tests/test_torch_serving.py holds it; audio through HTTP is 16-bit PCM of
it: within one PCM step.
"""

import base64
import io
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.inference.processor import Qwen3TTSProcessor as JProcessor
from qwen3_tts_tpu_torch.cli import demo
from qwen3_tts_tpu_torch.inference.processor import Qwen3TTSProcessor
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.runtime.server import ThreadedTTSServer, TTSServer
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from tests.test_gradio_ui import _Blocks, gradio_stub  # noqa: F401
from tests.test_torch_pipeline import _models, checkpoint  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

GREEDY = dict(do_sample=False, subtalker_dosample=False)
M = 8   # max_new_tokens
AUDIO_TOL = dict(atol=1e-5, rtol=0)
PCM_STEP = 1.0 / 32767


@pytest.fixture(scope="module")
def tm(checkpoint):  # noqa: F811
    _, model = _models(checkpoint, jnp.float32, torch.float32)
    model.generate_defaults = dict(GREEDY, max_new_tokens=M)
    return model


def _threaded(model, **kw):
    kw.setdefault("num_slots", 2)
    return ThreadedTTSServer(TTSServer(model, prefill_bucket=48, max_trailing=32, **kw))


def _want(model, text):
    wavs, sr = model.generate_custom_voice([text], speaker="vivian", language="english",
                                           non_streaming_mode=False)
    return wavs[0], sr


def test_threaded_server_concurrent_requests(tm):
    """Four producer threads synthesize at once (twice the slots) and one
    streams: every result equals generate_custom_voice, the stream's packets
    concatenate to its text's result, and the server drains."""
    texts = [f"concurrent request number {i}" for i in range(4)]
    srv = _threaded(tm)
    results, errors = {}, []

    def post(i):
        try:
            results[i] = srv.synthesize("custom_voice", text=texts[i], speaker="vivian",
                                        language="english", timeout=300)
        except Exception as e:  # pragma: no cover - reported below
            errors.append((i, e))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        pkts = list(srv.synthesize_stream("custom_voice", text=texts[0], speaker="vivian",
                                          language="english", timeout=300))
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i, text in enumerate(texts):
            want, sr = _want(tm, text)
            wav, got_sr = results[i]
            assert got_sr == sr and wav.shape == want.shape
            np.testing.assert_allclose(wav, want, **AUDIO_TOL)
        assert pkts and pkts[-1].final and sum(p.final for p in pkts) == 1
        np.testing.assert_allclose(np.concatenate([p.wav for p in pkts]), results[0][0],
                                   **AUDIO_TOL)
        deadline = time.time() + 30
        while srv.server.busy and time.time() < deadline:
            time.sleep(0.01)
        assert not srv.server.busy
    finally:
        srv.close()


def test_threaded_server_stream_close_frees_slot(tm):
    """Closing a stream generator early cancels its request: the only slot
    frees, a queued request then runs and its audio is correct, and a
    failing submit reaches its caller while the server stays up."""
    srv = _threaded(tm, num_slots=1)
    try:
        gen = srv.synthesize_stream("custom_voice", text="cancel me early", speaker="vivian",
                                    language="english")
        next(gen)           # live, holding the only slot
        gen.close()         # client disconnect -> cancel
        wav, sr = srv.synthesize("custom_voice", text="the survivor", speaker="vivian",
                                 language="english", timeout=120)
        want, wsr = _want(tm, "the survivor")
        assert sr == wsr
        np.testing.assert_allclose(wav, want, **AUDIO_TOL)
        with pytest.raises(ValueError, match="Unsupported speakers"):
            srv.synthesize("custom_voice", text="who?", speaker="nobody", timeout=60)
        assert not srv.server.busy
    finally:
        srv.close()


def test_threaded_server_poisoned_step_fails_every_request(tm, monkeypatch):
    """A step that raises fails every in-flight request with that error and
    aborts the server's state, instead of hanging the callers."""
    srv = _threaded(tm)
    try:
        def boom():
            raise RuntimeError("poisoned step")
        monkeypatch.setattr(srv.server, "step", boom)
        with pytest.raises(RuntimeError, match="poisoned"):
            srv.synthesize("custom_voice", text="doomed", speaker="vivian", timeout=60)
        # the loop thread aborts the server's state right after delivering
        deadline = time.time() + 30
        while srv.server.busy and time.time() < deadline:
            time.sleep(0.01)
        assert not srv.server.busy
    finally:
        srv.close()


def test_cli_parser_surface(capsys):
    """The JAX CLI's flags, the same overrides; --vocoder-device names a
    CUDA card, and an index the host does not have is a parser error that
    names the host's device count (before any model loads)."""
    args = demo.build_parser().parse_args(
        ["ckpt", "--port", "9000", "--dtype", "float32", "--top-k", "5", "--no-sample",
         "--kv-quant", "--warmup"])
    assert args.checkpoint == "ckpt" and args.port == 9000 and args.warmup
    assert demo._gen_overrides(args) == {"top_k": 5, "do_sample": False, "kv_quant": True}
    from qwen3_tts_tpu.cli.demo import build_parser as j_parser

    flags = {a.dest for a in demo.build_parser()._actions}
    assert flags == {a.dest for a in j_parser()._actions}
    assert demo.build_parser().parse_args(["ckpt", "--vocoder-device", "1"]).vocoder_device == 1
    with pytest.raises(SystemExit) as e:
        demo.main(["ckpt", "--vocoder-device", "1"])
    assert e.value.code == 2
    assert f"this host has {torch.cuda.device_count()} CUDA device(s)" in capsys.readouterr().err


def test_cli_vocoder_device_reaches_the_server(tm, monkeypatch):
    """`--vocoder-device N` on a host with more than N cards builds
    `TTSServer(..., vocoder_device=torch.device("cuda", N))` (the JAX CLI
    indexes jax.devices()); without it, vocoder_device is None."""
    from qwen3_tts_tpu_torch.inference import model as model_mod
    from qwen3_tts_tpu_torch.runtime import server as server_mod

    built = []

    class StubServer:
        def __init__(self, model, **kw):
            built.append(kw)

    class StubHttp:
        def __init__(self, model, kind, overrides, concurrency, engine=None):
            self.engine = engine

        def serve(self, *a):
            return None

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(model_mod.Qwen3TTSModel, "from_pretrained",
                        classmethod(lambda cls, *a, **kw: tm))
    monkeypatch.setattr(server_mod, "TTSServer", StubServer)
    monkeypatch.setattr(server_mod, "ThreadedTTSServer", lambda server: server)
    monkeypatch.setattr(demo, "_HttpDemo", StubHttp)
    monkeypatch.setitem(sys.modules, "gradio", None)   # no gradio: the HTTP demo
    demo.main(["ckpt", "--vocoder-device", "1"])
    demo.main(["ckpt"])
    assert [kw["vocoder_device"] for kw in built] == [torch.device("cuda", 1), None]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(http):
    port = _free_port()
    t = threading.Thread(target=http.serve, args=("127.0.0.1", port), daemon=True)
    t.start()
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                assert json.loads(r.read())["ok"]
            return port, t
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    raise AssertionError("demo server did not come up")


def _post(port, path, payload, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _wav_of(b64: str) -> np.ndarray:
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32767.0


@pytest.mark.parametrize("engine", [True, False])
def test_http_demo_end_to_end(tm, engine):
    """`_HttpDemo` on localhost, over ThreadedTTSServer (concurrent /tts and
    a chunked /tts_stream) or the static generate path (/tts only): the
    audio is the PCM of generate_custom_voice, /info names the speakers, a
    malformed request gets a 400 and the server stays up."""
    srv = _threaded(tm) if engine else None
    http = demo._HttpDemo(tm, "custom_voice", {}, concurrency=1, engine=srv)
    port, thread = _serve(http)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info") as r:
            info = json.loads(r.read())
        assert info["speakers"] == ["vivian"] and info["model_type"] == "custom_voice"
        texts = [f"hello over http {i}" for i in range(3 if engine else 1)]
        got, errors = {}, []

        def post(i):
            try:
                with _post(port, "/tts", {"task": "custom_voice", "text": texts[i],
                                          "speaker": "vivian", "language": "english",
                                          "non_streaming_mode": False}) as r:
                    got[i] = json.loads(r.read())
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors, errors
        for i, text in enumerate(texts):
            want, sr = _want(tm, text) if engine else tm.generate_custom_voice(
                [text], speaker="vivian", language="english")
            want = want if engine else want[0]
            assert got[i]["sample_rate"] == sr == 1000 and len(got[i]["wavs_b64"]) == 1
            wav = _wav_of(got[i]["wavs_b64"][0])
            assert wav.shape == want.shape
            np.testing.assert_allclose(wav, np.clip(want, -1, 1), atol=PCM_STEP, rtol=0)
        if engine:
            with _post(port, "/tts_stream", {"task": "custom_voice", "text": texts[0],
                                             "speaker": "vivian",
                                             "language": "english"}) as r:
                assert r.headers["X-Sample-Rate"] == "1000"
                pcm = np.frombuffer(r.read(), "<i2") / 32767.0
            want, _ = _want(tm, texts[0])
            np.testing.assert_allclose(pcm, np.clip(want, -1, 1), atol=PCM_STEP, rtol=0)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, "/tts", {"task": "custom_voice"}, timeout=60)
        assert err.value.code == 400 and "error" in json.loads(err.value.read())
    finally:
        http._server.shutdown()
        thread.join(timeout=10)
        if srv is not None:
            srv.close()


def _launch(model, kind):
    args = demo.build_parser().parse_args(["unused", "--port", "7999"])
    demo._launch_gradio(model, kind, {"seed": 0}, args)
    ui = _Blocks.current
    assert ui.launched is not None and ui.launched["server_port"] == 7999
    return ui


def test_gradio_ui_with_stub(tm, gradio_stub, tmp_path):  # noqa: F811
    """_launch_gradio builds each model kind's UI on a stub gradio: the
    custom-voice Generate handler returns generate_custom_voice's audio;
    the clone UI wires its three handlers, and its save and load handlers
    report bad input as a status instead of raising."""
    ui = _launch(tm, "custom_voice")
    fn, inputs, _ = ui.handlers["Generate"]
    assert len(inputs) == 4
    sr, wav = fn("hello from the ui", "vivian", "english", "")
    want, wsr = tm.generate_custom_voice(["hello from the ui"], speaker="vivian",
                                         language="english", seed=0)
    assert sr == wsr == 1000
    np.testing.assert_array_equal(wav, want[0])
    assert set(_launch(tm, "voice_design").handlers) == {"Generate"}
    ui = _launch(tm, "base")
    assert set(ui.handlers) == {"Generate", "Save voice prompt", "Generate from voice prompt"}
    out, status = ui.handlers["Save voice prompt"][0](None, "", False)
    assert out is None and "required" in status
    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a torch file")
    out, status = ui.handlers["Generate from voice prompt"][0](str(bad), "text", "auto")
    assert out is None and status != "Finished."


def test_warmup_model_runs_the_eager_route_on_cpu(tm, monkeypatch):
    """warmup_model routes each (batch, bucket) as _run does, on the CPU
    through the eager loop, every frame up to the budget: it returns its
    seconds and captures nothing."""
    from qwen3_tts_tpu_torch.runtime import generate
    from qwen3_tts_tpu_torch.runtime.warmup import warmup_model

    def no_capture(*a, **k):
        raise AssertionError("a capture on the CPU")

    steps = []
    real = generate.frame_step
    monkeypatch.setattr(graphs, "capture", no_capture)
    monkeypatch.setattr(generate, "frame_step", lambda *a, **k: steps.append(1) or real(*a, **k))
    secs = warmup_model(tm, prefill_buckets=(16,), batch_sizes=(1, 2), max_new_tokens=4,
                        verbose=False)
    assert secs > 0 and len(steps) == 2 * 3   # two shapes, max_new_tokens - 1 frames each


class _StandInTokenizer:
    """What the processor forwards to: records the keyword arguments."""

    model_input_names = ["input_ids", "attention_mask", "input_ids"]

    def __call__(self, text, **kw):
        ids = [[1 + (ord(c) * 7 + i) % 39 for i, c in enumerate(t)] for t in text]
        return {"input_ids": ids, "kwargs": kw}

    def decode(self, ids, **kw):
        return "".join(chr(97 + i % 26) for i in ids)

    def batch_decode(self, batch, **kw):
        return [self.decode(ids) for ids in batch]

    def apply_chat_template(self, conversations, chat_template=None, **kw):
        return {"conversations": conversations, "chat_template": chat_template, **kw}


def test_processor_matches_jax_surface():
    """Qwen3TTSProcessor forwards exactly as the JAX package's processor:
    text wrapped in a list, left padding and numpy tensors by default,
    decode passthrough, the chat template by keyword, deduplicated input
    names; a missing text raises."""
    t, j = Qwen3TTSProcessor(_StandInTokenizer()), JProcessor(_StandInTokenizer())
    for p in (t, j):
        with pytest.raises(ValueError):
            p()
    assert t("hello") == j("hello")
    assert t("hello")["kwargs"] == {"padding": False, "padding_side": "left",
                                    "return_tensors": "np"}
    assert t(["a", "bc"], return_tensors="pt") == j(["a", "bc"], return_tensors="pt")
    assert t.decode([1, 2]) == j.decode([1, 2]) and t.batch_decode([[3]]) == ["d"]
    conv = {"role": "user", "content": "hi"}
    assert t.apply_chat_template([conv], chat_template="T") == \
        j.apply_chat_template([conv], chat_template="T")
    assert t.apply_chat_template([conv])["conversations"] == [[conv]]
    assert t.model_input_names == ["input_ids", "attention_mask"]
