"""`TTSServer(vocoder_device=...)` of the port on the CPU: the vocoder on a
device of its own (here the CPU, the only one), against the one-device
server and `generate_custom_voice`, and against the JAX package's
`TTSServer(vocoder_device=jax.devices()[0])`; the decode tokenizer, the
warm-up on the vocoder device, `ThreadedTTSServer` over such a server, and
`build.pinning`'s device filter (a capture on one card pins nothing of
another).

The models are the port's (and the JAX package's) on the tiny checkpoint of
tests/test_torch_pipeline.py (fp32, greedy). Tolerances: the vocoder-device
server against the one-device server with `fast_first_packet=False`: equal
(the same codes, the same vocoder calls on the same device); against
`generate_custom_voice` and the JAX server: atol 1e-5 (the same codes; the
vocoder runs other batch shapes), as tests/test_torch_serving.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.runtime.server import AudioPacket as JPacket
from qwen3_tts_tpu.runtime.server import AudioResult as JResult
from qwen3_tts_tpu.runtime.server import TTSServer as JServer
from qwen3_tts_tpu_torch.ops.cuda import build
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.runtime import server as tserver
from qwen3_tts_tpu_torch.runtime.server import (AudioPacket, AudioResult, ThreadedTTSServer,
                                                TTSServer)
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from tests.test_torch_pipeline import _models, checkpoint  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

GREEDY = dict(do_sample=False, subtalker_dosample=False)
M = 8   # max_new_tokens
TEXTS = ["first sample text", "the second one", "and request three"]
AUDIO_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def both(checkpoint):  # noqa: F811
    return _models(checkpoint, jnp.float32, torch.float32)


def _server(model, cls=TTSServer, **kw):
    kw.setdefault("num_slots", 2)
    return cls(model, prefill_bucket=48, max_trailing=32, overrides=GREEDY, max_new_tokens=M,
               **kw)


def _serve(srv):
    """Three non-streamed requests and a stream of the first text: (results
    by id, the stream's packets)."""
    for i, t in enumerate(TEXTS):
        srv.submit_custom_voice(f"r{i}", text=t, speaker="vivian", language="english")
    srv.submit_custom_voice("s0", text=TEXTS[0], speaker="vivian", language="english",
                            stream=True)
    events = srv.run_until_drained()
    assert not srv.busy
    results = {e.request_id: e for e in events if isinstance(e, (AudioResult, JResult))}
    pkts = [e for e in events if isinstance(e, (AudioPacket, JPacket)) and e.request_id == "s0"]
    assert set(results) == {"r0", "r1", "r2"} and pkts and pkts[-1].final
    return results, pkts


def test_vocoder_device_server_matches_one_device_server_and_generate(both):
    """With vocoder_device="cpu" the results, each stream packet and the
    codes equal a one-device server built with fast_first_packet=False (the
    same schedule), and the audio equals generate_custom_voice's; the server
    vocodes on a copy of the decoder params, the model's tokenizer object
    and its params untouched."""
    _, tm = both
    tok = tm.speech_tokenizer
    params, leaves = tok.dec_params, dict(tok.dec_params)
    runs = {}
    for name, kw in (("vocoder", dict(vocoder_device="cpu")),
                     ("one", dict(fast_first_packet=False))):
        codes = {}
        srv = _server(tm, code_sink=lambda rid, fr, codes=codes: codes.setdefault(
            rid, []).extend(fr), **kw)
        runs[name] = (srv, codes) + _serve(srv)
    srv, codes, results, pkts = runs["vocoder"]
    _, codes1, results1, pkts1 = runs["one"]
    assert srv.vocoder_device == torch.device("cpu") and srv.fast_first_packet is False
    assert srv.dec_params is not params and srv._decode_tok is not tok
    assert srv._decode_tok.dec_params is srv.dec_params
    assert graphs.params_device(srv.dec_params) == torch.device("cpu")
    assert tm.speech_tokenizer is tok and tok.dec_params is params and dict(params) == leaves
    assert set(codes) == set(codes1)
    for rid in codes:
        np.testing.assert_array_equal(np.stack(codes[rid]), np.stack(codes1[rid]))
    for rid, r in results.items():
        np.testing.assert_array_equal(r.wav, results1[rid].wav)
    assert [(p.frame_start, p.frame_count, p.final) for p in pkts] == \
        [(p.frame_start, p.frame_count, p.final) for p in pkts1]
    for p, q in zip(pkts, pkts1):
        np.testing.assert_array_equal(p.wav, q.wav)
    want, sr = tm.generate_custom_voice(TEXTS, speaker="vivian", language="english",
                                        non_streaming_mode=False, max_new_tokens=M, **GREEDY)
    for i in range(3):
        got = results[f"r{i}"]
        assert got.sample_rate == sr and got.wav.shape == want[i].shape
        np.testing.assert_allclose(got.wav, want[i], **AUDIO_TOL)
    np.testing.assert_allclose(np.concatenate([p.wav for p in pkts]), want[0], **AUDIO_TOL)


def test_vocoder_device_server_matches_jax_server(both):
    """The port's server with its vocoder on the CPU against the JAX
    package's with `vocoder_device=jax.devices()[0]` (its first packets off
    too): the same packets (frame spans, finals) and the same audio."""
    jm, tm = both
    jres, jpkts = _serve(_server(jm, JServer, vocoder_device=jax.devices()[0]))
    res, pkts = _serve(_server(tm, vocoder_device="cpu"))
    for rid, r in jres.items():
        assert res[rid].sample_rate == r.sample_rate
        np.testing.assert_allclose(res[rid].wav, np.asarray(r.wav), **AUDIO_TOL)
    assert [(p.frame_start, p.frame_count, p.final) for p in pkts] == \
        [(p.frame_start, p.frame_count, p.final) for p in jpkts]
    for p, q in zip(pkts, jpkts):
        np.testing.assert_allclose(p.wav, np.asarray(q.wav), **AUDIO_TOL)


def test_completions_decode_through_the_vocoder_tokenizer(both, monkeypatch):
    """`_finish_results` decodes through `_decode_tok` (the copy holding the
    vocoder device's params), never through the model's tokenizer."""
    _, tm = both
    srv = _server(tm, vocoder_device="cpu")
    calls = []
    decode = srv._decode_tok.decode

    def counted(encoded, **kw):
        calls.append(len(encoded))
        return decode(encoded, **kw)

    def refused(*a, **kw):
        raise AssertionError("the model's tokenizer decoded a completion")

    monkeypatch.setattr(srv._decode_tok, "decode", counted)
    monkeypatch.setattr(tm.speech_tokenizer, "decode", refused)
    for i, t in enumerate(TEXTS[:2]):
        srv.submit_custom_voice(f"r{i}", text=t, speaker="vivian", language="english")
    results = [e for e in srv.run_until_drained() if isinstance(e, AudioResult)]
    assert len(results) == 2 and calls and all(n & (n - 1) == 0 for n in calls)


def test_warmup_vocodes_every_egress_shape_on_the_vocoder_device(both, monkeypatch):
    """`warmup()` with a vocoder device vocodes every `egress_shapes()` entry
    on the vocoder's params, decodes every completion batch through
    `_decode_tok` and runs no first-packet extract; a one-device server's
    warm-up runs the extract once per `first_packet_shapes()` entry (each
    row bucket, at T = F)."""
    _, tm = both
    seen, fast = [], []
    rows = tserver._vocode_rows_compact

    def recorded(params, cfg, codes, ctx, F_, pcm16=False):
        seen.append((params, graphs.params_device(params), codes.shape[0], codes.shape[2], F_))
        return rows(params, cfg, codes, ctx, F_, pcm16=pcm16)

    def first(*a, **kw):
        fast.append((a[3].shape[0], a[-1], a[-2]))
        return torch.zeros((1,)), torch.zeros((1,), dtype=torch.int32)

    monkeypatch.setattr(tserver, "_vocode_rows_compact", recorded)
    monkeypatch.setattr(tserver, "_first_packet_vocode", first)
    srv = _server(tm, num_slots=3, vocoder_device="cpu")
    decodes = []
    decode = srv._decode_tok.decode
    monkeypatch.setattr(srv._decode_tok, "decode",
                        lambda enc, **kw: decodes.append(len(enc)) or decode(enc, **kw))
    assert srv.warmup() > 0
    assert [(n, t, f) for _, _, n, t, f in seen] == srv.egress_shapes()
    assert all(p is srv.dec_params and d == torch.device("cpu") for p, d, _, _, _ in seen)
    assert fast == [] and decodes == [1, 2, 4]
    seen.clear()
    one = _server(tm, num_slots=3)
    one.warmup()
    assert fast == one.first_packet_shapes()
    assert all(p is tm.speech_tokenizer.dec_params for p, _, _, _, _ in seen)


def test_threaded_server_over_a_vocoder_device(both):
    """`ThreadedTTSServer` over a server with a vocoder device answers
    `synthesize` and `synthesize_stream` with generate_custom_voice's
    audio."""
    _, tm = both
    want, sr = tm.generate_custom_voice(TEXTS[:2], speaker="vivian", language="english",
                                        non_streaming_mode=False, max_new_tokens=M, **GREEDY)
    srv = ThreadedTTSServer(_server(tm, vocoder_device="cpu"))
    try:
        wav, got_sr = srv.synthesize("custom_voice", text=TEXTS[0], speaker="vivian",
                                     language="english", timeout=300)
        pkts = list(srv.synthesize_stream("custom_voice", text=TEXTS[1], speaker="vivian",
                                          language="english", timeout=300))
    finally:
        srv.close()
    assert got_sr == sr and not srv._thread.is_alive()
    np.testing.assert_allclose(wav, want[0], **AUDIO_TOL)
    assert pkts and pkts[-1].final
    np.testing.assert_allclose(np.concatenate([p.wav for p in pkts]), want[1], **AUDIO_TOL)


@pytest.mark.parametrize("vocoder_device", ["cuda:1", 1, torch.device("cuda", 0), "cuda"])
def test_vocoder_device_on_absent_cuda_raises(both, vocoder_device):
    """A CUDA vocoder device where CUDA is absent raises: no fallback to
    the CPU."""
    _, tm = both
    with pytest.raises(RuntimeError, match="CUDA"):
        _server(tm, vocoder_device=vocoder_device)


def test_pinning_collects_only_its_devices_states(monkeypatch):
    """`build.pinning(device)` collects the launch states keyed to that
    device index (a capture on one card pins nothing of another);
    `pinning()` collects every state; nested blocks each keep their own."""
    monkeypatch.setattr(build, "_STATE", build.OrderedDict())
    w = [torch.zeros(2) for _ in range(3)]

    def get(dev, i):
        return build.launch_state(("t", dev, 0, i), [w[i]], lambda st: None)

    with build.pinning() as every:
        with build.pinning(1) as one:
            a, b = get(0, 0), get(1, 1)
            with build.pinning(0) as zero:
                c = get(0, 2)
    assert every == [a, b, c] and one == [b] and zero == [c]
    assert build._PINNING == []
