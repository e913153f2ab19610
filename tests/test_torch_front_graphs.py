"""The clone front end as captured graphs, on the CPU: the keys of
`FrontGraphs` (with the vocoder owner's capture replaced by a stand-in, as
`test_torch_codec_graphs.py` does) and the mel spectrogram's constants.

- the tokenizer's encode through `front_call`: one graph per padded (rows,
  samples), the padding the JAX package's 8-frame bucket, captured at a
  key's second call (its first runs eagerly); codes equal to the eager
  route's and to the JAX package's `Qwen3TTSTokenizer.encode`;
- `extract_speaker_embedding` through `front_call`: one graph per exact
  sample count, replayed on clips its capture never saw; the embedding
  equal to the eager route's and within 1e-4 relative of the JAX
  package's (a 20-conv fp32 chain);
- inside `graphs.replay_only()` (a server's submit) nothing is captured,
  a held graph still replays; the seen keys are bounded; a server's submit
  runs its front end that way, and its warm-up's reference lengths are
  the 8-frame buckets its prefill admits;
- a run of distinct clip lengths past MAX_ENCODE_GRAPHS evicts encode
  graphs only: the vocoder's graphs and their keys stay; ECAPA's exact
  lengths past MAX_ECAPA_GRAPHS leave the encode's graphs as they were;
- `mel_spectrogram` within 1e-5 of the JAX package's (FFTs sum in another
  order) at the speaker encoder's settings and with a window shorter than
  n_fft; its window and filterbank are built once per (parameters,
  device): a second call builds neither.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models import speaker_encoder as jspk
from qwen3_tts_tpu.ops.stft import mel_spectrogram as j_mel
from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models import speaker_encoder as tspk
from qwen3_tts_tpu_torch.ops import stft
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, speaker_encoder_state
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_encoders import SPK_TINY, _encoders

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


class _FakeGraph:
    def __init__(self, run):
        self.run = run

    def replay(self, dev, generator):
        dev.replays += 1
        self.run()


@pytest.fixture
def fake_front(monkeypatch):
    """A stand-in CPU device whose vocoder, front-end and 25 Hz tokenizer
    owners capture by running the body once and replay by running it again
    into the static outputs; the graph layer on."""
    dev = graphs._Device.__new__(graphs._Device)
    dev.device, dev.captures, dev.replays = torch.device("cpu"), 0, 0
    dev.contexts = graphs.OrderedDict()
    dev.codec = graphs.CodecGraphs(dev, graphs.MAX_CODEC_GRAPHS)
    dev.encode = graphs.FrontGraphs(dev, graphs.MAX_ENCODE_GRAPHS)
    dev.ecapa = graphs.FrontGraphs(dev, graphs.MAX_ECAPA_GRAPHS)
    dev.campplus = graphs.FrontGraphs(dev, graphs.MAX_CAMPPLUS_GRAPHS)
    dev.dit_step = graphs.StepGraphs(dev, graphs.MAX_DIT_STEP_GRAPHS)

    def fake_capture(self, params, body, inputs):
        bufs = tuple(x.clone() for x in inputs)
        outs = tuple(body(*bufs))
        self.dev.captures += 1

        def run():
            for o, v in zip(outs, body(*bufs)):
                o.copy_(v)

        return graphs._CodecGraph(params, bufs, outs, _FakeGraph(run))

    monkeypatch.setattr(graphs.KeyedGraphs, "_capture", fake_capture)
    monkeypatch.setattr(graphs.KeyedGraphs, "_load",
                        staticmethod(lambda bufs, xs: [b.copy_(x) for b, x in zip(bufs, xs)]))
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER[0])
    monkeypatch.setattr(graphs, "_device", lambda device: dev)
    return dev


def _clip(n, seed):
    return (0.3 * np.random.default_rng(seed).normal(size=(n,))).clip(-1, 1).astype(np.float32)


def test_encode_graphs_keyed_by_the_eight_frame_bucket(fake_front):
    (tp, t_cfg), (jp, j_cfg) = _encoders(seed=3)
    tok = TTok.from_params(t_cfg, enc_params=tp)
    jtok = JTok.from_params(j_cfg, enc_params=jp)
    sr, ds = t_cfg.input_sample_rate, t_cfg.encode_downsample_rate
    bucket = 8 * ds
    clips = [_clip(bucket - 5, 0), _clip(bucket // 2, 1), _clip(bucket + 3, 2)]
    # the first two pad to one bucket: the first call runs eagerly, the
    # second captures; the third's bucket is captured in the second round
    got = [tok.encode((c, sr)).audio_codes[0] for c in clips + clips]
    keys = list(fake_front.encode.graphs)
    assert [k[2] for k in keys] == ["encode", "encode"]
    assert [k[5] for k in keys] == [(((1, bucket), torch.float32),),
                                    (((1, 2 * bucket), torch.float32),)]
    assert fake_front.captures == 2 and fake_front.replays == 4
    pair = [(clips[0], sr), (clips[2], sr)]
    two = [tok.encode(pair).audio_codes for _ in range(2)]   # ragged rows
    assert list(fake_front.encode.graphs)[-1][5] == (((2, 2 * bucket), torch.float32),)
    assert fake_front.captures == 3 and not fake_front.ecapa.graphs
    with graphs.eager():
        want = [tok.encode((c, sr)).audio_codes[0] for c in clips]
    for g, w, c in zip(got, want + want, clips + clips):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, jtok.encode((c, sr)).audio_codes[0])
    for rows in two:
        for g, (c, _) in zip(rows, pair):
            np.testing.assert_array_equal(g, jtok.encode((c, sr)).audio_codes[0])


def test_ecapa_graphs_keyed_by_exact_length(fake_front):
    cfg = SpeakerEncoderConfig.from_dict(SPK_TINY)
    state = speaker_encoder_state(cfg, seed=2)
    params = from_jax_tree(state)
    # 6000 eagerly, 6001 eagerly, 6000 captured with the third clip, 6001
    # with the fourth, then the first clip replays the graph of the third
    clips = [_clip(6000, 3), _clip(6001, 4), _clip(6000, 5), _clip(6001, 6), _clip(6000, 3)]
    got = [tspk.extract_speaker_embedding(params, cfg, c) for c in clips]
    keys = list(fake_front.ecapa.graphs)
    assert [k[2] for k in keys] == ["ecapa", "ecapa"]
    # least recently used first: the last call replayed the 6000 graph
    assert [k[5] for k in keys] == [(((6001,), torch.float32),), (((6000,), torch.float32),)]
    assert fake_front.captures == 2 and fake_front.replays == 3
    assert not torch.equal(got[4], got[2])
    with graphs.eager():
        want = [tspk.extract_speaker_embedding(params, cfg, c) for c in clips]
    jparams = jax.tree_util.tree_map(jnp.asarray, state)
    for g, w, c in zip(got, want, clips):
        assert torch.equal(g, w)
        j = np.asarray(jspk.extract_speaker_embedding(jparams, cfg, jnp.asarray(c)))
        assert np.linalg.norm(g.numpy() - j) / np.linalg.norm(j) < 1e-4


def _double(x):
    return (x * 2,)


def test_replay_only_captures_nothing_and_seen_keys_are_bounded(fake_front, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_FRONT_SEEN", 3)
    params = {"w": torch.zeros(1)}

    def call(n):
        return graphs.front_call(params, None, "ecapa", (), _double, torch.ones(n))[0]

    call(5)
    with graphs.replay_only():
        for _ in range(3):
            assert torch.equal(call(5), torch.full((5,), 2.0))
    assert fake_front.captures == 0 and not fake_front.ecapa.graphs
    call(5)                              # seen before: captured, then replayed
    assert fake_front.captures == 1 and fake_front.replays == 1
    with graphs.replay_only():
        call(5)                          # a held graph replays there too
        call(6), call(6)
    assert fake_front.captures == 1 and fake_front.replays == 2
    for n in (7, 8, 9):                  # the oldest seen key (5, then 6) goes
        call(n)
    assert [k[5][0][0] for k in fake_front.ecapa.seen] == [(7,), (8,), (9,)]
    call(6)                              # forgotten: eager again
    assert fake_front.captures == 1


def test_server_submit_is_replay_only_and_warms_every_reference_bucket():
    from types import SimpleNamespace

    from qwen3_tts_tpu_torch.runtime.server import TTSServer
    from qwen3_tts_tpu_torch.utils.metrics import MetricsRegistry
    from qwen3_tts_tpu_torch.utils.profiling import Tracer

    seen = []

    def specs(*a, **k):
        seen.append(getattr(graphs._LOCAL, "replay_only", False))
        return [], [SimpleNamespace(ref_code=None)]

    srv = SimpleNamespace(model=SimpleNamespace(_specs_voice_clone=specs),
                          _submit_specs=lambda *a: seen.append("submitted"),
                          _sampling_overrides=lambda **k: (None, None),
                          tracer=Tracer(MetricsRegistry()))
    TTSServer.submit_voice_clone(srv, "r", text="hi", voice_clone_prompt=[None])
    assert seen == [True, "submitted"] and not getattr(graphs._LOCAL, "replay_only", False)
    tok = SimpleNamespace(get_encode_downsample_rate=lambda: 1920)
    for bucket, n in ((128, 16), (130, 17), (512, 64), (2048, graphs.MAX_ENCODE_GRAPHS)):
        srv = SimpleNamespace(model=SimpleNamespace(speech_tokenizer=tok),
                              engine=SimpleNamespace(prefill_bucket=bucket))
        assert TTSServer.reference_lengths(srv) == [k * 8 * 1920 for k in range(1, n + 1)]


def test_front_graphs_never_evict_vocoder_graphs(fake_front, monkeypatch):
    """Clips of many lengths past MAX_ENCODE_GRAPHS: the encode's own LRU
    goes, least recently used first; the vocoder's graphs stay, keys and
    all."""
    monkeypatch.setattr(fake_front.encode, "bound", 2)
    monkeypatch.setattr(fake_front.codec, "bound", 3)
    dec_params = {"_codebooks": torch.zeros(1)}
    for n in (2, 3, 4):
        graphs.codec_call(dec_params, None, "rows", (n,), False, lambda a: (a * 2,),
                          torch.ones(n))
    vocoder = list(fake_front.codec.graphs)
    (tp, t_cfg), _ = _encoders(seed=3)
    tok = TTok.from_params(t_cfg, enc_params=tp)
    sr, bucket = t_cfg.input_sample_rate, 8 * t_cfg.encode_downsample_rate
    for i in range(1, 6):
        for _ in range(2):
            tok.encode((_clip(i * bucket, i), sr))
    assert list(fake_front.codec.graphs) == vocoder and len(vocoder) == 3
    assert [k[5][0][0] for k in fake_front.encode.graphs] == [(1, 4 * bucket), (1, 5 * bucket)]


def test_ecapa_lengths_never_evict_encode_graphs(fake_front, monkeypatch):
    monkeypatch.setattr(fake_front.ecapa, "bound", 2)
    enc, spk = {"w": torch.zeros(1)}, {"v": torch.zeros(1)}
    for _ in range(2):
        graphs.front_call(enc, None, "encode", (), _double, torch.ones(1, 8))
    encode = list(fake_front.encode.graphs)
    for n in range(10, 16):
        for _ in range(2):
            graphs.front_call(spk, None, "ecapa", (), _double, torch.ones(n))
    assert list(fake_front.encode.graphs) == encode and len(encode) == 1
    assert [k[5][0][0] for k in fake_front.ecapa.graphs] == [(14,), (15,)]


@pytest.mark.parametrize("win_size", [1024, 640])
def test_mel_spectrogram_matches_jax_and_builds_constants_once(monkeypatch, win_size):
    calls = {"window": 0, "filterbank": 0}
    real_window, real_fb = stft.hann_window, stft.mel_filterbank

    def window(*a):
        calls["window"] += 1
        return real_window(*a)

    def filterbank(*a):
        calls["filterbank"] += 1
        return real_fb(*a)

    monkeypatch.setattr(stft, "hann_window", window)
    monkeypatch.setattr(stft, "mel_filterbank", filterbank)
    monkeypatch.setattr(stft, "_MEL_CONSTANTS", {})
    y = np.stack([_clip(7000, 6), _clip(7000, 7)])
    kw = dict(n_fft=1024, num_mels=128, sampling_rate=24000, hop_size=256,
              win_size=win_size, fmin=0, fmax=12000)
    want = np.asarray(j_mel(jnp.asarray(y), **kw))
    first = stft.mel_spectrogram(torch.from_numpy(y), **kw)
    second = stft.mel_spectrogram(torch.from_numpy(y), **kw)
    single = stft.mel_spectrogram(torch.from_numpy(y[:1]), **kw)
    assert calls == {"window": 1, "filterbank": 1}
    np.testing.assert_allclose(first.numpy(), want, rtol=1e-5, atol=1e-5)
    # a row of a batch is not bit-equal to the same row alone on every
    # host: the filterbank einsum's BLAS splits the batch by thread count
    # (2.4e-7 apart at 4 threads and more); a second call on the same batch is
    assert torch.equal(second, first)
    np.testing.assert_allclose(single.numpy(), want[:1], rtol=1e-5, atol=1e-5)
