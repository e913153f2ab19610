"""The port's evaluation harness (`qwen3_tts_tpu_torch/evaluation.py`)
against the JAX package's.

- The metrics are numpy in both packages: equal to the bit on the same
  arrays (SNR, SI-SDR, LSD, MCD, the report, text normalization, WER / CER,
  cosine similarity).
- ECAPA speaker similarity with the same weights (each package's speaker
  encoder, fp32): within 1e-5.
- The runner on a tiny checkpoint this module writes (talker, speaker
  encoder, a 12 Hz tokenizer under speech_tokenizer/; no reference repo):
  the tokenizer round trip's metrics within 1e-4 relative of the JAX
  runner's (each package's fp32 encode and decode), the same unavailable
  markers and the same skip rows; with the port's stand-ins (a text
  tokenizer, an ASR callable) its synthesis suite reports the WER and
  speaker similarity of its own generations.
- `evaluate_tts_wer` with a fake ASR whose transcript depends on the
  audio's length: the same WER as the JAX package's (fp32 greedy codes are
  equal in both packages, tests/test_torch_pipeline.py).
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import evaluation as jev
from qwen3_tts_tpu_torch import evaluation as tev
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from tests.test_torch_pipeline import FakeTokenizer, _models, checkpoint  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


def _signals(n_ref=24000, n_deg=23500, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n_ref) / 24000
    ref = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(size=n_ref)).astype(np.float32)
    deg = (np.resize(ref, n_deg) + 0.1 * rng.normal(size=n_deg)).astype(np.float32)
    return ref, deg


@pytest.mark.parametrize("name", ["snr_db", "si_sdr_db", "log_spectral_distance_db",
                                  "mcd_db", "reconstruction_report"])
def test_signal_metrics_equal_jax(name):
    for n_ref, n_deg in ((24000, 23500), (700, 900)):   # aligned, and shorter than n_fft
        ref, deg = _signals(n_ref, n_deg)
        assert getattr(tev, name)(ref, deg) == getattr(jev, name)(ref, deg)


def test_text_metrics_equal_jax():
    pairs = [("Hello, WORLD!", "hello world", "en"), ("a b c d", "a x c d", "en"),
             ("a b", "a b c", "en"), ("你好世界", "你好地界", "zh"), ("", "extra", "en"),
             ("Ｆｕｌｌ　width_text", "full width text", "en")]
    for ref, hyp, lang in pairs:
        assert tev.normalize_text(ref, lang) == jev.normalize_text(ref, lang)
        assert tev.wer(ref, hyp, lang) == jev.wer(ref, hyp, lang)
    got = tev.evaluate_wer([p[0] for p in pairs[:3]], [p[1] for p in pairs[:3]])
    want = jev.evaluate_wer([p[0] for p in pairs[:3]], [p[1] for p in pairs[:3]])
    assert (got.wer, got.per_utterance) == (want.wer, want.per_utterance)
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=64), rng.normal(size=64)
    assert tev.cosine_similarity(a, b) == jev.cosine_similarity(a, b)


def test_ecapa_similarity_matches_jax():
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig
    from qwen3_tts_tpu_torch.utils.testing import speaker_encoder_state
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    cfg = SpeakerEncoderConfig(mel_dim=128, enc_dim=64, enc_channels=[16, 16, 16, 16, 48],
                               enc_kernel_sizes=[5, 3, 3, 3, 1], enc_dilations=[1, 2, 3, 4, 1],
                               enc_attention_channels=8, enc_res2net_scale=4,
                               enc_se_channels=8)
    state = speaker_encoder_state(cfg, 3)
    a, b = _signals(12000, 11000, seed=2)
    got = tev.speaker_similarity_ecapa(from_jax_tree(state), cfg, a, b)
    want = jev.speaker_similarity_ecapa(jax.tree_util.tree_map(jnp.asarray, state), cfg, a, b)
    assert abs(got - want) < 1e-5
    assert abs(got) < 1.0


@pytest.fixture(scope="module")
def eval_assets(tmp_path_factory):
    """A custom-voice checkpoint with a speaker encoder and a 12 Hz
    tokenizer under speech_tokenizer/, two 1 kHz wavs, and a manifest of a
    row with reference audio and a row without."""
    from qwen3_tts_tpu.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.config import CodecV2Config, MimiEncoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.utils.audio import write_wav
    from qwen3_tts_tpu_torch.utils.testing import (codec12_tokenizer_checkpoint,
                                                   speaker_encoder_state)
    from qwen3_tts_tpu_torch.weights import (flatten_state_dict, save_safetensors,
                                             talker_params_to_state_dict, from_jax_tree)
    from tests.test_codec12_encoder import TINY as ENC_TINY
    from tests.test_pipeline_parity import MODEL_TINY
    from tests.test_torch_pipeline import DEC_CFG

    d = tmp_path_factory.mktemp("eval")
    ckpt = d / "ckpt"
    (ckpt / "speech_tokenizer").mkdir(parents=True)
    cfg_json = json.loads(json.dumps(MODEL_TINY))
    cfg_json["speaker_encoder_config"].update(mel_dim=128)
    tc = TTSModelConfig.from_dict(cfg_json)
    jp = random_talker_params(tc.talker_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    sd = talker_params_to_state_dict(from_jax_tree(jax.tree_util.tree_map(
        lambda x: np.asarray(x) * 3.0, jp)), tc.talker_config)
    sd.update({k: torch.from_numpy(np.asarray(v)) for k, v in flatten_state_dict(
        speaker_encoder_state(tc.speaker_encoder_config, 1), "speaker_encoder").items()})
    save_safetensors(str(ckpt / "model.safetensors"), sd)
    with open(ckpt / "config.json", "w") as f:
        json.dump(cfg_json, f)
    # 2048 samples a frame, so one generated frame is long enough for the
    # speaker encoder's dilated convolutions
    dec = dataclasses.replace(DEC_CFG, upsample_rates=(4, 4, 4, 4), upsampling_ratios=(2, 4))
    codec = CodecV2Config(encoder_config=MimiEncoderConfig.from_dict(ENC_TINY),
                          decoder_config=dec, encoder_valid_num_quantizers=4,
                          input_sample_rate=1000, output_sample_rate=1000,
                          decode_upsample_rate=dec.total_upsample, encode_downsample_rate=16)
    tok_json, tok_state = codec12_tokenizer_checkpoint(codec, 3)
    save_safetensors(str(ckpt / "speech_tokenizer" / "model.safetensors"), tok_state)
    with open(ckpt / "speech_tokenizer" / "config.json", "w") as f:
        json.dump(tok_json, f)
    wavs = d / "wavs"
    wavs.mkdir()
    rng = np.random.default_rng(7)
    for i, n in enumerate((800, 1200)):
        t = np.arange(n)
        write_wav(str(wavs / f"u{i}.wav"), 0.3 * np.sin(t / (3 + i)) + 0.02 * rng.normal(size=n),
                  1000)
    write_wav(str(d / "ref.wav"), 0.3 * np.sin(np.arange(4000) / 4.0), 1000)
    manifest = d / "manifest.jsonl"
    with open(manifest, "w") as f:
        f.write(json.dumps({"text": "speak like the reference", "lang": "en",
                            "ref_audio": str(d / "ref.wav"), "ref_text": "a reference"}) + "\n")
        f.write(json.dumps({"text": "a custom voice line", "lang": "en"}) + "\n")
    return d, ckpt


def _args(d, ckpt, **kw):
    a = dict(ckpt=str(ckpt), tokenizer_ckpt=None, suite="all", manifest=str(d / "manifest.jsonl"),
             wav_dir=str(d / "wavs"), asr="none", asr_ckpt=None, lang="en", speaker=None,
             max_items=10, max_new_tokens=8, out=None, device="cpu")
    a.update(kw)
    return types.SimpleNamespace(**a)


def test_runner_matches_jax(eval_assets):
    d, ckpt = eval_assets
    args = _args(d, ckpt)
    got, want = tev.run_suite(args), jev.run_suite(args)
    assert got["skipped"] == want["skipped"]
    assert "seed_tts" in got["skipped"]      # no text tokenizer asset in either
    assert set(got["suites"]) == set(want["suites"]) == {"tokenizer_roundtrip"}
    g, w = got["suites"]["tokenizer_roundtrip"], want["suites"]["tokenizer_roundtrip"]
    assert set(g) == set(w)
    for k in w:
        if isinstance(w[k], float):
            assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-4), k
        else:
            assert g[k] == w[k], k
    assert {k for k, v in g.items() if isinstance(v, str)} == {"pesq_wb", "pesq_nb", "stoi",
                                                               "utmos"}
    assert tev._format_table(got).splitlines()[:2] == jev._format_table(want).splitlines()[:2]
    # the missing-asset rows
    bad = _args(d, d / "nowhere", wav_dir=None, manifest=None)
    assert tev.run_suite(bad)["skipped"].keys() == jev.run_suite(bad)["skipped"].keys()


def test_roundtrip_harness_matches_jax(eval_assets):
    from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok

    d, ckpt = eval_assets
    tok_dir = str(ckpt / "speech_tokenizer")
    rng = np.random.default_rng(3)
    wavs = [(0.2 * rng.normal(size=(n,))).astype(np.float32) for n in (900, 1300)]
    got = tev.evaluate_tokenizer_roundtrip(TTok.from_pretrained(tok_dir, device="cpu"), wavs,
                                           1000)
    want = jev.evaluate_tokenizer_roundtrip(JTok.from_pretrained(tok_dir), wavs, 1000)
    assert set(got) == set(want) == {"snr_db", "si_sdr_db", "lsd_db", "mcd_db"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-4), k


def test_runner_synthesis_suite_with_stand_ins(eval_assets, tmp_path):
    """With a stand-in text tokenizer and ASR the synthesis suite runs: the
    WER is the stand-in transcript's, the speaker similarity an ECAPA
    cosine of the reference row's generation; `main` writes the same JSON
    report; a Whisper request without a checkpoint marks the column."""
    d, ckpt = eval_assets
    heard = []

    def asr(wav, sr):
        heard.append(wav.shape[0])
        return "speak like the reference"

    rep = tev.run_suite(_args(d, ckpt, suite="seed-tts"), processor=FakeTokenizer(),
                        asr_fn=asr)
    out = rep["suites"]["seed_tts"]
    assert out["n_utterances"] == 2 and len(heard) == 2 and "seed_tts" not in rep["skipped"]
    want_wer = np.mean([0.0, tev.wer("a custom voice line", "speak like the reference")])
    assert out["wer"] == round(float(want_wer), 4)
    # the reference row's generation is sampled (the runner passes no
    # seed): its similarity is an ECAPA cosine, a number in [-1, 1]
    assert isinstance(out["speaker_sim"], float) and -1.0 <= out["speaker_sim"] <= 1.0
    whisper = tev.run_suite(_args(d, ckpt, suite="seed-tts", asr="whisper"),
                            processor=FakeTokenizer())
    assert whisper["suites"]["seed_tts"]["wer"] == "unavailable (no --asr-ckpt given)"
    path = tmp_path / "report.json"
    assert tev.main(["--ckpt", str(ckpt), "--wav-dir", str(d / "wavs"), "--suite", "tokenizer",
                     "--device", "cpu", "--out", str(path)]) == 0
    with open(path) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(tev.run_suite(_args(d, ckpt, suite="tokenizer"))))


def test_evaluate_tts_wer_matches_jax(checkpoint):  # noqa: F811
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    texts = ["the first line to speak", "a second and longer line to speak"]

    def asr(wav, sr):
        n = int(np.asarray(wav).shape[-1]) // 7 % 5
        return " ".join(["the", "second", "line", "to", "speak"][:n])

    kw = dict(do_sample=False, subtalker_dosample=False, max_new_tokens=10)
    got = tev.evaluate_tts_wer(tm, texts, asr, speaker="vivian", **kw)
    want = jev.evaluate_tts_wer(jm, texts, asr, speaker="vivian", **kw)
    assert got.per_utterance == want.per_utterance
    assert got.wer == want.wer
