"""The port's reference-audio front end against the JAX package: audio I/O,
the mel spectrogram, the ECAPA speaker encoder, the Mimi encoder and the
tokenizer's `encode`.

Both packages get the same numpy weights from the port's seeded
fabricators (`speaker_encoder_state`, `mimi_encoder_state`). Tolerances:
- WAV/FLAC decode and resampling: bit-equal (the same numpy code);
- mel spectrogram: 1e-5 (FFTs sum in another order);
- speaker embedding: 1e-4 relative (a 20-conv fp32 chain);
- Mimi pre-quantisation features: 1e-4; codes equal (fp32 argmins whose
  margins are far above the feature error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodecV2Config as JCodecCfg
from qwen3_tts_tpu.config import CodecV2DecoderConfig as JDecCfg
from qwen3_tts_tpu.config import MimiEncoderConfig as JMimiCfg
from qwen3_tts_tpu.config import SpeakerEncoderConfig as JSpkCfg
from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models.codec12 import encoder as jenc
from qwen3_tts_tpu.models import speaker_encoder as jspk
from qwen3_tts_tpu.ops import conv as jconv
from qwen3_tts_tpu.ops.stft import mel_spectrogram as j_mel
from qwen3_tts_tpu_torch.config import (CodecV2Config, CodecV2DecoderConfig,
                                        MimiEncoderConfig, SpeakerEncoderConfig)
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models.codec12 import encoder as tenc
from qwen3_tts_tpu_torch.models import speaker_encoder as tspk
from qwen3_tts_tpu_torch.ops.stft import mel_spectrogram as t_mel
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, mimi_encoder_state,
                                               speaker_encoder_state)
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_codec12_decoder import TINY as DEC_TINY
from tests.test_codec12_encoder import TINY as ENC_TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

SPK_TINY = dict(mel_dim=128, enc_dim=32, enc_channels=[16, 16, 16, 16, 48],
                enc_kernel_sizes=[5, 3, 3, 3, 1], enc_dilations=[1, 2, 3, 4, 1],
                enc_attention_channels=8, enc_res2net_scale=4, enc_se_channels=8)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _codec_cfgs():
    """(port config, JAX config) of one tiny 12 Hz tokenizer."""
    kw = dict(encoder_valid_num_quantizers=ENC_TINY["num_quantizers"],
              input_sample_rate=ENC_TINY["sampling_rate"], output_sample_rate=1000,
              decode_upsample_rate=64, encode_downsample_rate=16)
    t = CodecV2Config(encoder_config=MimiEncoderConfig.from_dict(ENC_TINY),
                      decoder_config=CodecV2DecoderConfig.from_dict(DEC_TINY), **kw)
    j = JCodecCfg(encoder_config=JMimiCfg.from_dict(ENC_TINY),
                  decoder_config=JDecCfg.from_dict(DEC_TINY), **kw)
    return t, j


def _encoders(seed=0):
    """Prepared Mimi encoder trees of both packages from one numpy tree."""
    t_cfg, j_cfg = _codec_cfgs()
    state = mimi_encoder_state(t_cfg.encoder_config, seed)
    jp = jenc.prepare_encoder_params(jax.tree_util.tree_map(jnp.asarray, state),
                                     j_cfg.encoder_config)
    tp = tenc.prepare_encoder_params(from_jax_tree(state), t_cfg.encoder_config)
    return (tp, t_cfg), (jp, j_cfg)


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_audio_read_and_resample_match_jax(tmp_path, fmt):
    from qwen3_tts_tpu.utils import audio as jaudio
    from qwen3_tts_tpu.utils.flac import write_flac
    from qwen3_tts_tpu_torch.utils import audio as taudio

    rng = np.random.default_rng(0)
    x = (0.4 * rng.uniform(-1, 1, (3000, 2))).astype(np.float32)
    path = str(tmp_path / f"a.{fmt}")
    (jaudio.write_wav if fmt == "wav" else write_flac)(path, x, 16000)
    (wt, srt), (wj, srj) = taudio.load_audio(path), jaudio.load_audio(path)
    assert srt == srj == 16000 and wt.ndim == 1
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(taudio.resample(wt, 16000, 24000),
                                  jaudio.resample(wj, 16000, 24000))
    items = taudio.normalize_audio_inputs([path, (x, 16000)])
    assert [s for _, s in items] == [16000, 16000]


def test_mel_spectrogram_matches_jax():
    rng = np.random.default_rng(1)
    y = (0.3 * rng.normal(size=(2, 6000))).clip(-1, 1).astype(np.float32)
    kw = dict(n_fft=1024, num_mels=128, sampling_rate=24000, hop_size=256,
              win_size=1024, fmin=0, fmax=12000)
    want = np.asarray(j_mel(jnp.asarray(y), **kw))
    got = t_mel(torch.tensor(y), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_speaker_embedding_matches_jax():
    cfg, jcfg = SpeakerEncoderConfig.from_dict(SPK_TINY), JSpkCfg.from_dict(SPK_TINY)
    state = speaker_encoder_state(cfg, seed=2)
    audio = (0.3 * np.random.default_rng(3).normal(size=(12000,))).astype(np.float32)
    want = np.asarray(jspk.extract_speaker_embedding(
        jax.tree_util.tree_map(jnp.asarray, state), jcfg, jnp.asarray(audio)))
    got = tspk.extract_speaker_embedding(from_jax_tree(state), cfg, audio).numpy()
    assert got.shape == (SPK_TINY["enc_dim"],)
    assert _rel(got, want) < 1e-4, _rel(got, want)


def test_mimi_fabricator_writes_the_checkpoint_layout():
    """The numpy fabricator's keys and shapes are HF MimiModel's encoder
    half: the tree the tokenizer loads from a checkpoint's `encoder.*`."""
    from transformers import MimiConfig, MimiModel

    from qwen3_tts_tpu.weights import flatten_state_dict

    want = {k: tuple(v.shape) for k, v in MimiModel(MimiConfig(**ENC_TINY)).state_dict().items()
            if not k.startswith(("decoder", "upsample"))}
    state = mimi_encoder_state(MimiEncoderConfig.from_dict(ENC_TINY), 0)
    got = {k: tuple(np.shape(v)) for k, v in flatten_state_dict(state).items()}
    assert got == want


def test_mimi_encoder_features_and_codes_match_jax():
    (tp, t_cfg), (jp, j_cfg) = _encoders()
    ecfg = j_cfg.encoder_config
    wav = np.random.default_rng(4).uniform(-1, 1, (2, 400)).astype(np.float32)
    h = jenc.seanet_encode(jp["encoder"], ecfg, jnp.asarray(wav)[:, None, :])
    h = jenc.encoder_transformer(jp["encoder_transformer"], ecfg, jnp.transpose(h, (0, 2, 1)))
    want_feats = np.asarray(jconv.causal_conv1d(
        jnp.transpose(h, (0, 2, 1)), jp["downsample"]["conv"]["weight"], None, stride=2,
        pad_mode="replicate"))
    got_feats = tenc.encoder_features(tp, t_cfg.encoder_config, torch.tensor(wav)).numpy()
    assert got_feats.shape == want_feats.shape
    np.testing.assert_allclose(got_feats, want_feats, rtol=1e-4, atol=1e-4)
    want = np.asarray(jenc.encode_waveform(jp, ecfg, jnp.asarray(wav)))
    got = tenc.encode_waveform(tp, t_cfg.encoder_config, torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (2, ENC_TINY["num_quantizers"], 400 // 16)
    np.testing.assert_array_equal(got, want)


def test_tokenizer_encode_ragged_matches_jax():
    """Ragged batch (8-frame bucket, per-row ceil(len / 16) trim), a (wav, sr)
    tuple at another rate (resampled first), and the decode of the codes."""
    (tp, t_cfg), (jp, j_cfg) = _encoders(seed=5)
    from qwen3_tts_tpu.utils.testing import random_vocoder_params

    vocoder = random_vocoder_params(j_cfg.decoder_config, jax.random.PRNGKey(6))
    ttok = TTok.from_params(t_cfg, enc_params=tp, dec_params=from_jax_tree(vocoder))
    jtok = JTok.from_params(j_cfg, enc_params=jp, dec_params=vocoder)
    rng = np.random.default_rng(7)
    wavs = [rng.uniform(-0.5, 0.5, (n,)).astype(np.float32) for n in (330, 170)]
    for audios, sr in ((wavs, 1000), ((wavs[1], 2000), None)):
        got, want = ttok.encode(audios, sr=sr), jtok.encode(audios, sr=sr)
        assert len(got.audio_codes) == len(want.audio_codes)
        for a, b in zip(got.audio_codes, want.audio_codes):
            assert a.dtype == np.int64 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    enc = ttok.encode(wavs, sr=1000)
    assert [c.shape[0] for c in enc.audio_codes] == [-(-330 // 16), -(-170 // 16)]
    wt, _ = ttok.decode(enc)
    wj, _ = jtok.decode(jtok.encode(wavs, sr=1000))
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_tokenizer_from_pretrained_loads_the_encoder(tmp_path):
    """A tokenizer checkpoint with `encoder.*` and `decoder.*` loads both
    halves onto the CPU when asked, and the encoder matches from_params."""
    import json

    from qwen3_tts_tpu.weights import flatten_state_dict, save_safetensors
    from tests.test_torch_pipeline import DEC_CFG

    t_cfg, _ = _codec_cfgs()
    state = mimi_encoder_state(t_cfg.encoder_config, 8)
    rng = np.random.default_rng(9)

    def rvq(n):
        return {"output_proj": {"weight": rng.normal(0, 0.3, (DEC_CFG.codebook_dim, 8, 1))
                                .astype(np.float32)},
                "vq": {"layers": {str(i): {"_codebook": {
                    "cluster_usage": np.ones((DEC_CFG.codebook_size,), np.float32),
                    "embedding_sum": rng.normal(0, 1, (DEC_CFG.codebook_size, 8))
                    .astype(np.float32)}} for i in range(n)}}}

    from qwen3_tts_tpu.utils.testing import random_vocoder_params

    dec = {k: v for k, v in random_vocoder_params(DEC_CFG, jax.random.PRNGKey(3)).items()
           if k != "_codebooks"}
    dec["quantizer"] = {"rvq_first": rvq(1), "rvq_rest": rvq(DEC_CFG.num_quantizers - 1)}
    flat = flatten_state_dict(state, "encoder")
    flat.update(flatten_state_dict(dec, "decoder"))
    save_safetensors(str(tmp_path / "model.safetensors"),
                     {k: np.asarray(v) for k, v in flat.items()})
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "qwen3_tts_tokenizer_12hz", "encoder_config": ENC_TINY,
                   "decoder_config": {k: list(v) if isinstance(v, tuple) else v
                                      for k, v in DEC_TINY.items()},
                   "encoder_valid_num_quantizers": 4, "input_sample_rate": 1000,
                   "output_sample_rate": 1000, "decode_upsample_rate": 64,
                   "encode_downsample_rate": 16}, f)
    tok = TTok.from_pretrained(str(tmp_path), device="cpu")
    ref = TTok.from_params(t_cfg, enc_params=tenc.prepare_encoder_params(
        from_jax_tree(state), t_cfg.encoder_config))
    wav = np.random.default_rng(10).uniform(-0.5, 0.5, (250,)).astype(np.float32)
    np.testing.assert_array_equal(tok.encode(wav, sr=1000).audio_codes[0],
                                  ref.encode(wav, sr=1000).audio_codes[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTok.from_pretrained(str(tmp_path))
