"""The port's 25 Hz (V1) tokenizer against the JAX package: mel front ends,
the windowed Whisper-VQ encoder and its codes, one DiT velocity evaluation,
the DiT sampler with and without CFG, BigVGAN, and the tokenizer end to
end from a checkpoint directory (config.json, model.safetensors,
campplus.onnx) that both packages load.

Both packages get identical weights: the port's numpy fabricator
`codec_v1_state` (JAX as is, the port through `from_jax_tree` or the
safetensors file). The sampler's noise is JAX's, passed to the port.
Tolerances (fp32 on the CPU):
- mels: atol 1e-5 (whisper) / 1e-4 (the BigVGAN mel is a log of |.|);
- codes: equal, a clip whose last attention window is partial included;
- one DiT velocity evaluation and the sampler: relative L2 1e-4;
- BigVGAN and the decoded waveforms: atol 5e-5 (values up to 1 after ~40
  fp32 convolutions summed in another order); int16 within 1 LSB.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import BigVGANConfig as JBigVGANCfg
from qwen3_tts_tpu.config import CodecV1Config as JCodecV1Cfg
from qwen3_tts_tpu.config import DiTConfig as JDiTCfg
from qwen3_tts_tpu.config import WhisperVQEncoderConfig as JEncCfg
from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models.codec25 import bigvgan as jbig
from qwen3_tts_tpu.models.codec25 import dit as jdit
from qwen3_tts_tpu.models.codec25 import encoder as jenc
from qwen3_tts_tpu.models.codec25 import mel as jmel
from qwen3_tts_tpu.weights import unflatten_state_dict as j_unflatten
from qwen3_tts_tpu_torch.config import BigVGANConfig, CodecV1Config, DiTConfig
from qwen3_tts_tpu_torch.config import WhisperVQEncoderConfig
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models.codec25 import bigvgan as tbig
from qwen3_tts_tpu_torch.models.codec25 import dit as tdit
from qwen3_tts_tpu_torch.models.codec25 import encoder as tenc
from qwen3_tts_tpu_torch.models.codec25 import mel as tmel
from qwen3_tts_tpu_torch.models.codec25.campplus import CAMPPlusConfig
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, campplus_state, codec_v1_state
from qwen3_tts_tpu_torch.weights import from_jax_tree, save_safetensors, unflatten_state_dict
from tests.test_campplus import _encode_model
from tests.test_codec25 import BIGVGAN_TINY, DIT_TINY, ENC_TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

# the JAX tests' tiny widths with 80 mel bins and 192-d x-vectors: what an
# encode returns (the reference mel, CAM++ at its released widths) is what
# the decoder then reads
DIT_CFG = dict(DIT_TINY, mel_dim=80, enc_emb_dim=192)
BIGVGAN_CFG = dict(BIGVGAN_TINY, mel_dim=80)
TOK_JSON = {
    "model_type": "qwen3_tts_tokenizer_25hz",
    "encoder_config": dict(ENC_TINY),
    "decoder_config": {"dit_config": DIT_CFG, "bigvgan_config": BIGVGAN_CFG},
    "input_sample_rate": 16000,
    "output_sample_rate": 16000,
    "decode_upsample_rate": 16,      # repeats x prod(upsample_rates)
    "encode_downsample_rate": 640,
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def state():
    """(flat numpy state, JAX tree, port tree) of the tiny 25 Hz tokenizer."""
    flat = codec_v1_state(CodecV1Config.from_dict(TOK_JSON), seed=0)
    tree = unflatten_state_dict(flat)
    return flat, jax.tree_util.tree_map(jnp.asarray, j_unflatten(flat)), from_jax_tree(tree)


def test_codec_v1_state_is_what_the_jax_modules_read(state):
    """Every key of the fabricated state is read by the JAX package's 25 Hz
    modules (encoder, DiT sampler, BigVGAN), and none they read is missing."""
    flat, _, _ = state
    read = set()

    class Probe(dict):
        def __init__(self, d, prefix):
            super().__init__({k: Probe(v, f"{prefix}{k}.") if isinstance(v, dict) else v
                              for k, v in d.items()})
            self.prefix = prefix

        def __getitem__(self, k):
            v = super().__getitem__(k)
            if not isinstance(v, Probe):
                read.add(self.prefix + k)
            return v

        def get(self, k, d=None):
            return self[k] if k in self else d

    tree = Probe(jax.tree_util.tree_map(jnp.asarray, j_unflatten(flat)), "")
    jcfg = JCodecV1Cfg.from_dict(TOK_JSON)
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, (3000,)).astype(np.float32)
    mel = jmel.get_mel_audio(wav, padding=True, audio_vq_ds_rate=2, n_mels=80)
    jenc.encode_mel_to_codes.__wrapped__(tree["encoder"]["tokenizer"], jcfg.encoder_config, mel)
    d = _dit_inputs()
    mel = jdit.dit_sample(tree["decoder"]["dit"], jcfg.dit_config, d["codes"], d["xvec"],
                          d["ref_mel"], d["noise"], num_steps=2)
    jbig.bigvgan_forward(tree["decoder"]["bigvgan"], jcfg.bigvgan_config, mel)
    assert read == set(flat)


@pytest.mark.parametrize("n_mels,padding", [(128, 160), (80, 0)])
def test_whisper_log_mel_matches_jax(n_mels, padding):
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, (3200,)).astype(np.float32)
    want = np.asarray(jmel.whisper_log_mel(wav, n_mels=n_mels, padding=padding))
    got = tmel.whisper_log_mel(wav, n_mels=n_mels, padding=padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n", [3000, 5200])
def test_get_mel_audio_matches_jax(n):
    wav = np.random.default_rng(n).uniform(-0.5, 0.5, (n,)).astype(np.float32)
    want = np.asarray(jmel.get_mel_audio(wav, padding=True, audio_vq_ds_rate=2, n_mels=80))
    got = tmel.get_mel_audio(wav, padding=True, audio_vq_ds_rate=2, n_mels=80).numpy()
    assert got.shape == want.shape and got.shape[1] % 4 == 0
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert tmel.get_T_after_cnn(n) == jmel.get_T_after_cnn(n)


def test_bigvgan_ref_mel_matches_jax():
    wav = np.random.default_rng(1).uniform(-0.5, 0.5, (2, 4000)).astype(np.float32)
    want = np.asarray(jmel.bigvgan_ref_mel(wav))
    got = tmel.bigvgan_ref_mel(wav).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_encode_mel_to_codes_matches_jax(state):
    """20 mel frames over 16-frame chunks: the second window holds 4 of 8
    valid positions (T5)."""
    _, jtree, ttree = state
    jcfg, tcfg = JEncCfg.from_dict(ENC_TINY), WhisperVQEncoderConfig.from_dict(ENC_TINY)
    wav = np.random.default_rng(2).uniform(-0.5, 0.5, (3000,)).astype(np.float32)
    mel = np.asarray(jmel.get_mel_audio(wav, padding=True, audio_vq_ds_rate=2, n_mels=80))
    assert mel.shape[1] % (2 * tcfg.n_window) != 0
    want = np.asarray(jenc.encode_mel_to_codes(jtree["encoder"]["tokenizer"], jcfg,
                                               jnp.asarray(mel)))
    got = tenc.encode_mel_to_codes(ttree["encoder"]["tokenizer"], tcfg,
                                   torch.tensor(mel)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_quantize_speech_matches_jax(state):
    _, jtree, ttree = state
    jcfg, tcfg = JEncCfg.from_dict(ENC_TINY), WhisperVQEncoderConfig.from_dict(ENC_TINY)
    rng = np.random.default_rng(3)
    wavs = [rng.uniform(-0.5, 0.5, (n,)).astype(np.float32) for n in (3000, 5200, 700)]
    want_codes, want_lens = jenc.quantize_speech(jtree["encoder"]["tokenizer"], jcfg, wavs)
    got_codes, got_lens = tenc.quantize_speech(ttree["encoder"]["tokenizer"], tcfg, wavs)
    assert got_lens == want_lens
    for g, w in zip(got_codes, want_codes):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def _dit_inputs(B=2, Tc=6, Tr=10, seed=4):
    rng = np.random.default_rng(seed)
    return dict(
        codes=rng.integers(0, 30, (B, Tc)),
        xvec=rng.normal(0, 0.5, (B, DIT_CFG["enc_emb_dim"])).astype(np.float32),
        ref_mel=rng.normal(0, 0.5, (B, Tr, DIT_CFG["mel_dim"])).astype(np.float32),
        noise=rng.normal(0, 1, (B, Tc * 2, DIT_CFG["mel_dim"])).astype(np.float32))


def test_dit_forward_matches_jax(state):
    """One velocity evaluation, 12 frames over blocks of 4: layer 0 looks
    back a block, layer 1 ahead (T6)."""
    _, jtree, ttree = state
    jcfg, tcfg = JDiTCfg.from_dict(DIT_CFG), DiTConfig.from_dict(DIT_CFG)
    assert tcfg.look_ahead_layers == (1,) and tcfg.look_backward_layers == (0,)
    rng = np.random.default_rng(5)
    B, T = 2, 12
    x = rng.normal(0, 1, (B, T, tcfg.mel_dim)).astype(np.float32)
    spk = rng.normal(0, 0.5, (B, T, tcfg.enc_emb_dim)).astype(np.float32)
    ref = rng.normal(0, 0.5, (B, 10, tcfg.mel_dim)).astype(np.float32)
    code = rng.normal(0, 1, (B, T, tcfg.emb_dim)).astype(np.float32)
    t = np.asarray([0.1, 0.7], np.float32)
    want = np.asarray(jdit.dit_forward(jtree["decoder"]["dit"], jcfg, *map(jnp.asarray,
                                                                         (x, spk, ref, code, t))))
    got = tdit.dit_forward(ttree["decoder"]["dit"], tcfg,
                           *map(torch.from_numpy, (x, spk, ref, code, t))).numpy()
    assert got.shape == want.shape == (B, T, tcfg.mel_dim)
    assert rel_l2(got, want) < 1e-4


@pytest.mark.parametrize("guidance_scale", [0.5, 0.0])
def test_dit_sample_matches_jax(state, guidance_scale):
    """The Euler sampler from the same noise, with CFG (a batch of the
    conditional and the unconditional halves) and without it."""
    _, jtree, ttree = state
    jcfg, tcfg = JDiTCfg.from_dict(DIT_CFG), DiTConfig.from_dict(DIT_CFG)
    d = _dit_inputs()
    want = np.asarray(jdit.dit_sample(jtree["decoder"]["dit"], jcfg, jnp.asarray(d["codes"]),
                                      jnp.asarray(d["xvec"]), jnp.asarray(d["ref_mel"]),
                                      jnp.asarray(d["noise"]), num_steps=4,
                                      guidance_scale=guidance_scale))
    got = tdit.dit_sample(ttree["decoder"]["dit"], tcfg, torch.from_numpy(d["codes"]),
                          torch.from_numpy(d["xvec"]), torch.from_numpy(d["ref_mel"]),
                          torch.from_numpy(d["noise"]), num_steps=4,
                          guidance_scale=guidance_scale).numpy()
    assert got.shape == want.shape == (2, DIT_CFG["mel_dim"], 12)
    assert rel_l2(got, want) < 1e-4


def test_bigvgan_forward_matches_jax(state):
    """Stages 0-1 run causal_type "2" blocks ('same' pre-conv), stage 2
    type "1" ('same' second convs) (T8)."""
    _, jtree, ttree = state
    jcfg, tcfg = JBigVGANCfg.from_dict(BIGVGAN_CFG), BigVGANConfig.from_dict(BIGVGAN_CFG)
    mel = np.random.default_rng(6).normal(-1, 1, (2, tcfg.mel_dim, 20)).astype(np.float32)
    want = np.asarray(jbig.bigvgan_forward(jtree["decoder"]["bigvgan"], jcfg, jnp.asarray(mel)))
    got = tbig.bigvgan_forward(ttree["decoder"]["bigvgan"], tcfg, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 20 * 8)
    assert 0.05 < np.abs(got).mean() and (np.abs(got) < 1).mean() > 0.3   # not all clipped
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.fixture(scope="module")
def v1_dir(tmp_path_factory, state):
    """A tiny 25 Hz tokenizer directory: config.json, model.safetensors (the
    port's writer) and a full-width campplus.onnx (both packages' x-vector
    extractors read CAMPPlusConfig()'s widths)."""
    flat, _, _ = state
    d = tmp_path_factory.mktemp("v1")
    with open(d / "config.json", "w") as f:
        json.dump(TOK_JSON, f)
    save_safetensors(str(d / "model.safetensors"), flat)
    with open(d / "campplus.onnx", "wb") as f:
        f.write(_encode_model(campplus_state(CAMPPlusConfig(), seed=7)))
    return str(d)


def test_v1_tokenizer_end_to_end_matches_jax(v1_dir):
    """from_pretrained in both packages (the port on the CPU), encode two
    clips of different lengths, decode them back with JAX's noise."""
    jtok = JTok.from_pretrained(v1_dir)
    ttok = TTok.from_pretrained(v1_dir, device="cpu")
    assert ttok.get_model_type() == "qwen3_tts_tokenizer_25hz"
    assert ttok._fe_sampling_rate == 16000
    rng = np.random.default_rng(8)
    clips = [rng.uniform(-0.5, 0.5, (n,)).astype(np.float32) for n in (8000, 5200)]
    jenc_out = jtok.encode(clips, sr=16000)
    tenc_out = ttok.encode(clips, sr=16000)
    for g, w in zip(tenc_out.audio_codes, jenc_out.audio_codes):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tenc_out.xvectors, jenc_out.xvectors):
        assert g.shape == (192,) and rel_l2(g, w) < 1e-5
    for g, w in zip(tenc_out.ref_mels, jenc_out.ref_mels):
        assert g.shape == w.shape and g.shape[1] == 80
        np.testing.assert_allclose(g, w, atol=1e-4)

    want, sr = jtok.decode(jenc_out)
    dcfg = JDiTCfg.from_dict(DIT_CFG)
    T = max(len(c) for c in jenc_out.audio_codes)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (2, T * dcfg.repeats, dcfg.mel_dim), jnp.float32))
    got, tsr = ttok.decode(tenc_out, noise=noise)
    assert tsr == sr == 16000
    for g, w, c in zip(got, want, jenc_out.audio_codes):
        assert g.shape == w.shape == (len(c) * 16,) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=5e-5)
    want16, _ = jtok.decode(jenc_out, output_dtype="int16")
    got16, _ = ttok.decode(tenc_out, output_dtype="int16", noise=noise)
    for g, w in zip(got16, want16):
        assert g.dtype == np.int16
        assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
    with pytest.raises(ValueError, match="output_dtype"):
        ttok.decode(tenc_out, output_dtype="f64")


def test_v1_decode_without_noise_is_seeded(v1_dir):
    """Without noise= the port draws from a generator seeded 0 (not JAX's
    PRNGKey(0): T7): two calls agree, a generator of another seed differs."""
    ttok = TTok.from_pretrained(v1_dir, device="cpu")
    rng = np.random.default_rng(9)
    enc = {"audio_codes": [rng.integers(0, 30, (6,))],
           "xvectors": [rng.normal(0, 0.3, (DIT_CFG["enc_emb_dim"],)).astype(np.float32)],
           "ref_mels": [rng.normal(0, 0.3, (10, DIT_CFG["mel_dim"])).astype(np.float32)]}
    a, _ = ttok.decode(enc)
    b, _ = ttok.decode(enc)
    c, _ = ttok.decode(enc, generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], c[0])


def test_v1_decode_refuses_codes_past_the_dit_table(v1_dir):
    """A code the DiT cannot embed: the JAX package's gather fills NaN (a
    silent NaN waveform), the port raises before anything reaches the
    device (ROADMAP queue 3)."""
    jtok, ttok = JTok.from_pretrained(v1_dir), TTok.from_pretrained(v1_dir, device="cpu")
    rng = np.random.default_rng(10)
    enc = {"audio_codes": [np.asarray([1, 2, DIT_CFG["num_embeds"], 3])],
           "xvectors": [rng.normal(0, 0.3, (DIT_CFG["enc_emb_dim"],)).astype(np.float32)],
           "ref_mels": [rng.normal(0, 0.3, (10, DIT_CFG["mel_dim"])).astype(np.float32)]}
    assert np.isnan(jtok.decode(enc)[0][0]).all()
    with pytest.raises(ValueError, match="code table"):
        ttok.decode(enc)


def test_codec_v1_state_encodes_only_codes_the_dit_embeds():
    """At CodecV1Config()'s widths the codebook (32768) outgrows the DiT's
    table (8193): the fabricated rows past it never win the search."""
    from qwen3_tts_tpu_torch.config import CodecV1Config as Cfg

    embed = torch.randn(40, 16, generator=torch.Generator().manual_seed(0))
    embed[30:] *= 10.0      # the fabricator's rule, on a 30-row table
    x = torch.randn(200, 16, generator=torch.Generator().manual_seed(1))
    params = {"audio_quantizer": {"rvqs": {"0": {"embed": embed[None]}}}}
    assert tenc.code_distances(params, x).argmin(-1).max() < 30
    assert Cfg().encoder_config.audio_vq_codebook_size > Cfg().dit_config.num_embeds


def test_v1_encode_without_campplus_raises(tmp_path, state):
    """No campplus.onnx: decode works from given x-vectors, encode raises
    (no onnxruntime route, T9); the CUDA default raises without a card."""
    flat, _, _ = state
    with open(tmp_path / "config.json", "w") as f:
        json.dump(TOK_JSON, f)
    save_safetensors(str(tmp_path / "model.safetensors"), flat)
    ttok = TTok.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="CAM"):
        ttok.encode([np.zeros(4000, np.float32)], sr=16000)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTok.from_pretrained(str(tmp_path))
