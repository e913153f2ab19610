"""The port's voice clone (and voice design) end to end against the JAX
package.

Both packages load one tiny base checkpoint (talker from the JAX
`random_talker_params`, speaker encoder from the port's numpy
fabricator), get the same tiny Mimi encoder and vocoder trees and the same
stand-in text tokenizer. Tolerances:
- reference codes equal, speaker embeddings 1e-4 relative (tests of the
  encoders themselves are in test_torch_encoders.py);
- ICL prompt embeddings 1e-5 (fp32, the same gathers and projections);
- fp32 greedy generation: codes equal, waveforms atol 1e-4 (the vocoder's
  convolutions sum in another order), on the dense prefill route and on
  the flash route (both packages' FLASH_PREFILL_MIN_T lowered to 8 and the
  port's fit rule opened to the tiny fp32 shapes, `open_flash_route`; the
  port runs the flash twin, the JAX package its kernel in interpret mode).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodecV2Config as JCodecCfg
from qwen3_tts_tpu.config import MimiEncoderConfig as JMimiCfg
from qwen3_tts_tpu.inference import model as jmodel
from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.models.codec12 import encoder as jenc
from qwen3_tts_tpu.utils.testing import random_talker_params, random_vocoder_params
from qwen3_tts_tpu.weights import (flatten_state_dict, save_safetensors,
                                   talker_params_to_state_dict)
from qwen3_tts_tpu_torch.config import CodecV2Config, MimiEncoderConfig, TTSModelConfig
from qwen3_tts_tpu_torch.inference import model as tmodel
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models.codec12 import encoder as tenc
from qwen3_tts_tpu_torch.ops.cuda import prefill_attention as tpa
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, mimi_encoder_state,
                                               speaker_encoder_state)
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_codec12_encoder import TINY as ENC_TINY
from tests.test_pipeline_parity import MODEL_TINY
from tests.test_torch_pipeline import DEC_CFG, FakeTokenizer
from tests.test_torch_prefill_route import open_flash_route

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

GREEDY = dict(do_sample=False, subtalker_dosample=False, max_new_tokens=10)
CODEC_KW = dict(encoder_valid_num_quantizers=4, input_sample_rate=1000,
                output_sample_rate=1000, decode_upsample_rate=DEC_CFG.total_upsample,
                encode_downsample_rate=16)
TEXTS = ["clone me please", "a second line in the same voice"]


def _model_json(model_type):
    d = json.loads(json.dumps(MODEL_TINY))
    d["tts_model_type"] = model_type
    # the x-vector rides the codec track: enc_dim is the talker width; the
    # mel front end has 128 bins
    d["speaker_encoder_config"].update(mel_dim=128, enc_dim=d["talker_config"]["hidden_size"])
    return d


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """{model_type: checkpoint dir} plus one Mimi encoder and vocoder tree."""
    dirs = {}
    for model_type in ("base", "voice_design"):
        d = tmp_path_factory.mktemp(f"torch_{model_type}")
        cfg_json = _model_json(model_type)
        tc = TTSModelConfig.from_dict(cfg_json)
        params = random_talker_params(tc.talker_config, jax.random.PRNGKey(0),
                                      dtype=jnp.float32)
        params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
        sd = talker_params_to_state_dict(params, tc.talker_config)
        sd.update(flatten_state_dict(speaker_encoder_state(tc.speaker_encoder_config, 1),
                                     "speaker_encoder"))
        save_safetensors(str(d / "model.safetensors"), {k: np.asarray(v) for k, v in sd.items()})
        with open(d / "config.json", "w") as f:
            json.dump(cfg_json, f)
        dirs[model_type] = str(d)
    enc = mimi_encoder_state(MimiEncoderConfig.from_dict(ENC_TINY), 2)
    return dirs, enc, random_vocoder_params(DEC_CFG, jax.random.PRNGKey(3))


def _models(ckpt, model_type="base"):
    dirs, enc, vocoder = ckpt
    jm = jmodel.Qwen3TTSModel.from_pretrained(dirs[model_type], dtype=jnp.float32)
    jcfg = JCodecCfg(encoder_config=JMimiCfg.from_dict(ENC_TINY), decoder_config=DEC_CFG,
                     **CODEC_KW)
    jm.speech_tokenizer = JTok.from_params(
        jcfg, enc_params=jenc.prepare_encoder_params(
            jax.tree_util.tree_map(jnp.asarray, enc), jcfg.encoder_config),
        dec_params=vocoder)
    jm.processor = FakeTokenizer()
    tm = tmodel.Qwen3TTSModel.from_pretrained(dirs[model_type], dtype=torch.float32,
                                              device="cpu")
    tcfg = CodecV2Config(encoder_config=MimiEncoderConfig.from_dict(ENC_TINY),
                         decoder_config=DEC_CFG, **CODEC_KW)
    tm.speech_tokenizer = TTok.from_params(
        tcfg, enc_params=tenc.prepare_encoder_params(from_jax_tree(enc), tcfg.encoder_config),
        dec_params=from_jax_tree(vocoder))
    tm.processor = FakeTokenizer()
    return jm, tm


def _ref_audio():
    rng = np.random.default_rng(4)
    return [(rng.uniform(-0.5, 0.5, (400,)).astype(np.float32), 1000),
            (rng.uniform(-0.5, 0.5, (300,)).astype(np.float32), 1000)]


def _prompts(m):
    """One ICL item and one x-vector-only item."""
    return m.create_voice_clone_prompt(_ref_audio(), ref_text=["ref words here", None],
                                       x_vector_only_mode=[False, True])


def test_create_voice_clone_prompt_matches_jax(ckpt):
    jm, tm = _models(ckpt)
    jitems, titems = _prompts(jm), _prompts(tm)
    assert [it.x_vector_only_mode for it in titems] == [False, True]
    assert titems[1].ref_code is None
    np.testing.assert_array_equal(titems[0].ref_code, jitems[0].ref_code)
    assert titems[0].ref_code.shape == (25, 4)
    for a, b in zip(titems, jitems):
        assert a.ref_spk_embedding.shape == (MODEL_TINY["talker_config"]["hidden_size"],)
        rel = np.linalg.norm(a.ref_spk_embedding - b.ref_spk_embedding) / np.linalg.norm(
            b.ref_spk_embedding)
        assert rel < 1e-4, rel


@pytest.mark.parametrize("non_streaming", [True, False])
def test_icl_prompt_embeds_match_jax(ckpt, non_streaming):
    from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs as j_assemble
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs as t_assemble

    jm, tm = _models(ckpt)
    items = _prompts(tm)
    outs = []
    for m, assemble in ((jm, j_assemble), (tm, t_assemble)):
        specs, _ = m._specs_voice_clone(TEXTS, "english", None, None, False, items,
                                        non_streaming)
        assert specs[0].ref_code is not None and specs[1].ref_code is None
        outs.append([np.asarray(x) for x in assemble(m.talker_params, m.config.talker_config,
                                                     m.config, specs, bucket=32)])
    for j, t in zip(*outs):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_fp32_greedy_voice_clone_matches_jax(ckpt, monkeypatch, route):
    jm, tm = _models(ckpt)
    items = _prompts(tm)
    calls = []
    if route == "flash":
        monkeypatch.setattr(jtalker, "FLASH_PREFILL_MIN_T", 8)
        open_flash_route(monkeypatch)
        jax.clear_caches()   # the threshold is read when JAX traces
        real = tpa.flash_prefill_ref
        monkeypatch.setattr(tpa, "flash_prefill_ref",
                            lambda *a: calls.append(a[0].shape[1]) or real(*a))
    codes = []
    for m in (jm, tm):
        specs, _ = m._specs_voice_clone(TEXTS, "english", None, None, False, items, True)
        codes.append(m._run(specs, m._generation_config(m._merge_generate_kwargs(**GREEDY)),
                            seed=0))
    if route == "flash":
        assert len(calls) == MODEL_TINY["talker_config"]["num_hidden_layers"]
        assert calls[0] >= 8
    for ct, cj in zip(codes[1], codes[0]):
        assert ct.shape == cj.shape and ct.shape[0] > 0
        np.testing.assert_array_equal(ct, cj)

    wj, srj = jm.generate_voice_clone(TEXTS, language="english", voice_clone_prompt=items,
                                      non_streaming_mode=True, seed=0, **GREEDY)
    wt, srt = tm.generate_voice_clone(TEXTS, language="english", voice_clone_prompt=items,
                                      non_streaming_mode=True, seed=0, **GREEDY)
    assert srt == srj == 1000
    up = DEC_CFG.total_upsample
    for a, b, c, it in zip(wt, wj, codes[1], items):
        assert a.dtype == np.float32 and a.shape == b.shape
        rl = 0 if it.ref_code is None else len(it.ref_code)
        total = (rl + c.shape[0]) * up
        assert a.shape[0] == total - int(rl / (rl + c.shape[0]) * total)
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_voice_clone_from_ref_audio_runs(ckpt):
    """`ref_audio` straight into generate_voice_clone (the prompt is made
    inside), streaming text layout, and the model-type guard."""
    _, tm = _models(ckpt)
    wavs, sr = tm.generate_voice_clone(TEXTS[:1], ref_audio=_ref_audio()[:1],
                                       ref_text="ref words here", seed=0, **GREEDY)
    assert sr == 1000 and len(wavs) == 1 and np.isfinite(wavs[0]).all()
    with pytest.raises(ValueError, match="ref_text is required"):
        tm.create_voice_clone_prompt(_ref_audio()[:1])
    _, vd = _models(ckpt, "voice_design")
    with pytest.raises(ValueError, match="does not support"):
        vd.generate_voice_clone("hi", ref_audio=_ref_audio()[:1], ref_text="x")


def test_fp32_greedy_voice_design_matches_jax(ckpt):
    jm, tm = _models(ckpt, "voice_design")
    kw = dict(instruct=["a deep calm narrator", None], language="english", seed=0, **GREEDY)
    codes = []
    for m in (jm, tm):
        specs = m._specs_voice_design(TEXTS, kw["instruct"], "english", True)
        codes.append(m._run(specs, m._generation_config(m._merge_generate_kwargs(**GREEDY)),
                            seed=0))
    for ct, cj in zip(*codes[::-1]):
        assert ct.shape[0] > 0
        np.testing.assert_array_equal(ct, cj)
    wj, _ = jm.generate_voice_design(TEXTS, **kw)
    wt, _ = tm.generate_voice_design(TEXTS, **kw)
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ext", ["npz", "pt"])
def test_voice_clone_prompt_files_round_trip(tmp_path, ext):
    """The port writes what the JAX package reads and reads what it writes."""
    rng = np.random.default_rng(5)
    items = [tmodel.VoiceClonePromptItem(
        ref_code=rng.integers(0, 16, (5, 4)), ref_spk_embedding=rng.normal(size=(8,))
        .astype(np.float32), x_vector_only_mode=False, icl_mode=True, ref_text="ref"),
        tmodel.VoiceClonePromptItem(
            ref_code=None, ref_spk_embedding=rng.normal(size=(8,)).astype(np.float32),
            x_vector_only_mode=True, icl_mode=False)]
    t_path, j_path = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    tmodel.save_voice_clone_prompts(t_path, items)
    jmodel.save_voice_clone_prompts(j_path, [jmodel.VoiceClonePromptItem(
        **dataclasses.asdict(it)) for it in items])
    for got in (tmodel.load_voice_clone_prompts(t_path), jmodel.load_voice_clone_prompts(t_path),
                tmodel.load_voice_clone_prompts(j_path)):
        assert len(got) == 2
        for a, b in zip(got, items):
            assert (a.ref_code is None) == (b.ref_code is None)
            if b.ref_code is not None:
                np.testing.assert_array_equal(a.ref_code, b.ref_code)
            np.testing.assert_array_equal(a.ref_spk_embedding, b.ref_spk_embedding)
            assert (a.x_vector_only_mode, a.icl_mode, a.ref_text) == (
                b.x_vector_only_mode, b.icl_mode, b.ref_text)
