"""The port's int8 custom-voice slice end to end against the JAX package.

Both packages load one tiny checkpoint written from the JAX
`random_talker_params` (through `talker_params_to_state_dict` and
safetensors), get the same tiny vocoder tree and the same stand-in text
tokenizer, and synthesise the same texts.

Tolerances:
- fp32, unquantised, greedy: codes equal (same math in fp32; only the
  order of float sums differs), waveforms within atol 1e-4 (the vocoder's
  fp32 convolutions sum in another order);
- int8 with both fused kernels (the port's CPU twins against the JAX
  Pallas kernels in interpret mode): frame-code agreement >= 0.9, because
  bf16 activations and W8A8 quantisation can flip a near-tie and the
  generation then diverges for that row.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodecV2Config, CodecV2DecoderConfig, TTSModelConfig
from qwen3_tts_tpu.inference.model import Qwen3TTSModel as JModel
from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models.codec12 import decoder as jdec
from qwen3_tts_tpu.utils.testing import random_talker_params, random_vocoder_params
from qwen3_tts_tpu.weights import save_safetensors, talker_params_to_state_dict
from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel as TModel
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.models.codec12 import decoder as tdec
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_codec12_decoder import TINY as DEC_TINY
from tests.test_pipeline_parity import MODEL_TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

TEXTS = ["hello world", "a second, longer sample"]
DEC_CFG = CodecV2DecoderConfig(**DEC_TINY)
CODEC_CFG = CodecV2Config(decoder_config=DEC_CFG, output_sample_rate=1000,
                          decode_upsample_rate=DEC_CFG.total_upsample)


class FakeTokenizer:
    """Deterministic char-hash tokenizer standing in for the Qwen2 text
    tokenizer (same as tests/test_inference_api.py)."""

    def __call__(self, text, return_tensors=None, **kw):
        ids = [1 + (ord(c) * 7 + i) % 39 for i, c in enumerate(text)][:24]
        ids = ids + [1] * max(0, 9 - len(ids))
        return {"input_ids": np.asarray([ids], dtype=np.int64)}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A talker-only checkpoint dir (no speech_tokenizer/: neither package
    then loads a codec) plus one vocoder tree for both packages."""
    d = tmp_path_factory.mktemp("torch_port_ckpt")
    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    params = random_talker_params(tc, jax.random.PRNGKey(0), dtype=jnp.float32)
    # the fabrication scale (0.02) leaves near-uniform logits; widen it so
    # greedy argmaxes are well separated from float noise
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    save_safetensors(str(d / "model.safetensors"),
                     talker_params_to_state_dict(params, tc))
    with open(d / "config.json", "w") as f:
        json.dump(MODEL_TINY, f)
    vocoder = random_vocoder_params(DEC_CFG, jax.random.PRNGKey(1))
    return str(d), vocoder


def _models(checkpoint, j_dtype, t_dtype, quantize=None):
    path, vocoder = checkpoint
    jm = JModel.from_pretrained(path, dtype=j_dtype, quantize=quantize)
    jm.speech_tokenizer = JTok.from_params(CODEC_CFG, dec_params=vocoder)
    jm.processor = FakeTokenizer()
    tm = TModel.from_pretrained(path, dtype=t_dtype, quantize=quantize, device="cpu")
    tm.speech_tokenizer = TTok.from_params(CODEC_CFG, dec_params=from_jax_tree(vocoder))
    tm.processor = FakeTokenizer()
    return jm, tm


GREEDY = dict(do_sample=False, subtalker_dosample=False, max_new_tokens=12)


def test_fp32_greedy_custom_voice_matches_jax(checkpoint):
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    for m in (jm, tm):
        specs = m._specs_custom_voice(TEXTS, "vivian", "english", None, True)
        m.codes = m._run(specs, m._generation_config(m._merge_generate_kwargs(**GREEDY)),
                         seed=0)
    assert [c.shape for c in tm.codes] == [c.shape for c in jm.codes]
    assert all(c.shape[0] > 0 for c in tm.codes)
    for ct, cj in zip(tm.codes, jm.codes):
        np.testing.assert_array_equal(ct, cj)

    wj, srj = jm.generate_custom_voice(TEXTS, speaker="vivian", language="english",
                                       seed=0, **GREEDY)
    wt, srt = tm.generate_custom_voice(TEXTS, speaker="vivian", language="english",
                                       seed=0, **GREEDY)
    assert srt == srj == 1000
    for a, b, c in zip(wt, wj, tm.codes):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert a.shape[0] == c.shape[0] * DEC_CFG.total_upsample
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("non_streaming,instruct,language", [
    (True, None, "english"), (False, "speak slowly", None), (False, None, "chinese")])
def test_prompt_assembly_matches_jax(checkpoint, non_streaming, instruct, language):
    """Batched prompt embeddings, masks and trailing text (fp32: 1e-5)."""
    from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs as j_assemble
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs as t_assemble

    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    outs = []
    for m, assemble in ((jm, j_assemble), (tm, t_assemble)):
        specs = m._specs_custom_voice(TEXTS, "vivian", language, instruct, non_streaming)
        outs.append([np.asarray(x) for x in assemble(m.talker_params, m.config.talker_config,
                                                     m.config, specs, bucket=32)])
    for j, t in zip(*outs):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_fp32_greedy_chunked_generation_matches_jax(checkpoint):
    """generate_frames_chunked (the path above 1024 new tokens), with small
    chunks and attend buckets so several of each run: codes equal."""
    from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
    from qwen3_tts_tpu.runtime.generate import GenerationConfig as JG
    from qwen3_tts_tpu.runtime.generate import generate_frames_chunked as j_chunked
    from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
    from qwen3_tts_tpu_torch.runtime.generate import GenerationConfig as TG
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames as t_frames
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames_chunked as t_chunked

    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    tc = jm.config.talker_config
    specs = jm._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    inputs = assemble_prompt_specs(jm.talker_params, tc, jm.config, specs, bucket=32)
    out_j = j_chunked(jm.talker_params, tc,
                      JG(max_new_tokens=12, sampling=JS(do_sample=False),
                         subtalker=JS(do_sample=False)),
                      *inputs, jax.random.PRNGKey(0), chunk=4, attend_bucket=32)
    t_inputs = [from_jax_tree(x) for x in inputs]
    t_cfg = TG(max_new_tokens=12, sampling=TS(do_sample=False), subtalker=TS(do_sample=False))
    out_t = t_chunked(tm.talker_params, tc, t_cfg, *t_inputs, torch.Generator(),
                      chunk=4, attend_bucket=32)
    np.testing.assert_array_equal(out_t.codes.numpy(), np.asarray(out_j.codes))
    np.testing.assert_array_equal(out_t.lengths.numpy(), np.asarray(out_j.lengths))
    out_f = t_frames(tm.talker_params, tc, t_cfg, *t_inputs, torch.Generator())
    np.testing.assert_array_equal(out_f.codes.numpy(), out_t.codes.numpy())


def test_int8_fused_generate_frames_agrees_with_jax(checkpoint):
    """int8, fused sub-talker and fused talker step on: the port's CPU
    twins against JAX generate_frames with its Pallas kernels in
    interpret mode, on the same prompt embeddings."""
    from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
    from qwen3_tts_tpu.runtime.generate import GenerationConfig as JG
    from qwen3_tts_tpu.runtime.generate import generate_frames as j_generate
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
    from qwen3_tts_tpu_torch.runtime.generate import GenerationConfig as TG
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames as t_generate

    jm, tm = _models(checkpoint, jnp.bfloat16, torch.bfloat16, quantize="int8")
    tc = jm.config.talker_config
    specs = jm._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs

    embeds, mask, trailing, pad = assemble_prompt_specs(
        jm.talker_params, tc, jm.config, specs, bucket=32)
    flags = dict(max_new_tokens=10, fused_subtalker=True, fused_talker_step=True)
    out_j = j_generate(jm.talker_params, tc,
                       JG(sampling=JS(do_sample=False), subtalker=JS(do_sample=False),
                          **flags),
                       embeds, mask, trailing, pad, jax.random.PRNGKey(0))
    counts = (subtalker_frame_fused.launches, talker_step_fused_cache.launches)
    out_t = t_generate(tm.talker_params, tc,
                       TG(sampling=TS(do_sample=False), subtalker=TS(do_sample=False),
                          **flags),
                       from_jax_tree(embeds), from_jax_tree(mask),
                       from_jax_tree(trailing), from_jax_tree(pad),
                       torch.Generator().manual_seed(0))
    # CPU tensors run the twins, not the kernels
    assert (subtalker_frame_fused.launches, talker_step_fused_cache.launches) == counts
    codes_j, len_j = np.asarray(out_j.codes), np.asarray(out_j.lengths)
    codes_t, len_t = out_t.codes.numpy(), out_t.lengths.numpy()
    assert codes_t.shape == codes_j.shape
    n = np.minimum(len_j, len_t)
    assert (n > 0).all()
    agree = np.mean(np.concatenate([(codes_t[b, :n[b]] == codes_j[b, :n[b]]).ravel()
                                    for b in range(len(TEXTS))]))
    assert agree >= 0.9, agree


def test_int8_custom_voice_api_runs_sampled(checkpoint):
    """The public int8 call path on the CPU: sampled, seeded, finite
    waveforms of lengths x upsample samples; the same seed repeats."""
    _, tm = _models(checkpoint, jnp.bfloat16, torch.bfloat16, quantize="int8")
    kw = dict(max_new_tokens=8, fused_talker_step=True)
    gen_cfg = tm._generation_config(tm._merge_generate_kwargs(**kw))
    assert gen_cfg.fused_subtalker and gen_cfg.fused_talker_step
    wavs, sr = tm.generate_custom_voice(TEXTS, speaker="vivian", seed=3, **kw)
    again, _ = tm.generate_custom_voice(TEXTS, speaker="vivian", seed=3, **kw)
    assert sr == 1000 and len(wavs) == 2
    for a, b in zip(wavs, again):
        assert np.isfinite(a).all() and a.shape[0] % DEC_CFG.total_upsample == 0
        np.testing.assert_array_equal(a, b)
    # on the CPU the fused talker step is opt-in; on CUDA it is the default
    assert not tm._generation_config(tm._merge_generate_kwargs()).fused_talker_step


def test_vocoder_matches_jax():
    vocoder = random_vocoder_params(DEC_CFG, jax.random.PRNGKey(2))
    codes = np.random.default_rng(0).integers(0, DEC_CFG.codebook_size,
                                              (2, DEC_CFG.num_quantizers, 21))
    want = jdec.chunked_decode(vocoder, DEC_CFG, jnp.asarray(codes), chunk_size=8,
                               left_context_size=3)
    got = tdec.chunked_decode(from_jax_tree(vocoder), DEC_CFG, torch.tensor(codes),
                              chunk_size=8, left_context_size=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tdec.to_pcm16(got).numpy(),
                                  np.asarray(jdec.to_pcm16(jnp.asarray(got.numpy()))))


def _tokenizer_dir(tmp_path, rng):
    """A 12 Hz tokenizer checkpoint directory (decoder only, the raw
    split-RVQ quantizer, drawn from `rng`): (its path, the raw tree)."""
    from qwen3_tts_tpu.weights import flatten_state_dict

    def codebook():
        return {"_codebook": {
            "cluster_usage": rng.uniform(0.5, 1.5, (DEC_CFG.codebook_size,)).astype(np.float32),
            "embedding_sum": rng.normal(0, 1, (DEC_CFG.codebook_size, 8)).astype(np.float32)}}

    def rvq(n):
        return {"output_proj": {"weight": rng.normal(0, 0.3, (DEC_CFG.codebook_dim, 8, 1))
                                .astype(np.float32)},
                "vq": {"layers": {str(i): codebook() for i in range(n)}}}

    raw = {k: v for k, v in random_vocoder_params(DEC_CFG, jax.random.PRNGKey(5)).items()
           if k != "_codebooks"}
    raw["quantizer"] = {"rvq_first": rvq(1), "rvq_rest": rvq(DEC_CFG.num_quantizers - 1)}
    tok_dir = tmp_path / "speech_tokenizer"
    tok_dir.mkdir()
    save_safetensors(str(tok_dir / "model.safetensors"),
                     {k: np.asarray(v) for k, v in flatten_state_dict(raw, "decoder").items()})
    with open(tok_dir / "config.json", "w") as f:
        json.dump({"model_type": "qwen3_tts_tokenizer_12hz", "decoder_config": DEC_TINY,
                   "output_sample_rate": 1000,
                   "decode_upsample_rate": DEC_CFG.total_upsample}, f)
    return tok_dir, raw


def test_speech_tokenizer_from_pretrained_matches_jax(checkpoint, tmp_path):
    """A 12 Hz tokenizer checkpoint with the raw split-RVQ quantizer: the
    port's loader folds the codebooks as the JAX `prepare_decoder_params`
    does (fp32: 1e-5), decodes like the JAX tokenizer (1e-4, conv sums), and
    `Qwen3TTSModel.from_pretrained` picks it up from `speech_tokenizer/`."""
    import shutil

    rng = np.random.default_rng(4)
    tok_dir, raw = _tokenizer_dir(tmp_path, rng)
    want = jdec.prepare_decoder_params(jax.tree_util.tree_map(jnp.asarray, raw), DEC_CFG)
    tok = TTok.from_pretrained(str(tok_dir), device="cpu")
    np.testing.assert_allclose(tok.dec_params["_codebooks"].numpy(),
                               np.asarray(want["_codebooks"]), rtol=1e-5, atol=1e-5)
    codes = [rng.integers(0, DEC_CFG.codebook_size, (n, DEC_CFG.num_quantizers))
             for n in (5, 9)]
    wt, srt = tok.decode([{"audio_codes": c} for c in codes])
    wj, srj = JTok.from_params(CODEC_CFG, dec_params=want).decode(
        [{"audio_codes": c} for c in codes])
    assert srt == srj == 1000
    for a, b in zip(wt, wj):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    pcm, _ = tok.decode({"audio_codes": codes}, output_dtype="int16")
    assert pcm[1].dtype == np.int16 and pcm[1].shape == wt[1].shape

    model_dir = tmp_path / "model"
    shutil.copytree(checkpoint[0], model_dir)
    shutil.copytree(tok_dir, model_dir / "speech_tokenizer")
    tm = TModel.from_pretrained(str(model_dir), dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tm.speech_tokenizer.dec_params["_codebooks"].numpy(),
                                  tok.dec_params["_codebooks"].numpy())


def test_from_pretrained_takes_hub_ids(checkpoint, tmp_path, monkeypatch):
    """A name that is not a local directory is a Hugging Face repo id: both
    loaders fetch it through `huggingface_hub.snapshot_download` (a stand-in
    module here, returning directories the test wrote: no network) and load
    what it returns; without the package they raise FileNotFoundError, as
    the JAX package does."""
    import shutil
    import sys
    import types

    tok_dir, _ = _tokenizer_dir(tmp_path, np.random.default_rng(4))
    model_dir = tmp_path / "model"
    shutil.copytree(checkpoint[0], model_dir)
    shutil.copytree(tok_dir, model_dir / "speech_tokenizer")
    snapshots = {"org/tiny-tts": str(model_dir), "org/tiny-tokenizer": str(tok_dir)}
    asked = []

    def snapshot_download(repo_id, allow_patterns=None):
        asked.append(repo_id)
        return snapshots[repo_id]

    hub = types.ModuleType("huggingface_hub")
    hub.snapshot_download = snapshot_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    tm = TModel.from_pretrained("org/tiny-tts", dtype=torch.float32, device="cpu")
    tok = TTok.from_pretrained("org/tiny-tokenizer", device="cpu")
    local = TModel.from_pretrained(str(model_dir), dtype=torch.float32, device="cpu")
    assert asked == ["org/tiny-tts", "org/tiny-tokenizer"]
    for a, b in ((tm.talker_params["codec_head"], local.talker_params["codec_head"]),
                 (tok.dec_params["_codebooks"], local.speech_tokenizer.dec_params["_codebooks"])):
        assert torch.equal(a, b)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)   # the import fails
    for load in (TModel.from_pretrained, TTok.from_pretrained):
        with pytest.raises(FileNotFoundError, match="huggingface_hub is unavailable"):
            load("org/tiny-tts", device="cpu")


def test_long_prefill_raises_and_cuda_request_checked(checkpoint, monkeypatch):
    """A prefill of FLASH_PREFILL_MIN_T tokens of the fp32 load is not
    kernel 3's shape (`flash_misfit`): it attends densely, bit-equal to
    allow_flash=False. With the fit rule opened to it, it attends through
    the flash prefill's twin (no kernel launch: the counter stays put) and
    matches the dense path within 1e-4 on the valid rows; asking for CUDA
    where there is none raises."""
    from qwen3_tts_tpu_torch.ops.cuda import prefill_attention as tpa

    tm = TModel.from_pretrained(checkpoint[0], dtype=torch.float32, device="cpu")
    tc = tm.config.talker_config
    B, T = 2, ttalker.FLASH_PREFILL_MIN_T
    starts = [0, min(301, T // 2)]   # both rows hold valid tokens at any threshold
    gen = torch.Generator().manual_seed(0)
    embeds = 0.3 * torch.randn((B, T, tc.hidden_size), generator=gen)
    mask = (torch.arange(T)[None, :] >= torch.tensor(starts)[:, None]).to(torch.int32)
    calls = []
    real = tpa.flash_prefill_ref
    monkeypatch.setattr(tpa, "flash_prefill_ref", lambda *a: calls.append(1) or real(*a))
    launches = tpa.flash_prefill.launches

    def run(allow_flash):
        cache = ttalker.KVCache.zeros(tc.num_hidden_layers, B, T + 1, tc.num_key_value_heads,
                                      tc.resolved_head_dim, dtype=torch.float32)
        return ttalker.talker_prefill(tm.talker_params, tc, embeds, mask, cache,
                                      allow_flash=allow_flash)

    lm, hm, _ = run(True)
    ld, hd, cd = run(False)
    assert not calls and torch.equal(lm, ld) and torch.equal(hm, hd)
    monkeypatch.setattr(ttalker, "flash_misfit", lambda *a: None)
    lf, hf, cf = run(True)
    assert len(calls) == tc.num_hidden_layers and tpa.flash_prefill.launches == launches
    torch.testing.assert_close(lf, ld, rtol=1e-4, atol=1e-4)
    for b, s in enumerate(starts):
        torch.testing.assert_close(hf[b, s:], hd[b, s:], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(cf.k[:, b, :, s:T], cd.k[:, b, :, s:T])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TModel.from_pretrained(checkpoint[0], device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            TModel(tm.config, tm.talker_params)
