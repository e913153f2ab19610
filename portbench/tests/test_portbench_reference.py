"""The frozen reference against the port's plain path at tiny widths on the
CPU, on the same drawn weights (the test imports both; the reference
imports nothing of the port)."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import talker as rt
from portbench.reference import vocoder as rv
from portbench.tests.tiny import tiny_config
from portbench.text import assistant_ids, ref_ids

from qwen3_tts_tpu_torch.config import CodecV2DecoderConfig
from qwen3_tts_tpu_torch.models.codec12.decoder import cut_rows, decode_frames
from qwen3_tts_tpu_torch.models.talker import (KVCache, code_predictor_frame, talker_prefill)
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from qwen3_tts_tpu_torch.runtime.prompts import PromptSpec, build_prompt
from qwen3_tts_tpu_torch.weights import quantize_talker_params

from portbench.system import port_configs

SEED = 2 ** 33 + 5


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    cfg = tiny_config()
    tree = weights.talker_tree(cfg, SEED, "cpu", dtype=torch.float32)
    tts_cfg, _ = port_configs(cfg, "custom_voice")
    return cfg, tree, quantize_talker_params(tree), tts_cfg


def _spec(cfg, tree):
    words = [11, 220, 3171, 9, 40000, 7]
    spk = cfg["spk_id"]["ryan"]
    return words, PromptSpec(input_id=np.asarray(assistant_ids(words)),
                             language_id=cfg["codec_language_id"]["english"],
                             speaker_embed=tree["codec_embedding"][spk])


def test_prompt_and_prefill_logits(setup):
    cfg, tree, params, tts_cfg = setup
    words, spec = _spec(cfg, tree)
    ref = rt.ReferenceTalker(cfg, tree, bits=8)
    prompt, trailing, pad = build_prompt(params, tts_cfg.talker_config, tts_cfg, spec)
    r_prompt, r_trailing, r_pad = ref.prompt({
        "input_id": assistant_ids(words), "language_id": spec.language_id,
        "speaker_embed": spec.speaker_embed})
    torch.testing.assert_close(r_prompt, prompt[0].float(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r_trailing, trailing[0].float(), rtol=1e-5, atol=1e-6)
    T = prompt.shape[1]
    t = cfg["talker"]
    cache = KVCache.zeros(t["num_hidden_layers"], 1, T, t["num_key_value_heads"], t["head_dim"],
                          dtype=torch.float32)
    logits, hidden, _ = talker_prefill(params, tts_cfg.talker_config, prompt,
                                       torch.ones((1, T), dtype=torch.int32), cache)
    r_logits, _ = ref.talker_pass(r_prompt, r_trailing, r_pad, torch.zeros((0, 4), dtype=torch.long))
    torch.testing.assert_close(r_logits[0], logits[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_ref", [3, 12], ids=["text_trails", "codes_outlast_text"])
def test_icl_prompt_is_the_ports_voice_clone_prompt(setup, n_ref):
    cfg, tree, params, tts_cfg = setup
    words, ref_words = [11, 220, 3171, 9, 40000, 7], [5, 6000, 17]
    gen = torch.Generator().manual_seed(n_ref)
    codes = torch.randint(0, 2048, (n_ref, 4), generator=gen)
    spk = torch.randn(cfg["talker"]["hidden_size"], generator=gen) * 0.02
    lang = cfg["codec_language_id"]["english"]
    spec = PromptSpec(input_id=np.asarray(assistant_ids(words)), language_id=lang,
                      speaker_embed=spk, ref_id=np.asarray(ref_ids(ref_words)),
                      ref_code=codes.numpy())
    base_cfg, _ = port_configs(cfg, "base")
    prompt, trailing, pad = build_prompt(params, base_cfg.talker_config, base_cfg, spec)
    ref = rt.ReferenceTalker(cfg, tree, bits=8)
    r_prompt, r_trailing, r_pad = ref.icl_prompt({
        "input_id": assistant_ids(words), "ref_id": ref_ids(ref_words), "ref_code": codes,
        "language_id": lang, "speaker_embed": spk})
    # text of 3 + 6 words and tts_eos against codec_bos and the frames
    assert r_trailing.shape[0] == (10 - (n_ref + 1) if n_ref + 1 < 10 else 1)
    torch.testing.assert_close(r_prompt, prompt[0].float(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r_trailing, trailing[0].float(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(r_pad, pad[0, 0].float(), rtol=1e-5, atol=1e-6)


def test_subtalker_teacher_forced_argmax_is_the_ports_greedy_codes(setup):
    cfg, tree, params, tts_cfg = setup
    ref = rt.ReferenceTalker(cfg, tree, bits=8)
    gen = torch.Generator().manual_seed(3)
    n, H = 6, cfg["talker"]["hidden_size"]
    hidden = torch.randn((n, H), generator=gen)
    code0 = torch.randint(0, 2048, (n,), generator=gen)
    c0_emb = tree["codec_embedding"][code0][:, None, :]
    codes, _ = code_predictor_frame(params, tts_cfg.talker_config, hidden[:, None, :], c0_emb,
                                    SamplingParams(do_sample=False))
    frames = torch.cat([code0[:, None], codes.long()], dim=1)
    sub = ref.sub_pass(hidden, frames)
    assert torch.equal(sub.argmax(-1), codes.long())
    assert float(rt.gaps(sub, frames[:, 1:]).max()) < 1e-4


def test_vocoder_and_packets():
    cfg = tiny_config()
    voc = weights.vocoder_tree(cfg, SEED, "cpu")
    dec_cfg = CodecV2DecoderConfig.from_dict(cfg["vocoder"])
    gen = torch.Generator().manual_seed(4)
    codes = torch.randint(0, 2048, (2, 4, 9), generator=gen)
    torch.testing.assert_close(rv.decode(voc, cfg["vocoder"], codes),
                               decode_frames(voc, dec_cfg, codes)[:, 0], rtol=1e-5, atol=1e-6)
    # a packet of 3 frames after 5, with 4 frames of left context
    hist = codes[0].T
    out = cut_rows(voc, dec_cfg, hist[1:8].T[None], torch.tensor([4]), 3)[0]
    want = rv.packet(voc, cfg["vocoder"], hist, 5, 3, 0, 4)
    torch.testing.assert_close(want, out, rtol=1e-5, atol=1e-6)


def test_quantize_rows_matches_the_ports_int8():
    from qwen3_tts_tpu_torch.weights import quantize_weight_int8

    w = torch.randn(5, 7, 33, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    q = quantize_weight_int8(w)
    torch.testing.assert_close(rt.quantize_rows(w, 8), q["q"].float() * q["s"][..., None],
                               rtol=0, atol=0)
