"""chip_smoke.py's audio readings and its vocoder draws, on the CPU.

The smoke holds the port's audio to the eager route, the host and other
requests' contexts on the card; those checks read amplitudes only while
the samples are not clamped to full scale. Here:
- `audio_levels` (RMS and full-scale share, float at +-1 and PCM16 at
  +-32767, arrays and tensors together) and `unclamped`, which fails above
  MAX_FULL_SCALE_SHARE;
- `scaled_vocoder_params` on a tiny decoder config: the seed's draw with
  every weight matrix times the scale, exactly, and the codebooks and
  vectors as drawn (scale 1.0 is the draw itself);
- the evaluation phase's tokenizer checkpoint (`eval_tokenizer_checkpoint`)
  at tiny widths: its decoder's weight matrices are the seed's draw times
  VOC_WEIGHT_SCALE, exactly, its vectors, raw split-RVQ quantizer and
  encoder as drawn; it loads through the port's tokenizer on the CPU, and a
  round trip reads at or below MAX_FULL_SCALE_SHARE.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from qwen3_tts_tpu_torch.config import CodecV2Config, CodecV2DecoderConfig, MimiEncoderConfig
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads,
                                               codec12_tokenizer_checkpoint,
                                               random_vocoder_params)
from qwen3_tts_tpu_torch.weights import flatten_state_dict
from tests.test_codec12_decoder import TINY as DEC_TINY
from tests.test_codec12_encoder import TINY as ENC_TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


@pytest.mark.parametrize("wav,share", [
    (np.array([0.5, -1.0, 1.0, 0.0, 0.25, -0.5], np.float32), 2 / 6),
    (np.array([32767, -32768, 0, 100, -16384, 8], np.int16), 2 / 6),
    (np.full(600, 0.25, np.float32), 0.0)], ids=["float", "pcm16", "quiet"])
def test_audio_levels_and_the_full_scale_gate(wav, share):
    levels = cs.audio_levels(wav[:3], torch.from_numpy(wav[3:]))
    y = wav.astype(np.float64) / (32767 if wav.dtype == np.int16 else 1.0)
    assert levels["full_scale_share"] == pytest.approx(share)
    assert levels["audio_rms"] == pytest.approx(float(np.sqrt(np.mean(y ** 2))))
    if share > cs.MAX_FULL_SCALE_SHARE:
        with pytest.raises(AssertionError, match="at full scale"):
            cs.unclamped("case", levels)
    else:
        assert cs.unclamped("case", levels) is levels


def test_scaled_vocoder_params_scale_the_weight_matrices_only():
    cfg = CodecV2DecoderConfig(**DEC_TINY)
    cpu = torch.device("cpu")
    drawn = random_vocoder_params(cfg, torch.Generator(device=cpu).manual_seed(7))
    raw = cs.scaled_vocoder_params(cfg, 7, cpu, scale=1.0)
    scaled = cs.scaled_vocoder_params(cfg, 7, cpu)
    want, got = flatten_state_dict(drawn), flatten_state_dict(scaled)
    assert set(got) == set(want) == set(flatten_state_dict(raw))
    for k, w in want.items():
        assert torch.equal(flatten_state_dict(raw)[k], w), k
        matrix = w.ndim >= 2 and not k.startswith("_codebooks")
        assert torch.equal(got[k], w * cs.VOC_WEIGHT_SCALE if matrix else w), k


def _tiny_codec():
    dec = CodecV2DecoderConfig(**DEC_TINY)
    return CodecV2Config(encoder_config=MimiEncoderConfig.from_dict(ENC_TINY),
                         decoder_config=dec, encoder_valid_num_quantizers=4,
                         input_sample_rate=1000, output_sample_rate=1000,
                         decode_upsample_rate=dec.total_upsample, encode_downsample_rate=16)


def test_eval_tokenizer_decoder_is_scaled_by_the_vocoder_rule(tmp_path):
    import json

    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.weights import save_safetensors

    codec = _tiny_codec()
    cfg_json, got = cs.eval_tokenizer_checkpoint(codec)
    _, raw = codec12_tokenizer_checkpoint(codec, cs.SEED + 31)
    drawn = flatten_state_dict({k: v for k, v in random_vocoder_params(
        codec.decoder_config, torch.Generator().manual_seed(cs.SEED + 31)).items()
        if k != "_codebooks"}, "decoder")
    assert set(got) == set(raw)
    assert set(drawn) == {k for k in got if k.startswith("decoder.")
                          and not k.startswith("decoder.quantizer.")}
    matrices = 0
    for k, w in raw.items():
        if k in drawn:
            assert np.array_equal(w, drawn[k].numpy()), k
            if w.ndim >= 2:
                matrices += 1
                assert torch.equal(torch.from_numpy(got[k]),
                                   drawn[k] * cs.VOC_WEIGHT_SCALE), k
                continue
        # vectors, the raw split-RVQ quantizer and the encoder: as drawn
        assert np.array_equal(got[k], w), k
    assert matrices > 10

    d = tmp_path / "speech_tokenizer"
    d.mkdir()
    save_safetensors(str(d / "model.safetensors"), got)
    with open(d / "config.json", "w") as f:
        json.dump(cfg_json, f)
    tok = Qwen3TTSTokenizer.from_pretrained(str(d), dtype=torch.float32, device="cpu")
    t = np.arange(1600) / 1000
    wav = (0.3 * np.sin(2 * np.pi * 90 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           ).astype(np.float32)
    out, sr = tok.decode(tok.encode(wav, sr=1000))
    levels = cs.unclamped("eval tokenizer round trip", cs.audio_levels(np.asarray(out[0])))
    assert sr == 1000 and levels["audio_rms"] > 0
