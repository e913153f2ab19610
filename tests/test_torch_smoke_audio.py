"""chip_smoke.py's audio readings and its vocoder draws, on the CPU.

The smoke holds the port's audio to the eager route, the host and other
requests' contexts on the card; those checks read amplitudes only while
the samples are not clamped to full scale. Here:
- `audio_levels` (RMS and full-scale share, float at +-1 and PCM16 at
  +-32767, arrays and tensors together) and `unclamped`, which fails above
  MAX_FULL_SCALE_SHARE;
- `scaled_vocoder_params` on a tiny decoder config: the seed's draw with
  every weight matrix times the scale, exactly, and the codebooks and
  vectors as drawn (scale 1.0 is the draw itself).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from qwen3_tts_tpu_torch.config import CodecV2DecoderConfig
from qwen3_tts_tpu_torch.utils.testing import random_vocoder_params
from qwen3_tts_tpu_torch.weights import flatten_state_dict
from tests.test_codec12_decoder import TINY as DEC_TINY


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
