"""ECAPA-TDNN speaker encoder (counterpart of
`qwen3_tts_tpu/models/speaker_encoder.py`): the x-vector of a voice clone.

TDNN blocks with reflect 'same' padding, Res2Net channel-split residues,
squeeze-excitation, attentive statistics pooling and a final 1x1 conv to
enc_dim (reference Qwen3TTSSpeakerEncoder, modeling_qwen3_tts.py:95-393).
The parameter tree is the checkpoint's `speaker_encoder.*` state dict,
unflattened; no preparation step.

These were XLA convolutions in the JAX package (no Pallas kernel), so plain
torch carries them, in fp32. `extract_speaker_embedding` turns TF32 off for
cuDNN convolutions and cuBLAS matmuls (`torch.backends.cudnn.allow_tf32`
and `torch.backends.cuda.matmul.allow_tf32`, process-wide), so the card
computes what the reference computes; on a CUDA device a length seen
before is one graph replay, one graph per exact sample count, as the JAX
package jits it per length (`runtime/graphs.py` `front_call`: a length's
first call runs eagerly, its second captures).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import SpeakerEncoderConfig
from ..ops.conv import conv1d
from ..weights import numeric_children

Params = Dict[str, Any]


def _same_reflect_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                       dilation: int = 1) -> torch.Tensor:
    """Conv1d(padding='same', padding_mode='reflect'): torch splits the
    effective padding as (total//2, total - total//2)."""
    total = dilation * (weight.shape[-1] - 1)
    if total > 0:
        x = F.pad(x, (total // 2, total - total // 2), mode="reflect")
    return conv1d(x, weight, bias, dilation=dilation)


def _tdnn(block: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    return torch.relu(_same_reflect_conv(x, block["conv"]["weight"],
                                         block["conv"]["bias"], dilation))


def _res2net(block: Params, x: torch.Tensor, scale: int, dilation: int) -> torch.Tensor:
    """Res2NetBlock (reference 95-126)."""
    blocks = numeric_children(block["blocks"])
    outputs = []
    prev = None
    for i, part in enumerate(torch.chunk(x, scale, dim=1)):
        if i == 0:
            prev = part
        elif i == 1:
            prev = _tdnn(blocks[0], part, dilation)
        else:
            prev = _tdnn(blocks[i - 1], part + prev, dilation)
        outputs.append(prev)
    return torch.cat(outputs, dim=1)


def _se_block(block: Params, x: torch.Tensor) -> torch.Tensor:
    """SqueezeExcitationBlock (reference 129-156)."""
    s = x.mean(dim=2, keepdim=True)
    s = torch.relu(conv1d(s, block["conv1"]["weight"], block["conv1"]["bias"]))
    s = torch.sigmoid(conv1d(s, block["conv2"]["weight"], block["conv2"]["bias"]))
    return x * s


def _se_res2net(block: Params, cfg: SpeakerEncoderConfig, x: torch.Tensor,
                dilation: int) -> torch.Tensor:
    """SqueezeExcitationRes2NetBlock (reference 269-308)."""
    h = _tdnn(block["tdnn1"], x)
    h = _res2net(block["res2net_block"], h, cfg.enc_res2net_scale, dilation)
    h = _tdnn(block["tdnn2"], h)
    return _se_block(block["se_block"], h) + x


def _attentive_stats_pool(block: Params, x: torch.Tensor) -> torch.Tensor:
    """AttentiveStatisticsPooling (reference 159-245), full-length mask."""
    eps = 1e-12
    B, C, T = x.shape

    def stats(m):
        mean = (m * x).sum(dim=2)
        std = torch.sqrt(torch.clamp((m * (x - mean[..., None]) ** 2).sum(dim=2),
                                     min=eps))
        return mean, std

    mean, std = stats(torch.full((B, 1, T), 1.0 / T, dtype=x.dtype, device=x.device))
    attn_in = torch.cat([x, mean[..., None].expand(B, C, T),
                         std[..., None].expand(B, C, T)], dim=1)
    attn = torch.tanh(_tdnn(block["tdnn"], attn_in))
    attn = _same_reflect_conv(attn, block["conv"]["weight"], block["conv"]["bias"])
    mean, std = stats(torch.softmax(attn, dim=2))
    return torch.cat([mean, std], dim=1)[..., None]   # (B, 2C, 1)


def speaker_encoder_forward(params: Params, cfg: SpeakerEncoderConfig,
                            mels: torch.Tensor) -> torch.Tensor:
    """mels: (B, T, mel_dim) -> (B, enc_dim) (reference forward 373-393)."""
    x = mels.permute(0, 2, 1)
    blocks = numeric_children(params["blocks"])
    h = _tdnn(blocks[0], x, cfg.enc_dilations[0])
    feats = []
    for i in range(1, len(cfg.enc_channels) - 1):
        h = _se_res2net(blocks[i], cfg, h, cfg.enc_dilations[i])
        feats.append(h)
    h = _tdnn(params["mfa"], torch.cat(feats, dim=1), cfg.enc_dilations[-1])
    h = _attentive_stats_pool(params["asp"], h)
    h = _same_reflect_conv(h, params["fc"]["weight"], params["fc"]["bias"])
    return h[..., 0]


def extract_speaker_embedding(params: Params, cfg: SpeakerEncoderConfig,
                              audio: torch.Tensor) -> torch.Tensor:
    """24 kHz mono waveform (T,) -> (enc_dim,) speaker embedding: log-mel
    (n_fft 1024, 128 bins, hop 256, win 1024, fmax 12000) -> encoder, in
    fp32 on the device of `params` (reference extract_speaker_embedding,
    modeling_qwen3_tts.py:1940-1954)."""
    from ..ops.stft import mel_spectrogram
    from ..runtime import graphs

    def body(wav):
        # TF32 off here too, so that a capture records the fp32 kernels
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        mels = mel_spectrogram(wav[None, :], n_fft=1024, num_mels=128,
                               sampling_rate=24000, hop_size=256, win_size=1024,
                               fmin=0, fmax=12000)
        return (speaker_encoder_forward(params, cfg, mels.permute(0, 2, 1))[0],)

    audio = torch.as_tensor(audio, dtype=torch.float32)
    return graphs.front_call(params, cfg, "ecapa", (), body, audio)[0]
