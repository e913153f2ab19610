"""25 Hz tokenizer encoder: the Whisper-style transformer with windowed
attention and the GRVQ code search (counterpart of
`qwen3_tts_tpu/models/codec25/encoder.py`; speech -> 1 code / 40 ms).

- The conv stack runs on fixed 2 * n_window-frame chunks of the mel, each of
  which maps to one n_window attention window, so the windows stack into a
  (num_windows, n_window, D) batch with a validity mask, built on the
  device from the valid length (`get_T_after_cnn`): only the last window
  is partial.
- The nearest-code search is an argmin over distances to the (32768, 1280)
  codebook (one group, one quantizer at inference; reference
  core_vq.py:441-523), in fp32 with TF32 off (`tokenizer_fp32`).

Only the encode path runs: the layers up to `audio_vq_layers` and the code
indices (reference quantize_speech, modeling...v1.py:1337-1340).
`encode_mel_to_codes` (the JAX package's jitted program) copies nothing
from host memory, so it can be captured; it runs eagerly (see
`runtime/graphs.py` for why).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...config import WhisperVQEncoderConfig
from ...ops.attention import attention, mask_to_bias
from ...ops.conv import conv1d
from ...ops.norms import layer_norm
from .mel import get_mel_audio, get_T_after_cnn

Params = Dict[str, Any]


def tokenizer_fp32() -> None:
    """TF32 off for cuBLAS matmuls and cuDNN convolutions (process-wide), as
    every fp32 module of the port runs: with TF32 the 32768-way code search
    flips codes and the DiT drifts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def sinusoid_positions(length: int, channels: int,
                       max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper sinusoid table (reference whisper_encoder.py:129-135)."""
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@lru_cache(maxsize=None)
def _device_sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """`sinusoid_positions` on `device`, built at the first call of its
    arguments and kept for good: an encode copies nothing from the host."""
    return torch.from_numpy(sinusoid_positions(length, channels)).to(device)


def window_mask(T_mel: int, n_window: int, device) -> torch.Tensor:
    """(n_chunks, n_window) bool: the positions of each attention window
    that hold frames of a T_mel-frame mel. Windows tile the conv output
    in order and only the last one is partial, so a position is valid
    where its index in the flattened windows is below get_T_after_cnn."""
    n_chunks = -(-T_mel // (2 * n_window))
    idx = torch.arange(n_chunks * n_window, device=device).view(n_chunks, n_window)
    return idx < get_T_after_cnn(T_mel)


def _linear(p: Params, x: torch.Tensor, bias: bool = True) -> torch.Tensor:
    y = x @ p["weight"].T.to(x.dtype)
    return y + p["bias"].to(x.dtype) if bias else y


def _attention_block(block: Params, x: torch.Tensor, mask_bias: torch.Tensor,
                     n_head: int) -> torch.Tensor:
    """ResidualAttentionBlock (reference 265-285): pre-LN MHA (k has no
    bias) + pre-LN GELU MLP."""
    B, T, D = x.shape
    hd = D // n_head
    a = layer_norm(x, block["attn_ln"]["weight"], block["attn_ln"]["bias"])
    ap = block["attn"]
    q = _linear(ap["query"], a).reshape(B, T, n_head, hd)
    k = _linear(ap["key"], a, bias=False).reshape(B, T, n_head, hd)
    v = _linear(ap["value"], a).reshape(B, T, n_head, hd)
    x = x + _linear(ap["out"], attention(q, k, v, mask_bias).reshape(B, T, D))
    m = layer_norm(x, block["mlp_ln"]["weight"], block["mlp_ln"]["bias"])
    m = _linear(block["mlp"]["2"], F.gelu(_linear(block["mlp"]["0"], m)))
    return x + m


def vq_features(params: Params, cfg: WhisperVQEncoderConfig,
                mel: torch.Tensor) -> torch.Tensor:
    """One sample. mel: (n_mels, T_mel) with T_mel a multiple of
    2 * audio_vq_ds_rate -> the vectors the code search quantizes,
    (T_mel // (2 * ds_rate), D) (WhisperEncoderVQ.forward up to the
    quantizer, speech_vq.py:278-323, and _do_quantize 239-250)."""
    chunk = cfg.n_window * 2
    T_mel = mel.shape[-1]
    n_chunks = -(-T_mel // chunk)
    mel_p = F.pad(mel, (0, n_chunks * chunk - T_mel))
    # (n_chunks, n_mels, chunk): a conv per chunk == a conv of the zero-padded chunk
    chunks = mel_p.reshape(mel.shape[0], n_chunks, chunk).permute(1, 0, 2)
    h = F.gelu(conv1d(F.pad(chunks, (1, 1)), params["conv1"]["weight"],
                      params["conv1"]["bias"]))
    h = F.gelu(conv1d(F.pad(h, (1, 1)), params["conv2"]["weight"],
                      params["conv2"]["bias"], stride=2))
    h = h.permute(0, 2, 1)                      # (n_chunks, n_window, D)

    W = cfg.n_window
    pe = params.get("positional_embedding")
    if pe is None:
        pe = _device_sinusoids(cfg.n_ctx, cfg.n_state, h.device)
    h = h + pe[:W][None].to(h.dtype)

    bias = mask_to_bias(window_mask(T_mel, W, h.device)[:, None, None, :])
    for i in range(cfg.audio_vq_layers):
        h = _attention_block(params["blocks"][str(i)], h, bias, cfg.n_head)

    # the valid positions back into one sequence: the windows' first
    # get_T_after_cnn positions in order
    x = h.reshape(n_chunks * W, -1)[:get_T_after_cnn(T_mel)]

    ds = params.get("audio_vq_downsample")
    if ds is not None:   # k = s = ds_rate (reference _do_quantize 247-250)
        x = conv1d(x.T[None], ds["weight"], ds["bias"], stride=cfg.audio_vq_ds_rate)[0].T
    return x


def code_distances(params: Params, x: torch.Tensor) -> torch.Tensor:
    """|e|^2 - 2 x.e for every codebook row e (the squared distance less
    |x|^2), fp32: (N, codebook_size)."""
    embed = params["audio_quantizer"]["rvqs"]["0"]["embed"][0].to(torch.float32)
    return (embed * embed).sum(dim=-1)[None, :] - 2.0 * (x.to(torch.float32) @ embed.T)


def encode_mel_to_codes(params: Params, cfg: WhisperVQEncoderConfig,
                        mel: torch.Tensor) -> torch.Tensor:
    """One sample: mel (n_mels, T_mel) -> codes (T_mel // (2 * ds_rate),)
    int64 on mel's device, the nearest codebook rows (return_indices=True)."""
    return torch.argmin(code_distances(params, vq_features(params, cfg, mel)), dim=-1)


def quantize_speech(params: Params, cfg: WhisperVQEncoderConfig,
                    wavs: List[np.ndarray]) -> Tuple[List[np.ndarray], List[int]]:
    """16 kHz waveforms -> (codes list, lengths), on the device of `params`
    (Qwen3TTSTokenizerV1Encoder.quantize_speech, modeling...v1.py:1337-1340)."""
    tokenizer_fp32()
    device = params["conv1"]["weight"].device
    codes, lens = [], []
    with torch.no_grad():
        for wav in wavs:
            mel = get_mel_audio(np.asarray(wav, np.float32), padding=True,
                                audio_vq_ds_rate=cfg.audio_vq_ds_rate,
                                n_mels=cfg.n_mels, device=device)
            idx = encode_mel_to_codes(params, cfg, mel).cpu().numpy()
            n = get_T_after_cnn(mel.shape[-1]) // cfg.audio_vq_ds_rate
            codes.append(idx[:n].astype(np.int64))
            lens.append(n)
    return codes, lens
