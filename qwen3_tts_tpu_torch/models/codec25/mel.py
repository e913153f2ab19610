"""Mel front ends of the 25 Hz tokenizer (counterpart of
`qwen3_tts_tpu/models/codec25/mel.py`), computed on the device of the
caller's choice through `torch.fft.rfft`.

- Whisper log-mel (16 kHz, n_fft 400, hop 160, center=True reflect padding,
  log10 + dynamic-range floor): reference vq/whisper_encoder.py:62-107.
- BigVGAN-style mel (filter 1024, hop 160, win 640, fmax 8000, log
  compression): reference vq/speech_vq.py:42-115 (MelSpectrogramFeatures),
  which is `ops/stft.py`'s `mel_spectrogram` at those settings.

Windows and filterbanks are built in numpy as the JAX package builds them,
once per (parameters, device) (`ops/stft.py` `mel_constants`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.stft import mel_constants, mel_spectrogram

N_FFT = 400
HOP_LENGTH = 160


def whisper_log_mel(audio, n_mels: int = 128, padding: int = 0,
                    device=None) -> torch.Tensor:
    """audio: (T,) 16 kHz (numpy or tensor) -> (n_mels, frames) log-mel on
    `device` (default: the tensor's own, or the CPU for numpy input).

    Matches torch.stft(center=True) + magnitude^2 of the reference
    log_mel_spectrogram, the last frame dropped as the reference does."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    if padding > 0:
        x = F.pad(x, (0, padding))
    x = F.pad(x[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    # Hann(400) and the slaney filterbank of 16 kHz, fmin 0, fmax 8 kHz
    window, filters = mel_constants(N_FFT, n_mels, 16000, N_FFT, 0.0, None, x.device)
    frames = x.unfold(0, N_FFT, HOP_LENGTH) * window[None, :]
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    mag = (spec.abs() ** 2).T[:, :-1]          # (freq, frames), last dropped
    log_spec = torch.log10(torch.clamp(filters @ mag, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def get_T_after_cnn(L_in: int, dilation: int = 1) -> int:
    """Output length after the whisper conv stack (k3 p1 s1 then k3 p1 s2).
    Reference: whisper_encoder.py:110-115."""
    for padding, kernel_size, stride in [(1, 3, 1), (1, 3, 2)]:
        L_out = L_in + 2 * padding - dilation * (kernel_size - 1) - 1
        L_in = 1 + L_out // stride
    return L_in


def get_mel_audio(audio, padding: bool = False, audio_vq_ds_rate: int = 1,
                  n_mels: int = 128, device=None) -> torch.Tensor:
    """Reference whisper_encoder.py:118-126: with `padding`, pad the audio so
    the mel frames are a multiple of 2 * ds_rate."""
    pad = 0
    if padding:
        reduction = HOP_LENGTH * 2 * audio_vq_ds_rate
        pad = math.ceil(len(audio) / reduction) * reduction - len(audio)
    return whisper_log_mel(audio, n_mels=n_mels, padding=pad, device=device)


def bigvgan_ref_mel(audio, filter_length: int = 1024, hop_length: int = 160,
                    win_length: int = 640, n_mels: int = 80, fmin: float = 0.0,
                    fmax: float = 8000.0, sr: int = 16000, device=None) -> torch.Tensor:
    """audio: (B, T) 16 kHz -> (B, n_mels, frames) log-compressed mel
    (MelSpectrogramFeatures.extract, speech_vq.py:92-115: reflect pad
    (filter - hop) / 2, Hann(win) zero-padded to filter_length, center=False,
    sqrt(|.|^2 + 1e-9), slaney mel, log(clamp 1e-5))."""
    y = torch.as_tensor(audio, dtype=torch.float32, device=device)
    return mel_spectrogram(y, n_fft=filter_length, num_mels=n_mels, sampling_rate=sr,
                           hop_size=hop_length, win_size=win_length, fmin=fmin,
                           fmax=fmax)
