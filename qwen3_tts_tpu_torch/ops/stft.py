"""STFT / mel front end (counterpart of `qwen3_tts_tpu/ops/stft.py`).

Matches the reference mel pipeline (modeling_qwen3_tts.py:396-464):
reflect-pad (n_fft - hop)/2, Hann window, center=False STFT, magnitude
sqrt(re^2+im^2+1e-9), slaney-norm mel filterbank (librosa.filters.mel
semantics), log dynamic-range compression with clip 1e-5. The window and
filterbank are built in numpy (float64, then float32) exactly as the JAX
package builds them, once per (parameters, device) and kept there
(`mel_constants`): a graph that captures `mel_spectrogram` must not copy
them from pageable host memory, and the JAX package bakes them into its
program as constants. Frames go through `torch.fft.rfft`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_size: int) -> np.ndarray:
    """torch.hann_window(periodic=True)."""
    n = np.arange(win_size)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))).astype(np.float32)


def _hz_to_mel_slaney(f):
    f = np.atleast_1d(np.asarray(f, dtype=np.float64))
    mels = f / (200.0 / 3)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels[log_t] = min_log_mel + np.log(f[log_t] / min_log_hz) / logstep
    return mels


def _mel_to_hz_slaney(m):
    m = np.atleast_1d(np.asarray(m, dtype=np.float64))
    freqs = m * (200.0 / 3)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    freqs[log_t] = min_log_hz * np.exp(logstep * (m[log_t] - min_log_mel))
    return freqs


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank
    (librosa.filters.mel semantics). Returns (n_mels, n_fft//2+1) float32."""
    if fmax is None:
        fmax = float(sr) / 2
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0, float(sr) / 2, n_freqs)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin)[0], _hz_to_mel_slaney(fmax)[0],
                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    weights = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int,
                   window: torch.Tensor) -> torch.Tensor:
    """Center=False magnitude STFT. y: (B, T) -> (B, n_fft//2+1, frames).

    `window` must be length n_fft (callers with a shorter analysis window
    pre-pad it, as mel_spectrogram does)."""
    frames = y.to(torch.float32).unfold(-1, n_fft, hop_size)   # (B, frames, n_fft)
    spec = torch.fft.rfft(frames * window[None, None, :], n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.permute(0, 2, 1)


_MEL_CONSTANTS: dict = {}


def mel_constants(n_fft: int, num_mels: int, sampling_rate: int, win_size: int,
                  fmin: float, fmax: Optional[float], device) -> tuple:
    """(Hann window zero-padded to n_fft, mel filterbank) on `device`,
    built at the first call of their parameters and device, then kept."""
    key = (n_fft, num_mels, sampling_rate, win_size, fmin, fmax, torch.device(device))
    got = _MEL_CONSTANTS.get(key)
    if got is None:
        window = hann_window(win_size)
        if win_size < n_fft:
            lpad = (n_fft - win_size) // 2
            window = np.pad(window, (lpad, n_fft - win_size - lpad))
        basis = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
        got = _MEL_CONSTANTS[key] = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                                          for x in (window, basis))
    return got


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int,
                    sampling_rate: int, hop_size: int, win_size: int,
                    fmin: float = 0.0, fmax: Optional[float] = None) -> torch.Tensor:
    """y: (B, T) waveform in [-1, 1] -> (B, num_mels, frames) log-mel."""
    pad = (n_fft - hop_size) // 2
    y = F.pad(y.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    window, basis = mel_constants(n_fft, num_mels, sampling_rate, win_size, fmin, fmax,
                                  y.device)
    mag = stft_magnitude(y, n_fft, hop_size, window)
    mel = torch.einsum("mf,bft->bmt", basis, mag)
    return torch.log(torch.clamp(mel, min=1e-5))
