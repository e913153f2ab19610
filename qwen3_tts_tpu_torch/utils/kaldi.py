"""Kaldi-compatible fbank features in numpy, torchaudio.compliance.kaldi
semantics (the port's own copy of `qwen3_tts_tpu/utils/kaldi.py`), used
by the 25 Hz tokenizer's CAM++ x-vector front end on the host (reference
vq/speech_vq.py:140-151: kaldi.fbank(num_mel_bins=80, dither=0,
sample_frequency=16000) then mean subtraction).

Implements the default kaldi pipeline: snip-edges framing (25 ms / 10 ms),
DC removal, pre-emphasis 0.97, povey window, power spectrum on
next-power-of-2 FFT, kaldi-scale triangular mel banks (low 20 Hz, high
Nyquist), log with epsilon floor.
"""

from __future__ import annotations

import numpy as np

from functools import lru_cache

EPSILON = 1.1920928955078125e-07  # kaldi float epsilon


def _povey_window(n: int) -> np.ndarray:
    a = 2 * np.pi / (n - 1)
    return ((0.5 - 0.5 * np.cos(a * np.arange(n))) ** 0.85).astype(np.float64)


def _mel(hz):
    return 1127.0 * np.log(1.0 + hz / 700.0)


@lru_cache(maxsize=8)
def _kaldi_mel_bins(num_mel_bins: int, n_fft: int, sample_frequency: float,
                    low_freq: float, high_freq: float) -> "np.ndarray":
    """Kaldi-style triangular mel bank (cached: identical per config, and
    fbank sits on the voice-clone hot path)."""
    nyquist = sample_frequency / 2
    high = high_freq if high_freq > 0 else nyquist + high_freq
    mel_low, mel_high = _mel(np.array(low_freq)), _mel(np.array(high))
    mel_delta = (mel_high - mel_low) / (num_mel_bins + 1)
    fft_freqs = np.arange(n_fft // 2 + 1) * sample_frequency / n_fft
    mel_freqs = _mel(fft_freqs)

    bins = np.zeros((num_mel_bins, n_fft // 2 + 1))
    for m in range(num_mel_bins):
        left = mel_low + m * mel_delta
        center = mel_low + (m + 1) * mel_delta
        right = mel_low + (m + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[m] = np.maximum(0.0, np.minimum(up, down))
    # kaldi excludes the nyquist bin from the banks; done here (not at the
    # call site) so the cached array is never mutated by callers
    bins[:, -1] = 0.0
    bins.setflags(write=False)
    return bins


def fbank(waveform: np.ndarray, num_mel_bins: int = 80,
          sample_frequency: float = 16000.0, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
          low_freq: float = 20.0, high_freq: float = 0.0,
          remove_dc_offset: bool = True) -> np.ndarray:
    """waveform: (T,) float in [-1, 1] -> (frames, num_mel_bins) log-fbank.

    Matches torchaudio.compliance.kaldi.fbank defaults with dither=0.
    Note: torchaudio multiplies [-1,1] float input by 1<<15 internally; the
    scale only shifts the log output by a constant, and CAM++ mean-subtracts,
    but we keep the scale for bitwise parity.
    """
    wav = np.asarray(waveform, np.float64) * 32768.0
    win = int(sample_frequency * frame_length_ms / 1000)
    shift = int(sample_frequency * frame_shift_ms / 1000)
    if len(wav) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(wav) - win) // shift
    idx = np.arange(n_frames)[:, None] * shift + np.arange(win)[None, :]
    frames = wav[idx]

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        prev = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * prev
    frames = frames * _povey_window(win)[None, :]

    n_fft = 1 << (win - 1).bit_length()
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = (spec.real ** 2 + spec.imag ** 2)

    bins = _kaldi_mel_bins(num_mel_bins, n_fft, sample_frequency,
                           low_freq, high_freq)
    feats = power @ bins.T
    return np.log(np.maximum(feats, EPSILON)).astype(np.float32)
