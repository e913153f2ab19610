"""Audio I/O and resampling without librosa/soundfile (the port's copy of
`qwen3_tts_tpu/utils/audio.py`).

The reference normalizes audio inputs from paths/URLs/base64/ndarrays
(qwen_tts/inference/qwen3_tts_model.py:188-264) via librosa/soundfile.  This
module provides the same surface with zero native audio dependencies:
stdlib WAV parsing, a pure-numpy FLAC decoder (utils/flac.py), and scipy
polyphase resampling. Other formats (mp3/ogg/...) raise.
"""

from __future__ import annotations

import base64
import io
import math
import struct
import wave
from typing import List, Tuple, Union

import numpy as np

AudioLike = Union[str, np.ndarray, Tuple[np.ndarray, int]]


def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV file -> (float32 mono-or-multichannel array, sr).

    Supports PCM 8/16/24/32-bit and IEEE float32/64.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(bytes(path_or_bytes))
    else:
        f = open(path_or_bytes, "rb")
    try:
        data = f.read()
    finally:
        f.close()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # the real format is the SubFormat GUID's leading 16-bit tag
        # (fmt body: 16 base + cbSize 2 + validBits 2 + channelMask 4,
        # GUID at offset 24); guessing from the bit depth misreads 32-bit
        # integer PCM as float32
        if len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            raise ValueError("WAVE_FORMAT_EXTENSIBLE without SubFormat GUID")

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            x = (raw[:, 0].astype(np.int32)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | (raw[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x.reshape(-1, channels)
    return x, int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write a float waveform in [-1, 1] as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim > 1:
        audio = audio.reshape(audio.shape[0], -1)
    pcm = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_audio(path_or_bytes) -> Tuple[np.ndarray, int]:
    """Decode any supported audio payload -> (float32 (T,) or (T, C), sr).

    Dispatch by magic bytes: RIFF/WAVE -> stdlib parser, fLaC -> pure-numpy
    FLAC decoder; any other format raises.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        head = bytes(path_or_bytes[:4])
    else:
        with open(path_or_bytes, "rb") as f:
            head = f.read(4)
    if head[:4] == b"RIFF":
        return read_wav(path_or_bytes)
    if head[:4] == b"fLaC":
        from .flac import read_flac

        return read_flac(path_or_bytes)
    raise ValueError(f"unsupported audio format (magic bytes {head!r}): the port "
                     "reads WAV and FLAC")


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy.signal.resample_poly)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    return resample_poly(audio.astype(np.float64), up, down).astype(np.float32)


def to_mono(audio: np.ndarray) -> np.ndarray:
    if audio.ndim > 1:
        return np.mean(audio, axis=-1).astype(np.float32)
    return audio.astype(np.float32)


def _is_probably_base64(s: str) -> bool:
    if s.startswith("data:audio"):
        return True
    return ("/" not in s and "\\" not in s) and len(s) > 256


def _is_url(s: str) -> bool:
    from urllib.parse import urlparse

    try:
        u = urlparse(s)
        return u.scheme in ("http", "https") and bool(u.netloc)
    except Exception:
        return False


def load_audio(x: AudioLike) -> Tuple[np.ndarray, int]:
    """Normalize one audio input (path / URL / base64 / (ndarray, sr)) to
    (float32 mono waveform, sr).  Mirrors reference _load_audio_to_np /
    _normalize_audio_inputs (qwen3_tts_model.py:207-264)."""
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], np.ndarray):
        return to_mono(x[0]), int(x[1])
    if isinstance(x, np.ndarray):
        raise ValueError("For numpy waveform input, pass a tuple (audio, sr).")
    if not isinstance(x, str):
        raise TypeError(f"Unsupported audio input type: {type(x)}")
    if _is_url(x):
        import urllib.request

        with urllib.request.urlopen(x) as resp:
            payload = resp.read()
        wav, sr = read_audio(payload)
    elif _is_probably_base64(x):
        b64 = x.split(",", 1)[1] if ("," in x and x.strip().startswith("data:")) else x
        wav, sr = read_audio(base64.b64decode(b64))
    else:
        wav, sr = read_audio(x)
    return to_mono(wav), sr


def normalize_audio_inputs(audios: Union[AudioLike, List[AudioLike]]
                           ) -> List[Tuple[np.ndarray, int]]:
    items = audios if isinstance(audios, list) else [audios]
    return [load_audio(a) for a in items]
