"""Qwen3TTSTokenizer, the speech tokenizer (counterpart of
`qwen3_tts_tpu/inference/tokenizer.py`), 12 Hz (V2) and 25 Hz (V1).

- `encode` takes wav path(s) / URL / base64 / numpy (+ sr) / (wav, sr)
  tuples. 12 Hz: pads the batch to a multiple of 8 frames, runs the Mimi
  encoder on the tokenizer's device (on a CUDA device one graph replay per
  call of a shape seen before, one graph per padded (rows, samples): the
  JAX package's `_encode_compiled`; `runtime/graphs.py` `front_call`) and
  trims each row to ceil(len / 1920) frames:
  (T_i, Q) codes per input. 25 Hz: resamples to 16 kHz and returns
  Whisper-VQ codes (T_i,), CAM++ x-vectors and reference mels
  (`models/codec25/model.py`).
- `decode` takes the encode output, a dict or a list of dicts. 12 Hz: pads
  the codes up to a multiple of the vocoder chunk, chunk-decodes (on a CUDA
  device each chunk one graph replay, PCM16 inside it when asked: the JAX
  package's `_decode_compiled` and `to_pcm16`) and trims each row to its
  own length. 25 Hz: pads codes with -1, stacks the
  x-vectors, pads the reference mels, runs the DiT sampler and BigVGAN; the
  sampler's noise is `noise=` or drawn from a generator seeded 0 (the JAX
  package draws `jax.random.PRNGKey(0)`, which torch cannot reproduce).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CodecV1Config, CodecV2Config, load_config
from ..models.codec12 import decoder as codec_decoder
from ..models.codec12 import encoder as codec_encoder
from ..runtime import graphs
from ..utils.audio import load_audio, resample, to_mono
from ..weights import load_safetensors_dir, resolve_checkpoint_dir


def resolve_device(device) -> torch.device:
    """torch.device(device); asking for CUDA where there is none, or for a
    CUDA device index the host does not have, raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but CUDA is not available")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device} requested but this host has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return device


@dataclasses.dataclass
class EncodeOutput:
    audio_codes: List[np.ndarray]          # V2: (T_i, Q) int64 each; V1: (T_i,)
    xvectors: Optional[List[np.ndarray]] = None   # V1 only
    ref_mels: Optional[List[np.ndarray]] = None   # V1 only


class Qwen3TTSTokenizer:
    """12 Hz (V2) or 25 Hz (V1) speech tokenizer: encoder and decoder."""

    def __init__(self):
        self.config = None          # CodecV2Config | CodecV1Config
        self.enc_params = None
        self.dec_params = None
        self.v1_model = None        # models.codec25.model.CodecV1Model
        self.chunk_size = 300
        self.left_context = 25
        self._compute_dtype = torch.float32
        self._fe_sampling_rate: Optional[int] = None

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.float32,
                        device="cuda") -> "Qwen3TTSTokenizer":
        """Load a tokenizer checkpoint directory onto `device`: 12 Hz
        (encoder + decoder) or 25 Hz (encoder, DiT, BigVGAN, and CAM++ from
        `campplus.onnx` when the directory has one), or a Hugging Face repo
        id through `huggingface_hub` (`weights.resolve_checkpoint_dir`).
        device="cuda" raises when CUDA is absent."""
        device = resolve_device(device)
        model_dir = resolve_checkpoint_dir(model_dir)
        cfg = load_config(model_dir)
        if not isinstance(cfg, (CodecV1Config, CodecV2Config)):
            raise ValueError(f"unsupported tokenizer config at {model_dir}")
        tree = load_safetensors_dir(model_dir, dtype=dtype,
                                    key_filter=r"^(en|de)coder\.", device=device)
        inst = cls()
        inst.config = cfg
        inst._compute_dtype = dtype
        if isinstance(cfg, CodecV1Config):
            from ..models.codec25.model import CodecV1Model, XVectorExtractor

            onnx_path = os.path.join(model_dir, "campplus.onnx")
            xv = XVectorExtractor(onnx_path if os.path.exists(onnx_path) else None,
                                  device=device)
            inst.v1_model = CodecV1Model(cfg, tree, xv)
            inst._fe_sampling_rate = 16000
        else:
            if "encoder" in tree:
                inst.enc_params = codec_encoder.prepare_encoder_params(
                    tree["encoder"], cfg.encoder_config)
            inst.dec_params = codec_decoder.prepare_decoder_params(
                tree["decoder"], cfg.decoder_config)
        pre = os.path.join(model_dir, "preprocessor_config.json")
        if os.path.exists(pre):
            with open(pre) as f:
                inst._fe_sampling_rate = json.load(f).get("sampling_rate",
                                                           inst._fe_sampling_rate)
        return inst

    @classmethod
    def from_params(cls, config: CodecV2Config, enc_params=None, dec_params=None,
                    dtype=torch.float32) -> "Qwen3TTSTokenizer":
        """Construct from in-memory prepared encoder / decoder trees."""
        inst = cls()
        inst.config = config
        inst.enc_params = enc_params
        inst.dec_params = dec_params
        inst._compute_dtype = dtype
        return inst

    def get_model_type(self) -> str:
        return self.config.model_type

    def get_input_sample_rate(self) -> int:
        return int(self.config.input_sample_rate)

    def get_output_sample_rate(self) -> int:
        return int(self.config.output_sample_rate)

    def get_encode_downsample_rate(self) -> int:
        return int(self.config.encode_downsample_rate)

    def get_decode_upsample_rate(self) -> int:
        return int(self.config.decode_upsample_rate)

    # -- encode -----------------------------------------------------------

    def _normalize_audio_inputs(self, audios, sr: Optional[int]) -> List[np.ndarray]:
        target_sr = self._fe_sampling_rate or self.get_input_sample_rate()
        if isinstance(audios, (str, np.ndarray)):
            audios = [audios]
        elif (isinstance(audios, tuple) and len(audios) == 2
                and isinstance(audios[0], np.ndarray)):
            audios = [audios]   # a single (wav, sr) pair, not a sequence
        out = []
        for a in audios:
            if isinstance(a, str):
                wav, asr = load_audio(a)
            elif isinstance(a, np.ndarray):
                if sr is None:
                    raise ValueError("For numpy waveform input, you must provide `sr`.")
                wav, asr = to_mono(a), int(sr)
            elif isinstance(a, tuple):
                wav, asr = to_mono(a[0]), int(a[1])
            else:
                raise TypeError(f"Unsupported audio input type: {type(a)}")
            if asr != target_sr:
                wav = resample(wav, asr, target_sr)
            out.append(wav.astype(np.float32))
        return out

    def encode(self, audios, sr: Optional[int] = None, return_dict: bool = True):
        """Audio -> EncodeOutput(audio_codes=[(T_i, Q) int64 per input]);
        25 Hz: EncodeOutput(audio_codes=[(T_i,)], xvectors, ref_mels)."""
        if self.v1_model is not None:
            codes, xvectors, ref_mels = self.v1_model.encode(
                self._normalize_audio_inputs(audios, sr))
            return (EncodeOutput(codes, xvectors, ref_mels) if return_dict
                    else (codes, xvectors, ref_mels))
        if self.enc_params is None:
            raise RuntimeError("this tokenizer has no encoder loaded")
        wavs = self._normalize_audio_inputs(audios, sr)
        ds = self.get_encode_downsample_rate()
        lengths = [len(w) for w in wavs]
        # pad to a multiple of 8 frames, as the JAX package buckets
        bucket = ds * 8
        padded_len = -(-max(lengths) // bucket) * bucket
        batch = np.zeros((len(wavs), padded_len), np.float32)
        for i, w in enumerate(wavs):
            batch[i, :len(w)] = w
        cfg, nq = self.config.encoder_config, int(self.config.encoder_valid_num_quantizers)
        dtype = self._compute_dtype

        def body(wav):
            return (codec_encoder.encode_waveform(self.enc_params, cfg, wav, num_quantizers=nq,
                                                  dtype=dtype),)

        with torch.no_grad():
            (codes,) = graphs.front_call(self.enc_params, cfg, "encode", (nq, dtype), body,
                                         torch.from_numpy(batch))
        codes = codes.cpu().numpy()
        # per-row trim to ceil(len / ds) frames (reference modeling...v2.py:984)
        out = [codes[i, :, :-(-n // ds)].T.astype(np.int64)
               for i, n in enumerate(lengths)]
        return EncodeOutput(audio_codes=out) if return_dict else (out,)

    # -- decode -----------------------------------------------------------

    def decode(self, encoded, output_dtype: str = "float32", noise=None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[List[np.ndarray], int]:
        """Codes -> ([wav per row], sample_rate). `encoded` is an encode
        output, a dict or a list of dicts with "audio_codes" ((T, Q) each;
        25 Hz: (T,) with "xvectors" and "ref_mels"); output_dtype "float32"
        or "int16" (PCM16). 25 Hz only: the sampler's `noise` ((B, T_max *
        repeats, mel_dim)) or a `generator` to draw it from."""
        xvectors = ref_mels = None
        if hasattr(encoded, "audio_codes"):
            codes_list = encoded.audio_codes
            xvectors = getattr(encoded, "xvectors", None)
            ref_mels = getattr(encoded, "ref_mels", None)
        elif isinstance(encoded, dict):
            codes_list = encoded["audio_codes"]
            xvectors, ref_mels = encoded.get("xvectors"), encoded.get("ref_mels")
        elif isinstance(encoded, list):
            codes_list = [e["audio_codes"] for e in encoded]
            if "xvectors" in encoded[0]:
                xvectors = [e["xvectors"] for e in encoded]
            if "ref_mels" in encoded[0]:
                ref_mels = [e["ref_mels"] for e in encoded]
        else:
            raise TypeError("`encoded` must be an encode output, a dict, or a "
                            "list of dicts.")
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported output_dtype {output_dtype!r}")
        out_np = np.int16 if output_dtype == "int16" else np.float32
        if self.v1_model is not None:
            return self._decode_v1(codes_list, xvectors, ref_mels, out_np, noise, generator)
        if not isinstance(codes_list, (list, tuple)):
            t = np.asarray(codes_list)
            codes_list = [t] if t.ndim == 2 else list(t)
        codes_list = [np.asarray(c.cpu() if torch.is_tensor(c) else c)
                      for c in codes_list]
        lengths = [c.shape[0] for c in codes_list]
        max_t = max(lengths)
        if max_t == 0:
            return ([np.zeros((0,), out_np) for _ in codes_list],
                    self.get_output_sample_rate())
        # pad to the vocoder chunk: padded frames only affect samples past
        # each row's trim point (the stack is causal)
        q = codes_list[0].shape[1]
        padded_t = -(-max_t // self.chunk_size) * self.chunk_size
        batch = np.zeros((len(codes_list), q, padded_t), np.int64)
        for i, c in enumerate(codes_list):
            batch[i, :, :c.shape[0]] = np.clip(c.T, 0, None)
        device = self.dec_params["_codebooks"].device
        with torch.no_grad():
            wav = codec_decoder.chunked_decode(
                self.dec_params, self.config.decoder_config,
                torch.as_tensor(batch, device=device), chunk_size=self.chunk_size,
                left_context_size=self.left_context, dtype=self._compute_dtype,
                pcm16=out_np is np.int16)
        wav = wav[:, 0, :].cpu()
        wav = (wav.numpy() if out_np is np.int16 else wav.float().numpy())
        up = self.get_decode_upsample_rate()
        return ([wav[i, :lengths[i] * up].astype(out_np)
                 for i in range(len(codes_list))], self.get_output_sample_rate())

    def _decode_v1(self, codes_list, xvectors, ref_mels, out_np=np.float32, noise=None,
                   generator=None) -> Tuple[List[np.ndarray], int]:
        """25 Hz decode: pad codes with -1, stack x-vectors, pad ref mels
        (reference qwen3_tts_tokenizer.py:331-355)."""
        if xvectors is None or ref_mels is None:
            raise ValueError("25Hz decode requires `xvectors` and `ref_mels`.")
        if not isinstance(codes_list, (list, tuple)):
            t = np.asarray(codes_list)
            codes_list = [t] if t.ndim == 1 else list(t)
        codes_list = [np.asarray(c).reshape(-1) for c in codes_list]
        B = len(codes_list)
        codes = np.full((B, max(c.shape[0] for c in codes_list)), -1, np.int64)
        for i, c in enumerate(codes_list):
            codes[i, :c.shape[0]] = c
        xv = np.stack([np.asarray(x) for x in xvectors], axis=0)
        ref_mels = [np.asarray(m) for m in ref_mels]
        rm = np.zeros((B, max(m.shape[0] for m in ref_mels), ref_mels[0].shape[-1]),
                      np.float32)
        for i, m in enumerate(ref_mels):
            rm[i, :m.shape[0]] = m
        wavs = self.v1_model.decode(codes, xv, rm, noise=noise, generator=generator)
        if out_np is np.int16:
            # the rounding of the 12 Hz path's to_pcm16 and of the WAV writer
            wavs = [np.round(np.clip(w.astype(np.float32), -1.0, 1.0) * 32767.0
                             ).astype(np.int16) for w in wavs]
        return [w.astype(out_np) for w in wavs], self.get_output_sample_rate()
