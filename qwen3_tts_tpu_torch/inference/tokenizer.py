"""Qwen3TTSTokenizer, the decode half (counterpart of
`qwen3_tts_tpu/inference/tokenizer.py`).

`decode` takes the encode output, a dict or a list of dicts, pads the codes
up to a multiple of the vocoder chunk, chunk-decodes and trims each row to
its own length. `encode` (the 12 Hz encoder) comes with the voice-clone
slice.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ..config import CodecV2Config, load_config
from ..models.codec12 import decoder as codec_decoder
from ..weights import load_safetensors_dir


class Qwen3TTSTokenizer:
    """12 Hz (V2) codec tokenizer, decode side."""

    def __init__(self):
        self.config = None
        self.dec_params = None
        self.chunk_size = 300
        self.left_context = 25
        self._compute_dtype = torch.float32

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.float32,
                        device="cpu") -> "Qwen3TTSTokenizer":
        """Load the decoder of a 12 Hz tokenizer checkpoint directory."""
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"{model_dir} is not a local directory")
        cfg = load_config(model_dir)
        if not isinstance(cfg, CodecV2Config):
            raise ValueError(f"unsupported tokenizer config at {model_dir}: the "
                             "port decodes the 12 Hz codec only")
        tree = load_safetensors_dir(model_dir, dtype=dtype, key_filter=r"^decoder\.",
                                    device=device)
        inst = cls()
        inst.config = cfg
        inst._compute_dtype = dtype
        inst.dec_params = codec_decoder.prepare_decoder_params(
            tree["decoder"], cfg.decoder_config)
        return inst

    @classmethod
    def from_params(cls, config: CodecV2Config, dec_params=None,
                    dtype=torch.float32) -> "Qwen3TTSTokenizer":
        """Construct from an in-memory prepared decoder tree."""
        inst = cls()
        inst.config = config
        inst.dec_params = dec_params
        inst._compute_dtype = dtype
        return inst

    def get_output_sample_rate(self) -> int:
        return int(self.config.output_sample_rate)

    def get_decode_upsample_rate(self) -> int:
        return int(self.config.decode_upsample_rate)

    def encode(self, *args, **kwargs):
        raise NotImplementedError(
            "the 12 Hz encoder comes with the voice-clone slice")

    def decode(self, encoded, output_dtype: str = "float32"
               ) -> Tuple[List[np.ndarray], int]:
        """Codes -> ([wav per row], sample_rate). `encoded` is a dict or a
        list of dicts with "audio_codes" ((T, Q) each); output_dtype
        "float32" or "int16" (PCM16, converted on the device)."""
        if isinstance(encoded, dict):
            codes_list = encoded["audio_codes"]
        elif isinstance(encoded, list):
            codes_list = [e["audio_codes"] for e in encoded]
        else:
            raise TypeError("`encoded` must be a dict or a list of dicts.")
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported output_dtype {output_dtype!r}")
        out_np = np.int16 if output_dtype == "int16" else np.float32
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
                left_context_size=self.left_context, dtype=self._compute_dtype)
            if out_np is np.int16:
                wav = codec_decoder.to_pcm16(wav)
        wav = wav[:, 0, :].cpu()
        wav = (wav.numpy() if out_np is np.int16 else wav.float().numpy())
        up = self.get_decode_upsample_rate()
        return ([wav[i, :lengths[i] * up].astype(out_np)
                 for i in range(len(codes_list))], self.get_output_sample_rate())
