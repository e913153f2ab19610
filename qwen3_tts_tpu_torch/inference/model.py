"""Qwen3TTSModel, the user-facing TTS API (counterpart of
`qwen3_tts_tpu/inference/model.py`), custom-voice synthesis:

    model = Qwen3TTSModel.from_pretrained(ckpt_dir, quantize="int8", device="cuda")
    wavs, sr = model.generate_custom_voice(text=..., speaker=..., language=...)

Prompts assemble per request (runtime/prompts.py), the frame loop runs on
the model's device (runtime/generate.py), and the vocoder decodes chunked
(inference/tokenizer.py). int8 loads default onto the fused sub-talker and,
on a CUDA device, onto the fused talker step: the two hand-written kernels.
Voice design, voice clone and streaming come with later slices.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import TTSModelConfig, load_config
from ..models.talker import prepare_talker_params
from ..ops.sampling import SamplingParams
from ..runtime.generate import (GenerationConfig, generate_frames,
                                generate_frames_chunked)
from ..runtime.prompts import PromptSpec, assemble_prompt_specs
from ..weights import load_safetensors_dir, quantize_talker_params
from .tokenizer import Qwen3TTSTokenizer

MaybeList = Union[Any, List[Any]]


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is not available")
    return device


class Qwen3TTSModel:
    def __init__(self, config: TTSModelConfig, talker_params,
                 speech_tokenizer=None, processor=None,
                 generate_defaults: Optional[Dict] = None,
                 quantized: Optional[str] = None, device="cpu"):
        self.config = config
        self.talker_params = talker_params
        self.speech_tokenizer = speech_tokenizer
        self.processor = processor
        self.generate_defaults = generate_defaults or {}
        # "int8" or None: int8 loads default onto the fused kernels
        self.quantized = quantized
        self.device = _resolve_device(device)

        tc = config.talker_config
        self.supported_speakers = list((tc.spk_id or {}).keys())
        self.supported_languages = ["auto"] + [
            k for k in (tc.codec_language_id or {}) if "dialect" not in k]
        self.tts_model_type = config.tts_model_type
        self.tts_model_size = config.tts_model_size

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.bfloat16,
                        quantize: Optional[str] = None,
                        device="cuda") -> "Qwen3TTSModel":
        """Load a reference-format checkpoint directory (config.json +
        safetensors [+ speech_tokenizer/] [+ generation_config.json]).

        quantize="int8" applies weight-only per-channel int8 to the talker /
        code-predictor matmul weights and the codec head. device="cuda"
        raises when CUDA is absent."""
        device = _resolve_device(device)
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(f"{model_dir} is not a local directory")
        config = load_config(model_dir)
        if not isinstance(config, TTSModelConfig):
            raise ValueError(f"{model_dir} is not a qwen3_tts checkpoint")
        tree = load_safetensors_dir(model_dir, dtype=dtype, key_filter=r"^talker\.",
                                    device=device)
        talker_params = prepare_talker_params(tree["talker"], config.talker_config)
        if quantize == "int8":
            talker_params = quantize_talker_params(talker_params)
        elif quantize is not None:
            raise ValueError(f"unsupported quantize mode {quantize!r}")

        tok_dir = os.path.join(model_dir, "speech_tokenizer")
        speech_tokenizer = (Qwen3TTSTokenizer.from_pretrained(
            tok_dir, dtype=torch.float32, device=device)
            if os.path.isdir(tok_dir) else None)

        processor = None
        try:  # the text tokenizer needs `transformers`, which is optional
            from transformers import AutoTokenizer

            processor = AutoTokenizer.from_pretrained(model_dir)
        except (ImportError, OSError, ValueError):
            pass

        gen_defaults = {}
        gc_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gc_path):
            with open(gc_path, "r", encoding="utf-8") as f:
                gen_defaults = json.load(f)
        return cls(config, talker_params, speech_tokenizer, processor,
                   gen_defaults, quantized=quantize, device=device)

    # -- helpers ------------------------------------------------------------

    def _ensure_list(self, x: MaybeList) -> List[Any]:
        return x if isinstance(x, list) else [x]

    def _broadcast(self, x, n, default=None):
        vals = self._ensure_list(default if x is None else x)
        if len(vals) == 1 and n > 1:
            vals = vals * n
        if len(vals) != n:
            raise ValueError(f"Batch size mismatch: got {len(vals)}, want {n}")
        return vals

    def _build_assistant_text(self, text: str) -> str:
        return f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"

    def _build_instruct_text(self, instruct: str) -> str:
        return f"<|im_start|>user\n{instruct}<|im_end|>\n"

    def _tokenize(self, text: str) -> np.ndarray:
        if self.processor is None:
            raise RuntimeError("no text tokenizer loaded")
        ids = self.processor(text, return_tensors="np")["input_ids"]
        return np.asarray(ids).reshape(-1)

    def _validate_languages(self, languages: List[str]) -> None:
        supported = {s.lower() for s in self.supported_languages}
        bad = [l for l in languages if l is None or str(l).lower() not in supported]
        if bad:
            raise ValueError(
                f"Unsupported languages: {bad}. Supported: {sorted(supported)}")

    def _validate_speakers(self, speakers: List[Optional[str]]) -> None:
        supported = {s.lower() for s in self.supported_speakers}
        bad = [s for s in speakers
               if s not in (None, "") and str(s).lower() not in supported]
        if bad:
            raise ValueError(
                f"Unsupported speakers: {bad}. Supported: {sorted(supported)}")

    def _language_id(self, language: str, speaker: Optional[str]) -> Optional[int]:
        """Language / dialect resolution (reference 2110-2122)."""
        tc = self.config.talker_config
        lang = (language or "auto").lower()
        lang_map = tc.codec_language_id or {}
        language_id = None if lang == "auto" else lang_map[lang]
        if (lang in ("chinese", "auto") and speaker
                and (tc.spk_is_dialect or {}).get(speaker.lower(), False)):
            language_id = lang_map[tc.spk_is_dialect[speaker.lower()]]
        return language_id

    def _merge_generate_kwargs(self, **kwargs) -> Dict[str, Any]:
        """user > generation_config.json > hard defaults."""
        hard = dict(do_sample=True, top_k=50, top_p=1.0, temperature=0.9,
                    repetition_penalty=1.05, subtalker_dosample=True,
                    subtalker_top_k=50, subtalker_top_p=1.0,
                    subtalker_temperature=0.9, max_new_tokens=2048)
        merged = {}
        for name, default in hard.items():
            user_val = kwargs.pop(name, None)
            if user_val is not None:
                merged[name] = user_val
            elif name in self.generate_defaults:
                merged[name] = self.generate_defaults[name]
            else:
                merged[name] = default
        merged.update(kwargs)
        return merged

    def _generation_config(self, kw: Dict[str, Any]) -> GenerationConfig:
        """int8 loads default onto the fused sub-talker, and on a CUDA device
        onto the fused talker step, so the public API runs the kernels."""
        sub_top_p = float(kw["subtalker_top_p"])
        int8 = self.quantized == "int8"
        fused = bool(kw.get("fused_subtalker", int8 and sub_top_p >= 1.0))
        if fused and not int8:
            raise ValueError("fused_subtalker=True requires int8 weights; load with "
                             "from_pretrained(..., quantize='int8')")
        if fused and sub_top_p < 1.0:
            raise ValueError("fused_subtalker=True does not support "
                             "subtalker_top_p < 1")
        fused_step = kw.get("fused_talker_step")
        if fused_step is None:
            fused_step = int8 and self.device.type == "cuda"
        fused_step = bool(fused_step)
        if fused_step and not int8:
            raise ValueError("fused_talker_step=True requires int8 weights; load "
                             "with from_pretrained(..., quantize='int8')")
        if kw.get("kv_quant"):
            raise NotImplementedError("kv_quant (int8 KV cache) is not ported yet")
        return GenerationConfig(
            max_new_tokens=int(kw["max_new_tokens"]),
            min_new_tokens=int(kw.get("min_new_tokens", 2)),
            sampling=SamplingParams(
                do_sample=bool(kw["do_sample"]), top_k=int(kw["top_k"]),
                top_p=float(kw["top_p"]), temperature=float(kw["temperature"]),
                repetition_penalty=float(kw["repetition_penalty"])),
            subtalker=SamplingParams(
                do_sample=bool(kw["subtalker_dosample"]),
                top_k=int(kw["subtalker_top_k"]), top_p=sub_top_p,
                temperature=float(kw["subtalker_temperature"]),
                repetition_penalty=1.0),
            fused_subtalker=fused,
            fused_talker_step=fused_step)

    def _run(self, specs: List[PromptSpec], gen_cfg: GenerationConfig,
             seed: Optional[int] = None) -> List[np.ndarray]:
        tc = self.config.talker_config
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(np.random.randint(0, 2**31)) if seed is None
                              else int(seed))
        with torch.no_grad():
            embeds, mask, trailing, pad = assemble_prompt_specs(
                self.talker_params, tc, self.config, specs, bucket=32)
            # the chunked loop pays one host sync per chunk instead of per
            # frame and attends length buckets of the KV buffer
            run = (generate_frames_chunked if gen_cfg.max_new_tokens > 1024
                   else generate_frames)
            out = run(self.talker_params, tc, gen_cfg, embeds, mask, trailing,
                      pad, generator)
        codes = out.codes.cpu().numpy()
        lens = out.lengths.cpu().numpy()
        return [codes[b, :lens[b]] for b in range(len(specs))]

    # -- custom voice ---------------------------------------------------------

    def _specs_custom_voice(self, text, speaker, language, instruct,
                            non_streaming) -> List[PromptSpec]:
        if self.tts_model_type != "custom_voice":
            raise ValueError(f"model type {self.tts_model_type} does not support "
                             "custom voice")
        texts = self._ensure_list(text)
        n = len(texts)
        languages = self._broadcast(language, n, default="Auto")
        speakers = self._broadcast(speaker, n)
        if self.tts_model_size == "0b6":  # 0.6B: instruct unsupported
            instruct = None
        instructs = self._broadcast(instruct, n, default="")
        self._validate_languages(languages)
        self._validate_speakers(speakers)

        tc = self.config.talker_config
        specs = []
        for t, spk, lang, ins in zip(texts, speakers, languages, instructs):
            spk_embed = (self.talker_params["codec_embedding"][tc.spk_id[spk.lower()]]
                         if spk else None)
            specs.append(PromptSpec(
                input_id=self._tokenize(self._build_assistant_text(t)),
                language_id=self._language_id(lang, spk),
                speaker_embed=spk_embed,
                instruct_id=(self._tokenize(self._build_instruct_text(ins))
                             if ins else None),
                non_streaming=non_streaming))
        return specs

    def generate_custom_voice(self, text, speaker, language=None, instruct=None,
                              non_streaming_mode: bool = True,
                              seed: Optional[int] = None, **kwargs):
        """Returns ([float32 waveform per text], sample_rate)."""
        specs = self._specs_custom_voice(text, speaker, language, instruct,
                                         non_streaming_mode)
        kw = self._merge_generate_kwargs(**kwargs)
        codes = self._run(specs, self._generation_config(kw), seed=seed)
        return self.speech_tokenizer.decode([{"audio_codes": c} for c in codes])
