"""Qwen3TTSModel, the user-facing TTS API (counterpart of
`qwen3_tts_tpu/inference/model.py`):

    model = Qwen3TTSModel.from_pretrained(ckpt_dir, quantize="int8")
    wavs, sr = model.generate_custom_voice(text=..., speaker=..., language=...)
    wavs, sr = model.generate_voice_design(text=..., instruct=...)
    items    = model.create_voice_clone_prompt(ref_audio=..., ref_text=...)
    wavs, sr = model.generate_voice_clone(text=..., voice_clone_prompt=items)
    for wav, sr in model.stream_custom_voice(text=..., speaker=...): ...

Everything runs on the model's device, the card unless the caller asks for
the CPU. Prompts assemble per request (runtime/prompts.py), the frame loop
runs in runtime/generate.py, and the vocoder decodes chunked
(inference/tokenizer.py); `stream_*` interleave talker chunks with vocoder
chunks (runtime/streaming.py). int8 loads default onto the fused
sub-talker and, on a CUDA device, onto the fused talker step; prompts of
2048 tokens or more prefill through the flash prefill kernel. `kv_quant=True`
stores the talker KV cache in int8.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import TTSModelConfig, load_config
from ..models.speaker_encoder import extract_speaker_embedding
from ..models.talker import prepare_talker_params
from ..ops.cuda.subtalker import config_misfit as subtalker_misfit
from ..ops.cuda.talker_step import config_misfit as talker_step_misfit
from ..ops.sampling import SamplingParams
from ..runtime.generate import (GenerationConfig, generate_frames,
                                generate_frames_chunked)
from ..runtime.prompts import PromptSpec, assemble_prompt_specs
from ..utils.audio import AudioLike, normalize_audio_inputs, resample
from ..weights import load_safetensors_dir, quantize_talker_params, resolve_checkpoint_dir
from .tokenizer import Qwen3TTSTokenizer, resolve_device

MaybeList = Union[Any, List[Any]]


@dataclass
class VoiceClonePromptItem:
    """One sample's voice-clone prompt (reference VoiceClonePromptItem,
    qwen3_tts_model.py:40-52)."""

    ref_code: Optional[np.ndarray]       # (T, Q) or None (x-vector only)
    ref_spk_embedding: np.ndarray        # (D,)
    x_vector_only_mode: bool
    icl_mode: bool
    ref_text: Optional[str] = None


def save_voice_clone_prompts(path: str, items: List[VoiceClonePromptItem]) -> None:
    """Persist prompt items. `.pt` paths write the reference demo's torch
    payload {"items": [asdict(item)]} with tensor fields (qwen_tts/cli/
    demo.py:516-522); any other extension writes a torch-free .npz. Both
    formats are the JAX package's."""
    if str(path).endswith(".pt"):
        torch.save({"items": [{
            "ref_code": (None if it.ref_code is None
                         else torch.from_numpy(np.array(it.ref_code))),
            "ref_spk_embedding": torch.from_numpy(
                np.array(it.ref_spk_embedding, np.float32)),
            "x_vector_only_mode": bool(it.x_vector_only_mode),
            "icl_mode": bool(it.icl_mode),
            "ref_text": it.ref_text,
        } for it in items]}, path)
        return
    payload: Dict[str, Any] = {"n": np.asarray(len(items))}
    for i, it in enumerate(items):
        payload[f"spk_{i}"] = np.asarray(it.ref_spk_embedding)
        payload[f"xvec_{i}"] = np.asarray(it.x_vector_only_mode)
        payload[f"icl_{i}"] = np.asarray(it.icl_mode)
        payload[f"text_{i}"] = np.asarray(it.ref_text or "")
        if it.ref_code is not None:
            payload[f"code_{i}"] = np.asarray(it.ref_code)
    np.savez(path, **payload)


def _load_pt_prompts(path: str) -> List[VoiceClonePromptItem]:
    """A reference-made `.pt` payload (qwen_tts/cli/demo.py:533-563)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "items" not in payload:
        raise ValueError(f"{path}: not a voice-clone prompt payload (missing 'items')")
    items = []
    for d in payload["items"]:
        code = d.get("ref_code")
        if code is not None:
            code = np.asarray(code.numpy() if torch.is_tensor(code) else code)
        spk = d.get("ref_spk_embedding")
        if spk is None:
            raise ValueError(f"{path}: item missing ref_spk_embedding")
        spk = np.asarray(spk.numpy() if torch.is_tensor(spk) else spk, np.float32)
        xvec = bool(d.get("x_vector_only_mode", False))
        items.append(VoiceClonePromptItem(
            ref_code=code, ref_spk_embedding=spk, x_vector_only_mode=xvec,
            icl_mode=bool(d.get("icl_mode", not xvec)), ref_text=d.get("ref_text")))
    return items


def load_voice_clone_prompts(path: str) -> List[VoiceClonePromptItem]:
    """Load `.npz` or reference-demo `.pt` voice-clone prompts."""
    if str(path).endswith(".pt"):
        return _load_pt_prompts(path)
    data = np.load(path, allow_pickle=False)
    items = []
    for i in range(int(data["n"])):
        text = str(data[f"text_{i}"])
        items.append(VoiceClonePromptItem(
            ref_code=data[f"code_{i}"] if f"code_{i}" in data else None,
            ref_spk_embedding=data[f"spk_{i}"],
            x_vector_only_mode=bool(data[f"xvec_{i}"]),
            icl_mode=bool(data[f"icl_{i}"]), ref_text=text or None))
    return items


class Qwen3TTSModel:
    def __init__(self, config: TTSModelConfig, talker_params,
                 speaker_encoder_params=None, speech_tokenizer=None,
                 processor=None, generate_defaults: Optional[Dict] = None,
                 quantized: Optional[str] = None, device="cuda"):
        self.config = config
        self.talker_params = talker_params
        self.speaker_encoder_params = speaker_encoder_params
        self.speech_tokenizer = speech_tokenizer
        self.processor = processor
        self.generate_defaults = generate_defaults or {}
        # "int8" or None: int8 loads default onto the fused kernels
        self.quantized = quantized
        self.device = resolve_device(device)

        tc = config.talker_config
        self.supported_speakers = list((tc.spk_id or {}).keys())
        self.supported_languages = ["auto"] + [
            k for k in (tc.codec_language_id or {}) if "dialect" not in k]
        self.tts_model_type = config.tts_model_type
        self.tts_model_size = config.tts_model_size
        self.tokenizer_type = config.tokenizer_type
        self.speaker_encoder_sample_rate = config.speaker_encoder_config.sample_rate

    @classmethod
    def from_pretrained(cls, model_dir: str, dtype=torch.bfloat16,
                        quantize: Optional[str] = None,
                        device="cuda") -> "Qwen3TTSModel":
        """Load a reference-format checkpoint directory (config.json +
        safetensors [+ speech_tokenizer/] [+ generation_config.json]), or a
        Hugging Face repo id through `huggingface_hub` where the path is not
        a local directory (`weights.resolve_checkpoint_dir`).

        quantize="int8" applies weight-only per-channel int8 to the talker /
        code-predictor matmul weights and the codec head. device="cuda"
        raises when CUDA is absent. The speaker encoder (`speaker_encoder.*`,
        base checkpoints) loads at `dtype`, as the JAX package loads it."""
        device = resolve_device(device)
        model_dir = resolve_checkpoint_dir(model_dir)
        config = load_config(model_dir)
        if not isinstance(config, TTSModelConfig):
            raise ValueError(f"{model_dir} is not a qwen3_tts checkpoint")
        tree = load_safetensors_dir(model_dir, dtype=dtype,
                                    key_filter=r"^(talker|speaker_encoder)\.",
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
        return cls(config, talker_params, tree.get("speaker_encoder"),
                   speech_tokenizer, processor, gen_defaults, quantized=quantize,
                   device=device)

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
        onto the fused talker step, so the public API runs the kernels. On
        a CUDA device a kernel is the default only where the talker's shapes
        fit it (`config_misfit` of each wrapper; the JAX kernels take every
        shape, so a misfit runs the plain route); a flag the caller names is
        taken as given, and a misfit then raises at the first frame."""
        sub_top_p = float(kw["subtalker_top_p"])
        int8 = self.quantized == "int8"
        tc = self.config.talker_config
        on_card = self.device.type == "cuda"
        fused = kw.get("fused_subtalker")
        if fused is None:
            fused = (int8 and sub_top_p >= 1.0
                     and not (on_card and subtalker_misfit(tc) is not None))
        fused = bool(fused)
        if fused and not int8:
            raise ValueError("fused_subtalker=True requires int8 weights; load with "
                             "from_pretrained(..., quantize='int8')")
        if fused and sub_top_p < 1.0:
            raise ValueError("fused_subtalker=True does not support "
                             "subtalker_top_p < 1")
        fused_step = kw.get("fused_talker_step")
        if fused_step is None:
            fused_step = int8 and on_card and talker_step_misfit(tc) is None
        fused_step = bool(fused_step)
        if fused_step and not int8:
            raise ValueError("fused_talker_step=True requires int8 weights; load "
                             "with from_pretrained(..., quantize='int8')")
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
            kv_quant=bool(kw.get("kv_quant", False)),
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

    def _stream_run(self, specs: List[PromptSpec], gen_cfg: GenerationConfig,
                    seed: Optional[int] = None, context_codes=None, context_lens=None):
        """Streaming counterpart of _run: yields (wav_chunk (B, samples), sr)
        packets as the session produces them. Each row's samples past its
        EOS are silenced, and trailing columns no row still uses are
        dropped (their frames are zero-masked codes, but the vocoder still
        makes audio of them)."""
        from ..runtime.streaming import StreamingSession

        tok = self.speech_tokenizer
        if tok is None or tok.dec_params is None:
            raise RuntimeError("streaming requires a loaded 12Hz speech tokenizer (vocoder)")
        tc = self.config.talker_config
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(np.random.randint(0, 2**31)) if seed is None
                              else int(seed))
        sr = tok.get_output_sample_rate()
        up = tok.config.decoder_config.total_upsample
        with torch.no_grad():
            embeds, mask, trailing, pad = assemble_prompt_specs(
                self.talker_params, tc, self.config, specs, bucket=32)
            session = StreamingSession(self.talker_params, tc, gen_cfg, tok.dec_params,
                                       tok.config.decoder_config)
            for pkt in session.run(embeds, mask, trailing, pad, generator,
                                   context_codes=context_codes,
                                   context_lens=context_lens):
                wav = pkt.wav
                n_active = pkt.active_frames.astype(np.int64)
                max_active = int(n_active.max())
                if max_active < pkt.frame_count:
                    wav = wav[:, :max_active * up]
                if (n_active < max_active).any():
                    cols = np.arange(wav.shape[1])[None, :]
                    wav = np.where(cols < n_active[:, None] * up, wav, 0.0)
                if wav.shape[1] == 0:
                    continue
                yield wav.astype(np.float32), sr

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

    def stream_custom_voice(self, text, speaker, language=None, instruct=None,
                            seed: Optional[int] = None, **kwargs):
        """Streaming custom voice: yields (wav_chunk (B, samples), sr)
        packets, the first after one frame."""
        specs = self._specs_custom_voice(text, speaker, language, instruct,
                                         non_streaming=False)
        kw = self._merge_generate_kwargs(**kwargs)
        return self._stream_run(specs, self._generation_config(kw), seed=seed)

    def get_supported_speakers(self) -> List[str]:
        return sorted(s.lower() for s in self.supported_speakers)

    def get_supported_languages(self) -> List[str]:
        return sorted(s.lower() for s in self.supported_languages)

    # -- voice design -------------------------------------------------------

    def _specs_voice_design(self, text, instruct, language,
                            non_streaming) -> List[PromptSpec]:
        if self.tts_model_type != "voice_design":
            raise ValueError(f"model type {self.tts_model_type} does not support "
                             "voice design")
        texts = self._ensure_list(text)
        n = len(texts)
        languages = self._broadcast(language, n, default="Auto")
        instructs = self._broadcast(instruct, n)
        self._validate_languages(languages)
        return [PromptSpec(
            input_id=self._tokenize(self._build_assistant_text(t)),
            language_id=self._language_id(lang, None),
            instruct_id=(self._tokenize(self._build_instruct_text(ins))
                         if ins else None),
            non_streaming=non_streaming)
            for t, lang, ins in zip(texts, languages, instructs)]

    def generate_voice_design(self, text, instruct, language=None,
                              non_streaming_mode: bool = True,
                              seed: Optional[int] = None, **kwargs):
        """Returns ([float32 waveform per text], sample_rate)."""
        specs = self._specs_voice_design(text, instruct, language, non_streaming_mode)
        kw = self._merge_generate_kwargs(**kwargs)
        codes = self._run(specs, self._generation_config(kw), seed=seed)
        return self.speech_tokenizer.decode([{"audio_codes": c} for c in codes])

    def stream_voice_design(self, text, instruct, language=None,
                            seed: Optional[int] = None, **kwargs):
        """Streaming voice design: yields (wav_chunk, sr) packets."""
        specs = self._specs_voice_design(text, instruct, language, False)
        kw = self._merge_generate_kwargs(**kwargs)
        return self._stream_run(specs, self._generation_config(kw), seed=seed)

    # -- voice clone ----------------------------------------------------------

    def _build_ref_text(self, text: str) -> str:
        return f"<|im_start|>assistant\n{text}<|im_end|>\n"

    def extract_speaker_embedding(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """24 kHz mono waveform -> (enc_dim,) float32 x-vector, computed on
        the model's device."""
        want_sr = self.speaker_encoder_sample_rate
        if sr != want_sr:
            raise ValueError(f"speaker encoder expects {want_sr} Hz audio, got {sr}")
        if self.speaker_encoder_params is None:
            raise RuntimeError("this checkpoint has no speaker encoder")
        with torch.no_grad():
            emb = extract_speaker_embedding(self.speaker_encoder_params,
                                            self.config.speaker_encoder_config, audio)
        return emb.float().cpu().numpy()

    def create_voice_clone_prompt(
            self, ref_audio: Union[AudioLike, List[AudioLike]],
            ref_text: Optional[Union[str, List[Optional[str]]]] = None,
            x_vector_only_mode: Union[bool, List[bool]] = False,
    ) -> List[VoiceClonePromptItem]:
        """Reference audio (+ its transcript) -> prompt items: the codec codes
        of the clip (ICL mode) and its speaker embedding (reference
        qwen3_tts_model.py:355-458)."""
        if self.tts_model_type != "base":
            raise ValueError(f"model type {self.tts_model_type} does not support "
                             "create_voice_clone_prompt")
        ref_audio_list = self._ensure_list(ref_audio)
        n = len(ref_audio_list)
        ref_text_list = ref_text if isinstance(ref_text, list) else [ref_text] * n
        xvec_list = (x_vector_only_mode if isinstance(x_vector_only_mode, list)
                     else [x_vector_only_mode] * n)
        if len(ref_text_list) != n or len(xvec_list) != n:
            raise ValueError("Batch size mismatch in voice clone prompt inputs")
        normalized = normalize_audio_inputs(ref_audio_list)
        ref_codes = self.speech_tokenizer.encode(list(normalized)).audio_codes
        items = []
        for i, ((wav, sr), code, rtext, xvec) in enumerate(
                zip(normalized, ref_codes, ref_text_list, xvec_list)):
            if not xvec and not rtext:
                raise ValueError("ref_text is required when x_vector_only_mode="
                                 f"False (ICL mode). Bad index={i}")
            wav24 = resample(wav, sr, self.speaker_encoder_sample_rate)
            items.append(VoiceClonePromptItem(
                ref_code=None if xvec else np.asarray(code),
                ref_spk_embedding=self.extract_speaker_embedding(
                    wav24, self.speaker_encoder_sample_rate),
                x_vector_only_mode=bool(xvec), icl_mode=bool(not xvec),
                ref_text=rtext))
        return items

    def _specs_voice_clone(self, text, language, ref_audio, ref_text,
                           x_vector_only_mode, voice_clone_prompt, non_streaming):
        if self.tts_model_type != "base":
            raise ValueError(f"model type {self.tts_model_type} does not support "
                             "voice clone")
        texts = self._ensure_list(text)
        n = len(texts)
        languages = self._broadcast(language, n, default="Auto")
        self._validate_languages(languages)
        if voice_clone_prompt is None:
            if ref_audio is None:
                raise ValueError("Either `voice_clone_prompt` or `ref_audio` must "
                                 "be provided.")
            items = self.create_voice_clone_prompt(
                ref_audio=ref_audio, ref_text=ref_text,
                x_vector_only_mode=x_vector_only_mode)
        else:
            items = voice_clone_prompt
        if len(items) == 1 and n > 1:
            items = items * n
        if len(items) != n:
            raise ValueError(f"Batch size mismatch: prompt={len(items)}, text={n}")
        specs = []
        for t, lang, item in zip(texts, languages, items):
            icl = item.icl_mode and item.ref_code is not None
            specs.append(PromptSpec(
                input_id=self._tokenize(self._build_assistant_text(t)),
                language_id=self._language_id(lang, None),
                speaker_embed=(np.asarray(item.ref_spk_embedding)
                               if (item.x_vector_only_mode or item.icl_mode) else None),
                ref_id=(self._tokenize(self._build_ref_text(item.ref_text))
                        if icl else None),
                ref_code=item.ref_code if icl else None,
                non_streaming=non_streaming))
        return specs, items

    def generate_voice_clone(self, text, language=None, ref_audio=None,
                             ref_text=None, x_vector_only_mode=False,
                             voice_clone_prompt=None,
                             non_streaming_mode: bool = False,
                             seed: Optional[int] = None, **kwargs):
        """Returns ([float32 waveform per text], sample_rate). Rows with
        reference codes decode those codes ahead of the generated ones (the
        vocoder's left context) and drop the same share of samples from the
        front (reference qwen3_tts_model.py:469-633)."""
        specs, items = self._specs_voice_clone(
            text, language, ref_audio, ref_text, x_vector_only_mode,
            voice_clone_prompt, non_streaming_mode)
        kw = self._merge_generate_kwargs(**kwargs)
        codes = self._run(specs, self._generation_config(kw), seed=seed)
        codes_for_decode = [c if it.ref_code is None
                            else np.concatenate([np.asarray(it.ref_code), c], axis=0)
                            for it, c in zip(items, codes)]
        wavs, fs = self.speech_tokenizer.decode(
            [{"audio_codes": c} for c in codes_for_decode])
        out = []
        for wav, it, c in zip(wavs, items, codes_for_decode):
            rl = 0 if it.ref_code is None else len(it.ref_code)
            out.append(wav[int(rl / max(len(c), 1) * wav.shape[0]):] if rl else wav)
        return out, fs

    def stream_voice_clone(self, text, language=None, ref_audio=None, ref_text=None,
                           x_vector_only_mode=False, voice_clone_prompt=None,
                           seed: Optional[int] = None, **kwargs):
        """Streaming voice clone: yields (wav_chunk, sr) packets of the
        generated audio only. Each row's last reference frames, right-aligned
        into (B, Q, T0) with per-row lengths, are its vocoder left context, so
        a batch mixing ICL and x-vector-only rows keeps each row's own."""
        from ..runtime.streaming import StreamingConfig

        specs, items = self._specs_voice_clone(text, language, ref_audio, ref_text,
                                               x_vector_only_mode, voice_clone_prompt,
                                               False)
        cap = StreamingConfig().vocoder_left_context
        lens = [min(cap, 0 if it.ref_code is None else len(it.ref_code)) for it in items]
        context = context_lens = None
        t0 = max(lens, default=0)
        if t0 > 0:
            context = np.zeros((len(items), self.config.talker_config.num_code_groups, t0),
                               np.int64)
            for i, (it, n) in enumerate(zip(items, lens)):
                if n:
                    context[i, :, t0 - n:] = np.asarray(it.ref_code)[-n:].T
            context_lens = np.asarray(lens, np.int64)
        kw = self._merge_generate_kwargs(**kwargs)
        return self._stream_run(specs, self._generation_config(kw), seed=seed,
                                context_codes=context, context_lens=context_lens)
