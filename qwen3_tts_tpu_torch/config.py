"""Configuration dataclasses of the port (its own copy of
`qwen3_tts_tpu/config.py`, with the same class and field names).

These mirror the semantics of the reference HF `PretrainedConfig` hierarchy
(reference: qwen_tts/core/models/configuration_qwen3_tts.py and
qwen_tts/core/tokenizer_12hz/configuration_qwen3_tts_tokenizer_v2.py) but are
plain frozen dataclasses loadable from the same checkpoint `config.json`
files, so both packages read a checkpoint into equal field values. The 25 Hz
(V1) classes come along so that `load_config` reads every checkpoint kind.
Unknown JSON keys are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


class HashableConfig:
    """Hash/eq by canonical JSON, so configs with dict fields (rope_scaling,
    speaker maps) can key caches and compare by value."""

    def _canonical(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)

    def __hash__(self) -> int:
        return hash(self._canonical())

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._canonical() == other._canonical()


@dataclass(frozen=True, eq=False)
class CodePredictorConfig(HashableConfig):
    """Sub-talker (MTP head) config.

    Reference: configuration_qwen3_tts.py:70-256 (Qwen3TTSTalkerCodePredictorConfig).
    """

    vocab_size: int = 2048
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_bias: bool = False
    use_sliding_window: bool = False
    sliding_window: Optional[int] = None
    num_code_groups: int = 32

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CodePredictorConfig":
        d = dict(d)
        if not d.get("use_sliding_window", False):
            d["sliding_window"] = None
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class TalkerConfig(HashableConfig):
    """Talker decoder LM config.

    Reference: configuration_qwen3_tts.py:259-451 (Qwen3TTSTalkerConfig).
    """

    vocab_size: int = 3072
    hidden_size: int = 1024
    intermediate_size: int = 2048
    num_hidden_layers: int = 20
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // heads
    hidden_act: str = "silu"
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[Dict[str, Any]] = None
    attention_bias: bool = False
    use_sliding_window: bool = False
    sliding_window: Optional[int] = None
    num_code_groups: int = 32
    text_hidden_size: int = 2048
    text_vocab_size: int = 151936
    codec_eos_token_id: int = 4198
    codec_think_id: int = 4202
    codec_nothink_id: int = 4203
    codec_think_bos_id: int = 4204
    codec_think_eos_id: int = 4205
    codec_pad_id: int = 4196
    codec_bos_id: int = 4197
    spk_id: Optional[Dict[str, int]] = None
    spk_is_dialect: Optional[Dict[str, Any]] = None
    codec_language_id: Optional[Dict[str, int]] = None
    code_predictor_config: CodePredictorConfig = field(default_factory=CodePredictorConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def mrope_section(self) -> Optional[List[int]]:
        if self.rope_scaling is None:
            return None
        return self.rope_scaling.get("mrope_section")

    @property
    def mrope_interleaved(self) -> bool:
        if self.rope_scaling is None:
            return False
        return bool(self.rope_scaling.get("interleaved", False))

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TalkerConfig":
        d = dict(d)
        cp = d.get("code_predictor_config") or {}
        if isinstance(cp, dict):
            d["code_predictor_config"] = CodePredictorConfig.from_dict(cp)
        if not d.get("use_sliding_window", False):
            d["sliding_window"] = None
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class SpeakerEncoderConfig(HashableConfig):
    """ECAPA-TDNN speaker encoder config.

    Reference: configuration_qwen3_tts.py:22-67 (Qwen3TTSSpeakerEncoderConfig).
    """

    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: Tuple[int, ...] = (512, 512, 512, 512, 1536)
    enc_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SpeakerEncoderConfig":
        d = dict(d)
        for k in ("enc_channels", "enc_kernel_sizes", "enc_dilations"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class TTSModelConfig(HashableConfig):
    """Top-level model config (reference: configuration_qwen3_tts.py:454-499)."""

    talker_config: TalkerConfig = field(default_factory=TalkerConfig)
    speaker_encoder_config: SpeakerEncoderConfig = field(default_factory=SpeakerEncoderConfig)
    tokenizer_type: Optional[str] = None
    tts_model_size: Optional[str] = None
    tts_model_type: Optional[str] = None
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    tts_pad_token_id: int = 151671
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TTSModelConfig":
        d = dict(d)
        tc = d.get("talker_config") or {}
        if isinstance(tc, dict):
            d["talker_config"] = TalkerConfig.from_dict(tc)
        sec = d.get("speaker_encoder_config") or {}
        if isinstance(sec, dict):
            d["speaker_encoder_config"] = SpeakerEncoderConfig.from_dict(sec)
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str) -> "TTSModelConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Codec V2 (12 Hz tokenizer)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class MimiEncoderConfig(HashableConfig):
    """Mimi (SEANet + transformer + split-RVQ) encoder config.

    Mirrors the fields of `transformers.MimiConfig` that the encoder uses.
    Reference: HF transformers models/mimi/configuration_mimi.py defaults.
    """

    sampling_rate: int = 24000
    frame_rate: float = 12.5
    audio_channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "constant"
    compress: int = 2
    use_conv_shortcut: bool = False
    # transformer
    num_hidden_layers: int = 8
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None
    intermediate_size: int = 2048
    hidden_act: str = "gelu"
    norm_eps: float = 1e-5
    max_position_embeddings: int = 8000
    rope_theta: float = 10000.0
    sliding_window: int = 250
    attention_bias: bool = False
    layer_scale_initial_scale: float = 0.01
    # quantizer
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    vector_quantization_hidden_dimension: int = 256
    upsample_groups: int = 512

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def encodec_frame_rate(self) -> float:
        import math

        return self.sampling_rate / math.prod(self.upsampling_ratios)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MimiEncoderConfig":
        d = dict(d)
        if "upsampling_ratios" in d and isinstance(d["upsampling_ratios"], list):
            d["upsampling_ratios"] = tuple(d["upsampling_ratios"])
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class CodecV2DecoderConfig(HashableConfig):
    """12 Hz codec decoder / vocoder config.

    Reference: configuration_qwen3_tts_tokenizer_v2.py:26-121.
    """

    codebook_size: int = 2048
    codebook_dim: int = 512
    hidden_size: int = 1024
    latent_dim: int = 1024
    max_position_embeddings: int = 8000
    rope_theta: float = 10000.0
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    attention_bias: bool = False
    sliding_window: int = 72
    intermediate_size: int = 3072
    hidden_act: str = "silu"
    layer_scale_initial_scale: float = 0.01
    rms_norm_eps: float = 1e-5
    num_hidden_layers: int = 8
    num_quantizers: int = 16
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    decoder_dim: int = 1536

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        import math

        return math.prod(self.upsample_rates) * math.prod(self.upsampling_ratios)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CodecV2DecoderConfig":
        d = dict(d)
        for k in ("upsample_rates", "upsampling_ratios"):
            if k in d and isinstance(d[k], list):
                d[k] = tuple(d[k])
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class CodecV2Config(HashableConfig):
    """12 Hz tokenizer top config (reference: configuration...v2.py:124-169)."""

    encoder_config: MimiEncoderConfig = field(default_factory=MimiEncoderConfig)
    decoder_config: CodecV2DecoderConfig = field(default_factory=CodecV2DecoderConfig)
    encoder_valid_num_quantizers: int = 16
    input_sample_rate: int = 24000
    output_sample_rate: int = 24000
    decode_upsample_rate: int = 1920
    encode_downsample_rate: int = 1920
    model_type: str = "qwen3_tts_tokenizer_12hz"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CodecV2Config":
        d = dict(d)
        ec = d.get("encoder_config") or {}
        if isinstance(ec, dict):
            d["encoder_config"] = MimiEncoderConfig.from_dict(ec)
        dc = d.get("decoder_config") or {}
        if isinstance(dc, dict):
            d["decoder_config"] = CodecV2DecoderConfig.from_dict(dc)
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str) -> "CodecV2Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


# ---------------------------------------------------------------------------
# Codec V1 (25 Hz tokenizer)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class DiTConfig(HashableConfig):
    """DiT flow-matching mel decoder config.

    Reference: configuration_qwen3_tts_tokenizer_v1.py:24-121.
    """

    hidden_size: int = 1024
    num_hidden_layers: int = 22
    num_attention_heads: int = 16
    ff_mult: int = 2
    emb_dim: int = 512
    head_dim: int = 64
    rope_theta: float = 10000.0
    block_size: int = 24
    look_ahead_layers: Tuple[int, ...] = (10,)
    look_backward_layers: Tuple[int, ...] = (0, 20)
    repeats: int = 2
    num_embeds: int = 8193
    mel_dim: int = 80
    enc_emb_dim: int = 192
    enc_dim: int = 128
    enc_channels: Tuple[int, ...] = (256, 256, 256, 256, 768)
    enc_kernel_sizes: Tuple[int, ...] = (5, 3, 3, 3, 1)
    enc_dilations: Tuple[int, ...] = (1, 2, 3, 4, 1)
    enc_attention_channels: int = 64
    enc_res2net_scale: int = 2
    enc_se_channels: int = 64

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiTConfig":
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class BigVGANConfig(HashableConfig):
    """BigVGAN vocoder config (reference: configuration...v1.py:124-162)."""

    mel_dim: int = 80
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    upsample_rates: Tuple[int, ...] = (5, 3, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 7, 4, 4, 4, 4)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BigVGANConfig":
        d = dict(d)
        for k in ("resblock_kernel_sizes", "upsample_rates",
                  "upsample_kernel_sizes"):
            if isinstance(d.get(k), list):
                d[k] = tuple(d[k])
        if isinstance(d.get("resblock_dilation_sizes"), list):
            d["resblock_dilation_sizes"] = tuple(
                tuple(x) for x in d["resblock_dilation_sizes"])
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class WhisperVQEncoderConfig(HashableConfig):
    """Whisper-VQ encoder config (reference: configuration...v1.py:195-277)."""

    n_mels: int = 128
    n_ctx: int = 1500
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 32
    n_window: int = 100
    output_dim: int = 3584
    audio_vq_type: str = "GRVQ"
    audio_vq_layers: int = 6
    audio_vq_codebook_size: int = 32768
    audio_vq_codebook_dim: int = 1280
    audio_vq_pe: bool = True
    audio_vq_ds_rate: int = 2

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WhisperVQEncoderConfig":
        return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True, eq=False)
class CodecV1Config(HashableConfig):
    """25 Hz tokenizer top config (reference: configuration...v1.py:280-324)."""

    encoder_config: WhisperVQEncoderConfig = field(default_factory=WhisperVQEncoderConfig)
    dit_config: DiTConfig = field(default_factory=DiTConfig)
    bigvgan_config: BigVGANConfig = field(default_factory=BigVGANConfig)
    input_sample_rate: int = 24000
    output_sample_rate: int = 24000
    decode_upsample_rate: int = 1920
    encode_downsample_rate: int = 1920
    model_type: str = "qwen3_tts_tokenizer_25hz"

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CodecV1Config":
        d = dict(d)
        ec = d.get("encoder_config") or {}
        if isinstance(ec, dict):
            d["encoder_config"] = WhisperVQEncoderConfig.from_dict(ec)
        dc = d.get("decoder_config") or {}
        if isinstance(dc, dict):
            d["dit_config"] = DiTConfig.from_dict(dc.get("dit_config") or {})
            d["bigvgan_config"] = BigVGANConfig.from_dict(
                dc.get("bigvgan_config") or {})
        d.pop("decoder_config", None)
        return cls(**_filter_kwargs(cls, d))

    @classmethod
    def from_json(cls, path: str) -> "CodecV1Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


def load_config(model_dir: str):
    """Load a checkpoint directory's config.json and dispatch on model_type."""
    path = os.path.join(model_dir, "config.json")
    with open(path, "r", encoding="utf-8") as f:
        d = json.load(f)
    mt = d.get("model_type", "")
    if mt == "qwen3_tts_tokenizer_12hz":
        return CodecV2Config.from_dict(d)
    if mt == "qwen3_tts_tokenizer_25hz":
        return CodecV1Config.from_dict(d)
    return TTSModelConfig.from_dict(d)
