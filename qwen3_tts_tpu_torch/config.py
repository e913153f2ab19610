"""Configuration dataclasses, shared with the JAX package.

`qwen3_tts_tpu/config.py` is pure Python (it imports no jax), so the port
reuses it instead of keeping a copy: both packages read a checkpoint's
config.json into the same classes. This module is the port's one import of
it.
"""

from qwen3_tts_tpu.config import (CodecV2Config, CodecV2DecoderConfig,  # noqa: F401
                                  CodePredictorConfig, TalkerConfig,
                                  TTSModelConfig, load_config)
