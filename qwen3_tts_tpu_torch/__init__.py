"""qwen3_tts_tpu_torch — the PyTorch + CUDA port of qwen3_tts_tpu.

The JAX package `qwen3_tts_tpu` stays the reference; each module here is
held against its counterpart there. The port imports torch and never jax
nor anything of `qwen3_tts_tpu`: it keeps its own copies of the pure-Python
modules it needs (`config.py`, `utils/audio.py`, `utils/flac.py`). Public
API:

    from qwen3_tts_tpu_torch import Qwen3TTSModel, Qwen3TTSTokenizer
"""

__version__ = "0.1.0"

_LAZY = {
    "Qwen3TTSModel": "qwen3_tts_tpu_torch.inference.model",
    "Qwen3TTSTokenizer": "qwen3_tts_tpu_torch.inference.tokenizer",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Qwen3TTSModel", "Qwen3TTSTokenizer", "__version__"]
