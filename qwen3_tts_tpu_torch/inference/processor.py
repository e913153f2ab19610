"""Qwen3TTSProcessor, the text tokenization wrapper (counterpart of
`qwen3_tts_tpu/inference/processor.py`).

Mirrors the reference processor surface (a thin wrapper over
Qwen2TokenizerFast with left padding), built on `transformers.AutoTokenizer`
loaded from the checkpoint directory. `transformers` is imported inside
`from_pretrained` only: the port runs without it, given a tokenizer.
"""

from __future__ import annotations

from typing import List, Optional, Union


class Qwen3TTSProcessor:
    def __init__(self, tokenizer, chat_template: Optional[str] = None):
        self.tokenizer = tokenizer
        self.chat_template = chat_template

    @classmethod
    def from_pretrained(cls, model_dir: str, **kwargs) -> "Qwen3TTSProcessor":
        from transformers import AutoTokenizer

        return cls(AutoTokenizer.from_pretrained(model_dir, **kwargs))

    def __call__(self, text: Union[str, List[str]] = None, **kwargs):
        if text is None:
            raise ValueError("You need to specify either a `text` input to process.")
        if not isinstance(text, list):
            text = [text]
        kwargs.setdefault("padding", False)
        kwargs.setdefault("padding_side", "left")
        kwargs.setdefault("return_tensors", "np")
        return self.tokenizer(text, **kwargs)

    def batch_decode(self, *args, **kwargs):
        return self.tokenizer.batch_decode(*args, **kwargs)

    def decode(self, *args, **kwargs):
        return self.tokenizer.decode(*args, **kwargs)

    def apply_chat_template(self, conversations, chat_template=None, **kwargs):
        if isinstance(conversations[0], dict):
            conversations = [conversations]
        # by keyword: positionally the template would bind to HF's `tools`
        return self.tokenizer.apply_chat_template(
            conversations, chat_template=chat_template, **kwargs)

    @property
    def model_input_names(self):
        return list(dict.fromkeys(self.tokenizer.model_input_names))
