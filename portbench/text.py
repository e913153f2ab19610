"""The benchmark's text tokenizer: one id per word, no cap.

The traffic writes its texts as words `w<id>` (an id of the 151,643 ordinary
Qwen2 text ids); the chat template's pieces map to their Qwen2 ids, so the
program's prompt layout (three role ids first, five template ids last) holds.
Both sides read the same ids: the program through this object as its text
processor, the reference through `assistant_ids`.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import numpy as np

SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645, "assistant": 77091, "\n": 198}
ORDINARY_IDS = 151643
_PIECE = re.compile(r"<\|im_start\|>|<\|im_end\|>|assistant|\n|w\d+| +")


def words_text(ids: Sequence[int]) -> str:
    return " ".join(f"w{int(i)}" for i in ids)


def encode(text: str) -> List[int]:
    ids, pos = [], 0
    for m in _PIECE.finditer(text):
        if m.start() != pos:
            raise ValueError(f"text piece {text[pos:m.start()]!r} is not a benchmark word")
        pos = m.end()
        piece = m.group()
        if piece in SPECIAL:
            ids.append(SPECIAL[piece])
        elif piece.startswith("w"):
            i = int(piece[1:])
            if not 0 <= i < ORDINARY_IDS:
                raise ValueError(f"word {piece!r} is outside the ordinary ids")
            ids.append(i)
    if pos != len(text):
        raise ValueError(f"text piece {text[pos:]!r} is not a benchmark word")
    return ids


class WordTokenizer:
    """The program's text processor: `tok(text, return_tensors="np")`."""

    def __call__(self, text, return_tensors=None, **kw):
        return {"input_ids": np.asarray([encode(text)], dtype=np.int64)}


def assistant_ids(words: Sequence[int]) -> List[int]:
    """The ids of the program's assistant template around `words`."""
    return encode(f"<|im_start|>assistant\n{words_text(words)}<|im_end|>\n"
                  f"<|im_start|>assistant\n")


def ref_ids(words: Sequence[int]) -> List[int]:
    """The ids of the program's reference-text template around `words` (a
    voice clone's transcript of its reference clip)."""
    return encode(f"<|im_start|>assistant\n{words_text(words)}<|im_end|>\n")
