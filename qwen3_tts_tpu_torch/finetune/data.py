"""SFT data pipeline (counterpart of `qwen3_tts_tpu/finetune/data.py`):
JSONL dataset and batch collation, numpy on the host.

- `prepare_data`: batch-encode training wavs into 16-codebook codes with
  the port's 12 Hz tokenizer and write JSONL rows (reference
  prepare_data.py:22-68, BATCH_INFER_NUM=32).
- `TTSDataset.collate`: the training prefill layout: two-channel ids
  (text / codec), the think / nothink block at positions 3-7, the speaker
  embedding slot at index 6, codec-0 labels, per-codebook codec_ids, masks
  (reference dataset.py:146-218). `pad_to_multiple` rounds the length up.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from ..config import TTSModelConfig
from ..ops.stft import mel_spectrogram
from ..utils.audio import load_audio, resample

BATCH_INFER_NUM = 32


def prepare_data(input_jsonl: str, output_jsonl: str, tokenizer,
                 batch_size: int = BATCH_INFER_NUM) -> int:
    """Encode each row's `audio` into `audio_codes` (T, Q) and write JSONL.
    Rows need {"audio": path, "text": str, "ref_audio": path, ...}. Returns
    the number of rows written."""
    with open(input_jsonl) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    out_rows: List[Dict[str, Any]] = []
    for start in range(0, len(rows), batch_size):
        chunk = rows[start:start + batch_size]
        enc = tokenizer.encode([load_audio(r["audio"]) for r in chunk])
        for r, codes in zip(chunk, enc.audio_codes):
            r = dict(r)
            r["audio_codes"] = np.asarray(codes).tolist()
            out_rows.append(r)
    with open(output_jsonl, "w") as f:
        for r in out_rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return len(out_rows)


@dataclass
class TTSDataset:
    """JSONL-backed SFT dataset (reference dataset.py:33-218)."""

    data_list: List[Dict[str, Any]]
    tokenize: Callable[[str], np.ndarray]   # text -> 1-D int ids
    config: TTSModelConfig
    num_code_groups: int = 16

    def __len__(self) -> int:
        return len(self.data_list)

    def _build_assistant_text(self, text: str) -> str:
        return f"<|im_start|>assistant\n{text}<|im_end|>\n<|im_start|>assistant\n"

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        item = self.data_list[idx]
        text_ids = np.asarray(self.tokenize(
            self._build_assistant_text(item["text"]))).reshape(-1)
        audio_codes = np.asarray(item["audio_codes"], dtype=np.int64)
        # single-speaker SFT reuses one ref_audio for every row: keep the
        # last file's mel instead of reading and transforming it each step
        if getattr(self, "_mel_cache_key", None) == item["ref_audio"]:
            mel = self._mel_cache_val
        else:
            wav, sr = load_audio(item["ref_audio"])
            if sr != 24000:
                wav = resample(wav, sr, 24000)
            mel = mel_spectrogram(torch.as_tensor(np.asarray(wav, np.float32)[None]),
                                  n_fft=1024,
                                  num_mels=self.config.speaker_encoder_config.mel_dim,
                                  sampling_rate=24000, hop_size=256, win_size=1024,
                                  fmin=0, fmax=12000).numpy()
            self._mel_cache_key = item["ref_audio"]
            self._mel_cache_val = mel
        return {
            "text_ids": text_ids[:-5][None, :],   # (1, t)
            "audio_codes": audio_codes,           # (t, Q)
            "ref_mel": np.transpose(mel, (0, 2, 1)),
        }

    def collate(self, batch: Sequence[Dict[str, np.ndarray]],
                pad_to_multiple: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.config
        tc = cfg.talker_config
        Q = self.num_code_groups

        item_length = [b["text_ids"].shape[1] + b["audio_codes"].shape[0] for b in batch]
        max_length = max(item_length) + 8
        if pad_to_multiple > 1:
            max_length = -(-max_length // pad_to_multiple) * pad_to_multiple
        b, t = len(batch), max_length

        input_ids = np.zeros((b, t, 2), np.int64)
        codec_ids = np.zeros((b, t, Q), np.int64)
        text_mask = np.zeros((b, t), bool)
        codec_mask_emb = np.zeros((b, t), bool)
        codec_mask = np.zeros((b, t), bool)
        attention_mask = np.zeros((b, t), np.int64)
        codec_0_labels = np.full((b, t), -100, np.int64)

        for i, data in enumerate(batch):
            text_ids = data["text_ids"]
            codes = data["audio_codes"]
            tl = text_ids.shape[1]
            cl = codes.shape[0]

            # text channel (reference dataset.py:167-175)
            input_ids[i, :3, 0] = text_ids[0, :3]
            input_ids[i, 3:7, 0] = cfg.tts_pad_token_id
            input_ids[i, 7, 0] = cfg.tts_bos_token_id
            input_ids[i, 8:8 + tl - 3, 0] = text_ids[0, 3:]
            input_ids[i, 8 + tl - 3, 0] = cfg.tts_eos_token_id
            input_ids[i, 8 + tl - 2:8 + tl + cl, 0] = cfg.tts_pad_token_id
            text_mask[i, :8 + tl + cl] = True

            # codec channel (reference dataset.py:177-201)
            input_ids[i, 3:8, 1] = [tc.codec_nothink_id, tc.codec_think_bos_id,
                                    tc.codec_think_eos_id, 0, tc.codec_pad_id]
            input_ids[i, 8:8 + tl - 2, 1] = tc.codec_pad_id
            input_ids[i, 8 + tl - 2, 1] = tc.codec_bos_id
            input_ids[i, 8 + tl - 1:8 + tl - 1 + cl, 1] = codes[:, 0]
            input_ids[i, 8 + tl - 1 + cl, 1] = tc.codec_eos_token_id

            codec_0_labels[i, 8 + tl - 1:8 + tl - 1 + cl] = codes[:, 0]
            codec_0_labels[i, 8 + tl - 1 + cl] = tc.codec_eos_token_id

            codec_ids[i, 8 + tl - 1:8 + tl - 1 + cl, :] = codes
            codec_mask_emb[i, 3:8 + tl + cl] = True
            codec_mask_emb[i, 6] = False   # the speaker embedding slot
            codec_mask[i, 8 + tl - 1:8 + tl - 1 + cl] = True
            attention_mask[i, :8 + tl + cl] = True

        mel_lens = {d["ref_mel"].shape[1] for d in batch}
        if len(mel_lens) > 1:
            # the reference collate's torch.cat fails here too (dataset.py:206-207)
            raise ValueError(
                "all reference audios in a batch must have equal duration "
                f"(got mel lengths {sorted(mel_lens)}); single-speaker SFT "
                "should reuse one ref_audio")
        return {
            "input_ids": input_ids,
            "ref_mels": np.concatenate([d["ref_mel"] for d in batch], axis=0),
            "attention_mask": attention_mask,
            "text_embedding_mask": text_mask[..., None],
            "codec_embedding_mask": codec_mask_emb[..., None],
            "codec_0_labels": codec_0_labels,
            "codec_ids": codec_ids,
            "codec_mask": codec_mask,
        }
