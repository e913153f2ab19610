"""Prompt / prefill assembly for the talker (counterpart of
`qwen3_tts_tpu/runtime/prompts.py`).

Per-sample prefill layout (reference modeling_qwen3_tts.py:2068-2234 and
generate_icl_prompt 1968-2019):

  [instruct text embeds]                      (optional, projected)
  [<|im_start|>assistant\\n role embeds]      (3 text tokens, projected)
  [tts_pad * (n-2) .. tts_bos] + codec[think block (+speaker) pad]  (summed)
  then one of:
    streaming:      [first text token + codec_bos]; trailing = rest + tts_eos
    non-streaming:  [text.. + tts_eos over codec_pad; tts_pad + codec_bos];
                    trailing = tts_pad
    ICL (clone):    ref text + text (+ tts_eos) against codec_bos + the
                    summed codec embeddings of every reference frame;
                    trailing per stream mode

Batches are left-padded with a mask, as the reference batches them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import TalkerConfig, TTSModelConfig
from ..models.talker import text_project


@dataclass
class PromptSpec:
    """One sample's prompt inputs (token ids are 1-D numpy arrays)."""

    input_id: np.ndarray                          # tokenized assistant text
    language_id: Optional[int] = None             # codec language id or None (auto)
    speaker_embed: Optional[torch.Tensor] = None  # (H,) codec-space speaker vec
    instruct_id: Optional[np.ndarray] = None      # tokenized instruct block
    ref_id: Optional[np.ndarray] = None           # tokenized ref text (ICL)
    ref_code: Optional[np.ndarray] = None         # (T, Q) reference codec codes
    non_streaming: bool = False


def _ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64).reshape(-1), device=device)


def _embed_text(params, cfg: TalkerConfig, ids: torch.Tensor) -> torch.Tensor:
    """text ids -> projected talker-space embeddings (1, L, H)."""
    return text_project(params, cfg, params["text_embedding"][ids][None])


def _embed_codec(params, ids: torch.Tensor) -> torch.Tensor:
    return params["codec_embedding"][ids][None]


def _frame_codec_embed(params, cfg: TalkerConfig, ref_code: torch.Tensor) -> torch.Tensor:
    """Summed per-codebook embeddings of reference frames. ref_code: (T, Q)
    -> (1, T, H); codebook 0 reads the talker table, 1..Q-1 the code
    predictor's tables (reference 1984-1989)."""
    cp_tables = params["code_predictor"]["embeddings"]   # (Q-1, V, H)
    out = params["codec_embedding"][ref_code[:, 0]]
    for i in range(1, cfg.num_code_groups):
        out = out + cp_tables[i - 1][ref_code[:, i]]
    return out[None]


def build_prompt(params, cfg: TalkerConfig, model_cfg: TTSModelConfig,
                 spec: PromptSpec) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble one sample's prefill. Returns (input_embed (1, L, H),
    trailing_text (1, Tt, H), tts_pad_embed (1, 1, H))."""
    dev = params["codec_embedding"].device
    special = _embed_text(params, cfg, _ids(
        [model_cfg.tts_bos_token_id, model_cfg.tts_eos_token_id,
         model_cfg.tts_pad_token_id], dev))
    tts_bos, tts_eos, tts_pad = special[:, 0:1], special[:, 1:2], special[:, 2:3]
    input_id = _ids(spec.input_id, dev)

    parts: List[torch.Tensor] = []
    if spec.instruct_id is not None:
        parts.append(_embed_text(params, cfg, _ids(spec.instruct_id, dev)))

    # think/language block (reference 2134-2147)
    if spec.language_id is None:
        codec_prefill = [cfg.codec_nothink_id, cfg.codec_think_bos_id,
                         cfg.codec_think_eos_id]
    else:
        codec_prefill = [cfg.codec_think_id, cfg.codec_think_bos_id,
                         int(spec.language_id), cfg.codec_think_eos_id]
    codec_emb_0 = _embed_codec(params, _ids(codec_prefill, dev))
    codec_emb_1 = _embed_codec(params, _ids([cfg.codec_pad_id, cfg.codec_bos_id], dev))
    if spec.speaker_embed is None:
        codec_embed = torch.cat([codec_emb_0, codec_emb_1], dim=1)
    else:
        spk = torch.as_tensor(spec.speaker_embed).to(
            device=dev, dtype=codec_emb_0.dtype).reshape(1, 1, -1)
        codec_embed = torch.cat([codec_emb_0, spk, codec_emb_1], dim=1)

    # role: "<|im_start|>assistant\n" (first 3 tokens)
    role_embed = _embed_text(params, cfg, input_id[:3])
    n = codec_embed.shape[1]
    text_track = torch.cat([tts_pad.expand(1, n - 2, tts_pad.shape[-1]), tts_bos],
                           dim=1)
    merged = text_track + codec_embed[:, :-1]
    # instruct embeds lead the prefill (reference 2076-2080)
    prompt = torch.cat(parts + [role_embed, merged], dim=1)

    if spec.ref_code is not None:
        # ICL voice-clone block (generate_icl_prompt, reference 1968-2019)
        ref_id = _ids(spec.ref_id, dev)
        text_embed = torch.cat([_embed_text(params, cfg, torch.cat(
            [ref_id[3:-2], input_id[3:-5]])), tts_eos], dim=1)
        ref_code = torch.as_tensor(np.asarray(spec.ref_code, np.int64), device=dev)
        codec_icl = torch.cat([_embed_codec(params, _ids([cfg.codec_bos_id], dev)),
                               _frame_codec_embed(params, cfg, ref_code)], dim=1)
        t_len, c_len = text_embed.shape[1], codec_icl.shape[1]
        if spec.non_streaming:
            pad_ids = torch.full((t_len,), cfg.codec_pad_id, device=dev)
            icl = torch.cat([text_embed + _embed_codec(params, pad_ids),
                             codec_icl + tts_pad], dim=1)
            trailing = tts_pad
        elif t_len > c_len:
            icl = text_embed[:, :c_len] + codec_icl
            trailing = text_embed[:, c_len:]
        else:
            icl = torch.cat([text_embed, tts_pad.expand(1, c_len - t_len, -1)],
                            dim=1) + codec_icl
            trailing = tts_pad
        return torch.cat([prompt, icl], dim=1), trailing, tts_pad

    first_tok = _embed_text(params, cfg, input_id[3:4]) + codec_embed[:, -1:]
    prompt = torch.cat([prompt, first_tok], dim=1)
    if spec.non_streaming:
        prompt = prompt[:, :-1]
        body = torch.cat([_embed_text(params, cfg, input_id[3:-5]), tts_eos], dim=1)
        pad_ids = torch.full((body.shape[1],), cfg.codec_pad_id, device=dev)
        body = body + _embed_codec(params, pad_ids)
        tail = tts_pad + _embed_codec(params, _ids([cfg.codec_bos_id], dev))
        prompt = torch.cat([prompt, body, tail], dim=1)
        trailing = tts_pad
    else:
        trailing = torch.cat([_embed_text(params, cfg, input_id[4:-5]), tts_eos], dim=1)
    return prompt, trailing, tts_pad


def batch_prompts(prompts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                  bucket: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left-pad a list of (prompt, trailing, pad) into batch tensors.

    Returns (inputs_embeds (B, L, H), attn_mask (B, L) int32, trailing
    (B, Tt, H), tts_pad_embed (1, 1, H)). Trailing hiddens are right-padded
    with the pad embedding; `bucket` rounds L and Tt up (extra left padding
    is masked; extra trailing columns hold the pad embedding, which matches
    the text-exhausted branch of the dual-track merge)."""
    tts_pad = prompts[0][2]
    L = max(p[0].shape[1] for p in prompts)
    Tt = max(p[1].shape[1] for p in prompts)
    L = -(-L // bucket) * bucket
    Tt = -(-Tt // bucket) * bucket
    B, H = len(prompts), tts_pad.shape[-1]
    dtype, dev = prompts[0][0].dtype, tts_pad.device
    batch = torch.zeros((B, L, H), dtype=dtype, device=dev)
    trail = tts_pad.to(dtype).expand(B, Tt, H).clone()
    mask = torch.zeros((B, L), dtype=torch.int32, device=dev)
    for i, (e, t, _) in enumerate(prompts):
        batch[i, L - e.shape[1]:] = e[0].to(dtype)
        trail[i, :t.shape[1]] = t[0].to(dtype)
        mask[i, L - e.shape[1]:] = 1
    return batch, mask, trail, tts_pad


def assemble_prompt_specs(params, cfg: TalkerConfig, model_cfg: TTSModelConfig,
                          specs: Sequence[PromptSpec], bucket: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Assemble and batch many specs: the `batch_prompts` tuple. (The JAX
    package groups same-shape specs into one vmapped program to save
    dispatches; eager torch has nothing to gain from that, so each spec is
    built on its own and the rows are identical.)"""
    return batch_prompts([build_prompt(params, cfg, model_cfg, s) for s in specs],
                         bucket=bucket)
