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
from typing import Any, Dict, List, Optional, Sequence, Tuple

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


def _embed_text(params, cfg: TalkerConfig, ids: torch.Tensor) -> torch.Tensor:
    """text ids (n, L) -> projected talker-space embeddings (n, L, H)."""
    return text_project(params, cfg, params["text_embedding"][ids])


def _frame_codec_embed(params, cfg: TalkerConfig, ref_code: torch.Tensor) -> torch.Tensor:
    """Summed per-codebook embeddings of reference frames. ref_code: (n, T,
    Q) -> (n, T, H); codebook 0 reads the talker table, 1..Q-1 the code
    predictor's tables (reference 1984-1989)."""
    cp_tables = params["code_predictor"]["embeddings"]   # (Q-1, V, H)
    out = params["codec_embedding"][ref_code[..., 0]]
    for i in range(1, cfg.num_code_groups):
        out = out + cp_tables[i - 1][ref_code[..., i]]
    return out


def _spec_group_key(spec: PromptSpec):
    """Specs with one key assemble as one group: the same segment lengths
    and layout flags (the JAX package's vmapped group)."""
    return (len(np.asarray(spec.input_id).reshape(-1)),
            -1 if spec.instruct_id is None else len(np.asarray(spec.instruct_id).reshape(-1)),
            -1 if spec.ref_id is None else len(np.asarray(spec.ref_id).reshape(-1)),
            -1 if spec.ref_code is None else np.asarray(spec.ref_code).shape,
            spec.language_id, bool(spec.non_streaming), spec.speaker_embed is not None)


def _assemble_group(params, cfg: TalkerConfig, model_cfg: TTSModelConfig,
                    specs: Sequence[PromptSpec]
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble n same-shape specs (one `_spec_group_key`) together: their
    ids go to the device in one copy, every text segment is embedded and
    projected in one call, every fixed codec id in one gather. Returns
    (input_embeds (n, L, H), trailing_text (n, Tt, H), tts_pad_embed
    (1, 1, H)), each row the prompt of its spec."""
    s0, n = specs[0], len(specs)
    dev = params["codec_embedding"].device

    def stack(name, dtype=np.int64):
        return np.stack([np.asarray(getattr(s, name), dtype) for s in specs])

    input_id = stack("input_id").reshape(n, -1)
    text = {"special": np.tile([[model_cfg.tts_bos_token_id, model_cfg.tts_eos_token_id,
                                 model_cfg.tts_pad_token_id]], (n, 1)),
            "role": input_id[:, :3]}   # "<|im_start|>assistant\n"
    if s0.instruct_id is not None:
        text["instruct"] = stack("instruct_id").reshape(n, -1)
    if s0.ref_code is not None:
        text["icl"] = np.concatenate([stack("ref_id").reshape(n, -1)[:, 3:-2],
                                      input_id[:, 3:-5]], axis=1)
    elif s0.non_streaming:
        text["body"] = input_id[:, 3:-5]
    else:
        text["first"], text["rest"] = input_id[:, 3:4], input_id[:, 4:-5]
    # think/language block (reference 2134-2147), then pad, bos
    if s0.language_id is None:
        think = [cfg.codec_nothink_id, cfg.codec_think_bos_id, cfg.codec_think_eos_id]
    else:
        think = [cfg.codec_think_id, cfg.codec_think_bos_id, int(s0.language_id),
                 cfg.codec_think_eos_id]
    ids = torch.as_tensor(np.concatenate(list(text.values()) + [np.tile(
        think + [cfg.codec_pad_id, cfg.codec_bos_id], (n, 1))], axis=1), device=dev)
    lens = [x.shape[1] for x in text.values()]
    emb = dict(zip(text, torch.split(_embed_text(params, cfg, ids[:, :sum(lens)]), lens, 1)))
    codec = params["codec_embedding"][ids[:1, sum(lens):]]            # (1, m, H)
    codec_emb_0, pad_row, bos_row = codec[:, :-2], codec[:, -2:-1], codec[:, -1:]
    tts_bos, tts_eos, tts_pad = (emb["special"][:, i:i + 1] for i in range(3))

    H = codec.shape[-1]
    if s0.speaker_embed is None:
        codec_embed = torch.cat([codec_emb_0, pad_row, bos_row], dim=1).expand(n, -1, -1)
    else:
        spk = torch.stack([torch.as_tensor(s.speaker_embed).reshape(-1) for s in specs]).to(
            device=dev, dtype=codec.dtype)
        codec_embed = torch.cat([codec_emb_0.expand(n, -1, -1), spk[:, None],
                                 torch.cat([pad_row, bos_row], dim=1).expand(n, -1, -1)],
                                dim=1)
    m = codec_embed.shape[1]
    text_track = torch.cat([tts_pad.expand(n, m - 2, H), tts_bos], dim=1)
    merged = text_track + codec_embed[:, :-1]
    # instruct embeds lead the prefill (reference 2076-2080)
    prompt = torch.cat(([emb["instruct"]] if "instruct" in emb else [])
                       + [emb["role"], merged], dim=1)

    if s0.ref_code is not None:
        # ICL voice-clone block (generate_icl_prompt, reference 1968-2019)
        text_embed = torch.cat([emb["icl"], tts_eos], dim=1)
        ref_code = torch.as_tensor(stack("ref_code"), device=dev)
        codec_icl = torch.cat([bos_row.expand(n, -1, -1),
                               _frame_codec_embed(params, cfg, ref_code)], dim=1)
        t_len, c_len = text_embed.shape[1], codec_icl.shape[1]
        if s0.non_streaming:
            icl = torch.cat([text_embed + pad_row, codec_icl + tts_pad], dim=1)
            trailing = tts_pad
        elif t_len > c_len:
            icl = text_embed[:, :c_len] + codec_icl
            trailing = text_embed[:, c_len:]
        else:
            icl = torch.cat([text_embed, tts_pad.expand(n, c_len - t_len, H)],
                            dim=1) + codec_icl
            trailing = tts_pad
        return torch.cat([prompt, icl], dim=1), trailing, tts_pad[:1]

    if s0.non_streaming:
        # the first text token's position is dropped: the text rides codec_pad
        body = torch.cat([emb["body"], tts_eos], dim=1) + pad_row
        prompt = torch.cat([prompt, body, tts_pad + bos_row], dim=1)
        trailing = tts_pad
    else:
        prompt = torch.cat([prompt, emb["first"] + codec_embed[:, -1:]], dim=1)
        trailing = torch.cat([emb["rest"], tts_eos], dim=1)
    return prompt, trailing, tts_pad[:1]


def build_prompt(params, cfg: TalkerConfig, model_cfg: TTSModelConfig,
                 spec: PromptSpec) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble one sample's prefill. Returns (input_embed (1, L, H),
    trailing_text (1, Tt, H), tts_pad_embed (1, 1, H))."""
    return _assemble_group(params, cfg, model_cfg, [spec])


def _combine(groups, B: int, bucket: int):
    """Left-pad the groups' prompts and right-pad their trailing text into
    batch tensors: `groups` is [(prompt (n, L_g, H), trailing (n, Tt_g, H),
    output rows (n,))] and one pad embedding (1, 1, H) ends the list. One
    copy per group and tensor (the JAX package's `_combine_groups`); the
    mask is built on the host."""
    *groups, tts_pad = groups
    L = -(-max(p.shape[1] for p, _, _ in groups) // bucket) * bucket
    Tt = -(-max(t.shape[1] for _, t, _ in groups) // bucket) * bucket
    H, dtype, dev = tts_pad.shape[-1], groups[0][0].dtype, tts_pad.device
    batch = torch.zeros((B, L, H), dtype=dtype, device=dev)
    trail = tts_pad.to(dtype).expand(B, Tt, H).clone()
    mask = torch.zeros((B, L), dtype=torch.int32)
    for prompt, trailing, rows in groups:
        idx = torch.as_tensor(rows, device=dev)
        batch[:, L - prompt.shape[1]:].index_copy_(0, idx, prompt.to(dtype))
        trail[:, :trailing.shape[1]].index_copy_(0, idx, trailing.to(dtype))
        mask[rows, L - prompt.shape[1]:] = 1
    return batch, mask, trail, tts_pad


def batch_prompts(prompts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                  bucket: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left-pad a list of (prompt, trailing, pad) into batch tensors.

    Returns (inputs_embeds (B, L, H), attn_mask (B, L) int32 on the host,
    trailing (B, Tt, H), tts_pad_embed (1, 1, H)). Trailing hiddens are
    right-padded with the pad embedding; `bucket` rounds L and Tt up (extra
    left padding is masked; extra trailing columns hold the pad embedding,
    which matches the text-exhausted branch of the dual-track merge)."""
    return _combine([(p, t, [i]) for i, (p, t, _) in enumerate(prompts)] + [prompts[0][2]],
                    len(prompts), bucket)


def assemble_prompt_specs(params, cfg: TalkerConfig, model_cfg: TTSModelConfig,
                          specs: Sequence[PromptSpec], bucket: int = 32
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Assemble and batch many specs: the `batch_prompts` tuple, the mask on
    the host (the prefill builds its flash plan from it without reading the
    device). Same-shape specs (`_spec_group_key`) assemble as one group, as
    the JAX package's vmapped program does, and the groups combine in one
    copy each. Not captured: its shapes follow each text's length."""
    groups: Dict[Any, List[int]] = {}
    for i, s in enumerate(specs):
        groups.setdefault(_spec_group_key(s), []).append(i)
    built = []
    for rows in groups.values():
        prompt, trailing, tts_pad = _assemble_group(params, cfg, model_cfg,
                                                    [specs[i] for i in rows])
        built.append((prompt, trailing, rows))
    return _combine(built + [tts_pad], len(specs), bucket)
