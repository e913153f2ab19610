"""Talker generation: batched frame-by-frame decode (counterpart of
`qwen3_tts_tpu/runtime/generate.py`).

  init_decode_state: prefill -> sample the first code0
  frame_step:        sub-talker -> frame embedding sum -> dual-track text
                     merge -> talker step -> sample the next code0
  generate_frames:   a Python loop over frame_step (the JAX while_loop)
  decode_chunk:      K frames of frame_step (the streaming granule)
  generate_frames_chunked: the same loop, attending a length bucket of the
                     KV buffer per chunk of frames

Reference semantics, as in the JAX package: frames are recorded for every
talker forward whose input is a sampled code0 (max_new_tokens M yields at
most M-1 frames); generation stops at codebook-0 EOS per row; the
repetition penalty sees only previously generated code0 ids; the top-1024
control ids except EOS are suppressed; min_new_tokens bans EOS for the first
samples; the dual-track merge adds the trailing text hidden until it runs
out, then the tts_pad embedding.

Sampling noise comes from one `torch.Generator` on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import TalkerConfig
from ..models.talker import (KVCache, StackDims, code_predictor_frame_dispatch,
                             talker_decode_step, talker_prefill)
from ..ops.cuda.talker_step import KV_CHUNK, talker_step_fused_cache
from ..ops.sampling import SamplingParams, process_and_sample_rows

Params = Dict[str, Any]

# the chunked generator attends a KV window rounded up to this bucket
ATTEND_BUCKET = 256


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 2048
    min_new_tokens: int = 2
    sampling: SamplingParams = field(default_factory=SamplingParams)
    subtalker: SamplingParams = field(default_factory=SamplingParams)
    # route the 15-step sub-talker through the fused W8A8 kernel
    # (ops/cuda/subtalker.py; int8 params only)
    fused_subtalker: bool = False
    # store the talker KV cache as per-(slot, head) symmetric int8 with f32
    # scales (half the bytes the decode attention reads)
    kv_quant: bool = False
    # route the talker decode step through the fused W8A8 kernel
    # (ops/cuda/talker_step.py; int8 params; a bf16 or, with kv_quant, an
    # int8 KV cache, its length rounded up to a multiple of 128 slots)
    fused_talker_step: bool = False

    def sampling_rows(self):
        """(talker_row, subtalker_row) in SamplingParams.as_row layout."""
        return self.sampling.as_row(), self.subtalker.as_row()


def suppress_mask_for(cfg: TalkerConfig, device="cpu") -> torch.Tensor:
    """(V,) bool: ids [V-1024, V) are suppressed, except codec EOS."""
    ids = torch.arange(cfg.vocab_size, device=device)
    return (ids >= cfg.vocab_size - 1024) & (ids != cfg.codec_eos_token_id)


class DecodeConst(NamedTuple):
    """Loop-invariant tensors of one generate call."""

    trailing_text: torch.Tensor   # (B, Tt, H) pad-filled projected text hiddens
    tts_pad_embed: torch.Tensor   # (1, 1, H)
    valid_prefill: torch.Tensor   # (B, S) bool prefill attention validity
    seq_lens: torch.Tensor        # (B,) real prefill length (rope base position)
    prefill_len: int              # T, the first decode cache slot
    samp_row: torch.Tensor        # (5,) talker sampling row
    sub_row: torch.Tensor         # (5,) sub-talker sampling row
    suppress: torch.Tensor        # (V,) bool


@dataclass
class DecodeState:
    cache: KVCache
    code0: torch.Tensor         # (B,) next frame's codebook-0 id
    last_hidden: torch.Tensor   # (B, 1, H)
    presence: torch.Tensor      # (B, V) bool generated-id history
    done: torch.Tensor          # (B,) bool
    lengths: torch.Tensor       # (B,) frames recorded
    t: int                      # frame counter


class GenerationResult(NamedTuple):
    codes: torch.Tensor    # (B, max_frames, Q) int32
    lengths: torch.Tensor  # (B,) valid frame count per sample


def _sample_code0(logits, gen_cfg: GenerationConfig, cfg: TalkerConfig,
                  const: DecodeConst, presence, ban, generator):
    B = logits.shape[0]
    return process_and_sample_rows(
        logits, const.samp_row[None, :].expand(B, 5), gen_cfg.sampling.top_k,
        presence=presence, suppress_mask=const.suppress, ban_eos=ban,
        eos_id=cfg.codec_eos_token_id,
        all_greedy=not gen_cfg.sampling.do_sample, generator=generator)


def kv_capacity(gen_cfg: GenerationConfig, T: int) -> int:
    """KV slots for a prefill of T tokens (the fused step wants whole
    128-slot chunks)."""
    S = T + gen_cfg.max_new_tokens + 1
    if gen_cfg.fused_talker_step:
        S = -(-S // KV_CHUNK) * KV_CHUNK
    return S


def attend_bucket_for(needed: int, S: int, bucket: int = ATTEND_BUCKET) -> int:
    """The attended KV window: `needed` slots rounded up to the bucket, at
    most the buffer S."""
    return min(S, -(-needed // bucket) * bucket)


def init_decode_state(params: Params, cfg: TalkerConfig,
                      gen_cfg: GenerationConfig, inputs_embeds: torch.Tensor,
                      attn_mask: torch.Tensor, trailing_text: torch.Tensor,
                      tts_pad_embed: torch.Tensor, generator: torch.Generator,
                      max_len: int):
    """Prefill and sample the first code0. `max_len` is the KV capacity S.
    Returns (DecodeState, DecodeConst)."""
    B, T, _ = inputs_embeds.shape
    dims = StackDims.from_talker(cfg)
    dev, dtype = inputs_embeds.device, inputs_embeds.dtype
    cache = KVCache.zeros(cfg.num_hidden_layers, B, max_len, dims.kv_heads,
                          dims.head_dim, dtype=dtype, device=dev,
                          quantized=gen_cfg.kv_quant)
    logits, hidden_seq, cache = talker_prefill(params, cfg, inputs_embeds,
                                               attn_mask, cache)
    samp_row, sub_row = gen_cfg.sampling_rows()
    valid_prefill = torch.zeros((B, max_len), dtype=torch.bool, device=dev)
    valid_prefill[:, :T] = attn_mask.to(torch.bool)
    const = DecodeConst(
        trailing_text=trailing_text, tts_pad_embed=tts_pad_embed.to(dtype),
        valid_prefill=valid_prefill,
        seq_lens=attn_mask.sum(dim=-1).to(torch.int32),
        prefill_len=T,
        samp_row=torch.as_tensor(samp_row, device=dev),
        sub_row=torch.as_tensor(sub_row, device=dev),
        suppress=suppress_mask_for(cfg, dev))
    presence = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
    ban = torch.full((B,), 0 < gen_cfg.min_new_tokens, device=dev)
    code0 = _sample_code0(logits, gen_cfg, cfg, const, presence, ban, generator)
    state = DecodeState(
        cache=cache, code0=code0, last_hidden=hidden_seq[:, -1:, :],
        presence=presence, done=torch.zeros((B,), dtype=torch.bool, device=dev),
        lengths=torch.zeros((B,), dtype=torch.int32, device=dev), t=0)
    return state, const


def frame_step(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
               const: DecodeConst, state: DecodeState,
               generator: torch.Generator, attend_len: Optional[int] = None):
    """One frame, in place on `state` (its cache is written in place).
    Returns (state, frame (B, Q) int32, active (B,) bool: whether the frame
    is valid output)."""
    eos = cfg.codec_eos_token_id
    B = state.code0.shape[0]
    dev = state.code0.device
    S = state.cache.k.shape[3]
    dtype = state.last_hidden.dtype

    now_done = state.done | (state.code0 == eos)
    presence = state.presence.clone()
    presence[torch.arange(B, device=dev), state.code0.long()] = True

    code0_embed = params["codec_embedding"][state.code0.long()][:, None, :].to(dtype)
    sub_rows = (const.sub_row[None, :].expand(B, 5)
                if gen_cfg.subtalker.do_sample else None)
    sub_codes, sub_emb_sum = code_predictor_frame_dispatch(
        params, cfg, state.last_hidden, code0_embed, gen_cfg.subtalker,
        fused=gen_cfg.fused_subtalker, rows=sub_rows,
        rows_top_k=gen_cfg.subtalker.top_k, generator=generator)
    frame = torch.cat([state.code0[:, None], sub_codes.to(torch.int32)], dim=1)
    active = ~now_done

    # dual-track merge (reference 1682-1692)
    Tt = const.trailing_text.shape[1]
    text_h = (const.trailing_text[:, state.t:state.t + 1] if state.t < Tt
              else const.tts_pad_embed.expand(B, 1, -1))
    embed = code0_embed + sub_emb_sum + text_h.to(dtype)

    cache_index = const.prefill_len + state.t
    slot = torch.arange(S, device=dev)[None, :]
    kv_valid = const.valid_prefill | ((slot >= const.prefill_len) & (slot <= cache_index))
    position = const.seq_lens + state.t
    if gen_cfg.fused_talker_step:
        cache = state.cache
        logits, last_hidden = talker_step_fused_cache(
            params, cfg, embed, position, cache_index, kv_valid, cache.k, cache.v,
            attend_len=attend_len, k_scale=cache.k_scale, v_scale=cache.v_scale)[:2]
    else:
        logits, last_hidden, _ = talker_decode_step(
            params, cfg, embed, position, cache_index, kv_valid, state.cache,
            attend_len=attend_len)

    ban = torch.full((B,), state.t + 1 < gen_cfg.min_new_tokens, device=dev)
    state.code0 = _sample_code0(logits, gen_cfg, cfg, const, presence, ban, generator)
    state.last_hidden = last_hidden
    state.presence = presence
    state.done = now_done
    state.lengths = state.lengths + active.to(torch.int32)
    state.t += 1
    return state, frame, active


def decode_chunk(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                 const: DecodeConst, state: DecodeState, num_frames: int,
                 generator: torch.Generator, attend_len: Optional[int] = None):
    """`num_frames` frame steps (the streaming granule), attending the first
    `attend_len` KV slots. Returns (state, frames (B, K, Q), active (B, K));
    steps past a row's EOS give inactive frames."""
    frames, actives = [], []
    for _ in range(num_frames):
        state, frame, active = frame_step(params, cfg, gen_cfg, const, state,
                                          generator, attend_len=attend_len)
        frames.append(frame)
        actives.append(active)
    return state, torch.stack(frames, dim=1), torch.stack(actives, dim=1)


def _finish(frames, actives, max_frames: int) -> GenerationResult:
    codes = torch.stack(frames, dim=1)          # (B, n, Q)
    active = torch.stack(actives, dim=1)        # (B, n)
    codes = torch.where(active[..., None], codes, torch.zeros_like(codes))
    lengths = active.sum(dim=1).to(torch.int32)
    pad = max_frames - codes.shape[1]
    if pad > 0:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    return GenerationResult(codes, lengths)


def generate_frames(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                    inputs_embeds: torch.Tensor, attn_mask: torch.Tensor,
                    trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
                    generator: torch.Generator) -> GenerationResult:
    """Full batch generation. inputs_embeds: (B, T, H) left-padded prefill;
    attn_mask: (B, T) 1 = real token; trailing_text: (B, Tt, H) pad-filled;
    tts_pad_embed: (1, 1, H). Stops once every row hit EOS (one host sync
    per frame to test it)."""
    T = inputs_embeds.shape[1]
    max_frames = gen_cfg.max_new_tokens - 1
    state, const = init_decode_state(params, cfg, gen_cfg, inputs_embeds,
                                     attn_mask, trailing_text, tts_pad_embed,
                                     generator, kv_capacity(gen_cfg, T))
    frames, actives = [], []
    eos = cfg.codec_eos_token_id
    while state.t < max_frames and not bool((state.done | (state.code0 == eos)).all()):
        state, frame, active = frame_step(params, cfg, gen_cfg, const, state,
                                          generator)
        frames.append(frame)
        actives.append(active)
    if not frames:
        B, Q = inputs_embeds.shape[0], cfg.num_code_groups
        z = torch.zeros((B, max_frames, Q), dtype=torch.int32, device=inputs_embeds.device)
        return GenerationResult(z, torch.zeros((B,), dtype=torch.int32, device=z.device))
    return _finish(frames, actives, max_frames)


def generate_frames_chunked(params: Params, cfg: TalkerConfig,
                            gen_cfg: GenerationConfig,
                            inputs_embeds: torch.Tensor, attn_mask: torch.Tensor,
                            trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
                            generator: torch.Generator, chunk: int = 64,
                            attend_bucket: int = ATTEND_BUCKET) -> GenerationResult:
    """Same results as `generate_frames`, but each chunk of frames attends
    only a length bucket of the KV buffer, and the EOS test runs once per
    chunk. Frames after a row's EOS are inactive."""
    T = inputs_embeds.shape[1]
    max_frames = gen_cfg.max_new_tokens - 1
    S = kv_capacity(gen_cfg, T)
    state, const = init_decode_state(params, cfg, gen_cfg, inputs_embeds,
                                     attn_mask, trailing_text, tts_pad_embed,
                                     generator, S)
    frames, actives = [], []
    emitted = 0
    while emitted < max_frames:
        k = min(chunk, max_frames - emitted)
        attend = attend_bucket_for(T + emitted + k + 1, S, attend_bucket)
        state, fr, act = decode_chunk(params, cfg, gen_cfg, const, state, k,
                                      generator, attend_len=attend)
        frames.extend(fr.unbind(1))
        actives.extend(act.unbind(1))
        emitted += k
        if bool(state.done.all()):
            break
    return _finish(frames, actives, max_frames)
