"""Dual-track streaming synthesis: talker chunks interleaved with chunked
vocoding (counterpart of `qwen3_tts_tpu/runtime/streaming.py`).

  host loop: [talker chunk of K frames] -> [vocoder over the new frames with
             left context] -> emit a packet -> next chunk

- Talker chunks are `decode_chunk` (runtime/generate.py) over one
  resumable decode state; a warm-up schedule (1, 2, 4, 8, 16 frames) keeps
  the first packet early, then chunks of 25 frames amortize the vocoder
  calls. Each chunk attends the KV window its last frame needs, rounded up
  to a multiple of 256 slots. On a CUDA device each chunk is one replay of
  the captured graph of (chunk frames, attend bucket) (runtime/graphs.py).
- The vocoder re-decodes up to 25 frames of left context per chunk, the
  reference's chunked-decode approximation at streaming granularity, with
  PER-ROW context so a batch mixing voice-clone rows (reference codes as
  context) and context-free rows keeps each row's own. On a CUDA device a
  packet's vocoder is one graph replay per (B, k, context cap): the
  schedule meets a handful of shapes.
- The code history stays on the model's device; one device-to-host copy
  per packet carries its audio.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from ..config import CodecV2DecoderConfig, TalkerConfig
from ..models.codec12.decoder import vocode_rows
from .generate import (GenerationConfig, attend_bucket_for, decode_chunk,
                       init_decode_state, kv_capacity)

Params = Dict[str, Any]


@dataclass(frozen=True)
class StreamingConfig:
    warmup_schedule: Tuple[int, ...] = (1, 2, 4, 8, 16)
    steady_chunk: int = 25
    vocoder_left_context: int = 25


@dataclass
class StreamPacket:
    """One emitted audio chunk."""

    wav: np.ndarray            # (B, samples) float32
    frame_start: int           # first frame index covered
    frame_count: int           # frames covered
    active_frames: np.ndarray  # (B,) valid frames within this packet
    latency_s: float           # wall time since session start


def _vocode_slice(p: Params, cfg: CodecV2DecoderConfig, codes_buf: torch.Tensor,
                  ctx_lens: torch.Tensor, emit_start: int, k: int,
                  ctx_cap: int) -> torch.Tensor:
    """Decode the next `k` frames of every row with per-row left context.

    codes_buf: (B, Q, T) code history; row b's usable history is
    [emit_start - ctx_lens[b], emit_start + k). Each row is gathered
    left-aligned as [c_b context | k new | tail], the batch is vocoded in
    one call (width ctx_cap + k; the vocoder is causal, so the tail never
    reaches the emitted samples), and the k frames' samples are cut per row
    at c_b: `vocode_rows`, on a CUDA device one replay of the graph of (B,
    ctx_cap + k, k), which the rows and their contexts enter as device
    tensors. Returns (B, k * upsample)."""
    B, Q, T = codes_buf.shape
    dev = codes_buf.device
    c = torch.clamp(ctx_lens.to(device=dev, dtype=torch.long), max=ctx_cap)
    idx = torch.clamp((emit_start - c)[:, None] + torch.arange(ctx_cap + k, device=dev),
                      0, T - 1)
    chunk = torch.gather(codes_buf, 2, idx[:, None, :].expand(B, Q, -1))
    return vocode_rows(p, cfg, chunk.to(torch.int32), c.to(torch.int32), k)


class StreamingSession:
    """One batched streaming synthesis run."""

    def __init__(self, talker_params: Params, talker_cfg: TalkerConfig,
                 gen_cfg: GenerationConfig, vocoder_params: Params,
                 vocoder_cfg: CodecV2DecoderConfig,
                 stream_cfg: StreamingConfig = StreamingConfig()):
        self.talker_params = talker_params
        self.talker_cfg = talker_cfg
        self.gen_cfg = gen_cfg
        self.vocoder_params = vocoder_params
        self.vocoder_cfg = vocoder_cfg
        self.stream_cfg = stream_cfg

    def _chunk_schedule(self, max_frames: int) -> Iterator[int]:
        emitted = 0
        for k in self.stream_cfg.warmup_schedule:
            k = min(k, max_frames - emitted)
            if k <= 0:
                return
            yield k
            emitted += k
        while emitted < max_frames:
            k = min(self.stream_cfg.steady_chunk, max_frames - emitted)
            yield k
            emitted += k

    def run(self, inputs_embeds: torch.Tensor, attn_mask: torch.Tensor,
            trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
            generator: torch.Generator, context_codes=None,
            context_lens=None) -> Iterator[StreamPacket]:
        """Generate and yield audio packets as they become available.

        `context_codes` (B, Q, T0): codec frames that precede the generated
        ones (a voice-clone reference), used as vocoder left context only;
        `context_lens` (B,): each row's valid context, right-aligned in
        context_codes (0: the row runs context-free)."""
        cfg, gen_cfg = self.talker_cfg, self.gen_cfg
        B, T, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        max_frames = gen_cfg.max_new_tokens - 1
        S = kv_capacity(gen_cfg, T)
        Q = cfg.num_code_groups

        t_start = time.time()
        state, const = init_decode_state(
            self.talker_params, cfg, gen_cfg, inputs_embeds, attn_mask,
            trailing_text, tts_pad_embed, generator, S)
        T0 = 0 if context_codes is None else context_codes.shape[-1]
        codes_buf = torch.zeros((B, Q, T0 + max_frames), dtype=torch.long, device=dev)
        if T0:
            codes_buf[:, :, :T0] = torch.as_tensor(np.asarray(context_codes), device=dev)
        ctx_lens0 = (torch.full((B,), T0, dtype=torch.long) if context_lens is None
                     else torch.as_tensor(np.asarray(context_lens), dtype=torch.long))
        emitted = 0    # generated frames emitted (context excluded)
        for k in self._chunk_schedule(max_frames):
            attend = attend_bucket_for(T + emitted + k + 1, S)
            state, frames, active = decode_chunk(
                self.talker_params, cfg, gen_cfg, const, state, k, generator,
                attend_len=attend)
            # post-EOS frames are zeroed (as generate_frames masks them), so
            # the vocoder never sees sampled control-range ids
            frames = frames * active[..., None].to(frames.dtype)
            codes_buf[:, :, T0 + emitted:T0 + emitted + k] = frames.transpose(1, 2)
            wav = _vocode_slice(self.vocoder_params, self.vocoder_cfg, codes_buf,
                                ctx_lens0 + emitted, T0 + emitted, k,
                                min(self.stream_cfg.vocoder_left_context, T0 + emitted))
            wav = wav.float().cpu().numpy()        # one device-to-host copy per packet
            active_np = active.cpu().numpy()
            latency = time.time() - t_start
            yield StreamPacket(wav=wav, frame_start=emitted, frame_count=k,
                               active_frames=active_np.sum(axis=1), latency_s=latency)
            emitted += k
            if bool(state.done.all()):
                break

    def synthesize(self, inputs_embeds, attn_mask, trailing_text, tts_pad_embed,
                   generator, context_codes=None, context_lens=None
                   ) -> Tuple[List[np.ndarray], float]:
        """Run the stream to completion; returns (per-row waveforms trimmed
        to their generated lengths, first-packet latency in seconds)."""
        up = self.vocoder_cfg.total_upsample
        packets = list(self.run(inputs_embeds, attn_mask, trailing_text, tts_pad_embed,
                                generator, context_codes=context_codes,
                                context_lens=context_lens))
        full = np.concatenate([p.wav for p in packets], axis=-1)
        lengths = sum(p.active_frames for p in packets)
        wavs = [full[b, :int(lengths[b]) * up] for b in range(full.shape[0])]
        return wavs, float(packets[0].latency_s)
