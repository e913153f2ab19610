"""Talker generation: batched frame-by-frame decode (counterpart of
`qwen3_tts_tpu/runtime/generate.py`).

  init_decode_state: prefill -> sample the first code0
  frame_step:        sub-talker -> frame embedding sum -> dual-track text
                     merge -> talker step -> sample the next code0
  generate_frames:   the frame loop to EOS (the JAX while_loop)
  decode_chunk:      K frames of frame_step (the JAX scan; the streaming
                     granule)
  generate_frames_chunked: the same loop, attending a length bucket of the
                     KV buffer per chunk of frames

On a CUDA device the prefill and the loop run as captured CUDA graphs
(runtime/graphs.py), the counterpart of the JAX jits: `init_decode_state`
is one replay of a graph context's prefill graph (the counterpart of
`_init_decode_state`), which fills the context's static buffers, its KV
cache among them, and each chunk of K frames is one graph replay. `generate_frames` tests EOS on the host once per
chunk of `GRAPH_FRAMES` frames; frames past a row's EOS are inactive and
zeroed, as the JAX while_loop zeroes them, so codes, lengths and hidden
states equal the eager loop's. On the CPU the eager loop is the path.

The frame counter `t` is a device scalar, so one captured step serves every
frame: it picks the trailing text row by a gather and forms the write slot
and the EOS ban from it on the device.

Reference semantics, as in the JAX package: frames are recorded for every
talker forward whose input is a sampled code0 (max_new_tokens M yields at
most M-1 frames); generation stops at codebook-0 EOS per row; the
repetition penalty sees only previously generated code0 ids; the top-1024
control ids except EOS are suppressed; min_new_tokens bans EOS for the first
samples; the dual-track merge adds the trailing text hidden until it runs
out, then the tts_pad embedding.

Sampling noise comes from one `torch.Generator` on the model's device; a
graph replays its draws from the generator's state, so one seed gives the
graphed and the eager loop the same codes.

`generate_frames(..., mesh=)` runs with tensor-parallel shards of the
params (`parallel/mesh.py`) and splits the batch rows over dp: every rank
gets the whole batch, runs its own rows, draws the noise of the whole batch
from the same seeded generator and keeps its rows (so a sampled sharded run
gives the unsharded run's codes), and returns the whole batch. The frame
loop then runs eagerly, testing EOS every frame: a collective over gloo
cannot be captured, the counterpart of the JAX package's sharded engines
keeping the plain jit path. The fused kernels raise under a mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..config import TalkerConfig
from ..models.talker import (KVCache, StackDims, code_predictor_frame_dispatch,
                             talker_decode_step, talker_prefill)
from ..ops.cuda.talker_step import KV_CHUNK, talker_step_fused_cache
from ..ops.sampling import SamplingParams, process_and_sample_rows
from ..parallel.mesh import Mesh, gather_rows
from . import graphs

Params = Dict[str, Any]

# the chunked generator attends a KV window rounded up to this bucket
ATTEND_BUCKET = 256
# frames per graph replay of `generate_frames` on a CUDA device: the host
# tests EOS once per chunk, and at most GRAPH_FRAMES - 1 frames run past the
# last row's EOS (PERF.md, section 3)
GRAPH_FRAMES = 8


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

    def canonical(self) -> "GenerationConfig":
        """This config with the sampling knobs that travel as data
        (temperature, top_p, repetition_penalty) reset to fixed values: the
        key of the captured graphs, which read the knobs from the rows of
        `sampling_rows`, so calls that differ only in them share graphs.
        do_sample and top_k stay (they shape the captured work)."""
        def canon(s: SamplingParams) -> SamplingParams:
            return SamplingParams(do_sample=s.do_sample, top_k=s.top_k, top_p=1.0,
                                  temperature=1.0, repetition_penalty=1.0)

        return dataclasses.replace(self, sampling=canon(self.sampling),
                                   subtalker=canon(self.subtalker))

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
    prefill_len: torch.Tensor     # () int32: T, the first decode cache slot
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
    t: torch.Tensor             # () int32 frame counter
    # the graph context whose static buffers these tensors are (a CUDA
    # device; None: the eager loop)
    graphs: Optional[Any] = None


class GenerationResult(NamedTuple):
    codes: torch.Tensor    # (B, max_frames, Q) int32
    lengths: torch.Tensor  # (B,) valid frame count per sample
    # (B, max_frames, H) talker hidden per frame, zero on inactive frames;
    # generate_frames_chunked returns an empty (B, 0, H) tensor instead (the
    # hiddens of thousands of frames would take GBs)
    hidden: torch.Tensor


def _sample_code0(logits, gen_cfg: GenerationConfig, cfg: TalkerConfig,
                  const: DecodeConst, presence, ban, generator, mesh=None):
    B = logits.shape[0]
    return process_and_sample_rows(
        logits, const.samp_row[None, :].expand(B, 5), gen_cfg.sampling.top_k,
        presence=presence, suppress_mask=const.suppress, ban_eos=ban,
        eos_id=cfg.codec_eos_token_id,
        all_greedy=not gen_cfg.sampling.do_sample, generator=generator,
        noise_rows=None if mesh is None else mesh.noise_rows(B))


def check_mesh_route(gen_cfg: GenerationConfig, mesh: Optional[Mesh]) -> None:
    """The fused kernels are one persistent launch over whole layers and
    cannot split heads: under a mesh they raise (as the JAX engine refuses
    fused_talker_step with a mesh)."""
    if mesh is not None and (gen_cfg.fused_subtalker or gen_cfg.fused_talker_step):
        raise ValueError("fused_subtalker / fused_talker_step run on one device; "
                         "drop them under a mesh")


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
                      max_len: int, mesh: Optional[Mesh] = None):
    """Prefill and sample the first code0. `max_len` is the KV capacity S;
    `attn_mask` may lie on the host (the prompt assembly's) or on the
    device. Returns (DecodeState, DecodeConst). On a CUDA device (unless
    `graphs.eager()` is in force, or under a mesh) the prefill and the
    first code are one replay of the prefill graph of a graph context
    (`DecodeGraphs.prefill`), which writes the context's static buffers,
    its KV cache among them, and `decode_chunk` replays its frame graphs
    over them. Under a mesh the inputs are this dp rank's rows."""
    B, T, _ = inputs_embeds.shape
    dims = StackDims.from_talker(cfg, mesh)
    dev, dtype = inputs_embeds.device, inputs_embeds.dtype
    ctx = None if mesh is not None else graphs.decode_context(
        params, cfg, gen_cfg, B, max_len, dtype, trailing_text.dtype, dev)
    if ctx is not None:
        return ctx.prefill(inputs_embeds, attn_mask, trailing_text, tts_pad_embed,
                           gen_cfg.sampling_rows(), generator)
    cache = KVCache.zeros(cfg.num_hidden_layers, B, max_len, dims.kv_heads, dims.head_dim,
                          dtype=dtype, device=dev, quantized=gen_cfg.kv_quant)
    samp_row, sub_row = (torch.as_tensor(r, device=dev) for r in gen_cfg.sampling_rows())
    return prefill_state(params, cfg, gen_cfg, inputs_embeds, attn_mask.to(dev), cache,
                         trailing_text, tts_pad_embed.to(dtype), samp_row, sub_row, generator,
                         mesh=mesh)


def prefill_state(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                  inputs_embeds: torch.Tensor, attn_mask: torch.Tensor, cache: KVCache,
                  trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
                  samp_row: torch.Tensor, sub_row: torch.Tensor,
                  generator: torch.Generator, mesh: Optional[Mesh] = None,
                  plan: Optional[tuple] = None):
    """The prefill into `cache` (zeroed) and the first code0 from the
    device inputs: (DecodeState, DecodeConst) of new tensors, which hold the
    const inputs themselves. No host value is read and no host copy made:
    the body of a prefill graph (`plan`: the flash prefill's work list,
    where `talker.prefill_uses_flash` admits the prefill), and the eager
    route."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    S = cache.k.shape[3]
    logits, hidden_seq, cache = talker_prefill(params, cfg, inputs_embeds, attn_mask, cache,
                                               mesh=mesh, plan=plan)
    valid_prefill = torch.zeros((B, S), dtype=torch.bool, device=dev)
    valid_prefill[:, :T] = attn_mask.to(torch.bool)
    const = DecodeConst(
        trailing_text=trailing_text, tts_pad_embed=tts_pad_embed,
        valid_prefill=valid_prefill,
        seq_lens=attn_mask.sum(dim=-1).to(torch.int32),
        prefill_len=torch.full((), T, dtype=torch.int32, device=dev),
        samp_row=samp_row, sub_row=sub_row, suppress=suppress_mask_for(cfg, dev))
    presence = torch.zeros((B, cfg.vocab_size), dtype=torch.bool, device=dev)
    ban = torch.full((B,), 0 < gen_cfg.min_new_tokens, device=dev)
    code0 = _sample_code0(logits, gen_cfg, cfg, const, presence, ban, generator, mesh)
    state = DecodeState(
        cache=cache, code0=code0, last_hidden=hidden_seq[:, -1:, :],
        presence=presence, done=torch.zeros((B,), dtype=torch.bool, device=dev),
        lengths=torch.zeros((B,), dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))
    return state, const


def frame_step(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
               const: DecodeConst, state: DecodeState,
               generator: torch.Generator, attend_len: Optional[int] = None,
               mesh: Optional[Mesh] = None):
    """One frame, in place on `state` (its cache is written in place). No
    host sync and no host value read from the device: a graph captures it.
    Returns (state, frame (B, Q) int32, hidden row (B, H), active (B,) bool:
    whether the frame is valid output), as the JAX frame_step. `mesh`: as
    in `init_decode_state` (eager only)."""
    eos = cfg.codec_eos_token_id
    B = state.code0.shape[0]
    dev = state.code0.device
    S = state.cache.k.shape[3]
    dtype = state.last_hidden.dtype

    now_done = state.done | (state.code0 == eos)
    code0 = state.code0.long()
    presence = state.presence.scatter(1, code0[:, None], True)

    code0_embed = params["codec_embedding"][code0][:, None, :].to(dtype)
    sub_rows = (const.sub_row[None, :].expand(B, 5)
                if gen_cfg.subtalker.do_sample else None)
    sub_codes, sub_emb_sum = code_predictor_frame_dispatch(
        params, cfg, state.last_hidden, code0_embed, gen_cfg.subtalker,
        fused=gen_cfg.fused_subtalker, rows=sub_rows,
        rows_top_k=gen_cfg.subtalker.top_k, generator=generator, mesh=mesh)
    frame = torch.cat([state.code0[:, None], sub_codes.to(torch.int32)], dim=1)
    active = ~now_done

    # dual-track merge (reference 1682-1692): row t of the trailing text
    # until it runs out, then the tts_pad embedding
    pad = const.tts_pad_embed.expand(B, 1, -1)
    Tt = const.trailing_text.shape[1]
    if Tt:
        row = const.trailing_text.index_select(
            1, torch.clamp(state.t, max=Tt - 1).reshape(1).long())
        text_h = torch.where(state.t < Tt, row, pad)
    else:
        text_h = pad
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
            attend_len=attend_len, mesh=mesh)

    ban = (state.t + 1 < gen_cfg.min_new_tokens).expand(B)
    state.code0 = _sample_code0(logits, gen_cfg, cfg, const, presence, ban, generator, mesh)
    state.last_hidden = last_hidden
    state.presence = presence
    state.done = now_done
    state.lengths = state.lengths + active.to(torch.int32)
    state.t = state.t + 1
    return state, frame, last_hidden[:, 0], active


def frame_loop(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
               const: DecodeConst, state: DecodeState, num_frames: int,
               generator: torch.Generator, attend_len: Optional[int] = None,
               mesh: Optional[Mesh] = None):
    """`num_frames` eager frame steps. Returns (state, frames (B, K, Q),
    active (B, K), hidden (B, K, H), zero on inactive frames): the body a
    graph captures."""
    frames, actives, hiddens = [], [], []
    for _ in range(num_frames):
        state, frame, hidden, active = frame_step(params, cfg, gen_cfg, const, state,
                                                  generator, attend_len=attend_len,
                                                  mesh=mesh)
        frames.append(frame)
        actives.append(active)
        hiddens.append(torch.where(active[:, None], hidden, torch.zeros_like(hidden)))
    return (state, torch.stack(frames, dim=1), torch.stack(actives, dim=1),
            torch.stack(hiddens, dim=1))


def _chunk(params, cfg, gen_cfg, const, state, num_frames, generator, attend_len,
           mesh=None):
    """(state, frames, active, hidden) of `num_frames` frames: one graph
    replay on a graph context, else the eager loop."""
    if state.graphs is not None:
        frames, active, hidden = state.graphs.run(params, gen_cfg, num_frames, attend_len,
                                                  generator)
        return state, frames, active, hidden
    return frame_loop(params, cfg, gen_cfg, const, state, num_frames, generator, attend_len,
                      mesh)


def decode_chunk(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                 const: DecodeConst, state: DecodeState, num_frames: int,
                 generator: torch.Generator, attend_len: Optional[int] = None):
    """`num_frames` frame steps (the streaming granule), attending the first
    `attend_len` KV slots: on a graph context one replay of the graph of
    (num_frames, attend_len), captured at first use. Returns (state,
    frames (B, K, Q), active (B, K)); steps past a row's EOS give inactive
    frames."""
    state, frames, active, _ = _chunk(params, cfg, gen_cfg, const, state, num_frames,
                                      generator, attend_len)
    if state.graphs is not None:   # the graph's static outputs: the next replay rewrites them
        frames, active = frames.clone(), active.clone()
    return state, frames, active


def _finish(frames, actives, hiddens, max_frames: int) -> GenerationResult:
    codes = torch.cat(frames, dim=1)            # (B, n, Q)
    active = torch.cat(actives, dim=1)          # (B, n)
    codes = torch.where(active[..., None], codes, torch.zeros_like(codes))
    lengths = active.sum(dim=1).to(torch.int32)
    pad = max_frames - codes.shape[1]
    if pad > 0:
        codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    if hiddens is None:
        return GenerationResult(codes, lengths, None)
    hidden = torch.cat(hiddens, dim=1)
    if pad > 0:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
    return GenerationResult(codes, lengths, hidden[:, :max_frames])


def generate_frames(params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                    inputs_embeds: torch.Tensor, attn_mask: torch.Tensor,
                    trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
                    generator: torch.Generator, stop_at_eos: bool = True,
                    mesh: Optional[Mesh] = None) -> GenerationResult:
    """Full batch generation. inputs_embeds: (B, T, H) left-padded prefill;
    attn_mask: (B, T) 1 = real token; trailing_text: (B, Tt, H) pad-filled;
    tts_pad_embed: (1, 1, H). Stops once every row hit EOS: the eager loop
    tests it on the host every frame, the graphed loop once per replay of
    GRAPH_FRAMES frames (the last replay is shorter, so no frame runs past
    max_frames). `stop_at_eos=False` runs every frame up to max_new_tokens
    (the warm-up: every graph a call of this shape can replay).

    `mesh`: `params` are this rank's tensor-parallel shards; every rank
    passes the whole batch and gets the whole result, each running its dp
    share of the rows (dp must divide B) on the eager loop."""
    if mesh is None:
        return _generate(params, cfg, gen_cfg, inputs_embeds, attn_mask, trailing_text,
                         tts_pad_embed, generator, stop_at_eos)
    check_mesh_route(gen_cfg, mesh)
    out = _generate(params, cfg, gen_cfg, *(x[mesh.rows(x.shape[0])] for x in (
        inputs_embeds, attn_mask, trailing_text)), tts_pad_embed, generator, stop_at_eos, mesh)
    return GenerationResult(*(gather_rows(x, mesh) for x in out))


def _generate(params, cfg, gen_cfg, inputs_embeds, attn_mask, trailing_text, tts_pad_embed,
              generator, stop_at_eos, mesh=None) -> GenerationResult:
    """`generate_frames` on this rank's rows."""
    B, T, H = inputs_embeds.shape
    max_frames = gen_cfg.max_new_tokens - 1
    state, const = init_decode_state(params, cfg, gen_cfg, inputs_embeds,
                                     attn_mask, trailing_text, tts_pad_embed,
                                     generator, kv_capacity(gen_cfg, T), mesh)
    eos = cfg.codec_eos_token_id
    step = GRAPH_FRAMES if state.graphs is not None else 1
    frames, actives, hiddens = [], [], []
    emitted = 0
    while emitted < max_frames and not (
            stop_at_eos and bool((state.done | (state.code0 == eos)).all())):
        k = min(step, max_frames - emitted)
        state, fr, act, hid = _chunk(params, cfg, gen_cfg, const, state, k, generator, None,
                                     mesh)
        if state.graphs is not None:   # the graph's static outputs: the next replay rewrites them
            fr, act, hid = fr.clone(), act.clone(), hid.clone()
        frames.append(fr)
        actives.append(act)
        hiddens.append(hid)
        emitted += k
    if not frames:
        dev = inputs_embeds.device
        z = torch.zeros((B, max_frames, cfg.num_code_groups), dtype=torch.int32, device=dev)
        return GenerationResult(z, torch.zeros((B,), dtype=torch.int32, device=dev),
                                torch.zeros((B, max_frames, H), dtype=inputs_embeds.dtype,
                                            device=dev))
    return _finish(frames, actives, hiddens, max_frames)


def generate_frames_chunked(params: Params, cfg: TalkerConfig,
                            gen_cfg: GenerationConfig,
                            inputs_embeds: torch.Tensor, attn_mask: torch.Tensor,
                            trailing_text: torch.Tensor, tts_pad_embed: torch.Tensor,
                            generator: torch.Generator, chunk: int = 64,
                            attend_bucket: int = ATTEND_BUCKET,
                            stop_at_eos: bool = True) -> GenerationResult:
    """Same codes and lengths as `generate_frames`, but each chunk of frames
    attends only a length bucket of the KV buffer, and the EOS test runs
    once per chunk. Frames after a row's EOS are inactive. `hidden` is an
    empty (B, 0, H) tensor, as the JAX function returns. `stop_at_eos` as
    in `generate_frames`."""
    B, T, H = inputs_embeds.shape
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
        frames.append(fr)
        actives.append(act)
        emitted += k
        if stop_at_eos and bool(state.done.all()):
            break
    out = _finish(frames, actives, None, max_frames)
    return out._replace(hidden=torch.zeros((B, 0, H), dtype=inputs_embeds.dtype,
                                           device=inputs_embeds.device))
