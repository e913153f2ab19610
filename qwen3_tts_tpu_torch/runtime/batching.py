"""Continuous batched serving: a slot-based KV cache with on-device admission
(counterpart of `qwen3_tts_tpu/runtime/batching.py`).

- A fixed pool of `num_slots` sequences shares one preallocated KV cache
  (bf16, or int8 with scale planes), in the port's (L, B, Hkv, S, D) layout
  on both decode routes. Every slot carries its own prefill length, frame
  counter, rope position, presence set, frame budget, request id, sampling
  rows and done flag, all on the device.
- New requests are staged in batches: one prefill over a (N,
  prefill_bucket) left-padded batch writes KV blocks and first-token state
  into staging rows, by a fixed-N merge that padding rows leave untouched
  (`stage_rows`). On a CUDA device each staging call is one replay of a
  captured graph of its request count N in {1, 2, 4, 8, 16}
  (`runtime/graphs.py::ServeGraphs.stage`).
- `serve_chunk` advances every live slot one frame per tick, a Python loop
  over `serve_step`. At the top of each tick, staged requests are installed
  into free slots by tensor ops on the device (no host sync), so a slot
  refills the tick after its sequence finishes. The chunk packs its frames
  and bookkeeping into one int32 array and makes one device-to-host copy.
  On a CUDA device each tick is one replay of a captured one-tick graph
  (`runtime/graphs.py::ServeGraphs`, one per attend bucket and install
  flag) that writes its tick column through a device tick index.
- The host scheduler (`ContinuousBatchingEngine`) batches requests into
  staging calls, sizes chunks, syncs each chunk's aux one chunk behind and
  attributes frames to request ids.
- Tracing (`trace_enabled`, off by default: the one switch): per-request
  stamps on `utils/profiling.py::clock` (`trace`: submit, staged,
  first_frame; the server adds first_packet) and the engine's spans in its
  `tracer`: host spans `engine.stage` (a staging batch's host work and its
  replay's dispatch), `engine.launch` (a chunk's replays and its aux
  copy's enqueue), `engine.aux_wait` (the aux copy's event sync) and
  `engine.attribute` (the rest of an aux sync), and device spans
  `engine.stage` (a staging replay) and `engine.chunk` (a chunk's tick
  replays). Work counters, always on: `engine.ticks`, `engine.frames`,
  `engine.staged_rows` and `engine.staged_rows_padded` (the rows of each
  staging call before and after its power-of-two padding), among others.

- `mesh=` (`parallel/mesh.py`): one engine spanning the ranks of a
  ("dp", "tp") mesh, in SPMD: every rank runs the same host scheduler over
  the same submissions and owns its dp share of the slots and staging rows
  (`shard_slot_state`), and under tp its heads of their KV caches, with the
  params as this rank's tensor-parallel shards. A rank prefills only the
  staged requests whose rows it owns and installs them into its own free
  slots. After each chunk the packed aux is all-reduced over dp into the
  full-size layout, so every rank attributes the same frames and takes the
  same staging and retire decisions (the counterpart of the free-slot
  argmax and the packed aux lowering to GSPMD collectives). Ticks run
  eagerly (no serve graphs: a gloo collective cannot be captured), and
  `fused_talker_step` / `fused_subtalker` raise, as the JAX engine refuses
  the fused step with a mesh. Noise is drawn for the whole slot pool and
  each rank keeps its slots' rows.

- `warmup_serve` captures the serve graph of every attend bucket a live
  engine can ask for, with and without installs, and `warmup_staging`
  the staging graph of every request-count bucket, with all-invalid rows
  (the counterparts of the JAX engine's AOT warm-up): a graph captured at a
  live tick stalls every slot for its warm pass and capture.

Not ported, being XLA compile plumbing: the AOT executable cache, and the
background prewarm of the next attend bucket (`_prewarm_next_bucket`):
after `warmup_serve` it is a no-op in the JAX engine too, and a capture on
a worker thread would race the loop thread's replays.
"""

from __future__ import annotations

import time as _time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TalkerConfig
from ..models.talker import (KVCache, StackDims, code_predictor_frame_dispatch,
                             decoder_stack, head_logits, talker_prefill)
from ..ops.attention import mask_to_bias
from ..ops.cuda.talker_step import KV_CHUNK
from ..ops.rope import default_inv_freq, rope_tables
from ..ops.sampling import SamplingParams, process_and_sample_rows
from ..parallel.mesh import Mesh, all_reduce
from ..utils import profiling
from ..utils.metrics import global_metrics
from ..weights import is_int8
from . import graphs
from .generate import (ATTEND_BUCKET, GenerationConfig, attend_bucket_for, check_mesh_route,
                       suppress_mask_for)

Params = Dict[str, Any]


@dataclass
class SlotState:
    # ---- live slots ----
    cache: KVCache              # (L, B, Hkv, S, D) [+ (L, B, Hkv, S) scales]
    kv_valid: torch.Tensor      # (B, S) bool: attendable slots
    active: torch.Tensor        # (B,) bool: the slot holds a live request
    code0: torch.Tensor         # (B,) pending codebook-0 token
    last_hidden: torch.Tensor   # (B, 1, H)
    presence: torch.Tensor      # (B, V) bool
    done: torch.Tensor          # (B,) reached EOS / frame budget
    t: torch.Tensor             # (B,) frames generated
    prefill_len: torch.Tensor   # (B,) padded prefill length (the bucket)
    seq_lens: torch.Tensor      # (B,) real prefill length
    trailing: torch.Tensor      # (B, Tt, H)
    trailing_len: torch.Tensor  # (B,)
    tts_pad: torch.Tensor       # (1, 1, H)
    max_frames: torch.Tensor    # (B,) per-slot frame budget
    req_id: torch.Tensor        # (B,) request id (-1 = none)
    # per-slot talker / sub-talker sampling rows [temp, top_p, rep_pen,
    # do_sample, top_k] (SamplingParams.as_row)
    sampling: torch.Tensor      # (B, 5) f32
    sub_sampling: torch.Tensor  # (B, 5) f32
    # ---- staging pool (prefilled requests awaiting a free slot) ----
    staged: KVCache             # (L, K, Hkv, Lp, D) [+ scales]
    staged_kv_valid: torch.Tensor   # (K, Lp) bool
    staged_code0: torch.Tensor      # (K,)
    staged_hidden: torch.Tensor     # (K, H)
    staged_seq_len: torch.Tensor    # (K,)
    staged_trailing: torch.Tensor   # (K, Tt, H)
    staged_trailing_len: torch.Tensor  # (K,)
    staged_max_frames: torch.Tensor    # (K,)
    staged_req_id: torch.Tensor        # (K,)
    staged_valid: torch.Tensor         # (K,) bool
    staged_sampling: torch.Tensor      # (K, 5)
    staged_sub_sampling: torch.Tensor  # (K, 5)


# slot fields an install copies from the staging pool: (slot, staged) names
_INSTALLED = (("code0", "staged_code0"), ("seq_lens", "staged_seq_len"),
              ("trailing", "staged_trailing"), ("trailing_len", "staged_trailing_len"),
              ("max_frames", "staged_max_frames"), ("req_id", "staged_req_id"),
              ("sampling", "staged_sampling"), ("sub_sampling", "staged_sub_sampling"))


def init_slot_state(cfg: TalkerConfig, num_slots: int, max_len: int,
                    max_trailing: int, dtype=torch.bfloat16,
                    prefill_bucket: int = 128, staging_rows: Optional[int] = None,
                    kv_quant: bool = False, device="cpu") -> SlotState:
    dims = StackDims.from_talker(cfg)
    B, S, H = num_slots, max_len, cfg.hidden_size
    K = staging_rows or num_slots
    L, Lp = cfg.num_hidden_layers, prefill_bucket

    def zeros(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=device)

    return SlotState(
        cache=KVCache.zeros(L, B, S, dims.kv_heads, dims.head_dim, dtype=dtype,
                            device=device, quantized=kv_quant),
        kv_valid=zeros(B, S, dt=torch.bool), active=zeros(B, dt=torch.bool),
        code0=zeros(B), last_hidden=zeros(B, 1, H, dt=dtype),
        presence=zeros(B, cfg.vocab_size, dt=torch.bool), done=zeros(B, dt=torch.bool),
        t=zeros(B), prefill_len=zeros(B), seq_lens=zeros(B),
        trailing=zeros(B, max_trailing, H, dt=dtype), trailing_len=zeros(B),
        tts_pad=zeros(1, 1, H, dt=dtype), max_frames=zeros(B),
        req_id=torch.full((B,), -1, dtype=torch.int32, device=device),
        sampling=zeros(B, 5, dt=torch.float32), sub_sampling=zeros(B, 5, dt=torch.float32),
        staged=KVCache.zeros(L, K, Lp, dims.kv_heads, dims.head_dim, dtype=dtype,
                             device=device, quantized=kv_quant),
        staged_kv_valid=zeros(K, Lp, dt=torch.bool), staged_code0=zeros(K),
        staged_hidden=zeros(K, H, dt=dtype), staged_seq_len=zeros(K),
        staged_trailing=zeros(K, max_trailing, H, dt=dtype), staged_trailing_len=zeros(K),
        staged_max_frames=zeros(K),
        staged_req_id=torch.full((K,), -1, dtype=torch.int32, device=device),
        staged_valid=zeros(K, dt=torch.bool),
        staged_sampling=zeros(K, 5, dt=torch.float32),
        staged_sub_sampling=zeros(K, 5, dt=torch.float32))


def stage_requests(params: Params, cfg: TalkerConfig, state: SlotState,
                   gen_cfg: GenerationConfig, embeds: torch.Tensor, mask: torch.Tensor,
                   trailing: torch.Tensor, meta: np.ndarray, tts_pad: torch.Tensor,
                   generator: torch.Generator, sampling_rows: torch.Tensor,
                   sub_sampling_rows: torch.Tensor, mesh: Optional[Mesh] = None) -> None:
    """Prefill a batch of N staged requests ((N, Lp, H) / (N, Lp) / (N, Tt,
    H), left-padded to the bucket; the mask on the host or the device) and
    write them into staging rows, in place: `stage_rows` on the device.
    `meta` (N, 5) host int [req_id, max_frames, trailing_len, row, valid];
    rows with valid 0 are padding and write nothing. Under a mesh `row` is a
    row of the whole pool: this rank prefills the requests whose rows it
    owns (the noise is drawn for all N)."""
    dev = embeds.device
    N = embeds.shape[0]
    noise_rows = None
    if mesh is not None:
        K = state.staged_valid.shape[0]
        mine = np.flatnonzero((meta[:, 4] != 0) & (meta[:, 3] // K == mesh.dp_rank))
        idx = torch.as_tensor(mine, dtype=torch.long, device=dev)
        noise_rows = (N, idx)
        embeds, mask, trailing = embeds[idx], mask.to(dev)[idx], trailing[idx]
        sampling_rows, sub_sampling_rows = sampling_rows[idx], sub_sampling_rows[idx]
        meta = meta[mine].copy()
        meta[:, 3] -= mesh.dp_rank * K
    stage_rows(params, cfg, state, gen_cfg, embeds, mask.to(dev), trailing,
               torch.as_tensor(meta, dtype=torch.int32, device=dev), tts_pad, generator,
               sampling_rows, sub_sampling_rows, noise_rows=noise_rows, mesh=mesh)


def stage_rows(params: Params, cfg: TalkerConfig, state: SlotState,
               gen_cfg: GenerationConfig, embeds: torch.Tensor, mask: torch.Tensor,
               trailing: torch.Tensor, meta: torch.Tensor, tts_pad: torch.Tensor,
               generator: torch.Generator, sampling_rows: torch.Tensor,
               sub_sampling_rows: torch.Tensor, noise_rows=None, mesh: Optional[Mesh] = None,
               plan: Optional[tuple] = None) -> None:
    """The staging prefill of N fixed rows, all on the device (`meta` (N, 5)
    int32 as in `stage_requests`): prefill into a temporary KV cache, sample
    each first code0, then merge into the staging pool in place as the JAX
    package does, by an order-safe gather over the pool's K rows: pool row
    k takes the valid entry naming it, if any. A padding row (valid 0)
    leaves nothing, and no host value is read, so a graph captures it
    (`plan`: the flash prefill's work list, where `talker.prefill_uses_flash`
    sends the prefill through kernel 3).
    The pad embedding is taken only when some row is valid (the JAX
    engine's warm-up pins the zero pad it stages with; this one does not)."""
    N, Lp, _ = embeds.shape
    dims = StackDims.from_talker(cfg, mesh)
    dev = embeds.device
    if N:
        tmp = KVCache.zeros(cfg.num_hidden_layers, N, Lp, dims.kv_heads, dims.head_dim,
                            dtype=state.last_hidden.dtype, device=dev,
                            quantized=state.cache.quantized)
        logits, hidden_seq, tmp = talker_prefill(params, cfg, embeds, mask, tmp, mesh=mesh,
                                                 plan=plan)
    else:   # no row of ours: the draw still runs, so every rank's generator moves alike
        logits = torch.zeros((0, cfg.vocab_size), device=dev)
    code0 = process_and_sample_rows(
        logits, sampling_rows, gen_cfg.sampling.top_k,
        presence=torch.zeros((N, cfg.vocab_size), dtype=torch.bool, device=dev),
        suppress_mask=suppress_mask_for(cfg, dev),
        ban_eos=torch.full((N,), 0 < gen_cfg.min_new_tokens, device=dev),
        eos_id=cfg.codec_eos_token_id, generator=generator, noise_rows=noise_rows)
    if not N:
        return
    K = state.staged_valid.shape[0]
    onehot = (meta[:, 4, None] != 0) & (meta[:, 3, None] == torch.arange(K, device=dev))
    hit = onehot.any(dim=0)                         # (K,) pool rows written
    src = onehot.to(torch.int32).argmax(dim=0)      # (K,) the entry each takes

    def merge(pool, new, axis=0):
        sel = hit.reshape([-1 if d == axis else 1 for d in range(pool.ndim)])
        pool.copy_(torch.where(sel, new.index_select(axis, src).to(pool.dtype), pool))

    for pool, fresh in ((state.staged.k, tmp.k), (state.staged.v, tmp.v),
                        (state.staged.k_scale, tmp.k_scale),
                        (state.staged.v_scale, tmp.v_scale)):
        if pool is not None:
            merge(pool, fresh, axis=1)
    for name, new in (("staged_kv_valid", mask.to(torch.bool)), ("staged_code0", code0),
                      ("staged_hidden", hidden_seq[:, -1, :]),
                      ("staged_seq_len", mask.sum(dim=-1)), ("staged_trailing", trailing),
                      ("staged_trailing_len", meta[:, 2]), ("staged_max_frames", meta[:, 1]),
                      ("staged_req_id", meta[:, 0]), ("staged_sampling", sampling_rows),
                      ("staged_sub_sampling", sub_sampling_rows)):
        merge(getattr(state, name), new)
    # in place: the engine's serve graphs read these very tensors
    state.staged_valid.logical_or_(hit)
    pad = tts_pad.reshape(state.tts_pad.shape).to(state.tts_pad.dtype)
    state.tts_pad.copy_(torch.where(hit.any(), pad, state.tts_pad))


def cancel_in_state(state: SlotState, rid: int) -> None:
    """Kill any live slot holding `rid` and invalidate its staged row. Runs
    after every chunk launched before it (one stream, program order), so it
    lands even when such a chunk installs the request."""
    hit = state.req_id == rid
    state.active &= ~hit
    state.done |= hit
    state.staged_valid &= state.staged_req_id != rid


def install_all(state: SlotState) -> None:
    """Install staged requests into free slots until either runs out, in
    place: the i-th free slot (in slot order) takes the i-th valid staged
    row (in row order), the JAX engine's one-at-a-time order, as tensor
    ops with no host sync."""
    free, staged = ~state.active, state.staged_valid
    fr = torch.cumsum(free.to(torch.int32), 0) - 1
    sr = torch.cumsum(staged.to(torch.int32), 0) - 1
    match = free[:, None] & staged[None, :] & (fr[:, None] == sr[None, :])   # (B, K)
    inst = match.any(dim=1)
    src = match.to(torch.int32).argmax(dim=1)
    Lp = state.staged_kv_valid.shape[1]
    c, sp = state.cache, state.staged
    for live, pool in ((c.k, sp.k), (c.v, sp.v), (c.k_scale, sp.k_scale),
                       (c.v_scale, sp.v_scale)):
        if live is not None:
            view = live[:, :, :, :Lp]
            sel = inst.reshape((1, -1) + (1,) * (view.ndim - 2))
            view.copy_(torch.where(sel, pool[:, src], view))
    row = torch.zeros_like(state.kv_valid)
    row[:, :Lp] = state.staged_kv_valid[src]
    state.kv_valid = torch.where(inst[:, None], row, state.kv_valid)
    for name, staged_name in _INSTALLED:
        cur, new = getattr(state, name), getattr(state, staged_name)[src]
        sel = inst.reshape((-1,) + (1,) * (cur.ndim - 1))
        setattr(state, name, torch.where(sel, new.to(cur.dtype), cur))
    state.last_hidden = torch.where(inst[:, None, None],
                                    state.staged_hidden[src][:, None, :], state.last_hidden)
    state.active = state.active | inst
    state.presence = state.presence & ~inst[:, None]
    state.done = state.done & ~inst
    state.t = torch.where(inst, 0, state.t)
    state.prefill_len = torch.where(inst, Lp, state.prefill_len)
    state.staged_valid = staged & ~match.any(dim=0)


def serve_step(params: Params, cfg: TalkerConfig, state: SlotState,
               gen_cfg: GenerationConfig, generator: torch.Generator,
               attend_len: Optional[int] = None, install: bool = True,
               mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance every slot one frame, in place, after installing staged
    requests into free slots (`install`). `attend_len` bounds the attended
    KV window (it covers the longest live slot). Under a mesh the slots are
    this rank's (the plain route only).

    Returns (frames (B, Q), emit (B,) bool, req_id (B,), finished (B,) bool:
    slots that consumed their final tick)."""
    if install:
        install_all(state)
    eos = cfg.codec_eos_token_id
    B = state.code0.shape[0]
    dev = state.code0.device
    S_buf = state.kv_valid.shape[1]
    dims = StackDims.from_talker(cfg, mesh)
    dtype = state.last_hidden.dtype
    rows = torch.arange(B, device=dev)
    noise_rows = None if mesh is None else mesh.noise_rows(B)

    now_done = state.done | (state.code0 == eos) | (state.t >= state.max_frames)
    emit = state.active & ~now_done
    code0 = state.code0.long()
    presence = state.presence.clone()
    presence[rows, code0] = presence[rows, code0] | emit

    code0_embed = params["codec_embedding"][code0][:, None, :].to(dtype)
    # per-slot sub-talker sampling rides the rows path only when the
    # engine's sub-talker samples at all (submit rejects the rest)
    sub_rows = state.sub_sampling if gen_cfg.subtalker.do_sample else None
    sub_codes, sub_emb_sum = code_predictor_frame_dispatch(
        params, cfg, state.last_hidden, code0_embed, gen_cfg.subtalker,
        fused=gen_cfg.fused_subtalker, rows=sub_rows,
        rows_top_k=gen_cfg.subtalker.top_k, generator=generator, mesh=mesh)
    frames = torch.cat([state.code0[:, None], sub_codes.to(torch.int32)], dim=1)

    # dual-track merge with a per-slot trailing index
    Tt = state.trailing.shape[1]
    text_h = state.trailing[rows, torch.clamp(state.t, max=Tt - 1).long()][:, None]
    use_pad = (state.t >= state.trailing_len)[:, None, None]
    text_h = torch.where(use_pad, state.tts_pad.expand_as(text_h), text_h)
    embed = code0_embed + sub_emb_sum + text_h.to(dtype)

    cache_index = state.prefill_len + state.t      # (B,)
    position = state.seq_lens + state.t
    slot = torch.arange(S_buf, device=dev)[None, :]
    kv_valid = state.kv_valid | ((slot >= state.prefill_len[:, None])
                                 & (slot <= cache_index[:, None]))
    cache = state.cache
    if gen_cfg.fused_talker_step:
        # kernel 2 with per-row write slots; it masks each row's current
        # slot out of the window and applies the sliding window itself
        from ..ops.cuda.talker_step import talker_step_fused_cache

        logits, h = talker_step_fused_cache(
            params, cfg, embed, position, cache_index, kv_valid, cache.k, cache.v,
            attend_len=attend_len, k_scale=cache.k_scale, v_scale=cache.v_scale)[:2]
    else:
        S = S_buf if attend_len is None else attend_len
        if cfg.sliding_window is not None:
            # index-based window, as talker_decode_step clamps it
            kv_valid = kv_valid & (slot > (cache_index[:, None] - cfg.sliding_window))
        bias = mask_to_bias(kv_valid[:, None, None, :S])
        inv_freq = default_inv_freq(dims.head_dim, cfg.rope_theta, device=dev)
        cos, sin = rope_tables(position[:, None], inv_freq)
        h = decoder_stack(params["layers"], params["norm"], dims, embed, cos, sin,
                          bias, cache, cache_index, attend_len=attend_len)
        logits = head_logits(h[:, 0].to(torch.float32), params["codec_head"], cfg.vocab_size,
                             mesh)
    next_code0 = process_and_sample_rows(
        logits, state.sampling, gen_cfg.sampling.top_k, presence=presence,
        suppress_mask=suppress_mask_for(cfg, dev),
        ban_eos=state.t + 1 < gen_cfg.min_new_tokens, eos_id=eos, generator=generator,
        noise_rows=noise_rows)
    req_id = state.req_id
    # a sampled EOS or an exhausted budget frees the slot this tick (the EOS
    # frame itself is never output)
    t_new = state.t + emit.to(torch.int32)
    code0_new = torch.where(emit, next_code0, state.code0)
    done_next = now_done | (code0_new == eos) | (t_new >= state.max_frames)
    finished = state.active & done_next
    state.code0 = code0_new
    state.last_hidden = torch.where(emit[:, None, None], h.to(dtype), state.last_hidden)
    state.presence = presence
    state.done = done_next
    state.t = t_new
    state.active = state.active & ~done_next
    return frames, emit, req_id, finished


def unpack_chunk_aux(aux: np.ndarray, num_slots: int, ticks: int, Q: int,
                     staging_rows: int):
    """Inverse of serve_chunk's packed aux: (frames (B, ticks, Q), emit (B,
    ticks), req_id (B, ticks), finished (B, ticks), staged_valid (K,),
    staged_rid (K,), t (B,)). Tick columns past the chunk's n_ticks are zero."""
    B, K = num_slots, staging_rows
    n_bt = B * ticks
    off = 0
    frames = aux[off:off + n_bt * Q].reshape(B, ticks, Q)
    off += n_bt * Q
    emit = aux[off:off + n_bt].reshape(B, ticks).astype(bool)
    off += n_bt
    req_id = aux[off:off + n_bt].reshape(B, ticks)
    off += n_bt
    finished = aux[off:off + n_bt].reshape(B, ticks).astype(bool)
    off += n_bt
    staged_valid = aux[off:off + K].astype(bool)
    off += K
    staged_rid = aux[off:off + K]
    off += K
    return frames, emit, req_id, finished, staged_valid, staged_rid, aux[off:off + B]


def serve_chunk(params: Params, cfg: TalkerConfig, state: SlotState,
                gen_cfg: GenerationConfig, generator: torch.Generator, n_ticks: int,
                max_ticks: int, attend_len: Optional[int] = None,
                install: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Advance every slot min(n_ticks, max_ticks) frames, in place. Returns
    one flat int32 tensor on the state's device packing (frames, emit,
    req_id, finished) for max_ticks tick columns plus (staged_valid,
    staged_rid, t): the chunk's single device-to-host copy (decode with
    `unpack_chunk_aux`). Under a mesh each piece is placed at this rank's
    rows of the whole pool's layout and the result all-reduced over dp:
    every rank gets the whole pool's aux."""
    B, Q = state.code0.shape[0], cfg.num_code_groups
    dev = state.code0.device
    fb = torch.zeros((B, max_ticks, Q), dtype=torch.int32, device=dev)
    eb, rb, db = (torch.zeros((B, max_ticks), dtype=torch.int32, device=dev)
                  for _ in range(3))
    for i in range(min(n_ticks, max_ticks)):
        frames, emit, req_id, finished = serve_step(params, cfg, state, gen_cfg, generator,
                                                    attend_len, install, mesh)
        fb[:, i] = frames
        eb[:, i] = emit.to(torch.int32)
        rb[:, i] = req_id
        db[:, i] = finished.to(torch.int32)
    pieces = (fb, eb, rb, db, state.staged_valid.to(torch.int32),
              state.staged_req_id.to(torch.int32), state.t.to(torch.int32))
    if mesh is None:
        return torch.cat([p.reshape(-1) for p in pieces])
    whole = []
    for p in pieces:   # this rank's rows of each piece, zeros elsewhere
        full = p.new_zeros((p.shape[0] * mesh.dp,) + tuple(p.shape[1:]))
        full[mesh.rows(full.shape[0])] = p
        whole.append(full.reshape(-1))
    return all_reduce(torch.cat(whole), mesh.dp_group)


def _pad_request(embeds, mask, trailing, Lp: int, Tt: int, dtype):
    """(1, T, H) / (1, T) / (1, Tt_in, H) request tensors -> left-padded
    (Lp, H) and right-padded (Tt, H) staging rows on the embeds' device, one
    pad each (the JAX package's `_pad_request_fn`), and the left-padded
    (Lp,) int32 mask on the host, where the staging prefill's flash plan is
    built when kernel 3 takes it (`talker.prefill_uses_flash`; a mask on the
    device is read once)."""
    T = embeds.shape[1]
    tl = min(trailing.shape[1], Tt)
    e = F.pad(embeds[0].to(dtype), (0, 0, Lp - T, 0))
    m = F.pad(mask[0].cpu().to(torch.int32), (Lp - T, 0))
    tr = F.pad(trailing[0, :tl].to(dtype), (0, 0, 0, Tt - tl))
    return e, m, tr


@dataclass
class Request:
    request_id: int
    inputs_embeds: torch.Tensor     # (1, T, H)
    attn_mask: torch.Tensor         # (1, T)
    trailing: torch.Tensor          # (1, Tt, H)
    trailing_len: int
    tts_pad: torch.Tensor
    max_frames: int = 2047
    # per-request talker sampling (None: the engine's gen_cfg.sampling);
    # top_k must fit the engine's candidate width gen_cfg.sampling.top_k
    sampling: Optional[SamplingParams] = None
    # per-request sub-talker sampling (None: gen_cfg.subtalker)
    sub_sampling: Optional[SamplingParams] = None


@dataclass
class Completion:
    request_id: int
    codes: np.ndarray            # (frames, Q)


class ContinuousBatchingEngine:
    """Host scheduler around stage_requests / serve_chunk: it batches new
    requests into staging calls and attributes emitted frames to request
    ids; admission itself (prefill + slot install) runs on the device.

    `mesh`: one engine spanning a ("dp", "tp") mesh (module docstring);
    `params` are this rank's `shard_talker_params`, and dp must divide
    `num_slots` and the staging rows. Every rank makes the same calls."""

    def __init__(self, params: Params, cfg: TalkerConfig, gen_cfg: GenerationConfig,
                 num_slots: int = 8, max_len: int = 3072, max_trailing: int = 512,
                 dtype=torch.bfloat16, seed: int = 0, ticks_per_sync: int = 8,
                 prefill_bucket: Optional[int] = None, installs_per_tick: int = 4,
                 staging_rows: Optional[int] = None, mesh=None, metrics=None,
                 chunk_ramp: Tuple[int, ...] = (2, 4, 8, 16)):
        check_mesh_route(gen_cfg, mesh)
        self.mesh = mesh
        self.params = params
        self.cfg = cfg
        self.gen_cfg = gen_cfg
        self.device = params["codec_embedding"].device
        self.num_slots = num_slots
        self.max_trailing = max_trailing
        self.dtype = dtype
        if gen_cfg.fused_talker_step:
            # kernel 2: int8 weights, the KV buffer in whole 128-slot chunks
            if not is_int8(params["layers"]["self_attn"]["qkv_proj"]["weight"]):
                raise ValueError("fused_talker_step requires int8-quantized params")
            max_len = -(-max_len // KV_CHUNK) * KV_CHUNK
        self.max_len = max_len
        self.prefill_bucket = int(prefill_bucket if prefill_bucket is not None
                                  else max(8, min(128, max_len // 2)))
        if self.prefill_bucket >= max_len:
            raise ValueError(f"prefill_bucket {self.prefill_bucket} must be < max_len "
                             f"{max_len}")
        # a staging pool deeper than the slots: the next wave prefills while
        # slots are busy and installs mid-chunk
        self.staging_rows = int(staging_rows if staging_rows is not None else 2 * num_slots)
        self.state = init_slot_state(cfg, num_slots, max_len, max_trailing, dtype,
                                     prefill_bucket=self.prefill_bucket,
                                     staging_rows=self.staging_rows,
                                     kv_quant=gen_cfg.kv_quant, device=self.device)
        if mesh is not None:
            from ..parallel.mesh import shard_slot_state

            self.state = shard_slot_state(self.state, mesh)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.ticks_per_sync = ticks_per_sync
        self.installs_per_tick = installs_per_tick
        # cold-start ramp: after an idle period the first chunks are short,
        # so a fresh request's first frames reach the host in a few ticks
        self.chunk_ramp = tuple(t for t in chunk_ramp if t < ticks_per_sync)
        self._ramp_i = len(self.chunk_ramp)
        # while set, the next chunks are at most this many ticks (TTSServer
        # sets it while a stream awaits its first packet)
        self.tick_cap: Optional[int] = None
        self.pending: deque = deque()
        self.frames_acc: Dict[int, List[np.ndarray]] = {}
        self.req_max_frames: Dict[int, int] = {}
        # staging row -> the request id staged there, until its install is
        # observed (the id disambiguates invalidations of an earlier occupant)
        self.staged_rows_busy: Dict[int, int] = {}
        # rid -> chunks launched when its staging prefill was dispatched: only
        # later chunks can hold its frames
        self._staged_stamp: Dict[int, int] = {}
        self.max_live_t = 0   # host mirror of the largest device t (exact per sync)
        self._zero_rows = None
        self._tts_pad_dev = None
        # launched chunks whose aux is not attributed yet: (aux on the
        # device, its host copy, the copy's event, ticks), synced one chunk
        # behind under load
        self._unprocessed: deque = deque()
        self._ticks_in_flight = 0
        # cancelled ids -> chunks launched at cancel time; late aux of earlier
        # chunks may still name them, so they stay quarantined until synced
        self._cancelled: Dict[int, int] = {}
        self._chunks_launched = 0
        self._chunks_synced = 0
        # requests whose frame budget clamps to zero complete at the next step
        self._instant: List[Completion] = []
        self._instant_ids: set = set()
        # streaming egress hook: frame_sink(request_id, frames (k, Q)) with
        # newly attributed frames, in order, at each aux sync
        self.frame_sink = None
        self.metrics = metrics if metrics is not None else global_metrics()
        # the serving path's spans (`trace_enabled` switches them) and the
        # per-request stamps (submit, staged, first_frame, ...) of requests
        # submitted while it is on
        self.tracer = profiling.Tracer(self.metrics)
        self.trace: Dict[int, Dict[str, float]] = {}
        # the one-tick serve graphs over self.state (a CUDA device)
        self._graphs = (graphs.ServeGraphs(self)
                        if graphs.enabled(self.device) and mesh is None else None)

    @property
    def trace_enabled(self) -> bool:
        """The switch of the per-request stamps and of `tracer`'s spans."""
        return self.tracer.enabled

    @trace_enabled.setter
    def trace_enabled(self, on: bool) -> None:
        self.tracer.enabled = bool(on)

    def stamp(self, rid: int, key: str, now: float) -> None:
        """Stamp `key` of a request stamped at its submit, once; a request
        submitted while the switch was off gets no stamps."""
        entry = self.trace.get(rid)
        if entry is not None:
            entry.setdefault(key, now)

    def submit(self, req: Request) -> None:
        self.metrics.count("engine.submits")
        if (req.request_id in self.frames_acc or req.request_id in self._instant_ids
                or req.request_id in self._cancelled
                or any(p[0] == req.request_id for p in self.pending)):
            raise ValueError(f"request id {req.request_id} already in flight")
        T = req.inputs_embeds.shape[1]
        if T > self.prefill_bucket:
            raise ValueError(f"prompt length {T} exceeds engine prefill_bucket "
                             f"{self.prefill_bucket}")
        e, m, tr = _pad_request(req.inputs_embeds, req.attn_mask, req.trailing,
                                self.prefill_bucket, self.max_trailing, self.dtype)
        if self._tts_pad_dev is None:
            self._tts_pad_dev = req.tts_pad.to(device=self.device, dtype=self.dtype)
        # the budget fits the buffer: a slot's write index prefill_bucket + t
        # stays below max_len (the fused kernel traps on a slot past it)
        mf = min(req.max_frames, self.max_len - self.prefill_bucket - 1)
        if mf <= 0:
            self._instant.append(Completion(
                req.request_id, np.zeros((0, self.cfg.num_code_groups), np.int64)))
            self._instant_ids.add(req.request_id)
            return
        if not self.frames_acc and not self._ticks_in_flight:
            self._ramp_i = 0    # the engine was idle: restart the latency ramp
        sp = req.sampling if req.sampling is not None else self.gen_cfg.sampling
        K = self.gen_cfg.sampling.top_k
        if 0 < K < (sp.top_k if sp.top_k > 0 else self.cfg.vocab_size):
            raise ValueError(f"request top_k={sp.top_k} exceeds the engine's "
                             f"candidate width top_k={K}")
        ssp = req.sub_sampling if req.sub_sampling is not None else self.gen_cfg.subtalker
        if ssp.do_sample and not self.gen_cfg.subtalker.do_sample:
            raise ValueError("request asks for sampled sub-talker codes but the engine "
                             "was built with a greedy gen_cfg.subtalker; construct the "
                             "engine with subtalker do_sample=True to serve it")
        if self.gen_cfg.fused_subtalker:
            if ssp.do_sample and ssp.top_p < 1.0:
                raise ValueError("the fused sub-talker kernel does not support "
                                 f"top_p < 1 (request sub_sampling.top_p={ssp.top_p})")
        else:
            Ks = self.gen_cfg.subtalker.top_k
            cp_v = self.cfg.code_predictor_config.vocab_size
            if ssp.do_sample and 0 < Ks < (ssp.top_k if ssp.top_k > 0 else cp_v):
                raise ValueError(f"request sub-talker top_k={ssp.top_k} exceeds the "
                                 f"engine's candidate width top_k={Ks}")
        if self.trace_enabled:
            self.trace[req.request_id] = {"submit": profiling.clock()}
        self.pending.append((req.request_id, e, m, tr,
                             min(req.trailing_len, self.max_trailing), mf,
                             sp.as_row(), ssp.as_row()))

    def cancel(self, request_id) -> bool:
        """Best-effort cancel: the request never completes and its slot or
        staging row frees at the next chunk. True if the request was known.
        Its id stays unusable until every chunk launched before the cancel
        has synced."""
        n = len(self.pending)
        self.pending = deque(p for p in self.pending if p[0] != request_id)
        if len(self.pending) < n:
            self.trace.pop(request_id, None)
            self.metrics.count("engine.cancels")
            return True
        if request_id in self._instant_ids:
            self._instant = [c for c in self._instant if c.request_id != request_id]
            self._instant_ids.discard(request_id)
            self.trace.pop(request_id, None)
            self.metrics.count("engine.cancels")
            return True
        if request_id not in self.frames_acc:
            return False
        self.trace.pop(request_id, None)
        self.frames_acc.pop(request_id, None)
        self.req_max_frames.pop(request_id, None)
        self._staged_stamp.pop(request_id, None)
        if self._unprocessed:
            self._cancelled[request_id] = self._chunks_launched
        cancel_in_state(self.state, request_id)
        for r in [r for r, rid in self.staged_rows_busy.items() if rid == request_id]:
            del self.staged_rows_busy[r]
        self.metrics.count("engine.cancels")
        return True

    def _stage_pending(self) -> int:
        """Stage as many pending requests as there are free staging rows, in
        batches of at most 16 (power-of-two batch sizes)."""
        total = 0
        while True:
            n = self._stage_batch()
            total += n
            if n == 0:
                return total

    def _stage_batch(self) -> int:
        # under dp, consecutive requests go to the dp shards in turn
        per = self.staging_rows // (self.mesh.dp if self.mesh is not None else 1)
        free_rows = sorted((k for k in range(self.staging_rows)
                            if k not in self.staged_rows_busy), key=lambda k: (k % per, k))
        n = min(len(self.pending), len(free_rows), 16)
        if n == 0:
            return 0
        with self.tracer.span("engine.stage"):
            Nb = 1 << (n - 1).bit_length()
            self.metrics.count("engine.staged_rows", n)
            self.metrics.count("engine.staged_rows_padded", Nb)
            if self._zero_rows is None:
                Lp, H, Tt = self.prefill_bucket, self.cfg.hidden_size, self.max_trailing
                self._zero_rows = (torch.zeros((Lp, H), dtype=self.dtype, device=self.device),
                                   torch.zeros((Lp,), dtype=torch.int32),
                                   torch.zeros((Tt, H), dtype=self.dtype, device=self.device))
            embeds_rows, mask_rows, trailing_rows = [], [], []
            meta = np.zeros((Nb, 5), np.int32)
            srows = np.zeros((Nb, 5), np.float32)
            ssrows = np.zeros((Nb, 5), np.float32)
            now = profiling.clock() if self.trace_enabled else 0.0
            for i in range(Nb):
                if i < n:
                    rid, e, m, tr, tlen, mf, srow, ssrow = self.pending.popleft()
                    meta[i] = (rid, mf, tlen, free_rows[i], 1)
                    srows[i], ssrows[i] = srow, ssrow
                    self.frames_acc[rid] = []
                    self.req_max_frames[rid] = mf
                    self.staged_rows_busy[free_rows[i]] = rid
                    self._staged_stamp[rid] = self._chunks_launched
                    if self.trace_enabled:
                        self.stamp(rid, "staged", now)
                else:
                    e, m, tr = self._zero_rows
                    meta[i] = (-1, 0, 0, 0, 0)
                embeds_rows.append(e)
                mask_rows.append(m)
                trailing_rows.append(tr)
            self._stage(embeds_rows, mask_rows, trailing_rows, meta, self._tts_pad_dev, srows,
                        ssrows)
        return n

    def _stage(self, embeds_rows, mask_rows, trailing_rows, meta: np.ndarray, tts_pad,
               srows: np.ndarray, ssrows: np.ndarray) -> None:
        """The staging prefill of these rows: on a CUDA device one replay of
        the staging graph of len(meta) rows (`ServeGraphs.stage`), else
        `stage_requests` eagerly."""
        with torch.no_grad():
            if self._graphs is not None:
                with self.tracer.device_span("engine.stage", self.device):
                    self._graphs.stage(embeds_rows, mask_rows, trailing_rows, meta, tts_pad,
                                       srows, ssrows, self.generator)
                return
            stage_requests(self.params, self.cfg, self.state, self.gen_cfg,
                           torch.stack(embeds_rows), torch.stack(mask_rows),
                           torch.stack(trailing_rows), meta, tts_pad, self.generator,
                           torch.as_tensor(srows, device=self.device),
                           torch.as_tensor(ssrows, device=self.device), self.mesh)

    def _attend_buckets(self) -> List[int]:
        """Every attend bucket a live engine can ask for: the multiples of
        ATTEND_BUCKET below max_len, then max_len."""
        return list(range(ATTEND_BUCKET, self.max_len, ATTEND_BUCKET)) + [self.max_len]

    def warmup_serve(self, verbose: bool = False) -> float:
        """Capture the serve graph of every attend bucket, with installs and
        without, before traffic (the JAX engine compiles each bucket's
        executable here). Where ticks run eagerly (the CPU, `graphs.eager()`,
        a mesh) there is nothing to capture. Returns its seconds."""
        t0 = _time.time()
        if self._graphs is not None:
            with torch.no_grad():
                for a in self._attend_buckets():
                    for install in (False, True):
                        self._graphs.graph(a, install, self.generator)
                    if verbose:
                        print(f"[engine.warmup] attend={a} captured at "
                              f"{_time.time() - t0:.1f}s", flush=True)
        return _time.time() - t0

    def warmup_staging(self, buckets=(1, 2, 4, 8, 16)) -> None:
        """Run the staging prefill once per request-count bucket up to
        staging_rows, with all-invalid rows (request id -1, valid 0):
        nothing is merged and the slot state is untouched, but the
        prefill's first-use costs are paid: on a CUDA device the staging
        graph of each bucket is captured. Like the JAX engine's, each call
        draws from the engine's generator. Unlike it, the pad embedding the
        engine installs stays the first request's: the JAX engine keeps the
        zero pad it warmed with for every later request."""
        Lp, H, Tt = self.prefill_bucket, self.cfg.hidden_size, self.max_trailing
        for nb in buckets:
            if nb > self.staging_rows:
                continue
            meta = np.zeros((nb, 5), np.int32)
            meta[:, 0] = -1
            rows = np.zeros((nb, 5), np.float32)
            e = torch.zeros((Lp, H), dtype=self.dtype, device=self.device)
            tr = torch.zeros((Tt, H), dtype=self.dtype, device=self.device)
            self._stage([e] * nb, [torch.zeros((Lp,), dtype=torch.int32)] * nb, [tr] * nb,
                        meta, torch.zeros((1, 1, H), dtype=self.dtype, device=self.device),
                        rows, rows)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_ticks(self) -> int:
        """Chunk length: `ticks_per_sync` under queue pressure (after the
        cold-start ramp, within `tick_cap`); once the queue is drained, just
        enough to cover the longest remaining request."""
        ticks = self.ticks_per_sync
        if self._ramp_i < len(self.chunk_ramp):
            ticks = min(ticks, self.chunk_ramp[self._ramp_i])
        if self.tick_cap is not None and self.tick_cap > 0:
            ticks = min(ticks, int(self.tick_cap))
        if self.pending:
            return ticks
        remaining = 0
        for rid, acc in self.frames_acc.items():
            remaining = max(remaining, self.req_max_frames.get(rid, ticks) - len(acc))
        return min(ticks, max(1, remaining + 2))   # + the finish tick + install slack

    def _launch_chunk(self) -> None:
        """Run one serve chunk and queue its aux; the host copy is
        enqueued behind the chunk (pinned, non-blocking) so it overlaps the
        next chunk's launches."""
        with self.tracer.span("engine.launch"):
            ticks = self._next_ticks()
            # the attend bucket must cover the furthest live slot by chunk end;
            # liveness is stale by the ticks in flight, so over-cover
            max_idx = self.prefill_bucket + self.max_live_t + self._ticks_in_flight
            attend = attend_bucket_for(max_idx + ticks + 1, self.max_len)
            install = self.installs_per_tick != 0 and bool(self.staged_rows_busy)
            with torch.no_grad():
                if self._graphs is not None:
                    with self.tracer.device_span("engine.chunk", self.device):
                        aux = self._graphs.chunk(ticks, attend, install, self.generator)
                else:
                    aux = serve_chunk(self.params, self.cfg, self.state, self.gen_cfg,
                                      self.generator, ticks, self.ticks_per_sync,
                                      attend_len=attend, install=install, mesh=self.mesh)
            event = None
            if aux.is_cuda:
                host = torch.empty(aux.shape, dtype=aux.dtype, pin_memory=True)
                host.copy_(aux, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = aux
            self._ramp_i = min(self._ramp_i + 1, len(self.chunk_ramp))
            self._chunks_launched += 1
            self._unprocessed.append((aux, host, event, ticks))
            self._ticks_in_flight += ticks
            self.metrics.count("engine.chunks")
            self.metrics.count("engine.ticks", ticks)

    def _process_oldest(self) -> List[Completion]:
        """Sync the oldest in-flight chunk's aux and attribute its frames."""
        if not self._unprocessed:
            return []
        _, host, event, ticks = self._unprocessed.popleft()
        self._ticks_in_flight -= ticks
        with self.tracer.span("engine.aux_wait"):
            if event is not None:
                event.synchronize()
            aux_np = host.numpy()
        with self.tracer.span("engine.attribute"):
            (frames, emit, req_id, finished, staged_valid, staged_rid,
             t_dev) = unpack_chunk_aux(aux_np, self.num_slots, self.ticks_per_sync,
                                       self.cfg.num_code_groups, self.staging_rows)
            completions: List[Completion] = []
            sink_frames: Dict[int, List[np.ndarray]] = {}
            now = profiling.clock() if self.trace_enabled else 0.0
            # attribute in tick order so slot reuse within a chunk stays coherent
            order = np.argwhere(emit | finished)
            for slot, t in sorted(order.tolist(), key=lambda st: (st[1], st[0])):
                rid = int(req_id[slot, t])
                if rid in self._cancelled:   # late aux of a pre-cancel chunk
                    continue
                if emit[slot, t]:
                    if self.trace_enabled and not self.frames_acc.get(rid):
                        self.stamp(rid, "first_frame", now)
                    self.frames_acc[rid].append(frames[slot, t])
                    if self.frame_sink is not None:
                        sink_frames.setdefault(rid, []).append(frames[slot, t])
                if finished[slot, t]:
                    acc = self.frames_acc.pop(rid, [])
                    self.req_max_frames.pop(rid, None)
                    self._staged_stamp.pop(rid, None)
                    codes = (np.stack(acc) if acc
                             else np.zeros((0, self.cfg.num_code_groups), np.int64))
                    completions.append(Completion(rid, codes))
            if self.frame_sink is not None:
                for rid, fl in sink_frames.items():
                    self.frame_sink(rid, np.stack(fl))
            # free staging rows the chunk installed: only when it names OUR
            # occupant (an older chunk reports a previous one, or -1)
            for r in [r for r, rid in self.staged_rows_busy.items()
                      if not staged_valid[r] and staged_rid[r] == rid]:
                del self.staged_rows_busy[r]
            self.max_live_t = int(t_dev.max()) if self.frames_acc else 0
            self._chunks_synced += 1
            self._cancelled = {r: s for r, s in self._cancelled.items()
                               if s > self._chunks_synced}
            self.metrics.count("engine.frames", float(emit.sum()))
            self.metrics.count("engine.completions", len(completions))
            return completions

    def oldest_chunk_may_contain(self, request_id) -> bool:
        """True if the oldest in-flight chunk launched after the request's
        staging prefill, so it can hold the request's frames."""
        if not self._unprocessed:
            return False
        return self._staged_stamp.get(request_id, self._chunks_launched + 1) \
            <= self._chunks_synced

    def _remaining_upper(self) -> int:
        """Upper bound on frames still to generate across live requests."""
        return sum(max(0, self.req_max_frames.get(r, 1) - len(a))
                   for r, a in self.frames_acc.items())

    def step(self) -> List[Completion]:
        """Stage pending requests, launch one chunk, and collect finished
        requests. Under load one chunk's aux stays in flight, so its copy
        overlaps the next chunk; at the tail every aux syncs at once. Device
        spans whose events have completed are resolved first."""
        self.tracer.resolve()
        completions: List[Completion] = list(self._instant)
        self._instant.clear()
        self._instant_ids.clear()
        if self._stage_pending() == 0 and self.pending and self._unprocessed:
            # staging waits on rows whose release is not observed yet
            completions += self._process_oldest()
            self._stage_pending()
        if not self.frames_acc:
            while self._unprocessed:
                completions += self._process_oldest()
            return completions
        if self._remaining_upper() > self._ticks_in_flight * self.num_slots:
            self._launch_chunk()
            while len(self._unprocessed) > 1:
                completions += self._process_oldest()
        else:
            while self._unprocessed:
                completions += self._process_oldest()
        return completions

    def stage_now(self) -> int:
        """Dispatch staging prefills for pending requests now (a latency
        caller about to block on in-flight aux)."""
        return self._stage_pending()

    def sync_in_flight(self) -> List[Completion]:
        """Sync every in-flight chunk's aux now."""
        out: List[Completion] = []
        while self._unprocessed:
            out.extend(self._process_oldest())
        return out

    def run_until_drained(self, max_ticks: int = 100000) -> List[Completion]:
        out: List[Completion] = []
        for _ in range(max_ticks):
            out.extend(self.step())
            if not self.pending and not self.frames_acc:
                break
        while self._unprocessed:
            out.extend(self._process_oldest())
        return out
