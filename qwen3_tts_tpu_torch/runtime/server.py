"""Text-in, audio-out serving over the continuous-batching engine
(counterpart of `qwen3_tts_tpu/runtime/server.py`):

  text request -> build_prompt -> engine (staged prefill, slot decode)
       -> frame_sink -> per-request code history -> batched chunk vocoder
       -> AudioPacket stream / AudioResult

- Packet egress: every due streaming request becomes a row of a wave of
  vocoder calls, (rows, Q, T); a row's context c = min(25, frames already
  decoded) leads, its new frames follow, the tail is zero. New frames
  bucket to F in {4, packet_frames}. The vocoder is causal, so a call
  computes only what its rows deliver: T = F where none of its rows has
  context (first packets), else left_context + F; and a wave of n rows is
  cut into row-bucket pieces (13 rows: 8 + 4 + 1) unless one call padded
  to the next bucket costs less card time (`_row_pieces`).
- Packets are cut every `packet_frames` frames, with an early first packet
  per request; completions flush the rest. While a stream awaits its first
  packet, engine chunks are capped at `first_packet_ticks` ticks, the step
  runs in latency order, other streams' bulk egress is deferred, and first
  packets vocode straight from the in-flight chunk's aux on the device.
- Voice-clone requests carry their reference codes as their own vocoder
  left context; non-streaming clones decode with the reference codes
  prepended and the same share of samples cut off the front.
- On a CUDA device every vocoder call (egress, first packet, completion
  decode) is one replay of a captured graph (`runtime/graphs.py`
  `CodecGraphs`), and `warmup()` captures every graph the server can ask
  for, the engine's serve ticks among them, before traffic arrives.
- `vocoder_device` dedicates another device to the vocoder (packet egress,
  the completion decode and their warm-up), on a copy of the decoder params:
  a second card, whose queue vocodes while the serving card's runs talker
  ticks, or the CPU. First packets then vocode from the host's frames like
  any packet (the chunk aux lies on the serving card).
- Tracing (the engine's `trace_enabled`, the one switch): host spans
  `server.step`, inside it `server.fast_first` (its dispatch, then its
  packets' emission, with its child `server.fast_first_wait`, the blocking
  copies of its counts and samples) and `server.egress` (with its child
  `server.egress_wait`, the wav's copy to the host), and `server.submit`
  a request, carrying its id; device spans `server.vocode` (each egress
  replay, on the vocoder device's stream where there is one) and
  `server.fast_first` (each first-packet replay); the per-request stamp
  `first_packet`. `trace_spans()` pops the recorded host spans and
  `first_packet_trace()` a request's stamps. Work counters, always on:
  `server.vocode_frames_delivered` (the frames of every packet),
  `server.vocode_frames_computed` (rows x frames of every vocoder call,
  padding rows and left context included) and `server.vocode_calls` (the
  egress and first-packet vocoder calls).

`ThreadedTTSServer` is the thread-safe wrapper for HTTP handlers: producer
threads submit and wait on per-request queues, one loop thread owns the
server, and with it every CUDA operation, graph capture and replay.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..inference.tokenizer import resolve_device
from ..models.codec12.decoder import cut_rows, vocode_rows
from ..utils import profiling
from ..weights import map_tensors
from . import graphs
from .batching import ContinuousBatchingEngine, Request
from .generate import GenerationConfig


# the largest completion-decode batch `TTSServer.warmup` captures: at the
# default 300-frame chunk one fp32 activation of the vocoder's last block
# takes ~0.24 GB a row, so larger batches, met only when more than 16
# non-streamed requests finish in one step, are captured at first use
WARM_DECODE_ROWS = 16
# stamps of finished requests that `first_packet_trace` has not popped yet
# (a stream whose first packet was also its last), oldest dropped first
MAX_FINISHED_TRACES = 4096
# the card time of one egress or first-packet vocoder replay of N rows of T
# frames, as REPLAY_FLOOR_MS + FRAME_ROW_MS * N * T: what `_row_pieces`
# weighs a padding row against one more replay with (a fit to replays of
# N in 1-32 and T in {4, 25, 29, 50} on an H100 80GB HBM3 at 700 W, fp32
# vocoder at the published widths: 5.26 ms at N=1, T=4, 15.69 at N=1,
# T=50, 335.69 at N=32, T=50)
REPLAY_FLOOR_MS = 4.4
FRAME_ROW_MS = 0.21


@dataclass
class AudioPacket:
    """One streamed audio chunk of one request."""

    request_id: Any
    wav: np.ndarray        # (samples,) float32, or int16
    sample_rate: int
    frame_start: int       # first generated-frame index covered
    frame_count: int
    final: bool            # True on the request's last packet


@dataclass
class AudioResult:
    """The whole synthesis of a non-streaming request."""

    request_id: Any
    wav: np.ndarray        # (samples,) float32, or int16
    sample_rate: int


@dataclass
class _ReqState:
    request_id: Any
    stream: bool
    # code history ((Q,) frames): ctx0 reference frames, then generated ones
    history: List[np.ndarray] = field(default_factory=list)
    ctx0: int = 0
    emitted: int = 0          # generated frames already sent as packets
    ref_code: Optional[np.ndarray] = None   # all reference codes (clone decode)
    done: bool = False
    first_sent: bool = False


def _bucket_request(prompt: torch.Tensor, trailing: torch.Tensor, bucket: int = 16):
    """Left-pad a (1, T, H) prompt and right-pad a (1, Tt, H) trailing text to
    length buckets, with the prompt's attention mask, on the host (the
    engine masks the padding, takes rope positions from the mask and builds
    the staging prefill's flash plan from it)."""
    T, Tt = prompt.shape[1], trailing.shape[1]
    L = -(-T // bucket) * bucket
    Tb = -(-Tt // bucket) * bucket
    mask = torch.zeros((1, L), dtype=torch.int32)
    mask[0, L - T:] = 1
    return (F.pad(prompt, (0, 0, L - T, 0)), mask, F.pad(trailing, (0, 0, 0, Tb - Tt)))


def _first_packet_extract(aux: torch.Tensor, rids: torch.Tensor, B: int, ticks: int,
                          Q: int, F_: int, T: int):
    """Each waiting request's first frames out of a chunk aux that is still
    on the device (serve_chunk's packed layout). A request holds one slot for
    the whole chunk and emits contiguous ticks, so its frames are
    frames[slot, t0:t0 + count]. Returns (codes (N, Q, T), rows laid out as
    a context-free first packet, and counts (N,) clamped to F_; 0: nothing
    for that request in this chunk)."""
    n_bt = B * ticks
    frames = aux[:n_bt * Q].reshape(B, ticks, Q)
    emit = aux[n_bt * Q:n_bt * Q + n_bt].reshape(B, ticks) != 0
    req_id = aux[n_bt * Q + n_bt:n_bt * Q + 2 * n_bt].reshape(B, ticks)
    m = (req_id[None] == rids[:, None, None]) & emit[None]      # (N, B, ticks)
    slot = m.any(-1).to(torch.int32).argmax(dim=1)             # (N,)
    mt = m[torch.arange(len(rids), device=aux.device), slot]   # (N, ticks)
    t0 = mt.to(torch.int32).argmax(dim=1)
    count = torch.clamp(mt.sum(dim=1), max=F_).to(torch.int32)
    idx = torch.clamp(t0[:, None] + torch.arange(F_, device=aux.device), max=ticks - 1)
    sel = torch.gather(frames[slot], 1, idx[:, :, None].expand(-1, -1, Q))   # (N, F_, Q)
    sel = torch.where(torch.arange(F_, device=aux.device)[None, :, None]
                      < count[:, None, None], sel, 0)
    codes = torch.zeros((len(rids), Q, T), dtype=torch.int32, device=aux.device)
    codes[:, :, :F_] = sel.transpose(1, 2)
    return codes, count


# packet egress, (N, Q, C + F_) codes and (N,) contexts on the host or the
# device: the JAX package's name for `vocode_rows`
_vocode_rows_compact = vocode_rows


def _first_packet_vocode(dec_params, cfg, aux: torch.Tensor, rids: torch.Tensor, B: int,
                         ticks: int, Q: int, F_: int, T: int, pcm16: bool = False):
    """`_first_packet_extract`, then its rows vocoded with no context
    (`cut_rows`): (wav (N, F_*up), counts (N,)). On a CUDA device one replay
    of the graph of (B, ticks, Q, F_, T, N, pcm16), which reads the chunk's
    aux through a static buffer filled by a device copy."""
    def body(aux, rids):
        codes, counts = _first_packet_extract(aux, rids, B, ticks, Q, F_, T)
        return cut_rows(dec_params, cfg, codes, torch.zeros_like(counts), F_, pcm16), counts

    return graphs.codec_call(dec_params, cfg, "extract+rows", (B, ticks, Q, F_, T), pcm16,
                             body, aux, rids)


class TTSServer:
    """Single-threaded text-level server: submit_* then step() /
    run_until_drained(). Built from a loaded `Qwen3TTSModel` whose speech
    tokenizer carries the 12 Hz vocoder; runs on the model's device.

    `vocoder_device` (a `torch.device`, a string, or an int: `cuda:N`):
    the device of every vocoder call (packet egress, the completion decode
    and their warm-up), on a copy of the decoder params made once here; the
    model's tokenizer keeps its own. A second card's queue then vocodes
    while the serving card's runs talker ticks; the codes are the same, and
    the audio too wherever the two devices compute the vocoder alike (the
    CPU's convolutions sum in another order than the card's). With it,
    `fast_first_packet` is off, as in the JAX package: the chunk aux it
    reads lies on the serving card."""

    def __init__(self, model, num_slots: int = 16, max_new_tokens: Optional[int] = None,
                 prefill_bucket: int = 128, max_trailing: int = 512,
                 packet_frames: int = 25, left_context: int = 25,
                 ticks_per_sync: int = 8, first_packet_ticks: int = 4, seed: int = 0,
                 overrides: Optional[Dict[str, Any]] = None, metrics=None,
                 output_dtype: str = "float32", vocoder_device=None,
                 fast_first_packet: bool = True, defer_bulk_egress: bool = True,
                 code_sink=None, **engine_kwargs):
        tok = model.speech_tokenizer
        if tok is None or tok.dec_params is None:
            raise RuntimeError("TTSServer requires a loaded 12Hz speech tokenizer (vocoder)")
        self.model = model
        kw = model._merge_generate_kwargs(**(overrides or {}))
        if max_new_tokens is not None:
            kw["max_new_tokens"] = max_new_tokens
        # The serve step is the model's own default (kernel 2 on an int8
        # load on CUDA) unless `overrides` names fused_talker_step. The JAX
        # package serves the plain route unless asked, from a first-packet
        # measurement on its TPU; on the H100 the fused route won both
        # requests/s and first-packet p50 (chip_smoke.py's serve-route A/B),
        # so the port departs from that rule.
        self.gen_cfg: GenerationConfig = model._generation_config(kw)
        self.dec_params = tok.dec_params
        self._decode_tok = tok
        self.vocoder_device = None
        if vocoder_device is not None:
            dev = resolve_device(torch.device("cuda", vocoder_device)
                                 if isinstance(vocoder_device, int) else vocoder_device)
            self.vocoder_device = dev
            self.dec_params = map_tensors(tok.dec_params, lambda t: t.to(dev))
            # the tokenizer's decode runs on its dec_params' device
            self._decode_tok = copy.copy(tok)
            self._decode_tok.dec_params = self.dec_params
        self.dec_cfg = tok.config.decoder_config
        self.sample_rate = tok.get_output_sample_rate()
        self.up = int(self.dec_cfg.total_upsample)
        self.packet_frames = int(packet_frames)
        self.left_context = int(left_context)
        # while a stream awaits its first packet, engine chunks are capped at
        # this many ticks (0: pure-throughput serving)
        self.first_packet_ticks = int(first_packet_ticks)
        # first packets vocode from the in-flight chunk's on-device aux, which
        # lies on the serving card: off with a vocoder device of its own
        self.fast_first_packet = bool(fast_first_packet) and self.vocoder_device is None
        # while a first packet is pending, steady streams' packets wait
        # (unless their backlog passes 3 * packet_frames)
        self.defer_bulk_egress = bool(defer_bulk_egress)
        self._defer_now = False
        self.num_slots = num_slots
        if output_dtype not in ("float32", "int16"):
            raise ValueError(f"unsupported output_dtype {output_dtype!r}")
        self.output_dtype = output_dtype
        max_len = prefill_bucket + self.gen_cfg.max_new_tokens + 8
        self.engine = ContinuousBatchingEngine(
            model.talker_params, model.config.talker_config, self.gen_cfg,
            num_slots=num_slots, max_len=max_len, max_trailing=max_trailing,
            dtype=model.talker_params["codec_embedding"].dtype, seed=seed,
            ticks_per_sync=ticks_per_sync, prefill_bucket=prefill_bucket,
            metrics=metrics, **engine_kwargs)
        self.engine.frame_sink = self._on_frames
        # code_sink(request_id, frames (k, Q) int32): each request's newly
        # generated codec frames, in order, as they reach the host
        self.code_sink = code_sink
        self.metrics = self.engine.metrics
        self.tracer = self.engine.tracer
        self._states: Dict[int, _ReqState] = {}
        self._by_user_id: Dict[Any, int] = {}
        # user request id -> stamps, of finished streams (first_packet_trace)
        self._finished_traces: "OrderedDict[Any, Dict[str, float]]" = OrderedDict()
        self._next_rid = 0
        self._Q = model.config.talker_config.num_code_groups

    # -- warm-up ---------------------------------------------------------

    def egress_shapes(self) -> List[tuple]:
        """(rows, frames vocoded, frames cut) = (N, T, F) of every
        packet-egress vocoder call: the row buckets (`_row_buckets`) times
        the frame buckets F in {_frame_bucket(1), _frame_bucket(packet_frames)},
        each at T = F (no row has context) and T = left_context + F."""
        frames = sorted({self._frame_bucket(1), self._frame_bucket(self.packet_frames)})
        return [(n, t, f) for n in self._row_buckets() for f in frames
                for t in sorted({f, self.left_context + f})]

    def first_packet_shapes(self) -> List[tuple]:
        """(N, T, F) of every fast-first-packet vocoder call: the row
        buckets at T = F = _frame_bucket(1) (its rows have no context)."""
        f = self._frame_bucket(1)
        return [(n, f, f) for n in self._row_buckets()]

    def warmup(self, verbose: bool = False) -> float:
        """Pay the serving path's first-use costs before live traffic does
        (the JAX package's `TTSServer.warmup`, in its order): every serve
        tick graph (`engine.warmup_serve`), the staging prefill of each
        request-count bucket (`engine.warmup_staging`), the egress vocoder
        of every `egress_shapes()` entry and, with `fast_first_packet`, the
        first-packet extract of every `first_packet_shapes()` entry; then,
        where the JAX server leaves it to the first completion, the
        completion decode of every power-of-two batch up to num_slots (at
        most WARM_DECODE_ROWS) at both chunk shapes; for a clone (base) model on a CUDA device, the clone
        front end's encode of one reference at each of `reference_lengths()`
        (the JAX server leaves it to the first request). On a CUDA device
        each of these is captured as a graph, so that traffic captures none
        (a capture at a live tick stalls every slot: a submit replays the
        front end's graphs and captures none, `graphs.replay_only`); on the
        CPU the same calls run eagerly and capture nothing, and the encode
        is not warmed. The egress and completion-decode calls run on the
        vocoder device (the first-packet extract is off there), which ends
        synchronised with the serving card.
        Call it on the thread that drives the server: a `ThreadedTTSServer`'s
        loop thread owns all CUDA work, so warm the `TTSServer` before
        wrapping it. Returns its seconds."""
        t0 = time.time()
        self.engine.warmup_serve(verbose=verbose)
        self.engine.warmup_staging()
        pcm16 = self.output_dtype == "int16"
        Q = self._Q
        with torch.no_grad():
            for N, T, F_ in self.egress_shapes():
                _vocode_rows_compact(self.dec_params, self.dec_cfg,
                                     torch.zeros((N, Q, T), dtype=torch.int32),
                                     torch.zeros((N,), dtype=torch.int32), F_, pcm16=pcm16)
                if verbose:
                    print(f"[server.warmup] vocode N={N} T={T} F={F_} done at "
                          f"{time.time() - t0:.1f}s", flush=True)
            if self.fast_first_packet:
                eng = self.engine
                B, ticks, K = eng.num_slots, eng.ticks_per_sync, eng.staging_rows
                n_bt = B * ticks
                aux = torch.zeros((n_bt * Q + 3 * n_bt + 2 * K + B,), dtype=torch.int32,
                                  device=eng.device)
                for N, T, F_ in self.first_packet_shapes():
                    _first_packet_vocode(self.dec_params, self.dec_cfg, aux,
                                         torch.full((N,), -1, dtype=torch.int32), B, ticks,
                                         Q, F_, T, pcm16=pcm16)
        tok = self.model.speech_tokenizer
        frames = np.zeros((tok.chunk_size + 1, Q), np.int64)   # the first and a steady chunk
        nb = 1
        while True:
            self._decode_tok.decode([{"audio_codes": frames}] * nb,
                                    output_dtype=self.output_dtype)
            if verbose:
                print(f"[server.warmup] decode batch {nb} done at {time.time() - t0:.1f}s",
                      flush=True)
            if nb >= min(self.num_slots, WARM_DECODE_ROWS):
                break
            nb <<= 1
        if (self.model.tts_model_type == "base" and getattr(tok, "enc_params", None) is not None
                and graphs.enabled(graphs.params_device(tok.enc_params))):
            sr = tok.get_input_sample_rate()
            for n in self.reference_lengths():
                clip = (np.zeros(n, np.float32), sr)
                tok.encode(clip)    # a front-end key's first call runs eagerly,
                tok.encode(clip)    # its second captures
            if verbose:
                print(f"[server.warmup] encode of {len(self.reference_lengths())} reference "
                      f"buckets done at {time.time() - t0:.1f}s", flush=True)
        for dev in (self.engine.device, self.vocoder_device):
            if dev is not None and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.time() - t0

    def reference_lengths(self) -> List[int]:
        """The padded sample counts of one reference clip whose frames fit
        this server's prefill bucket: one per 8-frame encode bucket, at
        most MAX_ENCODE_GRAPHS (a longer clip's encode runs eagerly)."""
        bucket = 8 * self.model.speech_tokenizer.get_encode_downsample_rate()
        n = min(-(-self.engine.prefill_bucket // 8), graphs.MAX_ENCODE_GRAPHS)
        return [k * bucket for k in range(1, n + 1)]

    # -- submission ------------------------------------------------------

    @staticmethod
    def _override(base, temperature=None, top_p=None, repetition_penalty=None,
                  do_sample=None, top_k=None):
        if all(v is None for v in (temperature, top_p, repetition_penalty, do_sample,
                                   top_k)):
            return None
        return dataclasses.replace(
            base,
            temperature=base.temperature if temperature is None else float(temperature),
            top_p=base.top_p if top_p is None else float(top_p),
            repetition_penalty=(base.repetition_penalty if repetition_penalty is None
                                else float(repetition_penalty)),
            do_sample=base.do_sample if do_sample is None else bool(do_sample),
            top_k=base.top_k if top_k is None else int(top_k))

    def _sampling_overrides(self, **kw):
        """Per-request sampling kwargs split into talker and sub-talker
        (`subtalker_` prefix) overrides of the engine's defaults."""
        sub_kw = {k[len("subtalker_"):]: v for k, v in kw.items()
                  if k.startswith("subtalker_")}
        talker_kw = {k: v for k, v in kw.items() if not k.startswith("subtalker_")}
        return (self._override(self.gen_cfg.sampling, **talker_kw),
                self._override(self.gen_cfg.subtalker, **sub_kw))

    def _submit_specs(self, request_id, specs, stream: bool,
                      ref_code: Optional[np.ndarray], max_frames: Optional[int],
                      sampling=None, sub_sampling=None) -> None:
        from .prompts import build_prompt

        if request_id in self._by_user_id:
            raise ValueError(f"request id {request_id!r} already in flight")
        (spec,) = specs
        with torch.no_grad():
            prompt, trailing, pad = build_prompt(
                self.model.talker_params, self.model.config.talker_config,
                self.model.config, spec)
        trailing_len = trailing.shape[1]
        if trailing_len > self.engine.max_trailing:
            # the engine would switch to tts_pad early and drop the tail
            raise ValueError(
                f"text trailing length {trailing_len} exceeds the server's "
                f"max_trailing {self.engine.max_trailing}; raise max_trailing or "
                "split the text")
        prompt, attn_mask, trailing = _bucket_request(prompt, trailing, bucket=16)
        rid = self._next_rid
        self._next_rid += 1
        st = _ReqState(request_id=request_id, stream=stream, ref_code=ref_code)
        if stream and ref_code is not None and len(ref_code):
            st.history = list(np.asarray(ref_code[-self.left_context:], np.int32))
            st.ctx0 = len(st.history)
        mf = self.gen_cfg.max_new_tokens - 1
        if max_frames is not None:
            mf = min(mf, int(max_frames))
        # the engine may reject the request: record server state after
        self.engine.submit(Request(
            request_id=rid, inputs_embeds=prompt, attn_mask=attn_mask,
            trailing=trailing, trailing_len=trailing_len, tts_pad=pad,
            max_frames=mf, sampling=sampling, sub_sampling=sub_sampling))
        self._states[rid] = st
        self._by_user_id[request_id] = rid
        self.metrics.count("server.submits")

    def submit_custom_voice(self, request_id, text: str, speaker: str,
                            language: Optional[str] = None,
                            instruct: Optional[str] = None, stream: bool = False,
                            max_frames: Optional[int] = None, **sampling_kw) -> None:
        with self.tracer.span("server.submit", request_id):
            specs = self.model._specs_custom_voice(text, speaker, language, instruct,
                                                   non_streaming=False)
            self._submit_specs(request_id, specs, stream, None, max_frames,
                               *self._sampling_overrides(**sampling_kw))

    def submit_voice_design(self, request_id, text: str, instruct: str,
                            language: Optional[str] = None, stream: bool = False,
                            max_frames: Optional[int] = None, **sampling_kw) -> None:
        with self.tracer.span("server.submit", request_id):
            specs = self.model._specs_voice_design(text, instruct, language,
                                                   non_streaming=False)
            self._submit_specs(request_id, specs, stream, None, max_frames,
                               *self._sampling_overrides(**sampling_kw))

    def submit_voice_clone(self, request_id, text: str, language: Optional[str] = None,
                           ref_audio=None, ref_text: Optional[str] = None,
                           x_vector_only_mode: bool = False, voice_clone_prompt=None,
                           stream: bool = False, max_frames: Optional[int] = None,
                           **sampling_kw) -> None:
        with self.tracer.span("server.submit", request_id):
            with graphs.replay_only():   # no capture at a live tick
                specs, items = self.model._specs_voice_clone(
                    text, language, ref_audio, ref_text, x_vector_only_mode,
                    voice_clone_prompt, non_streaming=False)
            ref_code = items[0].ref_code
            self._submit_specs(request_id, specs, stream,
                               None if ref_code is None else np.asarray(ref_code),
                               max_frames, *self._sampling_overrides(**sampling_kw))

    def abort_all(self) -> None:
        """Drop every in-flight request, engine and server bookkeeping both
        (after a failed step: `busy` would otherwise stay True)."""
        for rid in list(self._states):
            try:
                self.engine.cancel(rid)
            except Exception:
                pass    # the engine may itself be broken; the state still clears
        self._states.clear()
        self._by_user_id.clear()

    def cancel(self, request_id) -> bool:
        """Cancel an in-flight request: it yields nothing further and its
        slot or staging row frees at the next chunk. True if it was known."""
        rid = self._by_user_id.pop(request_id, None)
        if rid is None:
            return False
        self.engine.cancel(rid)
        self._states.pop(rid, None)
        self.metrics.count("server.cancels")
        return True

    def _forget(self, request_id) -> None:
        """Drop a finished request's state. Its stamps move to
        `_finished_traces` where it has a first packet, for
        `first_packet_trace` (a stream whose first packet is its last), and
        go otherwise."""
        rid = self._by_user_id.pop(request_id)
        del self._states[rid]
        entry = self.engine.trace.pop(rid, None)
        if entry is not None and "first_packet" in entry:
            self._finished_traces[request_id] = entry
            while len(self._finished_traces) > MAX_FINISHED_TRACES:
                self._finished_traces.popitem(last=False)

    # -- egress ----------------------------------------------------------

    def _on_frames(self, rid: int, frames: np.ndarray) -> None:
        st = self._states.get(rid)
        if st is not None:
            frames = frames.astype(np.int32)
            st.history.extend(frames)
            if self.code_sink is not None:
                self.code_sink(st.request_id, frames)

    def _pending(self, st: _ReqState) -> int:
        return len(st.history) - st.ctx0 - st.emitted

    def _due(self, st: _ReqState) -> bool:
        if not st.stream:
            return False
        if self._defer_now and st.first_sent:
            # first packets are pending: steady (and finished) streams wait
            # unless their backlog outgrows the bound
            return self._pending(st) >= 3 * self.packet_frames
        if st.done:
            return True     # the remainder (possibly an empty final packet)
        p = self._pending(st)
        if p <= 0:
            return False
        return not st.first_sent or p >= self.packet_frames

    def _row_bucket(self, n: int) -> int:
        return min(1 << max(0, n - 1).bit_length(), self.num_slots)

    def _row_buckets(self) -> List[int]:
        """The row counts a vocoder call may have: the powers of two below
        num_slots, then num_slots."""
        return sorted({self._row_bucket(n) for n in range(1, self.num_slots + 1)})

    def _row_pieces(self, n: int, T: int) -> List[int]:
        """The row counts of the vocoder calls of a wave of n <= num_slots
        rows of T frames: the greatest row bucket at or below the rows left,
        repeated, so that no row is padding (13: 8 + 4 + 1); or one call of
        `_row_bucket(n)` rows where its padding rows cost less card time
        than the split's further replays (REPLAY_FLOOR_MS, FRAME_ROW_MS)."""
        split, left = [], n
        while left:
            b = self.num_slots if left >= self.num_slots else 1 << (left.bit_length() - 1)
            split.append(b)
            left -= b
        pad = self._row_bucket(n) - n
        if pad * FRAME_ROW_MS * T < (len(split) - 1) * REPLAY_FLOOR_MS:
            return [self._row_bucket(n)]
        return split

    def _frame_bucket(self, kmax: int) -> int:
        small = min(4, self.packet_frames)
        return small if kmax <= small else self.packet_frames

    def _to_host(self, wav: torch.Tensor) -> np.ndarray:
        wav = wav.cpu().numpy()
        return wav.astype(np.float32) if self.output_dtype == "float32" else wav

    def _vocode_wave(self, batch: np.ndarray, ctx: np.ndarray, F_: int) -> torch.Tensor:
        """A wave's rows, codes (n, Q, left_context + F_) with a zero tail and
        contexts (n,), vocoded in `_row_pieces` calls, each of T = F_ frames
        where none of its rows has context, else left_context + F_; returns
        (n, F_ * up) samples on the vocoder's device. On a CUDA vocoder
        device each piece's codes and contexts go from pinned memory into
        its graph's static buffers, the replay and the copy of its output
        follow them, all on that device's current stream, and nothing here
        waits: the caller's copy to the host is the wave's one sync, and it
        waits for that stream alone (on a card of its own, no tick the
        serving card has queued waits for the vocoder)."""
        n, lc = len(batch), self.left_context
        pieces = self._row_pieces(n, F_ + (lc if ctx.any() else 0))
        out, lo = [], 0
        for N in pieces:
            T = F_ + (lc if ctx[lo:lo + N].any() else 0)
            codes = np.zeros((N, self._Q, T), np.int32)
            c = np.zeros((N,), np.int32)
            rows = batch[lo:lo + N, :, :T]
            codes[:len(rows)], c[:len(rows)] = rows, ctx[lo:lo + N]
            with torch.no_grad(), self.tracer.device_span(
                    "server.vocode", self.vocoder_device or self.engine.device):
                out.append(_vocode_rows_compact(
                    self.dec_params, self.dec_cfg, torch.from_numpy(codes), torch.from_numpy(c),
                    F_, pcm16=self.output_dtype == "int16"))
            self.metrics.count("server.vocode_frames_computed", N * T)
            self.metrics.count("server.vocode_calls")
            lo += N
        return torch.cat(out)[:n]

    def _emit_packets(self) -> List[AudioPacket]:
        """Vocode every due stream, a wave of at most num_slots rows at a
        time (`_vocode_wave`), one host wait a wave."""
        with self.tracer.span("server.egress"):
            out: List[AudioPacket] = []
            while True:
                due = [st for st in self._states.values() if self._due(st)][:self.num_slots]
                if not due:
                    return out
                meta = []
                for st in due:
                    c = min(self.left_context, st.ctx0 + st.emitted)
                    meta.append((st, c, min(self._pending(st), self.packet_frames)))
                F_ = self._frame_bucket(max([1] + [k for _, _, k in meta]))
                batch = np.zeros((len(due), self._Q, self.left_context + F_), np.int32)
                ctx = np.zeros((len(due),), np.int32)
                for i, (st, c, k) in enumerate(meta):
                    lo = st.ctx0 + st.emitted - c
                    if c + k > 0:
                        batch[i, :, :c + k] = np.stack(st.history[lo:lo + c + k]).T
                    ctx[i] = c
                wav = self._vocode_wave(batch, ctx, F_)
                with self.tracer.span("server.egress_wait"):
                    wav = self._to_host(wav)
                now = None
                for i, (st, c, k) in enumerate(meta):
                    final = st.done and self._pending(st) == k
                    out.append(AudioPacket(request_id=st.request_id, wav=wav[i, :k * self.up],
                                           sample_rate=self.sample_rate,
                                           frame_start=st.emitted, frame_count=k, final=final))
                    st.emitted += k
                    if not st.first_sent and self.engine.trace_enabled:
                        now = now or profiling.clock()
                        self.engine.stamp(self._by_user_id[st.request_id], "first_packet", now)
                    st.first_sent = True
                    self.metrics.count("server.packets")
                    self.metrics.count("server.vocode_frames_delivered", k)
                for st, _, _ in meta:
                    if st.done and self._pending(st) == 0:
                        self._forget(st.request_id)

    def _dispatch_fast_first(self, waiting_rids):
        """Extract first frames from the oldest in-flight chunk's aux and
        vocode them, all on the device, in `_row_pieces` calls of F_ frames
        (the rows have no context; a padding row's rid is -1, which finds
        nothing); returns (rids, wav, counts), nothing waited for."""
        aux = self.engine._unprocessed[0][0]
        rids = waiting_rids[:self.num_slots]
        F_ = self._frame_bucket(1)
        wavs, counts, lo = [], [], 0
        for N in self._row_pieces(len(rids), F_):
            arr = np.full((N,), -1, np.int32)
            part = rids[lo:lo + N]
            arr[:len(part)] = part
            with torch.no_grad(), self.tracer.device_span("server.fast_first",
                                                          self.engine.device):
                wav, count = _first_packet_vocode(
                    self.dec_params, self.dec_cfg, aux, torch.from_numpy(arr),
                    self.engine.num_slots, self.engine.ticks_per_sync, self._Q, F_, F_,
                    pcm16=self.output_dtype == "int16")
            wavs.append(wav)
            counts.append(count)
            self.metrics.count("server.vocode_frames_computed", N * F_)
            self.metrics.count("server.vocode_calls")
            lo += N
        return rids, torch.cat(wavs), torch.cat(counts)

    def _emit_fast_first(self, rids, wav_dev, counts_dev) -> List[AudioPacket]:
        """Emit the fast-path first packets, after the aux sync (so done
        flags and histories are current)."""
        out: List[AudioPacket] = []
        with self.tracer.span("server.fast_first_wait"):
            counts = counts_dev.cpu().numpy()
        wav = None
        for j, rid in enumerate(rids):
            st = self._states.get(rid)
            k = int(counts[j])
            if st is None or st.first_sent or k <= 0:
                continue
            if wav is None:
                with self.tracer.span("server.fast_first_wait"):
                    wav = self._to_host(wav_dev)
            final = st.done and self._pending(st) == k
            out.append(AudioPacket(request_id=st.request_id, wav=wav[j, :k * self.up],
                                   sample_rate=self.sample_rate, frame_start=st.emitted,
                                   frame_count=k, final=final))
            st.emitted += k
            st.first_sent = True
            if self.engine.trace_enabled:
                self.engine.stamp(rid, "first_packet", profiling.clock())
            self.metrics.count("server.packets")
            self.metrics.count("server.fast_first_packets")
            self.metrics.count("server.vocode_frames_delivered", k)
            if st.done and self._pending(st) == 0:
                self._forget(st.request_id)
        return out

    def _finish_results(self, completions) -> List[AudioResult]:
        """Decode non-streaming completions in one batch and mark streaming
        ones done for the final flush."""
        results: List[AudioResult] = []
        decode_batch = []
        for c in completions:
            st = self._states.get(c.request_id)
            if st is None:
                continue
            st.done = True
            if st.stream:
                continue
            codes = np.asarray(c.codes, np.int64)
            ref_len = 0
            if st.ref_code is not None:
                ref = np.asarray(st.ref_code, np.int64)
                codes = np.concatenate([ref, codes], axis=0)
                ref_len = len(ref)
            decode_batch.append((st, codes, ref_len))
        if decode_batch:
            # a power-of-two batch (1-frame dummy rows), as the JAX server
            nb = 1 << (len(decode_batch) - 1).bit_length()
            codes_in = [c for _, c, _ in decode_batch]
            codes_in += [np.zeros((1, self._Q), np.int64)] * (nb - len(codes_in))
            # on the vocoder device, its stream ordered as the egress's
            wavs, sr = self._decode_tok.decode(
                [{"audio_codes": c} for c in codes_in], output_dtype=self.output_dtype)
            for (st, codes, ref_len), wav in zip(decode_batch, wavs):
                if ref_len:
                    wav = wav[int(ref_len / max(len(codes), 1) * wav.shape[0]):]
                results.append(AudioResult(st.request_id, wav, sr))
                self._forget(st.request_id)
                self.metrics.count("server.results")
        return results

    def first_packet_trace(self, request_id) -> Optional[Dict[str, float]]:
        """The stamps (submit, staged, first_frame, first_packet: seconds on
        `utils/profiling.py::clock`) of request `request_id`, submitted while
        `engine.trace_enabled`, or None; pops them. A stream whose first
        packet was also its last keeps them, after it finished, until popped
        (at most MAX_FINISHED_TRACES such requests)."""
        rid = self._by_user_id.get(request_id)
        if rid is not None:
            return self.engine.trace.pop(rid, None)
        return self._finished_traces.pop(request_id, None)

    def trace_spans(self) -> List[profiling.Span]:
        """The host spans recorded since the last call, oldest first: at most
        `profiling.SPAN_RING` of them (the engine's and the server's; see
        the module docstring), on the profiler's clock. Call it on the
        thread that drives the server (a `ThreadedTTSServer`'s loop)."""
        return self.tracer.spans()

    # -- driving ---------------------------------------------------------

    def step(self) -> List[Union[AudioPacket, AudioResult]]:
        """One engine step and its egress; packets and results in order.
        While a stream awaits its first packet the step runs in latency
        order: first packets from the in-flight chunk, staging dispatched,
        the aux synced and due packets vocoded before the next chunk."""
        with self.tracer.span("server.step"):
            waiting_rids = []
            if self.first_packet_ticks:
                waiting_rids = [rid for rid, st in self._states.items()
                                if st.stream and not st.first_sent]
                self.engine.tick_cap = self.first_packet_ticks if waiting_rids else None
            waiting = bool(waiting_rids)
            self._defer_now = waiting and self.defer_bulk_egress
            events: List[Union[AudioPacket, AudioResult]] = []
            if waiting and self.engine._unprocessed:
                # the fast path serves streams with no reference context (a clone
                # stream's first packet must be vocoded with it) whose frames can
                # be in the oldest in-flight chunk
                fast = None
                if self.fast_first_packet:
                    fast_rids = [rid for rid in waiting_rids if self._states[rid].ctx0 == 0
                                 and self.engine.oldest_chunk_may_contain(rid)]
                    if fast_rids:
                        with self.tracer.span("server.fast_first"):
                            fast = self._dispatch_fast_first(fast_rids)
                self.engine.stage_now()
                completions = self.engine.sync_in_flight()
                events.extend(self._finish_results(completions))
                if fast is not None:
                    with self.tracer.span("server.fast_first"):
                        events.extend(self._emit_fast_first(*fast))
                events.extend(self._emit_packets())
            completions = self.engine.step()
            events.extend(self._finish_results(completions))
            events.extend(self._emit_packets())
            return events

    @property
    def busy(self) -> bool:
        return bool(self._states or self.engine.pending or self.engine.frames_acc)

    def run_until_drained(self, max_steps: int = 100000
                          ) -> List[Union[AudioPacket, AudioResult]]:
        out: List[Union[AudioPacket, AudioResult]] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.busy:
                return out
        raise RuntimeError("server did not drain within max_steps")


class ThreadedTTSServer:
    """Thread-safe wrapper: producers submit from any thread; one loop
    thread owns the server and all of its CUDA work (prefill, graph capture
    and replay, the vocoder), on the serving card and on a vocoder device of
    its own alike, and fans events out to per-request queues. The loop
    starts with the wrapper, so call `TTSServer.warmup()` before wrapping
    the server.

    Usage (blocking):      wav, sr = srv.synthesize(task, **kwargs)
    Usage (streaming):     for pkt in srv.synthesize_stream(task, **kwargs)
    """

    def __init__(self, server: TTSServer):
        import queue
        import threading

        self.server = server
        self._submit_q: "queue.Queue" = queue.Queue()
        self._sinks: Dict[Any, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        import queue as _queue

        while not self._stop:
            worked = False
            while True:
                try:
                    task, rid, kwargs, sink = self._submit_q.get_nowait()
                except _queue.Empty:
                    break
                if task == "__cancel__":
                    # the client went away: stop spending card time on it
                    self.server.cancel(rid)
                    with self._lock:
                        self._sinks.pop(rid, None)
                    worked = True
                    continue
                try:
                    submit = getattr(self.server, f"submit_{task}")
                    submit(rid, **kwargs)
                    with self._lock:
                        self._sinks[rid] = sink
                except Exception as e:  # surfaced per request; the server stays up
                    sink.put(e)
                worked = True
            if self.server.busy:
                try:
                    events = self.server.step()
                except Exception as e:
                    # a poisoned step fails every in-flight request: deliver
                    # the error instead of hanging their sinks, and clear the
                    # server's state so busy does not stay True
                    with self._lock:
                        sinks, self._sinks = self._sinks, {}
                    for sink in sinks.values():
                        sink.put(e)
                    self.server.abort_all()
                    events = []
                for ev in events:
                    with self._lock:
                        sink = self._sinks.get(ev.request_id)
                    if sink is not None:
                        sink.put(ev)
                        if isinstance(ev, AudioResult) or (
                                isinstance(ev, AudioPacket) and ev.final):
                            sink.put(None)        # end-of-stream marker
                            with self._lock:
                                self._sinks.pop(ev.request_id, None)
                worked = True
            if not worked:
                time.sleep(0.002)

    def _submit(self, task: str, stream: bool, kwargs):
        import queue

        with self._lock:
            rid = self._next_id
            self._next_id += 1
        sink: "queue.Queue" = queue.Queue()
        self._submit_q.put((task, rid, dict(kwargs, stream=stream), sink))
        return rid, sink

    def cancel(self, rid) -> None:
        """Enqueue a cancel of a request `_submit` returned; the loop thread
        runs it."""
        self._submit_q.put(("__cancel__", rid, None, None))

    def synthesize(self, task: str, timeout: float = 600.0, **kwargs):
        """Blocking non-streaming synthesis -> (wav, sample_rate)."""
        _, sink = self._submit(task, stream=False, kwargs=kwargs)
        ev = sink.get(timeout=timeout)
        if isinstance(ev, Exception):
            raise ev
        if not isinstance(ev, AudioResult):
            raise RuntimeError(f"expected an AudioResult, got {ev!r}")
        sink.get(timeout=timeout)   # end-of-stream marker
        return ev.wav, ev.sample_rate

    def synthesize_stream(self, task: str, timeout: float = 600.0, **kwargs):
        """Generator of AudioPacket for one request. Closing it early (the
        HTTP client disconnected) cancels the request."""
        rid, sink = self._submit(task, stream=True, kwargs=kwargs)
        done = False
        try:
            while True:
                ev = sink.get(timeout=timeout)
                if ev is None:
                    done = True
                    return
                if isinstance(ev, Exception):
                    done = True
                    raise ev
                yield ev
        finally:
            if not done:
                self.cancel(rid)
