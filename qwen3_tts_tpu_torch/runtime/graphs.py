"""Captured CUDA graphs of the prefill, the frame loop, the vocoder, the
clone front end, the 25 Hz tokenizer's sampler and x-vector, and the SFT
step: the port's counterpart of
`qwen3_tts_tpu/runtime/jit_options.py::decode_jit`, of `_init_decode_state`
and `stage_requests`, of the vocoder's jitted programs, of the tokenizer's
`_encode_compiled` and `extract_speaker_embedding`, of the 25 Hz
tokenizer's `_dit_sample_jit` and `campplus_embed`, and of its SFT script's
`jax.jit(make_train_step(...))`.

The JAX package compiles the frame loop into one device program per set of
static arguments (`decode_jit` over `_decode_chunk`'s scan and
`_generate_frames`' while_loop, keyed by cfg, gen_cfg, num_frames and
attend_len), the prefill and the engine's staging prefill into one program
per shape, and each vocoder call into one program per shape. Eager PyTorch
launches every operation from the host instead (~600 for one vocoder call,
~30 a layer for a prefill). Here each of them is captured once as a
`torch.cuda.CUDAGraph`, keyed the same way, and replayed with one launch.

Six owners of graphs:
- `DecodeGraphs`, a graph context of the batch generators and the streaming
  session: the static buffers of one decode shape (the weights, the talker
  config, gen_cfg.canonical() with its fused flags and KV mode, the batch B,
  the KV buffer S, the dtypes, the device), the KV cache among them, one
  prefill graph per prompt length T (`prefill`: the prefill and the first
  code0 into those buffers, from static input buffers and, where kernel 3
  takes the prefill (`talker.prefill_uses_flash`), its plan built on the
  host), and one graph
  per (K frames, attend_len) over them; at most MAX_GRAPHS_PER_CONTEXT of
  both kinds (least recently used go first). Contexts live in a per-device
  LRU of at most MAX_CONTEXTS entries and MAX_CONTEXT_BYTES of static
  buffers. A context that a live `DecodeState` uses is never handed to a
  second caller, and an evicted one lives on, buffers and graphs, for as
  long as its state does.
- `ServeGraphs`, the graphs of one continuous-batching engine over the
  engine's own `SlotState`: one-tick graphs keyed by (attend_len, install),
  at most 2 * ceil(max_len / ATTEND_BUCKET), and one staging-prefill graph
  per request count (`stage`: at most 5, counts 1 to 16), freed with the
  engine; `ContinuousBatchingEngine.warmup_serve` and `warmup_staging`
  capture them all.
- `CodecGraphs`, one per device: the 12 Hz vocoder's programs (the JAX
  package's `decode_frames_jit`, `_vocode_rows_compact`, `_vocode_slice`
  and the first-packet extract), each graph keyed by the decoder params'
  identity, the decoder config, the program ("chunk": one chunk of
  `chunked_decode`; "rows": rows vocoded and cut at their context, the
  server's egress and a stream's packet; "extract+rows": the server's first
  packet), its static arguments, pcm16 and the inputs' shapes and dtypes.
  Each holds static input buffers, which a call fills (a host input from
  pinned memory, a device one by a device copy) before the replay, and
  its output buffers, which the call copies out under the lock. At most
  MAX_CODEC_GRAPHS a device, least recently used first out. The vocoder
  draws no random numbers: its graphs register no generator.
- `FrontGraphs`, three per device, one a program, reached through
  `front_call` as the vocoder's are through `codec_call`: the clone front
  end's 12 Hz encode ("encode", keyed by the padded (rows, samples), which
  the tokenizer buckets to 8 frames as the JAX package does; at most
  MAX_ENCODE_GRAPHS) and the ECAPA speaker embedding ("ecapa", keyed by
  the exact sample count: stats pooling and the reflect-padded last conv
  see the true end; at most MAX_ECAPA_GRAPHS). Each bound is its own, so
  that clips of many lengths never evict a vocoder graph that a server's
  warm-up captured, nor ECAPA's exact lengths an encode bucket. A key is
  captured at its second call: its first runs eagerly and is remembered
  (the last MAX_FRONT_SEEN keys), because most clips are sent once and a
  capture costs several eager runs. Inside `replay_only()` (a server's
  submit, on the thread of its live ticks) a key without a graph runs
  eagerly and nothing is captured; `TTSServer.warmup` captures the encode
  of every bucket its prefill admits. A third `FrontGraphs` holds CAM++,
  the 25 Hz tokenizer's x-vector ("campplus", keyed by the host fbank's
  frame count; at most MAX_CAMPPLUS_GRAPHS).
- `StepGraphs`, one per device: the 25 Hz DiT sampler's Euler step
  (`step_loop`), y += v(y, t0) * (t1 - t0) with y, t0 and t1 static
  buffers; a call fills the conditioning's buffers once (computed eagerly
  before: the internal ECAPA, the input embedding's fixed columns, RoPE
  tables, three block biases), then per step copies t0 and t1 from the
  time grid on the device and replays. Keyed by the shapes the step reads
  ((B, Tc) and the CFG batch) and guidance_scale: num_steps and the
  sway change only the grid, and the reference mel reaches only the
  conditioning. Lengths are exact, as in the JAX package (the DiT's
  look-ahead makes end padding change the output). A key is captured at
  its DIT_CAPTURE_CALL-th call, the capture's warm pass being that call's
  first step; at most MAX_DIT_STEP_GRAPHS. DIT_CAPTURE_CALL is 2 because
  most clips are decoded once: at new ~10 s lengths on an H100 a first
  call that captured took 198-470 ms against 181-358 for a cold eager
  call, while over a length's first two calls capturing at the first was
  2-14% faster (chip_smoke's `v1_graphs` sets it to 1 and 2 in turn).
The 25 Hz tokenizer's other two programs, BigVGAN and the Whisper-VQ
encode, run eagerly: they read no host memory, so they can be captured,
but on an H100 a replay saved 4-5 of BigVGAN's ~85 ms and 1-3 of the
encode's 7-9 at 10 s, against ~118 and ~106 ms more for the call that
captured, which a clip length repays only after 33-41 and 117-390 later
calls (chip_smoke's `v1_graphs`, PERF.md). The DiT step and CAM++ repay
theirs after 1-2 and 3-6. Their bounds cap memory and are not fitted to a
traffic mix: 5 DiT keys of 2-20 s held 38.2 MiB of static inputs (the
biases grow as T^2) and 5 CAM++ keys 1.5 MiB, beside one shared pool of
~0.5 GiB.
- `TrainGraphs`, one per train step (`finetune/train.py`
  `make_train_step`, which hands it the mini-step's body): one graph per
  (B, T, phase) of the mini-step, phase "fold" or "fold+update" (the
  optimizer's fold of the gradients, and on every grad_accum-th call the
  clip and the AdamW step), over static buffers of the batch dict and the
  speaker embedding, the losses as static outputs copied out after the
  replay; at most MAX_TRAIN_GRAPHS, least recently used first out: both
  phases of every 64-token length up to 2048 (`sft.py` pads each batch to
  a multiple of 64). The graphs share the device's pool, so a graph costs
  its static inputs and its host-side graph, not its activations again.
  Its capture differs from the others': copying the params and the AdamW
  states for a warm pass would cost their size again, so the first call
  of a key runs eagerly on the side stream as the real step (it also
  creates AdamW's state), and the capture that follows records the same
  body with every grad None (backward allocates the grads from the pool);
  replays start at the next call of the key. Under a mesh the step stays
  eager.

Every capture:
- runs one eager warm-up pass on the device's side stream first (PyTorch's
  graph rules; it also builds the kernel wrappers' launch state for that
  stream), on copies of the small state tensors: the KV slots it writes are
  written again by the replay before anything reads them;
- captures on that side stream, with capture_error_mode="thread_local" (a
  thread doing host work cannot break it), into the device's one memory
  pool, which every graph of the device shares, with Python's cyclic
  garbage collection off (collecting a dead server's graphs there would
  invalidate the capture);
- draws its sampling noise from the device's private generator, registered
  with every graph of the frame loop; a replay copies the caller's
  generator state in and the advanced state back, so a graph draws the
  numbers the eager loop draws from the same state;
- runs with its device current (a server's vocoder device may be another
  card than the caller's), as does every replay;
- pins the kernel wrappers' `LaunchState`s of its device it used for the
  graph's life (`build.pin`), and counts each kernel launch it holds once
  per replay in the wrapper's launch counter (the capture itself launches
  nothing);
- raises if it fails: nothing falls back to the eager loop.
Captures, replays and the context LRU hold one process-wide lock, so that
callers on several threads (the demo's static path) interleave whole
replays: a replay owns the device's private generator from the copy in to
the copy out.

A graph reads and writes only static tensors, whose addresses its capture
baked in (kernel 3's TMA maps among them): inputs are copied into static
buffers before a replay, host inputs from pinned memory, and nothing in a
captured body reads the device from the host.

`eager()` turns the graphs off, every owner's, so that one process can run
the graphed and the eager route side by side (the smoke's and the
profiler's A/B). No configuration, CLI flag or server option selects it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from ..ops.cuda import build
from ..utils import profiling

MAX_CONTEXTS = 8               # decode graph contexts per device
MAX_CONTEXT_BYTES = 8 << 30    # their static buffers, KV caches included
MAX_GRAPHS_PER_CONTEXT = 32
MAX_CODEC_GRAPHS = 64          # vocoder graphs per device
MAX_ENCODE_GRAPHS = 64         # 12 Hz encode graphs per device: a 512-frame prefill's buckets
MAX_ECAPA_GRAPHS = 32          # speaker-embedding graphs per device
MAX_DIT_STEP_GRAPHS = 16       # 25 Hz DiT steps per device, one per (B, Tc): T^2 biases
MAX_CAMPPLUS_GRAPHS = 32       # CAM++ x-vectors per device, one per fbank frame count
DIT_CAPTURE_CALL = 2           # the call of a DiT step key that captures it: 1 or 2
MAX_FRONT_SEEN = 256           # keys of each front-end program seen once, remembered
MAX_TRAIN_GRAPHS = 64          # training graphs per train step: 2 phases x 32 lengths
V1_PROGRAMS = ("dit_step", "campplus")
_SMALL = ("code0", "last_hidden", "presence", "done", "lengths", "t")
_EAGER = [False]
_LOCK = threading.RLock()
_LOCAL = threading.local()


@contextlib.contextmanager
def eager():
    """Run every graphed program eagerly on a CUDA device inside the block
    (A/B measurements of the graphs against the eager code)."""
    prev = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = prev


def enabled(device) -> bool:
    """Whether the graphed programs on `device` run as graphs."""
    return torch.device(device).type == "cuda" and not _EAGER[0]


@contextlib.contextmanager
def replay_only():
    """Inside the block, on this thread, the clone front end's owners
    replay the graphs they hold and run any other key eagerly: nothing is
    captured (a server's submit runs on the thread of its live ticks)."""
    prev = getattr(_LOCAL, "replay_only", False)
    _LOCAL.replay_only = True
    try:
        yield
    finally:
        _LOCAL.replay_only = prev


def _counters():
    """(wrapper, attribute) of the launch counters of the kernels a graph
    holds."""
    from ..ops.cuda.prefill_attention import flash_prefill
    from ..ops.cuda.subtalker import subtalker_frame_fused
    from ..ops.cuda.talker_step import talker_step_fused_cache

    return ((subtalker_frame_fused, "launches"), (talker_step_fused_cache, "launches"),
            (talker_step_fused_cache, "launches_int8_kv"), (flash_prefill, "launches"))


def _read_counts() -> list:
    return [getattr(f, a) for f, a in _counters()]


def _add_counts(delta, sign: int = 1) -> None:
    for (f, a), d in zip(_counters(), delta):
        setattr(f, a, getattr(f, a) + sign * d)


class _Device:
    """Per-device graph state: the memory pool, the capture stream, the
    private generator, the decode contexts, the vocoder's and the front
    end's graphs, and the training owners."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.gen = torch.Generator(device=device)
        self.contexts: "OrderedDict[int, DecodeGraphs]" = OrderedDict()
        self.codec = CodecGraphs(self, MAX_CODEC_GRAPHS)
        self.encode = FrontGraphs(self, MAX_ENCODE_GRAPHS)
        self.ecapa = FrontGraphs(self, MAX_ECAPA_GRAPHS)
        self.campplus = FrontGraphs(self, MAX_CAMPPLUS_GRAPHS)
        self.dit_step = StepGraphs(self, MAX_DIT_STEP_GRAPHS)
        self.train: "weakref.WeakSet[TrainGraphs]" = weakref.WeakSet()
        self.captures = 0
        self.replays = 0


_DEVICES: Dict[int, _Device] = {}


def _device(device) -> _Device:
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _DEVICES:
        _DEVICES[index] = _Device(torch.device("cuda", index))
    return _DEVICES[index]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _copy_in(buf: torch.Tensor, x: torch.Tensor) -> None:
    """Copy `x` into the static buffer `buf` without a sync: from pinned
    memory where x lies on the host, else a device copy."""
    buf.copy_(x if x.device == buf.device else x.pin_memory(), non_blocking=True)


def _prefill_buffers(cfg, B: int, T: int, dtype, flash: bool, device) -> tuple:
    """Static inputs of a prefill over (B, T): embeds (B, T, H), mask (B, T)
    int32 and, where it attends through the flash kernel (`flash`), the
    kernel's plan (items, offsets), whose shapes no set of starts changes
    (`plan_shapes`, the device's SM count as CTAs)."""
    bufs = [torch.zeros((B, T, cfg.hidden_size), dtype=dtype, device=device),
            torch.zeros((B, T), dtype=torch.int32, device=device)]
    if flash:
        from ..ops.cuda.prefill_attention import plan_shapes

        shapes = plan_shapes(B, T, cfg.num_key_value_heads, build.sm_count(device))
        bufs += [torch.zeros(sh, dtype=torch.int32, device=device) for sh in shapes]
    return tuple(bufs)


def _load_plan(plan: tuple, cfg, attn_mask: torch.Tensor) -> None:
    """`flash_plan` of the starts of `attn_mask` ((B, T) left-padded, read
    on the host: where it lies on the device, one read) into the static
    (items, offsets) buffers `plan`, over as many CTAs as they hold."""
    from ..ops.cuda.prefill_attention import flash_plan

    mask = attn_mask.cpu()
    T = mask.shape[1]
    items, offsets = flash_plan(T, (T - mask.sum(dim=-1)).tolist(), cfg.sliding_window,
                                cfg.num_key_value_heads, plan[1].shape[0] - 1)
    for buf, x in zip(plan, (items, offsets)):
        _copy_in(buf, torch.from_numpy(x))


class _Graph:
    """One captured graph: the launches it holds and the launch states it
    pins."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: list, states: list):
        self.graph = graph
        self.launches = launches
        self.states = states
        weakref.finalize(self, build.pin(states))

    def replay(self, dev: _Device, generator: Optional[torch.Generator]) -> None:
        """One replay on the device's current stream; a device span armed
        on this thread (`utils/profiling.py`) records its events right
        around it."""
        span = profiling.armed()
        with _LOCK, torch.cuda.device(dev.device):
            if generator is not None:
                dev.gen.set_state(generator.get_state())
            if span is not None:
                span.before()
            self.graph.replay()
            if span is not None:
                span.after()
            if generator is not None:
                generator.set_state(dev.gen.get_state())
            _add_counts(self.launches)
            dev.replays += 1


class DecodeGraphs:
    """The static buffers of one decode shape and the graphs of its chunks
    (see the module docstring)."""

    def __init__(self, dev: _Device, key: tuple, params, cfg, gen_cfg, B: int, S: int,
                 Tcap: int, dtype, text_dtype):
        from ..models.talker import KVCache, StackDims
        from .generate import DecodeConst, DecodeState, suppress_mask_for

        device = dev.device
        dims = StackDims.from_talker(cfg)
        H = cfg.hidden_size

        def z(*shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        self.dev, self.key = dev, key
        self.params, self.cfg, self.gen_cfg = params, cfg, gen_cfg
        self.cache = KVCache.zeros(cfg.num_hidden_layers, B, S, dims.kv_heads, dims.head_dim,
                                   dtype=dtype, device=device, quantized=gen_cfg.kv_quant)
        self.const = DecodeConst(
            trailing_text=z(B, Tcap, H, dt=text_dtype), tts_pad_embed=z(1, 1, H, dt=dtype),
            valid_prefill=z(B, S, dt=torch.bool), seq_lens=z(B, dt=torch.int32),
            prefill_len=z(dt=torch.int32), samp_row=z(5, dt=torch.float32),
            sub_row=z(5, dt=torch.float32), suppress=suppress_mask_for(cfg, device))
        self.state = DecodeState(
            cache=self.cache, code0=z(B, dt=torch.int32), last_hidden=z(B, 1, H, dt=dtype),
            presence=z(B, cfg.vocab_size, dt=torch.bool), done=z(B, dt=torch.bool),
            lengths=z(B, dt=torch.int32), t=z(dt=torch.int32))
        self.graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._owner = None

    @property
    def busy(self) -> bool:
        return self._owner is not None and self._owner() is not None

    def nbytes(self) -> int:
        ts = [getattr(self.cache, f) for f in ("k", "v", "k_scale", "v_scale")]
        ts += [t for t in self.const if torch.is_tensor(t)]
        ts += [getattr(self.state, f) for f in _SMALL]
        ts += [t for g in self.graphs.values() for t in g.static]
        return _nbytes(ts)

    def fresh_cache(self):
        """The context's KV cache, zeroed (as a new one would be) for a
        prefill to write into."""
        for t in (self.cache.k, self.cache.v, self.cache.k_scale, self.cache.v_scale):
            if t is not None:
                t.zero_()
        return self.cache

    def prefill(self, inputs_embeds, attn_mask, trailing_text, tts_pad_embed, rows,
                generator: torch.Generator):
        """`generate.prefill_state` into this context: one replay of the
        prefill graph of the prompt length T (captured at first use). The
        inputs are copied into static buffers first: the embeds, the mask
        and, where the prefill attends through kernel 3
        (`talker.prefill_uses_flash`), the flash prefill's plan, built
        on the host from the mask (one device read where the mask lies on
        the device); the trailing text, padded with the tts_pad embedding up
        to the frame count (every frame reads the buffer; the loop never
        reaches row Tcap), the pad embedding and the sampling rows `rows`
        (`GenerationConfig.sampling_rows`: the knobs travel as data). Returns
        (state, const) over the static buffers, for `decode_chunk`."""
        from ..models import talker

        B, T = inputs_embeds.shape[:2]
        flash = talker.prefill_uses_flash(talker.StackDims.from_talker(self.cfg), T,
                                          inputs_embeds.dtype)
        key = ("prefill", T, flash)
        with _LOCK:
            g = self.graphs.get(key)
            if g is None:
                bufs = _prefill_buffers(self.cfg, B, T, inputs_embeds.dtype, flash,
                                        self.dev.device)
                self._load_prefill(bufs, inputs_embeds, attn_mask, trailing_text,
                                   tts_pad_embed, rows)
                g = self._capture_prefill(bufs, generator)
                self._add(key, g)
            else:
                self.graphs.move_to_end(key)
                self._load_prefill(g.static, inputs_embeds, attn_mask, trailing_text,
                                   tts_pad_embed, rows)
            g.replay(self.dev, generator)
        out = dataclasses.replace(self.state, graphs=self)
        self._owner = weakref.ref(out)
        return out, self.const

    def _load_prefill(self, bufs, inputs_embeds, attn_mask, trailing_text, tts_pad_embed,
                      rows):
        c = self.const
        embeds, mask, plan = bufs[0], bufs[1], bufs[2:]
        _copy_in(embeds, inputs_embeds)
        _copy_in(mask, attn_mask)
        if plan:
            _load_plan(plan, self.cfg, attn_mask)
        n = min(trailing_text.shape[1], c.trailing_text.shape[1])
        _copy_in(c.trailing_text[:, :n], trailing_text[:, :n])
        _copy_in(c.tts_pad_embed, tts_pad_embed)
        c.trailing_text[:, n:].copy_(c.tts_pad_embed.expand_as(c.trailing_text[:, n:]))
        for buf, row in zip((c.samp_row, c.sub_row), rows):
            _copy_in(buf, torch.tensor(row, dtype=torch.float32))

    def _capture_prefill(self, bufs, generator) -> _Graph:
        from .generate import prefill_state

        embeds, mask, plan = bufs[0], bufs[1], bufs[2:]
        c = self.const

        def body(gen):
            state, const = prefill_state(
                self.params, self.cfg, self.gen_cfg, embeds, mask, self.fresh_cache(),
                c.trailing_text, c.tts_pad_embed, c.samp_row, c.sub_row, gen,
                plan=plan or None)
            for f in _SMALL:
                getattr(self.state, f).copy_(getattr(state, f))
            for f in ("valid_prefill", "seq_lens", "prefill_len"):
                getattr(c, f).copy_(getattr(const, f))

        # the warm pass may run the body itself: the replay rewrites every
        # buffer it writes
        g = capture(self.dev, generator, body, body)
        g.static = bufs
        return g

    def _add(self, key, g) -> None:
        self.graphs[key] = g
        while len(self.graphs) > MAX_GRAPHS_PER_CONTEXT:
            self.graphs.popitem(last=False)

    def run(self, params, gen_cfg, K: int, attend_len: Optional[int],
            generator: torch.Generator):
        """Replay the graph of (K, attend_len), captured at first use.
        Returns its static outputs (frames (B, K, Q) int32, active (B, K),
        hidden (B, K, H), zero on inactive frames), which the next replay
        rewrites."""
        if params is not self.params or gen_cfg.canonical() != self.gen_cfg:
            raise ValueError("decode_chunk: params or gen_cfg differ from the ones the "
                             "decode state was initialised with")
        key = (int(K), attend_len)
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(int(K), attend_len, generator)
            self._add(key, g)
        else:
            self.graphs.move_to_end(key)
        g.replay(self.dev, generator)
        return g.static

    def _capture(self, K: int, attend_len: Optional[int], generator) -> _Graph:
        from .generate import frame_loop

        B, H = self.state.code0.shape[0], self.cfg.hidden_size
        dev = self.dev.device
        outs = (torch.empty((B, K, self.cfg.num_code_groups), dtype=torch.int32, device=dev),
                torch.empty((B, K), dtype=torch.bool, device=dev),
                torch.empty((B, K, H), dtype=self.state.last_hidden.dtype, device=dev))

        def body(dst, gen):
            work = dataclasses.replace(dst, graphs=None)
            work, *got = frame_loop(self.params, self.cfg, self.gen_cfg, self.const, work, K,
                                    gen, attend_len)
            for o, v in zip(outs, got):
                o.copy_(v)
            for f in _SMALL:   # close the loop: the next replay starts from here
                getattr(dst, f).copy_(getattr(work, f))

        def warm(gen):
            body(dataclasses.replace(self.state, **{f: getattr(self.state, f).clone()
                                                    for f in _SMALL}), gen)

        g = capture(self.dev, generator, warm, lambda gen: body(self.state, gen))
        g.static = outs
        return g


def capture(dev: _Device, generator: Optional[torch.Generator], warm, body) -> _Graph:
    """`warm(gen)` eagerly on the device's side stream, then `body(gen)`
    captured there; `gen` is the device's private generator, set from
    `generator`'s state (None: a graph that draws no random numbers). Both
    run with the device current, whichever device the caller's is:
    `torch.cuda.graph` synchronises the current device before a capture,
    and the capture records on the current device's stream."""
    gen = None if generator is None else dev.gen
    if generator is not None:
        gd = torch.device(generator.device)
        if gd.type != "cuda" or (gd.index if gd.index is not None
                                 else torch.cuda.current_device()) != dev.device.index:
            raise ValueError(f"the sampling generator is on {generator.device}; the graphs "
                             f"of {dev.device} draw from a generator on that device")
    with _LOCK, torch.cuda.device(dev.device):
        cur = torch.cuda.current_stream(dev.device)
        dev.stream.wait_stream(cur)
        with torch.cuda.stream(dev.stream):
            if gen is not None:
                gen.set_state(generator.get_state())
            warm(gen)
        cur.wait_stream(dev.stream)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        before = _read_counts()
        # no cyclic garbage collection inside a capture: a dead cycle that
        # holds a graph (a server and its engine's graphs) would destroy it
        # there, and a graph's teardown is a call a capture does not permit
        # (it invalidates the capture)
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with build.pinning(dev.device.index) as used:
                with torch.cuda.graph(graph, pool=dev.pool, stream=dev.stream,
                                      capture_error_mode="thread_local"):
                    body(gen)
        finally:
            if gc_on:
                gc.enable()
            delta = [a - b for a, b in zip(_read_counts(), before)]
            _add_counts(delta, -1)   # a capture records launches; it makes none
        dev.captures += 1
        return _Graph(graph, delta, used)


def _reserved():
    """The owner of a context handed out and not yet loaded."""
    return True


def decode_context(params, cfg, gen_cfg, B: int, S: int, dtype, text_dtype,
                   device) -> Optional[DecodeGraphs]:
    """A free graph context for this decode shape on `device` (made on a
    miss, evicting the least recently used past the bounds), or None where
    the loop runs eagerly (the CPU, or inside `eager()`)."""
    if not enabled(device):
        return None
    canon = gen_cfg.canonical()
    Tcap = max(1, gen_cfg.max_new_tokens - 1)
    key = (id(params), id(cfg), canon, B, S, Tcap, dtype, text_dtype)
    with _LOCK:
        dev = _device(device)
        for i, ctx in dev.contexts.items():
            if ctx.key == key and not ctx.busy:
                dev.contexts.move_to_end(i)
                ctx._owner = _reserved   # until `load` hands out its state
                return ctx
        ctx = DecodeGraphs(dev, key, params, cfg, canon, B, S, Tcap, dtype, text_dtype)
        ctx._owner = _reserved
        dev.contexts[id(ctx)] = ctx
        while len(dev.contexts) > 1 and (
                len(dev.contexts) > MAX_CONTEXTS
                or sum(c.nbytes() for c in dev.contexts.values()) > MAX_CONTEXT_BYTES):
            dev.contexts.popitem(last=False)
        return ctx


class ServeGraphs:
    """One engine's one-tick serve graphs (see the module docstring). A
    chunk of n ticks is n replays; each writes its tick column of the
    chunk's frame, emit, request-id and finished buffers through a device
    tick index."""

    def __init__(self, engine):
        # what the graphs read of the engine (not the engine itself: the
        # graphs go with it)
        self.params, self.cfg, self.gen_cfg = engine.params, engine.cfg, engine.gen_cfg
        self.state, self.ticks = engine.state, engine.ticks_per_sync
        self.dev = _device(engine.device)
        B, T = engine.num_slots, engine.ticks_per_sync
        dev = self.dev.device

        def z(*shape, dt=torch.int32):
            return torch.zeros(shape, dtype=dt, device=dev)

        # frames, emit, req_id, finished, tick index
        self.outs = (z(B, T, engine.cfg.num_code_groups), z(B, T), z(B, T), z(B, T),
                     z(dt=torch.int64))
        self.graphs: Dict[tuple, _Graph] = {}
        # the staging prefill's graphs, one per request count
        self.Lp, self.Tt, self.dtype = engine.prefill_bucket, engine.max_trailing, engine.dtype
        self.staging: Dict[int, _Graph] = {}

    def stage(self, embeds_rows, mask_rows, trailing_rows, meta, tts_pad, srows, ssrows,
              generator: torch.Generator) -> None:
        """`batching.stage_rows` of len(meta) requests (padding rows
        included), one replay of the staging graph of that count, captured
        at first use (or by the engine's `warmup_staging`). The inputs go
        into static buffers first: the rows ((Lp, H) embeds and (Tt, H)
        trailing on the device, (Lp,) int32 masks on the host), `meta`
        ((N, 5) int32) and the sampling rows (host numpy), the pad
        embedding and, where the staging prefill attends through kernel 3
        (`talker.prefill_uses_flash`), the flash prefill's plan, built from
        the masks on the host."""
        from ..models import talker

        N = len(meta)
        with _LOCK:
            g = self.staging.get(N)
            if g is None:
                dev, H = self.dev.device, self.cfg.hidden_size
                flash = talker.prefill_uses_flash(talker.StackDims.from_talker(self.cfg),
                                                  self.Lp, self.dtype)
                bufs = _prefill_buffers(self.cfg, N, self.Lp, self.dtype, flash, dev)
                bufs = bufs[:2] + (
                    torch.zeros((N, self.Tt, H), dtype=self.dtype, device=dev),
                    torch.zeros((N, 5), dtype=torch.int32, device=dev),
                    torch.zeros((N, 5), dtype=torch.float32, device=dev),
                    torch.zeros((N, 5), dtype=torch.float32, device=dev),
                    torch.zeros((1, 1, H), dtype=self.dtype, device=dev)) + bufs[2:]
                self._load_stage(bufs, embeds_rows, mask_rows, trailing_rows, meta, tts_pad,
                                 srows, ssrows)
                g = self.staging[N] = self._capture_stage(bufs, generator)
            else:
                self._load_stage(g.static, embeds_rows, mask_rows, trailing_rows, meta,
                                 tts_pad, srows, ssrows)
            g.replay(self.dev, generator)

    def _load_stage(self, bufs, embeds_rows, mask_rows, trailing_rows, meta, tts_pad, srows,
                    ssrows) -> None:
        embeds, mask, trailing, meta_b, srows_b, ssrows_b, pad = bufs[:7]
        torch.stack(embeds_rows, out=embeds)
        torch.stack(trailing_rows, out=trailing)
        mask_host = torch.stack([m.cpu() for m in mask_rows])
        _copy_in(mask, mask_host)
        for buf, x in ((meta_b, meta), (srows_b, srows), (ssrows_b, ssrows)):
            _copy_in(buf, torch.from_numpy(x))
        _copy_in(pad, tts_pad.reshape(pad.shape))
        if len(bufs) > 7:
            _load_plan(bufs[7:], self.cfg, mask_host)

    def _capture_stage(self, bufs, generator) -> _Graph:
        from .batching import stage_rows

        embeds, mask, trailing, meta, srows, ssrows, pad = bufs[:7]

        def body(gen):
            stage_rows(self.params, self.cfg, self.state, self.gen_cfg, embeds, mask, trailing,
                       meta, pad, gen, srows, ssrows, plan=bufs[7:] or None)

        # the warm pass runs the body itself: a merge written twice with the
        # same draws writes the same values
        g = capture(self.dev, generator, body, body)
        g.static = bufs
        return g

    def chunk(self, n_ticks: int, attend_len: int, install: bool,
              generator: torch.Generator) -> torch.Tensor:
        """serve_chunk's packed aux for min(n_ticks, ticks_per_sync) ticks."""
        st = self.state
        for t in self.outs:
            t.zero_()
        g = self.graph(attend_len, install, generator)
        for _ in range(min(n_ticks, self.ticks)):
            g.replay(self.dev, generator)
        fb, eb, rb, db, _ = self.outs
        return torch.cat([fb.reshape(-1), eb.reshape(-1), rb.reshape(-1), db.reshape(-1),
                          st.staged_valid.to(torch.int32), st.staged_req_id.to(torch.int32),
                          st.t.to(torch.int32)])

    def graph(self, attend_len: int, install: bool, generator: torch.Generator) -> _Graph:
        """The one-tick graph of (attend_len, install), captured if absent
        (at a live tick, or ahead of traffic by the engine's
        `warmup_serve`)."""
        key = (attend_len, bool(install))
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(attend_len, bool(install), generator)
        return g

    def _capture(self, attend_len: int, install: bool, generator) -> _Graph:
        from .batching import serve_step

        def body(dst, outs, gen):
            work = dataclasses.replace(dst)
            frames, emit, req_id, finished = serve_step(self.params, self.cfg, work,
                                                        self.gen_cfg, gen, attend_len, install)
            fb, eb, rb, db, tick = outs
            i = tick.reshape(1)
            for buf, v in ((fb, frames), (eb, emit), (rb, req_id), (db, finished)):
                buf.index_copy_(1, i, v.to(torch.int32)[:, None])
            tick.add_(1)
            for f in dataclasses.fields(dst):   # close the loop
                new, old = getattr(work, f.name), getattr(dst, f.name)
                if torch.is_tensor(new) and new is not old:
                    old.copy_(new)

        def warm(gen):
            st = self.state
            copy = dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                              for f in dataclasses.fields(st)
                                              if torch.is_tensor(getattr(st, f.name))})
            body(copy, tuple(t.clone() for t in self.outs), gen)

        return capture(self.dev, generator, warm, lambda gen: body(self.state, self.outs, gen))


class _CodecGraph:
    """One captured vocoder graph: its static inputs and outputs, and the
    decoder params it reads (held, so that their identity in its key
    stays theirs)."""

    def __init__(self, params, inputs: tuple, outputs: tuple, graph: _Graph):
        self.params, self.inputs, self.outputs, self.graph = params, inputs, outputs, graph

    def nbytes(self) -> int:
        return _nbytes(self.inputs + self.outputs)


class KeyedGraphs:
    """The graphs of one device's vocoder or of one of its programs, at
    most `bound` of them, least recently used first out (see the module
    docstring): keys, static copies in and out, captures, and the keys
    met once (`seen`) by an owner that captures at a key's second call."""

    def __init__(self, dev: _Device, bound: int):
        self.dev, self.bound = dev, bound
        self.graphs: "OrderedDict[tuple, _CodecGraph]" = OrderedDict()
        self.seen: "OrderedDict[tuple, None]" = OrderedDict()

    @staticmethod
    def key(params, cfg, program: str, static: tuple, pcm16: bool, inputs: tuple) -> tuple:
        return (id(params), cfg, program, static, bool(pcm16),
                tuple((tuple(x.shape), x.dtype) for x in inputs))

    def _first_sight(self, key: tuple) -> bool:
        """Whether `key` runs eagerly now: it has no graph and was not seen
        before (or this is inside `replay_only()`). Remembers it."""
        if key in self.graphs or (key in self.seen
                                  and not getattr(_LOCAL, "replay_only", False)):
            return False
        self.seen[key] = None
        self.seen.move_to_end(key)
        while len(self.seen) > MAX_FRONT_SEEN:
            self.seen.popitem(last=False)
        return True

    def _replay(self, key: tuple, params, body, inputs: tuple) -> tuple:
        """`body(*inputs)` as a replay of the graph of `key`, captured now
        if it has none; returns copies of the graph's outputs."""
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(params, body, inputs)
            self._add(key, g)
        else:
            self.graphs.move_to_end(key)
            self._load(g.inputs, inputs)
        g.graph.replay(self.dev, None)
        return tuple(o.clone() for o in g.outputs)

    def _add(self, key: tuple, g: _CodecGraph) -> None:
        self.graphs[key] = g
        while len(self.graphs) > self.bound:
            self.graphs.popitem(last=False)

    @staticmethod
    def _load(bufs: tuple, inputs: tuple) -> None:
        for buf, x in zip(bufs, inputs):
            _copy_in(buf, x)

    def _capture(self, params, body, inputs: tuple) -> _CodecGraph:
        dev = self.dev.device
        bufs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs)
        self._load(bufs, inputs)
        outs = []
        g = capture(self.dev, None, lambda _: body(*bufs), lambda _: outs.extend(body(*bufs)))
        return _CodecGraph(params, bufs, tuple(outs), g)


class CodecGraphs(KeyedGraphs):
    """The vocoder's graphs of one device, a key captured at its first
    call."""

    def run(self, params, cfg, program: str, static: tuple, pcm16: bool, body,
            inputs: tuple) -> tuple:
        """`body(*inputs)` as a replay of its graph; returns copies of the
        graph's outputs."""
        key = self.key(params, cfg, program, static, pcm16, inputs)
        with _LOCK:
            return self._replay(key, params, body, inputs)


class FrontGraphs(KeyedGraphs):
    """The graphs of one program on one device, a key captured at its
    second call."""

    def run(self, params, cfg, program: str, static: tuple, pcm16: bool, body,
            inputs: tuple) -> tuple:
        """`body(*inputs)`: eagerly at a key's first sight, else as a
        replay of its graph."""
        key = self.key(params, cfg, program, static, pcm16, inputs)
        with _LOCK:
            if self._first_sight(key):
                return body(*(x.to(self.dev.device) for x in inputs))
            return self._replay(key, params, body, inputs)


def _steps(body, y: torch.Tensor, grid: torch.Tensor, inputs: tuple) -> torch.Tensor:
    for i in range(grid.shape[0] - 1):
        body(y, grid[i], grid[i + 1], *inputs)
    return y


class StepGraphs(KeyedGraphs):
    """The 25 Hz DiT sampler's step on one device (see the module
    docstring): one graph of the step per key, captured at the key's
    DIT_CAPTURE_CALL-th call and replayed for its other steps."""

    def loop(self, params, cfg, static: tuple, body, y0: torch.Tensor, grid: torch.Tensor,
             inputs: tuple) -> torch.Tensor:
        """`step_loop` on this device: y, t0 and t1 are static buffers of
        the step's graph; each step fills t0 and t1 from `grid` by device
        copies, then replays. Before the capturing call the steps run
        eagerly; at it, the capture's warm pass is the first step."""
        ins = (y0, grid[0], grid[1]) + tuple(inputs)
        key = self.key(params, cfg, "dit_step", static, False, ins)
        with _LOCK:
            if DIT_CAPTURE_CALL > 1 and self._first_sight(key):
                return _steps(body, y0.to(self.dev.device, copy=True), grid, inputs)
            g = self.graphs.get(key)
            start = 0
            if g is None:
                g = self._capture(params, body, ins)
                self._add(key, g)
                start = 1
            else:
                self.graphs.move_to_end(key)
                self._load(g.inputs, ins)
            y, t0, t1 = g.inputs[:3]
            for i in range(start, grid.shape[0] - 1):
                self._load((t0, t1), (grid[i], grid[i + 1]))
                g.graph.replay(self.dev, None)
            return y.clone()


def params_device(tree) -> Optional[torch.device]:
    """The device of a parameter tree: its first tensor leaf's."""
    if torch.is_tensor(tree):
        return tree.device
    if isinstance(tree, dict):
        for v in tree.values():
            d = params_device(v)
            if d is not None:
                return d
    return None


def _owner_call(owner: str, params, cfg, program: str, static: tuple, pcm16: bool, body,
                inputs: tuple) -> tuple:
    device = params_device(params)
    if not enabled(device):
        return body(*(x.to(device) for x in inputs))
    with _LOCK:
        graphs = getattr(_device(device), owner)
    return graphs.run(params, cfg, program, static, pcm16, body, inputs)


def codec_call(params, cfg, program: str, static: tuple, pcm16: bool, body, *inputs) -> tuple:
    """`body(*inputs)` -> a tuple of tensors, one of the vocoder's programs
    over the decoder params `params` (config `cfg`; `program`, `static` and
    `pcm16` name it, see the module docstring). Inputs may lie on the host
    or on the params' device. On a CUDA device (outside `eager()`) one
    replay of the program's graph; elsewhere `body` on the inputs moved to
    the params' device."""
    return _owner_call("codec", params, cfg, program, static, pcm16, body, inputs)


def front_call(params, cfg, program: str, static: tuple, body, *inputs) -> tuple:
    """`codec_call` for the programs captured at a key's second call: the
    clone front end's ("encode" over the Mimi encoder's params, "ecapa"
    over the speaker encoder's) and CAM++ ("campplus"), each on the
    device's `FrontGraphs` of its own."""
    return _owner_call(program, params, cfg, program, static, False, body, inputs)


def step_loop(params, cfg, static: tuple, body, y0: torch.Tensor, grid: torch.Tensor,
              *inputs) -> torch.Tensor:
    """y = a copy of y0, then `body(y, grid[i], grid[i + 1], *inputs)` for
    each i < len(grid) - 1, each call writing y in place; returns y. On a
    CUDA device (outside `eager()`) the step is one graph keyed by the
    params' identity, `cfg`, `static` and the inputs' shapes and dtypes
    (`StepGraphs`); elsewhere the steps run eagerly on the params' device."""
    device = params_device(params)
    if not enabled(device):
        return _steps(body, y0.to(device, copy=True), grid, inputs)
    if grid.shape[0] < 2:
        return y0.clone()
    with _LOCK:
        owner = _device(device).dit_step
    return owner.loop(params, cfg, static, body, y0, grid, inputs)


class _TrainGraph:
    """One captured mini-step: its static inputs (the batch dict, the
    speaker embedding), its static outputs (the losses) and the params tree
    it trains (held, so that its identity in the key stays its own)."""

    def __init__(self, params, batch: dict, speaker: torch.Tensor, outputs: dict,
                 graph: _Graph):
        self.params, self.batch, self.speaker = params, batch, speaker
        self.outputs, self.graph = outputs, graph

    def load(self, batch: dict, speaker: torch.Tensor) -> None:
        for k, buf in self.batch.items():
            _copy_in(buf, batch[k])
        _copy_in(self.speaker, speaker)


class TrainGraphs:
    """The captured mini-steps of one train step (see the module
    docstring)."""

    def __init__(self, optimizer, body):
        self.optimizer, self.body = optimizer, body
        self.dev = _device(optimizer.leaves[0].device)
        self.graphs: "OrderedDict[tuple, _TrainGraph]" = OrderedDict()
        self.version = optimizer.version
        with _LOCK:
            self.dev.train.add(self)

    @staticmethod
    def key(params, batch: dict, speaker: torch.Tensor, update: bool) -> tuple:
        """(B, T, phase), then what else the capture bakes in: the params
        tree's identity and the inputs' names, shapes and dtypes."""
        B, T = batch["input_ids"].shape[:2]
        sig = tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
        return (int(B), int(T), "fold+update" if update else "fold", id(params), sig,
                tuple(speaker.shape), speaker.dtype)

    def step(self, params, batch: dict, speaker: torch.Tensor) -> dict:
        """One mini-step (`make_train_step`'s call): the replay of its
        key's graph, or, at the key's first call, the eager step and then
        the capture. Returns the losses (copies) and "updated"."""
        opt = self.optimizer
        with _LOCK:
            if opt.version != self.version:   # AdamW's state tensors were replaced
                self.graphs.clear()
                self.version = opt.version
            update = opt.begin()
            key = self.key(params, batch, speaker, update)
            g = self.graphs.get(key)
            if g is None:
                g, metrics = self._capture(params, batch, speaker, update)
                self.graphs[key] = g
                while len(self.graphs) > MAX_TRAIN_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
                g.load(batch, speaker)
                g.graph.replay(self.dev, None)
                metrics = {k: v.clone() for k, v in g.outputs.items()}
            opt.finish(update)
        metrics["updated"] = update
        return metrics

    def _capture(self, params, batch: dict, speaker: torch.Tensor, update: bool) -> tuple:
        dev = self.dev.device
        g = _TrainGraph(params, {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                                 for k, v in batch.items()},
                        torch.empty(speaker.shape, dtype=speaker.dtype, device=dev), {}, None)
        g.load(batch, speaker)
        first = {}

        def run(into):
            into.update(self.body(params, g.batch, g.speaker, update))

        # the warm pass is the real step; the body sets every grad to None
        # first, so the capture's backward allocates them from the pool
        g.graph = capture(self.dev, None, lambda _: run(first), lambda _: run(g.outputs))
        return g, {k: v.clone() for k, v in first.items()}


def stats(device) -> dict:
    """Graphs captured and replayed on `device` so far (every owner), decode
    contexts and their graphs, their static bytes, the vocoder's, the
    encode's and ECAPA's graphs and their static bytes, the training
    graphs, the DiT step's and CAM++'s graphs and their static bytes
    (`<program>_graphs`, `<program>_bytes`), and the bytes of the shared
    pool."""
    device = torch.device(device)
    dev = None
    if device.type == "cuda":
        dev = _DEVICES.get(torch.cuda.current_device() if device.index is None
                           else device.index)
    if dev is None:
        return {"captures": 0, "replays": 0, "contexts": 0, "graphs": 0, "static_bytes": 0,
                "codec_graphs": 0, "codec_bytes": 0, "encode_graphs": 0, "ecapa_graphs": 0,
                "front_bytes": 0, "train_graphs": 0,
                **{f"{p}_{k}": 0 for p in V1_PROGRAMS for k in ("graphs", "bytes")},
                "pool_bytes": 0}
    return {"captures": dev.captures, "replays": dev.replays, "contexts": len(dev.contexts),
            "graphs": sum(len(c.graphs) for c in dev.contexts.values()),
            "static_bytes": sum(c.nbytes() for c in dev.contexts.values()),
            "codec_graphs": len(dev.codec.graphs),
            "codec_bytes": sum(g.nbytes() for g in dev.codec.graphs.values()),
            "encode_graphs": len(dev.encode.graphs), "ecapa_graphs": len(dev.ecapa.graphs),
            "front_bytes": sum(g.nbytes() for o in (dev.encode, dev.ecapa)
                               for g in o.graphs.values()),
            "train_graphs": sum(len(t.graphs) for t in dev.train),
            **{f"{p}_graphs": len(getattr(dev, p).graphs) for p in V1_PROGRAMS},
            **{f"{p}_bytes": sum(g.nbytes() for g in getattr(dev, p).graphs.values())
               for p in V1_PROGRAMS},
            "pool_bytes": pool_bytes(dev)}


def pool_bytes(dev: _Device) -> int:
    """Bytes the caching allocator holds in the device's graph pool."""
    want = tuple(dev.pool)
    segs = torch.cuda.memory._snapshot(dev.device)["segments"]
    return sum(s["total_size"] for s in segs if tuple(s.get("segment_pool_id", ())) == want)


def clear(device=None) -> None:
    """Drop every decode context and every vocoder, front-end, 25 Hz
    tokenizer and training graph of `device` (every device: None). A
    context a live decode state still uses lives on until that state
    goes."""
    for index, dev in list(_DEVICES.items()):
        if device is None or torch.device(device).index in (None, index):
            dev.contexts.clear()
            dev.codec.graphs.clear()
            for o in (dev.encode, dev.ecapa, dev.campplus, dev.dit_step):
                o.graphs.clear()
                o.seen.clear()
            for t in list(dev.train):
                t.graphs.clear()
