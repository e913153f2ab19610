"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from qwen3_tts_tpu_torch/csrc
   (one nvcc per source, all started together);
   then, before any weights take memory, the bandwidth probes (slice 4,
   csrc/dma_peak.cu): each kernel against its twin on random data (small
   ragged shapes and the full default ones, both KV layouts, 1 and 3
   passes; exact integer sums, float lanes within 1e-6 relative, the weight
   column-sum sideband exact), then `utils/dma_peak.py`'s sweep in GB/s
   with each reading's share of the data-sheet rate (a reading above 105%
   fails: an L2 hit or skipped bytes, not bandwidth);
   slice 11, `misfit`: an int8 tiny talker with 4 query heads per kv head
   defaults to kernel 1 and to the plain talker step (kernel 2 does not
   take its shapes), runs `generate_custom_voice` without launching kernel
   2, and with a named fused_talker_step=True still raises; slice 15: that
   talker and an fp32 load with kernel 3's groups and head_dim each answer
   a non-streaming prompt of 384 tokens (past FLASH_PREFILL_MIN_T) without
   launching kernel 3 (`prefill_uses_flash`: `flash_misfit`'s rule is
   printed), their prefill graph and codes equal to `graphs.eager()`;
3. the flash prefill kernel's two products alone (`flash_tile_products`:
   TMA from strided views, the wgmma descriptors, the fragment layouts)
   against torch.matmul in fp32;
   the sub-talker and talker-step kernels (each one persistent cooperative
   launch on the layer engine of csrc/common.cuh) against their plain
   PyTorch twins on the card, at the 1.7B shapes with random int8 weights,
   B in {1, 8, 32} and past one launch's 32 rows as row tiles (48 for both,
   64 for the talker step): max errors, code agreement, kernel and twin
   times (CUDA events); each launch's grid and shared memory, and what one
   grid barrier costs; the engine's GEMM stage alone, bit for bit against
   `mm8` at the main path's eight (N, K) shapes and B in {1, 8, 32};
4. kernel 2's int8-KV mode against its twin at B in {1, 8, 32} over the
   main path's 256-slot buffer and at B in {1, 8, 2} over the clone call's
   KV buffer; the split-K attention there (B=2, both KV modes) against the
   one-pass twin and the twin in the kernel's split order, scalar and
   per-row write slots: one layer tight, full depth
   against the twin's card-vs-host spread; the device quantizer bit-equal to
   `kv_quantize` on rows built to catch a wrong one (rounding ties), the
   written int8 slot exactly `kv_quantize` of the kernel's own fresh K/V and
   the twin's slot wherever their bf16 inputs agree; every other slot and
   scale untouched; its time beside the bf16 mode's at the same window;
5. slice 1: an in-memory 1.7B int8 custom-voice model (random weights from
   a seed, default-width 12 Hz vocoder, stand-in text tokenizer) synthesises
   a few texts through `generate_custom_voice`, with a bf16 and then an int8
   KV cache, its frame loop as CUDA graph replays (runtime/graphs.py; each
   timed call after a warm-up call of its shape, which captures); the
   kernels' launch counters (which count every replayed launch) must move,
   the waveforms must be finite, 24 kHz, whole 1920-sample frames; then the
   graphed frame loop against the eager one (`graphs.eager()`), greedy and
   sampled from one seeded generator, bf16 and int8 KV: codes, lengths and
   hidden states equal, and the API call's wall, tick and RTF on each;
   slice 11: the prefill and first code0 as a replay of a prefill graph
   against the eager prefill (`prefill_ab`: KV cache max abs 0, first code0,
   last hidden, consts and the generator's state equal, the replay
   capturing nothing; then the whole frame result equal) with a bf16 and
   an int8 KV cache and on the stream's prompts; the call's wall split
   (`phase_split`) into clone front end, prompt assembly, prefill and
   first code, frame loop, vocoder and the rest, graphed and inside
   `graphs.eager()`, with the graph pool's bytes;
6. streaming: `stream_custom_voice(..., kv_quant=True)`: first-packet
   latency, packets, frames; the audio's samples must be the longest row's
   active frames x 1920; graphed against eager: the same chunks' codes and
   the same packets;
   slice 10, `codec_graphs`: the vocoder's captured graphs
   (`runtime/graphs.py` `CodecGraphs`) against the eager vocoder on the
   same codes, on every route: whole-call decode (float32 and int16),
   a stream's packet shapes, server egress at N in {1, 8} x F in {4, 25},
   the first-packet extract: float samples within 1e-5, PCM16 and counts
   equal, each graphed call one replay at least; device ms of each, graphed
   and eager; the stream's wall split into frame loop, vocoder and rest;
7. serving: a `TTSServer` (8 slots, kernel 2 in int8-KV mode) serves 12
   requests, half streamed, one cancelled mid-stream, one with a zero frame
   budget: every other request completes, the cancelled one yields nothing
   after its cancel; requests/s, audio s per wall s, first-packet p50/p95;
   its serve ticks as graph replays, then the same run on the eager loop:
   every request's codes equal;
   the server's serve step A/B: the same 6 requests (3 streamed, 16 frames)
   on the plain route, then on kernel 2, requests/s and first-packet p50 of
   each; the server's default must be the route that wins both; a
   48-slot server (both kernels as row tiles) drains 52 requests;
   slice 10, `server_warmup`: a fresh server's `TTSServer.warmup()`
   (seconds, serve and vocoder graphs captured, pool bytes), after which
   the 12-request mix must capture no graph (since slice 11 the staging
   prefill too is captured by it, one graph per request count, and the
   graphed and eager mixes' equal codes hold the staging graphs to the
   eager staging prefill); requests/s and first-packet
   p50/p95 warmed and cold (a fresh server without it), and the mix's wall
   split into frame loop, vocoder and rest;
   the graph layer: graphs captured and replayed, decode contexts, static
   and pool bytes, the vocoder's graphs; an eviction of every context
   while a stream is held after its first packet: a generate call
   re-captures and gives its earlier codes, the held stream finishes with an uninterrupted stream's
   codes; `warmup_model` over B in {1, 4} x prefill buckets {32, 64}, after
   which live calls of those shapes capture nothing; the front door:
   `ThreadedTTSServer` behind `_HttpDemo` on a localhost port, 8 concurrent
   POST /tts and 4 POST /tts_stream from worker threads, all audio of whole
   frames and together the frames the engine generated, a stream closed
   after its first packet frees its slot, the engine route serving all;
   slice 14, `vocoder_device`: servers of 2 slots serving 6 requests (2
   streamed, 32 frames), each warmed: one card with fast_first_packet off
   (the reference) and on; (a) the vocoder on the serving card named:
   codes equal, audio PCM16-equal and within 1e-5, no capture after the
   warm-up; (b) on the host's CPU: codes equal, audio within 1e-5 of the
   card's, the decoder params where they belong, no capture on the card;
   (c) on a second card where there is one (codes and PCM16
   equal, no capture on either card), else a line saying it did not run;
   requests/s, audio s per wall s, first packet p50 / p95 and the serving
   card's busy share (torch.profiler) of each;
   `serve_trace`: the serving path's tracing (`utils/profiling.py`) on a
   warmed server of 8 slots serving 16 streams with `trace_enabled` under
   torch.profiler: each device span's milliseconds positive and together
   no more than the wall, a `server.step` span within 1 ms of the
   `record_function` range around it in the profiler's trace (one clock),
   no span's name among the trace's device operations; the spans' share
   of the card's busy time and the benchmark's per-layer figures;
8. the clone model (the same talker as a base model, the speaker encoder at
   the released widths, the default-width Mimi encoder): a 10 s reference
   clip's codes and speaker embedding on the card against the host twins;
9. the flash prefill kernel against its twin at FLASH_CASES (B up to 4, T
   from 256 to 4096, ragged starts, a ragged T, windows of 512 and of 100
   keys) and at the clone's own prefill shape with q/k/v as strided views
   into one fused qkv tensor (as `decoder_stack` hands them over); its time
   beside the twin's, the bound's and SDPA's; whole `talker_prefill` calls,
   dense against flash, at B=4 and T in {256, 512, 1024, 2048}: where the
   route should switch (`FLASH_PREFILL_MIN_T`);
10. slice 2: `generate_voice_clone` (non-streaming ICL, B=2 texts of
   different lengths, so the prompt pads to T >= 2048 with ragged left
   padding), bf16 then int8 KV, must launch the flash prefill once per
   layer and both decode kernels, and give finite 24 kHz waveforms (the
   28 kernel-3 launches from one prefill graph replay: the timed call
   captures nothing); the clone prefill graphed against eager
   (`prefill_ab`) and the clone call's wall split;
   `stream_voice_clone` with the clip as vocoder context; a clone
   `TTSServer` (prefill bucket 512, kernel 3 inside its staging graphs)
   streams two ICL requests, each first packet the vocoder over its own
   reference frames, every code equal to the same run's inside
   `graphs.eager()`;
   slice 12, `front_graphs`: the clone front end's graphs (the 12 Hz
   encode per padded length, ECAPA per exact length, each captured at a
   length's second call) against the eager programs on a 9 s cut of the
   clip: codes equal, the x-vector within 1e-6; ms of a length's first
   call (eager), second (the capture), a replay and eager; the clone
   prompt's split into encode, ECAPA and host; 20 clip lengths encoded
   once (no capture) and again, after which the vocoder's graphs are the
   ones before; `clone server clips`: a warmed clone server (the encode of
   every reference bucket captured) meets 8 distinct clips and one repeat
   and captures nothing, an eager server meets 8 others; submit ms of
   both, the prompts through the warmed graphs equal to eager;
11. the 0.6B talker (`TALKER_0B6`, random int8 weights): kernel 1 without
   the small_to_mtp projection and kernel 2 at hidden 1024 against their
   twins at B=8, then `generate_custom_voice` of the smoke's texts;
12. slice 8, the 25 Hz (V1) tokenizer at its released widths (no kernel:
   plain PyTorch in fp32, TF32 off): a checkpoint directory of random
   weights written under build/ (config.json, model.safetensors,
   campplus.onnx) loaded through `Qwen3TTSTokenizer.from_pretrained`; a
   10 s clip encoded and decoded (encode s, decode s, decode RTF, peak
   memory); the mel, the encoder's codes (the share equal to the host's,
   every mismatch a near-tie of the 32768-way search), the x-vector, the
   reference mel, one DiT velocity evaluation and BigVGAN on a short mel,
   each against the same code on the host;
   slice 13, `v1_graphs`: the DiT sampler's step and CAM++ as captured
   graphs against `graphs.eager()` (the DiT mel within 1e-5, the x-vector
   within 1e-6, a replay equal to its capture's call), BigVGAN and the
   encode, which run eagerly, captured once to show they copy nothing
   from the host; ms of each at a key's first and second call, a replay
   and eager; the DiT's capture rule, a cold eager call beside a cold
   capture; the tokenizer graphed against eager on a seen and an unseen
   clip (codes, reference mel, PCM16 equal, waveform within 1e-5, no
   capture); 5 lengths of 2-20 s sent once, again, a third time, eagerly;
13. slice 8, SFT: four optimizer cycles of `make_train_step` at 1.7B in
   bf16 with the speaker encoder (ms per cycle, tokens/s, peak memory; the
   loss finite, the params and AdamW states moved); the loss and every
   gradient at full widths and 2 layers in fp32 against the host; then
   `sft.main` end to end on a 0.6B base checkpoint under build/, whose
   epoch checkpoint reloads as an int8 custom-voice model with the new
   speaker and speaks;
   slice 12, `sft_graphs`: those four cycles run as captured graphs (one
   per (B, T, phase), 2 captures in the first cycle and none after it),
   then four more inside `graphs.eager()`, 3 batches in turn: ms per
   cycle and tokens/s of each route, the graph pool's bytes; and a 2-layer
   fp32 step at 1.7B widths, graphed against eager from one start state
   over six mini-steps on 3 batches in turn (every replay meets inputs
   its capture never saw): losses, every leaf and both AdamW moments;
14. the native FLAC path: native/flac_fast.c built at first use
   into build/native/; a 10 s FLAC written by utils/flac.py decodes to the
   same samples through the C loops and the pure-Python path (both walls);
15. the DP / TP plans (parallel/mesh.py): two ranks sharing the
   card through gloo at TALKER_1B7's widths and 2 layers (PAR_LAYERS: the
   depth is cut for the smoke's time; fp32 params drawn on the host
   from the seed, each rank moving only its shard): tp=2 greedy fp32
   generation against the unsharded run (a differing code passes only as a
   near-tie: the top-2 gap is printed); a tp=2 bf16 prefill of an
   ICL-length batch, kernel 3 on each rank's 8 query / 4 KV heads held to
   its twin, the last hidden against the unsharded prefill; (1, 2) and
   (2, 1) engines against the unsharded engine; one SFT step at tp=2 and at
   dp=2 (2 layers, fp32) against the unsharded card run; a one-rank NCCL
   mesh; walls of ranks sharing one card, no throughput claim;
16. evaluation.py: `run_suite` over a base checkpoint (a clone
   row) and a custom-voice one (the tokenizer round trip over 2 synthetic
   24 kHz wavs, a custom-voice row), each against the same run on the host,
   the tokenizer's decoder scaled as the smoke's vocoders are; the audio
   levels of every wav read, round trip and synthesis row; the unavailable
   columns exactly the expected ones; `evaluate_tts_wer` with an injected
   ASR, card against host;
then the roofline of the custom-voice call (`utils/roofline.py`
`decode_roofline` with the rate `shaped_bw` measured above) and each decode
kernel's achievable floor beside its data-sheet bound; one JSON line with
every kernel's numbers, and the last line
{"ok": true, "device": {...}}.

Every 12 Hz vocoder of the smoke is its seed's draw with the weight
matrices scaled by VOC_WEIGHT_SCALE, and the 25 Hz draw's last BigVGAN conv
is scaled by V1_POST_SCALE (slice 15; the draws themselves clamp most
samples to +-1, which the `codec_graphs unscaled draw` and `codec25
unscaled draw` lines show); every phase that checks audio prints its RMS
and full-scale share and fails above MAX_FULL_SCALE_SHARE (`audio_levels`,
`unclamped`).

Imports nothing of JAX: the port runs on hosts that have no JAX installed.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from qwen3_tts_tpu_torch.utils.roofline import Peaks

SEED = 0
B_SET = (1, 8, 32)    # the decode kernels against their twins, and their times
# ... and past one launch's 32 rows (row tiles: 48 = 2 x 24, 64 = 2 x 32)
SUB_B_SET, STEP_B_SET = B_SET + (48,), B_SET + (48, 64)
B_MAIN = 8            # the batch whose numbers go into the JSON rows (the server's slots)
B_TWIN_ONCE = 32      # from here on the (slow) twins run one case per kernel
TEXTS = ["Hello from the port.", "A second sentence, a little longer.",
         "Short one.", "The fourth text closes the batch of four."]
MAX_NEW_TOKENS = 64
# The card's published peaks for the least time a kernel's work could take:
# utils/roofline.py (NVIDIA H100 SXM data sheet, dense; BENCH_* env overrides).
PEAKS = Peaks.from_env()
PEAK_BF16_FLOPS, PEAK_INT8_OPS = PEAKS.bf16_flops, PEAKS.int8_ops
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = PEAKS.fp32_flops, PEAKS.hbm_bytes
# Slice 2: two texts whose ICL prompts (reference text + text + 125 frames of
# a 10 s clip) pad to >= 2048 tokens, with different left padding per row.
CLONE_TEXT = "The quick brown fox jumps over the lazy dog near the river bank. "
CLONE_TEXTS = [CLONE_TEXT * 31, CLONE_TEXT * 25]
CLONE_REF_TEXT = "This is the reference recording of the voice to clone."
CLONE_REF_SECONDS = 10
CLONE_MAX_NEW_TOKENS = 48
CLONE_STREAM_TEXT = CLONE_TEXT * 2
# Serving: more requests than slots, so staging and installs mid-chunk run.
SERVE_SLOTS, SERVE_REQUESTS = 8, 12
# The server's vocoder device (slice 14): a mix of 6 requests, 2 streamed,
# over 2 slots at 32 frames, small enough for the route whose vocoder runs
# on the host's CPU (its warm-up vocodes every egress shape and completion
# batch there: 60.6 s of warm-up and a 16.0 s mix at 4 slots on the H100's
# host, 8 threads).
VOC_MIX = dict(slots=2, requests=6, streams=(0, 3), frames=32)
# The smoke's 12 Hz vocoders (`scaled_vocoder_params`): the seed's draw
# with every weight matrix scaled by VOC_WEIGHT_SCALE. At the default
# widths the draw itself (std 0.05) grows each layer's output ~5x and
# clamps every sample to +-1 (a full-scale share of 1.0000), so samples
# compared one by one would compare signs; scaled by 8 ** -0.5 each layer's
# gain is the same draw's at an eighth of the width, whose output stays
# inside [-1, 1] (pre-clamp std 0.043 at decoder_dim 192 on the CPU; RMS
# 0.0871 and no sample at full scale at the default widths on the H100).
# Every phase that holds audio to something prints its RMS and full-scale
# share and fails above MAX_FULL_SCALE_SHARE (`audio_levels`).
# (b): the CPU's vocoder against the card's on the same codes, fp32 with
# TF32 off on both: max abs 1.3e-6 on the H100's host (8 threads), so
# the vocoder's graphed-against-eager bound, 1e-5 (CODEC_TOL), holds it.
VOC_CPU_TOL = 1e-5
VOC_WEIGHT_SCALE = 8 ** -0.5
MAX_FULL_SCALE_SHARE = 0.01
CODEC_TOL = 1e-5              # the vocoder graphed against eager, float samples (max abs)
CODEC_ITERS = 5
# A streamed clone packet vocoded again from its own context and frames: the
# same fp32 vocoder on a batch of one row instead of the server's batch
# (cuDNN may pick other algorithms), so agreement to float noise; another
# request's context changes the audio far more.
CLONE_CTX_TOL = 1e-3
MIN_CODEC_AGREEMENT = 0.9     # Mimi codes, card against the host twin
SPK_REL_TOL = 1e-3            # speaker embedding, card against the host twin
# flash prefill against its twin (fp32 math on the same bf16 inputs): bf16
# output rounding and bf16 probabilities in the P.V product, unit-scale
# inputs. At unit scale a row that averages ~2000 keys has outputs of only
# ~0.03, so the absolute bar alone would pass a kernel that drops a key tile
# there; each valid (position, head) row is also held to a relative L2 error
# (bf16 rounding gives ~0.3%; one 64-key tile missed out of n keys ~8/sqrt(n),
# 17% at n = 2280).
FLASH_TOL = 3e-2
FLASH_ROW_REL_TOL = 1e-2
FLASH_CASES = [  # (B, T, starts, sliding window)
    (1, 2048, (0,), None),
    (4, 2048, (0, 129, 700, 1500), None),
    (4, 2048, (0, 129, 700, 1500), 512),
    (4, 2048, (0, 129, 700, 1500), 100),     # a window smaller than one 128-key tile
    (3, 2100, (0, 77, 2050), None),          # T not a multiple of 128
    (4, 256, (0, 9, 60, 130), None),         # the flash/dense threshold's range
    (4, 512, (0, 33, 200, 400), None),
    (4, 1024, (0, 65, 300, 900), None),
    (1, 4096, (0,), None),
    (4, 4096, (0, 333, 1400, 3000), None),
]
# The kernel's two products alone (`flash_tile_products`: TMA from strided
# views, the wgmma descriptors, the fragment layouts) against torch.matmul
# in fp32 on the same bf16 tiles: within bf16 rounding of the largest value
# (the products are exact in fp32; only the order of the fp32 sums differs).
FLASH_TILE_REL_TOL = 2 ** -8
FLASH_TILE_CASES = [(0, 0, 0, 0), (1, 5, 64, 128), (1, 15, 256, 256), (0, 9, 192, 128)]
# The flash/dense threshold: whole talker_prefill calls at B=4 (ragged
# left padding), dense against flash, in one run.
PREFILL_AB_T = (256, 512, 1024, 2048)
# The server's route A/B: the same short mix served plain and fused, in
# ROUTE_ROUNDS measured rounds a route (one round's wall is well under a
# second, so a single round is at the mercy of the host's load).
ROUTE_SLOTS, ROUTE_REQUESTS, ROUTE_FRAMES, ROUTE_ROUNDS = 8, 6, 16, 5
# A server past one launch's rows: every slot busy, drained.
WIDE_SLOTS, WIDE_REQUESTS, WIDE_FRAMES = 48, 52, 12
# Kernel vs twin. The twin (plain PyTorch, the reference's exact math) is
# chaotic in sum order: bf16 activations re-quantised to int8 at every
# matmul turn a one-ulp difference into a one-bucket step that the next
# layers amplify. Measured on the H100: the twin on the card against the
# same twin on the host differs by 3-10% relative L2 after the 28 talker
# layers and disagrees on ~0.4% of sub-talker codes. So each kernel is held
# (a) tightly where nothing accumulates and (b) against the reference's own
# spread, measured in this run, where it does.
ONE_LAYER_REL_TOL = 2e-2      # one talker layer, full widths
SPREAD_FACTOR, SPREAD_SLACK = 1.5, 2e-2   # full depth: <= 1.5 x spread + 0.02
MIN_CODE_AGREEMENT = 0.9      # sub-talker codes against the twin on the host
INT8_CLONE_B = 2              # the clone call's batch, timed at its window
B_SET_LONG = (1, 8)           # ... beside these
# the kernel's split-K attention against the twin in the same split order:
# the same operations, f32 sums inside a chunk in another order
SPLIT_TWIN_REL_TOL = 5e-3
EMB_TOL = dict(rtol=0.05, atol=0.02)   # emb_sum of fully agreeing rows
# The bandwidth probes against their twins: integer sums (the stream, the
# weight column sums) exactly; the shaped probe's lanes, whose K/V and vector
# parts the kernel sums in double, within 1e-6 of the float64 twin's f32
# value (the two differ by f32 rounding, ~6e-8). Small ragged shapes (a last
# item of 40 of 64 rows; 3-row items over 7 rows; weight items of 256, 256
# and 88 rows; K/V items of 16, 16 and 3 runs), then the default ones.
PROBE_REL_TOL = 1e-6
PROBE_STREAM_CASES = [(1000, 64), (7, 3)]          # (rows, block_rows)
PROBE_SHAPED_CASES = [dict(L=3, B=5, Hkv=7, Sc=128, S_buf=384, Wr=600, H=2048),
                      dict(L=2, B=2, Hkv=2, Sc=8, S_buf=16, Wr=16, H=256),
                      dict(S_buf=256), dict(S_buf=1024)]
PROBE_MAX_SHARE = 1.05        # of the data-sheet rate: above it, not bandwidth


T_START = time.time()


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items())
          + f" at_s={time.time() - T_START:.1f}", flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after one warm-up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(nbytes: float, ops=()):
    """(ms, "bytes" or "operations"): the least time the card could take for
    work that moves `nbytes` (each input read once, each output written
    once) and does `ops` ((count, peak rate) pairs), the larger of the two."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max([n / rate for n, rate in ops], default=0.0)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tree_bytes(tree) -> int:
    from qwen3_tts_tpu_torch.weights import map_tensors

    total = []
    map_tensors(tree, lambda t: total.append(t.numel() * t.element_size()))
    return sum(total)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def audio_levels(*wavs) -> dict:
    """The RMS and the share of samples at full scale (+-1 in float, +-32767
    in PCM16) over `wavs` (numpy arrays or tensors), as a phase's line
    fields."""
    x = np.concatenate([np.asarray(w.cpu() if torch.is_tensor(w) else w).reshape(-1)
                        for w in wavs])
    full = 32767 if x.dtype == np.int16 else 1.0
    y = x.astype(np.float64) / full
    return {"audio_rms": float(np.sqrt(np.mean(y ** 2))) if y.size else 0.0,
            "full_scale_share": float(np.mean(np.abs(y) >= 1.0)) if y.size else 0.0}


def unclamped(tag: str, levels: dict) -> dict:
    """`levels` (`audio_levels`), after failing where more than
    MAX_FULL_SCALE_SHARE of the samples sit at full scale: audio checks
    there would compare signs, not amplitudes."""
    if levels["full_scale_share"] > MAX_FULL_SCALE_SHARE:
        raise AssertionError(f"{tag}: {levels['full_scale_share']:.4f} of the samples at full "
                             f"scale (bar {MAX_FULL_SCALE_SHARE}), RMS {levels['audio_rms']:.4g}")
    return levels


def _counters() -> dict:
    """name -> (wrapper, attribute) of every kernel launch counter."""
    from qwen3_tts_tpu_torch.ops.cuda.dma_peak import shaped_sum, stream_sum
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import flash_prefill
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache

    return {"flash_prefill": (flash_prefill, "launches"),
            "subtalker": (subtalker_frame_fused, "launches"),
            "talker_step": (talker_step_fused_cache, "launches"),
            "talker_step_int8_kv": (talker_step_fused_cache, "launches_int8_kv"),
            "stream_bw": (stream_sum, "launches"),
            "shaped_bw": (shaped_sum, "launches")}


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for wrapper, attr in _counters().values():
        setattr(wrapper, attr, 0)


def read_launches() -> dict:
    return {name: getattr(wrapper, attr) for name, (wrapper, attr) in _counters().items()}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = card()
    print(smi, flush=True)
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from qwen3_tts_tpu_torch.ops.cuda import build

    t0 = time.time()
    path = build.build()
    build.load_library()
    line("build", seconds=f"{time.time() - t0:.1f}", library=path.name)


def model_params(cfg, device):
    """Random 1.7B talker params from the seed, int8. Norm weights get a
    small per-layer jitter (the fabrication draws ones) so a kernel reading
    another layer's norm would show."""
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.weights import quantize_talker_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = random_talker_params(cfg, gen, dtype=torch.bfloat16)
    for layers in (params["layers"], params["code_predictor"]["layers"]):
        for norm in (layers["input_layernorm"], layers["post_attention_layernorm"],
                     layers["self_attn"]["q_norm"], layers["self_attn"]["k_norm"]):
            w = norm["weight"]
            norm["weight"] = (1 + 0.1 * torch.randn(w.shape, generator=gen, device=device)
                              ).to(w.dtype)
    return quantize_talker_params(params)


def to_host(tree):
    from qwen3_tts_tpu_torch.weights import map_tensors

    return map_tensors(tree, lambda t: t.cpu())


def phase_subtalker(params, cfg, device, b_set=SUB_B_SET, label="") -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import (subtalker_frame_fused,
                                                        subtalker_frame_ref)
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams, gumbel_noise

    cp, cp_cfg = params["code_predictor"], cfg.code_predictor_config
    cp_host = to_host(cp)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    Qm1, V = cp["lm_heads"].shape[:2]
    out = {"agree": [], "agree_card_twin": [], "twin_spread": [], "err": 0.0,
           "ms": {}, "plain_ms": {}}
    sampled = SamplingParams(do_sample=True, top_k=50, temperature=0.9)
    for B in b_set:
        once = B >= B_TWIN_ONCE
        h = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.5
             ).to(torch.bfloat16)
        c0 = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.5
              ).to(torch.bfloat16)
        g = gumbel_noise((Qm1, B, V), gen, device)
        # per-row sampling rows are what the main path passes (greedy rows
        # mixed in here): one SamplingParams, or rows, per case
        rows = torch.tensor(np.stack([
            (SamplingParams(do_sample=False) if b % 3 == 0 else
             SamplingParams(do_sample=True, top_k=50 if b % 3 == 1 else 0,
                            temperature=0.9)).as_row() for b in range(B)]),
            device=device)
        for sampling, r in ((SamplingParams(do_sample=False), None), (sampled, None),
                            (None, rows))[2 if once else 0:]:
            ck, ek = subtalker_frame_fused(cp, cp_cfg, h, c0, sampling, rows=r, gumbel=g)
            cr, _ = subtalker_frame_ref(cp, cp_cfg, h, c0, sampling, rows=r, gumbel=g)
            ch, eh = subtalker_frame_ref(cp_host, cp_cfg, h.cpu(), c0.cpu(), sampling,
                                         rows=None if r is None else r.cpu(),
                                         gumbel=g.cpu())
            ck, ek = ck.cpu(), ek.cpu()
            same = ck == ch
            out["agree"].append(float(same.float().mean()))
            out["agree_card_twin"].append(float((ck == cr.cpu()).float().mean()))
            out["twin_spread"].append(float((cr.cpu() != ch).float().mean()))
            full = same.all(dim=1)
            if bool(full.any()):
                out["err"] = max(out["err"], max_abs(ek[full], eh[full]))
                if not torch.allclose(ek[full].float(), eh[full].float(), **EMB_TOL):
                    raise AssertionError(f"sub-talker emb_sum off at B={B}: "
                                         f"max_abs={max_abs(ek[full], eh[full])}")
        out["ms"][B] = cuda_ms(lambda: subtalker_frame_fused(
            cp, cp_cfg, h, c0, sampled, gumbel=g), 20)
        out["plain_ms"][B] = cuda_ms(lambda: subtalker_frame_ref(
            cp, cp_cfg, h, c0, sampled, gumbel=g), 1 if once else 3)
    out["geometry"] = engine_geometry("subtalker_frame_fused", subtalker_frame_fused)
    # bound at the main batch: every layer weight byte, the lm heads and the
    # projection read once, the sampled embedding rows and the noise; every
    # one of the Q positions runs every layer weight (int8) and each step one
    # lm head (bf16)
    B, Q = B_MAIN, Qm1 + 1
    Ht, Hc = cfg.hidden_size, cp_cfg.hidden_size
    layer_elems = sum(cp["layers"][grp][name]["weight"]["q"].numel()
                      for grp, names in (("self_attn", ("qkv_proj", "o_proj")),
                                         ("mlp", ("gate_up_proj", "down_proj")))
                      for name in names)
    nbytes = (tree_bytes(cp["layers"]) + tree_bytes(cp["lm_heads"]) + tree_bytes(cp["proj"])
              + Qm1 * B * Ht * 2 + Qm1 * B * V * 4 + 3 * B * Ht * 2 + B * Qm1 * 4)
    bf16_flops = 2 * B * Qm1 * V * Hc + (2 * B * Q * Hc * Ht if cp["proj"] is not None else 0)
    out["bound_ms"], out["bound_by"] = bound(nbytes, [(2 * B * Q * layer_elems, PEAK_INT8_OPS),
                                                      (bf16_flops, PEAK_BF16_FLOPS)])
    # what the kernel reads instead: every layer weight at each of the Q
    # positions (78 MB at 1.7B fits neither the L2 nor shared memory)
    out["streamed_bytes"] = nbytes + (Q - 1) * layer_elems
    agree = float(np.mean(out["agree"]))
    line("kernel subtalker" + label, code_agreement_vs_host_twin=f"{agree:.4f}",
         code_agreement_vs_card_twin=f"{np.mean(out['agree_card_twin']):.4f}",
         twin_card_vs_host_disagreement=f"{np.mean(out['twin_spread']):.4f}",
         emb_sum_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in b_set},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in b_set},
         **{f"bound_ms_B{B_MAIN}": f"{out['bound_ms']:.4f}"})
    if agree < MIN_CODE_AGREEMENT:
        raise AssertionError(f"sub-talker kernel/twin code agreement {out['agree']}")
    return out


def decode_state(cfg, B, S_buf, ci, device, gen):
    """Random bf16 KV history, ragged validity, one fresh embedding."""
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
    k = (torch.randn((L, B, Hkv, S_buf, D), generator=gen, device=device) * 0.5
         ).to(torch.bfloat16)
    v = (torch.randn((L, B, Hkv, S_buf, D), generator=gen, device=device) * 0.5
         ).to(torch.bfloat16)
    slot = torch.arange(S_buf, device=device)[None, :]
    start = torch.randint(0, 4, (B, 1), generator=gen, device=device)
    kv_valid = (slot >= start) & (slot <= ci)
    embed = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.3
             ).to(torch.bfloat16)
    position = torch.full((B,), ci, dtype=torch.int32, device=device)
    return k, v, kv_valid, embed, position


def _step_outputs(fn, params, cfg, state, ci, scales=None):
    """Run one talker step on copies of the cache (ci: an int, or (B,) per-row
    slots; scales: the int8 cache's (k_scale, v_scale)); returns (logits,
    hidden, the written k/v slots, dequantized in int8 mode, and there the
    raw int8 slots and their scales too) and whether every other cache slot,
    and every other scale, is untouched."""
    k, v, kv_valid, embed, position = state
    B, S = k.shape[1], k.shape[3]
    cis = [int(c) for c in ci] if torch.is_tensor(ci) else [ci] * B
    k2, v2 = k.clone(), v.clone()
    sc2 = None if scales is None else tuple(x.clone() for x in scales)
    kw = {} if sc2 is None else dict(k_scale=sc2[0], v_scale=sc2[1])
    lg, h = fn(params, cfg, embed, position, ci, kv_valid, k2, v2, **kw)[:2]
    keep = torch.ones((B, S), dtype=torch.bool)
    keep[torch.arange(B), cis] = False
    pairs = [(k2, k), (v2, v)] + ([] if scales is None else list(zip(sc2, scales)))
    intact = all(bool(torch.equal(a.cpu().transpose(0, 1).transpose(1, 3)[keep],
                                  b.cpu().transpose(0, 1).transpose(1, 3)[keep]))
                 for a, b in pairs)

    def slots(c):
        return torch.stack([c[:, b, :, i] for b, i in enumerate(cis)], dim=1)

    out = {"logits": lg, "hidden": h}
    if scales is None:
        out.update(k_slot=slots(k2), v_slot=slots(v2))
        return out, intact
    raw = {"k_q": slots(k2), "v_q": slots(v2), "k_s": slots(sc2[0]), "v_s": slots(sc2[1])}
    out.update(k_slot=raw["k_q"].float() * raw["k_s"][..., None],
               v_slot=raw["v_q"].float() * raw["v_s"][..., None])
    return out, intact, raw


def _rel_errs(a: dict, b: dict) -> dict:
    return {n: rel_err(a[n].cpu(), b[n].cpu()) for n in a}


def talker_step_bound(params, cfg, B: int, slots: int, kv_bytes: int) -> tuple:
    """The talker step's bound: every layer weight byte once, the valid KV
    slots of the window once (`kv_bytes` per (layer, slot, kv head) for K
    and V together, scales included; the data decides how many slots), the
    new slot written; int8 products over every weight, fp32 attention over
    the slots."""
    L, Hkv, D, H = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                    cfg.resolved_head_dim, cfg.hidden_size)
    layer_elems = sum(params["layers"][grp][name]["weight"]["q"].numel()
                      for grp, names in (("self_attn", ("qkv_proj", "o_proj")),
                                         ("mlp", ("gate_up_proj", "down_proj")))
                      for name in names)
    nbytes = (tree_bytes(params["layers"]) + tree_bytes(params["norm"])
              + L * Hkv * kv_bytes * (slots + B) + 2 * B * H * 2)
    return bound(nbytes, [(2 * B * layer_elems, PEAK_INT8_OPS),
                          (4 * cfg.num_attention_heads * D * slots * L, PEAK_FP32_FLOPS)])


def phase_talker_step(params, cfg, device, S_buf: int, b_set=STEP_B_SET, label="") -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import (talker_step_fused_cache,
                                                          talker_step_ref)
    from qwen3_tts_tpu_torch.weights import map_tensors

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ci = S_buf // 2
    params_host = to_host(params)
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    params1 = dict(params, layers=map_tensors(params["layers"], lambda t: t[:1].contiguous()))
    out = {"err": 0.0, "one_layer": 0.0, "full": 0.0, "spread": 0.0, "ms": {},
           "plain_ms": {}}
    for B in b_set:
        state = decode_state(cfg, B, S_buf, ci, device, gen)
        # (a) one layer at full widths: nothing accumulates, hold tight
        state1 = tuple(t[:1] if i < 2 else t for i, t in enumerate(state))
        k1, intact1 = _step_outputs(talker_step_fused_cache, params1, cfg1, state1, ci)
        r1, _ = _step_outputs(talker_step_ref, params1, cfg1, state1, ci)
        one = max(_rel_errs(k1, r1).values())
        # ... and with per-row write slots (the serving engine's form)
        ci_rows = torch.tensor([ci - 9 * b % 120 for b in range(B)], dtype=torch.int32,
                               device=device)
        slot = torch.arange(S_buf, device=device)[None, :]
        state_rows = (state1[0], state1[1], state1[2] & (slot <= ci_rows[:, None]),
                      state1[3], ci_rows)
        kr1, intact_rows = _step_outputs(talker_step_fused_cache, params1, cfg1,
                                         state_rows, ci_rows)
        rr1, _ = _step_outputs(talker_step_ref, params1, cfg1, state_rows, ci_rows)
        one = max(one, *_rel_errs(kr1, rr1).values())
        intact1 = intact1 and intact_rows
        # (b) full depth against the twin on the card; the twin on the host
        # gives the reference's own sum-order spread
        ko, intact = _step_outputs(talker_step_fused_cache, params, cfg, state, ci)
        ro, _ = _step_outputs(talker_step_ref, params, cfg, state, ci)
        ho, _ = _step_outputs(talker_step_ref, params_host, cfg,
                              tuple(t.cpu() for t in state), ci)
        full = max(_rel_errs(ko, ro).values())
        spread = max(_rel_errs(ro, ho).values())
        out["one_layer"] = max(out["one_layer"], one)
        out["full"] = max(out["full"], full)
        out["spread"] = max(out["spread"], spread)
        out["err"] = max(out["err"], max_abs(ko["logits"], ro["logits"]))
        if not (intact and intact1):
            raise AssertionError("talker step kernel wrote outside its cache slot")
        if not one <= ONE_LAYER_REL_TOL:
            raise AssertionError(f"talker step, one layer, B={B}: rel err {one:.3g}")
        if not full <= SPREAD_FACTOR * spread + SPREAD_SLACK:
            raise AssertionError(f"talker step, full depth, B={B}: rel err {full:.3g} "
                                 f"vs the twin's own spread {spread:.3g}")
        k, v, kv_valid, embed, position = state
        out["ms"][B] = cuda_ms(lambda: talker_step_fused_cache(
            params, cfg, embed, position, ci, kv_valid, k, v), 20)
        out["plain_ms"][B] = cuda_ms(lambda: talker_step_ref(
            params, cfg, embed, position, ci, kv_valid, k, v), 1 if B >= B_TWIN_ONCE else 3)
        if B == B_MAIN:   # bf16 K and V: 4 bytes per element pair
            out["bound_ms"], out["bound_by"] = talker_step_bound(
                params, cfg, B, int(kv_valid.sum()), 4 * cfg.resolved_head_dim)
        del state, k, v
        torch.cuda.empty_cache()
    out["geometry"] = engine_geometry("talker_step_fused_cache", talker_step_fused_cache)
    line("kernel talker_step" + label, S_buf=S_buf,
         one_layer_max_rel_err=f"{out['one_layer']:.3g}",
         full_depth_max_rel_err=f"{out['full']:.3g}",
         twin_card_vs_host_rel_spread=f"{out['spread']:.3g}",
         logits_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in b_set},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in b_set},
         **{f"bound_ms_B{B_MAIN}": f"{out['bound_ms']:.4f}"})
    return out


def engine_geometry(name: str, wrapper) -> tuple:
    """(grid, shared-memory bytes) of the cooperative launch `wrapper` made
    last, printed on a line of its own."""
    from qwen3_tts_tpu_torch.ops.cuda import build

    lib = build.load_library()
    fn = {"subtalker_frame_fused": lib.qt_subtalker_frame_geometry,
          "talker_step_fused_cache": lib.qt_talker_step_geometry}[name]
    grid, smem = build.launch_geometry(fn, wrapper.last_args)
    line("engine launch", kernel=name, B=wrapper.last_args.B, cooperative_grid=grid,
         threads=512, dynamic_smem_bytes=smem,
         sms=torch.cuda.get_device_properties(0).multi_processor_count)
    return grid, smem


def phase_engine_gemm(params, cfg, device) -> dict:
    """The engine's GEMM stage alone (`engine_gemm`) against `mm8` of the
    twin, bit for bit, at the main path's eight (N, K) shapes (the talker's
    and the code predictor's qkv, o, gate_up in its paired tiling, and down
    per MLP segment; layer 0's weights and scales) and B in {1, 8, 32}; and
    what one grid barrier costs (a launch of 1000 barriers and nothing
    else, beside one of none)."""
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import (engine_gemm, grid_barriers, mm8,
                                                          pick_mlp_chunks)

    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    cases = 0
    for name, layers in (("talker", params["layers"]),
                         ("code_predictor", params["code_predictor"]["layers"])):
        attn, mlp = layers["self_attn"], layers["mlp"]
        inter = mlp["gate_up_proj"]["weight"]["q"].shape[1] // 2
        for proj, tree, nseg, paired in (
                ("qkv", attn["qkv_proj"], 1, False), ("o", attn["o_proj"], 1, False),
                ("gate_up", mlp["gate_up_proj"], 1, True),
                ("down", mlp["down_proj"], pick_mlp_chunks(inter) if name == "talker" else 1,
                 False)):
            wq, ws = tree["weight"]["q"][0], tree["weight"]["s"][0]
            N, K = wq.shape
            seg = K // nseg
            for B in (1, 8, 32):
                x = torch.randn((B, K), generator=gen, device=device).to(torch.bfloat16)
                for c in range(nseg):
                    cols = slice(c * seg, (c + 1) * seg)
                    got = engine_gemm(x[:, cols], wq[:, cols], ws, paired)
                    want = mm8(x[:, cols], wq[:, cols], ws)
                    off = int((got != want).sum())
                    if off:
                        raise AssertionError(
                            f"engine GEMM stage {name} {proj} (N={N}, K={K}, segment {c} of "
                            f"{nseg}), B={B}: {off} of {got.numel()} outputs differ from mm8")
                    cases += 1
    ms = cuda_ms(lambda: grid_barriers(1000, device), 5)
    ms0 = cuda_ms(lambda: grid_barriers(0, device), 5)
    out = {"cases": cases, "barrier_us": (ms - ms0)}   # 1000 barriers: ms over 1000 = us each
    line("engine GEMM stage vs mm8", shapes=8, B=[1, 8, 32], cases=cases, outputs_off=0,
         grid_barrier_us=f"{out['barrier_us']:.3f}", empty_launch_ms=f"{ms0:.4f}")
    return out


def phase_split_attention(params, cfg, device, S_buf: int, ci: int) -> dict:
    """The split-K decode attention at the clone window (B = INT8_CLONE_B
    over S_buf slots, one layer at full widths, bf16 and int8 KV): the
    kernel against the one-pass twin (ONE_LAYER_REL_TOL, as every one-layer
    check) and against the twin in the kernel's own split order
    (`kv_splits=`: SPLIT_TWIN_REL_TOL)."""
    from qwen3_tts_tpu_torch.models.talker import kv_quantize
    from qwen3_tts_tpu_torch.ops.cuda import build
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import (pick_kv_splits,
                                                          talker_step_fused_cache,
                                                          talker_step_ref)
    from qwen3_tts_tpu_torch.weights import map_tensors

    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    B = INT8_CLONE_B
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    params1 = dict(params, layers=map_tensors(params["layers"], lambda t: t[:1].contiguous()))
    splits = pick_kv_splits(B, cfg.num_key_value_heads, S_buf, build.sm_count(device))
    if splits < 2:
        raise AssertionError(f"split-K phase: {splits} split at B={B}, S={S_buf}")

    def split_twin(*a, **kw):
        return talker_step_ref(*a, kv_splits=splits, **kw)

    k, v, kv_valid, embed, position = decode_state(cfg1, B, S_buf, ci, device, gen)
    (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
    out = {"splits": splits}
    for mode, state, scales in (("bf16_kv", (k, v, kv_valid, embed, position), None),
                                ("int8_kv", (kq, vq, kv_valid, embed, position), (ks, vs))):
        got = _step_outputs(talker_step_fused_cache, params1, cfg1, state, ci, scales)
        launched = talker_step_fused_cache.last_args.kv_splits
        one = _step_outputs(talker_step_ref, params1, cfg1, state, ci, scales)
        spl = _step_outputs(split_twin, params1, cfg1, state, ci, scales)
        if launched != splits:
            raise AssertionError(f"split-K phase: the kernel ran {launched} splits, the twin "
                                 f"{splits}")
        e_one = max(_rel_errs(got[0], one[0]).values())
        e_spl = max(_rel_errs(got[0], spl[0]).values())
        out[mode] = (e_one, e_spl)
        if not (got[1] and e_one <= ONE_LAYER_REL_TOL and e_spl <= SPLIT_TWIN_REL_TOL):
            raise AssertionError(f"split-K attention, {mode}, B={B}, S={S_buf}, {splits} "
                                 f"splits: rel err {e_one:.3g} vs the one-pass twin (bar "
                                 f"{ONE_LAYER_REL_TOL}), {e_spl:.3g} vs the split twin (bar "
                                 f"{SPLIT_TWIN_REL_TOL}), cache intact: {got[1]}")
    line("kernel talker_step split-K attention", B=B, S_buf=S_buf, ci=ci, splits=splits,
         **{f"{m}_rel_err_vs_one_pass_twin": f"{out[m][0]:.3g}" for m in ("bf16_kv", "int8_kv")},
         **{f"{m}_rel_err_vs_split_twin": f"{out[m][1]:.3g}" for m in ("bf16_kv", "int8_kv")})
    return out


def phase_kv_quantizer(device) -> dict:
    """The int8-KV store of kernel 2 (`store_kv`, through `kv_store_rows`)
    against `kv_quantize` on the host, bit for bit, over rows built to
    catch a wrong quantizer: every rounding tie of four power-of-two
    scales, the values where a reciprocal multiply rounds otherwise, a zero
    row, a row below the 1e-8 floor, Gaussian rows."""
    from qwen3_tts_tpu_torch.models.talker import kv_quantize
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import kv_store_rows
    from qwen3_tts_tpu_torch.utils.testing import kv_quantizer_probe, kv_quantizer_traps

    x = kv_quantizer_probe()
    traps = kv_quantizer_traps(x)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = kv_store_rows(xb.to(device))
    want_q, want_s = kv_quantize(xb)
    bad_q = int((q.cpu() != want_q).sum())
    bad_s = int((s.cpu() != want_s).sum())
    out = {"rows": x.shape[0], "ties": int(traps["ties"].sum()),
           "reciprocal": int(traps["reciprocal"].sum())}
    line("kernel talker_step int8-KV quantizer", **out, int8_values_off=bad_q,
         scales_off=bad_s)
    if bad_q or bad_s:
        raise AssertionError(f"int8-KV store vs kv_quantize: {bad_q} values and {bad_s} "
                             "scales differ")
    return out


def check_int8_slot(kraw, rraw, k16, r16) -> tuple:
    """The int8 slot one talker layer wrote, exactly: (a) on every (row, KV
    head) it is `kv_quantize` of the fresh bf16 K/V the kernel computed
    (`k16`, its bf16 mode's slot); (b) on every (row, KV head) whose fresh
    bf16 row equals the twin's (`r16`) it equals the twin's int8 row and
    scale. Returns (rows, rows with equal bf16 inputs)."""
    from qwen3_tts_tpu_torch.models.talker import kv_quantize

    rows = same = 0
    for name, qn, sn in (("k_slot", "k_q", "k_s"), ("v_slot", "v_q", "v_s")):
        fresh, twin = k16[name].cpu(), r16[name].cpu()
        got_q, got_s = kraw[qn].cpu(), kraw[sn].cpu()
        want_q, want_s = kv_quantize(fresh)
        eq = (fresh == twin).all(dim=-1)
        if not (torch.equal(got_q, want_q) and torch.equal(got_s, want_s)):
            raise AssertionError(f"int8-KV {name}: not kv_quantize of the kernel's own "
                                 f"bf16 row on {int((got_q != want_q).sum())} values, "
                                 f"{int((got_s != want_s).sum())} scales")
        if not (torch.equal(got_q[eq], rraw[qn].cpu()[eq])
                and torch.equal(got_s[eq], rraw[sn].cpu()[eq])):
            raise AssertionError(f"int8-KV {name}: off the twin's where the bf16 inputs agree")
        rows += eq.numel()
        same += int(eq.sum())
    return rows, same


def phase_talker_step_int8(params, cfg, device, windows) -> dict:
    """Kernel 2's int8-KV mode against its twin at B in B_SET over each
    (S_buf, ci) of `windows`, scalar and per-row slots; its time beside the
    bf16 mode's at the same window. The int8 history is the bf16 one of
    `decode_state` through `kv_quantize`."""
    from qwen3_tts_tpu_torch.models.talker import kv_quantize
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import (talker_step_fused_cache,
                                                          talker_step_ref)
    from qwen3_tts_tpu_torch.weights import map_tensors

    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    params_host = to_host(params)
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    params1 = dict(params, layers=map_tensors(params["layers"], lambda t: t[:1].contiguous()))
    out = {"err": 0.0, "one_layer": 0.0, "full": 0.0, "spread": 0.0, "slot_rows": 0,
           "slot_rows_equal_inputs": 0, "rows": []}
    out["probe"] = phase_kv_quantizer(device)
    for S_buf, ci in windows:
        # B=32 over the main path's buffer only: at the clone window its
        # caches and host twin would take minutes
        for B in (B_SET if S_buf == windows[0][0] else B_SET_LONG + (INT8_CLONE_B,)):
            k, v, kv_valid, embed, position = decode_state(cfg, B, S_buf, ci, device, gen)
            (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
            state, scales = (kq, vq, kv_valid, embed, position), (ks, vs)
            # (a) one layer, scalar and per-row slots: outputs against the
            # twin's on the card, and the written int8 slot and its scales
            # exactly (check_int8_slot)
            ci_rows = torch.tensor([ci - 9 * b % 120 for b in range(B)], dtype=torch.int32,
                                   device=device)
            slot = torch.arange(S_buf, device=device)[None, :]
            one, intact = 0.0, True
            for c, valid in ((ci, kv_valid), (ci_rows, kv_valid & (slot <= ci_rows[:, None]))):
                st1 = (kq[:1], vq[:1], valid, embed, position)
                sc1 = (ks[:1], vs[:1])
                kk, ok_k, kraw = _step_outputs(talker_step_fused_cache, params1, cfg1, st1,
                                               c, sc1)
                rr, _, rraw = _step_outputs(talker_step_ref, params1, cfg1, st1, c, sc1)
                one = max(one, *_rel_errs(kk, rr).values())
                intact = intact and ok_k
                # each side's fresh bf16 K/V of the layer: its bf16 mode
                # writes them into the slot (the same projection and rope)
                st16 = (k[:1], v[:1], valid, embed, position)
                k16, _ = _step_outputs(talker_step_fused_cache, params1, cfg1, st16, c)
                r16, _ = _step_outputs(talker_step_ref, params1, cfg1, st16, c)
                n, same = check_int8_slot(kraw, rraw, k16, r16)
                out["slot_rows"] += n
                out["slot_rows_equal_inputs"] += same
            # (b) full depth against the twin on the card, the twin on the host
            # giving the reference's own sum-order spread
            ko, ok_full, _ = _step_outputs(talker_step_fused_cache, params, cfg, state, ci,
                                           scales)
            ro, _, _ = _step_outputs(talker_step_ref, params, cfg, state, ci, scales)
            ho, _, _ = _step_outputs(talker_step_ref, params_host, cfg,
                                     tuple(t.cpu() for t in state), ci,
                                     tuple(t.cpu() for t in scales))
            full = max(_rel_errs(ko, ro).values())
            spread = max(_rel_errs(ro, ho).values())
            out["one_layer"] = max(out["one_layer"], one)
            out["full"] = max(out["full"], full)
            out["spread"] = max(out["spread"], spread)
            out["err"] = max(out["err"], max_abs(ko["logits"], ro["logits"]))
            if not (intact and ok_full):
                raise AssertionError("int8-KV talker step wrote outside its slot or scales")
            if not one <= ONE_LAYER_REL_TOL:
                raise AssertionError(f"int8-KV talker step, one layer, B={B}, S={S_buf}: "
                                     f"rel err {one:.3g}")
            if not full <= SPREAD_FACTOR * spread + SPREAD_SLACK:
                raise AssertionError(f"int8-KV talker step, full depth, B={B}, S={S_buf}: "
                                     f"rel err {full:.3g} vs the twin's own spread "
                                     f"{spread:.3g}")
            ms = cuda_ms(lambda: talker_step_fused_cache(
                params, cfg, embed, position, ci, kv_valid, kq, vq, k_scale=ks, v_scale=vs), 20)
            ms_bf16 = cuda_ms(lambda: talker_step_fused_cache(
                params, cfg, embed, position, ci, kv_valid, k, v), 20)
            plain = cuda_ms(lambda: talker_step_ref(
                params, cfg, embed, position, ci, kv_valid, kq, vq, k_scale=ks, v_scale=vs),
                1 if B >= B_TWIN_ONCE else 2)
            n_slots = int(kv_valid.sum())
            bms, by = talker_step_bound(params, cfg, B, n_slots, 2 * cfg.resolved_head_dim + 8)
            bms16, _ = talker_step_bound(params, cfg, B, n_slots, 4 * cfg.resolved_head_dim)
            out["rows"].append(dict(B=B, S_buf=S_buf, ci=ci, ms=ms, ms_bf16=ms_bf16,
                                    plain_ms=plain, bound_ms=bms, bound_by=by,
                                    bound_ms_bf16=bms16))
            line("kernel talker_step int8-KV", B=B, S_buf=S_buf, ci=ci,
                 one_layer_max_rel_err=f"{one:.3g}", full_depth_max_rel_err=f"{full:.3g}",
                 twin_card_vs_host_rel_spread=f"{spread:.3g}", ms=f"{ms:.3f}",
                 ms_bf16_kv=f"{ms_bf16:.3f}", plain_ms=f"{plain:.3f}",
                 bound_ms=f"{bms:.4f}", bound_by=by, bound_ms_bf16_kv=f"{bms16:.4f}")
            del k, v, kq, vq, ks, vs, state, scales
            torch.cuda.empty_cache()
    line("kernel talker_step int8-KV slot", rows_exact=out["slot_rows"],
         rows_with_the_twins_bf16_inputs=out["slot_rows_equal_inputs"],
         logits_max_abs_err=f"{out['err']:.3g}")
    return out


class StandInTokenizer:
    """Deterministic stand-in for the Qwen2 text tokenizer (the smoke must
    run without `transformers` and without a tokenizer asset); ids are
    stable per text, one per character, at most `max_ids` (None: all)."""

    def __init__(self, max_ids=48):
        self.max_ids = max_ids

    def __call__(self, text, return_tensors=None, **kw):
        ids = [3 + (ord(c) * 11 + i) % 211 for i, c in enumerate(text)][:self.max_ids]
        ids += [5] * max(0, 12 - len(ids))
        return {"input_ids": np.asarray([ids], dtype=np.int64)}


def build_model(params, cfg, device, size="1b7", quantized="int8"):
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel

    tc = dataclasses.replace(cfg, spk_id={"vivian": 3000},
                             codec_language_id={"english": 1000})
    tts_cfg = TTSModelConfig(talker_config=tc, tts_model_type="custom_voice",
                             tts_model_size=size)
    return Qwen3TTSModel(tts_cfg, params, None, smoke_vocoder(device), StandInTokenizer(), {},
                         quantized=quantized, device=device)


def scaled_vocoder_params(dec_cfg, seed: int, device, scale: float = VOC_WEIGHT_SCALE):
    """A 12 Hz vocoder's params drawn from `seed` on `device`, every weight
    matrix times `scale` (the codebooks and every vector kept): the smoke's
    vocoders, whose audio is not clamped (VOC_WEIGHT_SCALE)."""
    from qwen3_tts_tpu_torch.utils.testing import random_vocoder_params, scale_weight_matrices

    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: v if k == "_codebooks" else scale_weight_matrices(v, scale)
            for k, v in random_vocoder_params(dec_cfg, gen).items()}


def smoke_vocoder(device):
    """The default-width 12 Hz vocoder, random from the seed and scaled
    (`scaled_vocoder_params`), as a tokenizer."""
    from qwen3_tts_tpu_torch.config import CodecV2Config, CodecV2DecoderConfig
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer

    dec_cfg = CodecV2DecoderConfig()
    tok = Qwen3TTSTokenizer.from_params(CodecV2Config(decoder_config=dec_cfg),
                                        dec_params=scaled_vocoder_params(dec_cfg, SEED + 3,
                                                                         device))
    tok.chunk_size = 64
    return tok


def build_clone_model(params, cfg, device):
    """The same int8 talker as a base (voice-clone) model: the speaker
    encoder at the released widths with enc_dim = the talker width (the
    x-vector rides the codec track), the default-width Mimi encoder and
    vocoder (scaled: `scaled_vocoder_params`), all random from the seed,
    fp32."""
    from qwen3_tts_tpu_torch.config import (CodecV2Config, CodecV2DecoderConfig,
                                            MimiEncoderConfig, SpeakerEncoderConfig,
                                            TTSModelConfig)
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.codec12.encoder import prepare_encoder_params
    from qwen3_tts_tpu_torch.utils.testing import mimi_encoder_state, speaker_encoder_state
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    tts_cfg = TTSModelConfig(
        talker_config=dataclasses.replace(cfg, codec_language_id={"english": 1000}),
        speaker_encoder_config=SpeakerEncoderConfig(enc_dim=cfg.hidden_size),
        tts_model_type="base", tts_model_size="1b7")
    codec_cfg = CodecV2Config(encoder_config=MimiEncoderConfig(),
                              decoder_config=CodecV2DecoderConfig())
    spk = from_jax_tree(speaker_encoder_state(tts_cfg.speaker_encoder_config, SEED + 4),
                        device)
    enc = prepare_encoder_params(
        from_jax_tree(mimi_encoder_state(codec_cfg.encoder_config, SEED + 5), device),
        codec_cfg.encoder_config)
    tok = Qwen3TTSTokenizer.from_params(
        codec_cfg, enc_params=enc,
        dec_params=scaled_vocoder_params(codec_cfg.decoder_config, SEED + 6, device))
    return Qwen3TTSModel(tts_cfg, params, spk, tok, StandInTokenizer(max_ids=None), {},
                         quantized="int8", device=device)


def reference_clip(sr: int) -> np.ndarray:
    """CLONE_REF_SECONDS of a voice-like signal from the seed: a wandering
    pitch with harmonics, an amplitude envelope and a little noise."""
    rng = np.random.default_rng(SEED + 7)
    n = CLONE_REF_SECONDS * sr
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t) + 10 * rng.standard_normal(n).cumsum() / np.sqrt(n)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(h * phase) / h for h in range(1, 6))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 2.1 * t))
    wav += 0.01 * rng.standard_normal(n)
    return (0.25 * wav / np.abs(wav).max()).astype(np.float32)


def phase_clone_front_end(model) -> dict:
    """The reference clip's codes and speaker embedding on the card against
    the host twins (the same fp32 trees on the CPU), and the clone prompt's
    prefill shape (T, per-row first valid slot)."""
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.speaker_encoder import extract_speaker_embedding
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    sr = model.speech_tokenizer.get_input_sample_rate()
    wav = reference_clip(sr)
    tok = model.speech_tokenizer
    host_tok = Qwen3TTSTokenizer.from_params(tok.config, enc_params=to_host(tok.enc_params))
    t0 = time.time()
    card = tok.encode((wav, sr)).audio_codes[0]
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    host = host_tok.encode((wav, sr)).audio_codes[0]
    spk_card = model.extract_speaker_embedding(wav, sr)
    with torch.no_grad():
        spk_host = extract_speaker_embedding(to_host(model.speaker_encoder_params),
                                             model.config.speaker_encoder_config, wav).numpy()
    cb0 = float((card[:, 0] == host[:, 0]).mean())
    every = float((card == host).mean())
    spk_rel = float(np.linalg.norm(spk_card - spk_host) / np.linalg.norm(spk_host))
    items = model.create_voice_clone_prompt((wav, sr), ref_text=CLONE_REF_TEXT)
    specs, _ = model._specs_voice_clone(CLONE_TEXTS, "english", None, None, False,
                                        items, True)
    with torch.no_grad():
        _, mask, _, _ = assemble_prompt_specs(model.talker_params, model.config.talker_config,
                                              model.config, specs, bucket=32)
    T = mask.shape[1]
    starts = tuple(int(s) for s in (T - mask.sum(dim=1)).tolist())
    line("clone front end", ref_frames=card.shape[0], codebooks=card.shape[1],
         codebook0_agreement=f"{cb0:.4f}", all_codebook_agreement=f"{every:.4f}",
         speaker_embedding_rel_err=f"{spk_rel:.3g}", encode_s=f"{enc_s:.3f}",
         prefill_T=T, starts=list(starts))
    if min(cb0, every) < MIN_CODEC_AGREEMENT:
        raise AssertionError(f"Mimi codes on the card vs the host twin: {cb0}, {every}")
    if not spk_rel <= SPK_REL_TOL:
        raise AssertionError(f"speaker embedding card vs host rel err {spk_rel}")
    if T < 2048 or len(set(starts)) < 2:
        raise AssertionError(f"clone prompt T={T} starts={starts}: want T >= 2048, ragged")
    return {"wav": wav, "sr": sr, "T": T, "starts": starts, "ref_frames": card.shape[0],
            "items": items}


def flash_work(T: int, starts, window, Hq: int, Hkv: int, D: int):
    """(flops, bytes) the flash prefill's data needs: the query-key pairs of
    the valid rows (each sees min(i - start + 1, window) keys), q/k/v of
    the valid tokens read once, the output written once."""
    pairs = 0
    for s in starts:
        n = T - s
        w = window or n
        pairs += n * (n + 1) // 2 if n <= w else w * (w + 1) // 2 + (n - w) * w
    valid = sum(T - s for s in starts)
    return 4 * Hq * D * pairs, valid * (2 * Hq + 2 * Hkv) * D * 2


def phase_flash(cfg, device, main_shape) -> dict:
    """Kernel against its twin (fp32 math on the same bf16 inputs) at the
    FLASH_CASES and at the clone's own prefill shape, which gives the JSON
    numbers; SDPA with the same boolean mask as the yardstick."""
    import torch.nn.functional as F

    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import (_kernel_view, _mask,
                                                                flash_prefill,
                                                                flash_prefill_ref)

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    out = {"err": 0.0, "row_rel": 0.0}
    cases = FLASH_CASES + [(len(main_shape["starts"]), main_shape["T"],
                            main_shape["starts"], cfg.sliding_window)]
    for i, (B, T, starts, window) in enumerate(cases):
        main = i == len(cases) - 1
        if main:   # views into one fused qkv product, as decoder_stack passes them
            q, k, v = (x.unflatten(-1, (-1, D)) for x in torch.randn(
                (B, T, (Hq + 2 * Hkv) * D), generator=gen, device=device
            ).to(torch.bfloat16).split([Hq * D, Hkv * D, Hkv * D], dim=-1))
            if not all(_kernel_view(x) is x for x in (q, k, v)):
                raise AssertionError("flash prefill: the fused qkv views were copied, "
                                     "so the kernel's strided loads go unchecked")
        else:
            q, k, v = (torch.randn((B, T, h, D), generator=gen, device=device
                                   ).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        start = torch.tensor(starts, dtype=torch.int32, device=device)
        got = flash_prefill(q, k, v, start, sliding_window=window)
        want = flash_prefill_ref(q.float(), k.float(), v.float(), start, sliding_window=window)
        torch.cuda.synchronize()
        err = max(max_abs(got[b, s:], want[b, s:]) for b, s in enumerate(starts))
        row_rel = max(float(((got[b, s:].float() - want[b, s:]).norm(dim=-1)
                             / want[b, s:].norm(dim=-1).clamp_min(1e-30)).max())
                      for b, s in enumerate(starts))
        pad_zero = all(bool((got[b, :s] == 0).all()) for b, s in enumerate(starts))
        out["err"] = max(out["err"], err)
        out["row_rel"] = max(out["row_rel"], row_rel)
        ms = cuda_ms(lambda: flash_prefill(q, k, v, start, sliding_window=window), 20)
        plain = cuda_ms(lambda: flash_prefill_ref(q, k, v, start, sliding_window=window), 3)
        mask = _mask(T, start, window)[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True), 10)
        flops, nbytes = flash_work(T, starts, window, Hq, Hkv, D)
        bms, by = bound(nbytes, [(flops, PEAK_BF16_FLOPS)])
        line("kernel flash_prefill" + (" (clone shape, fused qkv views)" if main else ""),
             B=B, T=T, starts=list(starts), window=window, max_abs_err=f"{err:.3g}",
             max_row_rel_err=f"{row_rel:.3g}", padded_rows_zero=pad_zero,
             ms=f"{ms:.4f}", plain_ms=f"{plain:.3f}",
             library_ms=f"{lib:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
             bound_share=f"{bms / ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
        if not (err <= FLASH_TOL and row_rel <= FLASH_ROW_REL_TOL and pad_zero):
            raise AssertionError(f"flash prefill B={B} T={T} window={window}: max abs err "
                                 f"{err} (bar {FLASH_TOL}), max row rel err {row_rel} "
                                 f"(bar {FLASH_ROW_REL_TOL}), padded rows zero: {pad_zero}")
        if main:
            out.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()
    return out


def phase_flash_tiles(cfg, device) -> dict:
    """The flash kernel's two products alone (`flash_tile_products`), from
    q/k/v as strided views into one fused qkv tensor with a ragged T: s =
    Q K^T and o = bf16(s) V against torch.matmul in fp32 on the same bf16
    tiles (rows and keys past T zeros), within FLASH_TILE_REL_TOL of the
    largest value."""
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import (FP_BK, FP_BQ,
                                                                flash_tile_products)

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    B, T = 2, 300
    q, k, v = (x.unflatten(-1, (-1, D)) for x in torch.randn(
        (B, T, (Hq + 2 * Hkv) * D), generator=gen, device=device
    ).to(torch.bfloat16).split([Hq * D, Hkv * D, Hkv * D], dim=-1))

    def tile(x, b, h, lo, n):
        t = torch.zeros((n, D), device=device)
        rows = x[b, lo:lo + n, h].float()
        t[:rows.shape[0]] = rows
        return t

    worst = {"s": 0.0, "o": 0.0}
    for b, hq, q_lo, k0 in FLASH_TILE_CASES:
        s, o = flash_tile_products(q, k, v, b, hq, q_lo, k0)
        want_s = torch.matmul(tile(q, b, hq, q_lo, FP_BQ), tile(k, b, hq // 2, k0, FP_BK).T)
        want_o = torch.matmul(s.to(torch.bfloat16).float(), tile(v, b, hq // 2, k0, FP_BK))
        for name, got, want in (("s", s, want_s), ("o", o, want_o)):
            rel = max_abs(got, want) / float(want.abs().max().clamp_min(1e-30))
            worst[name] = max(worst[name], rel)
    line("kernel flash_prefill tile products", cases=len(FLASH_TILE_CASES), T=T,
         s_max_err_over_max=f"{worst['s']:.3g}", o_max_err_over_max=f"{worst['o']:.3g}",
         bar=f"{FLASH_TILE_REL_TOL:.3g}")
    if max(worst.values()) > FLASH_TILE_REL_TOL:
        raise AssertionError(f"flash tile products off torch.matmul: {worst}")
    return worst


def phase_prefill_ab(params, cfg, device) -> dict:
    """Whole `talker_prefill` calls at B=4 with ragged left padding, the
    dense plain attention against the flash kernel, at each T of
    PREFILL_AB_T, in turns (dense, flash, flash, dense); the least T from
    which flash wins at every measured point is where the route should
    switch on this card (`FLASH_PREFILL_MIN_T`)."""
    from qwen3_tts_tpu_torch.models import talker
    from qwen3_tts_tpu_torch.models.talker import KVCache, talker_prefill

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    B, res = 4, {}
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
    threshold = talker.FLASH_PREFILL_MIN_T
    try:
        for T in PREFILL_AB_T:
            embeds = (torch.randn((B, T, cfg.hidden_size), generator=gen, device=device) * 0.3
                      ).to(torch.bfloat16)
            starts = torch.tensor([0, T // 16, T // 4, T // 2], device=device)
            mask = (torch.arange(T, device=device)[None, :] >= starts[:, None]).to(torch.int32)
            cache = KVCache.zeros(L, B, T, Hkv, D, device=device)

            def run(flash):
                talker.FLASH_PREFILL_MIN_T = 0 if flash else 1 << 30
                with torch.no_grad():
                    talker_prefill(params, cfg, embeds, mask, cache, allow_flash=flash)

            ms = {"dense": [], "flash": []}
            for route in ("dense", "flash", "flash", "dense"):
                ms[route].append(cuda_ms(lambda: run(route == "flash"), 3))
            res[T] = (float(np.mean(ms["dense"])), float(np.mean(ms["flash"])))
            del embeds, cache
            torch.cuda.empty_cache()
    finally:
        talker.FLASH_PREFILL_MIN_T = threshold
    wins = [T for T in PREFILL_AB_T if all(res[t][1] < res[t][0] for t in PREFILL_AB_T if t >= T)]
    out = {"ms": res, "least_t": min(wins) if wins else None}
    line("prefill dense vs flash", B=B, layers=L,
         **{f"T{T}": f"dense_ms={d:.3f},flash_ms={f:.3f},ratio={d / f:.2f}"
            for T, (d, f) in res.items()},
         flash_wins_from_T=out["least_t"], FLASH_PREFILL_MIN_T=threshold)
    return out


def run_codes(model, specs, **kw) -> list:
    """The codes a generate_* call samples for `specs` with these generate
    kwargs and the smoke's seed: the model's frame loop, called directly."""
    gen_cfg = model._generation_config(model._merge_generate_kwargs(**kw))
    return model._run(specs, gen_cfg, seed=SEED)


def code_agreement(a, b) -> float:
    """Share of equal frames over each row's common length."""
    same = [(x[:n] == y[:n]).all(axis=1) for x, y in zip(a, b)
            for n in [min(len(x), len(y))]]
    return float(np.concatenate(same).mean())


def phase_clone(model, front, kv_quant: bool = False, base=None) -> dict:
    """generate_voice_clone at the long ICL prefill, bf16 or int8 KV (then
    beside the bf16 run `base`)."""
    mode = "int8_kv" if kv_quant else "bf16_kv"
    kw = dict(language="english", ref_audio=(front["wav"], front["sr"]),
              ref_text=CLONE_REF_TEXT, non_streaming_mode=True, seed=SEED, kv_quant=kv_quant)
    # warm-up at the timed call's shape: the graphs it replays are captured here
    model.generate_voice_clone(CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS, **kw)
    from qwen3_tts_tpu_torch.runtime import graphs

    g0 = graphs.stats(model.device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    wavs, sr = model.generate_voice_clone(CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS,
                                          **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    counts = graph_counts(model.device, g0)
    if counts["graphs_replayed"] <= 0 or counts["graphs_captured"]:
        # the prefill's 28 kernel-3 launches below then come from a replay
        raise AssertionError(f"the clone call after its warm-up call: {counts}")
    specs, _ = model._specs_voice_clone(CLONE_TEXTS, "english", None, None, False,
                                        front["items"], True)
    codes = run_codes(model, specs, max_new_tokens=CLONE_MAX_NEW_TOKENS, kv_quant=kv_quant)
    if sr != 24000:
        raise AssertionError(f"sample rate {sr}")
    up = model.speech_tokenizer.get_decode_upsample_rate()
    rl = front["ref_frames"]
    frames = []
    for w in wavs:
        # the reference codes decode ahead of the generated ones and the
        # same share of samples is cut off the front, with the reference's
        # float arithmetic: the whole-frame decode minus exactly that cut
        g = round(w.shape[0] / up)
        total = (rl + g) * up
        if not (w.ndim == 1 and g > 0 and w.shape[0] == total - int(rl / (rl + g) * total)):
            raise AssertionError(f"waveform of {w.shape} samples is not whole {up}-sample "
                                 "frames after the reference cut")
        if not np.isfinite(w).all():
            raise AssertionError("non-finite waveform")
        frames.append(g)
    L = model.config.talker_config.num_hidden_layers
    step_key = "talker_step_int8_kv" if kv_quant else "talker_step"
    if launches["flash_prefill"] != L or min(launches["subtalker"], launches[step_key]) <= 0:
        raise AssertionError(f"clone main path launches {launches}: want flash_prefill = {L} "
                             f"and both decode kernels ({step_key})")
    audio_s = sum(frames) * up / sr
    out = {"launches": launches, "codes": codes, "rtf": wall / audio_s}
    extra = {} if base is None else dict(bf16_kv_rtf=f"{base['rtf']:.4f}",
                                         code_agreement_vs_bf16_kv=
                                         f"{code_agreement(codes, base['codes']):.4f}")
    levels = audio_levels(*wavs)
    line(f"slice clone {mode}", texts=len(CLONE_TEXTS), prefill_T=front["T"],
         starts=list(front["starts"]), frames=frames, wall_s=f"{wall:.3f}",
         frames_per_s=f"{sum(frames) / wall:.2f}", rtf=f"{out['rtf']:.4f}", **extra,
         **counts, launches=launches, **levels)
    unclamped(f"slice clone {mode}", levels)
    return out


def phase_slice(model, kv_quant: bool = False, base=None, label="") -> dict:
    """generate_custom_voice, bf16 or int8 KV (then beside the bf16 run
    `base`)."""
    mode = "int8_kv" if kv_quant else "bf16_kv"
    kw = dict(speaker="vivian", language="english", seed=SEED, kv_quant=kv_quant)
    # warm-up at the timed call's shape: the graphs it replays are captured here
    model.generate_custom_voice(TEXTS, max_new_tokens=MAX_NEW_TOKENS, **kw)
    from qwen3_tts_tpu_torch.runtime import graphs

    g0 = graphs.stats(model.device)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    wavs, sr = model.generate_custom_voice(TEXTS, max_new_tokens=MAX_NEW_TOKENS, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    counts = graph_counts(model.device, g0)
    if counts["graphs_replayed"] <= 0 or counts["graphs_captured"]:
        raise AssertionError(f"the frame loop after its warm-up call: {counts}")
    specs = model._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    codes = run_codes(model, specs, max_new_tokens=MAX_NEW_TOKENS, kv_quant=kv_quant)
    if sr != 24000:
        raise AssertionError(f"sample rate {sr}")
    up = model.speech_tokenizer.get_decode_upsample_rate()
    frames = []
    for w in wavs:
        if not (w.ndim == 1 and w.shape[0] > 0 and w.shape[0] % up == 0):
            raise AssertionError(f"waveform shape {w.shape} is not whole {up}-sample frames")
        if not np.isfinite(w).all():
            raise AssertionError("non-finite waveform")
        frames.append(w.shape[0] // up)
    for name in ("subtalker", "talker_step_int8_kv" if kv_quant else "talker_step"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel was not launched on the main path")
    audio_s = sum(frames) * up / sr
    out = {"launches": launches, "codes": codes, "rtf": wall / audio_s, "wall": wall,
           "frames": frames}
    extra = {} if base is None else dict(bf16_kv_rtf=f"{base['rtf']:.4f}",
                                         code_agreement_vs_bf16_kv=
                                         f"{code_agreement(codes, base['codes']):.4f}")
    levels = audio_levels(*wavs)
    line(f"slice{label} {mode}", texts=len(TEXTS), frames=frames, wall_s=f"{wall:.3f}",
         frames_per_s=f"{sum(frames) / wall:.2f}", rtf=f"{out['rtf']:.4f}", **extra,
         **counts, launches=launches, **levels)
    unclamped(f"slice{label} {mode}", levels)
    return out


def stream_active_frames(model, specs, **kw) -> np.ndarray:
    """Per-row active frames of the stream a stream_* call runs for `specs`
    with these generate kwargs and the smoke's seed: its `StreamingSession`,
    driven directly (vocoder context changes only the audio, so none)."""
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs
    from qwen3_tts_tpu_torch.runtime.streaming import StreamingSession

    tc, tok = model.config.talker_config, model.speech_tokenizer
    gen_cfg = model._generation_config(model._merge_generate_kwargs(**kw))
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    with torch.no_grad():
        embeds, mask, trailing, pad = assemble_prompt_specs(model.talker_params, tc,
                                                            model.config, specs, bucket=32)
        session = StreamingSession(model.talker_params, tc, gen_cfg, tok.dec_params,
                                   tok.config.decoder_config)
        return np.sum([p.active_frames for p in session.run(embeds, mask, trailing, pad, gen)],
                      axis=0)


def phase_stream(name: str, stream, active_frames, up: int, max_frames: int) -> dict:
    """Drive one `stream_*` generator to its end: first-packet latency,
    packets, frames. The audio must be finite 24 kHz, and its samples the
    longest row's active frames x `up` (`active_frames()`: the per-row
    active frames of the same stream, with which the API trims and
    silences). A first pass of the same stream captures its graphs."""
    from qwen3_tts_tpu_torch.runtime import graphs

    for _ in stream():
        pass
    g0 = graphs.stats(torch.device("cuda"))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    first, chunks = None, []
    for wav, sr in stream():
        first = first if first is not None else time.time() - t0
        if sr != 24000 or not np.isfinite(wav).all() or wav.shape[1] % up:
            raise AssertionError(f"{name}: packet of shape {wav.shape} at {sr} Hz")
        chunks.append(wav)
    wall = time.time() - t0
    launches = read_launches()
    counts = graph_counts(torch.device("cuda"), g0)
    if counts["graphs_replayed"] <= 0:
        raise AssertionError(f"{name}: the stream replayed no graph ({counts})")
    active = active_frames()
    samples = sum(c.shape[1] for c in chunks)
    if not (chunks and samples == int(active.max()) * up and active.max() <= max_frames):
        raise AssertionError(f"{name}: {samples} samples vs active frames {active.tolist()}")
    if min(launches["subtalker"], launches["talker_step_int8_kv"]) <= 0:
        raise AssertionError(f"{name}: launches {launches}")
    levels = audio_levels(*chunks)
    line(f"stream {name}", first_packet_s=f"{first:.3f}", packets=len(chunks),
         frames=active.tolist(), wall_s=f"{wall:.3f}",
         rtf=f"{wall / (active.sum() * up / 24000):.4f}", **counts, launches=launches,
         **levels)
    unclamped(f"stream {name}", levels)
    return {"first_packet_s": first, "launches": launches}


SERVE_OVERRIDES = {"kv_quant": True, "fused_talker_step": True}


def serve_all(srv, submits, cancel_id=None) -> tuple:
    """Submit every request, then step `srv` until drained, cancelling
    `cancel_id` once its first packet arrived. Returns (events, first-packet
    seconds per request id, wall seconds)."""
    from qwen3_tts_tpu_torch.runtime.server import AudioPacket

    t0 = time.time()
    for submit in submits:
        submit()
    events, first, cancelled = [], {}, False
    for _ in range(100000):
        if not srv.busy:
            break
        evs = srv.step()
        now = time.time() - t0
        for e in evs:
            if cancelled and e.request_id == cancel_id:
                raise AssertionError(f"cancelled request {cancel_id} yielded {e}")
            if isinstance(e, AudioPacket):
                first.setdefault(e.request_id, now)
        events += evs
        if cancel_id in first and not cancelled:
            if not srv.cancel(cancel_id):
                raise AssertionError(f"cancel of {cancel_id} found no request")
            cancelled = True
    torch.cuda.synchronize()
    if srv.busy:
        raise AssertionError("server did not drain")
    return events, first, time.time() - t0


def _serve_run(model, eager: bool, warm: str = "request") -> dict:
    """One TTSServer over the custom-voice model on kernel 2's int8-KV mode,
    its serve chunks as graph replays (or, `eager`, the eager loop), warmed
    with one streamed request (`warm` "request"), with `TTSServer.warmup()`
    ("warmup") or not at all (None), then the 12-request mix: more requests
    than slots (staging and installs mid-chunk), half of them streamed, one
    cancelled mid-stream, one with a zero frame budget. Returns the checked
    run's numbers, every request's codes (the server's code sink), the
    graphs captured by the warm-up and by the mix, and the mix's device ms
    in the frame loop's and the vocoder's graph calls (graphed runs). An
    eager run runs wholly inside `graphs.eager()`."""
    from qwen3_tts_tpu_torch.runtime import graphs

    with graphs.eager() if eager else contextlib.nullcontext():
        return _serve_run_in(model, eager, warm)


def _serve_run_in(model, eager: bool, warm) -> dict:
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import AudioPacket, AudioResult, TTSServer

    codes = {}
    srv = TTSServer(model, num_slots=SERVE_SLOTS, overrides=SERVE_OVERRIDES,
                    max_new_tokens=MAX_NEW_TOKENS, seed=SEED,
                    code_sink=lambda rid, fr: codes.setdefault(rid, []).extend(fr))
    if (srv.engine._graphs is None) != eager:
        raise AssertionError(f"serve route: graphs {srv.engine._graphs}, eager={eager}")
    warm0 = graphs.stats(model.device)
    warm_s = None
    if warm == "request":
        serve_all(srv, [lambda: srv.submit_custom_voice("w", text=TEXTS[0], speaker="vivian",
                                                        language="english", stream=True)])
    elif warm == "warmup":
        warm_s = srv.warmup()
    warm1 = graphs.stats(model.device)
    ids = [f"r{i}" for i in range(SERVE_REQUESTS)]
    stream = {rid: i % 2 == 0 for i, rid in enumerate(ids)}
    zero, cancel = ids[1], ids[2]
    submits = [lambda rid=rid, i=i: srv.submit_custom_voice(
        rid, text=f"{TEXTS[i % len(TEXTS)]} Request {i}.", speaker="vivian",
        language="english", stream=stream[rid], max_frames=0 if rid == zero else None)
        for i, rid in enumerate(ids)]
    stats0 = graphs.stats(model.device)
    reset_launches()
    torch.cuda.synchronize()
    with owner_device_ms() if not eager else contextlib.nullcontext({}) as split:
        events, first, wall = serve_all(srv, submits, cancel_id=cancel)
    launches = read_launches()
    stats1 = graphs.stats(model.device)
    audio, done = 0, set()
    levels = audio_levels(*(e.wav for e in events))
    for rid in ids:
        mine = [e for e in events if e.request_id == rid]
        if rid == cancel:
            continue
        if stream[rid]:
            starts = [p.frame_start for p in mine]
            if not (mine and mine[-1].final and sum(p.final for p in mine) == 1
                    and starts == sorted(starts)
                    and all(isinstance(p, AudioPacket) and np.isfinite(p.wav).all()
                            for p in mine)):
                raise AssertionError(f"stream {rid}: {[(p.frame_start, p.final) for p in mine]}")
            audio += sum(p.wav.shape[0] for p in mine)
        else:
            if not (len(mine) == 1 and isinstance(mine[0], AudioResult)
                    and np.isfinite(mine[0].wav).all()
                    and (mine[0].wav.shape[0] == 0) == (rid == zero)):
                raise AssertionError(f"request {rid}: {mine}")
            audio += mine[0].wav.shape[0]
        done.add(rid)
    if min(launches["subtalker"], launches["talker_step_int8_kv"]) <= 0:
        raise AssertionError(f"serving launches {launches}")
    replays = stats1["replays"] - stats0["replays"]
    if (replays > 0) == eager:
        raise AssertionError(f"serving with eager={eager} replayed {replays} graphs")
    fp = np.array([first[rid] for rid in ids if stream[rid] and rid in first])
    return {"launches": launches, "requests_per_s": len(done) / wall, "wall": wall,
            "audio_s_per_s": audio / 24000 / wall, "done": done, "cancel": cancel,
            "zero": zero, "codes": codes, "replays": replays,
            "captures": stats1["captures"] - stats0["captures"],
            "first_packet_p50": float(np.percentile(fp, 50)),
            "first_packet_p95": float(np.percentile(fp, 95)),
            "levels": levels,
            "warm_s": warm_s, "warm_captures": warm1["captures"] - warm0["captures"],
            "warm_codec_graphs": warm1["codec_graphs"] - warm0["codec_graphs"],
            "serve_graphs": 0 if eager else len(srv.engine._graphs.graphs),
            "staging_graphs": 0 if eager else len(srv.engine._graphs.staging),
            "pool_bytes": warm1["pool_bytes"], "split": split}


def phase_serve(model) -> dict:
    """TTSServer with its serve chunks as graph replays, then the same run on
    the eager loop: every request's codes must be equal; requests/s, audio
    s per wall s and first-packet p50/p95 of both."""
    runs = {"graph": _serve_run(model, eager=False), "eager": _serve_run(model, eager=True)}
    g, e = runs["graph"], runs["eager"]
    if set(g["codes"]) != set(e["codes"]):
        raise AssertionError(f"served requests differ: {sorted(g['codes'])} vs "
                             f"{sorted(e['codes'])}")
    for rid, fr in g["codes"].items():
        if not np.array_equal(np.stack(fr), np.stack(e["codes"][rid])):
            raise AssertionError(f"request {rid}: graphed and eager serving codes differ")
    for name, r in runs.items():
        line(f"serve custom voice {name}", slots=SERVE_SLOTS, requests=SERVE_REQUESTS,
             completed=len(r["done"]), cancelled=r["cancel"], zero_budget=r["zero"],
             wall_s=f"{r['wall']:.3f}", requests_per_s=f"{r['requests_per_s']:.3f}",
             audio_s_per_wall_s=f"{r['audio_s_per_s']:.3f}",
             first_packet_p50_s=f"{r['first_packet_p50']:.3f}",
             first_packet_p95_s=f"{r['first_packet_p95']:.3f}",
             graphs_captured=r["captures"], graphs_replayed=r["replays"],
             launches=r["launches"], **r["levels"])
        unclamped(f"serve custom voice {name}", r["levels"])
    line("serve graph vs eager", requests=len(g["codes"]), codes_equal=True,
         frames=sum(len(v) for v in g["codes"].values()))
    return g


def _mix_server(model, overrides, slots, frames, tag):
    """A fresh TTSServer with `overrides` (None: the server's own defaults),
    warmed with one streamed request."""
    from qwen3_tts_tpu_torch.runtime.server import TTSServer

    srv = TTSServer(model, num_slots=slots, overrides=overrides, max_new_tokens=frames,
                    seed=SEED)
    serve_all(srv, [lambda: srv.submit_custom_voice(f"{tag}-w", text=TEXTS[0], speaker="vivian",
                                                    language="english", stream=True)])
    return srv


def _serve_round(srv, n, tag) -> dict:
    """Serve n custom-voice requests (every other one streamed) on `srv`;
    every request must complete. Returns its launches, the graphs it
    captured, requests/s and the streamed requests' first-packet p50."""
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import AudioPacket, AudioResult

    ids = [f"{tag}{i}" for i in range(n)]
    submits = [lambda rid=rid, i=i: srv.submit_custom_voice(
        rid, text=f"{TEXTS[i % len(TEXTS)]} Request {i}.", speaker="vivian",
        language="english", stream=i % 2 == 0) for i, rid in enumerate(ids)]
    captures0 = graphs.stats(srv.model.device)["captures"]
    reset_launches()
    torch.cuda.synchronize()
    events, first, wall = serve_all(srv, submits)
    launches = read_launches()
    for i, rid in enumerate(ids):
        mine = [e for e in events if e.request_id == rid]
        done = (mine and mine[-1].final and all(isinstance(e, AudioPacket) for e in mine)
                if i % 2 == 0 else len(mine) == 1 and isinstance(mine[0], AudioResult))
        if not (done and all(np.isfinite(e.wav).all() for e in mine)):
            raise AssertionError(f"{tag}: request {rid} did not complete: {mine}")
    fp = [first[rid] for i, rid in enumerate(ids) if i % 2 == 0]
    return {"launches": launches, "requests_per_s": n / wall, "wall": wall,
            "captures": graphs.stats(srv.model.device)["captures"] - captures0,
            "first_packet_p50": float(np.percentile(fp, 50))}


def _serve_mix(model, overrides, slots, n, frames, tag) -> dict:
    """`_serve_round` of n requests on a fresh `_mix_server`; also returns
    the server."""
    srv = _mix_server(model, overrides, slots, frames, tag)
    return {"srv": srv, **_serve_round(srv, n, tag)}


def phase_serve_routes(model) -> dict:
    """The server's serve step on the card: the same short mix served on the
    plain route (eager torch decode step) and on kernel 2, each on its own
    server. Each server first serves one unmeasured mix (every graph of the
    mix's shapes captured), then ROUTE_ROUNDS measured ones, in the order
    plain, fused, fused, plain, ... so that a drift of the host's speed
    falls on both routes alike. Requests/s and first-packet p50 of each
    route are the medians of its rounds. The server's default (no override)
    must be the route that wins both metrics, and the plain one unless the
    fused route wins both."""
    from qwen3_tts_tpu_torch.runtime.server import TTSServer

    routes = ("plain", "fused")
    servers = {route: _mix_server(model, {"fused_talker_step": route == "fused"}, ROUTE_SLOTS,
                                  ROUTE_FRAMES, route) for route in routes}
    for route in routes:
        _serve_round(servers[route], ROUTE_REQUESTS, f"{route}-u")
    rounds = {route: [] for route in routes}
    for k in range(ROUTE_ROUNDS):
        for route in routes if k % 2 == 0 else routes[::-1]:
            r = _serve_round(servers[route], ROUTE_REQUESTS, f"{route}{k}-")
            if (r["launches"]["talker_step"] > 0) != (route == "fused"):
                raise AssertionError(f"{route} route round {k} launches {r['launches']}")
            rounds[route].append(r)
    del servers
    res = {route: {m: float(np.median([r[m] for r in rs]))
                   for m in ("requests_per_s", "first_packet_p50")}
           for route, rs in rounds.items()}
    fused_wins = (res["fused"]["requests_per_s"] > res["plain"]["requests_per_s"]
                  and res["fused"]["first_packet_p50"] < res["plain"]["first_packet_p50"])
    default = TTSServer(model, num_slots=ROUTE_SLOTS).gen_cfg.fused_talker_step
    line("serve route A/B", slots=ROUTE_SLOTS, requests=ROUTE_REQUESTS, streamed=ROUTE_REQUESTS // 2,
         frames=ROUTE_FRAMES, rounds=ROUTE_ROUNDS,
         **{f"{k}_requests_per_s": f"{r['requests_per_s']:.3f}" for k, r in res.items()},
         **{f"{k}_first_packet_p50_s": f"{r['first_packet_p50']:.3f}" for k, r in res.items()},
         **{f"{k}_rounds_requests_per_s": [f"{r['requests_per_s']:.3f}" for r in rs]
            for k, rs in rounds.items()},
         **{f"{k}_rounds_first_packet_p50_s": [f"{r['first_packet_p50']:.3f}" for r in rs]
            for k, rs in rounds.items()},
         **{f"{k}_rounds_captures": sum(r["captures"] for r in rs) for k, rs in rounds.items()},
         fused_wins_both=fused_wins, server_default="fused" if default else "plain")
    if default != fused_wins:
        raise AssertionError(f"the server defaults to the {'fused' if default else 'plain'} "
                             f"route; this run's A/B says {'fused' if fused_wins else 'plain'}")
    return res


def phase_serve_wide(model) -> dict:
    """A TTSServer of WIDE_SLOTS slots (past one launch's 32 rows: both
    decode kernels run as row tiles) on its defaults, with more requests
    than slots: it must drain with every request complete, through the
    kernels."""
    r = _serve_mix(model, None, WIDE_SLOTS, WIDE_REQUESTS, WIDE_FRAMES, "wide")
    if r["srv"].num_slots != WIDE_SLOTS or min(r["launches"]["subtalker"],
                                              r["launches"]["talker_step"]) <= 0:
        raise AssertionError(f"wide server launches {r['launches']}")
    line("serve wide", slots=WIDE_SLOTS, requests=WIDE_REQUESTS, frames=WIDE_FRAMES,
         wall_s=f"{r['wall']:.3f}", requests_per_s=f"{r['requests_per_s']:.3f}",
         first_packet_p50_s=f"{r['first_packet_p50']:.3f}", launches=r["launches"])
    return r


def graph_owners():
    """(class or module, attribute, part) of the graph owners' calls: every
    `DecodeGraphs.run` and `ServeGraphs.chunk` ("frame_loop") and
    `CodecGraphs.run` ("vocoder", inputs copied in and outputs out)."""
    from qwen3_tts_tpu_torch.runtime import graphs

    return ((graphs.DecodeGraphs, "run", "frame_loop"),
            (graphs.ServeGraphs, "chunk", "frame_loop"),
            (graphs.CodecGraphs, "run", "vocoder"))


def call_parts():
    """(class or module, attribute, part) of what one generate_* call runs,
    on either route (graphs or `graphs.eager()`): the clone front end
    (`create_voice_clone_prompt`: Mimi codes and the speaker embedding),
    prompt assembly (`assemble_prompt_specs` as the API calls it), the
    prefill and first code (`init_decode_state`), the frame loop (each
    chunk of frames, `generate._chunk`) and the vocoder (`codec_call`)."""
    from qwen3_tts_tpu_torch.inference import model as api
    from qwen3_tts_tpu_torch.runtime import generate, graphs

    return ((api.Qwen3TTSModel, "create_voice_clone_prompt", "front_end"),
            (api, "assemble_prompt_specs", "prompt_assembly"),
            (generate, "init_decode_state", "prefill"),
            (generate, "_chunk", "frame_loop"),
            (graphs, "codec_call", "vocoder"))


@contextlib.contextmanager
def owner_device_ms(parts=None):
    """Device ms of the calls of `parts` ((owner, attribute, part) triples;
    default: `graph_owners()`) inside the block, by CUDA events around each
    call, summed per part; the dict yielded is filled when the block ends.
    A part's span counts any wait for the host inside it."""
    parts = graph_owners() if parts is None else parts
    events = {part: [] for _, _, part in parts}
    saved = []
    for owner, name, part in parts:
        real = getattr(owner, name)

        def timed_call(*a, real=real, part=part, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real(*a, **k)
            ev[1].record()
            events[part].append(ev)
            return out

        saved.append((owner, name, real))
        setattr(owner, name, timed_call)
    out = {}
    try:
        yield out
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)
    torch.cuda.synchronize()
    out.update({k: sum(a.elapsed_time(b) for a, b in v) for k, v in events.items()})
    out["calls"] = {k: len(v) for k, v in events.items()}


def split_fields(wall_s: float, split: dict) -> dict:
    """A run's wall split into its parts (device ms, `owner_device_ms`)
    and the rest (host scheduling, copies, whatever no part covers)."""
    wall = wall_s * 1e3
    parts = {k: v for k, v in split.items() if k != "calls"}
    return dict(wall_ms=f"{wall:.1f}", **{f"{k}_ms": f"{v:.1f}" for k, v in parts.items()},
                rest_ms=f"{wall - sum(parts.values()):.1f}", calls=split["calls"])


def phase_split(model, name: str, call) -> dict:
    """One generate_* call's wall split into `call_parts()` and the rest,
    on the graphed route and then inside `graphs.eager()`, each timed call
    after a warm-up call of its shape (which captures on the graphed
    route); the shared graph pool's bytes after the graphed warm-up."""
    from qwen3_tts_tpu_torch.runtime import graphs

    out = {}
    for route in ("graph", "eager"):
        with graphs.eager() if route == "eager" else contextlib.nullcontext():
            call()
            pool = graphs.stats(model.device)["pool_bytes"]
            torch.cuda.synchronize()
            t0 = time.time()
            with owner_device_ms(call_parts()) as split:
                call()
            torch.cuda.synchronize()
            wall = time.time() - t0
        out[route] = dict(split, wall_ms=wall * 1e3)
        extra = dict(pool_mib=f"{pool / 2**20:.1f}") if route == "graph" else {}
        line(f"split {name} {route}", **split_fields(wall, split), **extra)
    return out


def _aux_case(B: int, ticks: int, K: int, Qn: int, V: int, rng):
    """A packed chunk aux (serve_chunk's layout) in which slot i holds
    request 100 + i from tick i % 4 on, and the request ids to extract."""
    frames = rng.integers(0, V, (B, ticks, Qn)).astype(np.int32)
    req = np.full((B, ticks), -1, np.int32)
    emit = np.zeros((B, ticks), np.int32)
    for i in range(B):
        req[i, i % 4:], emit[i, i % 4:] = 100 + i, 1
    aux = np.concatenate([frames.reshape(-1), emit.reshape(-1), req.reshape(-1),
                          np.zeros(B * ticks + 2 * K + B, np.int32)])
    return aux, np.arange(100, 100 + B, dtype=np.int32)


def phase_codec_graphs(model) -> dict:
    """The vocoder's graphs against the eager vocoder (`graphs.eager()`) on
    the same codes, on each route: whole-call decode (B=4, a first and a
    steady chunk, float32 and int16), a stream's packet shapes (B=4, the
    schedule 1, 2, 4, 8, 16, 25 with per-row contexts), server egress at N
    in {1, 8} x F in {4, 25} x T in {F (no context), 25 + F} (float32 and
    int16) and the first-packet extract + vocoder (8 slots x 8 ticks, 8
    rows, T = F = 4, as the server calls it). Float samples within
    CODEC_TOL max abs, PCM16 samples and counts equal; every graphed call
    must replay a graph. Each call's device ms graphed and eager (CUDA
    events, CODEC_ITERS calls after one). Then the int8 stream's wall split
    into frame loop, vocoder and the rest."""
    from qwen3_tts_tpu_torch.models.codec12.decoder import chunked_decode
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import _first_packet_vocode, _vocode_rows_compact
    from qwen3_tts_tpu_torch.runtime.streaming import _vocode_slice

    tok = model.speech_tokenizer
    p, cfg = tok.dec_params, tok.config.decoder_config
    dev = p["_codebooks"].device
    Qn, V = cfg.num_quantizers, cfg.codebook_size
    rng = np.random.default_rng(SEED + 10)

    def codes(*shape):
        return torch.from_numpy(rng.integers(0, V, shape).astype(np.int32))

    cases = []   # (route, name, fn -> tuple of tensors)
    whole = codes(4, Qn, tok.chunk_size + 36).to(dev, torch.long)
    for pcm16 in (False, True):
        cases.append(("decode", f"B=4,T={whole.shape[-1]},{'int16' if pcm16 else 'float32'}",
                      lambda pcm16=pcm16: (chunked_decode(
                          p, cfg, whole, chunk_size=tok.chunk_size,
                          left_context_size=tok.left_context, pcm16=pcm16),)))
    buf = codes(4, Qn, 64).to(dev, torch.long)
    emitted = 0
    for k in (1, 2, 4, 8, 16, 25):
        ctx = torch.tensor([emitted, emitted, min(emitted, 3), 0])
        cases.append(("stream", f"B=4,k={k},ctx_cap={min(25, emitted)}",
                      lambda e=emitted, k=k, ctx=ctx: (_vocode_slice(p, cfg, buf, ctx, e, k,
                                                                      min(25, e)),)))
        emitted += k
    for N in (1, 8):
        for F_ in (4, 25):
            for C in (0, 25):
                c = codes(N, Qn, C + F_)
                x = torch.from_numpy(rng.integers(0, C + 1, N).astype(np.int32))
                for pcm16 in (False, True):
                    cases.append(("egress",
                                  f"N={N},T={C + F_},F={F_},{'int16' if pcm16 else 'float32'}",
                                  lambda c=c, x=x, F_=F_, pcm16=pcm16: (_vocode_rows_compact(
                                      p, cfg, c, x, F_, pcm16=pcm16),)))
    B, ticks = SERVE_SLOTS, 8
    aux, rids = _aux_case(B, ticks, 2 * B, Qn, V, rng)
    aux_dev = torch.from_numpy(aux).to(dev)
    cases.append(("first_packet", f"B={B},ticks={ticks},N={len(rids)},T=4,F=4",
                  lambda: _first_packet_vocode(p, cfg, aux_dev, torch.from_numpy(rids), B, ticks,
                                               Qn, 4, 4)))
    out = {}
    with torch.no_grad():
        for route, name, fn in cases:
            s0 = graphs.stats(dev)
            g = fn()
            torch.cuda.synchronize()
            replays = graphs.stats(dev)["replays"] - s0["replays"]
            with graphs.eager():
                e = fn()
                eager_ms = cuda_ms(fn, CODEC_ITERS)
            ms = cuda_ms(fn, CODEC_ITERS)
            err, equal, exact = 0.0, True, True   # exact: the integer outputs
            for a, b in zip(g, e):
                if a.dtype.is_floating_point:
                    err = max(err, max_abs(a, b))
                    equal &= torch.equal(a, b)
                else:
                    exact &= torch.equal(a, b)
            levels = audio_levels(g[0])   # the samples (float32 or PCM16)
            line(f"codec_graphs {route}", case=name, replays=replays, max_abs=f"{err:.3g}",
                 equal=equal and exact, graph_ms=f"{ms:.3f}", eager_ms=f"{eager_ms:.3f}",
                 **levels)
            unclamped(f"codec_graphs {route} {name}", levels)
            if replays <= 0:
                raise AssertionError(f"codec_graphs {route} {name}: the graphed call replayed "
                                     "no graph")
            if err > CODEC_TOL or not exact:
                raise AssertionError(f"codec_graphs {route} {name}: graphed and eager differ "
                                     f"(max abs {err}, integer outputs equal {exact})")
            out.setdefault(route, []).append({"case": name, "ms": ms, "eager_ms": eager_ms,
                                              "max_abs": err, "equal": equal})
        # why the smoke's vocoders are scaled: the seed's draw itself, unscaled,
        # on the whole-call case's codes
        raw = scaled_vocoder_params(cfg, SEED + 3, dev, scale=1.0)
        with graphs.eager():
            levels = audio_levels(chunked_decode(raw, cfg, whole, chunk_size=tok.chunk_size,
                                                 left_context_size=tok.left_context))
        del raw
        line("codec_graphs unscaled draw", case=cases[0][1], scale=1.0, **levels,
             smoke_scale=VOC_WEIGHT_SCALE)
        for _ in _stream(model):   # every graph of the stream's shapes captured
            pass
        with owner_device_ms() as split:
            _, wall = timed(lambda: [w for w, _ in _stream(model)])
    line("codec_graphs stream split", **split_fields(wall, split))
    out["stream_split"] = (wall, split)
    return out


def phase_server_warmup(model) -> dict:
    """A fresh int8 TTSServer at the smoke's serving configuration runs
    `warmup()`: its seconds, the serve and vocoder graphs it captured and
    the shared pool's bytes. Then the 12-request mix of `phase_serve` must
    capture no graph of any owner. Each server starts after
    `graphs.clear()` (no vocoder graph of an earlier phase); the second,
    fresh, without the warm-up serves the same
    mix: requests/s and first-packet p50 / p95 of both (printed, not
    gated), and the warmed run's wall split into the frame loop, the
    vocoder and the rest."""
    from qwen3_tts_tpu_torch.runtime import graphs

    # no graph of an earlier phase helps either server, and the pool's bytes
    # after the warm-up are its own graphs' (earlier servers hold none)
    graphs.clear(model.device)
    gc.collect()
    torch.cuda.empty_cache()
    warm = _serve_run(model, eager=False, warm="warmup")
    line("server_warmup", seconds=f"{warm['warm_s']:.3f}",
         graphs_captured=warm["warm_captures"], serve_graphs=warm["serve_graphs"],
         staging_graphs=warm["staging_graphs"],
         codec_graphs=warm["warm_codec_graphs"],
         pool_mib=f"{warm['pool_bytes'] / 2**20:.1f}", mix_graphs_captured=warm["captures"],
         mix_graphs_replayed=warm["replays"])
    if warm["captures"]:
        raise AssertionError(f"the mix captured {warm['captures']} graphs after "
                             "TTSServer.warmup()")
    graphs.clear(model.device)
    cold = _serve_run(model, eager=False, warm=None)
    for name, r in (("warmed", warm), ("cold", cold)):
        line(f"server_warmup {name}", requests=SERVE_REQUESTS, completed=len(r["done"]),
             requests_per_s=f"{r['requests_per_s']:.3f}",
             first_packet_p50_s=f"{r['first_packet_p50']:.3f}",
             first_packet_p95_s=f"{r['first_packet_p95']:.3f}",
             mix_graphs_captured=r["captures"], **r["levels"])
        unclamped(f"server_warmup {name}", r["levels"])
    line("server_warmup split", **split_fields(warm["wall"], warm["split"]))
    return {"warm": warm, "cold": cold}


# the serving path's device spans (`utils/profiling.py`), and the tracing
# phase's mix: streamed requests, twice the smoke server's slots
DEVICE_SPANS = ("engine.stage", "engine.chunk", "server.vocode", "server.fast_first")
TRACE_REQUESTS = 16
TRACE_CLOCK_TOL_S = 1e-3


def phase_serve_trace(model) -> dict:
    """The serving path's tracing on the card: a warmed TTSServer at the
    smoke's serving configuration, `engine.trace_enabled` on, serves
    TRACE_REQUESTS streamed requests under torch.profiler. Every device
    span's counter (`DEVICE_SPANS`) must be positive and their sum no
    larger than the mix's wall; the `server.step` span of the mix's first
    step, run inside a `record_function` range, must start and end within
    TRACE_CLOCK_TOL_S of that range's event in the profiler's trace (the
    spans' clock is the profiler's); no device operation of the trace may
    carry a span's name (the serving path adds no profiler ranges). Printed:
    the spans' device ms against the card's busy time in the trace, and
    the benchmark's per-layer figures read from the phase's counters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from qwen3_tts_tpu_torch.runtime.server import AudioPacket, TTSServer
    from qwen3_tts_tpu_torch.utils.metrics import MetricsRegistry

    srv = TTSServer(model, num_slots=SERVE_SLOTS, overrides=SERVE_OVERRIDES,
                    max_new_tokens=MAX_NEW_TOKENS, seed=SEED, metrics=MetricsRegistry())
    srv.warmup()
    srv.engine.trace_enabled = True
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):      # CUPTI's start-up, outside the mix
        pass
    torch.cuda.synchronize()
    probe = "smoke.trace_probe"
    with profile(activities=acts) as prof:
        t0 = time.time()
        for i in range(TRACE_REQUESTS):
            srv.submit_custom_voice(f"t{i}", text=f"{TEXTS[i % len(TEXTS)]} Request {i}.",
                                    speaker="vivian", language="english", stream=True)
        with record_function(probe):
            events = srv.step()
        while srv.busy:
            events += srv.step()
        torch.cuda.synchronize()
        wall = time.time() - t0
    srv.tracer.resolve()
    counters = srv.metrics.snapshot()["counters"]
    spans = srv.trace_spans()
    device_ms = {n: counters.get(f"{n}.device_ms", 0.0) for n in DEVICE_SPANS}
    if min(device_ms.values()) <= 0 or sum(device_ms.values()) > wall * 1e3:
        raise AssertionError(f"serve_trace: device spans {device_ms} ms, wall {wall:.3f} s")
    kineto = prof.profiler.kineto_results.events()
    (ev,) = [e for e in kineto if e.name() == probe and e.device_type() == DeviceType.CPU]
    step = min((s for s in spans if s.name == "server.step"), key=lambda s: s.start)
    a = ev.start_ns() * 1e-9
    off = (step.start - a, step.end - (a + ev.duration_ns() * 1e-9))
    if max(abs(o) for o in off) > TRACE_CLOCK_TOL_S:
        raise AssertionError(f"serve_trace: server.step span {step} against the profiler's "
                             f"range [{a}, +{ev.duration_ns()} ns]: offsets {off} s")
    names = {s.name for s in spans}
    dev = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in kineto
           if e.device_type() == DeviceType.CUDA and e.name() != probe]
    if any(e.name() in names for e in kineto if e.device_type() == DeviceType.CUDA):
        raise AssertionError(f"serve_trace: a span's name on the device timeline: {names}")
    busy, end = 0, None
    for x, y in sorted(dev):
        if end is None or y > end:
            busy += y - (x if end is None else max(x, end))
            end = y
    c = counters
    audio_s = sum(e.frame_count for e in events if isinstance(e, AudioPacket)) * srv.up \
        / srv.sample_rate
    host_ms = c["server.step.host_ms"] + c["server.submit.host_ms"] - sum(
        c.get(f"{w}.host_ms", 0.0)
        for w in ("server.fast_first_wait", "engine.aux_wait", "server.egress_wait"))
    vocoder_ms = device_ms["server.vocode"] + device_ms["server.fast_first"]
    frames_ratio = c["server.vocode_frames_computed"] / c["server.vocode_frames_delivered"]
    line("serve_trace", requests=TRACE_REQUESTS, wall_s=f"{wall:.3f}",
         **{f"{n}_device_ms": f"{v:.3f}" for n, v in device_ms.items()},
         busy_s=f"{busy * 1e-9:.3f}",
         spans_over_busy=f"{sum(device_ms.values()) / (busy * 1e-6):.4f}",
         clock_offsets_ms=f"{off[0] * 1e3:.3f},{off[1] * 1e3:.3f}", host_spans=len(spans),
         tick_device_ms=f"{device_ms['engine.chunk'] / c['engine.ticks']:.3f}",
         stage_device_ms=f"{device_ms['engine.stage'] / c['engine.staged_rows']:.3f}",
         vocoder_ms_per_audio_s=f"{vocoder_ms / audio_s:.3f}",
         vocoder_frames_per_frame=f"{frames_ratio:.3f}",
         host_step_busy_pct=f"{100 * host_ms / (wall * 1e3):.2f}", card=card())
    return {"device_ms": device_ms, "wall": wall, "offsets": off}


def busy_share(prof, index: int, wall_s: float) -> float:
    """The share of `wall_s` in which card `index` ran anything (a kernel, a
    copy or a set) in the torch.profiler run `prof`: the union of their
    spans over the wall."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.device_index == index)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6 / wall_s


def _voc_server(model, mix: dict, **kw) -> dict:
    """A TTSServer of the vocoder_device phase (`mix`'s slots, kernel 2 in
    int8-KV mode, the smoke's seed; `kw`: vocoder_device or
    fast_first_packet), warmed with `warmup()`, then `mix`'s requests,
    profiled: every request's codes (the code sink) and float audio, the
    mix's requests/s, audio s per wall s, first-packet p50 / p95, the
    serving card's busy share, and the graphs each card captured after the
    warm-up."""
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import AudioPacket, AudioResult, TTSServer

    codes = {}
    srv = TTSServer(model, num_slots=mix["slots"], overrides=SERVE_OVERRIDES,
                    max_new_tokens=mix["frames"], seed=SEED,
                    code_sink=lambda rid, fr: codes.setdefault(rid, []).extend(fr), **kw)
    serving = torch.device("cuda", torch.cuda.current_device())
    cards = [serving] + [d for d in [srv.vocoder_device]
                         if d is not None and d.type == "cuda" and d != serving]
    warm_s = srv.warmup()
    ids = [f"v{i}" for i in range(mix["requests"])]
    stream = {rid: i in mix["streams"] for i, rid in enumerate(ids)}
    submits = [lambda rid=rid, i=i: srv.submit_custom_voice(
        rid, text=f"{TEXTS[i % len(TEXTS)]} Request {i}.", speaker="vivian",
        language="english", stream=stream[rid]) for i, rid in enumerate(ids)]
    c0 = {d: graphs.stats(d)["captures"] for d in cards}
    reset_launches()
    for d in cards:
        torch.cuda.synchronize(d)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        events, first, wall = serve_all(srv, submits)
        for d in cards:
            torch.cuda.synchronize(d)
    launches = read_launches()
    captures = {str(d): graphs.stats(d)["captures"] - c0[d] for d in cards}
    audio = {}
    for rid in ids:
        mine = [e for e in events if e.request_id == rid]
        ok = (mine and mine[-1].final and all(isinstance(e, AudioPacket) for e in mine)
              if stream[rid] else len(mine) == 1 and isinstance(mine[0], AudioResult))
        if not (ok and all(np.isfinite(e.wav).all() for e in mine)):
            raise AssertionError(f"vocoder_device {kw}: request {rid} did not complete: {mine}")
        audio[rid] = np.concatenate([e.wav for e in mine])
    if min(launches["subtalker"], launches["talker_step_int8_kv"]) <= 0:
        raise AssertionError(f"vocoder_device {kw}: launches {launches}")
    fp = np.array([first[rid] for rid in ids if stream[rid]])
    return {"srv": srv, "mix": mix, "codes": {rid: np.stack(fr) for rid, fr in codes.items()},
            "audio": audio, "warm_s": warm_s, "wall": wall, "captures": captures,
            "launches": launches, "requests_per_s": len(ids) / wall,
            "audio_s_per_s": sum(a.shape[0] for a in audio.values()) / 24000 / wall,
            "first_packet_p50": float(np.percentile(fp, 50)),
            "first_packet_p95": float(np.percentile(fp, 95)),
            "busy": busy_share(prof, serving.index, wall)}


def _pcm16(wav: np.ndarray) -> np.ndarray:
    from qwen3_tts_tpu_torch.models.codec12.decoder import to_pcm16

    return to_pcm16(torch.from_numpy(wav)).numpy()


def _voc_against(run: dict, ref: dict, tag: str) -> dict:
    """`run`'s codes equal `ref`'s, request by request, and its audio has
    their shapes. Returns, over every request's concatenated samples, the
    max abs difference, the PCM16 samples that differ, the samples, and
    `ref`'s `audio_levels`."""
    if set(run["codes"]) != set(ref["codes"]):
        raise AssertionError(f"{tag}: requests {sorted(run['codes'])} vs {sorted(ref['codes'])}")
    diffs, pcm_off = [], 0
    for rid, fr in ref["codes"].items():
        if not np.array_equal(run["codes"][rid], fr):
            raise AssertionError(f"{tag}: request {rid}'s codes differ from the one-card server's")
        a, b = run["audio"][rid], ref["audio"][rid]
        if a.shape != b.shape:
            raise AssertionError(f"{tag}: request {rid}'s audio {a.shape} vs {b.shape}")
        diffs.append(np.abs(a - b))
        pcm_off += int((_pcm16(a) != _pcm16(b)).sum())
    d = np.concatenate(diffs)
    return {"max_abs": float(d.max()), "pcm16_off": pcm_off, "samples": d.size,
            "levels": audio_levels(*(ref["audio"][rid] for rid in ref["codes"]))}


def _voc_same_card(run: dict, ref: dict, tag: str) -> dict:
    """`_voc_against`, held to a card's vocoder: float within CODEC_TOL and
    PCM16 equal."""
    r = _voc_against(run, ref, tag)
    unclamped(tag, r["levels"])
    if r["max_abs"] > CODEC_TOL or r["pcm16_off"]:
        raise AssertionError(f"{tag}: audio max abs {r['max_abs']:.3g} (bar {CODEC_TOL}), "
                             f"{r['pcm16_off']} PCM16 samples differ")
    if any(run["captures"].values()):
        raise AssertionError(f"{tag}: graphs captured after the warm-up: {run['captures']}")
    return r


def _voc_line(name: str, r: dict, **extra) -> None:
    mix = r["mix"]
    line(f"vocoder_device {name}", slots=mix["slots"], requests=mix["requests"],
         streamed=len(mix["streams"]), frames=mix["frames"], warmup_s=f"{r['warm_s']:.3f}",
         wall_s=f"{r['wall']:.3f}", requests_per_s=f"{r['requests_per_s']:.3f}",
         audio_s_per_wall_s=f"{r['audio_s_per_s']:.3f}",
         first_packet_p50_s=f"{r['first_packet_p50']:.3f}",
         first_packet_p95_s=f"{r['first_packet_p95']:.3f}",
         serving_card_busy_share=f"{r['busy']:.4f}", captures_after_warmup=r["captures"],
         **extra)


def phase_vocoder_device(model, routes=("a", "b", "c"), mix=VOC_MIX) -> dict:
    """`TTSServer(vocoder_device=...)` (slice 14) on the int8 custom-voice
    model, kernels 1 and 2 on, every server warmed with `warmup()` and then
    serving `mix`: the reference, a one-card server built
    with fast_first_packet=False (which a vocoder device implies, so both
    schedule alike), and the default one-card server (its fast first packet
    on: what losing it costs, printed); then the `routes`: (a) the vocoder
    on the serving card named explicitly: codes equal the reference's, each
    request's audio PCM16-equal and within CODEC_TOL, no capture after the
    warm-up; (b) the vocoder on the host's CPU, the talker on the card:
    codes equal, audio within VOC_CPU_TOL of the card's vocoder, the
    server's decoder params on the CPU and the model's on the card, no
    capture on the card after the warm-up; (c) where the host has a second card, the vocoder there: codes
    and PCM16 equal, no capture on either card after the warm-up; else one
    line that says (c) did not run. Requests/s, audio s per wall s,
    first-packet p50 / p95 and the serving card's busy share of each."""
    from qwen3_tts_tpu_torch.runtime import graphs

    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    # the first profiler session starts CUPTI; not inside a measured mix
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    ref = _voc_server(model, mix, fast_first_packet=False)
    default = _voc_server(model, mix)
    levels = {name: audio_levels(*r["audio"].values()) for name, r in
              (("ref", ref), ("default", default))}
    _voc_line("one card", ref, fast_first_packet=False, **levels["ref"])
    _voc_line("one card default", default, fast_first_packet=True, **levels["default"])
    for name, lv in levels.items():
        unclamped(f"vocoder_device one card {name}", lv)
    out = {"ref": ref, "default": default}
    if "a" in routes:
        named = out["a"] = _voc_server(
            model, mix, vocoder_device=torch.device("cuda", torch.cuda.current_device()))
        a = _voc_same_card(named, ref, "(a) the serving card named")
        _voc_line("(a) serving card named", named, codes_equal=True,
                  audio_max_abs=f"{a['max_abs']:.3g}", pcm16_equal=True, **a["levels"])
    if "b" in routes:
        cpu = out["b"] = _voc_server(model, mix, vocoder_device="cpu")
        srv = cpu["srv"]
        if (graphs.params_device(srv.dec_params).type != "cpu"
                or graphs.params_device(model.speech_tokenizer.dec_params).type != "cuda"):
            raise AssertionError("(b): the server's decoder params must lie on the CPU and "
                                 "the model's on the card")
        b = _voc_against(cpu, ref, "(b) the vocoder on the CPU")
        _voc_line("(b) vocoder on the cpu", cpu, codes_equal=True,
                  audio_max_abs_vs_card=f"{b['max_abs']:.3g}", tolerance=VOC_CPU_TOL,
                  pcm16_samples_off=b["pcm16_off"], samples=b["samples"], **b["levels"],
                  torch_threads=torch.get_num_threads())
        unclamped("(b) the vocoder on the CPU", b["levels"])
        if b["max_abs"] > VOC_CPU_TOL:
            raise AssertionError(f"(b): audio max abs {b['max_abs']:.3g} off the card's "
                                 f"vocoder (bar {VOC_CPU_TOL})")
        if any(cpu["captures"].values()):
            raise AssertionError(f"(b): graphs captured after the warm-up: {cpu['captures']}")
    if "c" in routes:
        n = torch.cuda.device_count()
        if n < 2:
            line("vocoder_device (c) second card", ran=False,
                 reason=f"this host has {n} CUDA device; the route needs 2")
        else:
            second = out["c"] = _voc_server(model, mix, vocoder_device=1)
            c = _voc_same_card(second, ref, "(c) the vocoder on a second card")
            _voc_line("(c) second card", second, codes_equal=True,
                      audio_max_abs=f"{c['max_abs']:.3g}", pcm16_equal=True, **c["levels"],
                      vocoder_card=torch.cuda.get_device_name(1))
    for r in out.values():
        del r["srv"]
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_clone(model, front) -> None:
    """TTSServer over the clone model: two streamed ICL clone requests with
    different reference clips, their staging prefill (bucket 512) through
    kernel 3 inside the staging graphs. Each one's first packet must be the
    vocoder run over its OWN last reference frames and its first generated
    frames (vocoded again here), and not over the other request's; the same
    run inside `graphs.eager()` must give every request the same codes."""
    from qwen3_tts_tpu_torch.models.codec12.decoder import decode_frames
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import AudioPacket, TTSServer

    wav, sr = front["wav"], front["sr"]
    refs = {"a": (wav, sr), "b": (wav[:len(wav) * 6 // 10], sr)}
    items = {rid: model.create_voice_clone_prompt(r, ref_text=CLONE_REF_TEXT)[0]
             for rid, r in refs.items()}

    def serve(eager: bool):
        frames = {}
        with graphs.eager() if eager else contextlib.nullcontext():
            srv = TTSServer(model, num_slots=2, prefill_bucket=512, overrides=SERVE_OVERRIDES,
                            max_new_tokens=CLONE_MAX_NEW_TOKENS, seed=SEED,
                            code_sink=lambda rid, fr: frames.setdefault(rid, []).extend(fr))
            reset_launches()
            submits = [lambda rid=rid, t=t: srv.submit_voice_clone(
                rid, text=t, language="english", voice_clone_prompt=[items[rid]], stream=True)
                for rid, t in (("a", "A short line in the first voice."),
                               ("b", "And another short line, in the second voice."))]
            events, first, wall = serve_all(srv, submits)
        staging = 0 if eager else len(srv.engine._graphs.staging)
        return srv, frames, events, first, wall, read_launches(), staging

    srv, frames, events, first, wall, launches, staging = serve(False)
    eager_frames = serve(True)[1]
    codes_equal = set(frames) == set(eager_frames) and all(
        np.array_equal(np.stack(frames[r]), np.stack(eager_frames[r])) for r in frames)
    tok = model.speech_tokenizer
    up, ctx = tok.get_decode_upsample_rate(), srv.left_context
    errs = {}
    for rid in ("a", "b"):
        pkt = next(e for e in events if isinstance(e, AudioPacket) and e.request_id == rid)
        k = pkt.frame_count
        new = np.stack(frames[rid][:k])
        for ctx_of in ("a", "b"):
            codes = np.concatenate([items[ctx_of].ref_code[-ctx:], new]).T[None]
            with torch.no_grad():
                w = decode_frames(tok.dec_params, tok.config.decoder_config,
                                  torch.as_tensor(codes, device=tok.dec_params["_codebooks"].device))
            errs[(rid, ctx_of)] = float(np.abs(w[0, 0, -k * up:].cpu().numpy() - pkt.wav).max())
    own = max(errs[("a", "a")], errs[("b", "b")])
    other = min(errs[("a", "b")], errs[("b", "a")])
    levels = audio_levels(*(e.wav for e in events))
    line("serve clone", requests=2, prefill_bucket=512, wall_s=f"{wall:.3f}",
         first_packet_s={r: f"{t:.3f}" for r, t in first.items()},
         first_packet_vs_own_context_max_abs=f"{own:.3g}",
         first_packet_vs_other_context_min_abs=f"{other:.3g}", staging_graphs=staging,
         codes_equal_eager=codes_equal, launches=launches, **levels)
    unclamped("serve clone", levels)
    if not (own <= CLONE_CTX_TOL < other):
        raise AssertionError(f"clone serving context: {errs}")
    if launches["talker_step_int8_kv"] <= 0 or launches["flash_prefill"] <= 0 or not staging:
        raise AssertionError(f"clone serving launches {launches}, staging graphs {staging}")
    if not codes_equal:
        raise AssertionError("clone serving: graphed and eager staging give other codes")


FRONT_ITERS = 5                # timed calls per route of the front-end programs
FRONT_LENGTHS = 20             # distinct clip lengths encoded against the vocoder's graphs
FRONT_CLIPS = 8                # distinct reference clips sent to a clone server
XVEC_TOL = 1e-6                # the x-vector graphed against eager (max abs)


def wall_ms(fn, n: int) -> tuple:
    """(median host wall ms of n synchronised calls of fn, the last output)."""
    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times)), out


def phase_front_graphs(model, front) -> dict:
    """The clone front end's captured graphs (`runtime/graphs.py`
    `FrontGraphs`: the 12 Hz encode per padded (rows, samples), ECAPA per
    exact length, a key captured at its second call) against the eager
    programs: a 9 s cut of the reference clip (a length the run has not
    seen) through `Qwen3TTSTokenizer.encode` and
    `extract_speaker_embedding`; the wall ms of each program's first call
    of the length (eager: what a clip sent once costs), its second
    (warm-up, capture and replay), a replay and the eager program (medians
    of FRONT_ITERS); no capture at the first call, one at the second; the
    codes equal and the x-vector within XVEC_TOL, graphed against eager;
    `create_voice_clone_prompt`'s split into encode, ECAPA and the host's
    part (resampling, normalisation, copies), graphed and eager; then
    FRONT_LENGTHS clip lengths, after `graphs.clear`, encoded once each (no
    capture) and again (one capture each), after which the vocoder's graphs
    must be the ones before, count and keys."""
    from qwen3_tts_tpu_torch.inference import model as api
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.speaker_encoder import extract_speaker_embedding
    from qwen3_tts_tpu_torch.runtime import graphs

    tok, sr = model.speech_tokenizer, front["sr"]
    clip = front["wav"][:9 * sr]
    spk_params, spk_cfg = model.speaker_encoder_params, model.config.speaker_encoder_config
    programs = {"encode": lambda: tok.encode((clip, sr)).audio_codes[0],
                "ecapa": lambda: extract_speaker_embedding(spk_params, spk_cfg, clip).cpu()}

    def captures():
        return graphs.stats(model.device)["captures"]

    res, outs = {}, {}
    for name, fn in programs.items():
        c0 = captures()
        first, outs[name, "first"] = wall_ms(fn, 1)
        c1 = captures()
        second, outs[name, "graph"] = wall_ms(fn, 1)
        c2 = captures()
        replay, again = wall_ms(fn, FRONT_ITERS)
        with graphs.eager():
            eager, outs[name, "eager"] = wall_ms(fn, FRONT_ITERS)
        if (c1 - c0, c2 - c1, captures() - c2) != (0, 1, 0):
            raise AssertionError(f"front end {name}: captures {c1 - c0}, {c2 - c1}, "
                                 f"{captures() - c2} at a length's first, second and later calls")
        if not np.array_equal(np.asarray(again), np.asarray(outs[name, "graph"])):
            raise AssertionError(f"front end {name}: a replay differs from its capture's call")
        res[name] = dict(first_ms=first, second_ms=second, replay_ms=replay, eager_ms=eager)
    codes_equal = np.array_equal(outs["encode", "graph"], outs["encode", "eager"])
    xvec_err = float(np.abs(outs["ecapa", "graph"].numpy() - outs["ecapa", "eager"].numpy()).max())

    parts = ((Qwen3TTSTokenizer, "encode", "encode"),
             (api, "extract_speaker_embedding", "ecapa"))
    split = {}
    for route in ("graph", "eager"):
        with graphs.eager() if route == "eager" else contextlib.nullcontext():
            model.create_voice_clone_prompt((clip, sr), ref_text=CLONE_REF_TEXT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with owner_device_ms(parts) as sp:
                model.create_voice_clone_prompt((clip, sr), ref_text=CLONE_REF_TEXT)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        split[route] = dict(wall_ms=wall, encode_ms=sp["encode"], ecapa_ms=sp["ecapa"],
                            host_ms=wall - sp["encode"] - sp["ecapa"])

    # the lengths start unseen (earlier phases met some of their buckets),
    # beside a vocoder graph to keep
    graphs.clear(model.device)
    dev = graphs._device(model.device)
    tok.decode([{"audio_codes": front["items"][0].ref_code}])
    vocoder = list(dev.codec.graphs)
    bucket = 8 * tok.get_encode_downsample_rate()
    long_wav = np.tile(front["wav"], -(-(FRONT_LENGTHS + 1) * bucket // len(front["wav"])))
    walls, counts = [], []
    for _ in range(2):
        before = captures()
        t0 = time.perf_counter()
        for k in range(1, FRONT_LENGTHS + 1):   # buckets 2 to FRONT_LENGTHS + 1
            tok.encode((long_wav[:k * bucket + 77], sr))
        walls.append(time.perf_counter() - t0)
        counts.append(captures() - before)
    st = graphs.stats(model.device)
    kept = list(dev.codec.graphs) == vocoder
    line("front_graphs", clip_s=9, **{f"{n}_{k}": f"{v:.2f}" for n, r in res.items()
                                      for k, v in r.items()},
         codes_equal_eager=codes_equal, xvector_max_abs=f"{xvec_err:.3g}",
         **{f"split_{route}": {k: f"{v:.2f}" for k, v in sp.items()}
            for route, sp in split.items()},
         lengths=FRONT_LENGTHS, lengths_once_s=f"{walls[0]:.2f}",
         lengths_once_captures=counts[0], lengths_again_s=f"{walls[1]:.2f}",
         lengths_again_captures=counts[1], encode_graphs=st["encode_graphs"],
         ecapa_graphs=st["ecapa_graphs"], vocoder_graphs=len(vocoder),
         vocoder_graphs_kept=kept, pool_mib=f"{st['pool_bytes'] / 2**20:.1f}")
    if not codes_equal or not xvec_err <= XVEC_TOL:
        raise AssertionError(f"front end graphed vs eager: codes equal {codes_equal}, "
                             f"x-vector max abs {xvec_err}")
    if counts != [0, FRONT_LENGTHS]:
        raise AssertionError(f"captures {counts} for {FRONT_LENGTHS} lengths seen once, then "
                             "again (want none, then one each)")
    if not kept or not vocoder:
        raise AssertionError(f"{FRONT_LENGTHS} clip lengths changed the vocoder's "
                             f"{len(vocoder)} graphs")
    return dict(res, split=split)


def phase_clone_server_clips(model, front) -> dict:
    """Clone servers meeting distinct reference clips (2.5 to 9.5 s cut
    from the reference clip at seeded lengths and offsets, each request
    sending its clip as `ref_audio`, so that the server's submit runs the
    front end on the thread of its ticks): a graphed server, after
    `TTSServer.warmup()` (which captures the encode of every reference
    bucket its prefill admits), takes FRONT_CLIPS clips and the first once
    more; then a server inside `graphs.eager()` takes FRONT_CLIPS other
    clips and the first of them once more (lengths neither met before, as
    a server meets new users; the encode buckets are warm for both, the
    eager route's through the warm-up's eager first calls). Gates: the
    graphed server's traffic captures nothing (`graphs.replay_only`) and
    completes; then each of its clips' prompt (`create_voice_clone_prompt`
    inside `replay_only`, through the warmed graphs) has the eager route's
    codes and an x-vector within XVEC_TOL. Prints the warm-up's seconds and
    graphs, the submit ms p50 and max, the wall and requests/s of both."""
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import AudioResult, TTSServer

    rng = np.random.default_rng(SEED + 19)
    wav, sr = front["wav"], front["sr"]
    sets = []
    for _ in range(2):
        clips = []
        for _ in range(FRONT_CLIPS):
            n = int(rng.integers(int(2.5 * sr), int(9.5 * sr)))
            off = int(rng.integers(0, len(wav) - n))
            clips.append(wav[off:off + n])
        sets.append(clips + [clips[0]])

    def serve(eager: bool, clips) -> dict:
        with graphs.eager() if eager else contextlib.nullcontext():
            srv = TTSServer(model, num_slots=4, prefill_bucket=512, overrides=SERVE_OVERRIDES,
                            max_new_tokens=CLONE_MAX_NEW_TOKENS // 2, seed=SEED)
            c0 = graphs.stats(model.device)
            warm_s = 0.0 if eager else srv.warmup()
            c1 = graphs.stats(model.device)
            submit_ms = []
            t0 = time.perf_counter()
            for i, c in enumerate(clips):
                s0 = time.perf_counter()
                srv.submit_voice_clone(f"c{i}", text="A short line in the cloned voice.",
                                       language="english", ref_audio=(c, sr),
                                       ref_text=CLONE_REF_TEXT)
                submit_ms.append(1e3 * (time.perf_counter() - s0))
            done = [e for e in srv.run_until_drained() if isinstance(e, AudioResult)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c2 = graphs.stats(model.device)
        return dict(warm_s=warm_s, warm_captures=c1["captures"] - c0["captures"],
                    encode_graphs=c1["encode_graphs"], submit_ms=submit_ms, wall=wall,
                    done=len(done), captures=c2["captures"] - c1["captures"])

    graphs.clear(model.device)
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"graph": serve(False, sets[0]), "eager": serve(True, sets[1])}
    g = runs["graph"]
    # the warmed encode graphs and the eager front end on the graphed
    # server's clips: equal codes, the x-vector within XVEC_TOL
    codes_equal, xvec_err = True, 0.0
    before = graphs.stats(model.device)["captures"]
    for c in sets[0][:FRONT_CLIPS]:
        with graphs.replay_only():
            a = model.create_voice_clone_prompt((c, sr), ref_text=CLONE_REF_TEXT)[0]
        with graphs.eager():
            b = model.create_voice_clone_prompt((c, sr), ref_text=CLONE_REF_TEXT)[0]
        codes_equal &= np.array_equal(a.ref_code, b.ref_code)
        xvec_err = max(xvec_err, float(np.abs(np.asarray(a.ref_spk_embedding)
                                              - np.asarray(b.ref_spk_embedding)).max()))
    prompt_captures = graphs.stats(model.device)["captures"] - before
    for name, r in runs.items():
        line(f"clone server clips {name}", clips=FRONT_CLIPS + 1, distinct=FRONT_CLIPS,
             completed=r["done"], warmup_s=f"{r['warm_s']:.3f}",
             warmup_captures=r["warm_captures"], encode_graphs=r["encode_graphs"],
             submit_ms_p50=f"{np.median(r['submit_ms']):.2f}",
             submit_ms_max=f"{max(r['submit_ms']):.2f}",
             submit_ms=[f"{x:.2f}" for x in r["submit_ms"]], wall_s=f"{r['wall']:.3f}",
             requests_per_s=f"{(FRONT_CLIPS + 1) / r['wall']:.3f}",
             traffic_captures=r["captures"])
    line("clone server clips prompts", clips=FRONT_CLIPS, codes_equal_eager=codes_equal,
         xvector_max_abs=f"{xvec_err:.3g}", captures=prompt_captures)
    if g["captures"] or not g["encode_graphs"] or prompt_captures:
        raise AssertionError(f"clone server: {g['captures']} captures by the traffic after "
                             f"a warm-up of {g['encode_graphs']} encode graphs")
    if any(r["done"] != FRONT_CLIPS + 1 for r in runs.values()):
        raise AssertionError(f"clone server clips: completed {[r['done'] for r in runs.values()]}")
    if not codes_equal or not xvec_err <= XVEC_TOL:
        raise AssertionError(f"clone server clips: prompts graphed vs eager: codes equal "
                             f"{codes_equal}, x-vector max abs {xvec_err}")
    graphs.clear(model.device)
    return runs


def prefill_ab(model, specs, tag: str, **kw) -> dict:
    """`init_decode_state` on one batch of assembled prompts, graphed (a
    first call captures the context's prefill graph, a second replays it)
    and inside `graphs.eager()`, from generators of one seed: the KV cache
    (and its scales) at max abs 0, the first code0, the last hidden, the
    consts and the generators' states after equal; the replay captures
    nothing and launches kernel 3 once a layer where the route takes it
    (`talker.prefill_uses_flash`: T >= 256 and the kernel's shapes), else
    never. Then the whole frame result (`frame_result`) graphed against
    eager: equal."""
    from qwen3_tts_tpu_torch.models.talker import StackDims, prefill_uses_flash
    from qwen3_tts_tpu_torch.runtime import generate, graphs
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    tc, dev = model.config.talker_config, model.device
    gen_cfg = model._generation_config(model._merge_generate_kwargs(**kw))
    with torch.no_grad():
        inputs = assemble_prompt_specs(model.talker_params, tc, model.config, specs, bucket=32)
        B, T = inputs[1].shape
        S = generate.kv_capacity(gen_cfg, T)

        def init():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            state, const = generate.init_decode_state(model.talker_params, tc, gen_cfg,
                                                      *inputs, gen, S)
            torch.cuda.synchronize()
            return state, const, gen.get_state()

        init()   # the capture
        s0 = graphs.stats(dev)
        reset_launches()
        g_state, g_const, g_gen = init()
        launches, counts = read_launches(), graph_counts(dev, s0)
        with graphs.eager():
            e_state, e_const, e_gen = init()
    if g_state.graphs is None or e_state.graphs is not None:
        raise AssertionError(f"{tag}: prefill routes {g_state.graphs} / {e_state.graphs}")
    kv = max(max_abs(getattr(g_state.cache, f), getattr(e_state.cache, f))
             for f in ("k", "v", "k_scale", "v_scale") if getattr(e_state.cache, f) is not None)
    same = (torch.equal(g_state.code0, e_state.code0)
            and torch.equal(g_state.last_hidden, e_state.last_hidden)
            and torch.equal(g_gen, e_gen)
            and all(torch.equal(getattr(g_const, f), getattr(e_const, f))
                    for f in ("valid_prefill", "seq_lens", "prefill_len", "samp_row",
                              "sub_row", "tts_pad_embed")))
    L = tc.num_hidden_layers
    flash = prefill_uses_flash(StackDims.from_talker(tc), T, inputs[0].dtype)
    want_flash = L if flash else 0
    del g_state, e_state
    g = frame_result(model, specs, **kw)
    with graphs.eager():
        e = frame_result(model, specs, **kw)
    codes_equal = _same_result(g, e)
    line(f"prefill graph vs eager {tag}", B=B, T=T, kv_max_abs=kv, first_code0_equal=same,
         codes_equal=codes_equal, flash_launches=launches["flash_prefill"], **counts)
    if kv != 0 or not same or not codes_equal:
        raise AssertionError(f"{tag}: graphed prefill differs from eager (kv {kv}, state and "
                             f"consts equal {same}, codes equal {codes_equal})")
    if counts != {"graphs_captured": 0, "graphs_replayed": 1} or (
            launches["flash_prefill"] != want_flash):
        raise AssertionError(f"{tag}: the prefill replay: {counts}, flash launches "
                             f"{launches['flash_prefill']} (want {want_flash})")
    return {"launches": launches, "T": T, "dtype": inputs[0].dtype}


def phase_prefill_graphs(model) -> None:
    """The prefill graphs against the eager prefill (`prefill_ab`) on the
    custom-voice call's prompts, with a bf16 and an int8 KV cache, sampled,
    and on the stream's (streaming text layout, int8 KV)."""
    cv = model._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    for kv_quant in (False, True):
        prefill_ab(model, cv, f"custom voice {'int8' if kv_quant else 'bf16'}_kv",
                   max_new_tokens=MAX_NEW_TOKENS, kv_quant=kv_quant)
    prefill_ab(model, model._specs_custom_voice(TEXTS, "vivian", "english", None, False),
               "stream int8_kv", max_new_tokens=MAX_NEW_TOKENS, kv_quant=True)


MISFIT_TALKER = dict(   # 4 query heads per kv head: kernels 2 and 3 do not take it
    vocab_size=6400, hidden_size=256, intermediate_size=1536, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=2, head_dim=64, text_hidden_size=256,
    text_vocab_size=151936, num_code_groups=16)
MISFIT_CP = dict(vocab_size=2048, hidden_size=256, intermediate_size=768, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=64, num_code_groups=16)
# kernel 3's groups and head_dim, loaded in fp32: its only misfit is the dtype
MISFIT_FP32_TALKER = dict(MISFIT_TALKER, num_attention_heads=4, head_dim=128)
# a non-streaming prompt past FLASH_PREFILL_MIN_T (one text id a character)
MISFIT_LONG_TEXT = CLONE_TEXT * 5


def misfit_model(cfg_kw: dict, device, int8: bool):
    """A custom-voice model of a tiny talker (`cfg_kw`, MISFIT_CP's code
    predictor), random from the seed: int8 weights with bf16 activations, or
    an fp32 load; every text id kept (long prompts)."""
    from qwen3_tts_tpu_torch.config import CodePredictorConfig, TalkerConfig
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.weights import quantize_talker_params

    cfg = TalkerConfig(**cfg_kw, code_predictor_config=CodePredictorConfig(**MISFIT_CP))
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = random_talker_params(cfg, gen, dtype=torch.bfloat16 if int8 else torch.float32)
    model = build_model(quantize_talker_params(params) if int8 else params, cfg, device,
                        quantized="int8" if int8 else None)
    model.processor = StandInTokenizer(max_ids=None)
    return model


def misfit_long_prompt(model, label: str) -> None:
    """`model` answers MISFIT_LONG_TEXT in the non-streaming layout (a
    prefill past FLASH_PREFILL_MIN_T) through generate_custom_voice without
    launching kernel 3 (its shapes break `flash_misfit`, so the dense
    attention runs); its prefill graph and frame loop against
    `graphs.eager()` (`prefill_ab`: KV equal, 0 kernel-3 launches, the
    frame result equal)."""
    from qwen3_tts_tpu_torch.models.talker import FLASH_PREFILL_MIN_T
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import flash_misfit

    tc = model.config.talker_config
    up = model.speech_tokenizer.get_decode_upsample_rate()
    kw = dict(seed=SEED, max_new_tokens=MAX_NEW_TOKENS)
    reset_launches()
    wavs, sr = model.generate_custom_voice([MISFIT_LONG_TEXT], speaker="vivian",
                                           language="english", non_streaming_mode=True, **kw)
    launches = read_launches()
    specs = model._specs_custom_voice([MISFIT_LONG_TEXT], "vivian", "english", None, True)
    ab = prefill_ab(model, specs, f"misfit {label}", max_new_tokens=MAX_NEW_TOKENS)
    rule = flash_misfit(ab["dtype"], tc.num_attention_heads, tc.num_key_value_heads,
                        tc.resolved_head_dim)
    levels = audio_levels(*wavs)
    line(f"misfit {label} long prompt", T=ab["T"], flash_misfit=repr(rule),
         api_flash_launches=launches["flash_prefill"],
         prefill_replay_flash_launches=ab["launches"]["flash_prefill"], codes_equal_eager=True,
         frames=[w.shape[0] // up for w in wavs], **levels)
    if ab["T"] < FLASH_PREFILL_MIN_T or rule is None or launches["flash_prefill"]:
        raise AssertionError(f"misfit {label}: T {ab['T']}, rule {rule}, launches {launches}")
    if sr != 24000 or not all(np.isfinite(w).all() and w.shape[0] % up == 0 for w in wavs):
        raise AssertionError(f"misfit {label}: waveforms {[w.shape for w in wavs]} at {sr} Hz")
    unclamped(f"misfit {label} long prompt", levels)


def phase_misfit(device) -> None:
    """An int8 tiny talker with 4 query heads per kv head (random weights
    from the seed): with no flag the model defaults to kernel 1, whose
    shapes it fits, and to the plain talker step, whose kernel it does not
    fit (`config_misfit`); generate_custom_voice then runs, kernel 2 never
    launched, finite whole-frame audio; a named fused_talker_step=True
    still raises. Then kernel 3's route (slice 15): that talker, and an
    fp32 load of a talker with kernel 3's groups and head_dim, each answer a
    prompt past FLASH_PREFILL_MIN_T without launching kernel 3
    (`misfit_long_prompt`)."""
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import config_misfit

    model = misfit_model(MISFIT_TALKER, device, int8=True)
    cfg = model.config.talker_config
    g = model._generation_config(model._merge_generate_kwargs())
    if not g.fused_subtalker or g.fused_talker_step:
        raise AssertionError(f"G=4 defaults: fused_subtalker={g.fused_subtalker}, "
                             f"fused_talker_step={g.fused_talker_step}")
    kw = dict(speaker="vivian", language="english", seed=SEED, max_new_tokens=MAX_NEW_TOKENS)
    reset_launches()
    wavs, sr = model.generate_custom_voice(TEXTS, **kw)
    launches = read_launches()
    up = model.speech_tokenizer.get_decode_upsample_rate()
    if not all(np.isfinite(w).all() and w.shape[0] % up == 0 for w in wavs) or sr != 24000:
        raise AssertionError(f"G=4: waveforms {[w.shape for w in wavs]} at {sr} Hz")
    if launches["subtalker"] <= 0 or launches["talker_step"] or launches["talker_step_int8_kv"]:
        raise AssertionError(f"G=4 launches {launches}")
    try:
        model.generate_custom_voice(TEXTS, fused_talker_step=True, **kw)
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("G=4 with fused_talker_step=True did not raise")
    levels = audio_levels(*wavs)
    line("misfit G=4", misfit=config_misfit(cfg), fused_subtalker=True,
         fused_talker_step=False, frames=[w.shape[0] // up for w in wavs], launches=launches,
         named_flag_raises=raised[:60], **levels)
    unclamped("misfit G=4", levels)
    misfit_long_prompt(model, "G=4 int8")
    misfit_long_prompt(misfit_model(MISFIT_FP32_TALKER, device, int8=False), "G=2 fp32")


def frame_result(model, specs, **kw):
    """The GenerationResult (codes, lengths, hidden) that `_run` computes for
    `specs` with these generate kwargs and the smoke's seed: its route,
    called directly."""
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames, generate_frames_chunked
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    tc = model.config.talker_config
    gen_cfg = model._generation_config(model._merge_generate_kwargs(**kw))
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    with torch.no_grad():
        embeds, mask, trailing, pad = assemble_prompt_specs(model.talker_params, tc,
                                                            model.config, specs, bucket=32)
        run = generate_frames_chunked if gen_cfg.max_new_tokens > 1024 else generate_frames
        return run(model.talker_params, tc, gen_cfg, embeds, mask, trailing, pad, gen)


def _same_result(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def graph_counts(device, before: dict) -> dict:
    """Graphs captured and replayed on `device` since `graphs.stats` gave
    `before`."""
    from qwen3_tts_tpu_torch.runtime import graphs

    now = graphs.stats(device)
    return {"graphs_captured": now["captures"] - before["captures"],
            "graphs_replayed": now["replays"] - before["replays"]}


def phase_graph_ab(model) -> dict:
    """The frame loop as CUDA graph replays against the eager loop, 1.7B
    int8, the smoke's 4 texts: greedy and sampled from one seeded
    generator, bf16 and int8 KV. Codes, lengths and hidden states must be
    equal; the graphed call must replay graphs and the eager one none. Then
    the API call's wall, graphed and eager (each after a warm-up): the tick
    (wall / the longest row's frames) and the RTF."""
    from qwen3_tts_tpu_torch.runtime import graphs

    dev = model.device
    specs = model._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    out = {}
    for kv_quant in (False, True):
        for sampled in (False, True):
            kw = dict(max_new_tokens=MAX_NEW_TOKENS, kv_quant=kv_quant, do_sample=sampled,
                      subtalker_dosample=sampled)
            s0 = graphs.stats(dev)
            g = frame_result(model, specs, **kw)
            s1 = graphs.stats(dev)
            with graphs.eager():
                e = frame_result(model, specs, **kw)
            s2 = graphs.stats(dev)
            tag = f"{'int8' if kv_quant else 'bf16'}_kv {'sampled' if sampled else 'greedy'}"
            if s1["replays"] == s0["replays"] or s2["replays"] != s1["replays"]:
                raise AssertionError(f"{tag}: replays {s0['replays']} -> {s1['replays']} "
                                     f"(graphed) -> {s2['replays']} (eager)")
            if not _same_result(g, e):
                raise AssertionError(f"{tag}: graphed and eager results differ: lengths "
                                     f"{g.lengths.tolist()} vs {e.lengths.tolist()}")
            H = model.config.talker_config.hidden_size
            if g.hidden.shape != (len(TEXTS), MAX_NEW_TOKENS - 1, H):
                raise AssertionError(f"{tag}: hidden {tuple(g.hidden.shape)}")
            out[tag] = g
            line(f"graph vs eager {tag}", lengths=g.lengths.tolist(), codes_equal=True,
                 hidden_equal=True, graphs_captured=s1["captures"] - s0["captures"],
                 graphs_replayed=s1["replays"] - s0["replays"])
    up = model.speech_tokenizer.get_decode_upsample_rate()
    lengths = out["bf16_kv sampled"].lengths
    frames, audio_s = int(lengths.max()), float(lengths.sum()) * up / 24000

    def call():
        return model.generate_custom_voice(TEXTS, speaker="vivian", language="english",
                                           seed=SEED, max_new_tokens=MAX_NEW_TOKENS)

    walls = {}
    for name in ("graph", "eager"):
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            call()
            walls[name] = timed(call)[1]
    line("graph vs eager wall", texts=len(TEXTS), frames=frames,
         **{f"{k}_wall_s": f"{w:.4f}" for k, w in walls.items()},
         **{f"{k}_tick_ms": f"{w / frames * 1e3:.3f}" for k, w in walls.items()},
         **{f"{k}_rtf": f"{w / audio_s:.4f}" for k, w in walls.items()})
    return {"walls": walls, "frames": frames}


@contextlib.contextmanager
def recorded_stream_codes():
    """The frames (zeroed where inactive) of every chunk the streaming
    session decodes inside the block, in order, on the host."""
    from qwen3_tts_tpu_torch.runtime import streaming

    got, real = [], streaming.decode_chunk

    def rec(*a, **k):
        state, frames, active = real(*a, **k)
        got.append((frames * active[..., None].to(frames.dtype)).cpu())
        return state, frames, active

    streaming.decode_chunk = rec
    try:
        yield got
    finally:
        streaming.decode_chunk = real


def _stream(model):
    return model.stream_custom_voice(TEXTS, speaker="vivian", language="english", seed=SEED,
                                     kv_quant=True, max_new_tokens=MAX_NEW_TOKENS)


def phase_stream_ab(model) -> dict:
    """stream_custom_voice (int8 KV) with its chunks as graph replays, then
    on the eager loop: the same chunks' codes and the same packets."""
    from qwen3_tts_tpu_torch.runtime import graphs

    runs = {}
    for name in ("graph", "eager"):
        with graphs.eager() if name == "eager" else contextlib.nullcontext():
            s0 = graphs.stats(model.device)
            with recorded_stream_codes() as chunks:
                (wavs, wall) = timed(lambda: [w for w, _ in _stream(model)])
            s1 = graphs.stats(model.device)
        runs[name] = (torch.cat(chunks, dim=1), wavs, wall, s1["replays"] - s0["replays"])
    (gc, gw, gwall, grep), (ec, ew, ewall, erep) = runs["graph"], runs["eager"]
    if not (grep > 0 and erep == 0):
        raise AssertionError(f"stream replays: graphed {grep}, eager {erep}")
    if not (torch.equal(gc, ec) and len(gw) == len(ew)
            and all(np.array_equal(a, b) for a, b in zip(gw, ew))):
        raise AssertionError("graphed and eager streams differ")
    levels = audio_levels(*gw)
    line("stream graph vs eager", packets=len(gw), frames=gc.shape[1], codes_equal=True,
         packets_equal=True, graph_wall_s=f"{gwall:.3f}", eager_wall_s=f"{ewall:.3f}",
         graphs_replayed=grep, **levels)
    unclamped("stream graph vs eager", levels)
    return {"codes": gc}


def phase_graph_memory(model, stream_codes) -> dict:
    """The graph layer's bookkeeping: graphs captured and replayed so far,
    decode contexts, their static bytes and the shared pool's bytes. Then
    an eviction: a stream is held after its first packet, every context is
    dropped, a generate call re-captures its graphs and must give the codes
    it gave before, and the held stream (whose evicted context lives on)
    must finish with the codes of an uninterrupted stream."""
    from qwen3_tts_tpu_torch.runtime import graphs

    dev = model.device
    st = graphs.stats(dev)
    line("graphs", captures=st["captures"], replays=st["replays"], contexts=st["contexts"],
         context_graphs=st["graphs"], static_mib=f"{st['static_bytes'] / 2**20:.1f}",
         codec_graphs=st["codec_graphs"], codec_mib=f"{st['codec_bytes'] / 2**20:.1f}",
         pool_mib=f"{st['pool_bytes'] / 2**20:.1f}", max_contexts=graphs.MAX_CONTEXTS,
         max_graphs_per_context=graphs.MAX_GRAPHS_PER_CONTEXT,
         max_codec_graphs=graphs.MAX_CODEC_GRAPHS)
    specs = model._specs_custom_voice(TEXTS, "vivian", "english", None, True)
    kw = dict(max_new_tokens=MAX_NEW_TOKENS)
    first = frame_result(model, specs, **kw)
    with recorded_stream_codes() as chunks:
        held = _stream(model)
        next(held)
        graphs.clear(dev)
        c0 = graphs.stats(dev)["captures"]
        again = frame_result(model, specs, **kw)
        recaptured = graphs.stats(dev)["captures"] - c0
        for _ in held:
            pass
    if recaptured <= 0 or not _same_result(first, again):
        raise AssertionError(f"after the eviction: {recaptured} graphs re-captured, results "
                             f"equal {_same_result(first, again)}")
    if not torch.equal(torch.cat(chunks, dim=1), stream_codes):
        raise AssertionError("a stream held across the eviction lost its codes")
    line("graph eviction", recaptured=recaptured, codes_equal=True,
         held_stream_codes_equal=True)
    return st


def phase_warmup(model) -> float:
    """warmup_model over B in {1, 4} and prefill buckets {32, 64}: its
    seconds; then live calls of those shapes capture no graph."""
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs
    from qwen3_tts_tpu_torch.runtime.warmup import warmup_model

    dev = model.device
    graphs.clear(dev)
    before = graphs.stats(dev)
    secs = warmup_model(model, prefill_buckets=(32, 64), batch_sizes=(1, 4),
                        max_new_tokens=MAX_NEW_TOKENS, verbose=False)
    warm = graphs.stats(dev)
    buckets = []
    for texts in (TEXTS, TEXTS[:1]):
        specs = model._specs_custom_voice(texts, "vivian", "english", None, True)
        with torch.no_grad():
            buckets.append(assemble_prompt_specs(model.talker_params, model.config.talker_config,
                                                 model.config, specs, bucket=32)[0].shape[:2])
        model.generate_custom_voice(texts, speaker="vivian", language="english", seed=SEED,
                                    max_new_tokens=MAX_NEW_TOKENS)
    after = graphs.stats(dev)
    new = after["captures"] - warm["captures"]
    line("warmup", seconds=f"{secs:.2f}",
         graphs_captured=warm["captures"] - before["captures"], contexts=warm["contexts"], live_calls_BT=[tuple(b) for b in buckets],
         graphs_captured_after=new, graphs_replayed_after=after["replays"] - warm["replays"])
    if any(tuple(b) not in {(B, L) for B in (1, 4) for L in (32, 64)} for b in buckets):
        raise AssertionError(f"live call shapes {buckets} are not the warmed ones")
    if new:
        raise AssertionError(f"{new} graphs captured after the warm-up")
    return secs


def phase_http(model) -> dict:
    """The front door: ThreadedTTSServer over the model (its defaults:
    kernel 2, bf16 KV) behind `_HttpDemo` on a localhost port, driven with
    urllib from worker threads: 8 concurrent POST /tts and 4 POST
    /tts_stream, every response audio of whole frames, and all of it the
    frames the engine generated; then a stream closed after its first
    packet frees its slot. The engine route serves them all, not the static
    path."""
    import base64
    import io
    import socket
    import threading
    import urllib.request
    import wave

    from qwen3_tts_tpu_torch.cli.demo import _HttpDemo
    from qwen3_tts_tpu_torch.runtime.server import ThreadedTTSServer, TTSServer
    from qwen3_tts_tpu_torch.utils.metrics import MetricsRegistry

    frames = {}
    srv = ThreadedTTSServer(TTSServer(
        model, num_slots=SERVE_SLOTS, max_new_tokens=MAX_NEW_TOKENS, seed=SEED,
        metrics=MetricsRegistry(),
        code_sink=lambda rid, fr: frames.setdefault(rid, []).extend(fr)))
    demo = _HttpDemo(model, "custom_voice", {}, engine=srv)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    thread = threading.Thread(target=demo.serve, args=("127.0.0.1", port), daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{port}"
    try:
        for _ in range(100):
            try:
                urllib.request.urlopen(f"{url}/healthz", timeout=2).read()
                break
            except OSError:
                time.sleep(0.1)
        # one request first: the engine's graphs are captured outside the timing
        srv.synthesize("custom_voice", text=TEXTS[0], speaker="vivian", language="english")
        frames.clear()
        up = model.speech_tokenizer.get_decode_upsample_rate()
        got, pcm, errors = {}, {}, []

        def post(i, path):
            try:
                body = json.dumps({"task": "custom_voice", "speaker": "vivian",
                                   "language": "english",
                                   "text": f"{TEXTS[i % len(TEXTS)]} Over HTTP {i}."}).encode()
                req = urllib.request.Request(f"{url}{path}", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    data = r.read()
                if path == "/tts":
                    with wave.open(io.BytesIO(base64.b64decode(
                            json.loads(data)["wavs_b64"][0]))) as w:
                        got[(path, i)] = (w.getnframes(), w.getframerate())
                        pcm[(path, i)] = np.frombuffer(w.readframes(w.getnframes()), "<i2")
                else:
                    got[(path, i)] = (len(data) // 2, int(r.headers["X-Sample-Rate"]))
                    pcm[(path, i)] = np.frombuffer(data, "<i2")
            except Exception as e:
                errors.append((path, i, repr(e)))

        jobs = [(i, "/tts") for i in range(8)] + [(i, "/tts_stream") for i in range(4)]
        threads = [threading.Thread(target=post, args=job) for job in jobs]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        if errors or len(got) != len(jobs):
            raise AssertionError(f"HTTP requests failed: {errors}")
        samples = [n for n, _ in got.values()]
        if any(sr != 24000 or n <= 0 or n % up for n, sr in got.values()):
            raise AssertionError(f"HTTP audio not whole {up}-sample frames: {got}")
        engine_frames = sum(len(v) for v in frames.values())
        if len(frames) != len(jobs) or sum(samples) != engine_frames * up:
            raise AssertionError(f"HTTP audio {sum(samples)} samples vs {engine_frames} frames "
                                 f"the engine generated for {len(frames)} requests")
        # a stream closed after its first packet frees its slot
        gen = srv.synthesize_stream("custom_voice", text=TEXTS[1], speaker="vivian",
                                    language="english")
        next(gen)
        gen.close()
        deadline = time.time() + 60
        while srv.server.busy and time.time() < deadline:
            time.sleep(0.01)
        if srv.server.busy or srv.server.metrics.counters.get("server.cancels", 0) < 1:
            raise AssertionError("the closed stream did not free its slot")
        submits = srv.server.metrics.counters.get("server.submits", 0)
    finally:
        demo._server.shutdown()
        thread.join(timeout=30)
        srv.close()
    if demo.engine is not srv or submits < len(jobs) + 2:
        raise AssertionError(f"the engine route served {submits} requests")
    levels = audio_levels(*pcm.values())
    line("http front door", port=port, tts=8, tts_stream=4, wall_s=f"{wall:.3f}",
         requests_per_s=f"{len(jobs) / wall:.3f}", audio_frames=engine_frames,
         closed_stream_freed_slot=True, engine_submits=submits, **levels)
    unclamped("http front door", levels)
    return {"wall": wall}


def phase_probe(device) -> dict:
    """The bandwidth probes (csrc/dma_peak.cu): each kernel against its twin
    (PROBE_* cases), then `utils/dma_peak.py`'s sweep as the measurement
    path, its launches counted; no reading may pass PROBE_MAX_SHARE of the
    data-sheet rate. Returns the JSON numbers and the shaped probe's rate
    at the main path's layout (S_buf=256, strided)."""
    from qwen3_tts_tpu_torch.ops.cuda.dma_peak import (shaped_sum, shaped_sum_ref, stream_sum,
                                                       stream_sum_ref)
    from qwen3_tts_tpu_torch.utils import dma_peak as dp

    out = {"stream_err": 0.0, "shaped_err": 0.0, "shaped_rel": 0.0}
    rows, block_rows = dp.stream_shape(int(dp.DMA_GB * 1e9), 2)
    for n, br in PROBE_STREAM_CASES + [(rows, block_rows)]:
        x = dp.stream_input(n, device, SEED + 11)
        for P in (1, 3):
            got, want = stream_sum(x, P, br), stream_sum_ref(x, P)
            out["stream_err"] = max(out["stream_err"], max_abs(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"stream probe rows={n} block_rows={br} P={P}: max abs "
                                     f"err {max_abs(got, want)} (integer sums: want exact)")
        if n == rows:
            out["stream_plain_ms"] = cuda_ms(lambda: stream_sum_ref(x, 1), 3)
            out["stream_library_ms"] = cuda_ms(lambda: torch.sum(x, 0, dtype=torch.float32), 3)
        del x
        torch.cuda.empty_cache()
    for shape in PROBE_SHAPED_CASES:
        for contig in (False, True):
            w, k, v, s1, s2, nS = dp.shaped_inputs(**shape, contiguous_kv=contig,
                                                   device=device, seed=SEED + 12)
            for P in (1, 3):
                (got, side), (want, wside) = (
                    f(w, k, v, s1, s2, P, nS, contig) for f in (shaped_sum, shaped_sum_ref))
                rel = float(((got.double() - want.double()).abs()
                             / want.double().abs().clamp_min(1e-30)).max())
                out["shaped_err"] = max(out["shaped_err"], max_abs(got, want))
                out["shaped_rel"] = max(out["shaped_rel"], rel)
                if not (rel <= PROBE_REL_TOL and torch.equal(side, wside)):
                    raise AssertionError(
                        f"shaped probe {shape} contiguous_kv={contig} P={P}: max lane rel "
                        f"err {rel:.3g} (bar {PROBE_REL_TOL}), weight column sums exact: "
                        f"{torch.equal(side, wside)}")
            if shape == dict(S_buf=256) and not contig:
                out["shaped_plain_ms"] = cuda_ms(
                    lambda: shaped_sum_ref(w, k, v, s1, s2, 1, nS, contig), 3)
            del w, k, v, s1, s2
            torch.cuda.empty_cache()
    line("probe kernels vs twins", stream_cases=len(PROBE_STREAM_CASES) + 1,
         shaped_cases=2 * len(PROBE_SHAPED_CASES), passes=[1, 3],
         stream_max_abs_err=out["stream_err"], shaped_max_abs_err=f"{out['shaped_err']:.3g}",
         shaped_max_lane_rel_err=f"{out['shaped_rel']:.3g}", sideband="exact")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    readings = dp.sweep(device)
    launches = read_launches()
    peak_gbps = PEAK_BYTES_PER_S / 1e9
    for r in readings:
        print(f"  [probe sweep] {dp.describe(r)} = {r['gbps'] / peak_gbps:.4f} of "
              f"{peak_gbps:.0f} GB/s", flush=True)
    line("probe sweep", seconds=f"{time.time() - t0:.1f}", passes=f"{dp.P1}->{dp.P2}",
         reps=dp.REPS, launches=launches)
    too_fast = [r for r in readings if r["gbps"] > PROBE_MAX_SHARE * peak_gbps]
    if too_fast:
        raise AssertionError(f"readings above {PROBE_MAX_SHARE} of {peak_gbps} GB/s (an L2 "
                             f"hit or skipped bytes): {too_fast}")
    if min(launches["stream_bw"], launches["shaped_bw"]) <= 0:
        raise AssertionError(f"probe sweep launches {launches}")
    stream = max((r for r in readings if r["probe"] == "pure-stream"), key=lambda r: r["gbps"])
    shaped = next(r for r in readings if r["probe"] == "kernel-shaped"
                  and r["S_buf"] == 256 and r["kv"] == "strided")
    for key, r in (("stream", stream), ("shaped", shaped)):
        out[f"{key}_ms"] = r["bytes"] / (r["gbps"] * 1e9) * 1e3
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bound(r["bytes"])
    out.update(launches=launches, rate_gbps=shaped["gbps"])
    line("probe rows", stream_block_mb=stream["block_mb"],
         stream_ms_per_pass=f"{out['stream_ms']:.4f}",
         stream_plain_ms=f"{out['stream_plain_ms']:.3f}",
         stream_library_ms=f"{out['stream_library_ms']:.3f}",
         shaped_S256_strided_ms_per_pass=f"{out['shaped_ms']:.4f}",
         shaped_plain_ms=f"{out['shaped_plain_ms']:.3f}",
         achievable_gbps=f"{shaped['gbps']:.1f}")
    return out


def phase_roofline(cfg, cv, S_buf: int, probe: dict, kernels: list, sub: dict) -> None:
    """The custom-voice call against the card (`decode_roofline` at its B and
    window, the tick its wall over its frames, prefill and vocoder
    included), with the rate the shaped probe measured as the achievable
    one; each bytes-bound kernel's achievable floor (its bound's bytes at
    that rate) beside its data-sheet bound, the probes' own rows too; and
    the sub-talker's floor for the bytes its kernel streams (each layer
    weight at every position) beside the bound's (each once a frame)."""
    from qwen3_tts_tpu_torch.utils.roofline import decode_roofline

    rate = probe["rate_gbps"]
    ticks = max(cv["frames"])
    r = decode_roofline(cfg, len(TEXTS), attend_len=S_buf, tick_seconds=cv["wall"] / ticks,
                        peaks=PEAKS, achievable_gbps=rate)
    line("roofline custom voice", B=len(TEXTS), attend_len=S_buf, ticks=ticks,
         achievable_gbps=f"{rate:.1f}",
         **{k: f"{r[k]:.4g}" for k in ("tick_ms", "dma_floor_ms", "achievable_floor_ms",
                                       "mfu", "hbm_bw_util", "pct_of_dma_floor",
                                       "pct_of_achievable_floor")})
    for k in kernels:
        ach = (f"{k['bound_ms'] * PEAK_BYTES_PER_S / (rate * 1e9):.4f}"
               if k["bound_by"] == "bytes" else "n/a (bound by operations)")
        line("achievable floor", kernel=k["name"], ms=f"{k['ms']:.4f}",
             bound_ms=f"{k['bound_ms']:.4f}", bound_by=k["bound_by"], achievable_ms=ach)
    line("achievable floor, sub-talker as streamed", B=B_MAIN,
         streamed_gb=f"{sub['streamed_bytes'] / 1e9:.4f}",
         data_sheet_ms=f"{bound(sub['streamed_bytes'])[0]:.4f}",
         achievable_ms=f"{sub['streamed_bytes'] / (rate * 1e9) * 1e3:.4f}",
         ms=f"{sub['ms'][B_MAIN]:.4f}")


def phase_0b6(device) -> dict:
    """The 0.6B talker (`TALKER_0B6`, random int8 weights from the seed): at
    0.6B the talker's hidden size is the code predictor's, so kernel 1 runs
    without the small_to_mtp projection and kernel 2 at hidden 1024. Both
    against their twins at B_MAIN by the 1.7B bars, then
    generate_custom_voice of the smoke's texts through both kernels."""
    from qwen3_tts_tpu_torch.utils.testing import TALKER_0B6

    cfg = TALKER_0B6
    params = model_params(cfg, device)
    if params["code_predictor"]["proj"] is not None:
        raise AssertionError("0.6B: the code predictor should have no projection")
    sub = phase_subtalker(params, cfg, device, b_set=(B_MAIN,), label=" 0.6B")
    step = phase_talker_step(params, cfg, device, 256, b_set=(B_MAIN,), label=" 0.6B")
    cv = phase_slice(build_model(params, cfg, device, size="0b6"), label=" 0.6B")
    line("model 0.6B", hidden=cfg.hidden_size, has_proj=False, rtf=f"{cv['rtf']:.4f}",
         subtalker_ms_B8=f"{sub['ms'][B_MAIN]:.3f}", talker_step_ms_B8=f"{step['ms'][B_MAIN]:.3f}")
    return {"sub": sub, "step": step, "rtf": cv["rtf"]}


# ---------------------------------------------------------------------------
# Slice 8: the 25 Hz (V1) tokenizer and SFT (plain PyTorch; no kernel)
# ---------------------------------------------------------------------------

V1_DIR = "build/v1_tokenizer"
V1_MIN_CODE_MATCH = 0.98      # encoder codes, card against the host run of the same code
V1_NEAR_TIE_REL = 1e-4        # a mismatch must be a near-tie: squared-distance gap / distance
V1_MEL_TOL = 1e-4             # whisper log-mel (log10, floored), max abs
V1_REF_MEL_TOL = 1e-3         # reference mel, max abs: a natural log of |STFT| down to 1e-5
V1_XVEC_REL_TOL = 1e-4        # CAM++ x-vector, relative L2
V1_DIT_REL_TOL = 1e-4         # one DiT velocity evaluation, relative L2
V1_BIGVGAN_TOL = 1e-4         # BigVGAN on a short mel, max abs
V1_DIT_CODES = 24             # the host-side DiT evaluation: 24 codes (48 frames)
V1_BIGVGAN_FRAMES = 20
# BigVGAN's last conv in the smoke's V1 draw, scaled: the draw's DiT mel
# sits near the top of BigVGAN's dB range, and 85% of a 10 s clip's decoded
# samples sat at full scale on the H100 (`codec25 unscaled draw`), so the
# decode's checks would compare signs. The conv is linear with no bias: it
# scales the output before the clamp by exactly this factor (RMS 0.292 and
# no sample at full scale after it)
V1_POST_SCALE = 1 / 8
V1_ITERS = 3                   # timed calls per route of the 25 Hz programs
V1_LENGTHS = (2, 5, 9, 14, 20) # seconds: the clip lengths sent once, again, a third time
V1_GRAPH_MEL_REL = 1e-5        # the DiT mel after every step, graphed against eager (rel L2)
V1_GRAPH_WAV_TOL = 1e-5        # the decoded waveform graphed against eager (max abs)
V1_GRAPH_XVEC_REL = 1e-6       # the CAM++ x-vector graphed against eager (rel L2)
SFT_B, SFT_T, SFT_ACCUM, SFT_CYCLES = 2, 256, 2, 4
SFT_HOST_T = 64               # the 2-layer card-vs-host check's sequence length
SFT_LOSS_REL_TOL = 1e-5
SFT_GRAD_REL_TOL = 1e-3       # relative L2 per leaf, fp32 with TF32 off
SFT_DIR = "build/sft"
SFT_GRAPH_STEPS = 6           # mini-steps of the graphed-against-eager check (3 cycles)
SFT_BATCHES = 3               # batches of one shape taken in turn: a replay meets new inputs


def v1_config_json(cfg) -> dict:
    """A 25 Hz tokenizer's config.json from a CodecV1Config."""
    d = {k: getattr(cfg, k) for k in ("model_type", "input_sample_rate", "output_sample_rate",
                                      "decode_upsample_rate", "encode_downsample_rate")}
    d["encoder_config"] = dataclasses.asdict(cfg.encoder_config)
    d["decoder_config"] = {"dit_config": dataclasses.asdict(cfg.dit_config),
                           "bigvgan_config": dataclasses.asdict(cfg.bigvgan_config)}
    return d


def phase_codec25(device, cfg=None) -> dict:
    """The 25 Hz tokenizer at the released widths (CodecV1Config(),
    CAMPPlusConfig()), random weights from the fabricators written as a
    checkpoint directory under build/ and loaded through
    `Qwen3TTSTokenizer.from_pretrained` (the card by default): a 10 s 24 kHz
    clip encoded and decoded back (each timed after two warm-up calls, so
    that the graphed route replays, and in `graphs.eager()`), then
    every stage held to the same port code on the host in fp32, on the
    same 10 s clip (encoder, x-vector, reference mel) or a short input (one
    DiT velocity evaluation over V1_DIT_CODES codes, BigVGAN over
    V1_BIGVGAN_FRAMES mel frames)."""
    import os

    from qwen3_tts_tpu_torch.config import CodecV1Config
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.codec25 import bigvgan, dit, encoder
    from qwen3_tts_tpu_torch.models.codec25.campplus import CAMPPlusConfig
    from qwen3_tts_tpu_torch.models.codec25.mel import get_mel_audio
    from qwen3_tts_tpu_torch.models.codec25.model import XVectorExtractor
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.audio import resample
    from qwen3_tts_tpu_torch.utils.onnx_weights import write_onnx_initializers
    from qwen3_tts_tpu_torch.utils.testing import campplus_state, codec_v1_state
    from qwen3_tts_tpu_torch.weights import from_jax_tree, save_safetensors, unflatten_state_dict

    cfg = cfg or CodecV1Config()
    t0 = time.time()
    flat = codec_v1_state(cfg, SEED + 8)
    flat["decoder.bigvgan.conv_post.weight"] *= V1_POST_SCALE
    os.makedirs(V1_DIR, exist_ok=True)
    with open(os.path.join(V1_DIR, "config.json"), "w") as f:
        json.dump(v1_config_json(cfg), f)
    save_safetensors(os.path.join(V1_DIR, "model.safetensors"), flat)
    onnx_path = os.path.join(V1_DIR, "campplus.onnx")
    write_onnx_initializers(onnx_path, campplus_state(CAMPPlusConfig(), SEED + 9))
    write_s = time.time() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.time()
    tok = Qwen3TTSTokenizer.from_pretrained(V1_DIR, device=device)
    load_s = time.time() - t0
    if tok.v1_model is None or tok.v1_model.device.type != device.type:
        raise AssertionError(f"the 25 Hz tokenizer did not load onto {device}")
    weights_gib = (torch.cuda.memory_allocated() - base_mem) / 2**30

    clip = reference_clip(24000)
    routes = {}
    for route in ("eager", "graph"):   # the graphed calls timed after their captures
        with graphs.eager() if route == "eager" else contextlib.nullcontext():
            for _ in range(2):
                enc = tok.encode((clip, 24000))
            torch.cuda.synchronize()
            t0 = time.time()
            enc = tok.encode((clip, 24000))
            encode_s = time.time() - t0
            for _ in range(2):
                tok.decode(enc)
            t0 = time.time()
            wavs, sr = tok.decode(enc)
            routes[route] = (encode_s, time.time() - t0)
    encode_s, decode_s = routes["graph"]
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30   # the tokenizer's own
    n = len(enc.audio_codes[0])
    dcfg, bcfg = cfg.dit_config, cfg.bigvgan_config
    card = tok.v1_model.params
    with torch.no_grad():   # the decode's two stages apart, on its inputs
        ins = [torch.as_tensor(x[None], device=device)
               for x in (enc.audio_codes[0], enc.xvectors[0], enc.ref_mels[0])]
        noise = torch.randn((1, n * dcfg.repeats, dcfg.mel_dim), device=device,
                            generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        t0 = time.time()
        mel = dit.dit_sample(card["decoder"]["dit"], dcfg, *ins, noise)
        torch.cuda.synchronize()
        dit_s = time.time() - t0
        bigvgan.bigvgan_forward(card["decoder"]["bigvgan"], bcfg, mel)
        torch.cuda.synchronize()
        bigvgan_s = time.time() - t0 - dit_s
        # why the draw is scaled: its own last conv on the same mel
        big = card["decoder"]["bigvgan"]
        unscaled = audio_levels(bigvgan.bigvgan_forward(
            dict(big, conv_post={"weight": big["conv_post"]["weight"] / V1_POST_SCALE}), bcfg,
            mel))
    up = dcfg.repeats * int(np.prod(bcfg.upsample_rates))
    wav = wavs[0]
    if sr != cfg.output_sample_rate or wav.shape != (n * up,) or not np.isfinite(wav).all():
        raise AssertionError(f"decode: sr {sr}, shape {wav.shape} for {n} codes")
    if n != CLONE_REF_SECONDS * 25:
        raise AssertionError(f"{n} codes for a {CLONE_REF_SECONDS} s clip at 25 Hz")
    audio_s = wav.shape[0] / sr

    # every stage against the same code on the host, fp32 (TF32 is off)
    host = from_jax_tree(unflatten_state_dict(flat))
    ecfg = cfg.encoder_config
    wav16 = resample(clip, 24000, 16000)
    with torch.no_grad():
        mels = {d: get_mel_audio(wav16, padding=True, audio_vq_ds_rate=ecfg.audio_vq_ds_rate,
                                 n_mels=ecfg.n_mels, device=d) for d in (device, "cpu")}
        mel_err = max_abs(mels[device].cpu(), mels["cpu"])
        codes_card = encoder.encode_mel_to_codes(card["encoder"]["tokenizer"], ecfg,
                                                 mels[device]).cpu()
        x_host = encoder.vq_features(host["encoder"]["tokenizer"], ecfg, mels["cpu"])
        d_host = encoder.code_distances(host["encoder"]["tokenizer"], x_host)
    codes_host = d_host.argmin(dim=-1)
    if not np.array_equal(enc.audio_codes[0], codes_card[:n].numpy()):
        raise AssertionError("the tokenizer's codes are not its encoder's")
    miss = (codes_card != codes_host).nonzero()[:, 0]
    rows = torch.arange(len(codes_host))
    sq = (x_host.float() ** 2).sum(-1) + d_host[rows, codes_host]   # the host's squared distance
    gaps = (d_host[miss, codes_card[miss]] - d_host[miss, codes_host[miss]]) / sq[miss]
    match = 1.0 - len(miss) / len(codes_host)
    worst_gap = float(gaps.max()) if len(miss) else 0.0
    xv_host, rm_host = XVectorExtractor(onnx_path, device="cpu").extract_code(wav16)
    xv_err = rel_err(torch.from_numpy(enc.xvectors[0]), torch.from_numpy(xv_host))
    rm_err = max_abs(torch.from_numpy(enc.ref_mels[0]), torch.from_numpy(rm_host))

    rng = np.random.default_rng(SEED + 10)
    T = V1_DIT_CODES * dcfg.repeats
    table = host["decoder"]["dit"]["text_embed"]["codec_embed"]["weight"]
    code = table[torch.as_tensor(enc.audio_codes[0][:V1_DIT_CODES])].repeat_interleave(
        dcfg.repeats, dim=0)
    ins = [torch.from_numpy(rng.standard_normal((2, T, dcfg.mel_dim), dtype=np.float32)),
           torch.from_numpy(np.stack([enc.xvectors[0]] * 2))[:, None].expand(2, T, -1),
           torch.from_numpy(np.stack([enc.ref_mels[0], rm_host])),
           torch.stack([code, torch.zeros_like(code)]),
           torch.tensor([0.3, 0.3])]
    mel_in = torch.from_numpy(rng.normal(-5, 1.5, (1, bcfg.mel_dim, V1_BIGVGAN_FRAMES))
                              .astype(np.float32))
    with torch.no_grad():
        v_card = dit.dit_forward(card["decoder"]["dit"], dcfg, *(t.to(device) for t in ins))
        v_host = dit.dit_forward(host["decoder"]["dit"], dcfg, *ins)
        w_card = bigvgan.bigvgan_forward(card["decoder"]["bigvgan"], bcfg, mel_in.to(device))
        w_host = bigvgan.bigvgan_forward(host["decoder"]["bigvgan"], bcfg, mel_in)
    dit_err = rel_err(v_card.cpu(), v_host)
    big_err = max_abs(w_card.cpu(), w_host)
    errs = dict(mel=(mel_err, V1_MEL_TOL), xvector=(xv_err, V1_XVEC_REL_TOL),
                ref_mel=(rm_err, V1_REF_MEL_TOL), dit=(dit_err, V1_DIT_REL_TOL),
                bigvgan=(big_err, V1_BIGVGAN_TOL))
    out = dict(encode_s=encode_s, decode_s=decode_s, rtf=decode_s / audio_s, peak_gib=peak_gib,
               tokenizer=tok)
    levels = {k: audio_levels(w) for k, w in (("decode", wav), ("bigvgan", w_card))}
    line("codec25 unscaled draw", conv_post_scale=1.0, **unscaled,
         smoke_scale=V1_POST_SCALE)
    line("codec25", widths="released" if cfg == CodecV1Config() else "cut", codes=n, audio_s=f"{audio_s:.2f}",
         write_s=f"{write_s:.1f}", load_s=f"{load_s:.1f}", weights_gib=f"{weights_gib:.2f}",
         encode_s=f"{encode_s:.4f}", encode_eager_s=f"{routes['eager'][0]:.4f}",
         decode_s=f"{decode_s:.4f}", decode_eager_s=f"{routes['eager'][1]:.4f}",
         dit_s=f"{dit_s:.4f}",
         bigvgan_s=f"{bigvgan_s:.4f}", decode_rtf=f"{out['rtf']:.4f}", peak_gib=f"{peak_gib:.2f}", host_clip_s=CLONE_REF_SECONDS,
         code_match=f"{match:.4f}", mismatches=len(miss), worst_gap=f"{worst_gap:.2e}",
         mel_err=f"{mel_err:.2e}", xvector_rel=f"{xv_err:.2e}", ref_mel_err=f"{rm_err:.2e}",
         dit_rel=f"{dit_err:.2e}", dit_codes=V1_DIT_CODES, bigvgan_err=f"{big_err:.2e}",
         bigvgan_frames=V1_BIGVGAN_FRAMES,
         **{f"{k}_{f}": v for k, lv in levels.items() for f, v in lv.items()})
    for k, lv in levels.items():
        unclamped(f"codec25 {k}", lv)
    bad = {k: v for k, v in errs.items() if not v[0] <= v[1]}
    if bad:
        raise AssertionError(f"25 Hz stages off the host run: {bad}")
    if match < V1_MIN_CODE_MATCH or worst_gap > V1_NEAR_TIE_REL:
        raise AssertionError(f"encoder codes: {match:.4f} equal, worst mismatch gap {worst_gap}")
    return out


def _v1_inputs(tok, clip: np.ndarray) -> dict:
    """The inputs of the 25 Hz tokenizer's four programs for a 24 kHz clip,
    as its encode and decode make them: the Whisper mel, the CAM++ fbank
    (on the host), then, from the encode's output, the codes, x-vector and
    reference mel and the sampler's noise (seeded 0, as decode draws it)."""
    from qwen3_tts_tpu_torch.models.codec25.mel import get_mel_audio
    from qwen3_tts_tpu_torch.utils.audio import resample
    from qwen3_tts_tpu_torch.utils.kaldi import fbank

    m = tok.v1_model
    dev, ecfg, dcfg = m.device, m.config.encoder_config, m.config.dit_config
    wav16 = resample(clip, 24000, 16000)
    norm = m.xvector_extractor._peak_norm(wav16)
    feat = fbank(norm, num_mel_bins=m.xvector_extractor.cfg.feat_dim)
    enc = tok.encode((clip, 24000))
    n = len(enc.audio_codes[0])
    return dict(
        mel=get_mel_audio(wav16, padding=True, audio_vq_ds_rate=ecfg.audio_vq_ds_rate,
                          n_mels=ecfg.n_mels, device=dev),
        feats=torch.from_numpy((feat - feat.mean(axis=0, keepdims=True))[None]),
        codes=torch.as_tensor(enc.audio_codes[0][None], device=dev),
        xv=torch.as_tensor(enc.xvectors[0][None], device=dev),
        ref=torch.as_tensor(enc.ref_mels[0][None], device=dev),
        noise=torch.randn((1, n * dcfg.repeats, dcfg.mel_dim), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(0)))


def _rss_mib() -> float:
    """This process's resident host memory (VmRSS), MiB."""
    with open("/proc/self/status") as f:
        kb = next(int(x.split()[1]) for x in f if x.startswith("VmRSS:"))
    return kb / 1024


def _captured(fn):
    """fn captured once as a CUDA graph over the tensors it closes over (a
    warm call on a side stream first): (the graph, its output, the
    capture's host wall ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = fn()
    torch.cuda.synchronize()
    return g, out, 1e3 * (time.perf_counter() - t0)


def phase_v1_graphs(tok) -> dict:
    """The 25 Hz tokenizer's four programs (`runtime/graphs.py`): the DiT
    sampler's step (`StepGraphs`, captured at a key's DIT_CAPTURE_CALL-th
    call) and CAM++ (`FrontGraphs`, at its second) as captured graphs
    against their eager runs in `graphs.eager()`, on `phase_codec25`'s
    tokenizer (released widths); BigVGAN and the Whisper-VQ encode, which
    run eagerly, each captured once here to show that they copy nothing
    from the host (a replay equal to the eager call). After
    `graphs.clear`, for the 10 s clip: host wall ms of each graphed
    program at its key's first call, second call, a replay and eager
    (medians of V1_ITERS), with a replay equal to the second call; the DiT
    mel within V1_GRAPH_MEL_REL of eager, the x-vector within
    V1_GRAPH_XVEC_REL; BigVGAN's and the encode's eager ms, capture ms and
    replay ms. The DiT's capture rule on new lengths of ~10 s (246-249
    codes), the rules in turn 2, 1, 2, 1: each length's first and second
    call, so that a cold eager call stands beside a cold capture. The
    tokenizer's encode and decode graphed against eager (codes and
    reference mel equal, x-vector within V1_GRAPH_XVEC_REL, waveform within
    V1_GRAPH_WAV_TOL, PCM16 equal; both routes decode the graphed encode's
    output) on that clip and on another 10 s clip (the first reversed),
    neither of which may capture anything; the decode's wall graphed and
    eager, and the DiT's share of the graphed one; then V1_LENGTHS clip
    lengths encoded and decoded once, again, a third time and eagerly:
    captures, graphs and static bytes a program, pool bytes and host RSS
    after each round."""
    from qwen3_tts_tpu_torch.models.codec25 import bigvgan, dit, encoder
    from qwen3_tts_tpu_torch.models.codec25.campplus import campplus_embed
    from qwen3_tts_tpu_torch.runtime import graphs

    m = tok.v1_model
    dev, cfg, p = m.device, m.config, m.params
    dcfg = cfg.dit_config
    rule = graphs.DIT_CAPTURE_CALL
    clip = reference_clip(24000)
    graphs.clear(dev)   # the 10 s keys start unseen: phase_codec25 met them
    with graphs.eager():
        x = _v1_inputs(tok, clip)

    def sample(n=None, codes=x["codes"], noise=x["noise"]):
        n = n or codes.shape[1]
        return dit.dit_sample(p["decoder"]["dit"], dcfg, codes[:, :n], x["xv"], x["ref"],
                              noise[:, :n * dcfg.repeats])

    graphed = {
        "campplus": (lambda: campplus_embed(m.xvector_extractor.params,
                                            m.xvector_extractor.cfg, x["feats"]), (0, 1, 0)),
        "dit": (sample, (0, 1, 0) if rule == 2 else (1, 0, 0)),
    }
    eager = {
        "encode": lambda: encoder.encode_mel_to_codes(p["encoder"]["tokenizer"],
                                                      cfg.encoder_config, x["mel"]),
        "bigvgan": lambda: bigvgan.bigvgan_forward(p["decoder"]["bigvgan"], cfg.bigvgan_config,
                                                   outs["dit", "eager"]),
    }

    def captures():
        return graphs.stats(dev)["captures"]

    res, outs = {}, {}
    with torch.no_grad():
        for name, (fn, want) in graphed.items():
            c0 = captures()
            first, _ = wall_ms(fn, 1)
            c1 = captures()
            second, outs[name, "graph"] = wall_ms(fn, 1)
            c2 = captures()
            replay, again = wall_ms(fn, V1_ITERS)
            with graphs.eager():
                eager_ms, outs[name, "eager"] = wall_ms(fn, V1_ITERS)
            if (c1 - c0, c2 - c1, captures() - c2) != want:
                raise AssertionError(f"25 Hz {name}: captures {c1 - c0}, {c2 - c1}, "
                                     f"{captures() - c2} at a key's first, second and later "
                                     f"calls (want {want})")
            drift = max_abs(again, outs[name, "graph"])
            if drift:
                raise AssertionError(f"25 Hz {name}: a replay differs from its second call "
                                     f"by {drift}")
            res[name] = dict(first_ms=first, second_ms=second, replay_ms=replay,
                             eager_ms=eager_ms, replay_drift=drift)
        for name, fn in eager.items():
            c0 = captures()
            eager_ms, outs[name, "eager"] = wall_ms(fn, V1_ITERS)
            g, out, capture_ms = _captured(fn)
            replay, _ = wall_ms(g.replay, V1_ITERS)
            if captures() != c0:
                raise AssertionError(f"25 Hz {name}: the graph layer captured {name}")
            drift = max_abs(out, outs[name, "eager"])
            if drift:
                raise AssertionError(f"25 Hz {name}: its captured replay differs from the eager "
                                     f"call by {drift}")
            res[name] = dict(eager_ms=eager_ms, capture_ms=capture_ms, replay_ms=replay,
                             replay_drift=drift)
            del g, out
        # the DiT's capture rule: a cold eager call beside a cold capture
        rules = {1: [], 2: []}
        for r, n in ((2, 246), (1, 247), (2, 248), (1, 249)):
            graphs.DIT_CAPTURE_CALL = r
            try:
                c0 = captures()
                calls = [wall_ms(lambda: sample(n), 1) for _ in range(2)]
            finally:
                graphs.DIT_CAPTURE_CALL = rule
            got = captures() - c0
            if got != 1 or not all(torch.isfinite(o).all() for _, o in calls):
                raise AssertionError(f"25 Hz DiT rule {r} at {n} codes: {got} captures")
            rules[r].append((calls[0][0], calls[1][0]))
    dit_rel = rel_err(outs["dit", "graph"], outs["dit", "eager"])
    xv_rel = rel_err(outs["campplus", "graph"], outs["campplus", "eager"])
    rule_ms = {f"dit_rule{r}_{k}_ms": [f"{c[i]:.2f}" for c in v]
               for r, v in rules.items() for i, k in enumerate(("first", "second"))}
    rule_sum = {r: float(np.mean([a + b for a, b in v])) for r, v in rules.items()}

    # the tokenizer's routes, on the clip its graphs were captured on and a
    # clip they never saw; both routes decode the graphed encode's output
    ends = {}
    for name, c in (("seen", clip), ("unseen", clip[::-1].copy())):
        before = captures()
        got, enc = {}, None
        for route in ("graph", "eager"):
            with graphs.eager() if route == "eager" else contextlib.nullcontext():
                mine = tok.encode((c, 24000))
                enc = enc or mine
                wall, (wav, _) = wall_ms(lambda: tok.decode(enc), V1_ITERS)
                pcm, _ = tok.decode(enc, output_dtype="int16")
            got[route] = (mine, wav[0], pcm[0], wall)
        (ge, gw, gp, gwall), (ee, ew, ep, ewall) = got["graph"], got["eager"]
        ends[name] = dict(
            captures=captures() - before, decode_ms=gwall, decode_eager_ms=ewall,
            codes_equal=np.array_equal(ge.audio_codes[0], ee.audio_codes[0]),
            xvector_rel=rel_err(torch.from_numpy(ge.xvectors[0]),
                                torch.from_numpy(ee.xvectors[0])),
            ref_mel_equal=np.array_equal(ge.ref_mels[0], ee.ref_mels[0]),
            wav_max_abs=float(np.abs(gw - ew).max()), pcm16_equal=np.array_equal(gp, ep),
            **audio_levels(gw))
    dit_share = res["dit"]["replay_ms"] / ends["seen"]["decode_ms"]

    # clip lengths sent once, again, a third time, then eagerly
    graphs.clear(dev)
    gc.collect()
    torch.cuda.empty_cache()
    rounds = []
    long_clip = np.tile(clip, -(-max(V1_LENGTHS) // CLONE_REF_SECONDS))
    for r in ("once", "again", "third", "eager"):
        before, t0 = captures(), time.perf_counter()
        with graphs.eager() if r == "eager" else contextlib.nullcontext():
            for sec in V1_LENGTHS:
                tok.decode(tok.encode((long_clip[:sec * 24000 + 77], 24000)))
        torch.cuda.synchronize()
        st = graphs.stats(dev)
        rounds.append(dict(round=r, wall_s=f"{time.perf_counter() - t0:.3f}",
                           captures=captures() - before,
                           **{k: st[f"{k}_graphs"] for k in graphs.V1_PROGRAMS},
                           **{f"{k}_mib": f"{st[k + '_bytes'] / 2**20:.2f}"
                              for k in graphs.V1_PROGRAMS},
                           pool_mib=f"{st['pool_bytes'] / 2**20:.1f}",
                           rss_mib=f"{_rss_mib():.0f}"))
    line("v1_graphs", card=card(), clip_s=CLONE_REF_SECONDS,
         **{f"{n}_{k}": f"{v:.3g}" if k == "replay_drift" else f"{v:.2f}"
            for n, r in res.items() for k, v in r.items()},
         dit_mel_rel=f"{dit_rel:.3g}", xvector_rel=f"{xv_rel:.3g}", dit_capture_call=rule,
         **rule_ms, **{f"dit_rule{r}_two_calls_ms": f"{v:.2f}" for r, v in rule_sum.items()},
         **{f"{name}_{k}": (f"{v:.4g}" if isinstance(v, float) else v)
            for name, e in ends.items() for k, v in e.items()},
         decode_dit_share=f"{dit_share:.3f}", lengths_s=list(V1_LENGTHS))
    for r in rounds:
        line("v1_graphs lengths", **r)
    bad = [f"{name}: {k}" for name, e in ends.items() for k, ok in (
        ("codes", e["codes_equal"]), ("x-vector", e["xvector_rel"] <= V1_GRAPH_XVEC_REL),
        ("reference mel", e["ref_mel_equal"]), ("waveform", e["wav_max_abs"] <= V1_GRAPH_WAV_TOL),
        ("PCM16", e["pcm16_equal"])) if not ok]
    bad += [f"{name}: {e['captures']} captures" for name, e in ends.items() if e["captures"]]
    bad += [f"{name}: {e['full_scale_share']} of the samples at full scale"
            for name, e in ends.items() if e["full_scale_share"] > MAX_FULL_SCALE_SHARE]
    if not dit_rel <= V1_GRAPH_MEL_REL or not xv_rel <= V1_GRAPH_XVEC_REL:
        bad.append(f"programs: DiT mel {dit_rel}, x-vector {xv_rel}")
    n = len(V1_LENGTHS)   # the DiT's and CAM++'s keys
    want = [n * (rule == 1), n + n * (rule == 2), 0, 0]
    if [r["captures"] for r in rounds] != want:
        bad.append(f"captures by round {[r['captures'] for r in rounds]} (want {want})")
    if bad:
        raise AssertionError(f"25 Hz graphs against eager: {bad}")
    del tok, m, p, graphed, eager, outs, x
    graphs.clear(dev)   # the V1 graphs hold the tokenizer's weights
    gc.collect()
    torch.cuda.empty_cache()
    return dict(res, ends=ends, rounds=rounds)


def sft_batch(tts_cfg, rng, T: int, B: int, ref_mel) -> dict:
    """A collated SFT batch of B rows whose text and codes fill T - 8
    positions, all sharing one reference mel (1, frames, mel)."""
    from qwen3_tts_tpu_torch.finetune.data import TTSDataset

    text = (T - 8) // 5
    items = [{"text_ids": rng.integers(3, 1000, (1, text)),
              "audio_codes": rng.integers(0, 2048, (T - 8 - text, 16)),
              "ref_mel": ref_mel} for _ in range(B)]
    batch = TTSDataset([], None, tts_cfg, num_code_groups=16).collate(items, pad_to_multiple=64)
    if batch["input_ids"].shape[1] != T:
        raise AssertionError(f"batch length {batch['input_ids'].shape[1]} != {T}")
    return batch


def phase_sft(device, cfg=None, cfg_main=None) -> dict:
    """SFT on the card, three parts:
    1. four optimizer cycles of `make_train_step` at TALKER_1B7 in bf16 with
       the speaker encoder (B=SFT_B, T=SFT_T, grad_accum SFT_ACCUM): the
       loss finite, the params and the AdamW states moved, a state for
       every leaf (a leaf the loss does not reach gets a zero gradient, as
       jax.grad gives it); ms per cycle (after the first), tokens/s, peak;
    2. TALKER_1B7's widths at 2 layers (talker and code predictor) in fp32,
       TF32 off: the loss and every leaf's gradient on the card against the
       same code on the host (T=SFT_HOST_T);
    3. `sft.main` end to end at TALKER_0B6 on a base checkpoint directory
       written under build/ (bf16, with the speaker encoder): the epoch
       checkpoint reloads as an int8 custom-voice model whose new speaker
       row is the speaker encoder's x-vector, and speaks one line."""
    import os

    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.finetune import sft, train
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.models.speaker_encoder import speaker_encoder_forward
    from qwen3_tts_tpu_torch.ops.stft import mel_spectrogram
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.audio import load_audio, write_wav
    from qwen3_tts_tpu_torch.utils.testing import (TALKER_0B6, TALKER_1B7, random_talker_params,
                                                   speaker_encoder_state)
    from qwen3_tts_tpu_torch.weights import (flatten_state_dict, from_jax_tree, map_tensors,
                                             save_safetensors, talker_params_to_state_dict)

    cfg, cfg_main = cfg or TALKER_1B7, cfg_main or TALKER_0B6
    rng = np.random.default_rng(SEED + 11)
    os.makedirs(SFT_DIR, exist_ok=True)
    ref_path = os.path.join(SFT_DIR, "ref.wav")
    write_wav(ref_path, reference_clip(24000)[:3 * 24000], 24000)
    # the reference mel as the SFT dataset computes it (from the WAV file)
    ref_mel = mel_spectrogram(torch.from_numpy(load_audio(ref_path)[0][None]), n_fft=1024,
                              num_mels=128, sampling_rate=24000, hop_size=256, win_size=1024,
                              fmin=0, fmax=12000).permute(0, 2, 1).numpy()

    # 1. four optimizer cycles at 1.7B, bf16
    spk_cfg = SpeakerEncoderConfig(enc_dim=cfg.hidden_size)
    tts_cfg = TTSModelConfig(talker_config=cfg, speaker_encoder_config=spk_cfg)
    spk_params = map_tensors(from_jax_tree(speaker_encoder_state(spk_cfg, SEED + 12), device),
                             lambda t: t.to(torch.bfloat16))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    params = train.trainable(random_talker_params(
        cfg, torch.Generator(device=device).manual_seed(SEED + 13), dtype=torch.bfloat16))
    opt = train.default_optimizer(params, lr=2e-5, grad_accum=SFT_ACCUM)
    step = train.make_train_step(cfg, opt)
    watch = {k: v.detach().clone() for k, v in flatten_state_dict(params).items()
             if k in ("codec_head", "layers.mlp.down_proj.weight",
                      "code_predictor.lm_heads", "text_embedding")}
    T = SFT_T
    # SFT_BATCHES batches taken in turn: each replay meets a batch its
    # graph's capture did not see
    batches = [sft_batch(tts_cfg, rng, T, SFT_B, ref_mel) for _ in range(SFT_BATCHES)]

    def cycles():
        """SFT_CYCLES optimizer cycles: (losses, ms per cycle, the device's
        capture count after the first cycle)."""
        losses, cycle_ms, first = [], [], None
        for cycle in range(SFT_CYCLES):
            torch.cuda.synchronize()
            t0 = time.time()
            for i in range(SFT_ACCUM):
                b = batches[(cycle * SFT_ACCUM + i) % SFT_BATCHES]
                tb = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
                with torch.no_grad():
                    spk = speaker_encoder_forward(spk_params, spk_cfg,
                                                  tb.pop("ref_mels").to(torch.bfloat16))
                m = step(params, tb, spk)
                losses.append(float(m["loss"]))
            if not m["updated"]:
                raise AssertionError("a cycle of grad_accum steps did not update")
            torch.cuda.synchronize()
            cycle_ms.append(1e3 * (time.time() - t0))
            if first is None:
                first = graphs.stats(device)["captures"]
        return losses, cycle_ms, first

    # the default route (each mini-step one replay after its key's first
    # call), then the same params and optimizer inside graphs.eager()
    captures0 = graphs.stats(device)["captures"]
    losses, cycle_ms, captures1 = cycles()
    late_captures = graphs.stats(device)["captures"] - captures1
    pool = graphs.stats(device)["pool_bytes"]
    peak_gib = (torch.cuda.max_memory_allocated() - base_mem) / 2**30   # the training's own
    if not np.isfinite(losses).all():
        raise AssertionError(f"SFT losses {losses}")
    # one graph per phase (fold, fold + update) of the one (B, T)
    if captures1 - captures0 != min(SFT_ACCUM, 2) or late_captures:
        raise AssertionError(f"SFT graphs: {captures1 - captures0} captures in the first "
                             f"cycle, {late_captures} after it")
    flat = flatten_state_dict(params)
    moved = {k: bool((flat[k].detach() != v).any()) for k, v in watch.items()}
    states = opt.adamw.state
    if len(states) != len(opt.leaves) or not all(moved.values()):
        raise AssertionError(f"SFT: {len(states)} AdamW states for {len(opt.leaves)} leaves, "
                             f"moved {moved}")
    if (any(int(s["step"]) != SFT_CYCLES for s in states.values())
            or not all(states[flat[k]]["exp_avg_sq"].any() for k in watch)):
        raise AssertionError("an AdamW state did not advance")
    ms = float(np.mean(cycle_ms[1:]))
    tokens = SFT_B * T * SFT_ACCUM
    with graphs.eager():
        eager_losses, eager_cycle_ms, _ = cycles()
    if not np.isfinite(eager_losses).all() or graphs.stats(device)["captures"] != captures1:
        raise AssertionError(f"SFT eager cycles: losses {eager_losses}")
    eager_ms = float(np.mean(eager_cycle_ms[1:]))
    line("sft_graphs", model="1.7B" if cfg == TALKER_1B7 else "cut", dtype="bf16", B=SFT_B,
         T=T, grad_accum=SFT_ACCUM, ms_per_cycle_graph=f"{ms:.1f}",
         ms_per_cycle_eager=f"{eager_ms:.1f}",
         tokens_per_s_graph=f"{tokens / ms * 1e3:.0f}",
         tokens_per_s_eager=f"{tokens / eager_ms * 1e3:.0f}",
         cycles_ms_graph=[f"{x:.1f}" for x in cycle_ms],
         cycles_ms_eager=[f"{x:.1f}" for x in eager_cycle_ms],
         first_cycle_captures=captures1 - captures0, later_captures=late_captures,
         pool_mib=f"{pool / 2**20:.1f}", peak_gib=f"{peak_gib:.2f}")
    # where a cycle goes: one mini-step's forward + backward, one update
    tb = {k: torch.as_tensor(v, device=device) for k, v in batches[0].items()}
    with torch.no_grad():
        spk = speaker_encoder_forward(spk_params, spk_cfg, tb.pop("ref_mels").to(torch.bfloat16))
    torch.cuda.synchronize()
    t0 = time.time()
    train.sft_loss(params, cfg, tb, spk)[0].backward()
    torch.cuda.synchronize()
    fwd_bwd_ms = 1e3 * (time.time() - t0)
    grads = [p.grad for p in opt.leaves]
    for p in opt.leaves:
        p.grad = None
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(opt.leaves, grads)]
    opt.accumulate(grads)
    torch.cuda.synchronize()
    t0 = time.time()
    opt.accumulate(grads)
    torch.cuda.synchronize()
    update_ms = 1e3 * (time.time() - t0)
    del params, opt, step, watch, states, flat, grads
    graphs.clear()   # the pool's ~20 GB go back once no graph is left
    gc.collect()
    torch.cuda.empty_cache()

    # 2. full widths at 2 layers, fp32: the card against the host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2, code_predictor_config=dataclasses.replace(
        cfg.code_predictor_config, num_hidden_layers=2))
    host = random_talker_params(cfg2, torch.Generator().manual_seed(SEED + 14),
                                dtype=torch.float32)
    b = sft_batch(TTSModelConfig(talker_config=cfg2), rng, SFT_HOST_T, SFT_B, ref_mel)
    b.pop("ref_mels")
    spk = torch.from_numpy(rng.normal(0, 0.05, (SFT_B, cfg.hidden_size)).astype(np.float32))
    res = {}
    for name, dev in (("card", device), ("host", torch.device("cpu"))):
        p = train.trainable(map_tensors(host, lambda t: t.to(dev)))
        loss, _ = train.sft_loss(p, cfg2, {k: torch.as_tensor(v, device=dev)
                                           for k, v in b.items()}, spk.to(dev))
        loss.backward()
        res[name] = (float(loss.detach()), {k: v.grad.cpu() for k, v in
                                            flatten_state_dict(p).items()
                                            if v is not None and v.grad is not None})
        del p
    loss_rel = abs(res["card"][0] - res["host"][0]) / abs(res["host"][0])
    if set(res["card"][1]) != set(res["host"][1]):
        raise AssertionError("card and host gradients differ in their leaves")
    grad_rel = {k: rel_err(res["card"][1][k], g) for k, g in res["host"][1].items() if g.any()}
    worst = max(grad_rel, key=grad_rel.get)
    if loss_rel > SFT_LOSS_REL_TOL or grad_rel[worst] > SFT_GRAD_REL_TOL:
        raise AssertionError(f"SFT card vs host: loss rel {loss_rel}, {worst} {grad_rel[worst]}")
    del host, res
    torch.cuda.empty_cache()

    # 3. sft.main end to end at 0.6B
    base = os.path.join(SFT_DIR, "base")
    os.makedirs(base, exist_ok=True)
    spk06 = SpeakerEncoderConfig(enc_dim=cfg_main.hidden_size)
    cfg06 = TTSModelConfig(talker_config=dataclasses.replace(
        cfg_main, codec_language_id={"english": 1000}), speaker_encoder_config=spk06,
        tts_model_type="base", tts_model_size="0b6")
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg06), f)
    sd = talker_params_to_state_dict(random_talker_params(
        cfg_main, torch.Generator(device=device).manual_seed(SEED + 15)), cfg_main)
    spk_state = speaker_encoder_state(spk06, SEED + 16)
    sd.update(flatten_state_dict(spk_state, "speaker_encoder"))
    save_safetensors(os.path.join(base, "model.safetensors"), sd)
    del sd
    with open(os.path.join(SFT_DIR, "train.jsonl"), "w") as f:
        for i in range(4):
            f.write(json.dumps({"text": f"{TEXTS[i % len(TEXTS)]} {i}",
                                "audio_codes": rng.integers(0, 2048, (60 + 10 * i, 16)).tolist(),
                                "ref_audio": ref_path}) + "\n")
    out = os.path.join(SFT_DIR, "out")
    t0 = time.time()
    sft.main(["--init_model_path", base, "--train_jsonl", os.path.join(SFT_DIR, "train.jsonl"),
              "--output_model_path", out, "--batch_size", "2", "--grad_accum", "2",
              "--num_epochs", "1", "--speaker_name", "smoke_voice", "--speaker_row", "3000",
              "--device", str(device)],
             processor=StandInTokenizer(max_ids=None))
    main_s = time.time() - t0
    # the epoch checkpoint has no speech_tokenizer/: the smoke's vocoder speaks
    model = Qwen3TTSModel.from_pretrained(os.path.join(out, "checkpoint-epoch-0"),
                                          quantize="int8", device=device)
    model.speech_tokenizer, model.processor = smoke_vocoder(device), StandInTokenizer()
    if model.get_supported_speakers() != ["smoke_voice"] or model.tts_model_type != "custom_voice":
        raise AssertionError("the SFT checkpoint is not a custom-voice model of its speaker")
    with torch.no_grad():   # the x-vector sft.main wrote into row 3000
        want = speaker_encoder_forward(map_tensors(from_jax_tree(spk_state, device),
                                                   lambda t: t.to(torch.bfloat16)), spk06,
                                       torch.from_numpy(ref_mel).to(device, torch.bfloat16))[0]
    row_err = rel_err(model.talker_params["codec_embedding"][3000], want)
    if row_err > 1e-2:
        raise AssertionError(f"speaker row off the speaker encoder's x-vector: {row_err}")
    wavs, sr = model.generate_custom_voice(TEXTS[0], speaker="smoke_voice", language="english",
                                           seed=SEED, max_new_tokens=32)
    w = wavs[0]
    if sr != 24000 or w.shape[0] == 0 or w.shape[0] % 1920 or not np.isfinite(w).all():
        raise AssertionError(f"SFT model speech: sr {sr}, shape {w.shape}")
    line("sft", model="1.7B" if cfg == TALKER_1B7 else "cut", dtype="bf16", B=SFT_B, T=T, grad_accum=SFT_ACCUM,
         cycles=SFT_CYCLES, ms_per_cycle=f"{ms:.1f}", tokens_per_s=f"{tokens / ms * 1e3:.0f}",
         fwd_bwd_ms=f"{fwd_bwd_ms:.1f}", update_ms=f"{update_ms:.1f}",
         peak_gib=f"{peak_gib:.2f}", losses=[f"{x:.4f}" for x in losses],
         fp32_2layer_loss_rel=f"{loss_rel:.2e}", fp32_2layer_worst_grad=worst,
         fp32_2layer_grad_rel=f"{grad_rel[worst]:.2e}", main_0b6_s=f"{main_s:.1f}",
         speaker_row_rel=f"{row_err:.2e}", frames=w.shape[0] // 1920)
    del model
    torch.cuda.empty_cache()
    return dict(ms=ms, tokens_per_s=tokens / ms * 1e3, peak_gib=peak_gib)




def phase_sft_graphs(device, cfg=None) -> dict:
    """The SFT step's captured graphs against the eager step: TALKER_1B7's
    widths at 2 layers (talker and code predictor) in fp32, TF32 off, one
    start state, SFT_GRAPH_STEPS mini-steps at grad_accum 2 over
    SFT_BATCHES batches of one shape (and speaker vectors) taken in turn,
    so that every replay meets inputs its capture never saw, on the default
    route (each key's first call eager, then replays: 2 captures, 4
    replays) and inside `graphs.eager()`: each replay's loss differs from
    its key's capture-time loss; the losses within SFT_LOSS_REL_TOL, every
    leaf and both AdamW moments of every leaf within SFT_GRAD_REL_TOL
    (relative L2)."""
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.finetune import train
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7, random_talker_params
    from qwen3_tts_tpu_torch.weights import map_tensors

    cfg = cfg or TALKER_1B7
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2, code_predictor_config=dataclasses.replace(
        cfg.code_predictor_config, num_hidden_layers=2))
    rng = np.random.default_rng(SEED + 17)
    ref_mel = np.zeros((1, 8, 128), np.float32)
    batches = []
    for _ in range(SFT_BATCHES):
        b = sft_batch(TTSModelConfig(talker_config=cfg2), rng, SFT_HOST_T, SFT_B, ref_mel)
        b.pop("ref_mels")
        spk = rng.normal(0, 0.05, (SFT_B, cfg.hidden_size)).astype(np.float32)
        batches.append(({k: torch.as_tensor(v, device=device) for k, v in b.items()},
                        torch.from_numpy(spk).to(device)))
    start = random_talker_params(cfg2, torch.Generator(device=device).manual_seed(SEED + 18),
                                 dtype=torch.float32)
    runs = {}
    for route in ("graph", "eager"):
        params = train.trainable(map_tensors(start, lambda t: t.clone()))
        opt = train.default_optimizer(params, lr=1e-3, grad_accum=2)
        step = train.make_train_step(cfg2, opt)
        before = dict(graphs.stats(device))
        with graphs.eager() if route == "eager" else contextlib.nullcontext():
            losses = [float(step(params, *batches[i % SFT_BATCHES])["loss"])
                      for i in range(SFT_GRAPH_STEPS)]
        after = graphs.stats(device)
        runs[route] = dict(
            losses=losses, leaves=[p.detach() for p in opt.leaves],
            moments=[(opt.adamw.state[p]["exp_avg"], opt.adamw.state[p]["exp_avg_sq"])
                     for p in opt.leaves],
            captures=after["captures"] - before["captures"],
            replays=after["replays"] - before["replays"])
        del params, opt, step
    del start
    g, e = runs["graph"], runs["eager"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], e["losses"]))
    leaf_rel = max(rel_err(a, b) for a, b in zip(g["leaves"], e["leaves"]) if b.any())
    moment_rel = max(rel_err(a, b) for ga, ea in zip(g["moments"], e["moments"])
                     for a, b in zip(ga, ea) if b.any())
    # mini-steps 0 and 1 are the captures (fold, fold + update); each later
    # one replays the graph of its phase on a batch that capture never saw
    new_inputs = all(g["losses"][i] != g["losses"][i % 2] for i in range(2, SFT_GRAPH_STEPS))
    line("sft_graphs fp32 2-layer", steps=SFT_GRAPH_STEPS, grad_accum=2, T=SFT_HOST_T,
         batches=SFT_BATCHES, graph_captures=g["captures"], graph_replays=g["replays"],
         eager_captures=e["captures"], replays_differ_from_captures=new_inputs,
         loss_rel=f"{loss_rel:.2e}", leaf_rel=f"{leaf_rel:.2e}",
         moment_rel=f"{moment_rel:.2e}", losses=[f"{x:.5f}" for x in g["losses"]])
    if not new_inputs:
        raise AssertionError(f"SFT graphs: a replay's loss equals its capture's {g['losses']}")
    if (g["captures"], g["replays"], e["captures"], e["replays"]) != (
            2, SFT_GRAPH_STEPS - 2, 0, 0):
        raise AssertionError(f"SFT graphs: captures / replays {g['captures']} / "
                             f"{g['replays']} graphed, {e['captures']} / {e['replays']} eager")
    if (loss_rel > SFT_LOSS_REL_TOL or leaf_rel > SFT_GRAD_REL_TOL
            or moment_rel > SFT_GRAD_REL_TOL):
        raise AssertionError(f"SFT graphed vs eager: loss {loss_rel}, leaves {leaf_rel}, "
                             f"moments {moment_rel}")
    del runs, g, e
    graphs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(loss_rel=loss_rel, leaf_rel=leaf_rel, moment_rel=moment_rel)


# ---------------------------------------------------------------------------
# The DP / TP plans (parallel/mesh.py), evaluation.py, the native FLAC path
# ---------------------------------------------------------------------------

PAR_DIR = "build/parallel"
# the phase runs TALKER_1B7's widths (the head counts tp=2 splits) at
# PAR_LAYERS talker and code-predictor layers (28 and 5 took 155 s of the
# smoke's 1200): every check below is per layer or per frame
PAR_LAYERS = 2
PAR_FRAMES = 8                # (a): frames of the fp32 greedy generation
PAR_NEAR_TIE = 1e-3           # (a): a differing code passes only over a top-2 gap below this
PAR_ICL_T, PAR_ICL_STARTS = 2304, (0, 211)   # (b): the bf16 ICL-length prefill
PAR_HIDDEN_REL_TOL = 5e-2     # (b): its last hidden, tp=2 against unsharded (relative L2)
PAR_SLOTS, PAR_REQUESTS, PAR_REQ_FRAMES = 4, 6, 6     # (c): the mesh engines (queued)
PAR_SFT_LAYERS, PAR_SFT_REL_TOL = 2, 1e-4   # (d): full widths, 2 layers, fp32
EVAL_DIR = "build/eval"
# evaluation numbers, card against the host copy (fp32, TF32 off on both):
# relative, absolute below 1 (dB figures near 0). SI-SDR is held as what it
# measures: it is 20 log10 of the cosine rho between reference and output,
# and a relative change e of the output moves it by up to 20 log10(1 + e /
# rho) dB, which is large where rho is small (a random tokenizer's output:
# rho ~ 3e-3, -50 dB)
EVAL_REL_TOL = 1e-3
EVAL_WAVS, EVAL_WAV_S, EVAL_NEW_TOKENS = 2, 1.0, 8
EVAL_LAYERS = 1               # the evaluation talker's layers, at TALKER_0B6's widths
# the tokenizers the phase loads decode in chunks of this many frames: a
# decode pads its codes to a whole chunk, and at the tokenizer's default 300
# the phase's host half (inputs of <= 13 frames) took 61.1 s on an H100's
# host, 8.6 s at 32
EVAL_CHUNK_FRAMES = 32


def _par_cfg(cfg, layers=None):
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_hidden_layers=layers, code_predictor_config=(
        dataclasses.replace(cfg.code_predictor_config, num_hidden_layers=layers)))


def _par_host_params(cfg, seed):
    """fp32 params drawn on the host from a seed: every process draws the
    same numbers, and a rank moves only its shard to the card."""
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params

    return random_talker_params(cfg, torch.Generator().manual_seed(seed), dtype=torch.float32)


def _par_gen_cfg():
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
    from qwen3_tts_tpu_torch.runtime.generate import GenerationConfig

    return GenerationConfig(max_new_tokens=PAR_FRAMES + 1,
                            sampling=SamplingParams(do_sample=False, repetition_penalty=1.05),
                            subtalker=SamplingParams(do_sample=False))


def _par_icl(cfg, device):
    """The (b) inputs: a left-padded bf16 batch of ICL length from the seed."""
    rng = np.random.default_rng(SEED + 22)
    B, T = len(PAR_ICL_STARTS), PAR_ICL_T
    e = torch.from_numpy(rng.standard_normal((B, T, cfg.hidden_size), dtype=np.float32))
    mask = torch.ones((B, T), dtype=torch.int64)
    for b, s in enumerate(PAR_ICL_STARTS):
        e[b, :s], mask[b, :s] = 0, 0
    return e.to(device, torch.bfloat16), mask.to(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _par_generate(params, cfg, prompts, device, mesh=None):
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames

    e, m, tr, pad = (torch.from_numpy(x).to(device) for x in prompts)
    _sync(device)
    t0 = time.time()
    with torch.no_grad():
        r = generate_frames(params, cfg, _par_gen_cfg(), e, m, tr, pad,
                            torch.Generator(device=device).manual_seed(SEED), mesh=mesh)
    codes, lens = r.codes.cpu().numpy(), r.lengths.cpu().numpy()
    return codes, lens, time.time() - t0


def _par_local_heads(params, cfg, e, mask, mesh):
    """Layer 0's q, k, v on this rank's heads, as decoder_stack forms them
    (strided views of the fused qkv product after the norms and RoPE)."""
    from qwen3_tts_tpu_torch.models.talker import StackDims
    from qwen3_tts_tpu_torch.ops.norms import rms_norm
    from qwen3_tts_tpu_torch.ops.rope import apply_rope, default_inv_freq, rope_tables
    from qwen3_tts_tpu_torch.weights import matmul_t

    dims = StackDims.from_talker(cfg, mesh)
    B, T, _ = e.shape
    D = dims.head_dim
    lay = params["layers"]
    x = rms_norm(e, lay["input_layernorm"]["weight"][0], dims.eps)
    qkv = matmul_t(x, lay["self_attn"]["qkv_proj"]["weight"][0])
    nq, nkv = dims.heads * D, dims.kv_heads * D
    q = rms_norm(qkv[..., :nq].reshape(B, T, dims.heads, D),
                 lay["self_attn"]["q_norm"]["weight"][0], dims.eps)
    k = rms_norm(qkv[..., nq:nq + nkv].reshape(B, T, dims.kv_heads, D),
                 lay["self_attn"]["k_norm"]["weight"][0], dims.eps)
    v = qkv[..., nq + nkv:].reshape(B, T, dims.kv_heads, D)
    pos = torch.cumsum(mask, dim=-1) - 1
    pos = torch.where(mask == 0, torch.ones_like(pos), pos)
    cos, sin = rope_tables(pos, default_inv_freq(D, cfg.rope_theta, device=e.device))
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v, (T - mask.sum(dim=-1)).to(torch.int32)


def _par_prefill(params, cfg, device, mesh=None):
    """(b): the bf16 prefill of the ICL-length batch (T >= FLASH_PREFILL_MIN_T:
    kernel 3 in every layer, on this rank's heads under a mesh). Returns the
    last position's hidden, the flash launches, and kernel 3 on layer 0's
    local heads against its twin."""
    from qwen3_tts_tpu_torch.models.talker import talker_prefill
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import flash_prefill, flash_prefill_ref
    from qwen3_tts_tpu_torch.weights import map_tensors

    p16 = map_tensors(params, lambda t: t.to(torch.bfloat16))
    e, mask = _par_icl(cfg, device)
    flash_prefill.launches = 0
    _sync(device)
    t0 = time.time()
    with torch.no_grad():
        _, h, _ = talker_prefill(p16, cfg, e, mask, None, mesh=mesh)
    _sync(device)
    out = dict(last=h[:, -1].float().cpu(), launches=flash_prefill.launches,
               wall=time.time() - t0)
    with torch.no_grad():
        q, k, v, start = _par_local_heads(p16, cfg, e, mask, mesh)
        got = flash_prefill(q, k, v, start)
        want = flash_prefill_ref(q.float(), k.float(), v.float(), start)
        starts = start.tolist()
        out["heads"] = (q.shape[2], k.shape[2])
        out["err"] = max(max_abs(got[b, s:], want[b, s:]) for b, s in enumerate(starts))
        out["row_rel"] = max(float(((got[b, s:].float() - want[b, s:]).norm(dim=-1)
                                    / want[b, s:].norm(dim=-1).clamp_min(1e-30)).max())
                             for b, s in enumerate(starts))
        out["ms"] = (cuda_ms(lambda: flash_prefill(q, k, v, start), 10)
                     if device.type == "cuda" else float("nan"))
    return out


def _par_requests(prompts):
    """(c): PAR_REQUESTS single-prompt requests from the smoke's prompts."""
    e, m, tr, pad = prompts
    reqs = []
    for i in range(PAR_REQUESTS):
        b = i % e.shape[0]
        n = int(m[b].sum())
        reqs.append((e[b:b + 1, -n:], tr[b:b + 1], pad, PAR_REQ_FRAMES + i % 3))
    return reqs


def _par_engine(params, cfg, prompts, device, mesh=None):
    from qwen3_tts_tpu_torch.runtime.batching import ContinuousBatchingEngine, Request

    reqs = _par_requests(prompts)
    eng = ContinuousBatchingEngine(params, cfg, _par_gen_cfg(), num_slots=PAR_SLOTS,
                                   max_len=256, max_trailing=prompts[2].shape[1],
                                   prefill_bucket=128, dtype=torch.float32, mesh=mesh)
    _sync(device)
    t0 = time.time()
    for rid, (e, tr, pad, mf) in enumerate(reqs):
        eng.submit(Request(request_id=rid, inputs_embeds=torch.from_numpy(e).to(device),
                           attn_mask=torch.ones((1, e.shape[1]), dtype=torch.int32,
                                                device=device),
                           trailing=torch.from_numpy(tr).to(device), trailing_len=tr.shape[1],
                           tts_pad=torch.from_numpy(pad).to(device), max_frames=mf))
    with torch.no_grad():
        codes = {c.request_id: np.asarray(c.codes) for c in eng.run_until_drained()}
    return codes, time.time() - t0


def _par_sft(cfg, batch, spk, device, mesh=None):
    """(d): one train step (grad_accum 2, so the optimizer only folds the
    gradients in) at full widths and PAR_SFT_LAYERS layers in fp32. Returns
    the loss and the unsharded gradients (on the card)."""
    from qwen3_tts_tpu_torch.finetune import train
    from qwen3_tts_tpu_torch.parallel import mesh as M
    from qwen3_tts_tpu_torch.weights import flatten_state_dict, map_tensors

    cfg2 = _par_cfg(cfg, PAR_SFT_LAYERS)
    host = _par_host_params(cfg2, SEED + 23)
    plan = sharded = None
    if mesh is not None:
        plan = M.tp_shard_plan(host, mesh)
        sharded = train.param_flags(host, plan)
        host = M.shard_talker_params(host, mesh, plan)
    params = train.trainable(map_tensors(host, lambda t: t.to(device)))
    del host
    opt = train.default_optimizer(params, lr=2e-5, grad_accum=2, mesh=mesh, sharded=sharded)
    rows = slice(None) if mesh is None else mesh.rows(spk.shape[0])
    m = train.make_train_step(cfg2, opt)(
        params, {k: torch.as_tensor(v[rows], device=device) for k, v in batch.items()},
        torch.as_tensor(spk[rows], device=device))
    acc = iter(opt.acc)

    def like(tree):
        if isinstance(tree, dict):
            return {k: like(tree[k]) for k in sorted(tree)}
        return None if tree is None else next(acc)

    grads = like(params)
    if mesh is not None:
        grads = M.unshard_talker_params(grads, plan, mesh)
    return float(m["loss"]), {k: v for k, v in flatten_state_dict(grads).items()
                              if v is not None}


def _par_rank(rank, world, dp, tp, job):
    """One rank of the parallel phase: ranks share the one card through
    gloo. Every check the mesh shape (dp, tp) runs; rank 0 writes its
    unsharded SFT gradients where the parent reads them."""
    import os

    from qwen3_tts_tpu_torch.parallel import mesh as M
    from qwen3_tts_tpu_torch.weights import map_tensors

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, cfg = job["device"], job["cfg"]
    mesh = M.make_mesh(dp, tp, device=device, backend="gloo")
    t0 = time.time()
    host = _par_host_params(cfg, SEED + 21)
    params = map_tensors(M.shard_talker_params(host, mesh), lambda t: t.to(device))
    del host
    out = {"load_s": time.time() - t0}
    if dp == 1:
        out["gen"] = _par_generate(params, cfg, job["prompts"], device, mesh)
        out["prefill"] = _par_prefill(params, cfg, device, mesh)
    out["engine"] = _par_engine(params, cfg, job["prompts"], device, mesh)
    del params
    t0 = time.time()
    loss, grads = _par_sft(cfg, job["sft_batch"], job["sft_spk"], device, mesh)
    out["sft_loss"], out["sft_s"] = loss, time.time() - t0
    if rank == 0:
        path = os.path.join(PAR_DIR, f"grads_{dp}x{tp}.pt")
        torch.save({k: v.cpu() for k, v in grads.items()}, path)
        out["grads"] = path
    out["gib"] = (torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda"
                  else float("nan"))
    return out


@contextlib.contextmanager
def _recorded_logits(log: list):
    """Record every logits row block the samplers see (eager loops only)."""
    from qwen3_tts_tpu_torch.models import talker as T
    from qwen3_tts_tpu_torch.runtime import generate as G

    saved = [(T, "process_and_sample"), (T, "process_and_sample_rows"),
             (G, "process_and_sample_rows")]
    orig = [getattr(mod, name) for mod, name in saved]

    def wrap(fn):
        def inner(logits, *a, **kw):
            log.append(logits.float().cpu())
            return fn(logits, *a, **kw)
        return inner

    for (mod, name), fn in zip(saved, orig):
        setattr(mod, name, wrap(fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(saved, orig):
            setattr(mod, name, fn)


def _first_difference(got, glen, want, wlen):
    """(row, frame, codebook) of the first differing code, or None."""
    for b in range(want.shape[0]):
        n = min(glen[b], wlen[b])
        diff = np.argwhere(got[b, :n] != want[b, :n])
        if len(diff):
            return b, int(diff[0][0]), int(diff[0][1])
        if glen[b] != wlen[b]:
            return b, int(n), 0
    return None


def phase_parallel(device, cfg=None) -> dict:
    """The DP / TP plans on the one card: ranks that share it through
    gloo (spawned processes, one FileStore), at TALKER_1B7's widths and
    PAR_LAYERS layers, fp32 params drawn on the host from the seed (a rank
    moves only its shard):
    (a) tp=2 greedy generation of the smoke's texts in fp32 against the
        unsharded eager run (a differing code passes only as a near-tie: the
        unsharded top-2 logit gap there is printed);
    (b) tp=2 bf16 prefill of an ICL-length batch: kernel 3 on each rank's
        8 query / 4 KV heads, held to its twin on layer 0's local heads; the
        last hidden against the unsharded bf16 prefill;
    (c) a (1, 2) and a (2, 1) engine: PAR_SLOTS slots, PAR_REQUESTS greedy
        requests, each request's codes equal the unsharded engine's;
    (d) one SFT step at tp=2 and at dp=2, full widths at 2 layers in fp32:
        the loss and every leaf's gradient against the unsharded card run;
    (e) a one-rank NCCL mesh runs (a) at dp = tp = 1.
    The two meshes' ranks run beside each other and beside this process's
    references: every wall is of processes sharing one card (the ranks
    through gloo), no throughput claim."""
    import os
    import tempfile

    import torch.distributed as dist

    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.parallel import mesh as M
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7, spawn_ranks
    from qwen3_tts_tpu_torch.weights import map_tensors

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_t0 = time.time()
    os.makedirs(PAR_DIR, exist_ok=True)
    cfg = cfg or _par_cfg(TALKER_1B7, PAR_LAYERS)
    t0 = time.time()
    params = map_tensors(_par_host_params(cfg, SEED + 21), lambda t: t.to(device))
    load_s = time.time() - t0
    tc = dataclasses.replace(cfg, spk_id={"vivian": 3000}, codec_language_id={"english": 1000})
    model = Qwen3TTSModel(TTSModelConfig(talker_config=tc, tts_model_type="custom_voice"),
                          params, None, None, StandInTokenizer(), {}, device=device)
    with torch.no_grad():
        prompts = tuple(x.cpu().numpy() for x in assemble_prompt_specs(
            params, tc, model.config, model._specs_custom_voice(TEXTS, "vivian", "english",
                                                                None, False), bucket=32))
    rng = np.random.default_rng(SEED + 24)
    batch = sft_batch(TTSModelConfig(talker_config=cfg), rng, SFT_HOST_T, 2,
                      rng.standard_normal((1, 20, 128)).astype(np.float32))
    batch.pop("ref_mels")
    spk = rng.normal(0, 0.05, (2, cfg.hidden_size)).astype(np.float32)
    job = dict(prompts=prompts, sft_batch=batch, sft_spk=spk, cfg=cfg,
               device=torch.device(device.type, 0) if device.type == "cuda" else device)
    threads = max(1, (os.cpu_count() or 4) // 4)
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        # both meshes' ranks run beside this process's unsharded references
        runs = [pool.submit(spawn_ranks, _par_rank, 2, dp, tp, job, timeout=900,
                            threads=threads) for dp, tp in ((1, 2), (2, 1))]
        log: list = []
        with graphs.eager(), _recorded_logits(log):
            want_codes, want_lens, gen_wall = _par_generate(params, cfg, prompts, device)
        pre = _par_prefill(params, cfg, device)
        base_engine, engine_wall = _par_engine(params, cfg, prompts, device)
        # (e): a one-rank NCCL mesh in this process
        with tempfile.TemporaryDirectory(dir=PAR_DIR) as tmp:
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                    rank=0, world_size=1)
            try:
                mesh = M.make_mesh(1, 1, device=device)
                nccl_codes, nccl_lens, nccl_wall = _par_generate(params, cfg, prompts, device,
                                                                 mesh)
            finally:
                dist.destroy_process_group()
        del params, model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        loss, grads = _par_sft(cfg, batch, spk, device)
        tp_run, dp_run = (r.result() for r in runs)
    spawn_wall = time.time() - t0

    Q = cfg.num_code_groups
    gaps = []
    for r in tp_run:
        codes, lens, _ = r["gen"]
        first = _first_difference(codes, lens, want_codes, want_lens)
        if first is not None:
            b, f, j = first
            top2 = torch.topk(log[Q * f + j][b], 2).values
            gaps.append(float(top2[0] - top2[1]))
            if gaps[-1] > PAR_NEAR_TIE:
                raise AssertionError(f"parallel (a): codes differ at row {b} frame {f} "
                                     f"codebook {j}, top-2 gap {gaps[-1]} > {PAR_NEAR_TIE}")
    hidden_rel = max(rel_err(r["prefill"]["last"], pre["last"]) for r in tp_run)
    flash_err = max(r["prefill"]["err"] for r in tp_run)
    flash_row = max(r["prefill"]["row_rel"] for r in tp_run)
    launches = [r["prefill"]["launches"] for r in tp_run]
    heads = tp_run[0]["prefill"]["heads"]
    if not (hidden_rel <= PAR_HIDDEN_REL_TOL and flash_err <= FLASH_TOL
            and flash_row <= FLASH_ROW_REL_TOL
            and heads == (cfg.num_attention_heads // 2, cfg.num_key_value_heads // 2)
            # a CPU rehearsal runs the twin, which launches nothing
            and launches == [cfg.num_hidden_layers if device.type == "cuda" else 0] * 2):
        raise AssertionError(f"parallel (b): last hidden rel {hidden_rel} (bar "
                             f"{PAR_HIDDEN_REL_TOL}); local-head flash err {flash_err}, row "
                             f"{flash_row}, heads {heads}, launches {launches}")
    for name, run_ in (("(1, 2)", tp_run), ("(2, 1)", dp_run)):
        for r in run_:
            got = r["engine"][0]
            if set(got) != set(base_engine) or any(
                    not np.array_equal(got[k], base_engine[k]) for k in base_engine):
                agree = np.mean([np.array_equal(got.get(k), v) for k, v in base_engine.items()])
                raise AssertionError(f"parallel (c): the {name} engine's codes differ from the "
                                     f"unsharded engine's ({agree:.3f} of requests equal)")
    if not (np.array_equal(nccl_codes, want_codes) and np.array_equal(nccl_lens, want_lens)):
        raise AssertionError("parallel (e): the one-rank NCCL mesh changed the codes")
    sft = {}
    for tag, run_ in (("tp2", tp_run), ("dp2", dp_run)):
        got = torch.load(run_[0]["grads"])
        loss_rel = max(abs(r["sft_loss"] - loss) / abs(loss) for r in run_)
        if set(got) != set(grads):
            raise AssertionError(f"parallel (d) {tag}: gradient leaves differ")
        rels = {k: rel_err(got[k], v.cpu()) for k, v in grads.items() if v.any()}
        worst = max(rels, key=rels.get)
        sft[tag] = (loss_rel, worst, rels[worst])
        if loss_rel > PAR_SFT_REL_TOL or rels[worst] > PAR_SFT_REL_TOL:
            raise AssertionError(f"parallel (d) {tag}: loss rel {loss_rel}, {worst} "
                                 f"{rels[worst]} (bar {PAR_SFT_REL_TOL})")
    del grads, got
    if device.type == "cuda":
        torch.cuda.empty_cache()
    line("parallel", ranks="(1,2) and (2,1) at once, 4 processes sharing one card through gloo",
         model=(f"1.7B widths, {cfg.num_hidden_layers} layers"
                if cfg == _par_cfg(TALKER_1B7, PAR_LAYERS) else "cut"),
         cut=f"sft {PAR_SFT_LAYERS} layers", fp32_tp2_frames=int(want_lens.max()),
         codes_equal=not gaps, near_tie_gaps=[f"{g:.2e}" for g in gaps],
         bf16_icl_T=PAR_ICL_T, last_hidden_rel=f"{hidden_rel:.3g}",
         local_heads=f"{heads[0]}q/{heads[1]}kv", flash_local_err=f"{flash_err:.3g}",
         flash_local_row_rel=f"{flash_row:.3g}", flash_launches_per_rank=launches,
         flash_local_ms_sharing=f"{tp_run[0]['prefill']['ms']:.4f}",
         engines_equal="(1,2) (2,1)", requests=PAR_REQUESTS, slots=PAR_SLOTS,
         sft_tp2=f"loss_rel={sft['tp2'][0]:.2e} worst={sft['tp2'][1]}:{sft['tp2'][2]:.2e}",
         sft_dp2=f"loss_rel={sft['dp2'][0]:.2e} worst={sft['dp2'][1]}:{sft['dp2'][2]:.2e}",
         nccl_1rank_codes_equal=True, both_spawns_s=f"{spawn_wall:.1f}", rank_load_s=f"{tp_run[0]['load_s']:.1f}",
         rank_gen_s_sharing=f"{tp_run[0]['gen'][2]:.2f}", unsharded_gen_s=f"{gen_wall:.2f}",
         nccl_gen_s=f"{nccl_wall:.2f}", rank_prefill_s_sharing=f"{tp_run[0]['prefill']['wall']:.2f}",
         unsharded_prefill_s=f"{pre['wall']:.2f}", rank_engine_s_sharing=
         f"{tp_run[0]['engine'][1]:.2f}", unsharded_engine_s=f"{engine_wall:.2f}",
         rank_sft_s_sharing=f"{tp_run[0]['sft_s']:.2f}",
         rank_peak_gib=f"{max(r['gib'] for r in tp_run + dp_run):.2f}", host_load_s=f"{load_s:.1f}",
         phase_s=f"{time.time() - phase_t0:.1f}")
    return dict(flash_launches=launches, hidden_rel=hidden_rel, flash_err=flash_err)


def eval_tokenizer_checkpoint(codec):
    """The evaluation checkpoints' 12 Hz tokenizer: (config.json dict, flat
    numpy state dict) from SEED + 31, its decoder's weight matrices times
    VOC_WEIGHT_SCALE as `scaled_vocoder_params` scales them, its vectors,
    raw split-RVQ quantizer and encoder as drawn."""
    from qwen3_tts_tpu_torch.utils.testing import codec12_tokenizer_checkpoint

    return codec12_tokenizer_checkpoint(codec, SEED + 31, scale=VOC_WEIGHT_SCALE)


def _eval_checkpoints(talker, codec):
    """A base and a custom-voice checkpoint sharing one talker (TALKER_0B6's
    widths, EVAL_LAYERS layers), a speaker encoder, a 12 Hz tokenizer at the
    default widths (its decoder's weight matrices times VOC_WEIGHT_SCALE, as
    every smoke vocoder: the draw itself clamps its audio) and a greedy
    generation_config.json; 24 kHz wavs; a manifest for each (a clone row
    for the base model, a custom-voice row for the other)."""
    import os

    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.utils.audio import write_wav
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params, speaker_encoder_state
    from qwen3_tts_tpu_torch.weights import (flatten_state_dict, save_safetensors,
                                             talker_params_to_state_dict)

    tc = dataclasses.replace(talker, spk_id={"vivian": 3000},
                             codec_language_id={"english": 1000})
    spk_cfg = SpeakerEncoderConfig(enc_dim=tc.hidden_size)
    tok = os.path.abspath(os.path.join(EVAL_DIR, "speech_tokenizer"))
    os.makedirs(tok, exist_ok=True)
    tok_json, tok_state = eval_tokenizer_checkpoint(codec)
    save_safetensors(os.path.join(tok, "model.safetensors"), tok_state)
    with open(os.path.join(tok, "config.json"), "w") as f:
        json.dump(tok_json, f)
    sd = talker_params_to_state_dict(random_talker_params(
        tc, torch.Generator().manual_seed(SEED + 32), dtype=torch.float32), tc)
    sd.update(flatten_state_dict(speaker_encoder_state(spk_cfg, SEED + 33), "speaker_encoder"))
    weights = os.path.abspath(os.path.join(EVAL_DIR, "model.safetensors"))
    save_safetensors(weights, sd)
    ref = os.path.join(EVAL_DIR, "ref.wav")
    write_wav(ref, reference_clip(24000)[:3 * 24000], 24000)
    wav_dir = os.path.join(EVAL_DIR, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(SEED + 34)
    n = int(EVAL_WAV_S * 24000)
    for i in range(EVAL_WAVS):
        t = np.arange(n) / 24000
        write_wav(os.path.join(wav_dir, f"u{i}.wav"), 0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t)
                  * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.normal(size=n), 24000)
    rows = {"base": {"text": TEXTS[0], "lang": "english", "ref_audio": ref,
                     "ref_text": CLONE_REF_TEXT},
            "custom_voice": {"text": TEXTS[1], "lang": "english"}}
    dirs = {}
    for kind, row in rows.items():
        d = os.path.join(EVAL_DIR, kind)
        os.makedirs(d, exist_ok=True)
        cfg = TTSModelConfig(talker_config=tc, speaker_encoder_config=spk_cfg,
                             tts_model_type=kind, tts_model_size="0b6")
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        with open(os.path.join(d, "generation_config.json"), "w") as f:
            json.dump({"do_sample": False, "subtalker_dosample": False}, f)
        for name, target in (("model.safetensors", weights), ("speech_tokenizer", tok)):
            if not os.path.lexists(os.path.join(d, name)):
                os.symlink(target, os.path.join(d, name))
        with open(os.path.join(d, "manifest.jsonl"), "w") as f:
            f.write(json.dumps(row) + "\n")
        dirs[kind] = d
    return dirs, wav_dir


@contextlib.contextmanager
def _recorded_eval_audio(log: dict):
    """Record into `log` (kind -> list of waveforms) every wav that
    evaluation.py reads ("read"), each tokenizer round trip's output
    ("round_trip") and each row a model synthesises ("synthesis")."""
    from qwen3_tts_tpu_torch import evaluation
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel

    saved = [(evaluation, "_read_wav"), (evaluation, "reconstruction_report"),
             (Qwen3TTSModel, "generate_custom_voice"), (Qwen3TTSModel, "generate_voice_clone")]
    orig = [getattr(owner, name) for owner, name in saved]

    def read_wav(path):
        wav, sr = orig[0](path)
        log.setdefault("read", []).append(wav)
        return wav, sr

    def report(ref, deg, *a, **kw):
        log.setdefault("round_trip", []).append(np.asarray(deg))
        return orig[1](ref, deg, *a, **kw)

    def synthesis(fn):
        def inner(self, *a, **kw):
            wavs, sr = fn(self, *a, **kw)
            log.setdefault("synthesis", []).extend(np.asarray(w) for w in wavs)
            return wavs, sr
        return inner

    for (owner, name), fn in zip(saved, (read_wav, report, synthesis(orig[2]),
                                         synthesis(orig[3]))):
        setattr(owner, name, fn)
    try:
        yield
    finally:
        for (owner, name), fn in zip(saved, orig):
            setattr(owner, name, fn)


@contextlib.contextmanager
def _eval_chunk_frames(frames: int):
    """Every 12 Hz tokenizer loaded inside decodes in chunks of `frames`."""
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer

    load = Qwen3TTSTokenizer.__dict__["from_pretrained"]

    def chunked(cls, *a, **kw):
        tok = load.__func__(cls, *a, **kw)
        tok.chunk_size = frames
        return tok

    Qwen3TTSTokenizer.from_pretrained = classmethod(chunked)
    try:
        yield
    finally:
        Qwen3TTSTokenizer.from_pretrained = load


def _eval_numbers(report) -> dict:
    return {(s, k): v for s, m in report["suites"].items() for k, v in m.items()}


def phase_evaluation(device, talker=None, codec=None) -> dict:
    """evaluation.py on the card against the same calls on the host copy:
    `run_suite` over the base checkpoint (one clone row: synthesis and
    ECAPA speaker similarity) and the custom-voice one (the tokenizer round
    trip over EVAL_WAVS 24 kHz wavs and one custom-voice row), Whisper asked
    for without a model; `evaluate_tts_wer` with an injected ASR whose
    transcript depends on the audio's length. Every number within its bar
    of the host's (EVAL_REL_TOL, see there); the unavailable markers exactly
    the expected ones (Whisper, and pesq / pystoi / UTMOS unless
    installed)."""
    import importlib.util
    import os
    import types

    from qwen3_tts_tpu_torch import evaluation
    from qwen3_tts_tpu_torch.config import CodecV2Config
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.utils.testing import TALKER_0B6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = phase_t0 = time.time()
    dirs, wav_dir = _eval_checkpoints(talker or _par_cfg(TALKER_0B6, EVAL_LAYERS),
                                      codec or CodecV2Config())
    write_s = time.time() - t0

    def args(kind, dev):
        return types.SimpleNamespace(
            ckpt=dirs[kind], tokenizer_ckpt=None, suite="all" if kind == "custom_voice" else
            "seed-tts", manifest=os.path.join(dirs[kind], "manifest.jsonl"), wav_dir=wav_dir,
            asr="whisper", asr_ckpt=os.path.join(EVAL_DIR, "no-whisper"), lang="en",
            speaker=None, max_items=10, max_new_tokens=EVAL_NEW_TOKENS, out=None, device=dev)

    reports, walls = {}, {}
    audio = {dev: {} for dev in (str(device), "cpu")}
    for dev in audio:
        for kind in dirs:
            t0 = time.time()
            with _eval_chunk_frames(EVAL_CHUNK_FRAMES), _recorded_eval_audio(audio[dev]):
                reports[(kind, dev)] = evaluation.run_suite(args(kind, dev),
                                                            processor=StandInTokenizer())
            walls[(kind, dev)] = time.time() - t0
    errs = {}
    for kind in dirs:
        card, host = reports[(kind, str(device))], reports[(kind, "cpu")]
        if card["skipped"] != host["skipped"]:
            raise AssertionError(f"evaluation {kind}: skip rows differ: {card['skipped']} "
                                 f"against {host['skipped']}")
        cn, hn = _eval_numbers(card), _eval_numbers(host)
        if set(cn) != set(hn):
            raise AssertionError(f"evaluation {kind}: metrics differ: {set(cn) ^ set(hn)}")
        for key, v in hn.items():
            if isinstance(v, float):
                bar = (20 * np.log10(1 + EVAL_REL_TOL / min(10 ** (v / 20), 1.0))
                       if key[1] == "si_sdr_db" else EVAL_REL_TOL * max(abs(v), 1.0))
                errs[(kind,) + key] = abs(cn[key] - v) / bar
            elif cn[key] != v:
                raise AssertionError(f"evaluation {kind} {key}: {cn[key]!r} against {v!r}")
    worst = max(errs, key=errs.get)   # each difference over its bar
    if errs[worst] > 1.0:
        raise AssertionError(f"evaluation: {worst} card against host at {errs[worst]} of its "
                             f"bar; "
                             f"card {reports[(worst[0], str(device))]['suites']}, host "
                             f"{reports[(worst[0], 'cpu')]['suites']}")
    nums = _eval_numbers(reports[("custom_voice", str(device))])
    nums.update(_eval_numbers(reports[("base", str(device))]))
    unavailable = sorted(k for (_, k), v in nums.items() if isinstance(v, str))
    expected = ["wer"] + [k for k, mod in (("pesq_nb", "pesq"), ("pesq_wb", "pesq"),
                                                 ("stoi", "pystoi"), ("utmos", None))
                              if mod is None or importlib.util.find_spec(mod) is None]
    if (unavailable != sorted(set(expected))
            or not nums[("seed_tts", "wer")].startswith("unavailable (")):
        raise AssertionError(f"evaluation: unavailable columns {unavailable}, expected "
                             f"{sorted(set(expected))}")
    # evaluate_tts_wer with an injected ASR
    words = TEXTS[3].lower().rstrip(".").split()

    def asr(wav, sr):
        return " ".join(words[:np.asarray(wav).shape[-1] // 1920 % (len(words) + 1)])

    wers = {}
    for dev in audio:
        with _eval_chunk_frames(EVAL_CHUNK_FRAMES):
            m = Qwen3TTSModel.from_pretrained(dirs["custom_voice"], dtype=torch.float32,
                                              device=dev)
        m.processor = StandInTokenizer()
        with _recorded_eval_audio(audio[dev]):
            wers[dev] = evaluation.evaluate_tts_wer(m, [TEXTS[3], TEXTS[2]], asr, lang="en",
                                                    max_new_tokens=EVAL_NEW_TOKENS)
        del m
    if wers[str(device)].per_utterance != wers["cpu"].per_utterance:
        raise AssertionError(f"evaluate_tts_wer: card {wers[str(device)]} host {wers['cpu']}")
    # every wav read, round trip and synthesis row, one by one, on both
    levels = {}
    for dev, kinds in audio.items():
        side = "host" if dev == "cpu" else "card"
        for kind in ("read", "round_trip", "synthesis"):
            if not kinds.get(kind):
                raise AssertionError(f"evaluation: no {kind} audio recorded on {dev}")
            rows = [unclamped(f"evaluation {kind} {i} on the {side}", audio_levels(w))
                    for i, w in enumerate(kinds[kind])]
            levels[f"{kind}_{side}_rms"] = [f"{r['audio_rms']:.4g}" for r in rows]
            levels[f"{kind}_{side}_full_scale_share"] = [r["full_scale_share"] for r in rows]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    line("evaluation", talker=f"0.6B widths, {EVAL_LAYERS} layers" if talker is None else "cut",
         codec="default widths" if codec is None else "cut",
         wavs=EVAL_WAVS, tokenizer_snr_db=nums[("tokenizer_roundtrip", "snr_db")],
         tokenizer_mcd_db=nums[("tokenizer_roundtrip", "mcd_db")],
         clone_speaker_sim=nums[("seed_tts", "speaker_sim")],
         worst_card_vs_host_of_bar=f"{'/'.join(map(str, worst))}:{errs[worst]:.3f}",
         unavailable=unavailable, fake_asr_wer=f"{wers[str(device)].wer:.4f}", **levels,
         write_s=f"{write_s:.1f}", card_s=f"{walls[('custom_voice', str(device))] + walls[('base', str(device))]:.1f}",
         host_s=f"{walls[('custom_voice', 'cpu')] + walls[('base', 'cpu')]:.1f}",
         phase_s=f"{time.time() - phase_t0:.1f}")
    return {"errs": errs}


def phase_flac_native() -> dict:
    """The native FLAC fast path (native/flac_fast.c, built at first use
    into build/native/) against the pure-Python decoder on a FLAC written by
    utils/flac.py: the same samples; both walls."""
    import os

    from qwen3_tts_tpu_torch.utils import flac, native

    t0 = time.time()
    lib = native.flac_fast()
    build_s = time.time() - t0
    if lib is None:
        raise AssertionError("flac_native: the C library did not build")
    os.makedirs("build/flac", exist_ok=True)
    path = "build/flac/clip.flac"
    x = reference_clip(24000)
    flac.write_flac(path, x, 24000)
    t0 = time.time()
    fast, sr = flac.read_flac(path)
    native_s = time.time() - t0
    os.environ["QWEN3_TTS_NO_NATIVE"] = "1"
    try:
        t0 = time.time()
        slow, sr2 = flac.read_flac(path)
        python_s = time.time() - t0
    finally:
        del os.environ["QWEN3_TTS_NO_NATIVE"]
    if not (sr == sr2 == 24000 and np.array_equal(fast, slow)
            and np.abs(slow - x).max() <= 2.0 ** -15):
        raise AssertionError("flac_native: the native and Python paths disagree")
    line("flac_native", library=native.library_path("flac_fast").name, build_s=f"{build_s:.2f}",
         samples=len(fast), seconds_of_audio=len(fast) / sr, equal=True,
         native_s=f"{native_s:.4f}", python_s=f"{python_s:.4f}")
    return {"native_s": native_s, "python_s": python_s}


def run(cfg, device) -> list:
    """Every phase after the build, at talker config `cfg`; returns the
    kernels' JSON rows."""
    probe = phase_probe(device)
    phase_flash_tiles(cfg, device)
    phase_misfit(device)
    t0 = time.time()
    params = model_params(cfg, device)
    line("weights", seconds=f"{time.time() - t0:.1f}",
         gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    model = build_model(params, cfg, device)
    phase_engine_gemm(params, cfg, device)
    sub = phase_subtalker(params, cfg, device)
    # the main path's KV length: the bucketed prompt plus max_new_tokens + 1,
    # rounded up to whole 128-slot chunks
    S_buf = 256
    step = phase_talker_step(params, cfg, device, S_buf)
    cv = phase_slice(model)
    cv8 = phase_slice(model, kv_quant=True, base=cv)
    phase_split(model, "custom voice", lambda: model.generate_custom_voice(
        TEXTS, speaker="vivian", language="english", seed=SEED, max_new_tokens=MAX_NEW_TOKENS))
    phase_graph_ab(model)
    phase_prefill_graphs(model)
    up = model.speech_tokenizer.get_decode_upsample_rate()
    phase_stream("custom voice int8_kv", lambda: _stream(model), lambda: stream_active_frames(
        model, model._specs_custom_voice(TEXTS, "vivian", "english", None, False),
        kv_quant=True, max_new_tokens=MAX_NEW_TOKENS), up, MAX_NEW_TOKENS - 1)
    stream_ab = phase_stream_ab(model)
    phase_codec_graphs(model)
    phase_serve(model)
    phase_serve_routes(model)
    phase_serve_wide(model)
    phase_server_warmup(model)
    phase_serve_trace(model)
    phase_graph_memory(model, stream_ab["codes"])
    phase_warmup(model)
    phase_http(model)
    phase_vocoder_device(model)
    t0 = time.time()
    clone_model = build_clone_model(params, cfg, device)
    line("clone weights", seconds=f"{time.time() - t0:.1f}",
         gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    front = phase_clone_front_end(clone_model)
    # kernel 2's int8-KV mode at the main path's window and the clone call's
    # (its prefill plus max_new_tokens + 1 in 128-slot chunks)
    clone_buf = -(-(front["T"] + CLONE_MAX_NEW_TOKENS + 1) // 128) * 128
    step8 = phase_talker_step_int8(params, cfg, device, [
        (S_buf, S_buf // 2), (clone_buf, front["T"] + CLONE_MAX_NEW_TOKENS // 2)])
    phase_split_attention(params, cfg, device, clone_buf,
                          front["T"] + CLONE_MAX_NEW_TOKENS // 2)
    flash = phase_flash(cfg, device, front)
    phase_prefill_ab(params, cfg, device)
    clone = phase_clone(clone_model, front)
    phase_clone(clone_model, front, kv_quant=True, base=clone)
    prefill_ab(clone_model, clone_model._specs_voice_clone(
        CLONE_TEXTS, "english", None, None, False, front["items"], True)[0], "clone",
        max_new_tokens=CLONE_MAX_NEW_TOKENS)
    phase_split(clone_model, "clone", lambda: clone_model.generate_voice_clone(
        CLONE_TEXTS, language="english", ref_audio=(front["wav"], front["sr"]),
        ref_text=CLONE_REF_TEXT, non_streaming_mode=True, seed=SEED,
        max_new_tokens=CLONE_MAX_NEW_TOKENS))
    phase_stream("voice clone int8_kv", lambda: clone_model.stream_voice_clone(
        CLONE_STREAM_TEXT, language="english", ref_audio=(front["wav"], front["sr"]),
        ref_text=CLONE_REF_TEXT, seed=SEED, kv_quant=True,
        max_new_tokens=CLONE_MAX_NEW_TOKENS), lambda: stream_active_frames(
        clone_model, clone_model._specs_voice_clone(CLONE_STREAM_TEXT, "english", None, None,
                                                    False, front["items"], False)[0],
        kv_quant=True, max_new_tokens=CLONE_MAX_NEW_TOKENS), up, CLONE_MAX_NEW_TOKENS - 1)
    phase_serve_clone(clone_model, front)
    phase_front_graphs(clone_model, front)
    phase_clone_server_clips(clone_model, front)
    del model, clone_model
    from qwen3_tts_tpu_torch.runtime import graphs

    graphs.clear()   # the decode contexts and vocoder graphs hold the models' weights
    gc.collect()     # servers (engine <-> frame sink cycles) and their serve graphs
    torch.cuda.empty_cache()
    phase_0b6(device)
    phase_v1_graphs(phase_codec25(device)["tokenizer"])
    phase_sft(device)
    phase_sft_graphs(device)
    phase_flac_native()
    phase_parallel(device)
    phase_evaluation(device)
    row8 = next(r for r in step8["rows"] if r["B"] == B_MAIN and r["S_buf"] == S_buf)
    kernels = [
        {"name": "subtalker_frame_fused", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/subtalker.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/subtalker.py:352",
         "launches": cv["launches"]["subtalker"], "max_abs_err": sub["err"],
         "ms": sub["ms"][B_MAIN], "plain_ms": sub["plain_ms"][B_MAIN],
         "bound_ms": sub["bound_ms"], "bound_by": sub["bound_by"], "library_ms": None},
        {"name": "talker_step_fused_cache", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:417",
         "launches": cv["launches"]["talker_step"], "max_abs_err": step["err"],
         "ms": step["ms"][B_MAIN], "plain_ms": step["plain_ms"][B_MAIN],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"], "library_ms": None},
        {"name": "talker_step_fused_cache[int8_kv]", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:417",
         "launches": cv8["launches"]["talker_step_int8_kv"], "max_abs_err": step8["err"],
         "ms": row8["ms"], "plain_ms": row8["plain_ms"], "bound_ms": row8["bound_ms"],
         "bound_by": row8["bound_by"], "library_ms": None},
        {"name": "flash_prefill", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/prefill_attention.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/prefill_attention.py:174",
         "launches": clone["launches"]["flash_prefill"], "max_abs_err": flash["err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]},
    ]
    kernels += [
        {"name": "stream_bw", "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/dma_peak.cu",
         "replaces": "benchmarks/dma_peak.py:109", "launches": probe["launches"]["stream_bw"],
         "max_abs_err": probe["stream_err"], "ms": probe["stream_ms"],
         "plain_ms": probe["stream_plain_ms"], "bound_ms": probe["stream_bound_ms"],
         "bound_by": probe["stream_bound_by"], "library_ms": probe["stream_library_ms"]},
        {"name": "shaped_bw", "route": "cuda", "source": "qwen3_tts_tpu_torch/csrc/dma_peak.cu",
         "replaces": "benchmarks/dma_peak.py:178", "launches": probe["launches"]["shaped_bw"],
         "max_abs_err": probe["shaped_err"], "ms": probe["shaped_ms"],
         "plain_ms": probe["shaped_plain_ms"], "bound_ms": probe["shaped_bound_ms"],
         "bound_by": probe["shaped_bound_by"], "library_ms": None},
    ]
    phase_roofline(cfg, cv, S_buf, probe, kernels, sub)
    return kernels


def main() -> int:
    phase_device()
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7

    phase_build()
    kernels = run(TALKER_1B7, torch.device("cuda"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
