"""Where the time of the port's calls goes on one NVIDIA H100.

    python3 chip_profile.py [--stages | --sft | --sft-mix | --v1 | --vocoder-device]

Builds the kernels and the same in-memory 1.7B int8 models as chip_smoke.py
(random weights from its seed), then prints:
1. each kernel's registers, shared memory and spills, as ptxas reports them;
2. the host wall of the voice-clone call's parts (prompt creation, the
   prefill on the flash and on the dense route);
3. torch.profiler over one voice-clone call (bf16 and int8 KV), one
   custom-voice call, one int8-KV custom-voice stream and one int8-KV
   serving run (chip_smoke's 12 requests over 8 slots), the last three with
   the frame loop as CUDA graph replays and again on the eager loop
   (`runtime/graphs.py` `eager()`): device time by kernel (top rows) and
   the busy share (device kernel time over the unprofiled wall of the same
   call); the custom-voice call's tick (wall over the longest row's frames)
   and RTF, graphed and eager; each call's Chrome trace goes to
   build/traces/<call>/trace.json (`utils/profiling.py` `device_trace`).

4. the decode kernels' stages: the kernel library built once more with
   -DENG_PROFILE, in which block 0 notes the SM clock after each part of a
   stage (csrc/common.cuh `ENG_MARK`); one sub-talker frame at B=8 and one
   talker step at B=8 over 256 slots and at B=2 over the clone window:
   mean microseconds per layer of each quantiser (with the grid barrier
   and the copy of the int8 rows that follow it), GEMM stage, attention
   and grid barrier, and of the sub-talker's projection, lm head and
   sampling per step (`--stages` runs this part alone).

`--sft` instead profiles the SFT step at 1.7B in bf16 (chip_smoke's `sft`
phase shapes: B=2, T=256, grad_accum 2, the speaker encoder), as captured
graphs (the default route: one replay per mini-step) and inside
`graphs.eager()`, in the order graph, eager, eager, graph in one process:
the ms of an optimizer cycle, then torch.profiler over one cycle of each
route: device time and launches by kind of kernel (GEMMs, the attention's
softmax, the optimizer's fused multi-tensor kernels, the rest as
elementwise), the top kernels and the busy share.

`--sft-mix` runs `sft.main` at 1.7B on utterances of mixed length (several
64-token buckets, shuffled), graphed, graphed with a bound of 8 graphs,
and eager: ms per optimizer cycle, captures, the pool and the peak
(`phase_sft_mix`).

`--v1` profiles the 25 Hz tokenizer's decode programs at the released
widths (`CodecV1Config()`, random weights from the seed, in memory): the DiT
sampler on a 10 s clip's shapes (250 codes, a 1000-frame reference mel) as
graph replays and in `graphs.eager()`, and BigVGAN, which runs eagerly, on
its mel: the host wall (median of V1_PROFILE_ITERS), then torch.profiler
over one call of each: device time and launches by kind of kernel
(convolutions, GEMMs, the attention's softmax, the rest as elementwise),
the top kernels and the busy share.

`--vocoder-device` runs chip_smoke's `vocoder_device` phase with its
second-card route only, on a host with two cards or more: the one-card
reference and default servers, then the vocoder on card
1 (codes and PCM16 equal the reference's, no capture after the warm-up),
each with requests/s, audio s per wall s, first-packet p50 / p95 and the
serving card's busy share; on the smoke's mix, then on the serving phase's
(12 requests over 8 slots, half streamed, 64 frames), where the vocoder
takes a third of a one-card server's wall.

A diagnostic beside the smoke; it checks nothing that chip_smoke.py does not.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import subprocess
import sys
import time
from pathlib import Path

import torch

from chip_smoke import (CLONE_MAX_NEW_TOKENS, CLONE_REF_TEXT, CLONE_TEXTS, MAX_NEW_TOKENS,
                        SEED, SERVE_OVERRIDES, SERVE_REQUESTS, SERVE_SLOTS, TEXTS, _rss_mib,
                        build_clone_model, build_model, line, model_params, phase_build,
                        phase_clone_front_end, phase_device, phase_vocoder_device, serve_all,
                        wall_ms)
from qwen3_tts_tpu_torch.utils.profiling import device_trace

# one Chrome trace per profiled call (build/ is not committed)
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"


def phase_ptxas() -> None:
    """Registers, shared memory and spills of every kernel, as ptxas reports
    them for the sources the library is built from."""
    import re
    import tempfile

    from qwen3_tts_tpu_torch.ops.cuda import build

    for name in build.SOURCES:
        if not name.endswith(".cu"):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c", "-Xptxas", "-v",
                                   "-o", f"{tmp}/x.o", str(build.CSRC / name)],
                                  capture_output=True, text=True, check=True)
        kernel = None
        for row in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", row)
            if m:
                kernel = m.group(1)
            elif "spill" in row or "registers" in row:
                print(f"  [ptxas {name}] {kernel}: {row.split(':', 1)[-1].strip()}", flush=True)


def phase_profile(model, front, custom_voice_model) -> None:
    """Where the time of one call goes: host wall of the clone call's parts, then torch.profiler over one clone call and one
    custom-voice call: device time by kernel (top rows) and the busy share
    (device kernel time over the unprofiled wall of the same call)."""
    from qwen3_tts_tpu_torch.models.talker import KVCache, talker_prefill
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    def wall(fn, n=3):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            out.append(round(time.time() - t0, 4))
        return out

    ref = (front["wav"], front["sr"])
    tc = model.config.talker_config
    with torch.no_grad():
        items = model.create_voice_clone_prompt(ref, ref_text=CLONE_REF_TEXT)
        specs, _ = model._specs_voice_clone(CLONE_TEXTS, "english", None, None, False,
                                            items, True)
        embeds, mask, _, _ = assemble_prompt_specs(model.talker_params, tc, model.config,
                                                   specs, bucket=32)

        def prefill(allow_flash):
            B, T = mask.shape
            cache = KVCache.zeros(tc.num_hidden_layers, B, T + CLONE_MAX_NEW_TOKENS + 1,
                                  tc.num_key_value_heads, tc.resolved_head_dim,
                                  device=embeds.device)
            talker_prefill(model.talker_params, tc, embeds, mask, cache,
                           allow_flash=allow_flash)

        line("profile clone parts",
             create_voice_clone_prompt_s=wall(lambda: model.create_voice_clone_prompt(
                 ref, ref_text=CLONE_REF_TEXT)),
             prefill_flash_s=wall(lambda: prefill(True)),
             prefill_dense_s=wall(lambda: prefill(False)))
    kw = dict(language="english", ref_audio=ref, ref_text=CLONE_REF_TEXT,
              non_streaming_mode=True, seed=SEED)
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.runtime.server import TTSServer

    def server():
        return TTSServer(custom_voice_model, num_slots=SERVE_SLOTS, overrides=SERVE_OVERRIDES,
                         max_new_tokens=MAX_NEW_TOKENS, seed=SEED)

    srv = server()
    with graphs.eager():   # an engine takes its route when it is built
        srv_eager = server()
    runs = iter(range(10**6))

    def serve(srv):
        n = next(runs)
        serve_all(srv, [lambda i=i: srv.submit_custom_voice(
            f"{n}-{i}", text=f"{TEXTS[i % len(TEXTS)]} Request {i}.", speaker="vivian",
            language="english", stream=i % 2 == 0) for i in range(SERVE_REQUESTS)])

    def custom_voice():
        return custom_voice_model.generate_custom_voice(
            TEXTS, speaker="vivian", language="english", seed=SEED,
            max_new_tokens=MAX_NEW_TOKENS)

    def stream():
        return list(custom_voice_model.stream_custom_voice(
            TEXTS, speaker="vivian", language="english", seed=SEED, kv_quant=True,
            max_new_tokens=MAX_NEW_TOKENS))

    def eager(fn):
        def run():
            with graphs.eager():
                return fn()
        return run

    calls = {
        "clone": lambda: model.generate_voice_clone(
            CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS, **kw),
        "clone int8_kv": lambda: model.generate_voice_clone(
            CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS, kv_quant=True, **kw),
        "custom_voice": custom_voice,
        "custom_voice eager": eager(custom_voice),
        "stream custom_voice int8_kv": stream,
        "stream custom_voice int8_kv eager": eager(stream),
        "serve custom_voice int8_kv": lambda: serve(srv),
        "serve custom_voice int8_kv eager": eager(lambda: serve(srv_eager)),
    }
    unprofiled = {}
    for name, fn in calls.items():
        walls = wall(fn, 2)
        unprofiled[name] = min(walls)
        # no `annotate` around the call: a record_function range comes back
        # among the CUDA events (a device-side annotation as long as the
        # call) and would count as kernel time
        with device_trace(str(TRACE_DIR / name.replace(" ", "_"))) as prof:
            fn()
        kernels = {}
        for e in prof.events():
            # a record_function range (AdamW's "Optimizer.step#AdamW.step")
            # shows on the device's timeline too: it is no kernel
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("Optimizer.")
                    and not getattr(e, "is_user_annotation", False)):
                k = kernels.setdefault(e.name[:60], [0.0, 0])
                k[0] += e.device_time / 1e3
                k[1] += 1
        total = sum(t for t, _ in kernels.values())
        line(f"profile {name}", unprofiled_wall_s=walls, device_kernel_ms=f"{total:.1f}",
             busy_share=f"{total / 1e3 / min(walls):.3f}")
        for kname, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
            print(f"  {t:9.2f} ms {n:6d} launches  {kname}", flush=True)
    wavs, sr = custom_voice()
    up = custom_voice_model.speech_tokenizer.get_decode_upsample_rate()
    frames, audio_s = max(w.shape[0] for w in wavs) // up, sum(w.shape[0] for w in wavs) / sr
    line("profile custom_voice tick", frames=frames,
         **{f"{k}_tick_ms": f"{unprofiled[n] / frames * 1e3:.3f}"
            for k, n in (("graph", "custom_voice"), ("eager", "custom_voice eager"))},
         **{f"{k}_rtf": f"{unprofiled[n] / audio_s:.4f}"
            for k, n in (("graph", "custom_voice"), ("eager", "custom_voice eager"))})


def phase_engine_stages(params, cfg, device) -> None:
    """Where a launch of each persistent decode kernel spends its time, by
    the clock marks of block 0 (a build with -DENG_PROFILE; the marks cost a
    clock read each, so the sums run a few percent over the plain kernels')."""
    import ctypes

    import numpy as np

    from chip_smoke import decode_state
    from qwen3_tts_tpu_torch.ops.cuda import build
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams, gumbel_noise

    plain_flags = build.NVCC_FLAGS
    build.NVCC_FLAGS = plain_flags + ("-DENG_PROFILE",)
    build.load_library.cache_clear()
    try:
        lib = build.load_library()
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])

        def marks(fn):
            fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
            buf, n = np.zeros(4096, dtype=np.int64), ctypes.c_int()
            build.check(lib, fn(buf.ctypes.data, ctypes.byref(n)), "clock marks")
            return buf[:n.value]

        def show(name, parts, rows):
            us = np.diff(rows, axis=1) / mhz
            line(name, **{p: f"{v:.2f}" for p, v in zip(parts, us.mean(0))},
                 total_us=f"{us.sum(1).mean():.2f}")

        names = ["quant_in", "gemm_qkv", "barrier_1", "attention", "barrier_2", "quant_o",
                 "gemm_o", "barrier_3", "quant_mlp", "gemm_gate_up", "barrier_4"]
        gen = torch.Generator(device=device).manual_seed(SEED + 20)
        cp, cp_cfg = params["code_predictor"], cfg.code_predictor_config
        Qm1, V = cp["lm_heads"].shape[:2]
        B = 8
        h, c0 = ((torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.5)
                 .to(torch.bfloat16) for _ in range(2))
        g = gumbel_noise((Qm1, B, V), gen, device)
        sampled = SamplingParams(do_sample=True, top_k=50, temperature=0.9)
        for _ in range(3):
            subtalker_frame_fused(cp, cp_cfg, h, c0, sampled, gumbel=g)
        marks(lib.qt_subtalker_clock)
        subtalker_frame_fused(cp, cp_cfg, h, c0, sampled, gumbel=g)
        m = marks(lib.qt_subtalker_clock)
        # a position: stage x, the projection; 5 layers of 15 marks; from the
        # second on: final norm, lm head, barrier, sampling, barrier
        L, per, head, tail = cp_cfg.num_hidden_layers, 15, 2, 5
        first = head + L * per
        pos = [m[:first]] + [m[first + i * (first + tail):first + (i + 1) * (first + tail)]
                             for i in range(Qm1)]
        show(f"stages sub-talker B={B}, us per layer (of {L * (Qm1 + 1)})",
             names + ["quant_down", "gemm_down", "barrier_5"],
             np.stack([p[head + per * li:head + per * (li + 1)] for p in pos for li in range(L)]))
        show(f"stages sub-talker B={B}, us per step after the layers",
             ["final_norm", "lm_head", "barrier", "sampling", "barrier_2"],
             np.stack([p[first - 1:] for p in pos[1:]]))
        show(f"stages sub-talker B={B}, us per position before the layers",
             ["stage_x", "projection", "barrier_and_quant_in"],
             np.stack([np.concatenate([pos[i][-1:], pos[i + 1][:head + 1]])
                       for i in range(Qm1)]))
        line(f"stages sub-talker B={B}", frame_us=f"{(m[-1] - m[0]) / mhz:.1f}", marks=len(m))
        nseg = 6
        for B, S_buf, ci in ((8, 256, 128), (2, 2432, 2328)):
            k, v, kv_valid, embed, position = decode_state(cfg, B, S_buf, ci, device, gen)
            for _ in range(3):
                talker_step_fused_cache(params, cfg, embed, position, ci, kv_valid, k, v)
            marks(lib.qt_talker_clock)
            talker_step_fused_cache(params, cfg, embed, position, ci, kv_valid, k, v)
            m = marks(lib.qt_talker_clock)
            # block 0 runs one attention item a layer at these shapes: 2 more marks
            parts = (names[:3] + ["attention_prepare", "attention_chunks", "attention_fold"]
                     + names[4:] + [f"{a}_{c}" for c in range(nseg)
                                    for a in ("quant_down", "gemm_down")] + ["barrier_5"])
            per = len(parts) + 1
            show(f"stages talker step B={B} S={S_buf}, us per layer (of {len(m) // per})",
                 parts, m[:len(m) // per * per].reshape(-1, per))
            line(f"stages talker step B={B} S={S_buf}", step_us=f"{(m[-1] - m[0]) / mhz:.1f}",
                 marks=len(m))
            del k, v
            torch.cuda.empty_cache()
    finally:
        build.NVCC_FLAGS = plain_flags
        build.load_library.cache_clear()


SFT_KINDS = (   # (kind, substrings of a kernel's name), first match wins
    ("optimizer", ("multi_tensor_apply", "foreach", "adam", "lpnorm")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "wgmma")),
    ("attention", ("softmax",)),
)


V1_KINDS = (    # the 25 Hz decode's programs: cuDNN's convolutions, then as SFT_KINDS
    ("conv", ("conv", "cudnn", "implicit", "winograd", "fft")),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "wgmma")),
    ("attention", ("softmax",)),
)


def kernel_kind(name: str, kinds=SFT_KINDS) -> str:
    low = name.lower()
    return next((k for k, subs in kinds if any(x in low for x in subs)), "elementwise")


def device_kernels(prof, kinds=SFT_KINDS) -> tuple:
    """({kernel name: [device ms, launches]}, {kind: [device ms, launches]})
    of a profiled run."""
    kernels, by_kind = {}, {}
    for e in prof.events():
        # a record_function range (AdamW's "Optimizer.step#AdamW.step")
        # shows on the device's timeline too: it is no kernel
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("Optimizer.")
                and not getattr(e, "is_user_annotation", False)):
            for d, k in ((kernels, e.name[:60]), (by_kind, kernel_kind(e.name, kinds))):
                row = d.setdefault(k, [0.0, 0])
                row[0] += e.device_time / 1e3
                row[1] += 1
    return kernels, by_kind


def print_profile(label: str, prof, wall: float, kinds=SFT_KINDS, top: int = 12, **kw) -> None:
    kernels, by_kind = device_kernels(prof, kinds)
    total = sum(t for t, _ in kernels.values())
    line(label, **kw, wall_ms=f"{wall:.1f}", device_kernel_ms=f"{total:.1f}",
         busy_share=f"{total / wall:.3f}",
         **{f"{k}_ms": f"{t:.1f}" for k, (t, _) in sorted(by_kind.items())},
         **{f"{k}_launches": n for k, (_, n) in sorted(by_kind.items())})
    for kname, (t, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t:9.2f} ms {n:6d} launches  {kname}", flush=True)


def phase_sft_profile(device) -> None:
    """SFT cycles graphed and eager, then one profiled cycle of each (see
    the module docstring)."""
    import numpy as np

    from chip_smoke import SFT_ACCUM, SFT_B, SFT_T, reference_clip, sft_batch
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.finetune import train
    from qwen3_tts_tpu_torch.models.speaker_encoder import speaker_encoder_forward
    from qwen3_tts_tpu_torch.ops.stft import mel_spectrogram
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.testing import (TALKER_1B7, random_talker_params,
                                                   speaker_encoder_state)
    from qwen3_tts_tpu_torch.weights import from_jax_tree, map_tensors

    cfg = TALKER_1B7
    spk_cfg = SpeakerEncoderConfig(enc_dim=cfg.hidden_size)
    spk_params = map_tensors(from_jax_tree(speaker_encoder_state(spk_cfg, SEED + 12), device),
                             lambda t: t.to(torch.bfloat16))
    ref_mel = mel_spectrogram(torch.from_numpy(reference_clip(24000)[None, :3 * 24000]),
                              n_fft=1024, num_mels=128, sampling_rate=24000, hop_size=256,
                              win_size=1024, fmin=0, fmax=12000).permute(0, 2, 1).numpy()
    rng = np.random.default_rng(SEED + 11)
    tts_cfg = TTSModelConfig(talker_config=cfg, speaker_encoder_config=spk_cfg)
    batches = [sft_batch(tts_cfg, rng, SFT_T, SFT_B, ref_mel) for _ in range(SFT_ACCUM)]
    params = train.trainable(random_talker_params(
        cfg, torch.Generator(device=device).manual_seed(SEED + 13), dtype=torch.bfloat16))
    step = train.make_train_step(cfg, train.default_optimizer(params, lr=2e-5,
                                                              grad_accum=SFT_ACCUM))

    def cycle():
        for b in batches:
            tb = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            with torch.no_grad():
                spk = speaker_encoder_forward(spk_params, spk_cfg,
                                              tb.pop("ref_mels").to(torch.bfloat16))
            step(params, tb, spk)

    def route(name):
        return graphs.eager() if name == "eager" else contextlib.nullcontext()

    cycle()   # the graphs' captures
    walls = {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        with route(name):
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.time()
                cycle()
                torch.cuda.synchronize()
                walls[name].append(1e3 * (time.time() - t0))
    for name, ms in walls.items():
        line("sft cycles", route=name, ms_per_cycle=f"{np.median(ms):.1f}",
             cycles_ms=[f"{x:.1f}" for x in ms])
    for name in ("graph", "eager"):
        with route(name):
            with device_trace(str(TRACE_DIR / f"sft_cycle_{name}")) as prof:
                cycle()
        print_profile("profile sft cycle", prof, float(np.median(walls[name])), route=name)


V1_PROFILE_ITERS = 5           # unprofiled calls of each 25 Hz program and route
V1_PROFILE_CODES = 250         # a 10 s clip at 25 Hz


def phase_v1_profile(device) -> None:
    """The 25 Hz decode's two programs, the DiT graphed and eager and
    BigVGAN eager, then profiled (see the module docstring)."""
    from qwen3_tts_tpu_torch.config import CodecV1Config
    from qwen3_tts_tpu_torch.models.codec25 import bigvgan, dit
    from qwen3_tts_tpu_torch.models.codec25.encoder import tokenizer_fp32
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.testing import codec_v1_state
    from qwen3_tts_tpu_torch.weights import from_jax_tree, unflatten_state_dict

    cfg = CodecV1Config()
    dcfg, bcfg = cfg.dit_config, cfg.bigvgan_config
    tree = from_jax_tree(unflatten_state_dict(codec_v1_state(cfg, SEED + 8)), device)
    tokenizer_fp32()
    gen = torch.Generator(device=device).manual_seed(SEED)
    n = V1_PROFILE_CODES
    codes = torch.randint(0, dcfg.num_embeds, (1, n), device=device, generator=gen)
    xv = torch.nn.functional.normalize(
        torch.randn((1, dcfg.enc_emb_dim), device=device, generator=gen), dim=-1)
    ref = torch.randn((1, 4 * n, dcfg.mel_dim), device=device, generator=gen)
    noise = torch.randn((1, n * dcfg.repeats, dcfg.mel_dim), device=device, generator=gen)
    mel = {}
    programs = {
        "dit": (lambda: dit.dit_sample(tree["decoder"]["dit"], dcfg, codes, xv, ref, noise),
                ("graph", "eager")),
        "bigvgan": (lambda: bigvgan.bigvgan_forward(tree["decoder"]["bigvgan"], bcfg,
                                                    mel["dit"]), ("eager",)),
    }
    with torch.no_grad():
        for name, (fn, routes) in programs.items():
            for _ in range(2):   # the DiT's step is captured by the second call
                mel[name] = fn()
            for route in routes:
                with graphs.eager() if route == "eager" else contextlib.nullcontext():
                    wall, _ = wall_ms(fn, V1_PROFILE_ITERS)
                    with device_trace(str(TRACE_DIR / f"v1_{name}_{route}")) as prof:
                        fn()
                print_profile(f"profile v1 {name}", prof, wall, V1_KINDS, top=10, route=route)
    del tree, programs
    graphs.clear(device)
    gc.collect()
    torch.cuda.empty_cache()


SFT_MIX_ROWS = 128             # utterances of the mixed-length run (64 mini-steps at B=2)
SFT_MIX_SECONDS = (1.0, 20.0)  # their durations, uniform
SFT_MIX_TOKENS_PER_S = 3.5     # text tokens per second of speech
SFT_MIX_ACCUM = 4              # sft.main's default grad_accum (the reference recipe's)
SFT_MIX_DIR = Path(__file__).resolve().parent / "build" / "sft_mix"


def phase_sft_mix(device) -> None:
    """`sft.main` end to end at TALKER_1B7 (bf16 base checkpoint written
    under build/, the speaker encoder, B=2, grad_accum SFT_MIX_ACCUM, one
    epoch) on SFT_MIX_ROWS utterances of SFT_MIX_SECONDS (12.5 codec frames
    and SFT_MIX_TOKENS_PER_S text tokens a second, one stand-in id per
    token, plus the chat template), which `sft.main` shuffles and pads to
    multiples of 64 tokens: several (B, T) keys, as a real dataset gives.
    Three runs in one process, in this order, each from the same base and
    data order: the default route (graphs, MAX_TRAIN_GRAPHS), the same with
    the bound at 8, and inside `graphs.eager()`. Each train step is timed
    with a sync on both sides (`make_train_step` wrapped): ms per
    optimizer cycle over all cycles and over the cycles without a capture,
    padded tokens/s, the captures, the keys the owner held, the pool after
    each capture (max), the run's own peak, the host's RSS growth over the
    run and over each step that captured (the graph's host side)."""
    import json
    import os
    import shutil

    import numpy as np

    from chip_smoke import StandInTokenizer, reference_clip
    from qwen3_tts_tpu_torch.config import SpeakerEncoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.finetune import sft, train
    from qwen3_tts_tpu_torch.runtime import graphs
    from qwen3_tts_tpu_torch.utils.audio import write_wav
    from qwen3_tts_tpu_torch.utils.testing import (TALKER_1B7, random_talker_params,
                                                   speaker_encoder_state)
    from qwen3_tts_tpu_torch.weights import (flatten_state_dict, save_safetensors,
                                             talker_params_to_state_dict)

    cfg = dataclasses.replace(TALKER_1B7, codec_language_id={"english": 1000})
    spk_cfg = SpeakerEncoderConfig(enc_dim=cfg.hidden_size)
    base = SFT_MIX_DIR / "base"
    base.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with open(base / "config.json", "w") as f:
        json.dump(dataclasses.asdict(TTSModelConfig(
            talker_config=cfg, speaker_encoder_config=spk_cfg, tts_model_type="base",
            tts_model_size="1b7")), f)
    sd = talker_params_to_state_dict(random_talker_params(
        cfg, torch.Generator(device=device).manual_seed(SEED + 20), dtype=torch.bfloat16), cfg)
    sd.update(flatten_state_dict(speaker_encoder_state(spk_cfg, SEED + 21), "speaker_encoder"))
    save_safetensors(str(base / "model.safetensors"), sd)
    del sd
    torch.cuda.empty_cache()
    ref = SFT_MIX_DIR / "ref.wav"
    write_wav(str(ref), reference_clip(24000)[:3 * 24000], 24000)
    rng = np.random.default_rng(SEED + 22)
    durations = rng.uniform(*SFT_MIX_SECONDS, SFT_MIX_ROWS)
    with open(SFT_MIX_DIR / "train.jsonl", "w") as f:
        for i, d in enumerate(durations):
            text = "".join(chr(97 + x) for x in rng.integers(0, 26, int(SFT_MIX_TOKENS_PER_S * d) + 1))
            f.write(json.dumps({"text": text, "audio_codes": rng.integers(
                0, cfg.code_predictor_config.vocab_size,
                (int(12.5 * d) + 1, cfg.num_code_groups)).tolist(), "ref_audio": str(ref)}) + "\n")
    line("sft mix data", rows=SFT_MIX_ROWS, seconds=list(SFT_MIX_SECONDS),
         write_s=f"{time.time() - t0:.1f}")

    real = train.make_train_step

    def run(name: str, bound: int, eager: bool) -> None:
        steps, owners = [], []

        def make(cfg_, opt):
            step = real(cfg_, opt)

            def timed(params, batch, spk):
                r0 = _rss_mib()
                torch.cuda.synchronize()
                c0, s0 = graphs.stats(device)["captures"], time.perf_counter()
                m = step(params, batch, spk)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - s0)
                st = graphs.stats(device)
                steps.append((tuple(batch["input_ids"].shape[:2]), ms, st["captures"] - c0,
                              st["pool_bytes"], _rss_mib() - r0))
                if not owners:
                    owners.extend(t for d in graphs._DEVICES.values() for t in d.train
                                  if t.optimizer is opt)
                return m
            return timed

        graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mem0, rss0 = torch.cuda.memory_allocated(), _rss_mib()
        train.make_train_step, old_bound = make, graphs.MAX_TRAIN_GRAPHS
        graphs.MAX_TRAIN_GRAPHS = bound
        out = SFT_MIX_DIR / f"out_{name}"
        t0 = time.time()
        try:
            with graphs.eager() if eager else contextlib.nullcontext():
                sft.main(["--init_model_path", str(base), "--train_jsonl",
                          str(SFT_MIX_DIR / "train.jsonl"), "--output_model_path", str(out),
                          "--batch_size", "2", "--grad_accum", str(SFT_MIX_ACCUM),
                          "--num_epochs", "1", "--speaker_row", "3000", "--device", str(device)],
                         processor=StandInTokenizer(max_ids=None))
        finally:
            train.make_train_step, graphs.MAX_TRAIN_GRAPHS = real, old_bound
        main_s = time.time() - t0
        peak_gib = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        held = len(owners[0].graphs) if owners else 0
        shutil.rmtree(out, ignore_errors=True)
        n = len(steps) // SFT_MIX_ACCUM * SFT_MIX_ACCUM
        cycles = [steps[i:i + SFT_MIX_ACCUM] for i in range(0, n, SFT_MIX_ACCUM)]
        cycle_ms = [sum(s[1] for s in c) for c in cycles]
        clean = [sum(s[1] for s in c) for c in cycles if not any(s[2] for s in c)]
        tokens = sum(b * t for (b, t), *_ in steps[:n])
        Ts = sorted({t for (_, t), *_ in steps})
        line("sft mix", route=name, bound=bound, mini_steps=len(steps), cycles=len(cycles),
             T_buckets=Ts, keys=len({(s[0], i % SFT_MIX_ACCUM == SFT_MIX_ACCUM - 1)
                                     for i, s in enumerate(steps)}),
             captures=sum(s[2] for s in steps), graphs_held=held,
             ms_per_cycle=f"{np.mean(cycle_ms):.1f}",
             ms_per_cycle_without_capture=f"{np.mean(clean):.1f}" if clean else "none",
             cycles_without_capture=len(clean),
             train_s=f"{sum(cycle_ms) / 1e3:.2f}",
             tokens_per_s=f"{tokens / sum(cycle_ms) * 1e3:.0f}",
             pool_mib_max=f"{max(s[3] for s in steps) / 2**20:.1f}",
             pool_mib_by_capture=[f"{s[3] / 2**20:.0f}" for s in steps if s[2]],
             peak_gib=f"{peak_gib:.2f}", rss_growth_mib=f"{_rss_mib() - rss0:.0f}",
             host_mib_by_capture=[f"{s[4]:.0f}" for s in steps if s[2]],
             host_mib_other_steps=f"{sum(s[4] for s in steps if not s[2]):.0f}",
             main_s=f"{main_s:.1f}")

    run("graph", graphs.MAX_TRAIN_GRAPHS, False)
    run("graph_bound8", 8, False)
    run("eager", graphs.MAX_TRAIN_GRAPHS, True)
    graphs.clear()
    shutil.rmtree(SFT_MIX_DIR, ignore_errors=True)


def main() -> int:
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7

    phase_device()
    device = torch.device("cuda")
    if sys.argv[1:] == ["--sft"]:      # the SFT step only (no kernel runs in it)
        phase_sft_profile(device)
        return 0
    if sys.argv[1:] == ["--sft-mix"]:  # sft.main on mixed lengths, graphed and eager
        phase_sft_mix(device)
        return 0
    if sys.argv[1:] == ["--v1"]:       # the 25 Hz decode's programs
        phase_v1_profile(device)
        return 0
    phase_build()
    if sys.argv[1:] == ["--vocoder-device"]:   # the server's vocoder on a second card
        model = build_model(model_params(TALKER_1B7, device), TALKER_1B7, device)
        phase_vocoder_device(model, routes=("c",))
        phase_vocoder_device(model, routes=("c",), mix=dict(
            slots=SERVE_SLOTS, requests=SERVE_REQUESTS,
            streams=tuple(range(0, SERVE_REQUESTS, 2)), frames=MAX_NEW_TOKENS))
        return 0
    if sys.argv[1:] == ["--stages"]:   # the decode kernels' stages only
        phase_engine_stages(model_params(TALKER_1B7, device), TALKER_1B7, device)
        return 0
    phase_ptxas()
    params = model_params(TALKER_1B7, device)
    model = build_model(params, TALKER_1B7, device)
    clone_model = build_clone_model(params, TALKER_1B7, device)
    front = phase_clone_front_end(clone_model)
    phase_profile(clone_model, front, model)
    del model, clone_model
    torch.cuda.empty_cache()
    phase_engine_stages(params, TALKER_1B7, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
