"""A/B of the decode kernels and the flash prefill between checkouts, on one
NVIDIA H100.

    python3 chip_ab.py ROOT [ROOT ...] [--rounds N]

Times `talker_step_fused_cache` of each checkout's `qwen3_tts_tpu_torch`
(built from that checkout's sources) at chip_smoke.py's shapes: B=8 and
B=32 over the main path's 256-slot buffer (slot 128), and B=2 over the
clone call's buffer (a 2304-token prefill plus 49 slots in whole 128-slot
chunks: 2432 slots, slot 2328), with random 1.7B int8 weights from a seed;
bf16 KV and, where the checkout has it, int8 KV. Then
`subtalker_frame_fused`, one sampled frame (top-k 50, temperature 0.9) at
B in {1, 8, 32} (keys `subtalker/B<n>`). Then `flash_prefill` at the clone
call's prefill (B=2, T=2304, starts 24 and 414, q/k/v as views into one
fused qkv tensor, as the prefill hands them over) and at B=4, T=4096
(starts 0/333/1400/3000), bf16 at the 1.7B widths (keys `flash/<shape>`).
Then the frame loop: device ms per frame of `decode_chunk` (8 frames a
call, sampled, both kernels) at B=4 after a 32-token prefill, as CUDA graph
replays where the checkout has them (`loop/graph`, runtime/graphs.py) and
on the eager loop (`loop/eager`).
Each reading is a fresh process of one
checkout (the packages share a name), and each round runs the checkouts
forward then backward (A B B A for two), so drift of the card's clocks
falls on every side alike. Prints every reading, then one JSON line with
each (checkout, mode, shape)'s median, min and max over the rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 0
SHAPES = {"B8_S256": (8, 256, 128), "B32_S256": (32, 256, 128),
          "B2_S2432": (2, 2432, 2328)}   # (B, S_buf, slot)
SUBTALKER_B = (1, 8, 32)
FLASH_SHAPES = {"B2_T2304": (2304, (24, 414)), "B4_T4096": (4096, (0, 333, 1400, 3000))}
LOOP_B, LOOP_T, LOOP_FRAMES = 4, 32, 8


def child(root: str) -> None:
    """Time one checkout: the mean device ms of 20 launches after a warm-up,
    the median of 5 such repeats, per (mode, shape)."""
    sys.path.insert(0, os.path.abspath(root))
    import inspect

    import numpy as np
    import torch

    import qwen3_tts_tpu_torch
    from qwen3_tts_tpu_torch.ops.cuda import build
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache as step
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7 as cfg
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.weights import quantize_talker_params

    if not qwen3_tts_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {qwen3_tts_tpu_torch.__file__}, not the one under {root}")
    build.load_library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = quantize_talker_params(random_talker_params(cfg, gen, dtype=torch.bfloat16))
    modes = ["bf16"] + (["int8"] if "k_scale" in inspect.signature(step).parameters else [])
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim

    def cuda_ms(fn, iters=20):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    out = {}
    for shape, (B, S, ci) in SHAPES.items():
        k, v = ((torch.randn((L, B, Hkv, S, D), generator=gen, device=dev) * 0.5)
                .to(torch.bfloat16) for _ in range(2))
        slot = torch.arange(S, device=dev)[None, :]
        start = torch.randint(0, 4, (B, 1), generator=gen, device=dev)
        valid = (slot >= start) & (slot <= ci)
        embed = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=dev) * 0.3
                 ).to(torch.bfloat16)
        pos = torch.full((B,), ci, dtype=torch.int32, device=dev)
        for mode in modes:
            if mode == "bf16":
                args, kw = (k, v), {}
            else:
                from qwen3_tts_tpu_torch.models.talker import kv_quantize

                (kq, ks), (vq, vs) = kv_quantize(k), kv_quantize(v)
                args, kw = (kq, vq), dict(k_scale=ks, v_scale=vs)
            reps = [cuda_ms(lambda: step(params, cfg, embed, pos, ci, valid, *args, **kw))
                    for _ in range(5)]
            out[f"{mode}/{shape}"] = float(np.median(reps))
        del k, v
        torch.cuda.empty_cache()
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused as frame
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams, gumbel_noise

    cp, cp_cfg = params["code_predictor"], cfg.code_predictor_config
    Qm1, V = cp["lm_heads"].shape[:2]
    sampled = SamplingParams(do_sample=True, top_k=50, temperature=0.9)
    for B in SUBTALKER_B:
        h, c0 = ((torch.randn((B, 1, cfg.hidden_size), generator=gen, device=dev) * 0.5)
                 .to(torch.bfloat16) for _ in range(2))
        g = gumbel_noise((Qm1, B, V), gen, dev)
        reps = [cuda_ms(lambda: frame(cp, cp_cfg, h, c0, sampled, gumbel=g))
                for _ in range(5)]
        out[f"subtalker/B{B}"] = float(np.median(reps))
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import flash_prefill

    Hq = cfg.num_attention_heads
    for shape, (T, starts) in FLASH_SHAPES.items():
        qkv = torch.randn((len(starts), T, (Hq + 2 * Hkv) * D), generator=gen, device=dev
                          ).to(torch.bfloat16)
        q, k, v = (x.unflatten(-1, (-1, D)) for x in qkv.split([Hq * D, Hkv * D, Hkv * D], -1))
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        reps = [cuda_ms(lambda: flash_prefill(q, k, v, start)) for _ in range(5)]
        out[f"flash/{shape}"] = float(np.median(reps))
    out.update(loop_ms(params, cfg, gen, dev))
    print(json.dumps(out), flush=True)


def loop_ms(params, cfg, gen, dev) -> dict:
    """Device ms per frame of decode_chunk, graphed (where the checkout has
    runtime/graphs.py) and eager: the median of 5 chunks after one that
    captures."""
    import contextlib

    import numpy as np
    import torch

    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
    from qwen3_tts_tpu_torch.runtime import generate as G

    try:
        from qwen3_tts_tpu_torch.runtime import graphs
    except ImportError:
        graphs = None
    sp = SamplingParams(do_sample=True, top_k=50, temperature=0.9)
    gcfg = G.GenerationConfig(max_new_tokens=128, sampling=sp, subtalker=sp,
                              fused_subtalker=True, fused_talker_step=True)
    B, T, H, K = LOOP_B, LOOP_T, cfg.hidden_size, LOOP_FRAMES

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device=dev) * 0.3).to(torch.bfloat16)

    embeds, trailing, pad = rnd(B, T, H), rnd(B, 16, H), rnd(1, 1, H)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    modes = {"loop/eager": graphs.eager if graphs else contextlib.nullcontext}
    if graphs:
        modes["loop/graph"] = contextlib.nullcontext
    out = {}
    for key, ctx in modes.items():
        with ctx(), torch.no_grad():
            g = torch.Generator(device=dev).manual_seed(SEED)
            state, const = G.init_decode_state(params, cfg, gcfg, embeds, mask, trailing, pad,
                                               g, G.kv_capacity(gcfg, T))
            state = G.decode_chunk(params, cfg, gcfg, const, state, K, g)[0]
            reps = []
            for _ in range(5):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda.synchronize()
                a.record()
                state = G.decode_chunk(params, cfg, gcfg, const, state, K, g)[0]
                b.record()
                torch.cuda.synchronize()
                reps.append(a.elapsed_time(b) / K)
        out[key] = float(np.median(reps))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.roots[0])
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    readings = {root: {} for root in a.roots}
    for r in range(a.rounds):
        for root in a.roots + a.roots[::-1]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                   os.path.abspath(root)],
                                  capture_output=True, text=True, cwd=os.path.abspath(root))
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"{root}: exit {proc.returncode}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(f"round {r} {root} {got}", flush=True)
            for key, ms in got.items():
                readings[root].setdefault(key, []).append(ms)
    import statistics

    summary = {root: {key: {"median": statistics.median(v), "min": min(v), "max": max(v),
                            "n": len(v)} for key, v in rows.items()}
               for root, rows in readings.items()}
    print(json.dumps({"device": smi, "ab": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
