"""Measure the card's ACHIEVABLE device-memory read rate.

Counterpart of `benchmarks/dma_peak.py`, with its probes, knobs and sweep,
on the hand-written kernels of csrc/dma_peak.cu
(`ops/cuda/dma_peak.py`):

  1. pure-stream: one big int8 buffer read in blocks of `block_mb`
     contiguous bytes (the bytes one step of a block streams), reduced to
     1024 per-lane column sums;
  2. kernel-shaped: the talker step's per-step fetch set (one (Wr, H) int8
     weight block per layer, a K and a V chunk of (B, Hkv, Sc, D) bf16 in
     the cache's (L, B, Hkv, S_buf, D) layout, or chunk-major with
     `contiguous_kv`, two (1, 1, H) f32 vectors);
  3. torch-reduce: PyTorch's own int8 -> f32 sum over shifted windows of
     the same bytes, the library's rate as a yardstick.

Timing: every probe reads its data P times inside one launch, timed with
CUDA events at two pass counts; the rate comes from the slope
(t(P2) - t(P1)) / ((P2 - P1) * bytes), which cancels the constant launch
overhead. Data is random from a seed (a wrong index cannot hide).

    python -m qwen3_tts_tpu_torch.utils.dma_peak

runs on the card and prints GB/s for each. Env: DMA_GB gigabytes per pass
(default 2), DMA_REPS (default 3), DMA_P1/DMA_P2 pass counts (default
2/10). On CPU tensors (`device="cpu"`) the plain twins run, timed by the
host clock: a check of the arithmetic, not a rate.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..ops.cuda.dma_peak import LANES, shaped_sum, stream_sum

REPS = int(os.environ.get("DMA_REPS", "3"))
P1 = int(os.environ.get("DMA_P1", "2"))
P2 = int(os.environ.get("DMA_P2", "10"))
DMA_GB = float(os.environ.get("DMA_GB", "2"))
SEED = 0


def _time(fn: Callable[[], object], device) -> float:
    """Best of REPS seconds of fn() after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(REPS):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _slope_bw(build: Callable[[int], Callable[[], object]], bytes_per_pass: int,
              device="cuda", time_fn: Optional[Callable] = None) -> float:
    """GB/s from the time slope between P1 and P2 passes (the constant
    per-launch overhead cancels); `build(P)` returns the call for P passes,
    `time_fn(fn, device)` its seconds (default `_time`)."""
    time_fn = time_fn or _time
    t1 = time_fn(build(P1), device)
    t2 = time_fn(build(P2), device)
    dt = max(t2 - t1, 1e-9)
    return (P2 - P1) * bytes_per_pass / dt / 1e9


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def stream_shape(total_bytes: int, block_mb: float) -> Tuple[int, int]:
    """(rows, block_rows) of the (rows, 1024) int8 stream buffer: whole
    blocks of block_mb MB (rows a multiple of 8), as benchmarks/dma_peak.py
    sizes it."""
    rows_total = total_bytes // LANES
    block_rows = max(8, (int(block_mb * 1e6) // LANES) // 8 * 8)
    n = max(1, rows_total // block_rows)
    return n * block_rows, block_rows


def stream_input(rows: int, device="cuda", seed: int = SEED) -> torch.Tensor:
    return torch.randint(-128, 128, (rows, LANES), dtype=torch.int8, device=device,
                         generator=_generator(device, seed))


def stream_bw(total_bytes: int, block_mb: float, device="cuda") -> Tuple[float, int]:
    """(GB/s, bytes per pass) of the pure-stream probe."""
    rows, block_rows = stream_shape(total_bytes, block_mb)
    x = stream_input(rows, device)
    return _slope_bw(lambda P: lambda: stream_sum(x, P, block_rows), x.nbytes,
                     device), x.nbytes


def shaped_inputs(L=28, B=32, Hkv=8, Sc=128, S_buf=256, D=128, Wr=4096, H=2048,
                  contiguous_kv=False, device="cuda", seed: int = SEED) -> tuple:
    """(w, k, v, s1, s2, nS): random inputs of the kernel-shaped probe."""
    gen = _generator(device, seed)
    nS = S_buf // Sc
    kv_shape = (L * nS, B, Hkv, Sc, D) if contiguous_kv else (L, B, Hkv, S_buf, D)
    w = torch.randint(-128, 128, (L, Wr, H), dtype=torch.int8, device=device, generator=gen)
    k, v = (torch.randn(kv_shape, dtype=torch.bfloat16, device=device, generator=gen)
            for _ in range(2))
    s1, s2 = (torch.randn((L, 1, H), dtype=torch.float32, device=device, generator=gen)
              for _ in range(2))
    return w, k, v, s1, s2, nS


def shaped_bw(L=28, B=32, Hkv=8, Sc=128, S_buf=256, D=128, Wr=4096, H=2048,
              contiguous_kv=False, device="cuda") -> Tuple[float, int]:
    """(GB/s, bytes per pass) of the kernel-shaped probe. Bytes per pass:
    each weight block once per layer (the kernel multiplies by the nS
    chunks instead of reading it again), each KV chunk once, the vectors
    once per layer."""
    w, k, v, s1, s2, nS = shaped_inputs(L, B, Hkv, Sc, S_buf, D, Wr, H, contiguous_kv,
                                        device)
    moved = sum(t.nbytes for t in (w, k, v, s1, s2))
    return _slope_bw(lambda P: lambda: shaped_sum(w, k, v, s1, s2, P, nS, contiguous_kv),
                     moved, device), moved


def torch_reduce_bw(total_bytes: int, device="cuda") -> Tuple[float, int]:
    """(GB/s, bytes per pass) of PyTorch's own int8 -> f32 sum over shifted
    windows (each pass reads another (rows, 1024) window, so no pass is a
    copy of the last)."""
    rows = total_bytes // LANES

    def build(P):
        x = stream_input(rows + P, device)

        def fn():
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(P):
                acc += x[i:i + rows].sum(dtype=torch.float32)
            return acc

        return fn

    return _slope_bw(build, rows * LANES, device), rows * LANES


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def sweep(device="cuda") -> List[Dict]:
    """The main() sweep: pure-stream at blocks of 2/4/8/16 MB, kernel-shaped
    at S_buf 256/1024 strided and contiguous, then torch-reduce. One dict
    per reading: probe, its knobs, gbps, bytes (per pass)."""
    total = int(DMA_GB * 1e9)
    out = []
    for mb in (2, 4, 8, 16):
        bw, nb = stream_bw(total, mb, device)
        out.append({"probe": "pure-stream", "block_mb": mb, "gbps": bw, "bytes": nb})
        _free(device)
    for S_buf in (256, 1024):
        for contig in (False, True):
            bw, nb = shaped_bw(S_buf=S_buf, contiguous_kv=contig, device=device)
            out.append({"probe": "kernel-shaped", "S_buf": S_buf,
                        "kv": "contig" if contig else "strided", "gbps": bw, "bytes": nb})
            _free(device)
    bw, nb = torch_reduce_bw(total, device)
    out.append({"probe": "torch-reduce", "gbps": bw, "bytes": nb})
    _free(device)
    return out


def describe(r: Dict) -> str:
    """One printed line of a sweep reading, as benchmarks/dma_peak.py prints it."""
    if r["probe"] == "pure-stream":
        tag = f"pure-stream block={r['block_mb']:>3} MB"
    elif r["probe"] == "kernel-shaped":
        tag = f"kernel-shaped S={r['S_buf']:4d} kv={r['kv']}"
    else:
        tag = "torch-reduce"
    return f"{tag}: {r['gbps']:7.1f} GB/s ({r['bytes'] / 1e9:.2f} GB/pass)"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dma_peak: CUDA is not available (the probes measure the card)")
    print(f"platform=cuda device={torch.cuda.get_device_name(0)} passes={P1}->{P2}",
          flush=True)
    for r in sweep():
        print(describe(r), flush=True)


if __name__ == "__main__":
    main()
