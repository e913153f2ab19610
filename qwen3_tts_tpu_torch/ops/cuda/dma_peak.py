"""Device-memory bandwidth probes: column sums that read every byte once.

Counterparts of the two Pallas kernels of `benchmarks/dma_peak.py`. On a
CUDA tensor `stream_sum` and `shaped_sum` launch the hand-written kernels of
csrc/dma_peak.cu; on a CPU tensor they run the plain twins `stream_sum_ref`
and `shaped_sum_ref`. Any other device raises.

- `stream_sum(x, passes)`: x int8 (rows, 1024) -> (1024,) f32, passes x the
  column sums (`_stream_kernel`).
- `shaped_sum(w, k, v, s1, s2, passes, nS, contiguous_kv)`: the talker
  step's fetch set (`_shaped_kernel`) -> ((128,) f32, (L, H) f32). Per pass
  and per step (layer l, KV chunk c) the JAX kernel adds the first 128
  column sums of w[l], the (D,) lane sums of K and V chunk (l, c) and the
  sums of s1[l] and s2[l]; so out = passes x (nS x sum_l colsum(w[l])[:128]
  + the lane sums of every K and V chunk + nS x sum(s1 + s2)). The second
  output is passes x the column sums of every weight block over all H
  columns, which proves that every weight byte was read.

The twins sum in int64 or float64 and cast to f32 at the end.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import build

LANES = 1024          # the stream probe's row width (int8 bytes)
OUT_LANES = 128       # the shaped probe's output lanes (= D)
ITEM_BYTES = 1 << 19  # ~bytes of one work item of the shaped kernel
_PART_ROWS = 1 << 16  # rows per int64 partial sum in the stream twin


def stream_sum_ref(x: torch.Tensor, passes: int) -> torch.Tensor:
    """(1024,) f32: passes x the int64 column sums of x, int8 (rows, 1024)."""
    acc = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for part in x.split(_PART_ROWS):
        acc += part.sum(0, dtype=torch.int64)
    return (acc * passes).to(torch.float32)


def _kv_chunks(t: torch.Tensor, nS: int, contiguous_kv: bool):
    """The per-layer (or per-chunk) views of a K/V cache the probe reads:
    (L, B, Hkv, S_buf, D) strided, slots [:nS * Sc]; or chunk-major
    (L * nS, B, Hkv, Sc, D)."""
    if contiguous_kv:
        return list(t)
    Sc = t.shape[3] // nS
    return [layer[:, :, :nS * Sc] for layer in t]


def shaped_sum_ref(w: torch.Tensor, k: torch.Tensor, v: torch.Tensor, s1: torch.Tensor,
                   s2: torch.Tensor, passes: int, nS: int,
                   contiguous_kv: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the shaped probe: ((128,) f32, (L, H) f32), in
    int64 / float64."""
    L, _, H = w.shape
    col = torch.stack([w[l].sum(0, dtype=torch.int64) for l in range(L)])   # (L, H)
    kv = torch.zeros(k.shape[-1], dtype=torch.float64, device=w.device)
    for t in (k, v):
        for chunk in _kv_chunks(t, nS, contiguous_kv):
            kv += chunk.double().sum((0, 1, 2))
    vecs = s1.double().sum() + s2.double().sum()
    out = passes * (nS * col[:, :OUT_LANES].sum(0).double() + kv + nS * vecs)
    return out.to(torch.float32), (passes * col).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _max_grid(shaped: bool, device_index: int) -> int:
    """Blocks of the probe kernel that fit on the card at once."""
    import ctypes

    lib = build.load_library()
    grid = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(lib, lib.qt_dma_max_grid(int(shaped), ctypes.byref(grid)),
                    "dma probe occupancy")
    return grid.value


def _grid(items_per_pass: int, shaped: bool, device) -> int:
    """Blocks of a launch: as many as fit on the card, but no more than the
    work items of one pass. The blocks take items in pass order, so the
    items in flight at once span at most one pass and no block reads a byte
    that another block is reading in the pass before (which the L2 would
    serve: on an H100, 16 MB stream blocks, 125 a pass, read at 1.5x the
    card's data-sheet rate when the grid was the card's 264 blocks)."""
    return min(items_per_pass, _max_grid(shaped, device.index))


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (run the twin), True for CUDA, else raise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def stream_sum(x: torch.Tensor, passes: int, block_rows: int = 2048) -> torch.Tensor:
    """(1024,) f32: passes x the column sums of x, int8 (rows, 1024).

    CPU tensors run `stream_sum_ref`; CUDA tensors launch the kernel, which
    reads x `passes` times in one launch, in items of `block_rows` rows (the
    last one ragged), each launch adding one to `stream_sum.launches`."""
    if not _on_cuda("stream_sum", x):
        return stream_sum_ref(x, passes)
    build.require(x.dim() == 2 and x.shape[1] == LANES and x.shape[0] > 0,
                  f"stream_sum: want x (rows, {LANES}); got {tuple(x.shape)}")
    build.require(x.dtype == torch.int8 and x.is_contiguous() and _aligned(x),
                  "stream_sum: want a contiguous, 16-byte aligned int8 tensor")
    build.require(passes >= 1 and 1 <= block_rows < 1 << 26,
                  f"stream_sum: passes {passes}, block_rows {block_rows}")
    acc = torch.empty(LANES, dtype=torch.int64, device=x.device)
    out = torch.empty(LANES, dtype=torch.float32, device=x.device)
    args = build.StreamArgs(rows=x.shape[0], block_rows=block_rows, passes=passes,
                            grid=_grid(-(-x.shape[0] // block_rows), False, x.device),
                            x=build.ptr(x), acc=build.ptr(acc), out=build.ptr(out))
    lib = build.load_library()
    rc = lib.qt_stream_sum(args, build.stream_handle())
    stream_sum.launches += 1
    build.check(lib, rc, "stream probe kernel")
    return out


stream_sum.launches = 0


def _kv_strides(t: torch.Tensor, nS: int, contiguous_kv: bool) -> tuple:
    """(layer, chunk, batch row, kv head) element strides of a K/V cache."""
    if contiguous_kv:
        return nS * t.stride(0), t.stride(0), t.stride(1), t.stride(2)
    Sc = t.shape[3] // nS
    return t.stride(0), Sc * t.stride(3), t.stride(1), t.stride(2)


def shaped_sum(w: torch.Tensor, k: torch.Tensor, v: torch.Tensor, s1: torch.Tensor,
               s2: torch.Tensor, passes: int, nS: int,
               contiguous_kv: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shaped probe: ((128,) f32 out, (L, H) f32 weight column sums).

    w int8 (L, Wr, H); k, v bf16 (L, B, Hkv, S_buf, D) with S_buf = nS * Sc,
    or chunk-major (L * nS, B, Hkv, Sc, D) with `contiguous_kv`; s1, s2 f32
    (L, 1, H). CPU tensors run `shaped_sum_ref`; CUDA tensors launch the
    kernel (all passes in one launch), each launch adding one to
    `shaped_sum.launches`. The kernel takes D = 128, 128 <= H <= 4096 with
    H / 16 dividing 256, and every (Sc, D) run of K/V contiguous."""
    if not _on_cuda("shaped_sum", w):
        return shaped_sum_ref(w, k, v, s1, s2, passes, nS, contiguous_kv)
    build.require(w.dim() == 3 and w.dtype == torch.int8 and w.is_contiguous()
                  and _aligned(w), "shaped_sum: want w a contiguous int8 (L, Wr, H)")
    L, Wr, H = w.shape
    build.require(H % 16 == 0 and 256 % (H // 16) == 0 and OUT_LANES <= H <= 4096,
                  f"shaped_sum: H = {H}: want 128 <= H <= 4096, H / 16 dividing 256")
    build.require(passes >= 1 and nS >= 1, f"shaped_sum: passes {passes}, nS {nS}")
    build.require(k.dim() == 5 and tuple(k.shape) == tuple(v.shape),
                  f"shaped_sum: k {tuple(k.shape)}, v {tuple(v.shape)}")
    _, B, Hkv, S, D = k.shape
    if contiguous_kv:
        build.require(k.shape[0] == L * nS, f"shaped_sum: contiguous k wants L * nS = "
                      f"{L * nS} chunks, has {k.shape[0]}")
        Sc = S
    else:
        build.require(k.shape[0] == L and S % nS == 0,
                      f"shaped_sum: k (L, B, Hkv, S_buf, D) with S_buf a multiple of "
                      f"nS = {nS}; got {tuple(k.shape)}")
        Sc = S // nS
    build.require(D == OUT_LANES, f"shaped_sum: head_dim {D}, want {OUT_LANES}")
    for name, t in (("k", k), ("v", v)):
        build.require(t.dtype == torch.bfloat16 and t.stride(4) == 1 and t.stride(3) == D
                      and all(s % 8 == 0 for s in t.stride()[:3]) and _aligned(t),
                      f"shaped_sum: {name} must be bf16 with contiguous (Sc, D) runs")
    for name, t in (("s1", s1), ("s2", s2)):
        build.require(t.dtype == torch.float32 and t.is_contiguous()
                      and tuple(t.shape) == (L, 1, H), f"shaped_sum: {name} wants f32 "
                      f"contiguous {(L, 1, H)}; got {tuple(t.shape)}")
    build.same_device(w.device, k=k, v=v, s1=s1, s2=s2)
    w_rows = max(1, ITEM_BYTES // H)
    runs = max(1, ITEM_BYTES // (Sc * D * 2))
    grid = _grid(L * (-(-Wr // w_rows) + 2 * nS * -(-(B * Hkv) // runs)), True, w.device)

    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=w.device)

    colsum, kvpart, scpart = (empty(L, H, dtype=torch.int64),
                              empty(grid, OUT_LANES, dtype=torch.float64),
                              empty(grid, dtype=torch.float64))
    out, side = empty(OUT_LANES, dtype=torch.float32), empty(L, H, dtype=torch.float32)
    ks, vs = _kv_strides(k, nS, contiguous_kv), _kv_strides(v, nS, contiguous_kv)
    args = build.ShapedArgs(
        L=L, Wr=Wr, H=H, BH=B * Hkv, Hkv=Hkv, Sc=Sc, nS=nS, passes=passes, grid=grid,
        w_rows=w_rows, runs=runs,
        k_sl=ks[0], k_sc=ks[1], k_sb=ks[2], k_sh=ks[3],
        v_sl=vs[0], v_sc=vs[1], v_sb=vs[2], v_sh=vs[3],
        **{n: build.ptr(t) for n, t in (("w", w), ("k", k), ("v", v), ("s1", s1),
                                         ("s2", s2), ("colsum", colsum), ("kvpart", kvpart),
                                         ("scpart", scpart), ("out", out), ("side", side))})
    lib = build.load_library()
    rc = lib.qt_shaped_sum(args, build.stream_handle())
    shaped_sum.launches += 1
    build.check(lib, rc, "shaped probe kernel")
    return out, side


shaped_sum.launches = 0
