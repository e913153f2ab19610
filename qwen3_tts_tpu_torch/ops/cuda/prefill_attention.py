"""Causal GQA flash attention for the talker prefill.

Counterpart of `qwen3_tts_tpu/ops/pallas/prefill_attention.py`. On a CUDA
tensor `flash_prefill` launches the hand-written Hopper kernel
(csrc/prefill_attention.cu); on a CPU tensor it runs the plain twin
`flash_prefill_ref`. Any other device raises.

Masking model (the left-padded prefill layout of `models/talker.py`): query
slot i attends key slot j iff start_b <= j <= i, and j > i - window when a
sliding window is set. Query rows in the left padding see no key and come
out as zeros.

The kernel reads q, k and v where they lie, by TMA: (B, T, H, D) views with
any batch, token and head strides, as `decoder_stack` hands them over after
RoPE (q, k and v are views into the fused qkv product). Only the last axis
must be contiguous and every stride a whole 16 bytes; a view that is not
gets a contiguous copy first.

Its work list comes from `flash_plan`, a pure function of (T, starts,
window): which 128-key tiles each 64-position query tile visits, which of
them need a mask, and which CTA runs it. Its shapes depend only on (B, T,
Hkv, CTAs), so one pair of static buffers holds the plan of any starts. A
caller that knows the starts on the host (the prompt's mask; a captured
prefill, whose plan is copied into such buffers before each replay) passes
the plan; otherwise the wrapper builds it from the starts (one
device-to-host copy) and keeps it on the device for as long as the same
`start` tensor is passed unchanged, so the prefill's layers share one plan.
"""

from __future__ import annotations

import heapq
import weakref
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from . import build

FP_BQ = 64     # query positions per work item (csrc/prefill_attention.cu)
FP_BK = 128    # keys per K/V tile
# fields of a work item, as the kernel reads them
ITEM_FIELDS = ("b", "hk", "q_lo", "kt_lo", "kt_hi", "um_lo", "um_hi", "start")


def _mask(T: int, start: torch.Tensor, sliding_window: Optional[int]) -> torch.Tensor:
    """(B, T, T) bool: key j visible from query i."""
    i = torch.arange(T, device=start.device)[:, None]
    j = torch.arange(T, device=start.device)[None, :]
    ok = (j <= i)[None] & (j[None] >= start.to(torch.int64)[:, None, None])
    if sliding_window:
        ok = ok & (j > i - sliding_window)[None]
    return ok


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      start: torch.Tensor, scale: Optional[float] = None,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """Plain twin: dense masked attention in fp32. q: (B, T, Hq, D); k/v:
    (B, T, Hkv, D); start: (B,) first valid slot per row. Returns
    (B, T, Hq, D) in q.dtype, zeros on the rows that see no key."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    ok = _mask(T, start, sliding_window)[:, None, None]          # (B, 1, 1, T, T)
    qg = q.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = torch.where(ok, s, torch.full_like(s, float("-inf")))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / den.clamp_min(1e-30), v.float())
    return o.reshape(B, T, Hq, D).to(q.dtype)


def flash_plan(T: int, starts: Sequence[int], window: Optional[int], Hkv: int,
               ctas: int):
    """The kernel's work list: one item per (batch row b, kv head hk, query
    tile of FP_BQ positions from q_lo), with the FP_BK-key tiles it visits,
    [kt_lo, kt_hi], from max(start, q_lo - window + 1) to the causal
    diagonal (every visited tile holds a key some row of the tile sees; an
    empty range, kt_lo > kt_hi, means every row is left padding: a zero
    write), and the tiles every valid row sees whole, [um_lo, um_hi], which
    need no mask. Items are dealt heaviest first, each to the CTA with the
    least work so far, over min(items, ctas) CTAs. Returns (items (n, 8)
    int32 in ITEM_FIELDS order, grouped by CTA; offsets (CTAs + 1,) int32:
    CTA c runs items [offsets[c], offsets[c + 1]))."""
    nq = -(-T // FP_BQ)
    q_lo = np.arange(nq) * FP_BQ
    q_hi = np.minimum(q_lo + FP_BQ - 1, T - 1)
    rows = []
    for b, s in enumerate(starts):
        k_first = np.maximum(s, q_lo - window + 1 if window else 0)
        live = k_first <= q_hi
        kt_lo = np.where(live, k_first // FP_BK, 0)
        kt_hi = np.where(live, q_hi // FP_BK, -1)
        # whole tiles: k0 >= start, k0 + BK - 1 <= q_lo (causal for the first
        # row), k0 + BK <= T, and k0 > q_hi - window (the window for the last)
        um_lo = np.full(nq, -(-s // FP_BK))
        if window:
            um_lo = np.maximum(um_lo, -(-(q_hi - window + 1) // FP_BK))
        um_hi = np.minimum((q_lo + 1) // FP_BK - 1, T // FP_BK - 1)
        for hk in range(Hkv):
            rows.append(np.stack([np.full(nq, b), np.full(nq, hk), q_lo, kt_lo, kt_hi,
                                  um_lo, um_hi, np.full(nq, s)], axis=1))
    items = np.concatenate(rows).astype(np.int32)
    # a zero write costs about a quarter of a tile
    work = (items[:, 4] - items[:, 3] + 1) + 0.25
    order = np.argsort(-work, kind="stable")
    n_ctas = max(1, min(len(items), ctas))
    heap = [(0.0, c) for c in range(n_ctas)]
    lists = [[] for _ in range(n_ctas)]
    for i in order:
        load, c = heapq.heappop(heap)
        lists[c].append(i)
        heapq.heappush(heap, (load + float(work[i]), c))
    offsets = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    return items[np.concatenate(lists)], offsets


_PLANS: "OrderedDict[tuple, tuple]" = OrderedDict()


def device_plan(start: torch.Tensor, T: int, window: Optional[int], Hkv: int, ctas: int):
    """`flash_plan` for these starts as tensors on start's device (items,
    offsets), built once per `start` tensor while it is alive and unchanged:
    the prefill passes the same one to every layer."""
    dev = start.device
    key = (id(start), T, window, Hkv, ctas, dev)
    hit = _PLANS.get(key)
    if hit is not None and hit[0]() is start and hit[1] == start._version:
        return hit[2]
    items, offsets = flash_plan(T, start.tolist(), window, Hkv, ctas)
    plan = (torch.from_numpy(items).to(dev), torch.from_numpy(offsets).to(dev))
    _PLANS[key] = (weakref.ref(start), start._version, plan)
    while len(_PLANS) > build.MAX_CACHED:
        _PLANS.popitem(last=False)
    return plan


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernel's TMA maps can read it in place (the last axis
    contiguous, every other stride and the base a whole 16 bytes), else a
    contiguous copy."""
    strides_ok = x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
    return x if strides_ok and x.data_ptr() % 16 == 0 else x.contiguous()


def plan_shapes(B: int, T: int, Hkv: int, ctas: int) -> tuple:
    """The shapes of `flash_plan`'s (items, offsets) for any starts."""
    n = B * Hkv * -(-T // FP_BQ)
    return (n, len(ITEM_FIELDS)), (max(1, min(n, ctas)) + 1,)


def flash_misfit(dtype: torch.dtype, heads: int, kv_heads: int, head_dim: int
                 ) -> Optional[str]:
    """The first rule of what the kernel was built for that these shapes
    break, or None: bf16 q, k and v, head_dim 128 and two query heads per kv
    head (the released configurations' shape, which chip_smoke.py holds
    against the twin; another width needs its own instantiation). The
    wrapper's launch check raises with it; `models/talker.py`
    `prefill_uses_flash` routes a misfit to the dense attention."""
    if dtype != torch.bfloat16:
        return f"the kernel takes bf16 q, k and v; got {dtype}"
    if head_dim != 128:
        return f"the kernel is built for head_dim 128; got {head_dim}"
    if heads != 2 * kv_heads:
        return (f"{heads} query heads over {kv_heads} kv heads: the kernel is built for "
                "two query heads per kv head")
    return None


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  start: torch.Tensor, scale: Optional[float] = None,
                  sliding_window: Optional[int] = None,
                  plan: Optional[tuple] = None) -> torch.Tensor:
    """Causal left-padded GQA flash attention. q: (B, T, Hq, D); k/v:
    (B, T, Hkv, D); start: (B,) int32 first valid slot per row. Returns
    (B, T, Hq, D) in q.dtype.

    CPU tensors run `flash_prefill_ref`; CUDA tensors launch the kernel, each
    launch adding one to `flash_prefill.launches`. Shapes the kernel was
    not built for (`flash_misfit`) raise.
    `plan`: `flash_plan` of these starts as (items, offsets) int32 tensors
    on q's device (`plan_shapes`, the device's SM count as CTAs). Without
    it, the first call with a given `start` tensor reads it to the host for
    the work list; later calls with it do not. A captured launch takes the
    plan: a capture cannot read the device."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, start, scale, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    build.require(q.dim() == 4 and tuple(k.shape) == (B, T, Hkv, D)
                  and tuple(v.shape) == (B, T, Hkv, D),
                  f"flash_prefill: want q (B, T, Hq, D), k/v (B, T, Hkv, D); got "
                  f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    dtype = next((t.dtype for t in (q, k, v) if t.dtype != torch.bfloat16), torch.bfloat16)
    misfit = flash_misfit(dtype, Hq, Hkv, D)
    build.require(misfit is None, f"flash_prefill: {misfit}")
    build.require(tuple(start.shape) == (B,), "flash_prefill: start must be (B,)")
    build.same_device(q.device, k=k, v=v, start=start)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    ctas = build.sm_count(q.device)
    if plan is None:
        build.require(not torch.cuda.is_current_stream_capturing(),
                      "a captured flash prefill takes its plan (flash_plan) as an argument")
        items, offsets = device_plan(start, T, sliding_window, Hkv, ctas)
    else:
        items, offsets = plan
        build.require((tuple(items.shape), tuple(offsets.shape)) == plan_shapes(B, T, Hkv, ctas)
                      and items.dtype == offsets.dtype == torch.int32,
                      f"flash_prefill: want an int32 plan of shapes {plan_shapes(B, T, Hkv, ctas)}")
        build.same_device(q.device, items=items, offsets=offsets)
    out = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    args = build.FlashPrefillArgs(
        B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, window=sliding_window or 0,
        grid=offsets.numel() - 1, scale=D ** -0.5 if scale is None else scale,
        **_strides(q, k, v), q=build.ptr(q), k=build.ptr(k), v=build.ptr(v),
        out=build.ptr(out), items=build.ptr(items), item_off=build.ptr(offsets))
    lib = build.load_library()
    rc = lib.qt_flash_prefill(args, build.stream_handle())
    flash_prefill.launches += 1
    build.check(lib, rc, "flash prefill kernel")
    return out


flash_prefill.launches = 0


def _strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> dict:
    return dict(sqb=q.stride(0), sqt=q.stride(1), sqh=q.stride(2),
                skb=k.stride(0), skt=k.stride(1), skh=k.stride(2),
                svb=v.stride(0), svt=v.stride(1), svh=v.stride(2))


def flash_tile_products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, b: int, hq: int,
                        q_lo: int, k0: int):
    """The kernel's two products alone, on one tile: s = Q K^T (64 x 128
    f32) of query head hq's FP_BQ positions from q_lo and its kv head's
    FP_BK keys from k0 (batch row b; rows and keys past T read as zeros),
    and o = bf16(s) V (64 x 128 f32). No prefill calls it: it holds the TMA
    maps, the wgmma descriptors and the fragment layouts to a matmul on their
    own. CPU tensors run the plain version."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if q.device.type == "cpu":
        def tile(x, h, lo, n):
            t = torch.zeros((n, D))
            rows = x[b, lo:min(lo + n, T), h].float()
            t[:rows.shape[0]] = rows
            return t

        s = tile(q, hq, q_lo, FP_BQ) @ tile(k, hq // (Hq // Hkv), k0, FP_BK).T
        return s, s.to(torch.bfloat16).float() @ tile(v, hq // (Hq // Hkv), k0, FP_BK)
    build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v)) and D == 128
                  and Hq == 2 * Hkv, "flash_tile_products: bf16, head_dim 128, Hq = 2 Hkv")
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    s = torch.empty((FP_BQ, FP_BK), dtype=torch.float32, device=q.device)
    o = torch.empty((FP_BQ, D), dtype=torch.float32, device=q.device)
    args = build.FlashProbeArgs(B=B, T=T, Hq=Hq, Hkv=Hkv, b=b, hq=hq, q_lo=q_lo, k0=k0,
                                **_strides(q, k, v), q=build.ptr(q), k=build.ptr(k),
                                v=build.ptr(v), s=build.ptr(s), o=build.ptr(o))
    lib = build.load_library()
    build.check(lib, lib.qt_flash_probe(args, build.stream_handle()), "flash tile products")
    return s, o
