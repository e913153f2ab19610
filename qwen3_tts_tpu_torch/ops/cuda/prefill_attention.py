"""Causal GQA flash attention for the talker prefill.

Counterpart of `qwen3_tts_tpu/ops/pallas/prefill_attention.py`. On a CUDA
tensor `flash_prefill` launches the hand-written Hopper kernel
(csrc/prefill_attention.cu); on a CPU tensor it runs the plain twin
`flash_prefill_ref`. Any other device raises.

Masking model (the left-padded prefill layout of `models/talker.py`): query
slot i attends key slot j iff start_b <= j <= i, and j > i - window when a
sliding window is set. Query rows in the left padding see no key and come
out as zeros.

The kernel reads q, k and v where they lie: (B, T, H, D) views with any
batch, token and head strides, as `decoder_stack` hands them over after
RoPE (v is a view into the fused qkv product). Only the last axis must be
contiguous and every row 16-byte aligned; a view that is not gets a
contiguous copy first.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build


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


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x itself if the kernel can read it in place, else a contiguous copy."""
    strides_ok = x.stride(3) == 1 and all(s % 8 == 0 for s in x.stride()[:3])
    return x if strides_ok and x.data_ptr() % 16 == 0 else x.contiguous()


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  start: torch.Tensor, scale: Optional[float] = None,
                  sliding_window: Optional[int] = None) -> torch.Tensor:
    """Causal left-padded GQA flash attention. q: (B, T, Hq, D); k/v:
    (B, T, Hkv, D); start: (B,) int32 first valid slot per row. Returns
    (B, T, Hq, D) in q.dtype.

    CPU tensors run `flash_prefill_ref`; CUDA tensors launch the kernel, each
    launch adding one to `flash_prefill.launches`. The kernel is built for
    the released configurations' shape only (bf16, D = 128, Hq = 2 * Hkv,
    the shape chip_smoke.py holds against the twin); any other raises."""
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
    build.require(all(t.dtype == torch.bfloat16 for t in (q, k, v)),
                  "flash_prefill: the kernel takes bf16 q, k and v")
    build.require(D == 128 and Hq == 2 * Hkv,
                  f"flash_prefill: the kernel is built for head_dim 128 and two "
                  f"query heads per kv head; got head_dim {D}, {Hq} over {Hkv}")
    build.require(tuple(start.shape) == (B,), "flash_prefill: start must be (B,)")
    build.same_device(q.device, k=k, v=v, start=start)
    q, k, v = _kernel_view(q), _kernel_view(k), _kernel_view(v)
    start = start.to(torch.int32).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=torch.bfloat16, device=q.device)
    args = build.FlashPrefillArgs(
        B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, window=sliding_window or 0,
        scale=D ** -0.5 if scale is None else scale,
        sqb=q.stride(0), sqt=q.stride(1), sqh=q.stride(2),
        skb=k.stride(0), skt=k.stride(1), skh=k.stride(2),
        svb=v.stride(0), svt=v.stride(1), svh=v.stride(2),
        q=build.ptr(q), k=build.ptr(k), v=build.ptr(v), start=build.ptr(start),
        out=build.ptr(out))
    lib = build.load_library()
    rc = lib.qt_flash_prefill(args, build.stream_handle())
    flash_prefill.launches += 1
    build.check(lib, rc, "flash prefill kernel")
    return out


flash_prefill.launches = 0
