"""Attention ops: GQA with fp32 softmax, causal / sliding-window masks
(counterpart of `qwen3_tts_tpu/ops/attention.py`).

Masks are boolean predicates turned into additive fp32 biases whose masked
value is the most negative finite float (not -inf), as in the JAX package.
`attention_kv_quant` attends an int8 KV window with per-(slot, head)
scales folded into the scores and the probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float(torch.finfo(torch.float32).min)


def causal_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                kv_valid: Optional[torch.Tensor] = None,
                sliding_window: Optional[int] = None) -> torch.Tensor:
    """(B, Tq) / (B, Tk) positions -> (B, 1, Tq, Tk) bool, True = attend.

    With a window, key j is visible iff q_pos - window < k_pos <= q_pos."""
    ok = kv_pos[:, None, :] <= q_pos[:, :, None]
    if sliding_window is not None:
        ok = ok & (kv_pos[:, None, :] > (q_pos[:, :, None] - sliding_window))
    if kv_valid is not None:
        ok = ok & kv_valid[:, None, :]
    return ok[:, None, :, :]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """Boolean mask -> additive fp32 bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def attention_kv_quant(q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor,
                       vq: torch.Tensor, vs: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """GQA over an int8 KV window without dequantizing it.

    kq/vq: (B, Tk, Hkv, D) int8; ks/vs: (B, Tk, Hkv) fp32 per-(slot, head)
    scales. The K scale (times D^-0.5) multiplies the fp32 scores, the V
    scale the fp32 probabilities before their cast to the compute dtype, in
    the JAX package's order."""
    B, Tq, Hq, D = q.shape
    Hkv = kq.shape[2]
    if scale is None:
        scale = D ** -0.5
    groups = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          kq.to(q.dtype).to(torch.float32))
    scores = scores * (ks.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :] * scale)
    if mask is not None:
        bias = mask_to_bias(mask) if mask.dtype == torch.bool else mask.to(torch.float32)
        scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * vs.to(torch.float32).permute(0, 2, 1)[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vq.to(q.dtype))
    return out.reshape(B, Tq, Hq, D)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, Tq, Hq, D); k/v: (B, Tk, Hkv, D); mask: (B, 1, Tq, Tk) bool or
    additive bias. Returns (B, Tq, Hq, D) in q.dtype. Scores and softmax in
    fp32; the probabilities are cast to the compute dtype before the PV
    product, as the JAX package does.
    """
    B, Tq, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    groups = Hq // Hkv
    qg = q.reshape(B, Tq, Hkv, groups, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        bias = mask_to_bias(mask) if mask.dtype == torch.bool else mask.to(torch.float32)
        scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(q.dtype))
    return out.reshape(B, Tq, Hq, D)
