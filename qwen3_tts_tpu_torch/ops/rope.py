"""Rotary position embeddings (counterpart of `qwen3_tts_tpu/ops/rope.py`).

For TTS the talker's 3-axis mrope carries identical positions on all three
axes, so it reduces to plain 1-D RoPE (`models/talker.py` in the JAX
package); only the 1-D form is ported. Tables are fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def default_inv_freq(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Default RoPE inverse frequencies (fp32), matching HF `default` rope."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(position_ids: torch.Tensor, inv_freq: torch.Tensor,
                attention_scaling: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for positions of shape (..., T) -> (..., T, head_dim) fp32."""
    freqs = position_ids[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb) * attention_scaling, torch.sin(emb) * attention_scaling


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply 1-D RoPE. q/k: (B, T, H, D); cos/sin: (B, T, D) fp32."""
    cos = cos[:, :, None, :].to(torch.float32)
    sin = sin[:, :, None, :].to(torch.float32)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    q_out = qf * cos + rotate_half(qf) * sin
    k_out = kf * cos + rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
