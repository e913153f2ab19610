"""1-D convolutions with the reference codecs' causal padding (counterpart
of `qwen3_tts_tpu/ops/conv.py`).

NCT layout and torch-layout kernels, so the JAX package's parameter trees
apply unchanged. These were XLA convolutions in the JAX package, not Pallas
kernels, so `torch.nn.functional` carries them. Bias adds happen in fp32 as
in the JAX package (its convs accumulate in fp32 and add the bias before
the cast back).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _causal_pad_amounts(length: int, kernel_size: int, stride: int,
                        dilation: int):
    """(left, right) zero padding used by the reference causal convs."""
    eff_k = (kernel_size - 1) * dilation + 1
    pad_total = eff_k - stride
    n_frames = (length - eff_k + pad_total) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (eff_k - pad_total)
    return pad_total, ideal - length


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Plain unpadded conv1d. x: (B, C, T); weight: (O, I/groups, K)."""
    out = F.conv1d(x, weight.to(x.dtype), None, stride=stride,
                   dilation=dilation, groups=groups).to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :, None]
    return out.to(x.dtype)


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None, stride: int = 1,
                  dilation: int = 1, groups: int = 1,
                  pad_mode: str = "constant") -> torch.Tensor:
    """Causal conv1d with the reference's left + extra right padding, zeros
    or ("replicate") copies of the edge samples."""
    left, extra = _causal_pad_amounts(x.shape[-1], weight.shape[-1], stride,
                                      dilation)
    x = F.pad(x, (left, max(extra, 0)),
              mode="replicate" if pad_mode == "replicate" else "constant")
    return conv1d(x, weight, bias, stride=stride, dilation=dilation,
                  groups=groups)


def causal_conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            stride: int = 1) -> torch.Tensor:
    """Causal transposed conv1d: full transposed conv, trim `k - stride` on
    the right. weight: torch ConvTranspose1d layout (I, O, K)."""
    k = weight.shape[-1]
    out = F.conv_transpose1d(x, weight.to(x.dtype), None,
                             stride=stride).to(torch.float32)
    if bias is not None:
        out = out + bias.to(torch.float32)[None, :, None]
    right = k - stride
    if right > 0:
        out = out[..., :-right]
    return out.to(x.dtype)


def snake_beta(x: torch.Tensor, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
    """SnakeBeta: x + 1/(exp(beta) + 1e-9) * sin^2(x * exp(alpha)); alpha and
    beta are stored in log scale, shape (C,), x: (B, C, T)."""
    xf = x.to(torch.float32)
    a = torch.exp(alpha.to(torch.float32))[None, :, None]
    b = torch.exp(beta.to(torch.float32))[None, :, None]
    s = torch.sin(xf * a)
    return (xf + (1.0 / (b + 1e-9)) * s * s).to(x.dtype)
