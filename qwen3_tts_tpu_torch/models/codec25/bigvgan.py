"""BigVGAN vocoder (mel -> waveform) of the 25 Hz tokenizer (counterpart of
`qwen3_tts_tpu/models/codec25/bigvgan.py`; reference
Qwen3TTSTokenizerV1DecoderBigVGANModel, modeling...v1.py:698-1067):

- mel pre-processing: exp -> amplitude-to-dB -> [-1, 1] (1038-1050);
- transposed-conv upsampling with AMP residual blocks whose SnakeBeta
  activations are anti-aliased by kaiser-windowed sinc up / down sampling
  (UpSample1d / DownSample1d, 739-856). The JAX package's transposed convs
  are lhs-dilated correlations with the flipped kernel; here they are
  `conv_transpose1d` with the same full-length output, then the same crop;
- mixed causal / 'same' conv layouts per block depth (AMPBlock, 868-992).

The kaiser filters are computed in numpy and kept on the device per (ratio,
kernel size, dtype, device): a forward copies nothing from pageable host
memory, so it can be captured. It runs eagerly all the same (the JAX
package's `_bigvgan_jit`; see `runtime/graphs.py` for why).
"""

from __future__ import annotations

import math
import threading
from functools import lru_cache
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...config import BigVGANConfig
from ...ops.conv import conv1d, snake_beta

Params = Dict[str, Any]


@lru_cache(maxsize=32)
def _kaiser_sinc_filter(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Reference kaiser_sinc_filter1d (739-782)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    attenuation = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if attenuation > 50.0:
        beta = 0.1102 * (attenuation - 8.7)
    elif attenuation >= 21.0:
        beta = 0.5842 * (attenuation - 21) ** 0.4 + 0.07886 * (attenuation - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)  # matches torch periodic=False
    if even:
        time_idx = np.arange(-half_size, half_size) + 0.5
    else:
        time_idx = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros((1, 1, kernel_size), np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time_idx)
    filt = filt / filt.sum()
    return filt.reshape(1, 1, kernel_size).astype(np.float32)


@lru_cache(maxsize=None)
def _device_filter(ratio: int, kernel_size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The (1, 1, kernel_size) sinc filter of `ratio` on `device`, built at
    the first call of its arguments and kept for good: a forward copies
    nothing from the host."""
    filt = _kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, kernel_size)
    return torch.from_numpy(filt).to(device).to(dtype)


def _filter(ratio: int, kernel_size: int, channels: int, like: torch.Tensor) -> torch.Tensor:
    return _device_filter(ratio, kernel_size, like.dtype, like.device).expand(channels, 1, -1)


def _upsample1d(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Anti-aliased upsample (reference UpSample1d 785-807): edge pad, a
    grouped transposed conv with the sinc filter, x ratio, crop."""
    kernel_size = int(6 * ratio // 2) * 2
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    C = x.shape[1]
    x = F.pad(x, (pad, pad), mode="replicate")
    out = ratio * F.conv_transpose1d(x, _filter(ratio, kernel_size, C, x), stride=ratio,
                                     groups=C)
    return out[..., pad_left:out.shape[-1] - pad_right]


def _downsample1d(x: torch.Tensor, ratio: int, kernel_size: int) -> torch.Tensor:
    """Reference DownSample1d (810-832)."""
    pad_left = kernel_size // 2 - int(kernel_size % 2 == 0)
    pad_right = kernel_size // 2
    C = x.shape[1]
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return conv1d(x, _filter(ratio, kernel_size, C, x), stride=ratio, groups=C)


def _aa_snake(act_params: Params, x: torch.Tensor, ratio: int = 2,
              kernel_size: int = 12) -> torch.Tensor:
    """TorchActivation1d(SnakeBeta): upsample -> snake -> downsample
    (reference 835-856)."""
    h = snake_beta(_upsample1d(x, ratio), act_params["act"]["alpha"],
                   act_params["act"]["beta"])
    return _downsample1d(h, ratio, kernel_size)


def _causal_conv(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """CausalConv1d (859-865): left-pad dilation * (k - 1)."""
    pad = dilation * (p["weight"].shape[-1] - 1)
    return conv1d(F.pad(x, (pad, 0)), p["weight"], p.get("bias"), dilation=dilation)


def _same_conv(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    k = p["weight"].shape[-1]
    pad = (k * dilation - dilation) // 2
    return conv1d(F.pad(x, (pad, pad)), p["weight"], p.get("bias"), dilation=dilation)


def _amp_block(bp: Params, x: torch.Tensor, dilations, causal_type: str) -> torch.Tensor:
    """AMPBlock (868-992)."""
    acts = bp["activations"]
    h = x
    if causal_type == "2":
        h = _aa_snake(bp["pre_act"], _same_conv(bp["pre_conv"], x))
    for i, dil in enumerate(dilations):
        hh = _aa_snake(acts[str(2 * i)], h)
        hh = _causal_conv(bp["convs1"][str(i)], hh, dilation=dil)
        hh = _aa_snake(acts[str(2 * i + 1)], hh)
        if causal_type == "1":
            hh = _same_conv(bp["convs2"][str(i)], hh)
        else:
            hh = _causal_conv(bp["convs2"][str(i)], hh)
        x = x + hh
        h = hh
    return x


def _process_mel(mel: torch.Tensor) -> torch.Tensor:
    """exp -> dB -> normalized to [-1, 1] (reference 1038-1050)."""
    amp = torch.exp(mel.to(torch.float32))
    min_level = math.exp(-115 / 20.0 * math.log(10.0))
    db = 20.0 * torch.log10(torch.clamp(amp, min=min_level)) - 20.0
    return torch.clamp(2.0 * ((db + 115) / 115.0) - 1.0, -1.0, 1.0).to(mel.dtype)


_DETERMINISTIC = threading.Lock()   # held by a forward while it sets cuDNN's flag


def bigvgan_forward(params: Params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel: (B, mel_dim, T) -> wav (B, T * prod(upsample_rates)) in [-1, 1]
    (reference Qwen3TTSTokenizerV1DecoderBigVGANModel.forward, 1052-1067).
    cuDNN runs in its deterministic mode here: otherwise it may pick
    transposed-convolution algorithms that sum with atomics, and two calls
    on one 10 s mel differed by 4.7e-5 on an H100. The flag is process-wide,
    so one forward at a time sets it and puts it back (`_DETERMINISTIC`);
    another thread's convolutions meanwhile also get deterministic
    algorithms, which changes their speed, not their tolerance."""
    with _DETERMINISTIC:
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return _forward(params, cfg, mel)
        finally:
            torch.backends.cudnn.deterministic = prev


def _forward(params: Params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    h = _process_mel(mel)
    h = conv1d(F.pad(h, (2, 2)), params["conv_pre"]["weight"], params["conv_pre"]["bias"])
    n_res = len(cfg.resblock_kernel_sizes)
    for li, (stride, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][str(li)]["0"]
        # torch ConvTranspose1d with padding p: the full output, p cropped from both ends
        h = F.conv_transpose1d(h, up["weight"].to(h.dtype), None, stride=stride)
        if up.get("bias") is not None:
            h = h + up["bias"].to(h.dtype)[None, :, None]
        p = (k - stride) // 2
        if p > 0:
            h = h[..., p:-p]
        causal_type = "1" if li > 1 else "2"
        res = None
        for bi in range(n_res):
            out = _amp_block(params["resblocks"][str(li * n_res + bi)], h,
                             cfg.resblock_dilation_sizes[bi], causal_type)
            res = out if res is None else res + out
        h = res / n_res
    h = _aa_snake(params["activation_post"], h)
    wav = conv1d(F.pad(h, (3, 3)), params["conv_post"]["weight"], None)
    return torch.clamp(wav, -1.0, 1.0)[:, 0, :]
