"""CAM++ (D-TDNN with context-aware masking) speaker embedding in PyTorch
(counterpart of `qwen3_tts_tpu/models/codec25/campplus.py`).

The reference runs the CAM++ x-vector of the 25 Hz tokenizer through a
bundled `campplus.onnx` via onnxruntime (qwen_tts/core/tokenizer_25hz/vq/
speech_vq.py:118-159). This module is the network itself (the public
modelscope `speakerlab` CAMPPlus: FCM 2-D front end, D-TDNN blocks with CAM
layers, stats pooling) over a flat {torch-state-dict-name: tensor} mapping,
loaded from the ONNX file's initializers (`utils/onnx_weights.py`) or a
.safetensors export (the port's numpy reader). Every normalization runs in
inference mode (running statistics), as the exported graph does. There is
no onnxruntime route: a weights file that does not parse raises.

Architecture constants (campplus-common checkpoint): 80-d kaldi fbank, FCM
m_channels 32, D-TDNN init 128 channels, growth 32, bn_size 4, blocks
(12, 24, 16) with kernel 3 and dilations (1, 2, 2), embedding 192.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    m_channels: int = 32
    num_blocks: Tuple[int, ...] = (12, 24, 16)
    kernels: Tuple[int, ...] = (3, 3, 3)
    dilations: Tuple[int, ...] = (1, 2, 2)
    seg_len: int = 100
    bn_eps: float = 1e-5


def _bn(p: Params, prefix: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Inference-mode batch norm over axis 1; the affine terms are optional
    (`batchnorm_` layers have none)."""
    shape = [1, -1] + [1] * (x.ndim - 2)

    def g(name):
        a = p.get(f"{prefix}.{name}")
        return None if a is None else a.reshape(shape).to(x.dtype)

    y = (x - g("running_mean")) * torch.rsqrt(g("running_var") + eps)
    w, b = g("weight"), g("bias")
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


def _bn_relu(p: Params, prefix: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """config_str='batchnorm-relu' (Sequential[batchnorm, relu])."""
    return torch.relu(_bn(p, f"{prefix}.batchnorm", x, eps))


def _conv1d(p: Params, prefix: str, x: torch.Tensor, stride: int = 1, padding: int = 0,
            dilation: int = 1) -> torch.Tensor:
    """x: (B, C, T) -> (B, O, T')."""
    b = p.get(f"{prefix}.bias")
    return F.conv1d(x, p[f"{prefix}.weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding, dilation=dilation)


def _conv2d(p: Params, prefix: str, x: torch.Tensor, stride: Tuple[int, int] = (1, 1),
            padding: int = 0) -> torch.Tensor:
    """x: (B, C, F, T) -> (B, O, F', T')."""
    b = p.get(f"{prefix}.bias")
    return F.conv2d(x, p[f"{prefix}.weight"].to(x.dtype),
                    None if b is None else b.to(x.dtype), stride=stride, padding=padding)


def _res_block(p: Params, prefix: str, x: torch.Tensor, stride: int, in_planes: int,
               planes: int, eps: float) -> torch.Tensor:
    """FCM BasicResBlock: 3x3 conv (freq-strided) -> BN -> relu -> 3x3 conv
    -> BN, plus a strided 1x1 shortcut when the shape changes."""
    h = torch.relu(_bn(p, f"{prefix}.bn1",
                       _conv2d(p, f"{prefix}.conv1", x, stride=(stride, 1), padding=1), eps))
    h = _bn(p, f"{prefix}.bn2", _conv2d(p, f"{prefix}.conv2", h, padding=1), eps)
    if stride != 1 or in_planes != planes:
        s = _bn(p, f"{prefix}.shortcut.1",
                _conv2d(p, f"{prefix}.shortcut.0", x, stride=(stride, 1)), eps)
    else:
        s = x
    return torch.relu(h + s)


def _fcm(p: Params, cfg: CAMPPlusConfig, x: torch.Tensor) -> torch.Tensor:
    """Front-end conv module: (B, F, T) fbank -> (B, m * (F // 8), T)."""
    eps, m = cfg.bn_eps, cfg.m_channels
    h = torch.relu(_bn(p, "head.bn1", _conv2d(p, "head.conv1", x[:, None], padding=1), eps))
    for layer in ("layer1", "layer2"):   # two blocks each, the first strided on freq
        for bi, stride in enumerate((2, 1)):
            h = _res_block(p, f"head.{layer}.{bi}", h, stride, in_planes=m, planes=m, eps=eps)
    h = torch.relu(_bn(p, "head.bn2",
                       _conv2d(p, "head.conv2", h, stride=(2, 1), padding=1), eps))
    B, C, Fq, T = h.shape
    return h.reshape(B, C * Fq, T)


def _seg_pooling(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Average-pool (kernel = stride = seg_len, ceil mode) then nearest-unpool
    back to T (CAMLayer.seg_pooling)."""
    B, C, T = x.shape
    nseg = -(-T // seg_len)
    pad = nseg * seg_len - T
    xp = F.pad(x, (0, pad))
    cnt = F.pad(torch.ones((T,), dtype=x.dtype, device=x.device), (0, pad))
    seg = xp.reshape(B, C, nseg, seg_len).sum(-1) / cnt.reshape(nseg, seg_len).sum(-1)
    return seg.repeat_interleave(seg_len, dim=-1)[..., :T]


def _cam_layer(p: Params, prefix: str, x: torch.Tensor, kernel: int, dilation: int,
               cfg: CAMPPlusConfig) -> torch.Tensor:
    """Context-aware mask: the local conv gated by sigmoid(MLP(global mean +
    segment pooling))."""
    y = _conv1d(p, f"{prefix}.linear_local", x, padding=(kernel - 1) // 2 * dilation,
                dilation=dilation)
    context = x.mean(-1, keepdim=True) + _seg_pooling(x, cfg.seg_len)
    context = torch.relu(_conv1d(p, f"{prefix}.linear1", context))
    return y * torch.sigmoid(_conv1d(p, f"{prefix}.linear2", context))


def _dense_tdnn_layer(p: Params, prefix: str, x: torch.Tensor, kernel: int,
                      dilation: int, cfg: CAMPPlusConfig) -> torch.Tensor:
    h = _bn_relu(p, f"{prefix}.nonlinear1", x, cfg.bn_eps)
    h = _conv1d(p, f"{prefix}.linear1", h)
    h = _bn_relu(p, f"{prefix}.nonlinear2", h, cfg.bn_eps)
    return _cam_layer(p, f"{prefix}.cam_layer", h, kernel, dilation, cfg)


def campplus_forward(p: Params, cfg: CAMPPlusConfig, feats: torch.Tensor) -> torch.Tensor:
    """feats: (B, T, feat_dim) mean-normalized kaldi fbank -> (B, emb)."""
    eps = cfg.bn_eps
    x = _fcm(p, cfg, feats.permute(0, 2, 1))
    # the D-TDNN trunk ('xvector.' prefix)
    x = _bn_relu(p, "xvector.tdnn.nonlinear",
                 _conv1d(p, "xvector.tdnn.linear", x, stride=2, padding=2), eps)
    for i, (nl, k, d) in enumerate(zip(cfg.num_blocks, cfg.kernels, cfg.dilations)):
        for j in range(nl):
            y = _dense_tdnn_layer(p, f"xvector.block{i + 1}.tdnnd{j + 1}", x, k, d, cfg)
            x = torch.cat([x, y], dim=1)
        x = _bn_relu(p, f"xvector.transit{i + 1}.nonlinear", x, eps)
        x = _conv1d(p, f"xvector.transit{i + 1}.linear", x)
    x = _bn_relu(p, "xvector.out_nonlinear", x, eps)
    # stats pooling: mean + std (unbiased, as torch.std)
    stats = torch.cat([x.mean(-1), x.var(-1, unbiased=x.shape[-1] > 1).sqrt()], dim=1)
    emb = _conv1d(p, "xvector.dense.linear", stats[:, :, None])
    return _bn(p, "xvector.dense.nonlinear.batchnorm", emb, eps)[:, :, 0]


def campplus_embed(p: Params, cfg: CAMPPlusConfig, feats: torch.Tensor) -> torch.Tensor:
    """campplus_forward without autograd, on the device of `p` (feats may
    lie on the host): the JAX package's jitted entry. On a CUDA device one
    graph per feats shape, captured at the shape's second call
    (`runtime/graphs.py` `front_call`, program "campplus"); elsewhere
    eagerly."""
    from ...runtime import graphs

    def body(f):
        return (campplus_forward(p, cfg, f),)

    with torch.no_grad():
        return graphs.front_call(p, cfg, "campplus", (), body, feats)[0]


def load_campplus_params(path: str, device="cpu") -> Params:
    """CAM++ weights from the reference's campplus.onnx (initializer names
    follow the torch state dict) or from a .safetensors export, as fp32
    tensors on `device`. A file that does not parse raises."""
    if path.endswith(".onnx"):
        from ...utils.onnx_weights import read_onnx_initializers

        flat = {k: torch.from_numpy(v.copy()) for k, v in read_onnx_initializers(path).items()}
    else:
        from ...weights import read_safetensors

        flat = read_safetensors(path)
    required = "xvector.tdnn.linear.weight"
    if required not in flat:
        names = ", ".join(sorted(flat)[:8])
        raise ValueError(
            f"{path}: no CAM++ state-dict-style initializers found (expected "
            f"'{required}'; first names: {names} ...)")
    return {k: (v.to(torch.float32) if v.is_floating_point() else v).to(device)
            for k, v in flat.items()}
