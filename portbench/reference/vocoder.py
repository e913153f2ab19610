"""Plain PyTorch reference of the Qwen3-TTS 12 Hz tokenizer's decoder
(codes -> 24 kHz waveform), and of the server's streamed packets.

From the published decoder: the split-RVQ dequantisation as 16 pre-projected
codebooks (a gather and a sum), a causal conv, an 8-layer sliding-window
causal transformer (RoPE, RMSNorm, LayerScale), ConvNeXt upsampling, and
SnakeBeta decoder blocks with the reference codec's causal padding; the
output clamped to [-1, 1]. Float32; TF32 is off unless the control asks
for it.

A streamed packet of frames [s, s + k) is decoded with c = min(left
context, s + reference frames) frames of context before it (a voice clone's
reference codes would lead its history), and its samples are the last k
frames'.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

Tree = Dict[str, Any]
F32 = torch.float32


def _children(d: Tree):
    return [d[k] for k in sorted((k for k in d if k.isdigit()), key=int)]


def _pad_amounts(length: int, k: int, stride: int, dilation: int):
    eff = (k - 1) * dilation + 1
    total = eff - stride
    n = (length - eff + total) / stride + 1
    ideal = (math.ceil(n) - 1) * stride + (eff - total)
    return total, ideal - length


def causal_conv(x, p, stride=1, dilation=1, groups=1):
    w, b = p["weight"], p["bias"]
    left, extra = _pad_amounts(x.shape[-1], w.shape[-1], stride, dilation)
    x = F.pad(x, (left, max(extra, 0)))
    return F.conv1d(x, w.to(F32), b.to(F32), stride=stride, dilation=dilation, groups=groups)


def causal_tconv(x, p, stride):
    w = p["weight"]
    out = F.conv_transpose1d(x, w.to(F32), p["bias"].to(F32), stride=stride)
    right = w.shape[-1] - stride
    return out[..., :-right] if right > 0 else out


def snake(x, p):
    a = torch.exp(p["alpha"].to(F32))[None, :, None]
    b = torch.exp(p["beta"].to(F32))[None, :, None]
    s = torch.sin(x * a)
    return x + (1.0 / (b + 1e-9)) * s * s


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def _layer_norm(x, w, b, eps):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * w.to(F32) + b.to(F32)


def _lin(x, p):
    return x @ p["weight"].to(F32).T + p["bias"].to(F32)


def transformer(p: Tree, c: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """(B, T, latent) -> (B, T, latent)."""
    B, T, _ = x.shape
    H, Hkv, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    h = _lin(x, p["input_proj"])
    pos = torch.arange(T, device=x.device, dtype=F32)
    inv = 1.0 / (c["rope_theta"] ** (torch.arange(0, D, 2, dtype=F32, device=x.device) / D))
    ang = pos[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    i = torch.arange(T, device=x.device)
    ok = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - c["sliding_window"])

    def rot(t):
        return t * cos + torch.cat([-t[..., D // 2:], t[..., :D // 2]], -1) * sin

    for lp in _children(p["layers"]):
        a = lp["self_attn"]
        y = _rms(h, lp["input_layernorm"]["weight"], c["rms_norm_eps"])
        q = rot((y @ a["q_proj"]["weight"].to(F32).T).reshape(B, T, H, D))
        k = rot((y @ a["k_proj"]["weight"].to(F32).T).reshape(B, T, Hkv, D))
        v = (y @ a["v_proj"]["weight"].to(F32).T).reshape(B, T, Hkv, D)
        k, v = k.repeat_interleave(H // Hkv, dim=2), v.repeat_interleave(H // Hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
        s = s.masked_fill(~ok, float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, T, H * D)
        h = h + lp["self_attn_layer_scale"]["scale"].to(F32) * (o @ a["o_proj"]["weight"].to(F32).T)
        y = _rms(h, lp["post_attention_layernorm"]["weight"], c["rms_norm_eps"])
        m = lp["mlp"]
        down = ((F.silu(y @ m["gate_proj"]["weight"].to(F32).T) * (y @ m["up_proj"]["weight"].to(F32).T))
                @ m["down_proj"]["weight"].to(F32).T)
        h = h + lp["mlp_layer_scale"]["scale"].to(F32) * down
    h = _rms(h, p["norm"]["weight"], c["rms_norm_eps"])
    return _lin(h, p["output_proj"])


def decode(p: Tree, c: Dict[str, Any], codes: torch.Tensor) -> torch.Tensor:
    """codes (B, Q, T) -> waveform (B, T * upsample) in [-1, 1]."""
    books = p["_codebooks"].to(F32)
    codes = torch.clamp(codes.long(), 0, books.shape[1] - 1)
    x = sum(books[k][codes[:, k]] for k in range(books.shape[0])).permute(0, 2, 1)
    x = causal_conv(x, p["pre_conv"]["conv"])
    x = transformer(p["pre_transformer"], c, x.permute(0, 2, 1)).permute(0, 2, 1)
    for i, g in enumerate(_children(p["upsample"])):
        m = _children(g)
        x = causal_tconv(x, m[0]["conv"], c["upsampling_ratios"][i])
        blk = m[1]
        y = causal_conv(x, blk["dwconv"]["conv"], groups=x.shape[1]).permute(0, 2, 1)
        y = _layer_norm(y, blk["norm"]["weight"], blk["norm"]["bias"], 1e-6)
        y = F.gelu(_lin(y, blk["pwconv1"]))
        y = blk["gamma"].to(F32) * _lin(y, blk["pwconv2"])
        x = x + y.permute(0, 2, 1)
    dec = _children(p["decoder"])
    x = causal_conv(x, dec[0]["conv"])
    n = len(c["upsample_rates"])
    for i in range(n):
        mods = _children(dec[1 + i]["block"])
        x = causal_tconv(snake(x, mods[0]), mods[1]["conv"], c["upsample_rates"][i])
        for unit, dil in zip(mods[2:], (1, 3, 9)):
            y = causal_conv(snake(x, unit["act1"]), unit["conv1"]["conv"], dilation=dil)
            x = x + causal_conv(snake(y, unit["act2"]), unit["conv2"]["conv"])
    x = causal_conv(snake(x, dec[1 + n]), dec[2 + n]["conv"])
    return torch.clamp(x[:, 0], -1.0, 1.0)


def packet(p: Tree, c: Dict[str, Any], history: torch.Tensor, start: int, count: int,
           ctx0: int, left_context: int) -> torch.Tensor:
    """The samples of a streamed packet of `count` frames from generated
    frame `start`, over `history` ((ctx0 + n, Q): the request's reference
    frames, then its generated ones)."""
    lo_gen = ctx0 + start
    ctx = min(left_context, lo_gen)
    codes = history[lo_gen - ctx:lo_gen + count].T[None]
    up = 1
    for r in list(c["upsampling_ratios"]) + list(c["upsample_rates"]):
        up *= r
    return decode(p, c, codes)[0, ctx * up:(ctx + count) * up]
