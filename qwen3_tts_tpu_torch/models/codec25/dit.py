"""DiT flow-matching decoder (codes -> mel) of the 25 Hz tokenizer
(counterpart of `qwen3_tts_tpu/models/codec25/dit.py`; reference
Qwen3TTSTokenizerV1DecoderDiTModel, modeling...v1.py:1071-1226):

- block-local attention (block 24) with per-layer look-back / look-ahead
  masks (DiTDecoderLayer 663-695);
- AdaLN-Zero timestep conditioning (477-510) and a final norm without
  affine; RoPE over interleaved (even, odd) pairs (535-567), which is not
  the talker's `ops/rope.rotate_half`;
- the internal ECAPA speaker encoder over the reference mel (342-423,
  `models/speaker_encoder.py` with a config built from the DiT's);
- the classifier-free-guidance Euler sampler with the sway time schedule
  (sample, 1171-1226): a fixed number of steps, a plain Python loop here
  where the JAX package runs a `lax.scan`. The noise is the caller's.

Plain PyTorch in fp32: the JAX code was XLA (no Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ...config import DiTConfig, SpeakerEncoderConfig
from ...ops.attention import attention, mask_to_bias
from ..speaker_encoder import speaker_encoder_forward

Params = Dict[str, Any]


def _linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["weight"].T.to(x.dtype) + p["bias"].to(x.dtype)


def _ln_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _rotate_half_pairs(x: torch.Tensor) -> torch.Tensor:
    """(-x2, x1) over interleaved pairs (reference rotate_half_codec)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def _dit_rope_tables(seq_len: int, head_dim: int, theta: float, device):
    """cos, sin (T, head_dim) fp32, each frequency twice (its pair), built in
    float64 numpy as the JAX package builds them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.arange(seq_len)[:, None] * inv[None, :]
    freqs = np.stack([freqs, freqs], axis=-1).reshape(seq_len, -1)
    return (torch.as_tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(freqs), dtype=torch.float32, device=device))


def _timestep_embed(p: Params, t: torch.Tensor, dim_freq: int = 256) -> torch.Tensor:
    """SinusPositionEmbedding + MLP (reference 634-660). t: (B,)."""
    half = dim_freq // 2
    scale = math.log(10000) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -scale)
    emb = 1000.0 * t.to(torch.float32)[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    return _linear(p["time_mlp"]["2"], F.silu(_linear(p["time_mlp"]["0"], emb)))


def _dit_layer(lp: Params, cfg: DiTConfig, x: torch.Tensor, t_emb: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
    B, T, _ = x.shape
    H, hd = cfg.num_attention_heads, cfg.head_dim
    ada = _linear(lp["attn_norm"]["linear"], F.silu(t_emb))
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = torch.chunk(ada, 6, dim=1)
    norm = _ln_no_affine(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]

    ap = lp["attn"]
    q = _linear(ap["to_q"], norm).reshape(B, T, H, hd)
    k = _linear(ap["to_k"], norm).reshape(B, T, H, hd)
    v = _linear(ap["to_v"], norm).reshape(B, T, H, hd)
    cosb, sinb = cos[None, :, None, :], sin[None, :, None, :]
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    q = (qf * cosb + _rotate_half_pairs(qf) * sinb).to(x.dtype)
    k = (kf * cosb + _rotate_half_pairs(kf) * sinb).to(x.dtype)
    o = _linear(ap["to_out"]["0"], attention(q, k, v, mask_bias).reshape(B, T, H * hd))
    x = x + gate_msa[:, None] * o

    norm = _ln_no_affine(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
    ff = lp["ff"]["ff"]
    h = _linear(ff["3"], F.gelu(_linear(ff["0"], norm), approximate="tanh"))
    return x + gate_mlp[:, None] * h


def _block_bias(seq_len: int, block_size: int, look_back: int, look_ahead: int,
                device) -> torch.Tensor:
    blocks = torch.arange(seq_len, device=device) // block_size
    diff = blocks[None, :] - blocks[:, None]
    return mask_to_bias(((diff >= -look_back) & (diff <= look_ahead))[None, None])


def speaker_config(cfg: DiTConfig) -> SpeakerEncoderConfig:
    """The internal ECAPA's config, built from the DiT's (res2net scale 2)."""
    return SpeakerEncoderConfig(
        mel_dim=cfg.mel_dim, enc_dim=cfg.enc_dim, enc_channels=cfg.enc_channels,
        enc_kernel_sizes=cfg.enc_kernel_sizes, enc_dilations=cfg.enc_dilations,
        enc_attention_channels=cfg.enc_attention_channels,
        enc_res2net_scale=cfg.enc_res2net_scale, enc_se_channels=cfg.enc_se_channels)


def dit_forward(params: Params, cfg: DiTConfig, x: torch.Tensor, spk_vec: torch.Tensor,
                ref_mel: torch.Tensor, code_embed: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """One velocity evaluation. x: (B, T, mel); spk_vec: (B, T, enc_emb);
    ref_mel: (B, Tr, mel); code_embed: (B, T, emb_dim); t: (B,). The caller
    batches the CFG halves."""
    T = x.shape[1]
    t_emb = _timestep_embed(params["time_embed"], t)
    # input embed (reference DiTInputEmbedding 426-456)
    cond = speaker_encoder_forward(params["input_embed"]["spk_encoder"],
                                   speaker_config(cfg), ref_mel)   # (B, enc_dim)
    cond = cond[:, None, :].expand(-1, T, -1)
    h = _linear(params["input_embed"]["proj"],
                torch.cat([x, cond, code_embed, spk_vec], dim=-1))

    cos, sin = _dit_rope_tables(T, cfg.head_dim, cfg.rope_theta, x.device)
    for i in range(cfg.num_hidden_layers):
        bias = _block_bias(T, cfg.block_size, int(i in cfg.look_backward_layers),
                           int(i in cfg.look_ahead_layers), x.device)
        h = _dit_layer(params["transformer_blocks"][str(i)], cfg, h, t_emb, cos, sin, bias)

    scale, shift = torch.chunk(_linear(params["norm_out"]["linear"], F.silu(t_emb)), 2, dim=1)
    h = _ln_no_affine(h) * (1 + scale)[:, None, :] + shift[:, None, :]
    return _linear(params["proj_out"], h)


def time_schedule(num_steps: int, sway_coefficient) -> torch.Tensor:
    """The sampler's time grid (fp32, on the host): linspace(0, 1) bent by
    the sway schedule."""
    ts = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    if sway_coefficient is not None:
        ts = ts + sway_coefficient * (torch.cos(math.pi / 2 * ts) - 1 + ts)
    return ts


def dit_sample(params: Params, cfg: DiTConfig, codes: torch.Tensor, xvector: torch.Tensor,
               ref_mel: torch.Tensor, noise: torch.Tensor, num_steps: int = 10,
               guidance_scale: float = 0.5,
               sway_coefficient: float = -1.0) -> torch.Tensor:
    """Euler ODE over the flow field -> mel (B, mel_dim, T * repeats).
    codes: (B, Tc) int; noise: (B, Tc * repeats, mel) fp32, the caller's."""
    B, Tc = codes.shape
    T = Tc * cfg.repeats
    table = params["text_embed"]["codec_embed"]["weight"]
    code_embed = table[codes.long()].repeat_interleave(cfg.repeats, dim=1)
    code_embed_uncond = table[torch.zeros_like(codes).long()].repeat_interleave(
        cfg.repeats, dim=1)
    spk = xvector[:, None, :].expand(-1, T, -1)
    ts = time_schedule(num_steps, sway_coefficient).to(noise.device)
    use_cfg = guidance_scale >= 1e-5
    if use_cfg:
        spk2 = torch.cat([spk, torch.zeros_like(spk)], dim=0)
        ref2 = torch.cat([ref_mel, torch.zeros_like(ref_mel)], dim=0)
        code2 = torch.cat([code_embed, code_embed_uncond], dim=0)

    y = noise
    for i in range(num_steps - 1):
        t0, t1 = ts[i], ts[i + 1]
        if use_cfg:
            out = dit_forward(params, cfg, torch.cat([y, y], dim=0), spk2, ref2, code2,
                              t0.expand(2 * B))
            cond_out, uncond_out = torch.chunk(out, 2, dim=0)
            v = cond_out + (cond_out - uncond_out) * guidance_scale
        else:
            v = dit_forward(params, cfg, y, spk, ref_mel, code_embed, t0.expand(B))
        y = y + v * (t1 - t0)
    return y.permute(0, 2, 1)
