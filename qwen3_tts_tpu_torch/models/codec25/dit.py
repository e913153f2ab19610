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

A velocity evaluation is two parts: `dit_condition`, what does not depend on
x or t (the internal ECAPA over the reference mel, the input embedding's
fixed columns, the RoPE tables and the distinct block biases), which the
sampler computes once a call, and `dit_velocity`, which every step runs.
`dit_forward` is their composition. On a CUDA device the sampler's step is
one graph replay (`runtime/graphs.py` `step_loop`, the counterpart of
`_dit_sample_jit`), captured at the call of a key that
`graphs.DIT_CAPTURE_CALL` names; the RoPE tables and the time grid are built
once per device, since a graph cannot copy from pageable host memory.

Plain PyTorch in fp32: the JAX code was XLA (no Pallas kernel).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Dict, List, Tuple

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


def _rope_np(seq_len: int, head_dim: int, theta: float) -> Tuple[np.ndarray, np.ndarray]:
    """cos, sin (T, head_dim) fp32, each frequency twice (its pair), built in
    float64 numpy as the JAX package builds them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    freqs = np.arange(seq_len)[:, None] * inv[None, :]
    freqs = np.stack([freqs, freqs], axis=-1).reshape(seq_len, -1)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


@lru_cache(maxsize=64)
def _dit_rope_tables(seq_len: int, head_dim: int, theta: float, device) -> tuple:
    """`_rope_np` on `device`, built at the first call of its arguments (a
    step graph copies them into its own buffers, so one evicted here is
    safe)."""
    return tuple(torch.from_numpy(a).to(device) for a in _rope_np(seq_len, head_dim, theta))


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


def _mask_kinds(cfg: DiTConfig) -> List[Tuple[int, int]]:
    """(look-back, look-ahead) in blocks of each layer."""
    return [(int(i in cfg.look_backward_layers), int(i in cfg.look_ahead_layers))
            for i in range(cfg.num_hidden_layers)]


def dit_condition(params: Params, cfg: DiTConfig, spk_vec: torch.Tensor,
                  ref_mel: torch.Tensor, code_embed: torch.Tensor) -> tuple:
    """What every velocity evaluation of a call reads and no step changes:
    (fixed, cos, sin, *biases). `fixed` (B, T, enc_dim + emb_dim + enc_emb)
    is the input embedding's columns after x (the internal ECAPA of ref_mel
    over every frame, code_embed, spk_vec); cos, sin the RoPE tables; one
    block bias per distinct (look-back, look-ahead) of the layers, in sorted
    order. Arguments as `dit_forward`'s."""
    T = code_embed.shape[1]
    # input embed (reference DiTInputEmbedding 426-456)
    cond = speaker_encoder_forward(params["input_embed"]["spk_encoder"],
                                   speaker_config(cfg), ref_mel)   # (B, enc_dim)
    fixed = torch.cat([cond[:, None, :].expand(-1, T, -1), code_embed, spk_vec], dim=-1)
    cos, sin = _dit_rope_tables(T, cfg.head_dim, cfg.rope_theta, code_embed.device)
    biases = [_block_bias(T, cfg.block_size, back, ahead, code_embed.device)
              for back, ahead in sorted(set(_mask_kinds(cfg)))]
    return (fixed, cos, sin, *biases)


def dit_velocity(params: Params, cfg: DiTConfig, cond: tuple, x: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """One velocity evaluation over the call's `dit_condition`. x: (B, T,
    mel); t: (B,)."""
    fixed, cos, sin, *biases = cond
    t_emb = _timestep_embed(params["time_embed"], t)
    h = _linear(params["input_embed"]["proj"], torch.cat([x, fixed], dim=-1))
    kinds = _mask_kinds(cfg)
    order = sorted(set(kinds))
    for i, kind in enumerate(kinds):
        h = _dit_layer(params["transformer_blocks"][str(i)], cfg, h, t_emb, cos, sin,
                       biases[order.index(kind)])

    scale, shift = torch.chunk(_linear(params["norm_out"]["linear"], F.silu(t_emb)), 2, dim=1)
    h = _ln_no_affine(h) * (1 + scale)[:, None, :] + shift[:, None, :]
    return _linear(params["proj_out"], h)


def dit_forward(params: Params, cfg: DiTConfig, x: torch.Tensor, spk_vec: torch.Tensor,
                ref_mel: torch.Tensor, code_embed: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """One velocity evaluation. x: (B, T, mel); spk_vec: (B, T, enc_emb);
    ref_mel: (B, Tr, mel); code_embed: (B, T, emb_dim); t: (B,). The caller
    batches the CFG halves."""
    return dit_velocity(params, cfg, dit_condition(params, cfg, spk_vec, ref_mel, code_embed),
                        x, t)


def time_schedule(num_steps: int, sway_coefficient) -> torch.Tensor:
    """The sampler's time grid (fp32, on the host): linspace(0, 1) bent by
    the sway schedule."""
    ts = torch.linspace(0.0, 1.0, num_steps, dtype=torch.float32)
    if sway_coefficient is not None:
        ts = ts + sway_coefficient * (torch.cos(math.pi / 2 * ts) - 1 + ts)
    return ts


@lru_cache(maxsize=16)
def time_grid(num_steps: int, sway_coefficient, device) -> torch.Tensor:
    """`time_schedule` on `device`, copied there at the first call of its
    arguments."""
    return time_schedule(num_steps, sway_coefficient).to(device)


def dit_step(params: Params, cfg: DiTConfig, guidance_scale: float, y: torch.Tensor,
             t0: torch.Tensor, t1: torch.Tensor, *cond: torch.Tensor) -> tuple:
    """One Euler step y += v(y, t0) * (t1 - t0), y (B, T, mel) written in
    place; t0, t1 0-d; `cond` the call's `dit_condition`, over both CFG
    halves where guidance_scale >= 1e-5. Returns no output (a step graph's
    body)."""
    B = y.shape[0]
    if guidance_scale >= 1e-5:
        out = dit_velocity(params, cfg, cond, torch.cat([y, y], dim=0), t0.expand(2 * B))
        cond_out, uncond_out = torch.chunk(out, 2, dim=0)
        v = cond_out + (cond_out - uncond_out) * guidance_scale
    else:
        v = dit_velocity(params, cfg, cond, y, t0.expand(B))
    y.add_(v * (t1 - t0))
    return ()


def dit_sample(params: Params, cfg: DiTConfig, codes: torch.Tensor, xvector: torch.Tensor,
               ref_mel: torch.Tensor, noise: torch.Tensor, num_steps: int = 10,
               guidance_scale: float = 0.5,
               sway_coefficient: float = -1.0) -> torch.Tensor:
    """Euler ODE over the flow field -> mel (B, mel_dim, T * repeats).
    codes: (B, Tc) int; noise: (B, Tc * repeats, mel) fp32, the caller's
    (not written). The conditioning runs once, eagerly; the steps through
    `graphs.step_loop`, keyed by the shapes the step reads ((B, Tc), the CFG
    batch) and guidance_scale: num_steps and the sway only change the grid."""
    from ...runtime import graphs

    T = codes.shape[1] * cfg.repeats
    table = params["text_embed"]["codec_embed"]["weight"]
    code_embed = table[codes.long()].repeat_interleave(cfg.repeats, dim=1)
    spk = xvector[:, None, :].expand(-1, T, -1)
    if guidance_scale >= 1e-5:   # the CFG halves as one batch
        uncond = table[torch.zeros_like(codes).long()].repeat_interleave(cfg.repeats, dim=1)
        spk = torch.cat([spk, torch.zeros_like(spk)], dim=0)
        ref_mel = torch.cat([ref_mel, torch.zeros_like(ref_mel)], dim=0)
        code_embed = torch.cat([code_embed, uncond], dim=0)
    cond = dit_condition(params, cfg, spk, ref_mel, code_embed)
    grid = time_grid(num_steps, sway_coefficient, noise.device)

    def body(y, t0, t1, *c):
        return dit_step(params, cfg, guidance_scale, y, t0, t1, *c)

    y = graphs.step_loop(params, cfg, (float(guidance_scale),), body, noise, grid, *cond)
    return y.permute(0, 2, 1)
