"""12 Hz codec decoder, codes -> waveform (counterpart of
`qwen3_tts_tpu/models/codec12/decoder.py`).

- The split-RVQ dequantisation is folded at load time into 16 pre-projected
  codebooks, so decode is one gather + sum (`prepare_decoder_params`).
- An 8-layer sliding-window causal transformer (RoPE, RMSNorm, LayerScale).
- ConvNeXt upsampling and SnakeBeta decoder blocks with the reference's
  causal padding.
- `chunked_decode` re-decodes `left_context` frames before each chunk and
  drops their samples, as the reference's chunked decode does.
- `vocode_rows` vocodes a batch of rows, each with its own left context,
  and cuts each row's new frames out on the device (the server's packet
  egress and a stream's packet).

On a CUDA device each chunk of `chunked_decode` (with its PCM16 cast) and
each `vocode_rows` call is one replay of a captured CUDA graph
(`runtime/graphs.py` `CodecGraphs`), the counterpart of the JAX package's
one jitted program per shape; a padded call meets at most two chunk shapes,
the first chunk and the steady one with its left context.

These were XLA programs in the JAX package (no Pallas kernel), so plain
torch carries them. In float32 the decoder turns TF32 off for cuDNN
convolutions and cuBLAS matmuls (`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32`), so the card computes what the
reference computes; this sets those two process-wide flags.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...config import CodecV2DecoderConfig
from ...runtime import graphs
from ...ops.attention import attention, causal_mask
from ...ops.conv import causal_conv1d, causal_conv_transpose1d, snake_beta
from ...ops.norms import layer_norm, rms_norm
from ...ops.rope import apply_rope, default_inv_freq, rope_tables
from ...weights import numeric_children

Params = Dict[str, Any]


def _normalized_codebook(codebook: Params, eps: float = 1e-5) -> torch.Tensor:
    """EMA codebook -> embedding table: embedding_sum / clamp(usage, eps)."""
    usage = torch.clamp(codebook["cluster_usage"].to(torch.float32), min=eps)
    return codebook["embedding_sum"].to(torch.float32) / usage[:, None]


def prepare_decoder_params(params: Params, cfg: CodecV2DecoderConfig) -> Params:
    """Fold the split-RVQ output projections into the codebooks:
    dequant(codes) = W_first E_0[c_0] + W_rest sum_{k>=1} E_k[c_k], so
    E'_k = E_k W^T gives one (Q, bins, codebook_dim) gather table."""
    q = params["quantizer"]
    w_first = q["rvq_first"]["output_proj"]["weight"].to(torch.float32)[..., 0]
    w_rest = q["rvq_rest"]["output_proj"]["weight"].to(torch.float32)[..., 0]
    tables = [_normalized_codebook(layer["_codebook"]) @ w_first.T
              for layer in numeric_children(q["rvq_first"]["vq"]["layers"])]
    tables += [_normalized_codebook(layer["_codebook"]) @ w_rest.T
               for layer in numeric_children(q["rvq_rest"]["vq"]["layers"])]
    out = dict(params)
    out["_codebooks"] = torch.stack(tables, dim=0)
    return out


def rvq_dequantize(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes: (B, Q, T) int -> (B, codebook_dim, T) fp32. Ids are clamped
    into the valid range."""
    Q = codebooks.shape[0]
    if codes.shape[1] != Q:
        raise ValueError(f"Expected {Q} layers of codes, got {codes.shape[1]}")
    codes = torch.clamp(codes.long(), 0, codebooks.shape[1] - 1)
    out = codebooks[0][codes[:, 0]]
    for k in range(1, Q):
        out = out + codebooks[k][codes[:, k]]
    return out.permute(0, 2, 1)


def _transformer_layer(layer: Params, cfg: CodecV2DecoderConfig, h: torch.Tensor,
                       cos, sin, mask) -> torch.Tensor:
    B, T, _ = h.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    attn = layer["self_attn"]
    x = rms_norm(h, layer["input_layernorm"]["weight"], cfg.rms_norm_eps)
    q = (x @ attn["q_proj"]["weight"].T.to(x.dtype)).reshape(B, T, H, D)
    k = (x @ attn["k_proj"]["weight"].T.to(x.dtype)).reshape(B, T, Hkv, D)
    v = (x @ attn["v_proj"]["weight"].T.to(x.dtype)).reshape(B, T, Hkv, D)
    q, k = apply_rope(q, k, cos, sin)
    o = attention(q, k, v, mask).reshape(B, T, H * D) @ attn["o_proj"]["weight"].T.to(x.dtype)
    h = h + layer["self_attn_layer_scale"]["scale"].to(h.dtype) * o

    x = rms_norm(h, layer["post_attention_layernorm"]["weight"], cfg.rms_norm_eps)
    mlp = layer["mlp"]
    gate = F.silu(x @ mlp["gate_proj"]["weight"].T.to(x.dtype))
    up = x @ mlp["up_proj"]["weight"].T.to(x.dtype)
    down = (gate * up) @ mlp["down_proj"]["weight"].T.to(x.dtype)
    return h + layer["mlp_layer_scale"]["scale"].to(h.dtype) * down


def _linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    return x @ p["weight"].T.to(x.dtype) + p["bias"].to(x.dtype)


def pre_transformer(params: Params, cfg: CodecV2DecoderConfig,
                    x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, latent) -> (B, T, latent): input_proj -> sliding-window
    layers -> norm -> output_proj."""
    T = x.shape[1]
    h = _linear(x, params["input_proj"])
    pos = torch.arange(T, device=x.device)[None, :]
    cos, sin = rope_tables(pos, default_inv_freq(cfg.head_dim, cfg.rope_theta,
                                                 device=x.device))
    mask = causal_mask(pos, pos, sliding_window=cfg.sliding_window)
    for layer in numeric_children(params["layers"]):
        h = _transformer_layer(layer, cfg, h, cos, sin, mask)
    h = rms_norm(h, params["norm"]["weight"], cfg.rms_norm_eps)
    return _linear(h, params["output_proj"])


def _convnext_block(block: Params, x: torch.Tensor) -> torch.Tensor:
    h = causal_conv1d(x, block["dwconv"]["conv"]["weight"],
                      block["dwconv"]["conv"]["bias"], groups=x.shape[1])
    h = h.permute(0, 2, 1)
    h = layer_norm(h, block["norm"]["weight"], block["norm"]["bias"], eps=1e-6)
    h = F.gelu(_linear(h, block["pwconv1"]), approximate="none")
    h = block["gamma"].to(h.dtype) * _linear(h, block["pwconv2"])
    return x + h.permute(0, 2, 1)


def _residual_unit(unit: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    h = snake_beta(x, unit["act1"]["alpha"], unit["act1"]["beta"])
    h = causal_conv1d(h, unit["conv1"]["conv"]["weight"],
                      unit["conv1"]["conv"]["bias"], dilation=dilation)
    h = snake_beta(h, unit["act2"]["alpha"], unit["act2"]["beta"])
    h = causal_conv1d(h, unit["conv2"]["conv"]["weight"], unit["conv2"]["conv"]["bias"])
    return h + x


def _decoder_block(block: Params, cfg: CodecV2DecoderConfig, layer_idx: int,
                   x: torch.Tensor) -> torch.Tensor:
    mods = numeric_children(block["block"])
    h = snake_beta(x, mods[0]["alpha"], mods[0]["beta"])
    h = causal_conv_transpose1d(h, mods[1]["conv"]["weight"], mods[1]["conv"]["bias"],
                                stride=cfg.upsample_rates[layer_idx])
    for unit, dilation in zip(mods[2:], (1, 3, 9)):
        h = _residual_unit(unit, h, dilation)
    return h


def decode_frames(params: Params, cfg: CodecV2DecoderConfig,
                  codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Full decoder forward. codes: (B, Q, T) int -> wav (B, 1, T * upsample)
    in [-1, 1]."""
    if dtype == torch.float32:
        # full fp32 on the card (see the module docstring)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    hidden = rvq_dequantize(params["_codebooks"], codes).to(dtype)
    hidden = causal_conv1d(hidden, params["pre_conv"]["conv"]["weight"],
                           params["pre_conv"]["conv"]["bias"])
    hidden = pre_transformer(params["pre_transformer"], cfg,
                             hidden.permute(0, 2, 1)).permute(0, 2, 1)
    for i, group in enumerate(numeric_children(params["upsample"])):
        mods = numeric_children(group)
        hidden = causal_conv_transpose1d(hidden, mods[0]["conv"]["weight"],
                                         mods[0]["conv"]["bias"],
                                         stride=cfg.upsampling_ratios[i])
        hidden = _convnext_block(mods[1], hidden)
    dec = numeric_children(params["decoder"])
    wav = causal_conv1d(hidden, dec[0]["conv"]["weight"], dec[0]["conv"]["bias"])
    n_blocks = len(cfg.upsample_rates)
    for i in range(n_blocks):
        wav = _decoder_block(dec[1 + i], cfg, i, wav)
    wav = snake_beta(wav, dec[1 + n_blocks]["alpha"], dec[1 + n_blocks]["beta"])
    wav = causal_conv1d(wav, dec[2 + n_blocks]["conv"]["weight"],
                        dec[2 + n_blocks]["conv"]["bias"])
    return torch.clamp(wav, -1.0, 1.0)


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """Float waveform in [-1, 1] -> int16 PCM (round half to even)."""
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


def _decode_chunk(params: Params, cfg: CodecV2DecoderConfig, codes: torch.Tensor,
                  ctx: int, dtype, pcm16: bool) -> torch.Tensor:
    wav = decode_frames(params, cfg, codes, dtype=dtype)[..., ctx * cfg.total_upsample:]
    return to_pcm16(wav) if pcm16 else wav


def chunked_decode(params: Params, cfg: CodecV2DecoderConfig, codes: torch.Tensor,
                   chunk_size: int = 300, left_context_size: int = 25,
                   dtype=torch.float32, pcm16: bool = False) -> torch.Tensor:
    """Chunked decode: each chunk re-decodes `left_context_size` frames of
    context and drops the corresponding samples; `pcm16`: int16 samples
    (`to_pcm16`, inside each chunk's graph)."""
    total = codes.shape[-1]
    wavs = []
    start = 0
    while start < total:
        end = min(start + chunk_size, total)
        ctx = left_context_size if start - left_context_size > 0 else start
        (wav,) = graphs.codec_call(
            params, cfg, "chunk", (ctx, dtype), pcm16,
            lambda c, ctx=ctx: (_decode_chunk(params, cfg, c, ctx, dtype, pcm16),),
            codes[..., start - ctx:end])
        wavs.append(wav)
        start = end
    return torch.cat(wavs, dim=-1)


def cut_rows(params: Params, cfg: CodecV2DecoderConfig, codes: torch.Tensor,
             ctx: torch.Tensor, F_: int, pcm16: bool = False) -> torch.Tensor:
    """codes (N, Q, C + F_); ctx (N,) context frames per row. Vocode the
    batch, then gather each row's emitted span [c*up, (c + F_)*up) on the
    device, so only (N, F_*up) samples cross to the host (the JAX package's
    `_vocode_rows_compact`)."""
    wav = decode_frames(params, cfg, torch.clamp(codes.long(), min=0))[:, 0, :]
    up = wav.shape[-1] // codes.shape[-1]
    idx = ctx.long()[:, None] * up + torch.arange(F_ * up, device=wav.device)
    out = torch.gather(wav, 1, idx)
    return to_pcm16(out) if pcm16 else out


def vocode_rows(params: Params, cfg: CodecV2DecoderConfig, codes: torch.Tensor,
                ctx: torch.Tensor, F_: int, pcm16: bool = False) -> torch.Tensor:
    """`cut_rows`; codes and ctx on the host or the device. On a CUDA device
    one replay of the graph of (N, Q, C + F_, F_, pcm16)."""
    (out,) = graphs.codec_call(params, cfg, "rows", (F_,), pcm16,
                               lambda c, x: (cut_rows(params, cfg, c, x, F_, pcm16),),
                               codes, ctx)
    return out
