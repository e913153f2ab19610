"""12 Hz codec encoder, waveform -> codes (counterpart of
`qwen3_tts_tpu/models/codec12/encoder.py`): the Mimi encoder.

The reference wraps HF `MimiModel` with its decoder halves nulled out and
calls `MimiModel.encode` -> `_encode_frame` (HF modeling_mimi.py:1442-1481):
SEANet conv encoder -> 8-layer causal transformer (RoPE, LayerNorm,
LayerScale) -> strided downsample conv (replicate padding) -> split-RVQ
encode, as a nearest-codebook argmin per quantizer with the EMA codebooks
normalised once at load (`prepare_encoder_params`).

The parameter tree is the checkpoint's `encoder.*` state dict, unflattened.
These were XLA programs in the JAX package (no Pallas kernel), so plain
torch carries them, in fp32. `encode_waveform` turns TF32 off for cuDNN
convolutions and cuBLAS matmuls (process-wide, as the decoder does): an
argmin over 2048 codes is exactly where TF32's three digits would flip
codes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ...config import MimiEncoderConfig
from ...ops.attention import attention, causal_mask
from ...ops.conv import causal_conv1d
from ...ops.norms import layer_norm
from ...ops.rope import apply_rope, default_inv_freq, rope_tables
from ...weights import numeric_children

Params = Dict[str, Any]


def _resnet_block(block: Params, cfg: MimiEncoderConfig, x: torch.Tensor,
                  dilation: int) -> torch.Tensor:
    """MimiResnetBlock: [ELU, conv k=residual_kernel dil=d, ELU, conv k=1]
    (torch ModuleList indices 1 and 3), identity shortcut."""
    h = causal_conv1d(F.elu(x), block["block"]["1"]["conv"]["weight"],
                      block["block"]["1"]["conv"]["bias"], dilation=dilation,
                      pad_mode=cfg.pad_mode)
    h = causal_conv1d(F.elu(h), block["block"]["3"]["conv"]["weight"],
                      block["block"]["3"]["conv"]["bias"], pad_mode=cfg.pad_mode)
    return x + h


def seanet_encode(params: Params, cfg: MimiEncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 1, T) waveform -> (B, hidden, T') features. The layer list
    mirrors MimiEncoder.__init__ (modeling_mimi.py:444-480): conv0, then per
    downsample ratio (reversed) residual blocks, ELU and a strided conv;
    finally ELU + the last conv. ELU slots carry no parameters."""
    layers = params["layers"]
    idx = 0
    h = causal_conv1d(x, layers["0"]["conv"]["weight"], layers["0"]["conv"]["bias"],
                      pad_mode=cfg.pad_mode)
    idx += 1
    for ratio in reversed(cfg.upsampling_ratios):
        for j in range(cfg.num_residual_layers):
            h = _resnet_block(layers[str(idx)], cfg, h, cfg.dilation_growth_rate ** j)
            idx += 1
        idx += 1  # ELU slot
        h = causal_conv1d(F.elu(h), layers[str(idx)]["conv"]["weight"],
                          layers[str(idx)]["conv"]["bias"], stride=ratio,
                          pad_mode=cfg.pad_mode)
        idx += 1
    idx += 1  # final ELU slot
    return causal_conv1d(F.elu(h), layers[str(idx)]["conv"]["weight"],
                         layers[str(idx)]["conv"]["bias"], pad_mode=cfg.pad_mode)


def _transformer_layer(layer: Params, cfg: MimiEncoderConfig, h: torch.Tensor,
                       cos, sin, mask) -> torch.Tensor:
    B, T, _ = h.shape
    H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
    attn = layer["self_attn"]
    x = layer_norm(h, layer["input_layernorm"]["weight"],
                   layer["input_layernorm"]["bias"], cfg.norm_eps)
    q = (x @ attn["q_proj"]["weight"].T.to(x.dtype)).reshape(B, T, H, D)
    k = (x @ attn["k_proj"]["weight"].T.to(x.dtype)).reshape(B, T, Hkv, D)
    v = (x @ attn["v_proj"]["weight"].T.to(x.dtype)).reshape(B, T, Hkv, D)
    q, k = apply_rope(q, k, cos, sin)
    o = attention(q, k, v, mask).reshape(B, T, H * D) @ attn["o_proj"]["weight"].T.to(x.dtype)
    h = h + layer["self_attn_layer_scale"]["scale"].to(h.dtype) * o

    x = layer_norm(h, layer["post_attention_layernorm"]["weight"],
                   layer["post_attention_layernorm"]["bias"], cfg.norm_eps)
    mlp = layer["mlp"]
    x = F.gelu(x @ mlp["fc1"]["weight"].T.to(x.dtype), approximate="none")
    x = x @ mlp["fc2"]["weight"].T.to(x.dtype)
    return h + layer["mlp_layer_scale"]["scale"].to(h.dtype) * x


def encoder_transformer(params: Params, cfg: MimiEncoderConfig,
                        h: torch.Tensor) -> torch.Tensor:
    """h: (B, T, hidden) -> (B, T, hidden). Causal attention over the whole
    window: the eager Mimi path ignores `sliding_window` (modeling_mimi.py
    647-706), and the JAX package follows it."""
    T = h.shape[1]
    pos = torch.arange(T, device=h.device)[None, :]
    cos, sin = rope_tables(pos, default_inv_freq(cfg.resolved_head_dim, cfg.rope_theta,
                                                 device=h.device))
    mask = causal_mask(pos, pos)
    for layer in numeric_children(params["layers"]):
        h = _transformer_layer(layer, cfg, h, cos, sin, mask)
    return h


def _normalized_codebooks(rvq: Params, eps: float = 1e-5) -> torch.Tensor:
    """A residual VQ's EMA codebooks -> (n_q, bins, dim) fp32: embed_sum /
    clamp(cluster_usage) (MimiEuclideanCodebook.embed)."""
    tables = []
    for layer in numeric_children(rvq["layers"]):
        cb = layer["codebook"]
        usage = torch.clamp(cb["cluster_usage"].to(torch.float32), min=eps)
        tables.append(cb["embed_sum"].to(torch.float32) / usage[:, None])
    return torch.stack(tables, dim=0)


def prepare_encoder_params(params: Params, cfg: MimiEncoderConfig) -> Params:
    """Precompute the normalised codebook stacks of both RVQ halves."""
    out = dict(params)
    q = params["quantizer"]
    out["_semantic_codebooks"] = _normalized_codebooks(
        q["semantic_residual_vector_quantizer"])
    out["_acoustic_codebooks"] = _normalized_codebooks(
        q["acoustic_residual_vector_quantizer"])
    return out


def _rvq_encode(codebooks: torch.Tensor, input_proj: Optional[torch.Tensor],
                emb: torch.Tensor, num_quantizers: int) -> torch.Tensor:
    """Residual VQ encode. emb: (B, hidden, T) -> codes (B, n_q, T): per
    quantizer the argmin of |e|^2 - 2 r.e over the codebook (|r|^2 is the
    same for every entry), then subtract the chosen entry
    (MimiResidualVectorQuantizer.encode, modeling_mimi.py:1269-1303)."""
    x = emb.to(torch.float32)
    if input_proj is not None:
        x = torch.einsum("oc,bct->bot", input_proj.to(torch.float32)[..., 0], x)
    residual = x.permute(0, 2, 1)
    codes = []
    for k in range(num_quantizers):
        table = codebooks[k]
        dist = (table * table).sum(dim=-1) - 2.0 * (residual @ table.T)
        idx = torch.argmin(dist, dim=-1)
        codes.append(idx)
        residual = residual - table[idx]
    return torch.stack(codes, dim=1)


def split_rvq_encode(params: Params, cfg: MimiEncoderConfig, emb: torch.Tensor,
                     num_quantizers: Optional[int] = None) -> torch.Tensor:
    """emb: (B, hidden, T) -> codes (B, Q, T): the semantic RVQ first, the
    acoustic RVQ on the unquantised embeddings for the remaining codebooks
    (MimiSplitResidualVectorQuantizer.encode, modeling_mimi.py:1318-1345)."""
    q = params["quantizer"]
    nq = cfg.num_quantizers if num_quantizers is None else num_quantizers
    n_sem = cfg.num_semantic_quantizers

    def proj(rvq):
        ip = rvq.get("input_proj")
        return None if ip is None else ip["weight"]

    sem = _rvq_encode(params["_semantic_codebooks"],
                      proj(q["semantic_residual_vector_quantizer"]), emb, n_sem)
    if nq <= n_sem:
        return sem
    ac = _rvq_encode(params["_acoustic_codebooks"],
                     proj(q["acoustic_residual_vector_quantizer"]), emb, nq - n_sem)
    return torch.cat([sem, ac], dim=1)


def encoder_features(params: Params, cfg: MimiEncoderConfig, wav: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """wav: (B, T) -> the pre-quantisation features (B, hidden, T // 1920):
    SEANet -> transformer -> downsample conv (replicate-padded, stride 2)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h = seanet_encode(params["encoder"], cfg, wav[:, None, :].to(dtype))
    h = encoder_transformer(params["encoder_transformer"], cfg,
                            h.permute(0, 2, 1)).permute(0, 2, 1)
    ds = params["downsample"]["conv"]
    return causal_conv1d(h, ds["weight"], ds.get("bias"), stride=2, pad_mode="replicate")


def encode_waveform(params: Params, cfg: MimiEncoderConfig, wav: torch.Tensor,
                    num_quantizers: Optional[int] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """wav: (B, T) in [-1, 1] -> codes (B, Q, T // 1920) int64
    (MimiModel._encode_frame, modeling_mimi.py:1442-1481)."""
    return split_rvq_encode(params, cfg, encoder_features(params, cfg, wav, dtype),
                            num_quantizers)
