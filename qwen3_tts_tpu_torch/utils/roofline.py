"""Analytic roofline model for the talker decode tick: FLOPs and device
memory bytes per generated frame, against the card's peaks.

Counterpart of `qwen3_tts_tpu/utils/roofline.py`, with the same counting
rules and keys:

  mfu                      achieved FLOP/s / peak bf16 FLOP/s
  hbm_bw_util              achieved bytes/s / peak device memory rate
  pct_of_dma_floor         (weight + KV bytes / peak rate) / tick time: how
                           close the tick runs to its memory-bound speed of
                           light
  pct_of_achievable_floor  the same against a rate measured on this card
                           (`utils/dma_peak.py` `shaped_bw`, the talker
                           step's own fetch set); None when no rate is given

Counting rules (decode, one tick = one frame for every sequence in batch):
- matmul FLOPs = 2·M·N·K; attention scores+values = 4·heads·head_dim·S per
  query token. Elementwise/norm FLOPs are ignored (<<1%).
- weight bytes: each matmul weight is read once per tick (batch-amortized).
  int8 tensors count 1 byte/elem, bf16 2 (per-channel scales are
  negligible).
- KV bytes: K and V of every attended slot, per layer per sequence (int8
  KV: 1 byte/elem + an fp32 scale per (slot, head)).
- the sub-talker runs Q_sub = num_code_groups positions per frame; with
  `fused_subtalker` its layer weights count once per frame, the least a
  frame needs (the port's kernel reads them at every position: 78 MB at
  1.7B fits neither the L2 nor shared memory), else Q_sub times; all 15
  lm_heads stream once per frame.

Peaks default to the NVIDIA H100 SXM data sheet (dense) and are overridable
(kwargs or env BENCH_PEAK_BF16_TFLOPS / BENCH_PEAK_INT8_TOPS /
BENCH_HBM_GBPS). The achievable rate has no default: pass the one measured
in the same run (`achievable_gbps=`), or set BENCH_ACHIEVABLE_GBPS, which
overrides it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

from ..config import TalkerConfig

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
H100_BF16_TFLOPS = 989.0
H100_INT8_TOPS = 1979.0
H100_HBM_GBPS = 3350.0
H100_FP32_TFLOPS = 67.0      # outside the tensor cores


def _env(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


@dataclass(frozen=True)
class Peaks:
    bf16_flops: float
    int8_ops: float
    hbm_bytes: float
    fp32_flops: float = H100_FP32_TFLOPS * 1e12

    @classmethod
    def from_env(cls) -> "Peaks":
        return cls(
            bf16_flops=_env("BENCH_PEAK_BF16_TFLOPS", H100_BF16_TFLOPS) * 1e12,
            int8_ops=_env("BENCH_PEAK_INT8_TOPS", H100_INT8_TOPS) * 1e12,
            hbm_bytes=_env("BENCH_HBM_GBPS", H100_HBM_GBPS) * 1e9)


def _linear_flops(h_in: int, h_out: int) -> int:
    return 2 * h_in * h_out


def talker_flops_per_frame(cfg: TalkerConfig, attend_len: int) -> int:
    """Matmul+attention FLOPs for ONE sequence advancing ONE frame
    (talker step + full sub-talker frame + heads)."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    D = cfg.resolved_head_dim
    nq = cfg.num_attention_heads * D
    nkv = cfg.num_key_value_heads * D
    per_layer = (_linear_flops(H, nq + 2 * nkv)     # qkv
                 + _linear_flops(nq, H)             # o
                 + _linear_flops(H, 2 * I) + _linear_flops(I, H)  # mlp
                 + 4 * nq * attend_len)             # scores + values
    talker = cfg.num_hidden_layers * per_layer + _linear_flops(H, cfg.vocab_size)

    cp = cfg.code_predictor_config
    Hc, Ic = cp.hidden_size, cp.intermediate_size
    Dc = cp.head_dim
    nqc = cp.num_attention_heads * Dc
    nkvc = cp.num_key_value_heads * Dc
    q_sub = cfg.num_code_groups          # positions per frame (2 + Q-2)
    s_sub = q_sub + 1
    cp_layer = (_linear_flops(Hc, nqc + 2 * nkvc) + _linear_flops(nqc, Hc)
                + _linear_flops(Hc, 2 * Ic) + _linear_flops(Ic, Hc)
                + 4 * nqc * s_sub)
    sub = q_sub * cp.num_hidden_layers * cp_layer
    if Hc != H:
        sub += q_sub * _linear_flops(H, Hc)          # small_to_mtp projection
    sub += (cfg.num_code_groups - 1) * _linear_flops(Hc, cp.vocab_size)
    return talker + sub


def _layer_weight_elems(h: int, i: int, nq: int, nkv: int) -> int:
    return h * (nq + 2 * nkv) + nq * h + 3 * h * i


def talker_bytes_per_tick(cfg: TalkerConfig, batch: int, attend_len: int,
                          weight_bytes: int = 1, kv_bytes: int = 2,
                          fused_subtalker: bool = True,
                          head_bytes: int = 2) -> Dict[str, int]:
    """Device memory bytes moved per tick (ALL sequences advance one frame).

    weight_bytes: 1 for int8 layer weights, 2 for bf16. kv_bytes: 2 for
    bf16 KV, 1 for int8 (scales added on top). head_bytes: sub-talker
    lm_heads / embeddings dtype (not quantized by quantize_talker_params).
    """
    H, I = cfg.hidden_size, cfg.intermediate_size
    D = cfg.resolved_head_dim
    nq = cfg.num_attention_heads * D
    nkv = cfg.num_key_value_heads * D
    w_talker = (cfg.num_hidden_layers * _layer_weight_elems(H, I, nq, nkv)
                * weight_bytes
                + H * cfg.vocab_size * weight_bytes)   # codec head (int8 too)

    cp = cfg.code_predictor_config
    Hc, Ic, Dc = cp.hidden_size, cp.intermediate_size, cp.head_dim
    nqc = cp.num_attention_heads * Dc
    nkvc = cp.num_key_value_heads * Dc
    reads = 1 if fused_subtalker else cfg.num_code_groups
    w_sub = (cp.num_hidden_layers * _layer_weight_elems(Hc, Ic, nqc, nkvc)
             * weight_bytes * reads
             + (cfg.num_code_groups - 1) * Hc * cp.vocab_size * head_bytes)

    kv = (batch * cfg.num_hidden_layers * attend_len
          * cfg.num_key_value_heads * D * 2 * kv_bytes)
    if kv_bytes == 1:   # int8 KV: fp32 scale per (slot, head), k and v
        kv += (batch * cfg.num_hidden_layers * attend_len
               * cfg.num_key_value_heads * 2 * 4)
    return {"weights": w_talker + w_sub, "kv": kv,
            "total": w_talker + w_sub + kv}


def decode_roofline(cfg: TalkerConfig, batch: int, attend_len: int,
                    tick_seconds: float, weight_bytes: int = 1,
                    kv_bytes: int = 2, fused_subtalker: bool = True,
                    peaks: Optional[Peaks] = None,
                    achievable_gbps: Optional[float] = None) -> Dict[str, Optional[float]]:
    """Situate a measured decode tick time against the card.

    Returns mfu / hbm_bw_util / pct_of_dma_floor plus the underlying
    per-tick flops, bytes and the DMA-floor tick time; the achievable floor
    and its share from `achievable_gbps` (BENCH_ACHIEVABLE_GBPS overrides
    it), None with neither.
    """
    peaks = peaks or Peaks.from_env()
    flops = batch * talker_flops_per_frame(cfg, attend_len)
    bytes_ = talker_bytes_per_tick(cfg, batch, attend_len,
                                   weight_bytes=weight_bytes,
                                   kv_bytes=kv_bytes,
                                   fused_subtalker=fused_subtalker)
    t_floor = bytes_["total"] / peaks.hbm_bytes
    rate = os.environ.get("BENCH_ACHIEVABLE_GBPS", achievable_gbps)
    t_ach = None if rate is None else bytes_["total"] / (float(rate) * 1e9)
    return {
        "flops_per_tick": float(flops),
        "bytes_per_tick": float(bytes_["total"]),
        "weight_bytes_per_tick": float(bytes_["weights"]),
        "kv_bytes_per_tick": float(bytes_["kv"]),
        "dma_floor_ms": t_floor * 1e3,
        "achievable_floor_ms": None if t_ach is None else t_ach * 1e3,
        "tick_ms": tick_seconds * 1e3,
        "mfu": flops / tick_seconds / peaks.bf16_flops,
        "hbm_bw_util": bytes_["total"] / tick_seconds / peaks.hbm_bytes,
        "pct_of_dma_floor": t_floor / tick_seconds,
        "pct_of_achievable_floor": None if t_ach is None else t_ach / tick_seconds,
    }
