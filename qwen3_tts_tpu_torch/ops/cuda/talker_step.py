"""The whole talker decode step, W8A8, over a bf16 or an int8 KV cache.

Counterpart of `qwen3_tts_tpu/ops/pallas/talker_step.py`. On a CUDA tensor
`talker_step_fused_cache` launches the hand-written Hopper kernel chain
(csrc/talker_step.cu); on a CPU tensor it runs the plain twin
`talker_step_ref`, which follows the JAX `talker_step_ref` (mxu attention)
line for line. Any other device raises.

Per layer: RMSNorm, W8A8 qkv, QK-RMSNorm and RoPE, GQA over the cache as an
online softmax in 128-slot chunks with the current slot masked out and the
fresh K/V folded in at the end, W8A8 o_proj + residual, RMSNorm, W8A8
gate_up, SiLU(gate)*up and the down projection in C column chunks, each a
separate W8A8 product with its own activation scale added into the bf16
residual in turn. Then the final norm; the codec head runs outside.

The cache layout is (L, B, Hkv, S, D); the new slot is written in place.
int8-KV mode (int8 caches plus fp32 (L, B, Hkv, S) `k_scale`/`v_scale`):
the K scale multiplies each chunk's fp32 scores, the V scale the bf16
softmax weights before the P.V product; the fresh slot attends in bf16 and
is quantized (`kv_quantize`) on its way into the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ...config import TalkerConfig
from ...models.talker import kv_quantize
from ...weights import is_int8, matmul_t
from ..rope import default_inv_freq, rope_tables
from ..sampling import NEG_INF
from . import build

# the reference's KV chunk; the twin keeps it so CPU parity is tight
KV_CHUNK = 128


def pick_mlp_chunks(inter: int) -> int:
    """MLP column-chunk count (part of the math: the chunked down projection
    quantises each chunk's activations separately)."""
    for c in (6, 4, 2):
        if inter % c == 0:
            return c
    return 1


def _quant_rows(xf: torch.Tensor):
    """Per-row symmetric int8 quantization of fp32 activations. Returns the
    int8 values as exact small floats and the (R, 1) scales."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA a Python scalar divides as a reciprocal multiply
    xs = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    return torch.clamp(torch.round(xf / xs), -127, 127), xs


def mm8(x_bf: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """(R, IN) bf16 @ (OUT, IN) int8 -> (R, OUT) fp32, W8A8. The integer
    product is exact in float64 (|sum| < 2**53), so casting it to fp32 rounds
    exactly as the int32 accumulator of the kernel does."""
    xq, xs = _quant_rows(x_bf.to(torch.float32))
    acc = (xq.to(torch.float64) @ wq.to(torch.float64).T).to(torch.float32)
    return acc * xs * ws.to(torch.float32)[None, :]


def rms32(xf: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.to(torch.float32)[None, :]


def rot_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _bias(cfg: TalkerConfig, cache_index, kv_valid: torch.Tensor, S: int) -> torch.Tensor:
    """(B, S) additive f32 bias: the current slot is masked out (it is folded
    in separately), as are invalid and out-of-window slots."""
    dev = kv_valid.device
    ci = torch.as_tensor(cache_index, device=dev)
    ci_col = ci.reshape(-1, 1) if ci.ndim == 1 else ci
    slot = torch.arange(S, device=dev)[None, :]
    ok = (slot < ci_col) & kv_valid[:, :S]
    if cfg.sliding_window is not None:
        ok = ok & (slot > (ci_col - cfg.sliding_window))
    zero = torch.zeros((), device=dev)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _write_slot(cache: torch.Tensor, new: torch.Tensor, cache_index) -> None:
    """cache (L, B, Hkv, S[, D])[:, b, :, ci_b] = new (L, B, Hkv[, D]), in
    place."""
    ci = torch.as_tensor(cache_index, device=cache.device)
    if ci.ndim == 1:
        rows = torch.arange(cache.shape[1], device=cache.device)
        # advanced indices on axes 1 and 3 put the batch axis first
        cache[:, rows, :, ci.long()] = new.transpose(0, 1).to(cache.dtype)
    else:
        cache[:, :, :, int(ci)] = new.to(cache.dtype)


def talker_step_ref(params: Dict[str, Any], cfg: TalkerConfig,
                    embed: torch.Tensor, position: torch.Tensor, cache_index,
                    kv_valid: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, attend_len: Optional[int] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None):
    """Plain-torch twin of the kernel (the JAX `talker_step_ref`, mxu
    attention). Returns (logits (B, V) f32, hidden (B, 1, H), k_cache,
    v_cache) with the new slot written in place, plus (k_scale, v_scale) in
    int8-KV mode (a 6-tuple, as the JAX function)."""
    quant_kv = k_scale is not None
    layers = params["layers"]
    attn, mlp = layers["self_attn"], layers["mlp"]
    B, _, H = embed.shape
    heads, kv_heads, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                          cfg.resolved_head_dim)
    G = heads // kv_heads
    nq, nkv = heads * D, kv_heads * D
    inter = mlp["gate_up_proj"]["weight"]["q"].shape[1] // 2
    L = attn["qkv_proj"]["weight"]["q"].shape[0]
    S = k_cache.shape[3] if attend_len is None else attend_len
    # the JAX kernel takes one whole-window chunk for short odd windows
    Sc = KV_CHUNK if (S % KV_CHUNK == 0 or S > 3 * KV_CHUNK) else S
    nS = -(-S // Sc)
    eps = cfg.rms_norm_eps
    scale = D ** -0.5
    C = pick_mlp_chunks(inter)
    Ic = inter // C

    inv_freq = default_inv_freq(D, cfg.rope_theta, device=embed.device)
    cos, sin = rope_tables(position[:, None], inv_freq)
    cos, sin = cos[:, 0], sin[:, 0]
    bias = _bias(cfg, cache_index, kv_valid, S)[:, None, :]

    x = embed[:, 0, :].to(torch.bfloat16)
    newks, newvs = [], []
    for li in range(L):
        xn = rms32(x.float(), layers["input_layernorm"]["weight"][li], eps
                   ).to(torch.bfloat16)
        qkv = mm8(xn, attn["qkv_proj"]["weight"]["q"][li],
                  attn["qkv_proj"]["weight"]["s"][li])
        q = qkv[:, :nq].reshape(B * heads, D)
        k = qkv[:, nq:nq + nkv].reshape(B * kv_heads, D)
        v = qkv[:, nq + nkv:].reshape(B * kv_heads, D)
        q = rms32(q, attn["q_norm"]["weight"][li], eps)
        k = rms32(k, attn["k_norm"]["weight"][li], eps)
        cq, sq = cos.repeat_interleave(heads, 0), sin.repeat_interleave(heads, 0)
        q = (q * cq + rot_half(q) * sq).to(torch.bfloat16)
        ck, sk = cos.repeat_interleave(kv_heads, 0), sin.repeat_interleave(kv_heads, 0)
        k = (k * ck + rot_half(k) * sk).to(torch.bfloat16)
        v = v.to(torch.bfloat16)
        newks.append(k.reshape(B, kv_heads, D))
        newvs.append(v.reshape(B, kv_heads, D))

        qb = q.reshape(B * kv_heads, G, D).float()
        m = torch.full((B * kv_heads, G), NEG_INF, device=x.device)
        den = torch.zeros((B * kv_heads, G), device=x.device)
        acc = torch.zeros((B * kv_heads, G, D), device=x.device)
        for c in range(nS):
            sl = slice(c * Sc, min((c + 1) * Sc, S))
            kf = k_cache[li, :, :, sl].reshape(B * kv_heads, -1, D).float()
            vf = v_cache[li, :, :, sl].reshape(B * kv_heads, -1, D).float()
            s = torch.einsum("bgd,bsd->bgs", qb, kf)
            if quant_kv:
                s = s * k_scale[li, :, :, sl].reshape(B * kv_heads, 1, -1)
            bc = bias[:, :, sl].reshape(B, 1, 1, -1).expand(
                B, kv_heads, G, kf.shape[1]).reshape(B * kv_heads, G, -1)
            s = s * scale + bc
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None]).to(torch.bfloat16).float()
            den = den * corr + e.sum(dim=-1)
            if quant_kv:
                e = (e * v_scale[li, :, :, sl].reshape(B * kv_heads, 1, -1)
                     ).to(torch.bfloat16).float()
            pv = torch.einsum("bgs,bsd->bgd", e, vf)
            acc = acc * corr[..., None] + pv
            m = m_new
        knf = newks[-1].reshape(B * kv_heads, 1, D).float()
        vnf = newvs[-1].reshape(B * kv_heads, 1, D).float()
        s_new = (qb * knf).sum(dim=-1) * scale
        m_tot = torch.maximum(m, s_new)
        corr = torch.exp(m - m_tot)
        e_new = torch.exp(s_new - m_tot).to(torch.bfloat16).float()
        dd = den * corr + e_new
        og = (acc * corr[..., None] + e_new[..., None] * vnf) / dd[..., None]
        o = og.reshape(B, heads * D)
        x = x + mm8(o.to(torch.bfloat16), attn["o_proj"]["weight"]["q"][li],
                    attn["o_proj"]["weight"]["s"][li]).to(torch.bfloat16)

        xn2 = rms32(x.float(), layers["post_attention_layernorm"]["weight"][li],
                    eps).to(torch.bfloat16)
        guq = mlp["gate_up_proj"]["weight"]["q"][li]
        gus = mlp["gate_up_proj"]["weight"]["s"][li]
        for c in range(C):
            gate = mm8(xn2, guq[c * Ic:(c + 1) * Ic],
                       gus[c * Ic:(c + 1) * Ic]).to(torch.bfloat16)
            up = mm8(xn2, guq[inter + c * Ic:inter + (c + 1) * Ic],
                     gus[inter + c * Ic:inter + (c + 1) * Ic]).to(torch.bfloat16)
            g32 = gate.float()
            prod = (g32 * torch.sigmoid(g32) * up.float()).to(torch.bfloat16)
            part = mm8(prod, mlp["down_proj"]["weight"]["q"][li][:, c * Ic:(c + 1) * Ic],
                       mlp["down_proj"]["weight"]["s"][li])
            x = x + part.to(torch.bfloat16)

    h = rms32(x.float(), params["norm"]["weight"], eps).to(torch.bfloat16)
    newk, newv = torch.stack(newks), torch.stack(newvs)
    if quant_kv:
        (newk, newk_s), (newv, newv_s) = kv_quantize(newk), kv_quantize(newv)
        _write_slot(k_scale, newk_s, cache_index)
        _write_slot(v_scale, newv_s, cache_index)
    _write_slot(k_cache, newk, cache_index)
    _write_slot(v_cache, newv, cache_index)
    logits = matmul_t(h.float(), params["codec_head"])
    out = (logits, h[:, None, :].to(embed.dtype), k_cache, v_cache)
    return out + (k_scale, v_scale) if quant_kv else out


def talker_step_fused_cache(params: Dict[str, Any], cfg: TalkerConfig,
                            embed: torch.Tensor, position: torch.Tensor,
                            cache_index, kv_valid: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            attend_len: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None):
    """One fused decode step. embed: (B, 1, H); position: (B,); cache_index:
    an int (whole-batch write slot) or (B,) per-row slots; kv_valid: (B, S)
    incl. the new slot; k_cache/v_cache: (L, B, Hkv, S_buf, D) bf16, or
    int8 together with fp32 (L, B, Hkv, S_buf) k_scale/v_scale.

    Returns (logits (B, V) f32, hidden (B, 1, H), k_cache, v_cache), the new
    slot written in place, plus (k_scale, v_scale) in int8-KV mode. CPU
    tensors run `talker_step_ref`; CUDA tensors launch the kernel, each
    launch adding one to `talker_step_fused_cache.launches` (bf16 KV) or
    `.launches_int8_kv` (int8 KV). An int slot is checked on the host; a
    per-row slot tensor is not (that would cost a sync per step): a slot
    outside the buffer makes the kernel trap, and the next sync raises, as
    the twin raises IndexError. The serving engine never hands one over
    (`ContinuousBatchingEngine` caps every budget to its buffer).
    """
    layers = params["layers"]
    if not is_int8(layers["self_attn"]["qkv_proj"]["weight"]):
        raise ValueError("fused talker step requires int8-quantized params")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode takes both k_scale and v_scale")
    quant_kv = k_scale is not None
    if embed.device.type == "cpu":
        return talker_step_ref(params, cfg, embed, position, cache_index,
                               kv_valid, k_cache, v_cache, attend_len,
                               k_scale=k_scale, v_scale=v_scale)
    if embed.device.type != "cuda":
        raise ValueError(f"fused talker step: unsupported device {embed.device}")

    B, _, H = embed.shape
    dev = embed.device
    heads, kvh, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.resolved_head_dim)
    inter = layers["mlp"]["gate_up_proj"]["weight"]["q"].shape[1] // 2
    L = layers["self_attn"]["qkv_proj"]["weight"]["q"].shape[0]
    S_buf = k_cache.shape[3]
    S = S_buf if attend_len is None else attend_len
    C = pick_mlp_chunks(inter)
    build.check_layer_shapes(H, heads, kvh, D, inter, C)
    kv_dtype = torch.int8 if quant_kv else torch.bfloat16
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        build.require(c.dtype == kv_dtype and c.is_contiguous() and c.is_cuda
                      and tuple(c.shape) == (L, B, kvh, S_buf, D),
                      f"{name}: want contiguous {kv_dtype} CUDA (L, B, Hkv, S, D) = "
                      f"{(L, B, kvh, S_buf, D)}, got {tuple(c.shape)} {c.dtype}")
    if quant_kv:
        build.require(D % 16 == 0, f"int8 KV: head_dim {D} must be a multiple of 16")
        for name, c in (("k_scale", k_scale), ("v_scale", v_scale)):
            build.require(c.dtype == torch.float32 and c.is_contiguous() and c.is_cuda
                          and tuple(c.shape) == (L, B, kvh, S_buf),
                          f"{name}: want contiguous float32 CUDA (L, B, Hkv, S) = "
                          f"{(L, B, kvh, S_buf)}, got {tuple(c.shape)} {c.dtype}")
    build.require(0 < S <= S_buf and tuple(kv_valid.shape) == (B, S_buf)
                  and kv_valid.dtype == torch.bool,
                  "kv_valid: want (B, S_buf) bool and 0 < attend_len <= S_buf")

    build.same_device(dev, k_cache=k_cache, v_cache=v_cache, kv_valid=kv_valid,
                      k_scale=k_scale, v_scale=v_scale,
                      norm=params["norm"]["weight"])
    lib = build.load_library()
    inv_freq = default_inv_freq(D, cfg.rope_theta, device=dev)
    cos, sin = rope_tables(position.to(dev)[:, None], inv_freq)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    ci = torch.as_tensor(cache_index, device=dev).to(torch.int32)
    ci = (ci if ci.ndim == 1 else ci.expand(B)).contiguous()
    # the kernel writes slot ci of every row: a Python int is checked here
    # without a sync, a per-row tensor by the kernel (it traps)
    build.require(ci.shape == (B,) and (not isinstance(cache_index, int)
                                        or 0 <= cache_index < S_buf),
                  f"cache_index must be in [0, {S_buf}), one per row")
    valid = kv_valid.contiguous()
    x0 = build.bf16(embed[:, 0, :])
    # the tensors behind each struct's pointers must outlive the call
    w, _w_tensors = build.int8_layer_weights(layers, dev)
    t, _t_tensors = build.layer_scratch(B, H, heads, kvh, D, inter, C, dev)
    fnw = build.f32(params["norm"]["weight"])
    x = torch.empty((B, H), dtype=torch.bfloat16, device=dev)
    h = torch.empty((B, H), dtype=torch.bfloat16, device=dev)
    # int8 mode: this layer's fresh bf16 K/V, which the attention folds in
    # at finalize (the cache slot holds its int8 quantization)
    fresh = (torch.empty((2, B, kvh, D), dtype=torch.bfloat16, device=dev)
             if quant_kv else None)
    kv = build.KVPtrs(kc=build.ptr(k_cache), vc=build.ptr(v_cache),
                      ks=build.ptr(k_scale), vs=build.ptr(v_scale),
                      knew=build.ptr(None if fresh is None else fresh[0]),
                      vnew=build.ptr(None if fresh is None else fresh[1]))
    args = build.TalkerStepArgs(
        B=B, H=H, heads=heads, kvh=kvh, D=D, inter=inter, nseg=C, L=L,
        S_buf=S_buf, S_att=S, window=cfg.sliding_window or 0, ld_valid=S_buf,
        eps=cfg.rms_norm_eps, scale=D ** -0.5,
        embed=build.ptr(x0), cosr=build.ptr(cos), sinr=build.ptr(sin),
        ci=build.ptr(ci), valid=build.ptr(valid), w=w, fnw=build.ptr(fnw),
        kv=kv, t=t, x=build.ptr(x), h=build.ptr(h))
    rc = lib.qt_talker_step(args, build.stream_handle())
    if quant_kv:
        talker_step_fused_cache.launches_int8_kv += 1
    else:
        talker_step_fused_cache.launches += 1
    build.check(lib, rc, "talker step kernel")
    logits = matmul_t(h.float(), params["codec_head"])
    out = (logits, h[:, None, :].to(embed.dtype), k_cache, v_cache)
    return out + (k_scale, v_scale) if quant_kv else out


talker_step_fused_cache.launches = 0
talker_step_fused_cache.launches_int8_kv = 0


def kv_store_rows(x: torch.Tensor):
    """The kernel's int8-KV store applied to given rows: x (R, D) bf16, D <=
    128 -> (int8 (R, D), fp32 scales (R,)), which must equal `kv_quantize(x)`
    bit for bit. No decode path calls it: it holds the device quantizer to
    the rule on chosen values (rounding ties, tiny rows). CPU tensors run
    `kv_quantize`."""
    if x.device.type == "cpu":
        return kv_quantize(x)
    R, D = x.shape
    build.require(x.dtype == torch.bfloat16 and x.is_cuda and D <= 128,
                  f"kv_store_rows: want (R, D <= 128) bf16 CUDA, got {tuple(x.shape)} "
                  f"{x.dtype}")
    x = x.contiguous()
    q = torch.empty((R, D), dtype=torch.int8, device=x.device)
    s = torch.empty((R,), dtype=torch.float32, device=x.device)
    fresh = torch.empty_like(x)
    lib = build.load_library()
    build.check(lib, lib.qt_kv_store_rows(build.ptr(x), R, D, build.ptr(q), build.ptr(s),
                                          build.ptr(fresh), build.stream_handle()),
                "kv store kernel")
    return q, s
