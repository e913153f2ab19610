"""The whole talker decode step, W8A8, over a bf16 or an int8 KV cache.

Counterpart of `qwen3_tts_tpu/ops/pallas/talker_step.py`. On a CUDA tensor
`talker_step_fused_cache` launches the hand-written Hopper kernel, one
persistent cooperative launch per step (csrc/talker_step.cu on the layer
engine of csrc/common.cuh); on a CPU tensor it runs the plain twin
`talker_step_ref`, which follows the JAX `talker_step_ref` (mxu attention)
line for line. Any other device raises.

Per layer: RMSNorm, W8A8 qkv, QK-RMSNorm and RoPE, GQA over the cache as an
online softmax in 128-slot chunks with the current slot masked out and the
fresh K/V folded in at the end (the kernel cuts the window into `kv_splits`
runs of chunks, each with its own online softmax, and folds the partial
sums in order before the fresh slot; `talker_step_ref(..., kv_splits=S)` is
that order in plain PyTorch, 1 the one-pass order), W8A8 o_proj + residual, RMSNorm, W8A8
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


def config_misfit(cfg: TalkerConfig) -> Optional[str]:
    """The first rule of the layer engine (`build.layer_misfit`, the launch
    check's) that a talker config breaks in the kernel, or None. Any batch
    fits (row tiles)."""
    inter = cfg.intermediate_size
    return build.layer_misfit(1, cfg.hidden_size, cfg.num_attention_heads,
                              cfg.num_key_value_heads, cfg.resolved_head_dim, inter,
                              pick_mlp_chunks(inter))


def pick_kv_splits(B: int, kv_heads: int, attend_len: int, blocks: int) -> int:
    """Window splits of the kernel's attention: enough (row, kv head, split)
    items to cover `blocks` SMs, in whole 128-slot chunks, at most
    `build.KV_SPLITS_MAX`. Split s takes chunks [s * cps, (s + 1) * cps) with
    cps = ceil(chunks / splits), and no split is empty."""
    nchunks = -(-attend_len // KV_CHUNK)
    # a split pays for its fold with at least two chunks
    want = max(1, min(build.KV_SPLITS_MAX, nchunks // 2, blocks // (B * kv_heads)))
    cps = -(-nchunks // want)
    return -(-nchunks // cps)


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
                    v_scale: Optional[torch.Tensor] = None, kv_splits: int = 1):
    """Plain-torch twin of the kernel (the JAX `talker_step_ref`, mxu
    attention). Returns (logits (B, V) f32, hidden (B, 1, H), k_cache,
    v_cache) with the new slot written in place, plus (k_scale, v_scale) in
    int8-KV mode (a 6-tuple, as the JAX function). `kv_splits` > 1 is the
    kernel's split-K order: the window's chunks in that many runs, each an
    online softmax from an empty state, the partial (m, l, acc) folded in
    run order, then the fresh slot; 1 is the reference's one pass."""
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
    if kv_splits < 1:
        raise ValueError(f"kv_splits must be >= 1, got {kv_splits}")
    cps = -(-nS // kv_splits)   # chunks per split
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
        parts = []
        for c0 in range(0, nS, cps):
            m = torch.full((B * kv_heads, G), NEG_INF, device=x.device)
            den = torch.zeros((B * kv_heads, G), device=x.device)
            acc = torch.zeros((B * kv_heads, G, D), device=x.device)
            for c in range(c0, min(c0 + cps, nS)):
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
            parts.append((m, den, acc))
        m, den, acc = parts[0]
        for m_b, den_b, acc_b in parts[1:]:
            m_t = torch.maximum(m, m_b)
            wa, wb = torch.exp(m - m_t), torch.exp(m_b - m_t)
            den = den * wa + den_b * wb
            acc = acc * wa[..., None] + acc_b * wb[..., None]
            m = m_t
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


def _launch_state(params, cfg: TalkerConfig, B: int, inter: int, C: int, L: int,
                  dev) -> "build.LaunchState":
    """What the wrapper keeps between calls for these weights, this batch
    size, device and stream: the converted weights, the engine's
    scratch, the rope frequencies and the argument struct with every pointer
    that does not change from step to step."""
    H = cfg.hidden_size
    heads, kvh, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.resolved_head_dim)
    wts = build.layer_weight_tensors(params["layers"])
    final_norm = params["norm"]["weight"]

    def make(st):
        fnw = build.converted(final_norm, torch.float32)
        w, w_keep = build.int8_layer_weights(wts, dev)
        t, zero_bytes, t_keep = build.engine_scratch(B, H, heads, kvh, D, inter, C, L, dev)
        x = torch.empty((B, H), dtype=torch.bfloat16, device=dev)
        st.inv_freq = default_inv_freq(D, cfg.rope_theta, device=dev)
        st.ci = torch.empty((B,), dtype=torch.int32, device=dev)
        st.keep = (fnw, w_keep, t_keep, x)
        st.args = build.TalkerStepArgs(
            B=B, H=H, heads=heads, kvh=kvh, D=D, inter=inter, nseg=C, L=L,
            window=cfg.sliding_window or 0, eps=cfg.rms_norm_eps, scale=D ** -0.5,
            w=w, fnw=build.ptr(fnw), t=t, zero_bytes=zero_bytes, x=build.ptr(x))

    key = ("talker_step", dev.index, build.stream_handle(), B, cfg.sliding_window,
           cfg.rms_norm_eps, cfg.rope_theta)
    return build.launch_state(key, list(wts.values()) + [final_norm], make)


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
    tensors run `talker_step_ref`; CUDA tensors launch the kernel, once per
    row tile of at most 32 rows (`step_row_tiles`), each launch adding one
    to `talker_step_fused_cache.launches` (bf16 KV) or `.launches_int8_kv`
    (int8 KV). An int slot is checked on the host; a per-row slot tensor is
    not (that would cost a sync per step): a slot outside the buffer makes
    the kernel trap, and the next sync raises, as the twin raises
    IndexError. The serving engine never hands one over
    (`ContinuousBatchingEngine` caps every budget to its buffer).
    """
    layers = params["layers"]
    if not is_int8(layers["self_attn"]["qkv_proj"]["weight"]):
        raise ValueError("fused talker step requires int8-quantized params")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8-KV mode takes both k_scale and v_scale")
    if embed.device.type == "cpu":
        return talker_step_ref(params, cfg, embed, position, cache_index,
                               kv_valid, k_cache, v_cache, attend_len,
                               k_scale=k_scale, v_scale=v_scale)
    if embed.device.type != "cuda":
        raise ValueError(f"fused talker step: unsupported device {embed.device}")
    return step_row_tiles(_step_launch, params, cfg, embed, position, cache_index, kv_valid,
                          k_cache, v_cache, attend_len, k_scale, v_scale)


def step_row_tiles(step, params: Dict[str, Any], cfg: TalkerConfig, embed: torch.Tensor,
                   position: torch.Tensor, cache_index, kv_valid: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   attend_len: Optional[int] = None, k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None,
                   max_rows: int = build.ENGINE_MAX_ROWS):
    """`step` (one kernel launch, or the twin) over the equal row tiles of
    `build.row_tiles(B, max_rows)`, one after another: each tile gets its
    rows of embed, position, per-row slots and kv_valid and views of its
    rows of the caches and scales, which it writes in place (rows are
    independent in the step). Returns what `step` returns for the batch."""
    tiles = build.row_tiles(embed.shape[0], max_rows)
    if len(tiles) == 1:
        return step(params, cfg, embed, position, cache_index, kv_valid, k_cache, v_cache,
                    attend_len, k_scale=k_scale, v_scale=v_scale)
    ci = cache_index
    per_row = not isinstance(ci, int) and torch.as_tensor(ci).ndim == 1
    logits = hidden = None
    for sl in tiles:
        lg, h = step(params, cfg, embed[sl], position[sl], ci[sl] if per_row else ci,
                     kv_valid[sl], k_cache[:, sl], v_cache[:, sl], attend_len,
                     k_scale=None if k_scale is None else k_scale[:, sl],
                     v_scale=None if v_scale is None else v_scale[:, sl])[:2]
        if logits is None:
            logits = lg.new_empty((embed.shape[0],) + lg.shape[1:])
            hidden = h.new_empty((embed.shape[0],) + h.shape[1:])
        logits[sl], hidden[sl] = lg, h
    out = (logits, hidden, k_cache, v_cache)
    return out + (k_scale, v_scale) if k_scale is not None else out


def _cache_rows(c: torch.Tensor) -> int:
    """Rows of the contiguous (L, rows, ...) tensor of which `c` is a slice
    of rows (its own rows when it is contiguous); 0 when it is neither."""
    if c.is_contiguous():
        return c.shape[1]
    row = c[0, 0]
    if row.is_contiguous() and c.stride(1) == row.numel() and c.stride(0) % c.stride(1) == 0:
        return c.stride(0) // c.stride(1)
    return 0


def _step_launch(params: Dict[str, Any], cfg: TalkerConfig, embed: torch.Tensor,
                 position: torch.Tensor, cache_index, kv_valid: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 attend_len: Optional[int] = None, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
    """One launch of the kernel over B <= 32 rows. The caches (and scales)
    are contiguous or a slice of rows of contiguous ones (a row tile): the
    kernel takes the rows of the whole cache for its layer stride."""
    layers = params["layers"]
    quant_kv = k_scale is not None
    B, _, H = embed.shape
    dev = embed.device
    heads, kvh, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.resolved_head_dim)
    inter = layers["mlp"]["gate_up_proj"]["weight"]["q"].shape[1] // 2
    L = layers["self_attn"]["qkv_proj"]["weight"]["q"].shape[0]
    S_buf = k_cache.shape[3]
    S = S_buf if attend_len is None else attend_len
    C = pick_mlp_chunks(inter)
    build.check_layer_shapes(B, H, heads, kvh, D, inter, C)
    rows = _cache_rows(k_cache)
    kv_dtype = torch.int8 if quant_kv else torch.bfloat16
    caches = (("k_cache", k_cache), ("v_cache", v_cache))
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if quant_kv else ()
    for name, c in caches + scales:
        want = (L, B, kvh, S_buf, D) if name.endswith("cache") else (L, B, kvh, S_buf)
        dtype = kv_dtype if name.endswith("cache") else torch.float32
        build.require(c.dtype == dtype and c.is_cuda and tuple(c.shape) == want
                      and rows >= B and _cache_rows(c) == rows,
                      f"{name}: want {dtype} CUDA {want}, rows of one contiguous cache, "
                      f"got {tuple(c.shape)} {c.dtype}")
    if quant_kv:
        build.require(D % 16 == 0, f"int8 KV: head_dim {D} must be a multiple of 16")
    build.require(0 < S <= S_buf and tuple(kv_valid.shape) == (B, S_buf)
                  and kv_valid.dtype == torch.bool,
                  "kv_valid: want (B, S_buf) bool and 0 < attend_len <= S_buf")

    build.same_device(dev, k_cache=k_cache, v_cache=v_cache, kv_valid=kv_valid,
                      k_scale=k_scale, v_scale=v_scale,
                      norm=params["norm"]["weight"])
    lib = build.load_library()
    st = _launch_state(params, cfg, B, inter, C, L, dev)
    cos, sin = rope_tables(position.to(dev)[:, None], st.inv_freq)
    cos, sin = cos[:, 0].contiguous(), sin[:, 0].contiguous()
    if isinstance(cache_index, int):
        # the kernel writes slot ci of every row: a Python int is checked here
        # without a sync, a per-row tensor by the kernel (it traps). A graph
        # would bake the int into its fill: captured steps take a tensor.
        build.require(not torch.cuda.is_current_stream_capturing(),
                      "a captured talker step takes cache_index as a device tensor")
        build.require(0 <= cache_index < S_buf, f"cache_index must be in [0, {S_buf})")
        ci = st.ci.fill_(cache_index)
    else:
        ci = torch.as_tensor(cache_index, device=dev).to(torch.int32)
        ci = (ci if ci.ndim == 1 else ci.expand(B)).contiguous()
        build.require(ci.shape == (B,), f"cache_index: want one slot per row, got {ci.shape}")
    valid = kv_valid.contiguous()
    x0 = build.bf16(embed[:, 0, :])
    h = torch.empty((B, H), dtype=torch.bfloat16, device=dev)
    args = st.args
    # S_att, kv_splits and kv_cps are host values: a captured graph keeps the
    # ones of its capture, which is right only because attend_len (and the
    # buffer, hence S_buf) is part of every graph's key (runtime/graphs.py)
    args.S_buf, args.S_att, args.ld_valid, args.cache_rows = S_buf, S, S_buf, rows
    args.kv_splits = pick_kv_splits(B, kvh, S, build.sm_count(dev))
    args.kv_cps = -(-(-(-S // KV_CHUNK)) // args.kv_splits)
    args.embed, args.cosr, args.sinr = build.ptr(x0), build.ptr(cos), build.ptr(sin)
    args.ci, args.valid, args.h = build.ptr(ci), build.ptr(valid), build.ptr(h)
    args.kv.kc, args.kv.vc = build.ptr(k_cache), build.ptr(v_cache)
    args.kv.ks, args.kv.vs = build.ptr(k_scale), build.ptr(v_scale)
    rc = lib.qt_talker_step(args, build.stream_handle())
    talker_step_fused_cache.last_args = args
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
talker_step_fused_cache.last_args = None   # the last launch's argument struct


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
    lib = build.load_library()
    build.check(lib, lib.qt_kv_store_rows(build.ptr(x), R, D, build.ptr(q), build.ptr(s),
                                          build.stream_handle()), "kv store kernel")
    return q, s


def engine_gemm(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                paired: bool = False) -> torch.Tensor:
    """The layer engine's quantiser and GEMM stage alone: x (B <= 32, K) bf16
    is quantised per row and multiplied with wq (N, K) int8 (a column slice of a wider
    matrix is taken through its row stride), out (B, N) f32 = `mm8(x, wq,
    ws)`, bit for bit: the int32 sums are exact in any order. `paired` runs
    the gate_up tiling (rows [0, N/2) and [N/2, N) share each mma tile). No
    decode path calls it: it holds the stage to the twin on its own. CPU
    tensors run `mm8`."""
    if x.device.type == "cpu":
        return mm8(x, wq, ws)
    B, K = x.shape
    N = wq.shape[0]
    build.require(x.dtype == torch.bfloat16 and x.is_cuda and x.stride(1) == 1
                  and 1 <= B <= build.ENGINE_MAX_ROWS and x.stride(0) % 8 == 0,
                  f"engine_gemm: want (B <= 32, K) bf16 CUDA rows, got {tuple(x.shape)} {x.dtype}")
    build.require(wq.dtype == torch.int8 and tuple(wq.shape) == (N, K) and wq.stride(1) == 1
                  and wq.stride(0) % 16 == 0 and K % 256 == 0 and K <= 4096
                  and N % (16 if paired else 8) == 0,
                  f"engine_gemm: want (N, K) int8 rows, K % 256 == 0, K <= 4096, got "
                  f"{tuple(wq.shape)}")
    build.same_device(x.device, wq=wq, ws=ws)
    ws = build.f32(ws)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    bar = torch.zeros((2,), dtype=torch.int32, device=x.device)
    xq_g = torch.empty((B, K), dtype=torch.int8, device=x.device)
    xs_g = torch.empty((B,), dtype=torch.float32, device=x.device)
    args = build.GemmProbeArgs(B=B, N=N, K=K, ldx=x.stride(0), ldw=wq.stride(0),
                               paired=int(paired), x=build.ptr(x), wq=build.ptr(wq),
                               ws=build.ptr(ws), out=build.ptr(out), bar=build.ptr(bar),
                               xq_g=build.ptr(xq_g), xs_g=build.ptr(xs_g))
    lib = build.load_library()
    build.check(lib, lib.qt_gemm_probe(args, build.stream_handle()), "engine GEMM stage")
    return out


def grid_barriers(n: int, device) -> None:
    """Launch the engine's cooperative grid (one block per SM) through `n`
    grid barriers and nothing else: what one barrier costs on the card."""
    bar = torch.zeros((2,), dtype=torch.int32, device=device)
    lib = build.load_library()
    build.check(lib, lib.qt_barrier_probe(build.BarrierProbeArgs(n=n, bar=build.ptr(bar)),
                                          build.stream_handle()), "barrier probe")
