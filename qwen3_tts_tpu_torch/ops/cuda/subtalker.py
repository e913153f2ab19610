"""The whole sub-talker frame, W8A8, with sampling.

Counterpart of `qwen3_tts_tpu/ops/pallas/subtalker.py`. On a CUDA tensor
`subtalker_frame_fused` launches the hand-written Hopper kernel, one
persistent cooperative launch per frame (csrc/subtalker.cu on the layer
engine of csrc/common.cuh); on a CPU tensor it runs the plain twin
`subtalker_frame_ref`, which follows the JAX `subtalker_frame_ref` line for
line. Any other device raises.

One frame runs 16 positions (2 prefill + 14 steps) through the code
predictor: the optional bf16 small_to_mtp projection, W8A8 matmuls with
per-row dynamic activation scales, QK-RMSNorm, RoPE, a KV cache of at most
16 slots, per-step lm-head logits, temperature, exact top-k (k-th value by a
32-step bit search), Gumbel-max sampling, and the embedding gather into
`emb_sum`. Greedy rows take temperature 1, k 0 and zero noise. The Gumbel
draw (Q-1, B, V) is made outside (from a generator, or passed in), so both
versions sample from the same numbers.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ...weights import is_int8
from ..rope import default_inv_freq, rope_tables
from ..sampling import NEG_INF, gumbel_noise
from . import build
from .talker_step import mm8, rms32, rot_half


def kth_value_bits(logits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th largest value per row by binary search over the monotone
    int32 image of the fp32 bits (32 iterations, no sort). k: (B, 1)."""
    sign = torch.tensor(-(1 << 31), dtype=torch.int32, device=logits.device)
    bits = logits.to(torch.float32).contiguous().view(torch.int32)
    keys = torch.where(bits >= 0, bits, torch.bitwise_not(bits) ^ sign)
    lo = torch.full(logits.shape[:-1] + (1,), -(1 << 31), dtype=torch.int32,
                    device=logits.device)
    hi = torch.full_like(lo, (1 << 31) - 1)
    for _ in range(32):
        mid = (lo >> 1) + (hi >> 1) + ((lo | hi) & 1)
        ge = (keys >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid - 1)
    bits_t = torch.where(lo >= 0, lo, torch.bitwise_not(lo ^ sign))
    return bits_t.view(torch.float32)


def process_logits(logits: torch.Tensor, do_sample: bool, temp: torch.Tensor,
                   top_k: torch.Tensor) -> torch.Tensor:
    """Temperature + top-k (HF semantics: mask values below the k-th);
    temp (B, 1) f32, top_k (B, 1) int32, k <= 0 or >= V keeps all."""
    if not do_sample:
        return logits
    lt = logits / temp
    V = lt.shape[-1]
    kth = kth_value_bits(lt, torch.clamp(top_k, 1, V))
    kth = torch.where((top_k > 0) & (top_k < V), kth, torch.full_like(kth, NEG_INF))
    return torch.where(lt < kth, torch.full_like(lt, NEG_INF), lt)


def sampling_inputs(sampling, rows: Optional[torch.Tensor], B: int, V: int,
                    Qm1: int, device, generator: Optional[torch.Generator] = None,
                    gumbel: Optional[torch.Tensor] = None):
    """(do_sample, temp (B, 1) f32, top_k (B, 1) int32, gumbel (Qm1, B, V) or
    None) from one SamplingParams or per-row `rows` (SamplingParams.as_row
    layout; greedy rows get temp 1, k 0 and zero noise)."""
    def noise():
        g = gumbel if gumbel is not None else gumbel_noise((Qm1, B, V), generator, device)
        return g.to(device=device, dtype=torch.float32)

    if rows is not None:
        rows = rows.to(device)
        row_on = rows[:, 3] > 0.5
        one = torch.ones((), device=device)
        temp = torch.where(row_on, torch.clamp(rows[:, 0], min=1e-6), one)
        kvec = torch.where(row_on, rows[:, 4].to(torch.int32),
                           torch.zeros((), dtype=torch.int32, device=device))
        g = torch.where(row_on[None, :, None], noise(), torch.zeros((), device=device))
        return True, temp[:, None].float(), kvec[:, None], g
    do_sample = bool(sampling.do_sample)
    temp = torch.full((B, 1), float(sampling.temperature) if do_sample else 1.0,
                      dtype=torch.float32, device=device)
    kvec = torch.full((B, 1), int(sampling.top_k), dtype=torch.int32, device=device)
    return do_sample, temp, kvec, (noise() if do_sample else None)


def _check_sampling(sampling, rows) -> None:
    if rows is None and sampling.top_p < 1.0:
        raise ValueError("fused sub-talker does not support top_p < 1")


def subtalker_frame_ref(cp: Dict[str, Any], cp_cfg, past_hidden: torch.Tensor,
                        code0_embed: torch.Tensor, sampling,
                        rows: Optional[torch.Tensor] = None,
                        gumbel: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel (the JAX `subtalker_frame_ref`).
    Returns (codes (B, Q-1) int32, emb_sum (B, 1, Ht) bf16)."""
    _check_sampling(sampling, rows)
    layers = cp["layers"]
    attn, mlp = layers["self_attn"], layers["mlp"]
    dev = past_hidden.device
    B = past_hidden.shape[0]
    Ht = past_hidden.shape[-1]
    heads, kv_heads, D = (cp_cfg.num_attention_heads,
                          cp_cfg.num_key_value_heads, cp_cfg.head_dim)
    G = heads // kv_heads
    inter = cp_cfg.intermediate_size
    Qm1, V = cp["lm_heads"].shape[:2]
    smax = Qm1 + 1
    eps = cp_cfg.rms_norm_eps
    nq, nkv = heads * D, kv_heads * D
    scale = D ** -0.5
    n_layers = attn["qkv_proj"]["weight"]["q"].shape[0]

    inv_freq = default_inv_freq(D, cp_cfg.rope_theta, device=dev)
    cos, sin = rope_tables(torch.arange(smax, device=dev)[None, :], inv_freq)
    cos, sin = cos[0], sin[0]
    do_sample, temp, kvec, gumbel = sampling_inputs(
        sampling, rows, B, V, Qm1, dev, generator, gumbel)

    kvk = torch.zeros((n_layers, smax, B * kv_heads, D), dtype=torch.bfloat16, device=dev)
    kvv = torch.zeros_like(kvk)
    pos_ids = torch.arange(smax, device=dev)[:, None]

    def project(x_raw):
        if cp.get("proj") is None:
            return x_raw
        y = x_raw.float() @ cp["proj"]["weight"].to(torch.bfloat16).float().T
        return (y + cp["proj"]["bias"].float()[None, :]).to(torch.bfloat16)

    def forward(x_raw, i):
        x = project(x_raw)
        cos_i, sin_i = cos[i:i + 1], sin[i:i + 1]
        for li in range(n_layers):
            xn = rms32(x.float(), layers["input_layernorm"]["weight"][li], eps
                       ).to(torch.bfloat16)
            qkv = mm8(xn, attn["qkv_proj"]["weight"]["q"][li],
                      attn["qkv_proj"]["weight"]["s"][li])
            q = qkv[:, :nq].reshape(B * heads, D)
            k = qkv[:, nq:nq + nkv].reshape(B * kv_heads, D)
            v = qkv[:, nq + nkv:].reshape(B * kv_heads, D)
            q = rms32(q, attn["q_norm"]["weight"][li], eps)
            k = rms32(k, attn["k_norm"]["weight"][li], eps)
            q = (q * cos_i + rot_half(q) * sin_i).to(torch.bfloat16)
            k = (k * cos_i + rot_half(k) * sin_i).to(torch.bfloat16)
            kvk[li, i] = k
            kvv[li, i] = v.to(torch.bfloat16)

            kf, vf = kvk[li].float(), kvv[li].float()
            q4 = q.reshape(B, kv_heads, G, D)
            o_groups = []
            for g in range(G):
                qg = q4[:, :, g, :].reshape(B * kv_heads, D).float()
                s = (kf * qg[None]).sum(dim=-1) * scale
                s = torch.where(pos_ids <= i, s, torch.full_like(s, NEG_INF))
                m = s.amax(dim=0, keepdim=True)
                p = torch.exp(s - m)
                p = (p / p.sum(dim=0, keepdim=True)).to(torch.bfloat16).float()
                og = (p[:, :, None] * vf).sum(dim=0)
                o_groups.append(og.reshape(B, kv_heads, 1, D))
            o = torch.cat(o_groups, dim=2).reshape(B, heads * D).to(torch.bfloat16)
            x = x + mm8(o, attn["o_proj"]["weight"]["q"][li],
                        attn["o_proj"]["weight"]["s"][li]).to(torch.bfloat16)

            xn2 = rms32(x.float(), layers["post_attention_layernorm"]["weight"][li],
                        eps).to(torch.bfloat16)
            gu = mm8(xn2, mlp["gate_up_proj"]["weight"]["q"][li],
                     mlp["gate_up_proj"]["weight"]["s"][li]).to(torch.bfloat16)
            g32 = gu[:, :inter].float()
            prod = (g32 * torch.sigmoid(g32) * gu[:, inter:].float()).to(torch.bfloat16)
            x = x + mm8(prod, mlp["down_proj"]["weight"]["q"][li],
                        mlp["down_proj"]["weight"]["s"][li]).to(torch.bfloat16)
        return rms32(x.float(), cp["norm"]["weight"], eps)

    forward(past_hidden[:, 0, :].to(torch.bfloat16), 0)
    x_raw = code0_embed[:, 0, :].to(torch.bfloat16)
    emb_sum = torch.zeros((B, Ht), dtype=torch.bfloat16, device=dev)
    codes_all = []
    for i in range(1, smax):
        hn = forward(x_raw, i)
        head = cp["lm_heads"][i - 1].to(torch.bfloat16).float()
        lt = process_logits(hn @ head.T, do_sample, temp, kvec)
        if do_sample:
            lt = lt + gumbel[i - 1]
        codes = torch.argmax(lt, dim=-1).to(torch.int32)
        codes_all.append(codes)
        row = cp["embeddings"][i - 1].to(torch.bfloat16)[codes.long()]
        emb_sum = emb_sum + row
        x_raw = row
    return torch.stack(codes_all, dim=1), emb_sum[:, None, :]


def frame_misfit(B: int, Ht: int, cp_cfg, V: int, Qm1: int,
                 has_proj: bool) -> Optional[str]:
    """The first rule of what one launch of the kernel accepts that these
    shapes break, or None: the layer engine's shapes (`build.layer_misfit`)
    at the code predictor's widths, both hidden sizes in whole 256-column
    loads, a logits row that fits shared memory, at most 16 positions, and
    a talker width equal to the code predictor's where there is no
    small_to_mtp projection (the 0.6B talker)."""
    Hc = cp_cfg.hidden_size
    misfit = build.layer_misfit(B, Hc, cp_cfg.num_attention_heads,
                                cp_cfg.num_key_value_heads, cp_cfg.head_dim,
                                cp_cfg.intermediate_size, 1)
    if misfit is not None:
        return misfit
    if Ht % 256 or Hc % 256:
        return f"talker hidden {Ht} and hidden {Hc} must be multiples of 256"
    if V > build.MAX_SMEM_ROW or V % 4:
        return f"vocab {V}: want a multiple of 4, at most {build.MAX_SMEM_ROW}"
    if Qm1 + 1 > 16:
        return f"{Qm1 + 1} positions: the kernel's attention holds 16 slots"
    if not has_proj and Hc != Ht:
        return "without a projection Hc must equal Ht"
    return None


def check_frame_shapes(B: int, Ht: int, cp_cfg, V: int, Qm1: int, has_proj: bool) -> None:
    """Raise ValueError with `frame_misfit`'s rule where the shapes break one."""
    misfit = frame_misfit(B, Ht, cp_cfg, V, Qm1, has_proj)
    build.require(misfit is None, misfit)


def config_misfit(cfg) -> Optional[str]:
    """`frame_misfit` of a talker config (`TalkerConfig`): what keeps its
    code predictor off the kernel, or None. Any batch fits (row tiles)."""
    cp_cfg = cfg.code_predictor_config
    return frame_misfit(1, cfg.hidden_size, cp_cfg, cp_cfg.vocab_size,
                        cfg.num_code_groups - 1, cp_cfg.hidden_size != cfg.hidden_size)


def _launch_state(cp: Dict[str, Any], cp_cfg, B: int, Ht: int, V: int, Qm1: int, L: int,
                  dev) -> "build.LaunchState":
    """What the wrapper keeps between frames for these weights, this batch
    size, device and stream: the converted weights, the rope tables of the
    16 positions, the engine's scratch, the frame's KV cache and the
    argument struct with every pointer that does not change."""
    Hc = cp_cfg.hidden_size
    heads, kvh, D = (cp_cfg.num_attention_heads, cp_cfg.num_key_value_heads,
                     cp_cfg.head_dim)
    inter, smax = cp_cfg.intermediate_size, Qm1 + 1
    has_proj = cp.get("proj") is not None
    wts = build.layer_weight_tensors(cp["layers"])
    extra = {"fnw": cp["norm"]["weight"], "lm_heads": cp["lm_heads"],
             "embeds": cp["embeddings"]}
    if has_proj:
        extra.update(projw=cp["proj"]["weight"], projb=cp["proj"]["bias"])

    def make(st):
        def empty(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device=dev)

        cos, sin = rope_tables(torch.arange(smax, device=dev)[None, :],
                               default_inv_freq(D, cp_cfg.rope_theta, device=dev))
        cos, sin = cos[0].contiguous(), sin[0].contiguous()
        f32 = {"fnw", "projb"}
        conv = {k: build.converted(v, torch.float32 if k in f32 else torch.bfloat16)
                for k, v in extra.items()}
        w, w_keep = build.int8_layer_weights(wts, dev)
        t, zero_bytes, t_keep = build.engine_scratch(B, Hc, heads, kvh, D, inter, 1, smax * L, dev)
        kc, vc = empty(L, B, kvh, smax, D), empty(L, B, kvh, smax, D)
        x, xraw = empty(B, Hc), empty(B, Ht)
        logits = empty(B, V, dtype=torch.float32)
        st.keep = (cos, sin, conv, w_keep, t_keep, kc, vc, x, xraw, logits)
        st.args = build.SubtalkerArgs(
            B=B, Ht=Ht, Hc=Hc, heads=heads, kvh=kvh, D=D, inter=inter, V=V, Qm1=Qm1,
            L=L, has_proj=int(has_proj), eps=cp_cfg.rms_norm_eps, scale=D ** -0.5,
            cosr=build.ptr(cos), sinr=build.ptr(sin), projw=build.ptr(conv.get("projw")),
            projb=build.ptr(conv.get("projb")), w=w, fnw=build.ptr(conv["fnw"]),
            lm_heads=build.ptr(conv["lm_heads"]), embeds=build.ptr(conv["embeds"]),
            kc=build.ptr(kc), vc=build.ptr(vc), t=t, zero_bytes=zero_bytes,
            x=build.ptr(x), xraw=build.ptr(xraw), logits=build.ptr(logits))

    key = ("subtalker", dev.index, build.stream_handle(), B, cp_cfg.rms_norm_eps,
           cp_cfg.rope_theta)
    return build.launch_state(key, list(wts.values()) + list(extra.values()), make)


def subtalker_frame_fused(cp: Dict[str, Any], cp_cfg, past_hidden: torch.Tensor,
                          code0_embed: torch.Tensor, sampling,
                          rows: Optional[torch.Tensor] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused sub-talker frame. cp: code-predictor params with int8 layer
    weights; past_hidden/code0_embed: (B, 1, Ht). Returns (codes (B, Q-1)
    int32, emb_sum (B, 1, Ht) bf16). CPU tensors run `subtalker_frame_ref`;
    CUDA tensors launch the kernel, once per row tile of at most 32 rows
    (`frame_row_tiles`), each launch adding one to
    `subtalker_frame_fused.launches`."""
    if not is_int8(cp["layers"]["self_attn"]["qkv_proj"]["weight"]):
        raise ValueError("fused sub-talker requires int8-quantized params")
    if past_hidden.device.type == "cpu":
        return subtalker_frame_ref(cp, cp_cfg, past_hidden, code0_embed, sampling,
                                   rows=rows, gumbel=gumbel, generator=generator)
    if past_hidden.device.type != "cuda":
        raise ValueError(f"fused sub-talker: unsupported device {past_hidden.device}")
    _check_sampling(sampling, rows)
    B, Ht = past_hidden.shape[0], past_hidden.shape[-1]
    build.require(tuple(code0_embed.shape) == (B, 1, Ht),
                  f"code0_embed: want {(B, 1, Ht)}, got {tuple(code0_embed.shape)}")
    return frame_row_tiles(_frame_launch, cp, cp_cfg, past_hidden, code0_embed, sampling,
                           rows=rows, gumbel=gumbel, generator=generator)


def frame_row_tiles(frame, cp: Dict[str, Any], cp_cfg, past_hidden: torch.Tensor,
                    code0_embed: torch.Tensor, sampling, rows: Optional[torch.Tensor] = None,
                    gumbel: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    max_rows: int = build.ENGINE_MAX_ROWS) -> Tuple[torch.Tensor, torch.Tensor]:
    """`frame` (one kernel launch, or the twin) over the equal row tiles of
    `build.row_tiles(B, max_rows)`, one after another: each tile gets its
    rows of past_hidden, code0_embed and the sampling rows, and its slice
    (axis 1) of the Gumbel noise, drawn once for the whole batch where none
    is passed (the same draw an untiled frame makes); its codes and emb_sum
    land in the batch's outputs."""
    B = past_hidden.shape[0]
    tiles = build.row_tiles(B, max_rows)
    if len(tiles) == 1:
        return frame(cp, cp_cfg, past_hidden, code0_embed, sampling, rows=rows,
                     gumbel=gumbel, generator=generator)
    Qm1, V = cp["lm_heads"].shape[:2]
    if gumbel is None and (rows is not None or sampling.do_sample):
        gumbel = gumbel_noise((Qm1, B, V), generator, past_hidden.device)
    codes = emb = None
    for sl in tiles:
        c, e = frame(cp, cp_cfg, past_hidden[sl], code0_embed[sl], sampling,
                     rows=None if rows is None else rows[sl],
                     gumbel=None if gumbel is None else gumbel[:, sl])
        if codes is None:
            codes = c.new_empty((B,) + c.shape[1:])
            emb = e.new_empty((B,) + e.shape[1:])
        codes[sl], emb[sl] = c, e
    return codes, emb


def _frame_launch(cp: Dict[str, Any], cp_cfg, past_hidden: torch.Tensor,
                  code0_embed: torch.Tensor, sampling, rows: Optional[torch.Tensor] = None,
                  gumbel: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel over B <= 32 rows."""
    dev = past_hidden.device
    B, Ht = past_hidden.shape[0], past_hidden.shape[-1]
    Qm1, V = cp["lm_heads"].shape[:2]
    L = cp["layers"]["self_attn"]["qkv_proj"]["weight"]["q"].shape[0]
    has_proj = cp.get("proj") is not None
    check_frame_shapes(B, Ht, cp_cfg, V, Qm1, has_proj)
    build.require(B <= build.sm_count(dev), f"batch {B}: sampling takes one block per row")
    build.same_device(dev, code0_embed=code0_embed, lm_heads=cp["lm_heads"],
                      embeddings=cp["embeddings"], norm=cp["norm"]["weight"],
                      proj=cp["proj"]["weight"] if has_proj else None)

    lib = build.load_library()
    st = _launch_state(cp, cp_cfg, B, Ht, V, Qm1, L, dev)
    do_sample, temp, kvec, g = sampling_inputs(sampling, rows, B, V, Qm1, dev,
                                               generator, gumbel)
    temp = temp[:, 0].contiguous()
    kvec = kvec[:, 0].contiguous()
    g = g.contiguous() if do_sample else None
    x0 = build.bf16(torch.cat([past_hidden, code0_embed], dim=1))
    codes = torch.empty((B, Qm1), dtype=torch.int32, device=dev)
    emb_sum = torch.empty((B, Ht), dtype=torch.bfloat16, device=dev)
    args = st.args
    args.do_sample = int(do_sample)
    args.x0, args.gumbel = build.ptr(x0), build.ptr(g)
    args.temp, args.topk = build.ptr(temp), build.ptr(kvec)
    args.codes, args.emb_sum = build.ptr(codes), build.ptr(emb_sum)
    rc = lib.qt_subtalker_frame(args, build.stream_handle())
    subtalker_frame_fused.launches += 1
    subtalker_frame_fused.last_args = args
    build.check(lib, rc, "sub-talker kernel")
    return codes, emb_sum[:, None, :]


subtalker_frame_fused.launches = 0
subtalker_frame_fused.last_args = None   # the last launch's argument struct
