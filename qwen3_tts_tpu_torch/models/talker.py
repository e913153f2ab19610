"""Talker LM + code predictor (counterpart of `qwen3_tts_tpu/models/talker.py`).

Qwen3-style decoder layers (GQA with per-head QK-RMSNorm, SwiGLU MLP,
RMSNorm pre-norms); the talker's 3-axis mrope carries identical positions
for TTS, so it runs as 1-D RoPE on the mask-cumsum positions.

Layers are stacked along a leading axis as in the JAX package (so one tree
converts leaf by leaf), and a Python loop walks them. The KV cache has one
layout everywhere, (L, B, Hkv, S, D): the fused talker step wants it, and
keeping prefill and the plain decode step on the same layout saves the
transposes the JAX package does at each change of path. The cache is
updated in place. Training (SFT) passes `cache=None` to `decoder_stack` /
`talker_prefill`: attention then reads the call's fresh K/V and nothing is
written, so autograd never sees an in-place write to a tensor it saved. An int8 cache (`KVCache.zeros(..., quantized=True)`)
stores per-(slot, head) symmetric int8 with fp32 scale planes
(L, B, Hkv, S), quantized on the way in (`kv_quantize`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import CodePredictorConfig, TalkerConfig
from ..ops.attention import attention, attention_kv_quant, mask_to_bias
from ..ops.cuda.prefill_attention import flash_misfit, flash_prefill
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, default_inv_freq, rope_tables
from ..ops.sampling import process_and_sample, process_and_sample_rows
from ..parallel.mesh import Mesh, copy_to_tp, gather_from_tp, reduce_from_tp, tp_splits
from ..weights import matmul_t, numeric_children, stack_layers, weight_rows

Params = Dict[str, Any]

# Prefills of this many tokens or more attend through the flash prefill
# kernel (ops/cuda/prefill_attention.py) instead of the dense masked path,
# where the kernel takes their shapes (`prefill_uses_flash`).
# Set from the H100's A/B of whole 1.7B prefills at B=4 (chip_smoke.py
# `phase_prefill_ab`): flash won at every measured T from 256 to 2048 (the
# JAX package keeps 2048, a TPU measurement). Tests lower it to run the
# kernel's path at small shapes.
FLASH_PREFILL_MIN_T = 256


@dataclass(frozen=True)
class StackDims:
    """Shape info shared by the talker and code-predictor decoder stacks.

    Under a mesh (`parallel/mesh.py`) the head counts are this rank's: the
    attention is split over tp when tp divides the KV heads (then
    `attn_mesh` is the mesh its collectives run on), the MLP when it divides
    the intermediate width (`mlp_mesh`), as `tp_shard_plan` splits the
    weights."""

    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    eps: float
    attn_mesh: Optional[Mesh] = None
    mlp_mesh: Optional[Mesh] = None

    @classmethod
    def _local(cls, hidden, heads, kv_heads, head_dim, eps, inter,
               mesh: Optional[Mesh]) -> "StackDims":
        attn = mesh if tp_splits(kv_heads, mesh) else None
        if attn is not None:
            heads, kv_heads = heads // mesh.tp, kv_heads // mesh.tp
        return cls(hidden, heads, kv_heads, head_dim, eps, attn,
                   mesh if tp_splits(inter, mesh) else None)

    @classmethod
    def from_talker(cls, cfg: TalkerConfig, mesh: Optional[Mesh] = None) -> "StackDims":
        return cls._local(cfg.hidden_size, cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.resolved_head_dim,
                          cfg.rms_norm_eps, cfg.intermediate_size, mesh)

    @classmethod
    def from_code_predictor(cls, cfg: CodePredictorConfig,
                            mesh: Optional[Mesh] = None) -> "StackDims":
        return cls._local(cfg.hidden_size, cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.head_dim, cfg.rms_norm_eps,
                          cfg.intermediate_size, mesh)


def head_logits(x: torch.Tensor, w, vocab: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """x @ w.T of a vocabulary head (`matmul_t`); under a mesh that splits
    the vocabulary, this rank's rows of w give a shard of the logits, which
    are gathered whole before any sampling or loss sees them."""
    mesh = mesh if tp_splits(vocab, mesh) else None
    return gather_from_tp(matmul_t(copy_to_tp(x, mesh), w), mesh)


@dataclass
class KVCache:
    """Preallocated KV buffers, (L, B, Hkv, S, D): compute dtype, or int8
    with fp32 per-(slot, head) scales (L, B, Hkv, S) when quantized."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def zeros(cls, n_layers: int, batch: int, max_len: int, kv_heads: int,
              head_dim: int, dtype=torch.bfloat16, device="cpu",
              quantized: bool = False) -> "KVCache":
        shape = (n_layers, batch, kv_heads, max_len, head_dim)
        if not quantized:
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        return cls(*(torch.zeros(shape, dtype=torch.int8, device=device)
                     for _ in range(2)),
                   *(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                     for _ in range(2)))


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis: x (..., D) -> (int8
    (..., D), fp32 scale (...,)) with x ~= q * scale. Bit-equal to the JAX
    package: scale = max(amax, 1e-8) / 127, a true division, round half to
    even."""
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1), min=1e-8)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is one ulp off on ~4% of scales
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


# ---------------------------------------------------------------------------
# Parameter preparation
# ---------------------------------------------------------------------------


def _fuse_layer_projections(stacked: Params) -> Params:
    """Fuse q/k/v and gate/up weights into single matmuls (outputs are split
    after; the math is identical)."""
    attn, mlp = stacked["self_attn"], stacked["mlp"]
    return {
        "self_attn": {
            "qkv_proj": {"weight": torch.cat([attn["q_proj"]["weight"],
                                              attn["k_proj"]["weight"],
                                              attn["v_proj"]["weight"]], dim=-2)},
            "o_proj": attn["o_proj"],
            "q_norm": attn["q_norm"],
            "k_norm": attn["k_norm"],
        },
        "mlp": {
            "gate_up_proj": {"weight": torch.cat([mlp["gate_proj"]["weight"],
                                                  mlp["up_proj"]["weight"]], dim=-2)},
            "down_proj": mlp["down_proj"],
        },
        "input_layernorm": stacked["input_layernorm"],
        "post_attention_layernorm": stacked["post_attention_layernorm"],
    }


def _stack_decoder_layers(layers_tree: Params) -> Params:
    return _fuse_layer_projections(stack_layers(numeric_children(layers_tree)))


def prepare_talker_params(params: Params, cfg: TalkerConfig) -> Params:
    """Reorganize a `talker.*` state-dict subtree into the stacked layout."""
    model, cp = params["model"], params["code_predictor"]
    cp_cfg = cfg.code_predictor_config
    out: Params = {
        "layers": _stack_decoder_layers(model["layers"]),
        "norm": model["norm"],
        "codec_embedding": model["codec_embedding"]["weight"],
        "text_embedding": model["text_embedding"]["weight"],
        "text_projection": params["text_projection"],
        "codec_head": params["codec_head"]["weight"],
    }
    out["code_predictor"] = {
        "layers": _stack_decoder_layers(cp["model"]["layers"]),
        "norm": cp["model"]["norm"],
        # (Q-1, cp_vocab, talker_hidden)
        "embeddings": torch.stack(
            [t["weight"] for t in numeric_children(cp["model"]["codec_embedding"])]),
        # (Q-1, cp_vocab, cp_hidden)
        "lm_heads": torch.stack(
            [t["weight"] for t in numeric_children(cp["lm_head"])]),
        "proj": (cp["small_to_mtp_projection"]
                 if cp_cfg.hidden_size != cfg.hidden_size else None),
    }
    return out


def unbind_layers(stacked: Params) -> list:
    """Every layer of a stacked layer tree (views, no copies), one
    `torch.unbind` per leaf. Under autograd, backward then stacks each
    weight's layer gradients once; indexing layer by layer would build a
    whole stacked gradient per layer (L^2 traffic: a 1.7B SFT cycle on an
    H100 took 1.5-1.7x as long)."""
    if isinstance(stacked, dict):
        per_key = {k: unbind_layers(v) for k, v in stacked.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(stacked, 0))


# ---------------------------------------------------------------------------
# Decoder stack (shared by talker / code predictor)
# ---------------------------------------------------------------------------


def _write_kv(cache: KVCache, li: int, offset, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Write (B, T, Hkv, D) fresh K/V into layer li at slots [offset,
    offset + T), or (T = 1) at a tensor offset: per-row slots (B,) or one
    slot for all rows (a 0-d tensor); int8 caches get the quantized values
    and their scales."""
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # (B, Hkv, T, D)
    if cache.quantized:
        (kt, ks), (vt, vs) = kv_quantize(kt), kv_quantize(vt)
    if torch.is_tensor(offset):
        rows = torch.arange(k.shape[0], device=k.device)
        # a 0-d index would be read to the host (a sync, which a CUDA graph
        # capture refuses): one slot for every row goes as a (B,) index
        idx = offset.long().expand(k.shape[0])
        cache.k[li, rows, :, idx] = kt[:, :, 0].to(cache.k.dtype)
        cache.v[li, rows, :, idx] = vt[:, :, 0].to(cache.v.dtype)
        if cache.quantized:
            cache.k_scale[li, rows, :, idx] = ks[:, :, 0]
            cache.v_scale[li, rows, :, idx] = vs[:, :, 0]
        return
    T = k.shape[1]
    cache.k[li, :, :, offset:offset + T] = kt.to(cache.k.dtype)
    cache.v[li, :, :, offset:offset + T] = vt.to(cache.v.dtype)
    if cache.quantized:
        cache.k_scale[li, :, :, offset:offset + T] = ks
        cache.v_scale[li, :, :, offset:offset + T] = vs


def prefill_uses_flash(dims: StackDims, T: int, dtype: torch.dtype) -> bool:
    """Whether a left-padded prefill (one with its rows' starts) of T tokens
    in `dtype` attends through `flash_prefill`: iff T >= FLASH_PREFILL_MIN_T
    and the kernel was built for its shapes (`flash_misfit` is None). Every
    other prefill attends densely, which computes what the JAX package
    computes below its own threshold. The rule is the same on every device,
    so the CPU takes the card's route; the prefill and staging graphs
    (runtime/graphs.py) key their plan buffers by it, so a misfit never
    builds a plan."""
    return (T >= FLASH_PREFILL_MIN_T
            and flash_misfit(dtype, dims.heads, dims.kv_heads, dims.head_dim) is None)


def decoder_stack(stacked: Params, norm: Params, dims: StackDims,
                  h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  mask_bias: torch.Tensor, cache: Optional[KVCache], offset,
                  attend_len: Optional[int] = None,
                  prefill_start: Optional[torch.Tensor] = None,
                  prefill_window: Optional[int] = None,
                  prefill_plan: Optional[tuple] = None) -> torch.Tensor:
    """Run all layers. h: (B, T, hidden); mask_bias: (B, 1, T, S') additive
    with S' = attend_len or the cache length. Writes the new K/V at
    [offset, offset + T) of `cache` in place (an int offset), or for T = 1
    at per-row slots (a (B,) tensor offset: the serving engine, whose rows
    sit at different depths), and attends over its first S' slots; an int8
    cache is attended through `attention_kv_quant`, the slots just written
    included. Returns the final-normed hidden (B, T, hidden).

    With `prefill_start` ((B,) first valid slot per row of a left-padded
    prefill), where `prefill_uses_flash` says so, attention runs `flash_prefill`
    on this call's fresh, unquantized K/V instead (the cache's slots
    [0, T); later slots are masked on the dense path anyway; an int8 cache
    still receives the quantized values), and `mask_bias` is not read;
    `prefill_plan` is its work list (`flash_prefill`'s `plan`).

    `cache=None` (training): no cache is written or read; the dense path
    attends over this call's fresh K/V ((B, 1, T, T) mask_bias, offset 0),
    which is what the JAX package computes over a zero cache of length T.

    Under a mesh (`dims.attn_mesh`, `dims.mlp_mesh`) the weights are this
    rank's head-aligned shards and `dims` counts its heads: the partial sums
    after o_proj and down_proj are all-reduced over tp (`reduce_from_tp`),
    and the inputs of qkv and gate_up and the shared q/k norm weights pass
    `copy_to_tp`, whose backward all-reduces their gradients. The cache
    holds this rank's KV heads; the flash prefill runs on them."""
    B, T, _ = h.shape
    attn_mesh, mlp_mesh = dims.attn_mesh, dims.mlp_mesh
    nq = dims.heads * dims.head_dim
    nkv = dims.kv_heads * dims.head_dim
    if cache is None:
        n_layers = stacked["input_layernorm"]["weight"].shape[0]
    else:
        n_layers = cache.k.shape[0]
        S_att = cache.k.shape[3] if attend_len is None else attend_len
    use_flash = prefill_start is not None and prefill_uses_flash(dims, T, h.dtype)
    layers = unbind_layers(stacked)
    for li in range(n_layers):
        lp = layers[li]
        attn = lp["self_attn"]
        x = rms_norm(h, lp["input_layernorm"]["weight"], dims.eps)
        qkv = matmul_t(copy_to_tp(x, attn_mesh), attn["qkv_proj"]["weight"])
        q = qkv[..., :nq].reshape(B, T, dims.heads, dims.head_dim)
        k = qkv[..., nq:nq + nkv].reshape(B, T, dims.kv_heads, dims.head_dim)
        v = qkv[..., nq + nkv:].reshape(B, T, dims.kv_heads, dims.head_dim)
        q = rms_norm(q, copy_to_tp(attn["q_norm"]["weight"], attn_mesh), dims.eps)
        k = rms_norm(k, copy_to_tp(attn["k_norm"]["weight"], attn_mesh), dims.eps)
        q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            _write_kv(cache, li, offset, k, v)
        if use_flash:
            o = flash_prefill(q, k, v, prefill_start, sliding_window=prefill_window,
                              plan=prefill_plan)
        elif cache is None:
            o = attention(q, k, v, mask_bias)
        elif cache.quantized:
            o = attention_kv_quant(
                q, cache.k[li, :, :, :S_att].transpose(1, 2),
                cache.k_scale[li, :, :, :S_att].transpose(1, 2),
                cache.v[li, :, :, :S_att].transpose(1, 2),
                cache.v_scale[li, :, :, :S_att].transpose(1, 2), mask_bias)
        else:
            k_att = cache.k[li, :, :, :S_att].transpose(1, 2).to(x.dtype)
            v_att = cache.v[li, :, :, :S_att].transpose(1, 2).to(x.dtype)
            o = attention(q, k_att, v_att, mask_bias)
        h = h + reduce_from_tp(matmul_t(o.reshape(B, T, nq), attn["o_proj"]["weight"]),
                               attn_mesh)

        x = rms_norm(h, lp["post_attention_layernorm"]["weight"], dims.eps)
        mlp = lp["mlp"]
        inter = weight_rows(mlp["gate_up_proj"]["weight"]) // 2
        gu = matmul_t(copy_to_tp(x, mlp_mesh), mlp["gate_up_proj"]["weight"])
        h = h + reduce_from_tp(matmul_t(F.silu(gu[..., :inter]) * gu[..., inter:],
                                        mlp["down_proj"]["weight"]), mlp_mesh)
    return rms_norm(h, norm["weight"], dims.eps)


# ---------------------------------------------------------------------------
# Talker forward passes
# ---------------------------------------------------------------------------


def text_project(params: Params, cfg: TalkerConfig, x: torch.Tensor) -> torch.Tensor:
    """text_projection resize MLP (fc1 -> silu -> fc2)."""
    tp = params["text_projection"]
    h = (x @ tp["linear_fc1"]["weight"].T.to(x.dtype)
         + tp["linear_fc1"]["bias"].to(x.dtype))
    h = F.silu(h)
    return (h @ tp["linear_fc2"]["weight"].T.to(x.dtype)
            + tp["linear_fc2"]["bias"].to(x.dtype))


def talker_prefill(params: Params, cfg: TalkerConfig, inputs_embeds: torch.Tensor,
                   attn_mask: torch.Tensor, cache: Optional[KVCache],
                   allow_flash: bool = True, mesh: Optional[Mesh] = None,
                   plan: Optional[tuple] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, Optional[KVCache]]:
    """Prefill the talker. inputs_embeds: (B, T, H) left-padded; attn_mask:
    (B, T) 1 = real token (on the host or the device). Returns (logits of
    the last position (B, V) f32, last-layer normed hiddens (B, T, H),
    cache).

    Prefills that `prefill_uses_flash` admits (T >= FLASH_PREFILL_MIN_T and
    shapes the kernel takes) attend through `flash_prefill`, which requires
    contiguous left padding (the prompt layout) and has no backward;
    callers with other masks or gradients pass allow_flash=False.
    `plan`: its work list for the mask's starts (`flash_prefill`; a
    captured prefill must pass it).
    `cache=None` is the training route (see `decoder_stack`). `mesh`: the
    params are this rank's tensor-parallel shards (`parallel/mesh.py`); the
    logits come back whole."""
    B, T, _ = inputs_embeds.shape
    S = T if cache is None else cache.k.shape[3]
    dims = StackDims.from_talker(cfg, mesh)
    dev = inputs_embeds.device
    attn_mask = attn_mask.to(dev)

    # mrope with identical axes == 1-D rope on mask-cumsum positions
    positions = torch.cumsum(attn_mask, dim=-1) - 1
    positions = torch.where(attn_mask == 0, torch.ones_like(positions), positions)

    kv_valid = torch.zeros((B, S), dtype=torch.bool, device=dev)
    kv_valid[:, :T] = attn_mask.to(torch.bool)
    # causality by slot index (left padding has position 1)
    slot = torch.arange(S, device=dev)[None, :]
    qslot = torch.arange(T, device=dev)[None, :]
    ok = (slot <= qslot[:, :, None]) & kv_valid[:, None, :]
    if cfg.sliding_window is not None:
        ok = ok & (slot > (qslot[:, :, None] - cfg.sliding_window))
    bias = mask_to_bias(ok[:, None])
    # first valid slot per row, for the flash path
    start = (T - attn_mask.sum(dim=-1)).to(torch.int32) if allow_flash else None

    inv_freq = default_inv_freq(dims.head_dim, cfg.rope_theta, device=dev)
    cos, sin = rope_tables(positions, inv_freq)
    h = decoder_stack(params["layers"], params["norm"], dims, inputs_embeds,
                      cos, sin, bias, cache, 0, prefill_start=start,
                      prefill_window=cfg.sliding_window, prefill_plan=plan)
    logits = head_logits(h[:, -1].to(torch.float32), params["codec_head"], cfg.vocab_size, mesh)
    return logits, h, cache


def talker_decode_step(params: Params, cfg: TalkerConfig, embed: torch.Tensor,
                       position: torch.Tensor, cache_index: int,
                       kv_valid: torch.Tensor, cache: KVCache,
                       attend_len: Optional[int] = None, mesh: Optional[Mesh] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, KVCache]:
    """One plain decode step. embed: (B, 1, H); position: (B,) rope
    position; cache_index: slot to write; kv_valid: (B, S) incl. the new
    slot. Returns (logits (B, V), hidden (B, 1, H), cache). `mesh` as in
    `talker_prefill`."""
    S = cache.k.shape[3] if attend_len is None else attend_len
    dims = StackDims.from_talker(cfg, mesh)
    dev = embed.device
    slot = torch.arange(S, device=dev)[None, :]
    ok = (slot <= cache_index) & kv_valid[:, :S]
    if cfg.sliding_window is not None:
        ok = ok & (slot > (cache_index - cfg.sliding_window))
    bias = mask_to_bias(ok[:, None, None, :])
    inv_freq = default_inv_freq(dims.head_dim, cfg.rope_theta, device=dev)
    cos, sin = rope_tables(position[:, None], inv_freq)
    h = decoder_stack(params["layers"], params["norm"], dims, embed, cos, sin,
                      bias, cache, cache_index, attend_len=attend_len)
    logits = head_logits(h[:, 0].to(torch.float32), params["codec_head"], cfg.vocab_size, mesh)
    return logits, h, cache


# ---------------------------------------------------------------------------
# Code predictor (sub-talker): one frame = prefill(2) + Q-2 single steps
# ---------------------------------------------------------------------------


def _cp_project(cp: Params, x: torch.Tensor) -> torch.Tensor:
    proj = cp["proj"]
    if proj is None:
        return x
    return x @ proj["weight"].T.to(x.dtype) + proj["bias"].to(x.dtype)


def code_predictor_frame_dispatch(params: Params, cfg: TalkerConfig,
                                  past_hidden: torch.Tensor,
                                  code0_embed: torch.Tensor, sampling,
                                  fused: bool = False,
                                  rows: Optional[torch.Tensor] = None,
                                  rows_top_k: int = 0,
                                  generator: Optional[torch.Generator] = None,
                                  mesh: Optional[Mesh] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one sub-talker frame to the plain layer loop or to the fused
    sub-talker (ops/cuda/subtalker.py: W8A8, int8 params only). `rows`
    ((B, 5), SamplingParams.as_row layout) carries per-row sampling. Under
    a mesh only the plain loop runs (the fused kernel runs whole layers and
    cannot split heads)."""
    if not fused:
        return code_predictor_frame(params, cfg, past_hidden, code0_embed,
                                    sampling, rows=rows, rows_top_k=rows_top_k,
                                    generator=generator, mesh=mesh)
    if mesh is not None:
        raise ValueError("the fused sub-talker kernel does not run under a mesh")
    from ..ops.cuda.subtalker import subtalker_frame_fused

    return subtalker_frame_fused(params["code_predictor"],
                                 cfg.code_predictor_config, past_hidden,
                                 code0_embed, sampling, rows=rows,
                                 generator=generator)


def code_predictor_frame(params: Params, cfg: TalkerConfig,
                         past_hidden: torch.Tensor, code0_embed: torch.Tensor,
                         sampling, rows: Optional[torch.Tensor] = None,
                         rows_top_k: int = 0,
                         generator: Optional[torch.Generator] = None,
                         mesh: Optional[Mesh] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate codebooks 1..Q-1 for one frame.

    past_hidden/code0_embed: (B, 1, talker_hidden). Returns (codes (B, Q-1)
    int32, the sum of the Q-1 sub-code embeddings (B, 1, talker_hidden)).
    Prefill over 2 positions, then Q-2 single-position steps, each with its
    own lm head and embedding table. `mesh`: tensor-parallel shards, and
    the B rows are this dp rank's share (the noise is drawn for all rows)."""
    B = past_hidden.shape[0]
    noise_rows = None if mesh is None else mesh.noise_rows(B)
    if rows is not None:
        def sample(logits):
            return process_and_sample_rows(logits, rows, rows_top_k,
                                           generator=generator, noise_rows=noise_rows)
    else:
        def sample(logits):
            return process_and_sample(logits, sampling, generator=generator,
                                      noise_rows=noise_rows)

    cp_cfg = cfg.code_predictor_config
    cp = params["code_predictor"]
    dims = StackDims.from_code_predictor(cp_cfg, mesh)
    V = cp_cfg.vocab_size
    dev, dtype = past_hidden.device, past_hidden.dtype
    Qm1 = cfg.num_code_groups - 1
    S = Qm1 + 2
    cache = KVCache.zeros(cp_cfg.num_hidden_layers, B, S, dims.kv_heads,
                          dims.head_dim, dtype=dtype, device=dev)
    inv_freq = default_inv_freq(dims.head_dim, cp_cfg.rope_theta, device=dev)
    slots = torch.arange(S, device=dev)

    pre = _cp_project(cp, torch.cat([past_hidden, code0_embed], dim=1))
    cos, sin = rope_tables(torch.arange(2, device=dev)[None, :].expand(B, 2),
                           inv_freq)
    ok = slots[None, :] <= torch.arange(2, device=dev)[:, None]
    bias = mask_to_bias(ok)[None, None].expand(B, 1, 2, S)
    h = decoder_stack(cp["layers"], cp["norm"], dims, pre, cos, sin, bias,
                      cache, 0)
    logits = head_logits(h[:, -1].to(torch.float32), cp["lm_heads"][0], V, mesh)
    code = sample(logits)
    codes = [code]
    emb_sum = cp["embeddings"][0][code.long()][:, None, :].to(dtype)
    for step in range(1, Qm1):
        raw = cp["embeddings"][step - 1][code.long()][:, None, :].to(dtype)
        x = _cp_project(cp, raw)
        cos, sin = rope_tables(torch.full((B, 1), step + 1, device=dev), inv_freq)
        bias = mask_to_bias(slots <= step + 1)[None, None, None, :].expand(B, 1, 1, S)
        h = decoder_stack(cp["layers"], cp["norm"], dims, x, cos, sin, bias,
                          cache, step + 1)
        logits = head_logits(h[:, 0].to(torch.float32), cp["lm_heads"][step], V, mesh)
        code = sample(logits)
        codes.append(code)
        emb_sum = emb_sum + cp["embeddings"][step][code.long()][:, None, :].to(dtype)
    return torch.stack(codes, dim=1), emb_sum
