"""Random parameter fabrication for smoke runs and tests.

- Talker and vocoder: torch counterparts of `qwen3_tts_tpu/utils/testing.py`,
  trees in the *prepared* layout that `prepare_talker_params` /
  `prepare_decoder_params` emit, drawn from a `torch.Generator` directly on
  the target device (a 1.7B tree is ~4 GB in bf16; drawing it on the card
  avoids a host round trip). The draws are not the JAX package's numbers:
  tests that compare the two packages build one tree with JAX and convert
  it with `from_jax_tree`.
- Speaker encoder and Mimi encoder: numpy trees from a seed, in the
  checkpoint's state-dict layout (`speaker_encoder.*` and the speech
  tokenizer's `encoder.*`, unflattened); the 25 Hz tokenizer and CAM++:
  flat numpy state dicts (`encoder.tokenizer.*`, `decoder.dit.*`,
  `decoder.bigvgan.*`; CAM++ `head.*` and `xvector.*`) with non-trivial
  batch-norm running statistics. Both packages take the same numpy
  tree (the JAX package as is, the port through `from_jax_tree`), so a test
  feeds them identical weights; conv weights are drawn with a 1/sqrt(fan_in)
  scale so activations stay O(1) at the released widths.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import (CodecV1Config, CodecV2Config, CodecV2DecoderConfig, CodePredictorConfig,
                      MimiEncoderConfig, SpeakerEncoderConfig, TalkerConfig)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _decoder_layer_stack(gen, n_layers, hidden, heads, kv_heads, head_dim,
                         inter, dtype, device):
    qkv_rows = (heads + 2 * kv_heads) * head_dim

    def init(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "self_attn": {
            "qkv_proj": {"weight": init(n_layers, qkv_rows, hidden)},
            "o_proj": {"weight": init(n_layers, hidden, heads * head_dim)},
            "q_norm": {"weight": ones(n_layers, head_dim)},
            "k_norm": {"weight": ones(n_layers, head_dim)},
        },
        "mlp": {
            "gate_up_proj": {"weight": init(n_layers, 2 * inter, hidden)},
            "down_proj": {"weight": init(n_layers, hidden, inter)},
        },
        "input_layernorm": {"weight": ones(n_layers, hidden)},
        "post_attention_layernorm": {"weight": ones(n_layers, hidden)},
    }


def random_talker_params(cfg: TalkerConfig, gen: torch.Generator,
                         dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random talker + code-predictor tree on `gen.device`."""
    device = gen.device
    cp_cfg = cfg.code_predictor_config
    hd = cfg.resolved_head_dim

    def init(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    params: Dict[str, Any] = {
        "layers": _decoder_layer_stack(
            gen, cfg.num_hidden_layers, cfg.hidden_size,
            cfg.num_attention_heads, cfg.num_key_value_heads, hd,
            cfg.intermediate_size, dtype, device),
        "norm": {"weight": torch.ones(cfg.hidden_size, dtype=dtype, device=device)},
        "codec_embedding": init(cfg.vocab_size, cfg.hidden_size),
        "text_embedding": init(cfg.text_vocab_size, cfg.text_hidden_size),
        "text_projection": {
            "linear_fc1": {"weight": init(cfg.text_hidden_size, cfg.text_hidden_size),
                           "bias": zeros(cfg.text_hidden_size)},
            "linear_fc2": {"weight": init(cfg.hidden_size, cfg.text_hidden_size),
                           "bias": zeros(cfg.hidden_size)},
        },
        "codec_head": init(cfg.vocab_size, cfg.hidden_size),
    }
    qm1 = cfg.num_code_groups - 1
    cp: Dict[str, Any] = {
        "layers": _decoder_layer_stack(
            gen, cp_cfg.num_hidden_layers, cp_cfg.hidden_size,
            cp_cfg.num_attention_heads, cp_cfg.num_key_value_heads,
            cp_cfg.head_dim, cp_cfg.intermediate_size, dtype, device),
        "norm": {"weight": torch.ones(cp_cfg.hidden_size, dtype=dtype, device=device)},
        "embeddings": init(qm1, cp_cfg.vocab_size, cfg.hidden_size),
        "lm_heads": init(qm1, cp_cfg.vocab_size, cp_cfg.hidden_size),
        "proj": None,
    }
    if cp_cfg.hidden_size != cfg.hidden_size:
        cp["proj"] = {"weight": init(cp_cfg.hidden_size, cfg.hidden_size),
                      "bias": zeros(cp_cfg.hidden_size)}
    params["code_predictor"] = cp
    return params


def random_vocoder_params(cfg: CodecV2DecoderConfig, gen: torch.Generator,
                          dtype=torch.float32) -> Dict[str, Any]:
    """Random 12 Hz vocoder tree in the prepared layout, any config size."""
    device = gen.device

    def init(*shape, scale=0.05):
        return _normal(gen, shape, scale, dtype, device)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=device)

    def conv(o, i, k):
        return {"conv": {"weight": init(o, i, k), "bias": const(o, 0.0)}}

    def tconv(i, o, k):
        return {"conv": {"weight": init(i, o, k), "bias": const(o, 0.0)}}

    def snake(n):
        return {"alpha": const(n, 0.0), "beta": const(n, 0.0)}

    h, lat, dd = cfg.hidden_size, cfg.latent_dim, cfg.decoder_dim
    layers = {}
    for li in range(cfg.num_hidden_layers):
        layers[str(li)] = {
            "self_attn": {name: {"weight": init(h, h)}
                          for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {"gate_proj": {"weight": init(cfg.intermediate_size, h)},
                    "up_proj": {"weight": init(cfg.intermediate_size, h)},
                    "down_proj": {"weight": init(h, cfg.intermediate_size)}},
            "input_layernorm": {"weight": const(h, 1.0)},
            "post_attention_layernorm": {"weight": const(h, 1.0)},
            "self_attn_layer_scale": {"scale": const(h, 0.01)},
            "mlp_layer_scale": {"scale": const(h, 0.01)},
        }
    upsample = {}
    for i, ratio in enumerate(cfg.upsampling_ratios):
        upsample[str(i)] = {
            "0": tconv(lat, lat, ratio),
            "1": {"dwconv": conv(lat, 1, 7),
                  "norm": {"weight": const(lat, 1.0), "bias": const(lat, 0.0)},
                  "pwconv1": {"weight": init(4 * lat, lat), "bias": const(4 * lat, 0.0)},
                  "pwconv2": {"weight": init(lat, 4 * lat), "bias": const(lat, 0.0)},
                  "gamma": const(lat, 1e-6)},
        }
    decoder = {"0": conv(dd, lat, 7)}
    for i, rate in enumerate(cfg.upsample_rates):
        ind, outd = dd // (2 ** i), dd // (2 ** (i + 1))
        block = {"0": snake(ind), "1": tconv(ind, outd, 2 * rate)}
        for j in range(3):
            block[str(2 + j)] = {"act1": snake(outd), "conv1": conv(outd, outd, 7),
                                 "act2": snake(outd), "conv2": conv(outd, outd, 1)}
        decoder[str(1 + i)] = {"block": block}
    outd = dd // (2 ** len(cfg.upsample_rates))
    decoder[str(1 + len(cfg.upsample_rates))] = snake(outd)
    decoder[str(2 + len(cfg.upsample_rates))] = conv(1, outd, 7)

    return {
        "_codebooks": init(cfg.num_quantizers, cfg.codebook_size,
                           cfg.codebook_dim, scale=0.02),
        "pre_conv": conv(lat, cfg.codebook_dim, 3),
        "pre_transformer": {
            "input_proj": {"weight": init(h, lat), "bias": const(h, 0.0)},
            "layers": layers,
            "norm": {"weight": const(h, 1.0)},
            "output_proj": {"weight": init(lat, h), "bias": const(lat, 0.0)},
        },
        "upsample": upsample,
        "decoder": decoder,
    }


def _bf16_values() -> np.ndarray:
    """Every positive finite bfloat16 value, as float32."""
    return (np.arange(1, 0x7F80, dtype=np.uint32) << 16).view(np.float32)


def kv_quantizer_traps(x: np.ndarray) -> Dict[str, np.ndarray]:
    """Masks over float32 rows x (R, D) of the values where a wrong int8 KV
    quantizer departs from `kv_quantize` (s = max(amax, 1e-8) / 127, q =
    round half to even(x / s), a true f32 division): "ties" (x / s = k +
    1/2: rounding half away from zero, or truncation, differ) and
    "reciprocal" (x * (1 / s) rounds otherwise than x / s)."""
    x = np.asarray(x, np.float32)
    s = np.maximum(np.abs(x).max(axis=-1, keepdims=True), np.float32(1e-8)) / np.float32(127)
    q = x / s
    return {"ties": np.abs(q - np.trunc(q)) == 0.5,
            "reciprocal": np.rint(x * (np.float32(1) / s)) != np.rint(q)}


def kv_quantizer_probe(D: int = 128, seed: int = 0) -> np.ndarray:
    """(R, D) float32 rows of bfloat16 values on which a wrong int8 KV
    quantizer gives another answer than `kv_quantize` (see
    `kv_quantizer_traps`): rows whose scale is a power of two, holding every
    rounding tie; rows of scales that have a tie or a reciprocal-sensitive
    value, holding those; a zero row, a row below the 1e-8 scale floor, and
    Gaussian rows across scales (a scale of amax / 128 differs everywhere).
    Each crafted row's first entry is its amax; signs are random."""
    rng = np.random.default_rng(seed)
    allx = _bf16_values()

    def row(amax, picks):
        picks = np.asarray(picks, np.float32)[:D - 1]
        fill = rng.choice(allx[allx <= amax], D - 1 - len(picks))
        r = np.concatenate([[amax], picks, fill]).astype(np.float32)
        return r * rng.choice(np.float32([-1, 1]), D)

    rows = [row(np.float32(127 * 2.0 ** e), (np.arange(127) + 0.5) * 2.0 ** e)
            for e in (-12, -4, 0, 3)]
    found = 0
    for amax in rng.choice(allx[(allx > 1e-4) & (allx < 1e4)], 1500, replace=False):
        x = allx[allx <= amax]
        traps = kv_quantizer_traps(np.concatenate([[amax], x])[None])
        special = x[(traps["ties"] | traps["reciprocal"])[0, 1:]]
        if len(special):
            rows.append(row(amax, special))
            found += 1
            if found == 48:
                break
    rows.append(np.zeros(D, np.float32))
    rows.append(rng.normal(0, 1e-9, D))
    rows += [rng.normal(0, sigma, D) for sigma in np.logspace(-3, 2, 16)]
    x = torch.from_numpy(np.stack(rows).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _np_conv(rng: np.random.Generator, o: int, i: int, k: int, bias: bool = True):
    """{"weight": (o, i, k)[, "bias": (o,)]} float32, 1/sqrt(fan_in) scale."""
    out = {"weight": rng.normal(0, 1 / np.sqrt(i * k), (o, i, k)).astype(np.float32)}
    if bias:
        out["bias"] = rng.normal(0, 0.02, (o,)).astype(np.float32)
    return out


def speaker_encoder_state(cfg: SpeakerEncoderConfig, seed: int) -> Dict[str, Any]:
    """A random ECAPA-TDNN `speaker_encoder.*` tree (numpy float32)."""
    rng = np.random.default_rng(seed)
    C, K = cfg.enc_channels, cfg.enc_kernel_sizes
    scale = cfg.enc_res2net_scale
    blocks: Dict[str, Any] = {"0": {"conv": _np_conv(rng, C[0], cfg.mel_dim, K[0])}}
    for i in range(1, len(C) - 1):
        part = C[i] // scale
        blocks[str(i)] = {
            "tdnn1": {"conv": _np_conv(rng, C[i], C[i - 1], 1)},
            "res2net_block": {"blocks": {str(j): {"conv": _np_conv(rng, part, part, K[i])}
                                         for j in range(scale - 1)}},
            "tdnn2": {"conv": _np_conv(rng, C[i], C[i], 1)},
            "se_block": {"conv1": _np_conv(rng, cfg.enc_se_channels, C[i], 1),
                         "conv2": _np_conv(rng, C[i], cfg.enc_se_channels, 1)},
        }
    return {
        "blocks": blocks,
        "mfa": {"conv": _np_conv(rng, C[-1], sum(C[1:-1]), K[-1])},
        "asp": {"tdnn": {"conv": _np_conv(rng, cfg.enc_attention_channels, 3 * C[-1], 1)},
                "conv": _np_conv(rng, C[-1], cfg.enc_attention_channels, 1)},
        "fc": _np_conv(rng, cfg.enc_dim, 2 * C[-1], 1),
    }


def mimi_encoder_state(cfg: MimiEncoderConfig, seed: int) -> Dict[str, Any]:
    """A random Mimi encoder tree (numpy float32) in the layout of HF
    `MimiModel`'s encoder half: `encoder`, `encoder_transformer`,
    `downsample`, `quantizer`."""
    rng = np.random.default_rng(seed)
    nf, h = cfg.num_filters, cfg.hidden_size

    def vec(n, mean=0.0, std=0.02):
        return (mean + rng.normal(0, std, (n,))).astype(np.float32)

    layers: Dict[str, Any] = {"0": {"conv": _np_conv(rng, nf, cfg.audio_channels,
                                                     cfg.kernel_size)}}
    idx, mult = 1, 1
    for ratio in reversed(cfg.upsampling_ratios):
        dim = mult * nf
        for _ in range(cfg.num_residual_layers):
            layers[str(idx)] = {"block": {
                "1": {"conv": _np_conv(rng, dim // cfg.compress, dim,
                                       cfg.residual_kernel_size)},
                "3": {"conv": _np_conv(rng, dim, dim // cfg.compress, 1)}}}
            idx += 1
        idx += 1   # ELU
        layers[str(idx)] = {"conv": _np_conv(rng, 2 * dim, dim, 2 * ratio)}
        idx += 1
        mult *= 2
    idx += 1       # ELU
    layers[str(idx)] = {"conv": _np_conv(rng, h, mult * nf, cfg.last_kernel_size)}

    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd

    def lin(o, i):
        return {"weight": rng.normal(0, 1 / np.sqrt(i), (o, i)).astype(np.float32)}

    tlayers = {str(li): {
        "self_attn": {"q_proj": lin(nq, h), "k_proj": lin(nkv, h), "v_proj": lin(nkv, h),
                      "o_proj": lin(h, nq)},
        "mlp": {"fc1": lin(cfg.intermediate_size, h), "fc2": lin(h, cfg.intermediate_size)},
        "input_layernorm": {"weight": vec(h, 1.0, 0.1), "bias": vec(h)},
        "post_attention_layernorm": {"weight": vec(h, 1.0, 0.1), "bias": vec(h)},
        "self_attn_layer_scale": {"scale": vec(h, cfg.layer_scale_initial_scale, 0.002)},
        "mlp_layer_scale": {"scale": vec(h, cfg.layer_scale_initial_scale, 0.002)},
    } for li in range(cfg.num_hidden_layers)}

    vq = cfg.vector_quantization_hidden_dimension

    def rvq(n):
        def codebook():
            usage = rng.uniform(0.5, 1.5, (cfg.codebook_size,)).astype(np.float32)
            embed = rng.normal(0, 1, (cfg.codebook_size, cfg.codebook_dim))
            return {"codebook": {"initialized": np.ones((1,), np.float32),
                                 "cluster_usage": usage,
                                 "embed_sum": (embed * usage[:, None]).astype(np.float32)}}

        return {"layers": {str(i): codebook() for i in range(n)},
                "input_proj": _np_conv(rng, vq, h, 1, bias=False),
                "output_proj": _np_conv(rng, h, vq, 1, bias=False)}

    return {
        "encoder": {"layers": layers},
        "encoder_transformer": {"layers": tlayers},
        "downsample": {"conv": _np_conv(
            rng, h, h, 2 * round(cfg.encodec_frame_rate / cfg.frame_rate), bias=False)},
        "quantizer": {
            "semantic_residual_vector_quantizer": rvq(cfg.num_semantic_quantizers),
            "acoustic_residual_vector_quantizer": rvq(
                cfg.num_quantizers - cfg.num_semantic_quantizers)},
    }


def _np_normal(rng: np.random.Generator, shape, std: float, mean: float = 0.0) -> np.ndarray:
    return (mean + std * rng.standard_normal(shape, dtype=np.float32)).astype(np.float32)


def _np_linear(rng: np.random.Generator, o: int, i: int, bias: bool = True) -> Dict[str, Any]:
    out = {"weight": _np_normal(rng, (o, i), 1 / np.sqrt(i))}
    if bias:
        out["bias"] = _np_normal(rng, (o,), 0.02)
    return out


def _np_conv32(rng: np.random.Generator, o: int, i: int, k: int, bias: bool = True):
    """_np_conv drawn in float32 (the 25 Hz tree is ~0.6G values)."""
    out = {"weight": _np_normal(rng, (o, i, k), 1 / np.sqrt(i * k))}
    if bias:
        out["bias"] = _np_normal(rng, (o,), 0.02)
    return out


def _np_norm(rng: np.random.Generator, n: int) -> Dict[str, Any]:
    return {"weight": _np_normal(rng, (n,), 0.1, 1.0), "bias": _np_normal(rng, (n,), 0.02)}


def codec_v1_state(cfg: CodecV1Config, seed: int) -> Dict[str, np.ndarray]:
    """A random 25 Hz tokenizer state dict (flat, numpy float32): the
    Whisper-VQ encoder's first `audio_vq_layers` blocks, downsample and
    codebook (`encoder.tokenizer.*`), the DiT with its ECAPA
    (`decoder.dit.*`) and BigVGAN (`decoder.bigvgan.*`): every key the 25 Hz
    modules read. Linear and conv weights have a 1/sqrt(fan_in) scale."""
    from ..models.codec25.dit import speaker_config
    from ..weights import flatten_state_dict

    rng = np.random.default_rng(seed)
    ec, dc, bc = cfg.encoder_config, cfg.dit_config, cfg.bigvgan_config
    D = ec.n_state
    blocks = {str(i): {
        "attn_ln": _np_norm(rng, D),
        "attn": {"query": _np_linear(rng, D, D), "key": _np_linear(rng, D, D, bias=False),
                 "value": _np_linear(rng, D, D), "out": _np_linear(rng, D, D)},
        "mlp_ln": _np_norm(rng, D),
        "mlp": {"0": _np_linear(rng, 4 * D, D), "2": _np_linear(rng, D, 4 * D)},
    } for i in range(ec.audio_vq_layers)}
    encoder = {
        "conv1": _np_conv32(rng, D, ec.n_mels, 3), "conv2": _np_conv32(rng, D, D, 3),
        "blocks": blocks,
        "audio_vq_downsample": _np_conv32(rng, D, D, ec.audio_vq_ds_rate),
        "audio_quantizer": {"rvqs": {"0": {"embed": _np_normal(
            rng, (1, ec.audio_vq_codebook_size, ec.audio_vq_codebook_dim), 1.0)}}},
    }
    # CodecV1Config()'s codebook (32768) outgrows the DiT's code table
    # (num_embeds 8193): rows past the table sit 10x farther out, so an
    # encode emits only codes its decode embeds, as a trained pair would
    embed = encoder["audio_quantizer"]["rvqs"]["0"]["embed"]
    embed[:, dc.num_embeds:] *= 10.0

    H, inner = dc.hidden_size, dc.num_attention_heads * dc.head_dim
    layers = {str(i): {
        "attn_norm": {"linear": _np_linear(rng, 6 * H, H)},
        "attn": {"to_q": _np_linear(rng, inner, H), "to_k": _np_linear(rng, inner, H),
                 "to_v": _np_linear(rng, inner, H), "to_out": {"0": _np_linear(rng, H, inner)}},
        "ff": {"ff": {"0": _np_linear(rng, H * dc.ff_mult, H),
                      "3": _np_linear(rng, H, H * dc.ff_mult)}},
    } for i in range(dc.num_hidden_layers)}
    dit = {
        "time_embed": {"time_mlp": {"0": _np_linear(rng, H, 256), "2": _np_linear(rng, H, H)}},
        "input_embed": {
            "spk_encoder": speaker_encoder_state(speaker_config(dc), seed + 1),
            "proj": _np_linear(rng, H, dc.mel_dim + dc.enc_dim + dc.emb_dim + dc.enc_emb_dim)},
        "transformer_blocks": layers,
        "norm_out": {"linear": _np_linear(rng, 2 * H, H)},
        "proj_out": _np_linear(rng, dc.mel_dim, H),
        "text_embed": {"codec_embed": {"weight": _np_normal(rng, (dc.num_embeds, dc.emb_dim),
                                                            1.0)}},
    }

    def snake(n):
        return {"act": {"alpha": _np_normal(rng, (n,), 0.1),
                        "beta": _np_normal(rng, (n,), 0.1)}}

    n_res = len(bc.resblock_kernel_sizes)
    ch = bc.upsample_initial_channel
    bigvgan = {"conv_pre": _np_conv32(rng, ch, bc.mel_dim, 5), "ups": {}, "resblocks": {}}
    for li, (stride, k) in enumerate(zip(bc.upsample_rates, bc.upsample_kernel_sizes)):
        co = ch // 2
        up = _np_conv32(rng, co, ch, k)   # ConvTranspose1d layout (in, out, k)
        bigvgan["ups"][str(li)] = {"0": {"weight": np.ascontiguousarray(
            up["weight"].transpose(1, 0, 2)), "bias": up["bias"]}}
        for bi, (rk, dils) in enumerate(zip(bc.resblock_kernel_sizes,
                                            bc.resblock_dilation_sizes)):
            block = {"activations": {str(j): snake(co) for j in range(2 * len(dils))},
                     "convs1": {str(j): _np_conv32(rng, co, co, rk) for j in range(len(dils))},
                     "convs2": {str(j): _np_conv32(rng, co, co, rk) for j in range(len(dils))}}
            if li <= 1:   # causal_type "2": a 'same' pre-conv and its activation
                block["pre_conv"] = _np_conv32(rng, co, co, rk)
                block["pre_act"] = snake(co)
            bigvgan["resblocks"][str(li * n_res + bi)] = block
        ch = co
    bigvgan["activation_post"] = snake(ch)
    bigvgan["conv_post"] = _np_conv32(rng, 1, ch, 7, bias=False)
    return flatten_state_dict({"encoder": {"tokenizer": encoder},
                               "decoder": {"dit": dit, "bigvgan": bigvgan}})


def campplus_state(cfg, seed: int) -> Dict[str, np.ndarray]:
    """A random CAM++ state dict (flat, numpy float32) at `cfg`
    (models/codec25/campplus.py CAMPPlusConfig): the modelscope CAMPPlus
    names, batch norms with non-trivial running statistics (`batchnorm_`
    layers without affine terms)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}

    def conv(name, o, i, *k, bias=False):
        out[f"{name}.weight"] = _np_normal(rng, (o, i) + k, 1 / np.sqrt(i * int(np.prod(k))))
        if bias:
            out[f"{name}.bias"] = _np_normal(rng, (o,), 0.02)

    def bn(name, n, affine=True):
        out[f"{name}.running_mean"] = _np_normal(rng, (n,), 0.2)
        out[f"{name}.running_var"] = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
        if affine:
            out[f"{name}.weight"] = _np_normal(rng, (n,), 0.1, 1.0)
            out[f"{name}.bias"] = _np_normal(rng, (n,), 0.1)

    m = cfg.m_channels
    conv("head.conv1", m, 1, 3, 3)
    bn("head.bn1", m)
    for layer in ("layer1", "layer2"):
        for bi in (0, 1):
            pre = f"head.{layer}.{bi}"
            conv(f"{pre}.conv1", m, m, 3, 3)
            bn(f"{pre}.bn1", m)
            conv(f"{pre}.conv2", m, m, 3, 3)
            bn(f"{pre}.bn2", m)
            if bi == 0:   # stride 2 on frequency: a 1x1 shortcut
                conv(f"{pre}.shortcut.0", m, m, 1, 1)
                bn(f"{pre}.shortcut.1", m)
    conv("head.conv2", m, m, 3, 3)
    bn("head.bn2", m)
    ch = cfg.init_channels
    conv("xvector.tdnn.linear", ch, m * (cfg.feat_dim // 8), 5)
    bn("xvector.tdnn.nonlinear.batchnorm", ch)
    bn_c = cfg.bn_size * cfg.growth_rate
    for i, (nl, k) in enumerate(zip(cfg.num_blocks, cfg.kernels)):
        for j in range(nl):
            pre = f"xvector.block{i + 1}.tdnnd{j + 1}"
            bn(f"{pre}.nonlinear1.batchnorm", ch)
            conv(f"{pre}.linear1", bn_c, ch, 1)
            bn(f"{pre}.nonlinear2.batchnorm", bn_c)
            conv(f"{pre}.cam_layer.linear_local", cfg.growth_rate, bn_c, k)
            conv(f"{pre}.cam_layer.linear1", bn_c // 2, bn_c, 1, bias=True)
            conv(f"{pre}.cam_layer.linear2", cfg.growth_rate, bn_c // 2, 1, bias=True)
            ch += cfg.growth_rate
        bn(f"xvector.transit{i + 1}.nonlinear.batchnorm", ch)
        conv(f"xvector.transit{i + 1}.linear", ch // 2, ch, 1)
        ch //= 2
    bn("xvector.out_nonlinear.batchnorm", ch)
    conv("xvector.dense.linear", cfg.embedding_size, 2 * ch, 1)
    bn("xvector.dense.nonlinear.batchnorm", cfg.embedding_size, affine=False)
    return out


# The released talkers' widths (the JAX package's TALKER_0B6 and TALKER_1B7
# presets). At 0.6B the talker's hidden size equals the code predictor's, so
# the sub-talker runs without the small_to_mtp projection.
TALKER_0B6 = TalkerConfig(
    vocab_size=6400, hidden_size=1024, intermediate_size=3072,
    num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
    head_dim=128, text_hidden_size=1024, text_vocab_size=151936,
    num_code_groups=16,
    rope_scaling={"rope_type": "default", "mrope_section": [24, 20, 20],
                  "interleaved": True},
    code_predictor_config=CodePredictorConfig(
        vocab_size=2048, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=5, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, num_code_groups=16),
)

TALKER_1B7 = TalkerConfig(
    vocab_size=6400, hidden_size=2048, intermediate_size=6144,
    num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=8,
    head_dim=128, text_hidden_size=2048, text_vocab_size=151936,
    num_code_groups=16,
    rope_scaling={"rope_type": "default", "mrope_section": [24, 20, 20],
                  "interleaved": True},
    code_predictor_config=CodePredictorConfig(
        vocab_size=2048, hidden_size=1024, intermediate_size=3072,
        num_hidden_layers=5, num_attention_heads=16, num_key_value_heads=8,
        head_dim=128, num_code_groups=16),
)


def scale_weight_matrices(tree, scale: float):
    """`tree` with every tensor of two or more dimensions times `scale` and
    every vector as it was: the rule by which the smoke's random 12 Hz
    vocoders are kept from clamping their audio."""
    from ..weights import map_tensors

    return map_tensors(tree, lambda t: t * scale if t.ndim >= 2 else t)


def codec12_tokenizer_checkpoint(cfg: CodecV2Config, seed: int, scale: float = 1.0):
    """A 12 Hz tokenizer checkpoint directory's contents, random from a
    seed: (config.json dict, flat numpy state dict) with `encoder.*`
    (`mimi_encoder_state`) and `decoder.*` (`random_vocoder_params` drawn
    on the CPU, every weight matrix times `scale` and every vector as drawn,
    its folded codebook table replaced by the raw split-RVQ quantizer:
    cluster usage, embedding sums of codebook_dim / 2 and the output
    projections, which both packages fold on load, unscaled). At the
    default widths the unscaled draw clamps its audio to +-1; chip_smoke's
    evaluation checkpoints pass its VOC_WEIGHT_SCALE."""
    import dataclasses

    from ..weights import flatten_state_dict

    dec = cfg.decoder_config
    rng = np.random.default_rng(seed)
    vq_dim = dec.codebook_dim // 2

    def rvq(n):
        return {"output_proj": {"weight": _np_normal(rng, (dec.codebook_dim, vq_dim, 1),
                                                     vq_dim ** -0.5)},
                "vq": {"layers": {str(i): {"_codebook": {
                    "cluster_usage": rng.uniform(0.5, 1.5, (dec.codebook_size,)).astype(np.float32),
                    "embedding_sum": _np_normal(rng, (dec.codebook_size, vq_dim), 1.0)}}
                    for i in range(n)}}}

    raw = {k: scale_weight_matrices(v, scale) for k, v in random_vocoder_params(
        dec, torch.Generator().manual_seed(seed)).items() if k != "_codebooks"}
    raw["quantizer"] = {"rvq_first": rvq(1), "rvq_rest": rvq(dec.num_quantizers - 1)}
    state = {k: np.asarray(v) for k, v in flatten_state_dict(raw, "decoder").items()}
    state.update({k: np.asarray(v) for k, v in flatten_state_dict(
        mimi_encoder_state(cfg.encoder_config, seed + 1), "encoder").items()})
    return dataclasses.asdict(cfg), state


# torch's intra-op threads in a CPU test module. The suite runs six pytest
# workers on one host; at torch's default of one thread a core each, their
# pools spun against each other and every file ran many times slower than
# alone, while one thread or eight made no difference to a file run alone.
TEST_TORCH_THREADS = 1


def bounded_torch_threads():
    """The body of each port test module's autouse, module-scoped fixture
    (`pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)`):
    torch runs TEST_TORCH_THREADS intra-op threads for the module, and the
    count it found is restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(TEST_TORCH_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _rank_main(fn, rank: int, world: int, tmp: str, threads: int, args: tuple) -> None:
    import os
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    torch.set_num_threads(threads)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=300))
    try:
        out = ("ok", fn(rank, world, *args))
    except BaseException:
        out = ("error", traceback.format_exc())
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if out[0] == "ok":
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, timeout: float = 600.0, threads: int = 1) -> list:
    """Run `fn(rank, world, *args)` in `world` fresh processes (the spawn
    start method: a child imports only `fn`'s module and what it imports,
    so a caller that has JAX loaded hands its ranks none of it), joined in
    one gloo process group over a FileStore in a temporary directory (no
    port, so parallel test workers never collide). Returns each rank's
    picklable result in rank order; a rank that raises, or a run past
    `timeout` seconds, fails the call with the ranks' tracebacks. `fn`
    must be a module-level function; each rank runs `threads` CPU threads."""
    import multiprocessing as mp
    import os
    import pickle
    import tempfile
    import time

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, tmp, threads, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code {procs[r].exitcode})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status == "ok":
                results.append(value)
            else:
                errors.append(f"rank {r}:\n{value}")
    if errors or hung:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, {world}): "
                           + ("timed out; " if hung else "") + "\n".join(errors))
    return results
