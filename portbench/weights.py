"""The benchmark's weights, drawn on the device from the run's seed.

Both sides take their weights from here: the program gets the drawn bf16
talker tree (which it quantises to int8 itself) and the scaled vocoder
tree; the reference (`reference/`) draws the same trees again from the same
seed after the window and quantises the talker itself. Nothing here imports
the program. The layout is the prepared (stacked, fused) tree that the
program's model constructor takes.

Every matrix is N(0, 0.02) as the repository's smoke run draws it; norm
weights are 1 + N(0, 0.1) per layer, so a kernel that read another layer's
norm would show. The 12 Hz vocoder's weight matrices are scaled by
VOCODER_WEIGHT_SCALE (8 ** -0.5): the unscaled draw clamps nearly every
sample to +-1, which would make the audio comparison compare signs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

# the vocoder rule: weight matrices (2+ dims) times this, vectors and the
# codebooks as drawn
VOCODER_WEIGHT_SCALE = 8 ** -0.5
# seed offsets of the separate draws of one run
TALKER_DRAW, VOCODER_DRAW = 0, 1


def generator(seed: int, draw: int, device) -> torch.Generator:
    """A generator on `device` for one draw of one run (seeds up to 2**63)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 8 + draw) % (2 ** 63))
    return gen


def _normal(gen, shape, std, dtype, device):
    return (torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std).to(dtype)


def _layer_stack(gen, n, hidden, heads, kv_heads, head_dim, inter, dtype, device):
    def init(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def norm(*shape):
        return (1 + _normal(gen, shape, 0.1, torch.float32, device)).to(dtype)

    return {
        "self_attn": {
            "qkv_proj": {"weight": init(n, (heads + 2 * kv_heads) * head_dim, hidden)},
            "o_proj": {"weight": init(n, hidden, heads * head_dim)},
            "q_norm": {"weight": norm(n, head_dim)},
            "k_norm": {"weight": norm(n, head_dim)},
        },
        "mlp": {
            "gate_up_proj": {"weight": init(n, 2 * inter, hidden)},
            "down_proj": {"weight": init(n, hidden, inter)},
        },
        "input_layernorm": {"weight": norm(n, hidden)},
        "post_attention_layernorm": {"weight": norm(n, hidden)},
    }


def talker_tree(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The talker and code predictor of configuration `cfg` (its "talker"
    and "code_predictor" groups) in `dtype`, from `seed`."""
    t, cp = cfg["talker"], cfg["code_predictor"]
    gen = generator(seed, TALKER_DRAW, device)
    hd = t["head_dim"]

    def init(*shape):
        return _normal(gen, shape, 0.02, dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    H, Hc, Ht = t["hidden_size"], cp["hidden_size"], t["text_hidden_size"]
    tree = {
        "layers": _layer_stack(gen, t["num_hidden_layers"], H, t["num_attention_heads"],
                               t["num_key_value_heads"], hd, t["intermediate_size"], dtype,
                               device),
        "norm": {"weight": (1 + _normal(gen, (H,), 0.1, torch.float32, device)).to(dtype)},
        "codec_embedding": init(t["vocab_size"], H),
        "text_embedding": init(t["text_vocab_size"], Ht),
        "text_projection": {
            "linear_fc1": {"weight": init(Ht, Ht), "bias": zeros(Ht)},
            "linear_fc2": {"weight": init(H, Ht), "bias": zeros(H)},
        },
        "codec_head": init(t["vocab_size"], H),
    }
    qm1 = t["num_code_groups"] - 1
    sub = {
        "layers": _layer_stack(gen, cp["num_hidden_layers"], Hc, cp["num_attention_heads"],
                               cp["num_key_value_heads"], cp["head_dim"],
                               cp["intermediate_size"], dtype, device),
        "norm": {"weight": (1 + _normal(gen, (Hc,), 0.1, torch.float32, device)).to(dtype)},
        "embeddings": init(qm1, cp["vocab_size"], H),
        "lm_heads": init(qm1, cp["vocab_size"], Hc),
        "proj": None,
    }
    if Hc != H:
        sub["proj"] = {"weight": init(Hc, H), "bias": zeros(Hc)}
    tree["code_predictor"] = sub
    return tree


def vocoder_tree(cfg: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """The 12 Hz vocoder of `cfg` (its "vocoder" group) in float32, in the
    prepared layout (16 pre-projected codebooks), its weight matrices
    scaled by VOCODER_WEIGHT_SCALE."""
    c = cfg["vocoder"]
    gen = generator(seed, VOCODER_DRAW, device)
    f32 = torch.float32

    def init(*shape, std=0.05):
        x = _normal(gen, shape, std, f32, device)
        return x * VOCODER_WEIGHT_SCALE if len(shape) >= 2 else x

    def const(n, value):
        return torch.full((n,), value, dtype=f32, device=device)

    def conv(o, i, k):
        return {"conv": {"weight": init(o, i, k), "bias": const(o, 0.0)}}

    def tconv(i, o, k):
        return {"conv": {"weight": init(i, o, k), "bias": const(o, 0.0)}}

    def snake(n):
        return {"alpha": const(n, 0.0), "beta": const(n, 0.0)}

    h, lat, dd, inter = c["hidden_size"], c["latent_dim"], c["decoder_dim"], c["intermediate_size"]
    layers = {str(li): {
        "self_attn": {name: {"weight": init(h, h)}
                      for name in ("q_proj", "k_proj", "v_proj", "o_proj")},
        "mlp": {"gate_proj": {"weight": init(inter, h)}, "up_proj": {"weight": init(inter, h)},
                "down_proj": {"weight": init(h, inter)}},
        "input_layernorm": {"weight": const(h, 1.0)},
        "post_attention_layernorm": {"weight": const(h, 1.0)},
        "self_attn_layer_scale": {"scale": const(h, 0.01)},
        "mlp_layer_scale": {"scale": const(h, 0.01)},
    } for li in range(c["num_hidden_layers"])}
    upsample = {str(i): {
        "0": tconv(lat, lat, ratio),
        "1": {"dwconv": conv(lat, 1, 7),
              "norm": {"weight": const(lat, 1.0), "bias": const(lat, 0.0)},
              "pwconv1": {"weight": init(4 * lat, lat), "bias": const(4 * lat, 0.0)},
              "pwconv2": {"weight": init(lat, 4 * lat), "bias": const(lat, 0.0)},
              "gamma": const(lat, 1e-6)},
    } for i, ratio in enumerate(c["upsampling_ratios"])}
    decoder = {"0": conv(dd, lat, 7)}
    for i, rate in enumerate(c["upsample_rates"]):
        ind, outd = dd // (2 ** i), dd // (2 ** (i + 1))
        block = {"0": snake(ind), "1": tconv(ind, outd, 2 * rate)}
        for j in range(3):
            block[str(2 + j)] = {"act1": snake(outd), "conv1": conv(outd, outd, 7),
                                 "act2": snake(outd), "conv2": conv(outd, outd, 1)}
        decoder[str(1 + i)] = {"block": block}
    outd = dd // (2 ** len(c["upsample_rates"]))
    decoder[str(1 + len(c["upsample_rates"]))] = snake(outd)
    decoder[str(2 + len(c["upsample_rates"]))] = conv(1, outd, 7)
    return {
        "_codebooks": _normal(gen, (c["num_quantizers"], c["codebook_size"],
                                    c["codebook_dim"]), 0.02, f32, device),
        "pre_conv": conv(lat, c["codebook_dim"], 3),
        "pre_transformer": {
            "input_proj": {"weight": init(h, lat), "bias": const(h, 0.0)},
            "layers": layers,
            "norm": {"weight": const(h, 1.0)},
            "output_proj": {"weight": init(lat, h), "bias": const(lat, 0.0)},
        },
        "upsample": upsample,
        "decoder": decoder,
    }
