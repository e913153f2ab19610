"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from qwen3_tts_tpu_torch/csrc
   (one nvcc per source, all started together);
3. the sub-talker and talker-step kernels against their plain PyTorch twins
   on the card, at the 1.7B shapes with random int8 weights, B in {1, 8}:
   max errors, code agreement, kernel and twin times (CUDA events);
4. slice 1: an in-memory 1.7B int8 custom-voice model (random weights from
   a seed, default-width 12 Hz vocoder, stand-in text tokenizer) synthesises
   a few texts through `generate_custom_voice`; the kernels' launch counters
   must move, the waveforms must be finite, 24 kHz, whole 1920-sample frames;
5. the clone model (the same talker as a base model, the speaker encoder at
   the released widths, the default-width Mimi encoder): a 10 s reference
   clip's codes and speaker embedding on the card against the host twins;
6. the flash prefill kernel against its twin at B in {1, 4}, T in {2048,
   4096}, ragged starts, one sliding window, and at the clone's own prefill
   shape with q/k/v as strided views into one fused qkv tensor (as
   `decoder_stack` hands them over); its time beside the twin's, the bound's and SDPA's; the dense
   plain prefill attention's time at T in {1024, 2048, 4096};
7. slice 2: `generate_voice_clone` (non-streaming ICL, B=2 texts of different
   lengths, so the prompt pads to T >= 2048 with ragged left padding) must
   launch the flash prefill once per layer and both decode kernels, and
   give finite 24 kHz waveforms;
then one JSON line with every kernel's numbers, and the last line
{"ok": true, "device": {...}}.

Imports nothing of JAX: the port runs on hosts that have no JAX installed.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B_SET = (1, 8)
TEXTS = ["Hello from the port.", "A second sentence, a little longer.",
         "Short one.", "The fourth text closes the batch of four."]
MAX_NEW_TOKENS = 64
# The card's published peaks (NVIDIA H100 SXM data sheet, dense) for the
# least time a kernel's work could take.
PEAK_BF16_FLOPS, PEAK_INT8_OPS, PEAK_FP32_FLOPS = 989e12, 1979e12, 67e12
PEAK_BYTES_PER_S = 3.35e12
# Slice 2: two texts whose ICL prompts (reference text + text + 125 frames of
# a 10 s clip) pad to >= 2048 tokens, with different left padding per row.
CLONE_TEXT = "The quick brown fox jumps over the lazy dog near the river bank. "
CLONE_TEXTS = [CLONE_TEXT * 31, CLONE_TEXT * 25]
CLONE_REF_TEXT = "This is the reference recording of the voice to clone."
CLONE_REF_SECONDS = 10
CLONE_MAX_NEW_TOKENS = 48
MIN_CODEC_AGREEMENT = 0.9     # Mimi codes, card against the host twin
SPK_REL_TOL = 1e-3            # speaker embedding, card against the host twin
# flash prefill against its twin (fp32 math on the same bf16 inputs): bf16
# output rounding and bf16 probabilities in the P.V product, unit-scale
# inputs. At unit scale a row that averages ~2000 keys has outputs of only
# ~0.03, so the absolute bar alone would pass a kernel that drops a key tile
# there; each valid (position, head) row is also held to a relative L2 error
# (bf16 rounding gives ~0.3%; one 64-key tile missed out of n keys ~8/sqrt(n),
# 17% at n = 2280).
FLASH_TOL = 3e-2
FLASH_ROW_REL_TOL = 1e-2
FLASH_CASES = [  # (B, T, starts, sliding window)
    (1, 2048, (0,), None),
    (4, 2048, (0, 129, 700, 1500), None),
    (4, 2048, (0, 129, 700, 1500), 512),
    (1, 4096, (0,), None),
    (4, 4096, (0, 333, 1400, 3000), None),
]
# Kernel vs twin. The twin (plain PyTorch, the reference's exact math) is
# chaotic in sum order: bf16 activations re-quantised to int8 at every
# matmul turn a one-ulp difference into a one-bucket step that the next
# layers amplify. Measured on the card: the twin on the card against the
# same twin on the host differs by ~9% relative L2 after the 28 talker
# layers and disagrees on ~12% of sub-talker codes. So each kernel is held
# (a) tightly where nothing accumulates and (b) against the reference's own
# spread, measured in this run, where it does.
ONE_LAYER_REL_TOL = 2e-2      # one talker layer, full widths
SPREAD_FACTOR, SPREAD_SLACK = 1.5, 2e-2   # full depth: <= 1.5 x spread + 0.02
MIN_CODE_AGREEMENT = 0.9      # sub-talker codes against the twin on the host
EMB_TOL = dict(rtol=0.05, atol=0.02)   # emb_sum of fully agreeing rows


def line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches (after one warm-up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(nbytes: float, ops=()):
    """(ms, "bytes" or "operations"): the least time the card could take for
    work that moves `nbytes` (each input read once, each output written
    once) and does `ops` ((count, peak rate) pairs), the larger of the two."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = max([n / rate for n, rate in ops], default=0.0)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tree_bytes(tree) -> int:
    from qwen3_tts_tpu_torch.weights import map_tensors

    total = []
    map_tensors(tree, lambda t: total.append(t.numel() * t.element_size()))
    return sum(total)


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _counted_wrappers() -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import flash_prefill
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache

    return {"flash_prefill": flash_prefill, "subtalker": subtalker_frame_fused,
            "talker_step": talker_step_fused_cache}


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for wrapper in _counted_wrappers().values():
        wrapper.launches = 0


def read_launches() -> dict:
    return {name: wrapper.launches for name, wrapper in _counted_wrappers().items()}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from qwen3_tts_tpu_torch.ops.cuda import build

    t0 = time.time()
    path = build.build()
    build.load_library()
    line("build", seconds=f"{time.time() - t0:.1f}", library=path.name)


def model_params(cfg, device):
    """Random 1.7B talker params from the seed, int8. Norm weights get a
    small per-layer jitter (the fabrication draws ones) so a kernel reading
    another layer's norm would show."""
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.weights import quantize_talker_params

    gen = torch.Generator(device=device).manual_seed(SEED)
    params = random_talker_params(cfg, gen, dtype=torch.bfloat16)
    for layers in (params["layers"], params["code_predictor"]["layers"]):
        for norm in (layers["input_layernorm"], layers["post_attention_layernorm"],
                     layers["self_attn"]["q_norm"], layers["self_attn"]["k_norm"]):
            w = norm["weight"]
            norm["weight"] = (1 + 0.1 * torch.randn(w.shape, generator=gen, device=device)
                              ).to(w.dtype)
    return quantize_talker_params(params)


def to_host(tree):
    from qwen3_tts_tpu_torch.weights import map_tensors

    return map_tensors(tree, lambda t: t.cpu())


def phase_subtalker(params, cfg, device) -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import (subtalker_frame_fused,
                                                        subtalker_frame_ref)
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams, gumbel_noise

    cp, cp_cfg = params["code_predictor"], cfg.code_predictor_config
    cp_host = to_host(cp)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    Qm1, V = cp["lm_heads"].shape[:2]
    out = {"agree": [], "agree_card_twin": [], "twin_spread": [], "err": 0.0,
           "ms": {}, "plain_ms": {}}
    sampled = SamplingParams(do_sample=True, top_k=50, temperature=0.9)
    for B in B_SET:
        h = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.5
             ).to(torch.bfloat16)
        c0 = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.5
              ).to(torch.bfloat16)
        g = gumbel_noise((Qm1, B, V), gen, device)
        # per-row sampling rows are what the main path passes (greedy rows
        # mixed in here): one SamplingParams, or rows, per case
        rows = torch.tensor(np.stack([
            (SamplingParams(do_sample=False) if b % 3 == 0 else
             SamplingParams(do_sample=True, top_k=50 if b % 3 == 1 else 0,
                            temperature=0.9)).as_row() for b in range(B)]),
            device=device)
        for sampling, r in ((SamplingParams(do_sample=False), None), (sampled, None),
                            (None, rows)):
            ck, ek = subtalker_frame_fused(cp, cp_cfg, h, c0, sampling, rows=r, gumbel=g)
            cr, _ = subtalker_frame_ref(cp, cp_cfg, h, c0, sampling, rows=r, gumbel=g)
            ch, eh = subtalker_frame_ref(cp_host, cp_cfg, h.cpu(), c0.cpu(), sampling,
                                         rows=None if r is None else r.cpu(),
                                         gumbel=g.cpu())
            ck, ek = ck.cpu(), ek.cpu()
            same = ck == ch
            out["agree"].append(float(same.float().mean()))
            out["agree_card_twin"].append(float((ck == cr.cpu()).float().mean()))
            out["twin_spread"].append(float((cr.cpu() != ch).float().mean()))
            full = same.all(dim=1)
            if bool(full.any()):
                out["err"] = max(out["err"], max_abs(ek[full], eh[full]))
                if not torch.allclose(ek[full].float(), eh[full].float(), **EMB_TOL):
                    raise AssertionError(f"sub-talker emb_sum off at B={B}: "
                                         f"max_abs={max_abs(ek[full], eh[full])}")
        out["ms"][B] = cuda_ms(lambda: subtalker_frame_fused(
            cp, cp_cfg, h, c0, sampled, gumbel=g), 20)
        out["plain_ms"][B] = cuda_ms(lambda: subtalker_frame_ref(
            cp, cp_cfg, h, c0, sampled, gumbel=g), 3)
    # bound at the largest B: every layer weight byte, the lm heads and the
    # projection read once, the sampled embedding rows and the noise; every
    # one of the Q positions runs every layer weight (int8) and each step one
    # lm head (bf16)
    B, Q = max(B_SET), Qm1 + 1
    Ht, Hc = cfg.hidden_size, cp_cfg.hidden_size
    layer_elems = sum(cp["layers"][grp][name]["weight"]["q"].numel()
                      for grp, names in (("self_attn", ("qkv_proj", "o_proj")),
                                         ("mlp", ("gate_up_proj", "down_proj")))
                      for name in names)
    nbytes = (tree_bytes(cp["layers"]) + tree_bytes(cp["lm_heads"]) + tree_bytes(cp["proj"])
              + Qm1 * B * Ht * 2 + Qm1 * B * V * 4 + 3 * B * Ht * 2 + B * Qm1 * 4)
    bf16_flops = 2 * B * Qm1 * V * Hc + (2 * B * Q * Hc * Ht if cp["proj"] is not None else 0)
    out["bound_ms"], out["bound_by"] = bound(nbytes, [(2 * B * Q * layer_elems, PEAK_INT8_OPS),
                                                      (bf16_flops, PEAK_BF16_FLOPS)])
    agree = float(np.mean(out["agree"]))
    line("kernel subtalker", code_agreement_vs_host_twin=f"{agree:.4f}",
         code_agreement_vs_card_twin=f"{np.mean(out['agree_card_twin']):.4f}",
         twin_card_vs_host_disagreement=f"{np.mean(out['twin_spread']):.4f}",
         emb_sum_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in B_SET},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in B_SET},
         **{f"bound_ms_B{B}": f"{out['bound_ms']:.4f}"})
    if agree < MIN_CODE_AGREEMENT:
        raise AssertionError(f"sub-talker kernel/twin code agreement {out['agree']}")
    return out


def decode_state(cfg, B, S_buf, ci, device, gen):
    """Random bf16 KV history, ragged validity, one fresh embedding."""
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
    k = (torch.randn((L, B, Hkv, S_buf, D), generator=gen, device=device) * 0.5
         ).to(torch.bfloat16)
    v = (torch.randn((L, B, Hkv, S_buf, D), generator=gen, device=device) * 0.5
         ).to(torch.bfloat16)
    slot = torch.arange(S_buf, device=device)[None, :]
    start = torch.randint(0, 4, (B, 1), generator=gen, device=device)
    kv_valid = (slot >= start) & (slot <= ci)
    embed = (torch.randn((B, 1, cfg.hidden_size), generator=gen, device=device) * 0.3
             ).to(torch.bfloat16)
    position = torch.full((B,), ci, dtype=torch.int32, device=device)
    return k, v, kv_valid, embed, position


def _step_outputs(fn, params, cfg, state, ci):
    """Run one talker step on copies of the cache (ci: an int, or (B,) per-row
    slots); returns (logits, hidden, written k/v slots) and whether every
    other cache slot is untouched."""
    k, v, kv_valid, embed, position = state
    B, S = k.shape[1], k.shape[3]
    cis = [int(c) for c in ci] if torch.is_tensor(ci) else [ci] * B
    k2, v2 = k.clone(), v.clone()
    lg, h, _, _ = fn(params, cfg, embed, position, ci, kv_valid, k2, v2)
    keep = torch.ones((B, S), dtype=torch.bool)
    keep[torch.arange(B), cis] = False
    intact = all(bool(torch.equal(a.cpu().permute(1, 3, 0, 2, 4)[keep],
                                  b.cpu().permute(1, 3, 0, 2, 4)[keep]))
                 for a, b in ((k2, k), (v2, v)))

    def slots(c):
        return torch.stack([c[:, b, :, i] for b, i in enumerate(cis)], dim=1)

    return {"logits": lg, "hidden": h, "k_slot": slots(k2), "v_slot": slots(v2)}, intact


def _rel_errs(a: dict, b: dict) -> dict:
    return {n: rel_err(a[n].cpu(), b[n].cpu()) for n in a}


def phase_talker_step(params, cfg, device, S_buf: int) -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import (talker_step_fused_cache,
                                                          talker_step_ref)
    from qwen3_tts_tpu_torch.weights import map_tensors

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ci = S_buf // 2
    params_host = to_host(params)
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    params1 = dict(params, layers=map_tensors(params["layers"], lambda t: t[:1].contiguous()))
    out = {"err": 0.0, "one_layer": 0.0, "full": 0.0, "spread": 0.0, "ms": {},
           "plain_ms": {}}
    for B in B_SET:
        state = decode_state(cfg, B, S_buf, ci, device, gen)
        # (a) one layer at full widths: nothing accumulates, hold tight
        state1 = tuple(t[:1] if i < 2 else t for i, t in enumerate(state))
        k1, intact1 = _step_outputs(talker_step_fused_cache, params1, cfg1, state1, ci)
        r1, _ = _step_outputs(talker_step_ref, params1, cfg1, state1, ci)
        one = max(_rel_errs(k1, r1).values())
        # ... and with per-row write slots (the serving engine's form)
        ci_rows = torch.tensor([ci - 9 * b for b in range(B)], dtype=torch.int32,
                               device=device)
        slot = torch.arange(S_buf, device=device)[None, :]
        state_rows = (state1[0], state1[1], state1[2] & (slot <= ci_rows[:, None]),
                      state1[3], ci_rows)
        kr1, intact_rows = _step_outputs(talker_step_fused_cache, params1, cfg1,
                                         state_rows, ci_rows)
        rr1, _ = _step_outputs(talker_step_ref, params1, cfg1, state_rows, ci_rows)
        one = max(one, *_rel_errs(kr1, rr1).values())
        intact1 = intact1 and intact_rows
        # (b) full depth against the twin on the card; the twin on the host
        # gives the reference's own sum-order spread
        ko, intact = _step_outputs(talker_step_fused_cache, params, cfg, state, ci)
        ro, _ = _step_outputs(talker_step_ref, params, cfg, state, ci)
        ho, _ = _step_outputs(talker_step_ref, params_host, cfg,
                              tuple(t.cpu() for t in state), ci)
        full = max(_rel_errs(ko, ro).values())
        spread = max(_rel_errs(ro, ho).values())
        out["one_layer"] = max(out["one_layer"], one)
        out["full"] = max(out["full"], full)
        out["spread"] = max(out["spread"], spread)
        out["err"] = max(out["err"], max_abs(ko["logits"], ro["logits"]))
        if not (intact and intact1):
            raise AssertionError("talker step kernel wrote outside its cache slot")
        if not one <= ONE_LAYER_REL_TOL:
            raise AssertionError(f"talker step, one layer, B={B}: rel err {one:.3g}")
        if not full <= SPREAD_FACTOR * spread + SPREAD_SLACK:
            raise AssertionError(f"talker step, full depth, B={B}: rel err {full:.3g} "
                                 f"vs the twin's own spread {spread:.3g}")
        k, v, kv_valid, embed, position = state
        out["ms"][B] = cuda_ms(lambda: talker_step_fused_cache(
            params, cfg, embed, position, ci, kv_valid, k, v), 20)
        out["plain_ms"][B] = cuda_ms(lambda: talker_step_ref(
            params, cfg, embed, position, ci, kv_valid, k, v), 3)
    # bound at the largest B: every layer weight byte once, the valid KV
    # slots of the window once (the data decides how many), the new slot
    # written; int8 products over every weight, fp32 attention over the slots
    L, Hkv, D, H = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                    cfg.resolved_head_dim, cfg.hidden_size)
    slots = int(kv_valid.sum())
    layer_elems = sum(params["layers"][grp][name]["weight"]["q"].numel()
                      for grp, names in (("self_attn", ("qkv_proj", "o_proj")),
                                         ("mlp", ("gate_up_proj", "down_proj")))
                      for name in names)
    nbytes = (tree_bytes(params["layers"]) + tree_bytes(params["norm"])
              + 2 * L * Hkv * D * 2 * (slots + B) + 2 * B * H * 2)
    out["bound_ms"], out["bound_by"] = bound(nbytes, [
        (2 * B * layer_elems, PEAK_INT8_OPS),
        (4 * cfg.num_attention_heads * D * slots * L, PEAK_FP32_FLOPS)])
    line("kernel talker_step", S_buf=S_buf,
         one_layer_max_rel_err=f"{out['one_layer']:.3g}",
         full_depth_max_rel_err=f"{out['full']:.3g}",
         twin_card_vs_host_rel_spread=f"{out['spread']:.3g}",
         logits_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in B_SET},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in B_SET},
         **{f"bound_ms_B{max(B_SET)}": f"{out['bound_ms']:.4f}"})
    return out


class StandInTokenizer:
    """Deterministic stand-in for the Qwen2 text tokenizer (the smoke must
    run without `transformers` and without a tokenizer asset); ids are
    stable per text, one per character, at most `max_ids` (None: all)."""

    def __init__(self, max_ids=48):
        self.max_ids = max_ids

    def __call__(self, text, return_tensors=None, **kw):
        ids = [3 + (ord(c) * 11 + i) % 211 for i, c in enumerate(text)][:self.max_ids]
        ids += [5] * max(0, 12 - len(ids))
        return {"input_ids": np.asarray([ids], dtype=np.int64)}


def build_model(params, cfg, device):
    from qwen3_tts_tpu_torch.config import CodecV2Config, CodecV2DecoderConfig, TTSModelConfig
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.utils.testing import random_vocoder_params

    tc = dataclasses.replace(cfg, spk_id={"vivian": 3000},
                             codec_language_id={"english": 1000})
    tts_cfg = TTSModelConfig(talker_config=tc, tts_model_type="custom_voice",
                             tts_model_size="1b7")
    dec_cfg = CodecV2DecoderConfig()
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    tok = Qwen3TTSTokenizer.from_params(CodecV2Config(decoder_config=dec_cfg),
                                        dec_params=random_vocoder_params(dec_cfg, gen))
    tok.chunk_size = 64
    return Qwen3TTSModel(tts_cfg, params, None, tok, StandInTokenizer(), {},
                         quantized="int8", device=device)


def build_clone_model(params, cfg, device):
    """The same int8 talker as a base (voice-clone) model: the speaker
    encoder at the released widths with enc_dim = the talker width (the
    x-vector rides the codec track), the default-width Mimi encoder and
    vocoder, all random from the seed, fp32."""
    from qwen3_tts_tpu_torch.config import (CodecV2Config, CodecV2DecoderConfig,
                                            MimiEncoderConfig, SpeakerEncoderConfig,
                                            TTSModelConfig)
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.codec12.encoder import prepare_encoder_params
    from qwen3_tts_tpu_torch.utils.testing import (mimi_encoder_state, random_vocoder_params,
                                                   speaker_encoder_state)
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    tts_cfg = TTSModelConfig(
        talker_config=dataclasses.replace(cfg, codec_language_id={"english": 1000}),
        speaker_encoder_config=SpeakerEncoderConfig(enc_dim=cfg.hidden_size),
        tts_model_type="base", tts_model_size="1b7")
    codec_cfg = CodecV2Config(encoder_config=MimiEncoderConfig(),
                              decoder_config=CodecV2DecoderConfig())
    spk = from_jax_tree(speaker_encoder_state(tts_cfg.speaker_encoder_config, SEED + 4),
                        device)
    enc = prepare_encoder_params(
        from_jax_tree(mimi_encoder_state(codec_cfg.encoder_config, SEED + 5), device),
        codec_cfg.encoder_config)
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    tok = Qwen3TTSTokenizer.from_params(
        codec_cfg, enc_params=enc,
        dec_params=random_vocoder_params(codec_cfg.decoder_config, gen))
    return Qwen3TTSModel(tts_cfg, params, spk, tok, StandInTokenizer(max_ids=None), {},
                         quantized="int8", device=device)


def reference_clip(sr: int) -> np.ndarray:
    """CLONE_REF_SECONDS of a voice-like signal from the seed: a wandering
    pitch with harmonics, an amplitude envelope and a little noise."""
    rng = np.random.default_rng(SEED + 7)
    n = CLONE_REF_SECONDS * sr
    t = np.arange(n) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t) + 10 * rng.standard_normal(n).cumsum() / np.sqrt(n)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(h * phase) / h for h in range(1, 6))
    wav *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 2.1 * t))
    wav += 0.01 * rng.standard_normal(n)
    return (0.25 * wav / np.abs(wav).max()).astype(np.float32)


def phase_clone_front_end(model) -> dict:
    """The reference clip's codes and speaker embedding on the card against
    the host twins (the same fp32 trees on the CPU), and the clone prompt's
    prefill shape (T, per-row first valid slot)."""
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
    from qwen3_tts_tpu_torch.models.speaker_encoder import extract_speaker_embedding
    from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs

    sr = model.speech_tokenizer.get_input_sample_rate()
    wav = reference_clip(sr)
    tok = model.speech_tokenizer
    host_tok = Qwen3TTSTokenizer.from_params(tok.config, enc_params=to_host(tok.enc_params))
    t0 = time.time()
    card = tok.encode((wav, sr)).audio_codes[0]
    torch.cuda.synchronize()
    enc_s = time.time() - t0
    host = host_tok.encode((wav, sr)).audio_codes[0]
    spk_card = model.extract_speaker_embedding(wav, sr)
    with torch.no_grad():
        spk_host = extract_speaker_embedding(to_host(model.speaker_encoder_params),
                                             model.config.speaker_encoder_config, wav).numpy()
    cb0 = float((card[:, 0] == host[:, 0]).mean())
    every = float((card == host).mean())
    spk_rel = float(np.linalg.norm(spk_card - spk_host) / np.linalg.norm(spk_host))
    items = model.create_voice_clone_prompt((wav, sr), ref_text=CLONE_REF_TEXT)
    specs, _ = model._specs_voice_clone(CLONE_TEXTS, "english", None, None, False,
                                        items, True)
    with torch.no_grad():
        _, mask, _, _ = assemble_prompt_specs(model.talker_params, model.config.talker_config,
                                              model.config, specs, bucket=32)
    T = mask.shape[1]
    starts = tuple(int(s) for s in (T - mask.sum(dim=1)).tolist())
    line("clone front end", ref_frames=card.shape[0], codebooks=card.shape[1],
         codebook0_agreement=f"{cb0:.4f}", all_codebook_agreement=f"{every:.4f}",
         speaker_embedding_rel_err=f"{spk_rel:.3g}", encode_s=f"{enc_s:.3f}",
         prefill_T=T, starts=list(starts))
    if min(cb0, every) < MIN_CODEC_AGREEMENT:
        raise AssertionError(f"Mimi codes on the card vs the host twin: {cb0}, {every}")
    if not spk_rel <= SPK_REL_TOL:
        raise AssertionError(f"speaker embedding card vs host rel err {spk_rel}")
    if T < 2048 or len(set(starts)) < 2:
        raise AssertionError(f"clone prompt T={T} starts={starts}: want T >= 2048, ragged")
    return {"wav": wav, "sr": sr, "T": T, "starts": starts, "ref_frames": card.shape[0]}


def flash_work(T: int, starts, window, Hq: int, Hkv: int, D: int):
    """(flops, bytes) the flash prefill's data needs: the query-key pairs of
    the valid rows (each sees min(i - start + 1, window) keys), q/k/v of
    the valid tokens read once, the output written once."""
    pairs = 0
    for s in starts:
        n = T - s
        w = window or n
        pairs += n * (n + 1) // 2 if n <= w else w * (w + 1) // 2 + (n - w) * w
    valid = sum(T - s for s in starts)
    return 4 * Hq * D * pairs, valid * (2 * Hq + 2 * Hkv) * D * 2


def phase_flash(cfg, device, main_shape) -> dict:
    """Kernel against its twin (fp32 math on the same bf16 inputs) at the
    FLASH_CASES and at the clone's own prefill shape, which gives the JSON
    numbers; SDPA with the same boolean mask as the yardstick."""
    import torch.nn.functional as F

    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import (_kernel_view, _mask,
                                                                flash_prefill,
                                                                flash_prefill_ref)

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    out = {"err": 0.0, "row_rel": 0.0}
    cases = FLASH_CASES + [(len(main_shape["starts"]), main_shape["T"],
                            main_shape["starts"], cfg.sliding_window)]
    for i, (B, T, starts, window) in enumerate(cases):
        main = i == len(cases) - 1
        if main:   # views into one fused qkv product, as decoder_stack passes them
            q, k, v = (x.unflatten(-1, (-1, D)) for x in torch.randn(
                (B, T, (Hq + 2 * Hkv) * D), generator=gen, device=device
            ).to(torch.bfloat16).split([Hq * D, Hkv * D, Hkv * D], dim=-1))
            if not all(_kernel_view(x) is x for x in (q, k, v)):
                raise AssertionError("flash prefill: the fused qkv views were copied, "
                                     "so the kernel's strided loads go unchecked")
        else:
            q, k, v = (torch.randn((B, T, h, D), generator=gen, device=device
                                   ).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        start = torch.tensor(starts, dtype=torch.int32, device=device)
        got = flash_prefill(q, k, v, start, sliding_window=window)
        want = flash_prefill_ref(q.float(), k.float(), v.float(), start, sliding_window=window)
        torch.cuda.synchronize()
        err = max(max_abs(got[b, s:], want[b, s:]) for b, s in enumerate(starts))
        row_rel = max(float(((got[b, s:].float() - want[b, s:]).norm(dim=-1)
                             / want[b, s:].norm(dim=-1).clamp_min(1e-30)).max())
                      for b, s in enumerate(starts))
        pad_zero = all(bool((got[b, :s] == 0).all()) for b, s in enumerate(starts))
        out["err"] = max(out["err"], err)
        out["row_rel"] = max(out["row_rel"], row_rel)
        ms = cuda_ms(lambda: flash_prefill(q, k, v, start, sliding_window=window), 20)
        plain = cuda_ms(lambda: flash_prefill_ref(q, k, v, start, sliding_window=window), 3)
        mask = _mask(T, start, window)[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True), 10)
        flops, nbytes = flash_work(T, starts, window, Hq, Hkv, D)
        bms, by = bound(nbytes, [(flops, PEAK_BF16_FLOPS)])
        line("kernel flash_prefill" + (" (clone shape, fused qkv views)" if main else ""),
             B=B, T=T, starts=list(starts), window=window, max_abs_err=f"{err:.3g}",
             max_row_rel_err=f"{row_rel:.3g}", padded_rows_zero=pad_zero,
             ms=f"{ms:.4f}", plain_ms=f"{plain:.3f}",
             library_ms=f"{lib:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
             bound_share=f"{bms / ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
        if not (err <= FLASH_TOL and row_rel <= FLASH_ROW_REL_TOL and pad_zero):
            raise AssertionError(f"flash prefill B={B} T={T} window={window}: max abs err "
                                 f"{err} (bar {FLASH_TOL}), max row rel err {row_rel} "
                                 f"(bar {FLASH_ROW_REL_TOL}), padded rows zero: {pad_zero}")
        if main:
            out.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()
    return out


def phase_dense_crossover(cfg, device) -> None:
    """The dense plain prefill attention (what T < FLASH_PREFILL_MIN_T runs)
    against the flash kernel at B=4 without padding, T in {1024, 2048,
    4096}: where the route should switch on this card."""
    from qwen3_tts_tpu_torch.ops.attention import attention, mask_to_bias
    from qwen3_tts_tpu_torch.ops.cuda.prefill_attention import _mask, flash_prefill

    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    B, res = 4, {}
    for T in (1024, 2048, 4096):
        q, k, v = (torch.randn((B, T, h, D), generator=gen, device=device).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv))
        start = torch.zeros((B,), dtype=torch.int32, device=device)
        bias = mask_to_bias(_mask(T, start, None)[:, None])
        dense = cuda_ms(lambda: attention(q, k, v, bias), 3)
        flash = cuda_ms(lambda: flash_prefill(q, k, v, start), 10)
        res[T] = (dense, flash)
        del q, k, v, bias
        torch.cuda.empty_cache()
    line("dense vs flash prefill attention", B=B,
         **{f"T{T}": f"dense_ms={d:.3f},flash_ms={f:.4f},ratio={d / f:.1f}"
            for T, (d, f) in res.items()})


def phase_clone(model, front) -> dict:
    kw = dict(language="english", ref_audio=(front["wav"], front["sr"]),
              ref_text=CLONE_REF_TEXT, non_streaming_mode=True, seed=SEED)
    model.generate_voice_clone(CLONE_TEXTS, max_new_tokens=2, **kw)   # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    wavs, sr = model.generate_voice_clone(CLONE_TEXTS, max_new_tokens=CLONE_MAX_NEW_TOKENS,
                                          **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    if sr != 24000:
        raise AssertionError(f"sample rate {sr}")
    up = model.speech_tokenizer.get_decode_upsample_rate()
    rl = front["ref_frames"]
    frames = []
    for w in wavs:
        # the reference codes decode ahead of the generated ones and the
        # same share of samples is cut off the front, with the reference's
        # float arithmetic: the whole-frame decode minus exactly that cut
        g = round(w.shape[0] / up)
        total = (rl + g) * up
        if not (w.ndim == 1 and g > 0 and w.shape[0] == total - int(rl / (rl + g) * total)):
            raise AssertionError(f"waveform of {w.shape} samples is not whole {up}-sample "
                                 "frames after the reference cut")
        if not np.isfinite(w).all():
            raise AssertionError("non-finite waveform")
        frames.append(g)
    L = model.config.talker_config.num_hidden_layers
    if launches["flash_prefill"] < L or min(launches.values()) <= 0:
        raise AssertionError(f"clone main path launches {launches}: want flash_prefill >= {L} "
                             "and both decode kernels")
    audio_s = sum(frames) * up / sr
    line("slice clone", texts=len(CLONE_TEXTS), prefill_T=front["T"],
         starts=list(front["starts"]), frames=frames, wall_s=f"{wall:.3f}",
         frames_per_s=f"{sum(frames) / wall:.2f}", rtf=f"{wall / audio_s:.4f}",
         launches=launches)
    return launches


def phase_slice(model) -> dict:
    kw = dict(speaker="vivian", language="english", seed=SEED)
    model.generate_custom_voice(TEXTS[:1], max_new_tokens=4, **kw)   # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    wavs, sr = model.generate_custom_voice(TEXTS, max_new_tokens=MAX_NEW_TOKENS, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    if sr != 24000:
        raise AssertionError(f"sample rate {sr}")
    up = model.speech_tokenizer.get_decode_upsample_rate()
    frames = []
    for w in wavs:
        if not (w.ndim == 1 and w.shape[0] > 0 and w.shape[0] % up == 0):
            raise AssertionError(f"waveform shape {w.shape} is not whole {up}-sample frames")
        if not np.isfinite(w).all():
            raise AssertionError("non-finite waveform")
        frames.append(w.shape[0] // up)
    for name in ("subtalker", "talker_step"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel was not launched on the main path")
    audio_s = sum(frames) * up / sr
    line("slice", texts=len(TEXTS), frames=frames, wall_s=f"{wall:.3f}",
         frames_per_s=f"{sum(frames) / wall:.2f}", rtf=f"{wall / audio_s:.4f}",
         launches=launches)
    return launches


def run(cfg, device) -> list:
    """Every phase after the build, at talker config `cfg`; returns the
    kernels' JSON rows."""
    t0 = time.time()
    params = model_params(cfg, device)
    line("weights", seconds=f"{time.time() - t0:.1f}",
         gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    model = build_model(params, cfg, device)
    sub = phase_subtalker(params, cfg, device)
    # the main path's KV length: the bucketed prompt plus max_new_tokens + 1,
    # rounded up to whole 128-slot chunks
    S_buf = 256
    step = phase_talker_step(params, cfg, device, S_buf)
    launches = phase_slice(model)
    t0 = time.time()
    clone_model = build_clone_model(params, cfg, device)
    line("clone weights", seconds=f"{time.time() - t0:.1f}",
         gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    front = phase_clone_front_end(clone_model)
    flash = phase_flash(cfg, device, front)
    phase_dense_crossover(cfg, device)
    clone_launches = phase_clone(clone_model, front)
    return [
        {"name": "subtalker_frame_fused", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/subtalker.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/subtalker.py:352",
         "launches": launches["subtalker"], "max_abs_err": sub["err"],
         "ms": sub["ms"][max(B_SET)], "plain_ms": sub["plain_ms"][max(B_SET)],
         "bound_ms": sub["bound_ms"], "bound_by": sub["bound_by"], "library_ms": None},
        {"name": "talker_step_fused_cache", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:417",
         "launches": launches["talker_step"], "max_abs_err": step["err"],
         "ms": step["ms"][max(B_SET)], "plain_ms": step["plain_ms"][max(B_SET)],
         "bound_ms": step["bound_ms"], "bound_by": step["bound_by"], "library_ms": None},
        {"name": "flash_prefill", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/prefill_attention.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/prefill_attention.py:174",
         "launches": clone_launches["flash_prefill"], "max_abs_err": flash["err"],
         "ms": flash["ms"], "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]},
    ]


def main() -> int:
    phase_device()
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7

    phase_build()
    kernels = run(TALKER_1B7, torch.device("cuda"))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
