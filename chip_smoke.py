"""Smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one line (any failure raises and exits non-zero):
1. device: CUDA present; the card's name and power limit (nvidia-smi);
2. build: compile the hand-written kernels from qwen3_tts_tpu_torch/csrc;
3. each kernel against its plain PyTorch twin on the card, at the 1.7B
   shapes with random int8 weights, B in {1, 8}: max errors, code agreement,
   kernel and twin times (CUDA events);
4. the slice: an in-memory 1.7B int8 custom-voice model (random weights from
   a seed, default-width 12 Hz vocoder, stand-in text tokenizer) synthesises
   a few texts through `generate_custom_voice`; the kernels' launch counters
   must move, the waveforms must be finite, 24 kHz, whole 1920-sample frames;
then one JSON line with every kernel's numbers, and the last line
{"ok": true, "device": {...}}.

Imports nothing of JAX: the port runs on hosts that have no JAX installed.
"""

from __future__ import annotations

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


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


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
    agree = float(np.mean(out["agree"]))
    line("kernel subtalker", code_agreement_vs_host_twin=f"{agree:.4f}",
         code_agreement_vs_card_twin=f"{np.mean(out['agree_card_twin']):.4f}",
         twin_card_vs_host_disagreement=f"{np.mean(out['twin_spread']):.4f}",
         emb_sum_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in B_SET},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in B_SET})
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
    import dataclasses

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
    line("kernel talker_step", S_buf=S_buf,
         one_layer_max_rel_err=f"{out['one_layer']:.3g}",
         full_depth_max_rel_err=f"{out['full']:.3g}",
         twin_card_vs_host_rel_spread=f"{out['spread']:.3g}",
         logits_max_abs_err=f"{out['err']:.3g}",
         **{f"ms_B{b}": f"{out['ms'][b]:.3f}" for b in B_SET},
         **{f"plain_ms_B{b}": f"{out['plain_ms'][b]:.3f}" for b in B_SET})
    return out


class StandInTokenizer:
    """Deterministic stand-in for the Qwen2 text tokenizer (the smoke must
    run without `transformers` and without a tokenizer asset); ids are
    stable per text."""

    def __call__(self, text, return_tensors=None, **kw):
        ids = [3 + (ord(c) * 11 + i) % 211 for i, c in enumerate(text)][:48]
        ids += [5] * max(0, 12 - len(ids))
        return {"input_ids": np.asarray([ids], dtype=np.int64)}


def build_model(params, cfg, device):
    import dataclasses

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
    return Qwen3TTSModel(tts_cfg, params, tok, StandInTokenizer(), {},
                         quantized="int8", device=device)


def phase_slice(model) -> dict:
    from qwen3_tts_tpu_torch.ops.cuda.subtalker import subtalker_frame_fused
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache

    kw = dict(speaker="vivian", language="english", seed=SEED)
    model.generate_custom_voice(TEXTS[:1], max_new_tokens=4, **kw)   # warm-up
    subtalker_frame_fused.launches = 0
    talker_step_fused_cache.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    wavs, sr = model.generate_custom_voice(TEXTS, max_new_tokens=MAX_NEW_TOKENS, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"subtalker": subtalker_frame_fused.launches,
                "talker_step": talker_step_fused_cache.launches}
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel was not launched on the main path")
    audio_s = sum(frames) * up / sr
    line("slice", texts=len(TEXTS), frames=frames, wall_s=f"{wall:.3f}",
         frames_per_s=f"{sum(frames) / wall:.2f}", rtf=f"{wall / audio_s:.4f}",
         launches=launches)
    return launches


def main() -> int:
    phase_device()
    from qwen3_tts_tpu_torch.utils.testing import TALKER_1B7

    phase_build()
    device = torch.device("cuda")
    cfg = TALKER_1B7
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
    kernels = [
        {"name": "subtalker_frame_fused", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/subtalker.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/subtalker.py:272",
         "launches": launches["subtalker"], "max_abs_err": sub["err"],
         "ms": sub["ms"][max(B_SET)], "plain_ms": sub["plain_ms"][max(B_SET)]},
        {"name": "talker_step_fused_cache", "route": "cuda",
         "source": "qwen3_tts_tpu_torch/csrc/talker_step.cu",
         "replaces": "qwen3_tts_tpu/ops/pallas/talker_step.py:293",
         "launches": launches["talker_step"], "max_abs_err": step["err"],
         "ms": step["ms"][max(B_SET)], "plain_ms": step["plain_ms"][max(B_SET)]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
