"""The int8 KV cache of the port against the JAX package: `kv_quantize`,
`attention_kv_quant`, the int8-KV mode of the talker-step twin, an int8
prefill, and int8-KV generation.

Tolerances:
- `kv_quantize`: bit-equal (same f32 division, round half to even);
- `attention_kv_quant` (fp32): 1e-5, float sums in another order;
- the talker-step twin (bf16 activations, W8A8): atol and rtol 2e-2 on
  logits, hidden and the fresh slot's scales, as tests/test_torch_talker_step.py
  holds the bf16 mode; the written int8 slot bit-equal at layer 0 (whose
  inputs are the same bf16 values) and within one step of 127 at later
  layers (a one-ulp change of a bf16 input can cross a rounding boundary);
- the int8 prefill (fp32): int8 values equal on >= 99.9% and within one
  step everywhere, scales 1e-5;
- fp32 greedy generation with an int8 cache: codes equal, waveforms atol
  1e-4 (the vocoder's fp32 convolutions sum in another order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops import attention as jattn
from qwen3_tts_tpu.ops.pallas import talker_step as jstep
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import quantize_talker_params
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops import attention as tattn
from qwen3_tts_tpu_torch.ops.cuda import talker_step as tstep
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, kv_quantizer_probe,
                                               kv_quantizer_traps)
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_pipeline import GREEDY, TEXTS, _models, checkpoint  # noqa: F401
from tests.test_torch_talker_step import CFG, TOL, _slot

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

SLIDING = dataclasses.replace(CFG, sliding_window=40)


def test_kv_quantize_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.3, (3, 5, 4, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0                       # amax 0: the 1e-8 floor
    x[1, 2, 3, :4] = [127.5, -0.5, 1.5, 2.5]   # exact halves round to even
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dtype)
        qj, sj = jtalker.kv_quantize(xj)
        qt, st = ttalker.kv_quantize(from_jax_tree(xj))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(
            ttalker.kv_dequantize(qt, st, torch.float32).numpy(),
            np.asarray(jtalker.kv_dequantize(qj, sj, jnp.float32)))


def test_quantizer_probe_rows():
    """The rows that hold the device quantizer to the rule: the port's and
    the JAX package's `kv_quantize` agree on them bit for bit; they hold
    rounding ties and values where a reciprocal multiply rounds otherwise,
    so round half away from zero and x * (1 / s) both give other int8
    values; `kv_store_rows` on CPU tensors is `kv_quantize`."""
    x = kv_quantizer_probe()
    traps = kv_quantizer_traps(x)
    assert traps["ties"].sum() >= 500 and traps["reciprocal"].sum() >= 5
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q, s = tstep.kv_store_rows(xb)
    qj, sj = jtalker.kv_quantize(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    xf, sc = xb.float(), s[:, None]
    assert (torch.round(xf * (1 / sc)) != q).any()
    assert (torch.sign(xf) * torch.floor(xf.abs() / sc + 0.5) != q).any()


@pytest.mark.parametrize("quant", [False, True])
def test_twin_raises_on_a_slot_past_the_buffer(quant):
    """A per-row write slot outside the buffer raises IndexError in the twin
    (on the card the kernel traps and the next sync raises)."""
    params = from_jax_tree(quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(1), dtype=jnp.bfloat16)))
    k, v, ks, vs, kv_valid, embed, position = (from_jax_tree(a)
                                               for a in _int8_state(2, 256, [20, 30]))
    if not quant:
        k, v = (ttalker.kv_dequantize(q, sc, torch.bfloat16) for q, sc in ((k, ks), (v, vs)))
    kw = dict(k_scale=ks, v_scale=vs) if quant else {}
    with pytest.raises(IndexError):
        tstep.talker_step_fused_cache(params, CFG, embed, position,
                                      torch.tensor([20, 256], dtype=torch.int32), kv_valid,
                                      k, v, **kw)


def test_attention_kv_quant_matches_jax():
    rng = np.random.default_rng(1)
    B, Tq, Tk, Hq, Hkv, D = 2, 3, 11, 4, 2, 16
    q = jnp.asarray(rng.normal(0, 1, (B, Tq, Hq, D)), jnp.float32)
    kq, ks = jtalker.kv_quantize(jnp.asarray(rng.normal(0, 1, (B, Tk, Hkv, D)), jnp.float32))
    vq, vs = jtalker.kv_quantize(jnp.asarray(rng.normal(0, 1, (B, Tk, Hkv, D)), jnp.float32))
    mask = jnp.asarray(rng.random((B, 1, Tq, Tk)) > 0.3)
    want = jattn.attention_kv_quant(q, kq, ks, vq, vs, mask)
    got = tattn.attention_kv_quant(*(from_jax_tree(a) for a in (q, kq, ks, vq, vs, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _int8_state(B, S_buf, ci, seed=0):
    """Random int8 KV history with scales, in the fused layout."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = CFG.num_hidden_layers, CFG.num_key_value_heads, CFG.resolved_head_dim
    k, ks = jtalker.kv_quantize(jnp.asarray(rng.normal(0, 0.5, (L, B, Hkv, S_buf, D)),
                                            jnp.bfloat16))
    v, vs = jtalker.kv_quantize(jnp.asarray(rng.normal(0, 0.5, (L, B, Hkv, S_buf, D)),
                                            jnp.bfloat16))
    slot = np.arange(S_buf)[None, :]
    start = rng.integers(0, 4, size=(B, 1))
    kv_valid = jnp.asarray((slot >= start) & (slot <= np.reshape(ci, (-1, 1))), bool)
    embed = jnp.asarray(rng.normal(0, 0.3, (B, 1, CFG.hidden_size)), jnp.bfloat16)
    position = jnp.asarray(rng.integers(40, 42, size=(B,)), jnp.int32)
    return k, v, ks, vs, kv_valid, embed, position


@pytest.mark.parametrize("cfg,S_buf,attend_len,ci", [
    (CFG, 256, 256, 37), (CFG, 512, 256, 37), (CFG, 256, None, [37, 12, 90, 5]),
    (SLIDING, 256, 256, 100), (SLIDING, 512, 256, [100, 12, 70, 45])])
def test_int8_twin_matches_jax_reference(cfg, S_buf, attend_len, ci):
    params = quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    B = 4
    k, v, ks, vs, kv_valid, embed, position = _int8_state(B, S_buf, ci)
    ci_j = jnp.asarray(ci, jnp.int32) if isinstance(ci, list) else ci
    lg_j, h_j, kj, vj, ksj, vsj = jstep.talker_step_ref(
        params, cfg, embed, position, ci_j, kv_valid, k, v, attend_len=attend_len,
        k_scale=ks, v_scale=vs)

    kt, vt, kst, vst = (from_jax_tree(a) for a in (k, v, ks, vs))
    ci_t = torch.tensor(ci, dtype=torch.int32) if isinstance(ci, list) else ci
    before = (tstep.talker_step_fused_cache.launches,
              tstep.talker_step_fused_cache.launches_int8_kv)
    out = tstep.talker_step_fused_cache(
        from_jax_tree(params), cfg, from_jax_tree(embed), from_jax_tree(position), ci_t,
        from_jax_tree(kv_valid), kt, vt, attend_len=attend_len, k_scale=kst, v_scale=vst)
    assert (tstep.talker_step_fused_cache.launches,
            tstep.talker_step_fused_cache.launches_int8_kv) == before
    lg_t, h_t, kt2, vt2, kst2, vst2 = out
    assert kt2 is kt and kst2 is kst   # written in place

    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), **TOL)
    for got, want in ((kst, ksj), (vst, vsj)):
        np.testing.assert_allclose(_slot(got.numpy()[..., None], ci, B),
                                   _slot(np.asarray(want)[..., None], ci, B), **TOL)
    for got, want in ((kt, kj), (vt, vj)):
        g, w = _slot(got.numpy(), ci, B).astype(int), _slot(np.asarray(want), ci, B).astype(int)
        # layer 0's fresh K/V come from the same bf16 inputs: bit-equal
        np.testing.assert_array_equal(g[0], w[0])
        assert np.abs(g - w).max() <= 1
        keep = np.ones(got.shape, bool)
        for b, c in enumerate(np.broadcast_to(np.asarray(ci), (B,))):
            keep[:, b, :, c] = False
        np.testing.assert_array_equal(got.numpy()[keep], np.asarray(want)[keep])


def test_int8_prefill_writes_jax_cache():
    """An fp32 prefill into an int8 cache writes the JAX package's int8
    values and scales (layouts (L, B, Hkv, S, D) here, (L, B, S, Hkv, D)
    there)."""
    rng = np.random.default_rng(2)
    cfg = CFG
    params_j = random_talker_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    params_j = jax.tree_util.tree_map(lambda x: x * 3.0, params_j)
    B, T, S = 2, 9, 16
    embeds = jnp.asarray(rng.normal(0, 0.5, (B, T, cfg.hidden_size)), jnp.float32)
    mask = jnp.asarray(np.arange(T)[None, :] >= np.array([[0], [3]]), jnp.int32)
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.resolved_head_dim
    cj = jtalker.KVCache.zeros(L, B, S, Hkv, D, jnp.float32, quantized=True)
    lj, _, cj = jtalker.talker_prefill(params_j, cfg, embeds, mask, cj)
    ct = ttalker.KVCache.zeros(L, B, S, Hkv, D, torch.float32, quantized=True)
    lt, _, ct = ttalker.talker_prefill(from_jax_tree(params_j), cfg, from_jax_tree(embeds),
                                       from_jax_tree(mask), ct)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    for got, want in ((ct.k, cj.k), (ct.v, cj.v)):
        g, w = got.numpy().astype(int), np.swapaxes(np.asarray(want), 2, 3).astype(int)
        assert np.abs(g - w).max() <= 1 and (g == w).mean() >= 0.999
    for got, want in ((ct.k_scale, cj.k_scale), (ct.v_scale, cj.v_scale)):
        np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(want), 2, 3),
                                   rtol=1e-5, atol=1e-7)


def test_wrapper_int8_mode_on_cpu_tensors():
    """On CPU tensors the wrapper's int8 mode is the twin's: a 6-tuple, the
    scales written at the slot only; a lone scale plane raises."""
    params = from_jax_tree(quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(1), dtype=jnp.bfloat16)))
    k, v, ks, vs, kv_valid, embed, position = (from_jax_tree(a)
                                               for a in _int8_state(2, 256, 20))
    ks_before = ks.clone()
    out = tstep.talker_step_fused_cache(params, CFG, embed, position, 20, kv_valid,
                                        k, v, k_scale=ks, v_scale=vs)
    assert len(out) == 6
    changed = (ks != ks_before).any(dim=(0, 1, 2))
    assert changed.nonzero().flatten().tolist() == [20]
    with pytest.raises(ValueError, match="both"):
        tstep.talker_step_fused_cache(params, CFG, embed, position, 20, kv_valid, k, v,
                                      k_scale=ks)


def test_fp32_greedy_int8_kv_generate_matches_jax(checkpoint):  # noqa: F811
    """generate_custom_voice(kv_quant=True), fp32 greedy on the dense
    route: the port's codes equal the JAX package's, waveforms 1e-4."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    kw = dict(GREEDY, kv_quant=True)
    codes = []
    for m in (jm, tm):
        gen_cfg = m._generation_config(m._merge_generate_kwargs(**kw))
        assert gen_cfg.kv_quant
        specs = m._specs_custom_voice(TEXTS, "vivian", "english", None, True)
        codes.append(m._run(specs, gen_cfg, seed=0))
    for cj, ct in zip(*codes):
        assert ct.shape[0] > 0
        np.testing.assert_array_equal(ct, cj)
    wj, _ = jm.generate_custom_voice(TEXTS, speaker="vivian", language="english", seed=0,
                                     **kw)
    wt, _ = tm.generate_custom_voice(TEXTS, speaker="vivian", language="english", seed=0,
                                     **kw)
    for a, b in zip(wt, wj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
