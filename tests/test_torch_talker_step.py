"""The talker-step twin (`talker_step_ref`, which the CUDA wrapper runs for
CPU tensors) against the JAX package's exact-math `talker_step_ref` (mxu
attention), on the tiny config of tests/test_pallas_talker_step.py.

Tolerance: logits, hidden and the written K/V slot allclose at atol and
rtol 2e-2. Both sides carry bf16 activations, and a one-ulp change of a
bf16 input (float sums in another order) can move a value into the next
int8 bucket of the W8A8 activation quantiser.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodePredictorConfig, TalkerConfig
from qwen3_tts_tpu.ops.pallas import talker_step as jstep
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import quantize_talker_params
from qwen3_tts_tpu_torch.ops.cuda import talker_step as tstep
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

CFG = TalkerConfig(
    vocab_size=256, hidden_size=96, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, text_hidden_size=96, text_vocab_size=128, num_code_groups=5,
    codec_eos_token_id=250, codec_pad_id=251, codec_bos_id=252,
    codec_think_id=253, codec_nothink_id=254, codec_think_bos_id=255,
    codec_think_eos_id=249,
    code_predictor_config=CodePredictorConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_code_groups=5))
TOL = dict(rtol=2e-2, atol=2e-2)


def _state(B, S_buf, ci, seed=0):
    """Random bf16 KV history in the fused (L, B, Hkv, S, D) layout, ragged
    per-row validity, one fresh embedding (as the JAX suite builds it)."""
    rng = np.random.default_rng(seed)
    L, Hkv, D = CFG.num_hidden_layers, CFG.num_key_value_heads, CFG.resolved_head_dim
    k = jnp.asarray(rng.normal(0, 0.5, (L, B, Hkv, S_buf, D)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(0, 0.5, (L, B, Hkv, S_buf, D)), jnp.bfloat16)
    slot = np.arange(S_buf)[None, :]
    start = rng.integers(0, 4, size=(B, 1))
    ci_col = np.reshape(ci, (-1, 1))
    kv_valid = jnp.asarray((slot >= start) & (slot <= ci_col), bool)
    embed = jnp.asarray(rng.normal(0, 0.3, (B, 1, CFG.hidden_size)), jnp.bfloat16)
    position = jnp.asarray(rng.integers(40, 42, size=(B,)), jnp.int32)
    return k, v, kv_valid, embed, position


def _slot(cache, ci, B):
    ci = np.broadcast_to(np.asarray(ci), (B,))
    return np.stack([cache[:, b, :, ci[b]] for b in range(B)], axis=1)


@pytest.mark.parametrize("S_buf,attend_len,ci", [
    (256, 256, 37), (512, 512, 37), (512, 256, 37), (256, None, [37, 12, 90, 5])])
def test_twin_matches_jax_reference(S_buf, attend_len, ci):
    params = quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16))
    B = 4
    k, v, kv_valid, embed, position = _state(B, S_buf, ci)
    ci_j = jnp.asarray(ci, jnp.int32) if isinstance(ci, list) else ci
    lg_j, h_j, kj, vj = jstep.talker_step_ref(
        params, CFG, embed, position, ci_j, kv_valid, k, v, attend_len=attend_len)

    kt, vt = from_jax_tree(k), from_jax_tree(v)
    ci_t = torch.tensor(ci, dtype=torch.int32) if isinstance(ci, list) else ci
    lg_t, h_t, kt2, vt2 = tstep.talker_step_ref(
        from_jax_tree(params), CFG, from_jax_tree(embed), from_jax_tree(position),
        ci_t, from_jax_tree(kv_valid), kt, vt, attend_len=attend_len)
    assert kt2 is kt and vt2 is vt   # written in place

    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
    np.testing.assert_allclose(h_t.float().numpy(), np.asarray(h_j, np.float32), **TOL)
    kt_np, vt_np = kt.float().numpy(), vt.float().numpy()
    kj_np, vj_np = np.asarray(kj, np.float32), np.asarray(vj, np.float32)
    np.testing.assert_allclose(_slot(kt_np, ci, B), _slot(kj_np, ci, B), **TOL)
    np.testing.assert_allclose(_slot(vt_np, ci, B), _slot(vj_np, ci, B), **TOL)
    # every other slot is untouched
    keep = np.ones(kt_np.shape, bool)
    for b, c in enumerate(np.broadcast_to(np.asarray(ci), (B,))):
        keep[:, b, :, c] = False
    np.testing.assert_array_equal(kt_np[keep], np.asarray(k, np.float32)[keep])


def test_mlp_chunks_and_int8_matmul_match_jax():
    """The chunk count and the W8A8 product are the reference's exactly."""
    for inter in (6144, 3072, 128, 100, 7):
        assert tstep.pick_mlp_chunks(inter) == jstep._pick_mlp_chunks(inter)
    r = np.random.default_rng(3)
    x = jnp.asarray(r.normal(0, 1, (5, 64)), jnp.bfloat16)
    wq = jnp.asarray(r.integers(-127, 128, (48, 64)), jnp.int8)
    ws = jnp.asarray(r.uniform(1e-3, 1e-2, (48,)), jnp.float32)
    want = np.asarray(jstep._mm8(x, wq, ws))
    got = tstep.mm8(from_jax_tree(x), from_jax_tree(wq), from_jax_tree(ws)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_twin_on_cpu_tensors():
    params = from_jax_tree(quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(1), dtype=jnp.bfloat16)))
    k, v, kv_valid, embed, position = (from_jax_tree(a) for a in _state(2, 256, 20))
    k2, v2 = k.clone(), v.clone()
    before = tstep.talker_step_fused_cache.launches
    lg_w, h_w, _, _ = tstep.talker_step_fused_cache(params, CFG, embed, position, 20,
                                                    kv_valid, k, v)
    lg_r, h_r, _, _ = tstep.talker_step_ref(params, CFG, embed, position, 20,
                                            kv_valid, k2, v2)
    assert tstep.talker_step_fused_cache.launches == before
    np.testing.assert_array_equal(lg_w.numpy(), lg_r.numpy())
    np.testing.assert_array_equal(k.float().numpy(), k2.float().numpy())
    plain = from_jax_tree(random_talker_params(CFG, jax.random.PRNGKey(1)))
    with pytest.raises(ValueError, match="int8"):
        tstep.talker_step_fused_cache(plain, CFG, embed, position, 20, kv_valid, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        tstep.talker_step_fused_cache(params, CFG, embed.to("meta"), position, 20,
                                      kv_valid, k, v)
