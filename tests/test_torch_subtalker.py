"""The sub-talker twin (`subtalker_frame_ref`, which the CUDA wrapper runs
for CPU tensors) against the JAX package's exact-math `subtalker_frame_ref`,
on the tiny config of tests/test_pallas_subtalker.py.

Tolerances are the JAX suite's own for kernel-vs-reference: both sides
compute W8A8 with bf16 activations, and a one-ulp difference in a bf16
activation (sums in another order) can move a row's int8 bucket and flip a
near-tie argmax, which then cascades through the autoregressive chain. So:
mean code agreement >= 0.9 over 4 seeds, and emb_sum within rtol 0.05 /
atol 0.02 on rows whose codes fully agree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodePredictorConfig, TalkerConfig
from qwen3_tts_tpu.ops.pallas import subtalker as jsub
from qwen3_tts_tpu.ops.sampling import SamplingParams as JSampling
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import quantize_talker_params
from qwen3_tts_tpu_torch.ops.cuda import subtalker as tsub
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TSampling
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
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_code_groups=5))
CP_CFG = CFG.code_predictor_config


def _tiny_cp(seed, B=4):
    params = quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(seed), dtype=jnp.bfloat16))
    cp = params["code_predictor"]
    rng = np.random.default_rng(seed)
    hidden = jnp.asarray(rng.normal(0, 0.5, (B, 1, CFG.hidden_size)), jnp.bfloat16)
    c0e = jnp.asarray(rng.normal(0, 0.5, (B, 1, CFG.hidden_size)), jnp.bfloat16)
    return cp, hidden, c0e


def _run_both(seed, j_sampling, t_sampling, rows=None):
    cp, hidden, c0e = _tiny_cp(seed)
    key = jax.random.PRNGKey(7 + seed)
    codes_j, emb_j = jsub.subtalker_frame_ref(
        cp, CP_CFG, hidden, c0e, key, j_sampling,
        rows=None if rows is None else jnp.asarray(rows))
    Qm1, V = cp["lm_heads"].shape[:2]
    gumbel = np.asarray(jax.random.gumbel(key, (Qm1, hidden.shape[0], V), jnp.float32))
    codes_t, emb_t = tsub.subtalker_frame_ref(
        from_jax_tree(cp), CP_CFG, from_jax_tree(hidden), from_jax_tree(c0e),
        t_sampling, rows=None if rows is None else torch.tensor(rows),
        gumbel=torch.tensor(gumbel))
    return (np.asarray(codes_j), np.asarray(emb_j, np.float32),
            codes_t.numpy(), emb_t.float().numpy())


def _check(results):
    agree = []
    for codes_j, emb_j, codes_t, emb_t in results:
        assert codes_t.shape == codes_j.shape and codes_t.dtype == np.int32
        assert emb_t.shape == emb_j.shape
        agree.append((codes_j == codes_t).mean())
        full = (codes_j == codes_t).all(axis=1)
        if full.any():
            np.testing.assert_allclose(emb_t[full], emb_j[full], rtol=0.05, atol=0.02)
    assert float(np.mean(agree)) >= 0.9, agree


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_twin_matches_jax_reference(mode):
    if mode == "greedy":
        js, ts = JSampling(do_sample=False), TSampling(do_sample=False)
    else:
        js = JSampling(do_sample=True, top_k=8, temperature=0.9)
        ts = TSampling(do_sample=True, top_k=8, temperature=0.9)
    _check([_run_both(seed, js, ts) for seed in range(4)])


def test_twin_matches_jax_reference_per_row_sampling():
    """Mixed rows: greedy, two sampled with top-k, one sampled without."""
    rows = np.stack([
        JSampling(do_sample=False).as_row(),
        JSampling(do_sample=True, temperature=0.7, top_k=4).as_row(),
        JSampling(do_sample=True, temperature=2.0, top_k=16).as_row(),
        JSampling(do_sample=True, temperature=1.1, top_k=0).as_row(),
    ])
    _check([_run_both(seed, None, None, rows=rows) for seed in range(2)])


def test_kth_value_bits_exact():
    """The bit search reproduces jax.lax.top_k's k-th value exactly."""
    x = np.random.default_rng(0).normal(0, 3, (8, 257)).astype(np.float32)
    for k in (1, 2, 8, 50, 257):
        want = np.asarray(jax.lax.top_k(jnp.asarray(x), k)[0][:, -1:])
        got = tsub.kth_value_bits(torch.tensor(x), torch.full((8, 1), k))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"k={k}")


def test_wrapper_runs_twin_on_cpu_tensors():
    """On CPU tensors the kernel wrapper is the twin: same codes, and the
    launch counter does not move. Non-int8 params and top_p < 1 raise."""
    cp, hidden, c0e = _tiny_cp(0)
    cp_t = from_jax_tree(cp)
    h_t, c_t = from_jax_tree(hidden), from_jax_tree(c0e)
    sampling = TSampling(do_sample=True, top_k=8)
    g = torch.from_numpy(np.random.default_rng(1).gumbel(size=(4, 4, 64)).astype(np.float32))
    before = tsub.subtalker_frame_fused.launches
    codes_w, emb_w = tsub.subtalker_frame_fused(cp_t, CP_CFG, h_t, c_t, sampling, gumbel=g)
    codes_r, emb_r = tsub.subtalker_frame_ref(cp_t, CP_CFG, h_t, c_t, sampling, gumbel=g)
    assert tsub.subtalker_frame_fused.launches == before
    np.testing.assert_array_equal(codes_w.numpy(), codes_r.numpy())
    np.testing.assert_array_equal(emb_w.float().numpy(), emb_r.float().numpy())
    with pytest.raises(ValueError, match="top_p"):
        tsub.subtalker_frame_fused(cp_t, CP_CFG, h_t, c_t, TSampling(top_p=0.5))
    plain = from_jax_tree(random_talker_params(CFG, jax.random.PRNGKey(0))["code_predictor"])
    with pytest.raises(ValueError, match="int8"):
        tsub.subtalker_frame_fused(plain, CP_CFG, h_t, c_t, sampling)
    with pytest.raises(ValueError, match="unsupported device"):
        tsub.subtalker_frame_fused(cp_t, CP_CFG, h_t.to("meta"), c_t.to("meta"), sampling)
