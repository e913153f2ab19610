"""The port's ops against their JAX twins on the same numpy inputs.

Tolerance: 1e-5 in fp32 (both sides compute in fp32 on the CPU; only the
order of float sums differs). Sampling compares ids exactly: the categorical
draw is argmax(logits + gumbel) in both packages, and the JAX key's Gumbel
draw is handed to the port as `noise`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.ops import attention as jattn
from qwen3_tts_tpu.ops import conv as jconv
from qwen3_tts_tpu.ops import norms as jnorms
from qwen3_tts_tpu.ops import rope as jrope
from qwen3_tts_tpu.ops import sampling as jsamp
from qwen3_tts_tpu_torch.ops import attention as tattn
from qwen3_tts_tpu_torch.ops import conv as tconv
from qwen3_tts_tpu_torch.ops import norms as tnorms
from qwen3_tts_tpu_torch.ops import rope as trope
from qwen3_tts_tpu_torch.ops import sampling as tsamp
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, **kw):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(kw or TOL))


def test_norms():
    r = _rng(0)
    x = r.normal(0, 2, (3, 5, 48)).astype(np.float32)
    w = r.normal(1, 0.1, (48,)).astype(np.float32)
    b = r.normal(0, 0.1, (48,)).astype(np.float32)
    _close(tnorms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    _close(tnorms.layer_norm(torch.tensor(x), torch.tensor(w), torch.tensor(b), 1e-5),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))


def test_rope():
    r = _rng(1)
    q = r.normal(size=(2, 7, 4, 32)).astype(np.float32)
    k = r.normal(size=(2, 7, 2, 32)).astype(np.float32)
    pos = r.integers(0, 500, size=(2, 7))
    _close(trope.default_inv_freq(32, 10000.0), jrope.default_inv_freq(32, 10000.0))
    tc, ts = trope.rope_tables(torch.tensor(pos), trope.default_inv_freq(32, 1e4))
    jc, js = jrope.rope_tables(jnp.asarray(pos), jrope.default_inv_freq(32, 1e4))
    # cos/sin of arguments up to ~500 rad: one fp32 ulp of the argument
    _close(tc, jc, rtol=1e-5, atol=1e-4)
    _close(ts, js, rtol=1e-5, atol=1e-4)
    tq, tk = trope.apply_rope(torch.tensor(q), torch.tensor(k), torch.tensor(np.asarray(jc)),
                              torch.tensor(np.asarray(js)))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("window", [None, 3])
def test_attention_gqa_masks(window):
    r = _rng(2)
    B, T, Hq, Hkv, D = 2, 6, 4, 2, 16
    q = r.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = r.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = r.normal(size=(B, T, Hkv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T))
    valid = np.ones((B, T), bool)
    valid[1, :2] = False
    tm = tattn.causal_mask(torch.tensor(pos), torch.tensor(pos), torch.tensor(valid), window)
    jm = jattn.causal_mask(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(valid), window)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tattn.mask_to_bias(tm).numpy(),
                                  np.asarray(jattn.mask_to_bias(jm)))
    _close(tattn.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), tm),
           jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))


def _logits(seed, B=4, V=97):
    r = _rng(seed)
    logits = r.normal(0, 3, (B, V)).astype(np.float32)
    presence = r.random((B, V)) < 0.2
    suppress = np.zeros(V, bool)
    suppress[-10:] = True
    suppress[V - 3] = False   # the "EOS" id stays allowed
    ban = np.array([True, False] * (B // 2))
    return logits, presence, suppress, ban


@pytest.mark.parametrize("params", [
    dict(do_sample=False),
    dict(do_sample=True, top_k=8, top_p=1.0, temperature=0.8),
    dict(do_sample=True, top_k=8, top_p=0.7, temperature=1.3),
    dict(do_sample=True, top_k=0, top_p=0.9, temperature=0.9),
])
def test_process_and_sample(params):
    logits, presence, suppress, ban = _logits(3)
    B, V = logits.shape
    sp_j = jsamp.SamplingParams(repetition_penalty=1.1, **params)
    sp_t = tsamp.SamplingParams(repetition_penalty=1.1, **params)
    key = jax.random.PRNGKey(5)
    want = jsamp.process_and_sample(jnp.asarray(logits), key, sp_j,
                                    presence=jnp.asarray(presence),
                                    suppress_mask=jnp.asarray(suppress),
                                    ban_eos=jnp.asarray(ban), eos_id=V - 3)
    k = sp_j.top_k
    noise = np.asarray(jax.random.gumbel(key, (B, k if 0 < k < V else V), jnp.float32))
    got = tsamp.process_and_sample(torch.tensor(logits), sp_t,
                                   presence=torch.tensor(presence),
                                   suppress_mask=torch.tensor(suppress),
                                   ban_eos=torch.tensor(ban), eos_id=V - 3,
                                   noise=torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,all_greedy", [(16, False), (0, False), (16, True)])
def test_process_and_sample_rows(top_k, all_greedy):
    logits, presence, suppress, ban = _logits(4)
    B, V = logits.shape
    rows = np.stack([
        jsamp.SamplingParams(do_sample=False).as_row(),
        jsamp.SamplingParams(do_sample=True, temperature=0.7, top_k=4).as_row(),
        jsamp.SamplingParams(do_sample=True, temperature=1.5, top_k=0,
                             top_p=0.8).as_row(),
        jsamp.SamplingParams(do_sample=True, temperature=1.0, top_k=12).as_row(),
    ])
    key = jax.random.PRNGKey(9)
    want = jsamp.process_and_sample_rows(
        jnp.asarray(logits), key, jnp.asarray(rows), top_k,
        presence=jnp.asarray(presence), suppress_mask=jnp.asarray(suppress),
        ban_eos=jnp.asarray(ban), eos_id=V - 3, all_greedy=all_greedy)
    noise = np.asarray(jax.random.gumbel(key, (B, top_k if top_k else V), jnp.float32))
    got = tsamp.process_and_sample_rows(
        torch.tensor(logits), torch.tensor(rows), top_k,
        presence=torch.tensor(presence), suppress_mask=torch.tensor(suppress),
        ban_eos=torch.tensor(ban), eos_id=V - 3, all_greedy=all_greedy,
        noise=torch.tensor(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,dilation,groups", [(1, 1, 1), (2, 1, 1), (1, 3, 1),
                                                    (1, 1, 4)])
def test_causal_conv1d(stride, dilation, groups):
    r = _rng(6)
    x = r.normal(size=(2, 8, 19)).astype(np.float32)
    w = r.normal(size=(12, 8 // groups, 5)).astype(np.float32)
    b = r.normal(size=(12,)).astype(np.float32)
    _close(tconv.causal_conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                               stride=stride, dilation=dilation, groups=groups),
           jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, dilation=dilation, groups=groups))


@pytest.mark.parametrize("stride,k", [(2, 4), (3, 6), (2, 2)])
def test_causal_conv_transpose1d_and_snake(stride, k):
    r = _rng(7)
    x = r.normal(size=(2, 6, 11)).astype(np.float32)
    w = r.normal(size=(6, 5, k)).astype(np.float32)
    b = r.normal(size=(5,)).astype(np.float32)
    _close(tconv.causal_conv_transpose1d(torch.tensor(x), torch.tensor(w),
                                         torch.tensor(b), stride=stride),
           jconv.causal_conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), stride=stride))
    a, be = r.normal(0, 0.3, (6,)).astype(np.float32), r.normal(0, 0.3, (6,)).astype(np.float32)
    _close(tconv.snake_beta(torch.tensor(x), torch.tensor(a), torch.tensor(be)),
           jconv.snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(be)))
