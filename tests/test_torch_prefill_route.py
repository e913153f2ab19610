"""Kernel 3's route: which prefills attend through `flash_prefill`, on the CPU.

The kernel (csrc/prefill_attention.cu) is built for bf16, head_dim 128 and
two query heads per kv head; the JAX `flash_prefill` takes any. So the
port routes by shape, before launch: `models/talker.py`
`prefill_uses_flash` sends a prefill through kernel 3 iff it has its rows'
starts, T >= FLASH_PREFILL_MIN_T and `flash_misfit` is None, on every
device, and everything else attends densely, which is what the JAX package
computes below its own threshold (2048). Here:
- `flash_misfit` names each rule, and is None for the released shape;
- `talker_prefill` at T=260 (past the port's threshold of 256, below the
  JAX package's 2048) on tiny talkers: G=4 and fp32 loads take the dense
  route (no call of the flash twin) and agree with the JAX package's
  `talker_prefill` within 1e-4 in fp32 (a 2-layer chain summed in another
  order); in bf16 the G=4 talker's prefill is bit-equal to the dense route
  (`allow_flash=False`), and a bf16 G=2 talker with head_dim 128 still
  takes the flash route, its valid hiddens within 5e-2 relative L2 of the
  dense route's (the twin's probabilities stay fp32 where the dense path
  casts them to bf16; 1.6e-2 measured over the 2 layers).
The prefill graph's key and plan buffers and the staging graphs' plan
buffers follow the same rule: tests/test_torch_prefill_graphs.py, route
"misfit".

`open_flash_route` is how the other files drive the flash twin at tiny
fp32 shapes: it lowers the threshold and lets the shapes pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.cuda import prefill_attention as tpa
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_weights import TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_FLASH_REL_L2 = 5e-2
T_ROUTE = 260


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def open_flash_route(monkeypatch, min_t: int = 8) -> None:
    """Send every prefill of `min_t` tokens or more through the flash twin:
    the threshold lowered and `flash_misfit` passing any shape (the tiny
    fp32 configs of the tests break its rules; this file tests them)."""
    monkeypatch.setattr(ttalker, "FLASH_PREFILL_MIN_T", min_t)
    monkeypatch.setattr(ttalker, "flash_misfit", lambda *a: None)


@pytest.mark.parametrize("args,rule", [
    ((torch.bfloat16, 16, 8, 128), None),           # the released 1.7B / 0.6B shape
    ((torch.float32, 16, 8, 128), "bf16"),
    ((torch.bfloat16, 16, 8, 64), "head_dim 128"),
    ((torch.bfloat16, 32, 8, 128), "two query heads"),
    ((torch.bfloat16, 8, 8, 128), "two query heads")])
def test_flash_misfit_names_each_rule(args, rule):
    got = tpa.flash_misfit(*args)
    assert got is None if rule is None else rule in got


def _cfg(heads, kv_heads):
    return dataclasses.replace(TINY, num_attention_heads=heads, num_key_value_heads=kv_heads,
                               head_dim=128)


@pytest.mark.parametrize("name,heads,kv_heads", [("G=4", 8, 2), ("G=2", 4, 2)])
def test_prefill_route_by_shape_at_t260(monkeypatch, name, heads, kv_heads):
    cfg = _cfg(heads, kv_heads)
    params = jax.tree_util.tree_map(lambda x: x * 3.0, random_talker_params(
        cfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    B, T, S = 2, T_ROUTE, T_ROUTE + 4
    rng = np.random.default_rng(2)
    embeds = (0.3 * rng.normal(size=(B, T, cfg.hidden_size))).astype(np.float32)
    mask = (np.arange(T)[None, :] >= np.array([[0], [37]])).astype(np.int32)
    calls = []
    real = tpa.flash_prefill_ref
    monkeypatch.setattr(tpa, "flash_prefill_ref", lambda *a: calls.append(1) or real(*a))
    dims = ttalker.StackDims.from_talker(cfg)

    def port(dtype, allow_flash=True):
        tp = from_jax_tree(jax.tree_util.tree_map(lambda x: x.astype(dtype), params))
        cache = ttalker.KVCache.zeros(cfg.num_hidden_layers, B, S, dims.kv_heads,
                                      dims.head_dim, dtype=torch.float32)
        del calls[:]
        out = ttalker.talker_prefill(tp, cfg, torch.tensor(embeds).to(
            torch.float32 if dtype == jnp.float32 else torch.bfloat16),
            torch.tensor(mask), cache, allow_flash=allow_flash)
        return out, len(calls)

    # fp32: the dense route, against the JAX package's (dense below 2048)
    (lt, ht, _), n = port(jnp.float32)
    assert T >= ttalker.FLASH_PREFILL_MIN_T and T < jtalker.FLASH_PREFILL_MIN_T
    assert n == 0 and not ttalker.prefill_uses_flash(dims, T, torch.float32)
    jcache = jtalker.KVCache.zeros(cfg.num_hidden_layers, B, S, dims.kv_heads,
                                   dims.head_dim, dtype=jnp.float32)
    lj, hj, _ = jtalker.talker_prefill(params, cfg, jnp.asarray(embeds), jnp.asarray(mask),
                                       jcache)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **FP32_TOL)
    for b in range(B):
        lo = int(T - mask[b].sum())
        np.testing.assert_allclose(ht[b, lo:].numpy(), np.asarray(hj)[b, lo:], **FP32_TOL)

    # bf16: G=4 stays dense (bit-equal to allow_flash=False); G=2 with
    # head_dim 128 is the kernel's shape and takes the flash route
    (lb, hb, _), n = port(jnp.bfloat16)
    (ld, hd, _), n_dense = port(jnp.bfloat16, allow_flash=False)
    flash = name == "G=2"
    assert ttalker.prefill_uses_flash(dims, T, torch.bfloat16) == flash
    assert (n, n_dense) == ((cfg.num_hidden_layers if flash else 0), 0)
    if flash:
        for b in range(B):
            lo = int(T - mask[b].sum())
            assert rel_l2(hb[b, lo:], hd[b, lo:]) < BF16_FLASH_REL_L2
    else:
        assert torch.equal(lb, ld) and torch.equal(hb, hd)
