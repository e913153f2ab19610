"""The port's flash prefill against the JAX package's.

- `flash_prefill_ref` (the twin the wrapper runs on CPU tensors) against the
  JAX `flash_prefill` in interpret mode, on the cases of
  tests/test_pallas_kernels.py with that file's tolerances: fp32 rtol/atol
  2e-5 on valid rows (the sums run in another order), bf16 3e-2 (bf16
  outputs); padded rows are zeros in both.
- `flash_plan`, the kernel's work list, against `_mask` over a sweep of
  (T, starts, window): the visited tiles hold exactly the keys some row of
  the query tile sees, unmasked tiles are wholly visible and masked ones
  are not, padding-only query tiles are zero writes, and every item is
  dealt to one CTA once;
- `flash_tile_products`' plain version (the kernel's two products on one
  tile) against numpy, rows and keys past T read as zeros;
- `talker_prefill` with the flash route forced on at small shapes (both
  packages' FLASH_PREFILL_MIN_T lowered to 8, the port's fit rule opened to
  the tiny fp32 shapes: `open_flash_route`) against the JAX package's,
  on one fp32 parameter tree: logits, valid hiddens and valid cache slots
  within 1e-4 (28-op layer chains in another sum order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops.pallas.prefill_attention import flash_prefill as j_flash
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops.cuda import prefill_attention as tpa
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_prefill_route import open_flash_route
from tests.test_torch_weights import TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

CASES = {
    # B, T, Hq, Hkv, D, starts, window, dtype, (block_q, block_k), tol
    "ragged_starts": (2, 160, 8, 4, 128, [0, 37], None, np.float32, (64, 64), 2e-5),
    "window_ragged_T": (2, 100, 4, 2, 64, [5, 0], 24, np.float32, (32, 32), 2e-5),
    "bf16": (1, 128, 4, 2, 128, [11], None, "bf16", (256, 512), 3e-2),
}


def _inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, size=(B, T, Hq, D)).astype(np.float32),
            rng.normal(0, 1, size=(B, T, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, size=(B, T, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_flash_prefill_twin_matches_jax(case):
    B, T, Hq, Hkv, D, starts, window, dtype, (bq, bk), tol = CASES[case]
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=len(case))
    start = np.asarray(starts, np.int32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    want = np.asarray(j_flash(jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                              jnp.asarray(start), sliding_window=window, block_q=bq,
                              block_k=bk, interpret=True)).astype(np.float32)
    launches = tpa.flash_prefill.launches
    got = tpa.flash_prefill(torch.tensor(q).to(tdt), torch.tensor(k).to(tdt),
                            torch.tensor(v).to(tdt), torch.tensor(start),
                            sliding_window=window)
    assert tpa.flash_prefill.launches == launches   # CPU tensors run the twin
    assert got.dtype == tdt and tuple(got.shape) == (B, T, Hq, D)
    got = got.float().numpy()
    for b in range(B):
        s = start[b]
        np.testing.assert_allclose(got[b, s:], want[b, s:], rtol=tol, atol=tol)
        assert not got[b, :s].any() and not want[b, :s].any()


def test_flash_prefill_twin_matches_dense_attention():
    """The twin equals the dense masked `attention` of ops/attention.py on
    valid rows (fp32, 1e-5): the flash route computes the same function."""
    from qwen3_tts_tpu_torch.ops.attention import attention

    B, T, Hq, Hkv, D = 2, 48, 4, 2, 16
    q, k, v = (torch.tensor(x) for x in _inputs(B, T, Hq, Hkv, D, seed=7))
    start = torch.tensor([0, 13], dtype=torch.int32)
    for window in (None, 10):
        ok = tpa._mask(T, start, window)[:, None]
        want = attention(q, k, v, ok)
        got = tpa.flash_prefill_ref(q, k, v, start, sliding_window=window)
        for b in range(B):
            torch.testing.assert_close(got[b, start[b]:], want[b, start[b]:],
                                       rtol=1e-5, atol=1e-5)


PLAN_CASES = [  # (T, starts, window)
    (2304, (24, 414), None),            # the clone prefill
    (2100, (0, 77, 2050), None),        # T not a multiple of 128, a row of padding tiles
    (2048, (0, 129, 700, 1500), 512),   # a window of several tiles
    (1000, (0, 300), 100),              # a window smaller than one tile
    (300, (5, 0, 299), 24),
    (64, (0, 63), None),
    (130, (129,), 1),
]


@pytest.mark.parametrize("T,starts,window", PLAN_CASES)
def test_flash_plan_covers_exactly_the_visible_keys(T, starts, window):
    Hkv, ctas = 2, 7
    items, offsets = tpa.flash_plan(T, starts, window, Hkv, ctas)
    nq = -(-T // tpa.FP_BQ)
    assert items.shape == (len(starts) * Hkv * nq, len(tpa.ITEM_FIELDS))
    assert offsets[0] == 0 and offsets[-1] == len(items)
    assert len(offsets) == min(len(items), ctas) + 1
    assert (np.diff(offsets) > 0).all()
    assert len({(b, hk, q) for b, hk, q in items[:, :3].tolist()}) == len(items)
    mask = tpa._mask(T, torch.tensor(starts), window).numpy()
    for b, hk, q_lo, kt_lo, kt_hi, um_lo, um_hi, s in items.tolist():
        assert s == starts[b] and q_lo % tpa.FP_BQ == 0
        vis = mask[b, q_lo:min(q_lo + tpa.FP_BQ, T)]        # valid rows of the tile
        visited = np.zeros(T, bool)
        visited[kt_lo * tpa.FP_BK:(kt_hi + 1) * tpa.FP_BK] = kt_lo <= kt_hi
        assert not (vis.any(0) & ~visited).any()             # every visible key is visited
        assert (kt_lo > kt_hi) == (not vis.any())            # a zero write iff all padding
        for kt in range(kt_lo, kt_hi + 1):
            tile = vis[:, kt * tpa.FP_BK:(kt + 1) * tpa.FP_BK]
            assert tile.any()                                # no tile visited for nothing
            whole = tile.all() and (kt + 1) * tpa.FP_BK <= T
            assert whole == (um_lo <= kt <= um_hi)           # masks on edge tiles only


def test_device_plan_is_kept_per_start_tensor():
    start = torch.tensor([3, 200], dtype=torch.int32)
    items, offsets = tpa.device_plan(start, 640, None, 2, 5)
    want_items, want_offsets = tpa.flash_plan(640, [3, 200], None, 2, 5)
    assert np.array_equal(items.numpy(), want_items)
    assert np.array_equal(offsets.numpy(), want_offsets)
    assert tpa.device_plan(start, 640, None, 2, 5)[0] is items
    start[1] = 0   # written in place: a new plan
    again = tpa.device_plan(start, 640, None, 2, 5)[0]
    assert again is not items and (again[:, 7] == 0).any()


@pytest.mark.parametrize("q_lo,k0", [(0, 0), (64, 128), (192, 128)])
def test_flash_tile_products_plain_version(q_lo, k0):
    B, T, Hq, Hkv, D = 2, 250, 4, 2, 128
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(B, T, Hq, Hkv, D, 5))
    s, o = tpa.flash_tile_products(q, k, v, 1, 3, q_lo, k0)

    def tile(x, h, lo, n):
        t = np.zeros((n, D), np.float32)
        rows = x[1, lo:lo + n, h].float().numpy()
        t[:len(rows)] = rows
        return t

    want_s = tile(q, 3, q_lo, 64) @ tile(k, 1, k0, 128).T
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-5, atol=1e-4)
    p = s.to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(o.numpy(), p @ tile(v, 1, k0, 128), rtol=1e-5, atol=1e-4)


def test_flash_prefill_refuses_other_devices():
    q = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.flash_prefill(q, q[:, :, :1], q[:, :, :1], torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("window", [None, 16])
def test_talker_prefill_flash_route_matches_jax(monkeypatch, window):
    cfg = dataclasses.replace(TINY, sliding_window=window)
    params = random_talker_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    B, T, S = 2, 40, 48
    rng = np.random.default_rng(1)
    embeds = (0.3 * rng.normal(size=(B, T, cfg.hidden_size))).astype(np.float32)
    mask = (np.arange(T)[None, :] >= np.array([[0], [7]])).astype(np.int32)
    monkeypatch.setattr(jtalker, "FLASH_PREFILL_MIN_T", 8)
    open_flash_route(monkeypatch)
    dims = jtalker.StackDims.from_talker(cfg)

    jcache = jtalker.KVCache.zeros(cfg.num_hidden_layers, B, S, dims.kv_heads,
                                   dims.head_dim, dtype=jnp.float32)
    lj, hj, cj = jtalker.talker_prefill(params, cfg, jnp.asarray(embeds),
                                        jnp.asarray(mask), jcache)
    tcache = ttalker.KVCache.zeros(cfg.num_hidden_layers, B, S, dims.kv_heads,
                                   dims.head_dim, dtype=torch.float32)
    calls = []
    real = tpa.flash_prefill_ref
    monkeypatch.setattr(tpa, "flash_prefill_ref",
                        lambda *a: calls.append(a[5]) or real(*a))
    lt, ht, ct = ttalker.talker_prefill(from_jax_tree(params), cfg, torch.tensor(embeds),
                                        torch.tensor(mask), tcache)
    assert calls == [window] * cfg.num_hidden_layers   # the flash route ran
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4, atol=1e-4)
    for b in range(B):
        lo = int(T - mask[b].sum())
        np.testing.assert_allclose(ht[b, lo:].numpy(), np.asarray(hj)[b, lo:],
                                   rtol=1e-4, atol=1e-4)
        # the port's cache is (L, B, Hkv, S, D); the JAX cache (L, B, S, Hkv, D)
        for t_c, j_c in ((ct.k, cj.k), (ct.v, cj.v)):
            np.testing.assert_allclose(t_c[:, b, :, lo:T].permute(0, 2, 1, 3).numpy(),
                                       np.asarray(j_c)[:, b, lo:T], rtol=1e-4, atol=1e-4)
