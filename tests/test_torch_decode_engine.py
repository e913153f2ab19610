"""The host-visible code of the decode layer engine against the JAX package.

What the persistent kernels (csrc/common.cuh) changed in plain PyTorch:
- `talker_step_ref(..., kv_splits=S)`, the kernel's split-K attention order
  (the window's chunks in S runs, each an online softmax from an empty
  state, the partial sums folded in run order, then the fresh slot), against
  the JAX package's one-pass `talker_step_ref`;
- `pick_kv_splits`, which chooses S for the kernel;
- `engine_gemm` / `mm8`, the GEMM stage's twin, over the column segments
  and the gate_up pairing the engine uses, against the JAX `_mm8`;
- the wrappers' state kept between calls (`build.launch_state`,
  `build.converted`).

Tolerances:
- the split twin against the JAX reference: relative L2 <= 2e-2 on logits
  and hidden. Both sides carry bf16 activations re-quantised to int8 at every
  matmul, and a split moves the running max at which e = bf16(exp(s - m)) is
  rounded. The slot written at layer 0 (same bf16 inputs on both sides) is
  bit-equal, later layers' slots allclose at 2e-2 (bf16 KV) or within one
  int8 step (int8 KV); every other slot is untouched;
- kv_splits=1, and any split count whose extra runs hold no live slot, are
  bit-equal to the one-pass order: a dead run folds in with weight 0;
- `mm8` against the JAX `_mm8`: bit-equal (exact integer sums, the same f32
  epilogue);
- the wrappers on a second call and after a change of B: bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.ops.pallas import subtalker as jsub
from qwen3_tts_tpu.ops.pallas import talker_step as jstep
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import quantize_talker_params
from qwen3_tts_tpu_torch.ops.cuda import build
from qwen3_tts_tpu_torch.ops.cuda import subtalker as tsub
from qwen3_tts_tpu_torch.ops.cuda import talker_step as tstep
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_talker_step import CFG, TOL, _slot, _state

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

SLIDING = dataclasses.replace(CFG, sliding_window=300)
S_BUF = 1024            # eight 128-slot chunks: up to eight runs
REL_L2 = 2e-2
SPLIT_CASES = [           # (config, write slot(s))
    (CFG, 900),                                   # one slot for the batch, ragged validity
    (CFG, [900, 130, 517, 40]),                   # per-row slots, rows that end in other runs
    (SLIDING, [900, 700, 517, 310]),              # a sliding window over several runs
]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def params_j():
    return quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16))


def _inputs(ci, quant, seed=3):
    """(JAX arrays, torch tensors) of one step over S_BUF slots; int8 KV:
    the bf16 history through the JAX `kv_quantize`."""
    B = 4
    k, v, kv_valid, embed, position = _state(B, S_BUF, ci, seed=seed)
    scales = {}
    if quant:
        (k, ks), (v, vs) = jtalker.kv_quantize(k), jtalker.kv_quantize(v)
        scales = dict(k_scale=ks, v_scale=vs)
    ci_j = jnp.asarray(ci, jnp.int32) if isinstance(ci, list) else ci
    ci_t = torch.tensor(ci, dtype=torch.int32) if isinstance(ci, list) else ci
    jax_in = (embed, position, ci_j, kv_valid, k, v), scales
    torch_in = (tuple(from_jax_tree(a) for a in (embed, position)) + (ci_t,)
                + tuple(from_jax_tree(a) for a in (kv_valid, k, v)),
                {n: from_jax_tree(a) for n, a in scales.items()})
    return B, jax_in, torch_in


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
@pytest.mark.parametrize("splits", [1, 2, 8])
@pytest.mark.parametrize("cfg,ci", SPLIT_CASES, ids=["scalar", "per_row", "sliding"])
def test_split_twin_matches_jax_reference(params_j, cfg, ci, splits, quant):
    B, (jargs, jkw), (targs, tkw) = _inputs(ci, quant)
    out_j = jstep.talker_step_ref(params_j, cfg, *jargs, **jkw)
    before = [t.clone() for t in targs[4:6]] + [t.clone() for t in tkw.values()]
    out_t = tstep.talker_step_ref(from_jax_tree(params_j), cfg, *targs, kv_splits=splits, **tkw)
    assert len(out_t) == len(out_j) == (6 if quant else 4)
    assert _rel(out_t[0].numpy(), out_j[0]) <= REL_L2
    assert _rel(out_t[1].float().numpy(), np.asarray(out_j[1], np.float32)) <= REL_L2
    for got, want, old in zip(out_t[2:], out_j[2:], before):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        planes = got.ndim == 4   # a scale plane (L, B, Hkv, S)
        g = _slot(got[..., None] if planes else got, ci, B)
        w = _slot(want[..., None] if planes else want, ci, B)
        if quant and not planes:
            np.testing.assert_array_equal(g[0], w[0])   # layer 0: the same bf16 inputs
            assert np.abs(g - w).max() <= 1
        else:
            if not planes:
                np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_allclose(g, w, **TOL)
        keep = np.ones(got.shape, bool)
        for b, c in enumerate(np.broadcast_to(np.asarray(ci), (B,))):
            keep[:, b, :, c] = False
        np.testing.assert_array_equal(got[keep], old.float().numpy()[keep])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
def test_one_split_is_the_one_pass_order(params_j, quant):
    """kv_splits=1 is the default bit for bit, and so is any split count when
    only the first run holds live slots (ci < 128): a run without a live slot
    folds in with weight exp(NEG_INF - m) = 0."""
    params = from_jax_tree(params_j)
    B, _, (targs, tkw) = _inputs([100, 37, 5, 127], quant)

    def run(**kw):
        args = tuple(a.clone() if torch.is_tensor(a) else a for a in targs)
        return tstep.talker_step_ref(params, CFG, *args,
                                     **{n: a.clone() for n, a in tkw.items()}, **kw)

    want = run()
    for splits in (1, 2, 8):
        got = run(kv_splits=splits)
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"kv_splits={splits}"
    with pytest.raises(ValueError):
        run(kv_splits=0)


def test_split_order_differs_only_in_rounding(params_j):
    """With live slots in several runs the split order is another rounding of
    the same sums: not bit-equal to one pass, and within 2e-2 of it."""
    params = from_jax_tree(params_j)
    _, _, (targs, _) = _inputs(900, False)
    one = tstep.talker_step_ref(params, CFG, *(a.clone() if torch.is_tensor(a) else a
                                               for a in targs))
    eight = tstep.talker_step_ref(params, CFG, *(a.clone() if torch.is_tensor(a) else a
                                                 for a in targs), kv_splits=8)
    assert not torch.equal(one[0], eight[0])
    assert _rel(eight[0].numpy(), one[0].numpy()) <= REL_L2


@pytest.mark.parametrize("B,kvh,S,blocks", [
    (2, 8, 2432, 132), (1, 8, 2432, 132), (8, 8, 256, 132), (16, 8, 256, 132),
    (32, 8, 256, 132), (4, 8, 1024, 132), (1, 2, 128, 132), (3, 8, 3000, 108),
    (1, 1, 8192, 132)])
def test_pick_kv_splits(B, kvh, S, blocks):
    """Every run holds at least one chunk (two when the window is split), no
    chunk is left out, the count stays within the partial buffers, and the
    items do not exceed the blocks once the window is split."""
    splits = tstep.pick_kv_splits(B, kvh, S, blocks)
    nchunks = -(-S // tstep.KV_CHUNK)
    cps = -(-nchunks // splits)
    assert 1 <= splits <= build.KV_SPLITS_MAX
    assert (splits - 1) * cps < nchunks <= splits * cps
    if splits > 1:
        assert cps >= 2 and B * kvh * splits <= max(blocks, B * kvh) * 2
    if B * kvh >= blocks // 2 + 1 or nchunks < 4:
        assert splits == 1


def test_pick_kv_splits_at_the_served_shapes():
    assert tstep.pick_kv_splits(2, 8, 2432, 132) >= 4      # the clone window: B=2 covers the SMs
    assert tstep.pick_kv_splits(8, 8, 256, 132) == 1       # two chunks: not worth a fold
    assert tstep.pick_kv_splits(32, 8, 256, 132) == 1


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("B", [1, 8, 32])
def test_engine_gemm_twin_is_the_jax_mm8(B, paired):
    """`engine_gemm` on CPU tensors is `mm8`, which equals the JAX `_mm8` bit
    for bit: on a whole matrix, on each K segment of a chunked down
    projection taken through its row stride, and for gate_up, whose paired
    tiling only reorders rows (gate rows and up rows keep their places)."""
    rng = np.random.default_rng(B)
    N, K, nseg = 48, 192, 3
    x = (rng.normal(0, 1.5, (B, K))).astype(np.float32)
    wq = rng.integers(-127, 128, (N, K)).astype(np.int8)
    ws = rng.uniform(1e-3, 2e-2, (N,)).astype(np.float32)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    wt, st = torch.from_numpy(wq), torch.from_numpy(ws)
    seg = K // nseg
    for c in range(nseg):
        cols = slice(c * seg, (c + 1) * seg)
        want = np.asarray(jsub._mm8(xj[:, cols], jnp.asarray(wq[:, cols]), jnp.asarray(ws)))
        got = tstep.engine_gemm(xt[:, cols], wt[:, cols], st, paired)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jsub._mm8(xj, jnp.asarray(wq), jnp.asarray(ws)))
    np.testing.assert_array_equal(tstep.engine_gemm(xt, wt, st, paired).numpy(), want)


def test_converted_weights_are_kept_and_refreshed():
    """`build.converted` copies a weight once, returns a tensor of the wanted
    type as it is, and converts again after an in-place write or for another
    tensor object."""
    w = torch.arange(6, dtype=torch.float32).to(torch.bfloat16)
    assert build.converted(w, torch.bfloat16) is w
    a = build.converted(w, torch.float32)
    assert a.dtype == torch.float32 and build.converted(w, torch.float32) is a
    w.mul_(2)
    b = build.converted(w, torch.float32)
    assert b is not a and torch.equal(b, w.float())
    w2 = w.clone()
    assert build.converted(w2, torch.float32) is not b


def test_launch_state_is_per_shape_stream_and_weights():
    """`build.launch_state` builds once per key and weights: the same state
    on a second call, a new one for another batch size or stream, after a
    weight was written to, and for other weight tensors."""
    made = []

    def make(st):
        made.append(st)
        st.scratch = torch.empty(4)

    w = [torch.zeros(3), torch.ones(2)]
    a = build.launch_state(("t", 0, 7, 8), w, make)
    assert build.launch_state(("t", 0, 7, 8), w, make) is a and len(made) == 1
    b = build.launch_state(("t", 0, 7, 32), w, make)          # another batch size
    c = build.launch_state(("t", 0, 9, 8), w, make)           # another stream
    assert b is not a and c is not a and b.scratch is not a.scratch
    assert build.launch_state(("t", 0, 7, 8), w, make) is a   # the first is still there
    w[0].add_(1)                                              # a weight was written to
    d = build.launch_state(("t", 0, 7, 8), w, make)
    assert d is not a and build.launch_state(("t", 0, 7, 8), w, make) is d
    w2 = [t.clone() for t in w]                               # other tensors, same values
    assert build.launch_state(("t", 0, 7, 8), w2, make) is not d
    assert len(made) == 5


def test_engine_scratch_zeroed_region_is_one_block():
    """The barrier words, the attention's arrival counts and the product's
    maxima are one zeroed int32 tensor, in that order, each part as large as
    the kernels index it."""
    B, H, heads, kvh, D, inter, nseg, inst = 3, 192, 4, 2, 64, 512, 2, 5
    t, zero_bytes, ts = build.engine_scratch(B, H, heads, kvh, D, inter, nseg, inst, "cpu")
    zeroed = ts["bar"]
    assert zeroed.dtype == torch.int32 and not zeroed.any()
    assert zero_bytes == zeroed.numel() * 4
    assert t.cnt - t.bar >= 2 * 4 and t.amax - t.cnt >= B * kvh * 4
    assert t.bar + zero_bytes - t.amax == inst * B * nseg * 4
    assert ts["part_acc"].shape == (B * kvh * build.KV_SPLITS_MAX, heads // kvh, D)
    assert ts["qkv"].shape == (B, (heads + 2 * kvh) * D) and ts["prod"].shape == (B, inter)
    assert ts["xq_g"].shape == (B, inter) and ts["xs_g"].shape == (B, nseg)


@pytest.mark.parametrize("shape,ok", [
    (dict(B=8, H=2048, heads=16, kvh=8, D=128, inter=6144, nseg=6), True),    # the 1.7B talker
    (dict(B=32, H=1024, heads=16, kvh=8, D=128, inter=3072, nseg=1), True),   # its code predictor
    (dict(B=33, H=1024, heads=16, kvh=8, D=128, inter=3072, nseg=1), False),  # too many rows
    (dict(B=8, H=96, heads=4, kvh=2, D=16, inter=128, nseg=2), False),        # the tests' widths
    (dict(B=8, H=2048, heads=32, kvh=8, D=128, inter=6144, nseg=6), False),   # G = 4
    (dict(B=8, H=2048, heads=16, kvh=8, D=128, inter=6144, nseg=1), False),   # K = 6144 > 4096
])
def test_check_layer_shapes(shape, ok):
    if ok:
        build.check_layer_shapes(**shape)
    else:
        with pytest.raises(ValueError):
            build.check_layer_shapes(**shape)


def test_wrappers_repeat_and_follow_a_change_of_batch(params_j):
    """Both decode wrappers give the same outputs on a second call, and after
    a call at another batch size the first batch's outputs again."""
    params = from_jax_tree(params_j)
    cp, cp_cfg = params["code_predictor"], CFG.code_predictor_config
    Qm1, V = cp["lm_heads"].shape[:2]
    sampled = SamplingParams(do_sample=True, top_k=5, temperature=0.9)

    def step(B, seed):
        k, v, kv_valid, embed, position = (from_jax_tree(a)
                                           for a in _state(B, 256, 37, seed=seed))
        return tstep.talker_step_fused_cache(params, CFG, embed, position, 37, kv_valid, k, v)

    def frame(B, seed):
        rng = np.random.default_rng(seed)
        h, c0 = (torch.from_numpy(rng.normal(0, 0.5, (B, 1, CFG.hidden_size)).astype(np.float32)
                                  ).to(torch.bfloat16) for _ in range(2))
        g = torch.from_numpy(rng.gumbel(size=(Qm1, B, V)).astype(np.float32))
        return tsub.subtalker_frame_fused(cp, cp_cfg, h, c0, sampled, gumbel=g)

    for fn in (step, frame):
        first = fn(4, 0)
        again = fn(4, 0)
        fn(2, 1)
        back = fn(4, 0)
        for a, b, c in zip(first, again, back):
            assert torch.equal(a, b) and torch.equal(a, c)
