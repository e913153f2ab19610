"""Batches past the layer engine's 32 rows, and the 0.6B preset.

Both decode wrappers run a batch of more than `build.ENGINE_MAX_ROWS` rows
as equal row tiles, one launch each (`build.row_tiles`,
`subtalker.frame_row_tiles`, `talker_step.step_row_tiles`). The tiling is
held here through the plain twins, at B=10 in tiles of at most 4 (4 + 4 + 4,
the last tile repeating two rows of the one before), against the untiled
twin on the same inputs:
- sub-talker codes equal under the same injected Gumbel noise (the twin's
  rows are independent and its integer sums exact), emb_sum allclose at
  1e-6;
- talker-step logits and hidden allclose at 1e-5 (the fp32 codec head and
  norms may block their sums by batch size), every written cache slot and
  scale the untiled twin's, written in place in the caller's caches, and
  every other slot untouched.
The 0.6B preset equals the JAX package's field for field, and both kernels'
host checks accept its widths (kernel 1 without the small_to_mtp
projection, kernel 2 at hidden 1024).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models import talker as jtalker
from qwen3_tts_tpu.utils import testing as jtesting
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import quantize_talker_params
from qwen3_tts_tpu_torch.ops.cuda import build
from qwen3_tts_tpu_torch.ops.cuda import subtalker as tsub
from qwen3_tts_tpu_torch.ops.cuda import talker_step as tstep
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
from qwen3_tts_tpu_torch.utils import testing as ttesting
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_talker_step import CFG, _state

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

B, MAX_ROWS = 10, 4


@pytest.mark.parametrize("rows,max_rows,want", [
    (48, 32, [(0, 24), (24, 48)]),
    (64, 32, [(0, 32), (32, 64)]),
    (32, 32, [(0, 32)]),
    (1, 32, [(0, 1)]),
    (33, 32, [(0, 17), (16, 33)]),
    (10, 4, [(0, 4), (4, 8), (6, 10)]),
])
def test_row_tiles(rows, max_rows, want):
    """ceil(B / max_rows) equal tiles of at most max_rows that cover every
    row; where they do not divide B the last one ends at row B."""
    tiles = build.row_tiles(rows, max_rows)
    assert [(t.start, t.stop) for t in tiles] == want
    assert len({t.stop - t.start for t in tiles}) == 1
    assert set().union(*(range(t.start, t.stop) for t in tiles)) == set(range(rows))


@pytest.fixture(scope="module")
def params():
    return from_jax_tree(quantize_talker_params(
        random_talker_params(CFG, jax.random.PRNGKey(5), dtype=jnp.bfloat16)))


@pytest.mark.parametrize("mode", ["greedy", "sampled", "rows", "generator"])
def test_subtalker_row_tiles_match_the_untiled_twin(params, mode):
    cp, cp_cfg = params["code_predictor"], CFG.code_predictor_config
    Qm1, V = cp["lm_heads"].shape[:2]
    rng = np.random.default_rng(11)
    h, c0 = (torch.from_numpy(rng.normal(0, 0.5, (B, 1, CFG.hidden_size)).astype(np.float32)
                              ).to(torch.bfloat16) for _ in range(2))
    g = torch.from_numpy(rng.gumbel(size=(Qm1, B, V)).astype(np.float32))
    sampled = SamplingParams(do_sample=True, top_k=5, temperature=0.9)
    rows = torch.tensor(np.stack([
        (SamplingParams(do_sample=False) if b % 3 == 0 else sampled).as_row() for b in range(B)]))
    kw = {"greedy": dict(sampling=SamplingParams(do_sample=False)),
          "sampled": dict(sampling=sampled, gumbel=g),
          "rows": dict(sampling=None, rows=rows, gumbel=g),
          "generator": dict(sampling=sampled)}[mode]

    def run(fn, **extra):
        if mode == "generator":
            extra["generator"] = torch.Generator().manual_seed(3)
        return fn(cp, cp_cfg, h, c0, **kw, **extra)

    whole = run(tsub.subtalker_frame_ref)
    tiled = run(lambda *a, **k: tsub.frame_row_tiles(tsub.subtalker_frame_ref, *a, **k,
                                                     max_rows=MAX_ROWS))
    assert torch.equal(tiled[0], whole[0])
    assert torch.allclose(tiled[1].float(), whole[1].float(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_slot", "per_row_slots"])
def test_talker_step_row_tiles_match_the_untiled_twin(params, quant, per_row):
    S = 256
    ci = [200 - 7 * b for b in range(B)] if per_row else 200
    k, v, kv_valid, embed, position = _state(B, S, ci, seed=4)
    if quant:
        (k, ks), (v, vs) = jtalker.kv_quantize(k), jtalker.kv_quantize(v)
        scales = [from_jax_tree(ks), from_jax_tree(vs)]
    else:
        scales = []
    k, v, kv_valid, embed, position = (from_jax_tree(a) for a in (k, v, kv_valid, embed, position))
    ci_t = torch.tensor(ci, dtype=torch.int32) if per_row else ci

    def run(step):
        caches = [c.clone() for c in [k, v] + scales]
        kw = dict(zip(("k_scale", "v_scale"), caches[2:]))
        out = step(params, CFG, embed, position, ci_t, kv_valid, caches[0], caches[1], **kw)
        assert all(o is c for o, c in zip(out[2:], caches))   # written in place
        return out[0], out[1], caches

    lw, hw, cw = run(tstep.talker_step_ref)
    lt, ht, ct = run(lambda *a, **kw: tstep.step_row_tiles(tstep.talker_step_ref, *a, **kw,
                                                            max_rows=MAX_ROWS))
    assert torch.allclose(lt, lw, rtol=1e-5, atol=1e-5)
    assert torch.allclose(ht.float(), hw.float(), rtol=1e-5, atol=1e-5)
    cis = np.broadcast_to(np.asarray(ci), (B,))
    for whole, tiled, orig in zip(cw, ct, [k, v] + scales):
        assert torch.equal(tiled, whole)
        for b in range(B):   # every row's slot written, nothing else
            assert not torch.equal(tiled[:, b, :, cis[b]], orig[:, b, :, cis[b]])
            keep = torch.ones(S, dtype=torch.bool)
            keep[cis[b]] = False
            assert torch.equal(tiled[:, b, :, keep], orig[:, b, :, keep])


def test_talker_0b6_preset_is_the_jax_one():
    assert dataclasses.asdict(ttesting.TALKER_0B6) == dataclasses.asdict(jtesting.TALKER_0B6)
    assert dataclasses.asdict(ttesting.TALKER_1B7) == dataclasses.asdict(jtesting.TALKER_1B7)


@pytest.mark.parametrize("preset", ["TALKER_0B6", "TALKER_1B7"])
def test_kernel_host_checks_take_the_released_widths(preset):
    """Kernel 2 at the talker's widths and kernel 1 at the code predictor's,
    at B = 32 (one launch) and B = 1; at 0.6B the talker's hidden size is
    the code predictor's, so kernel 1 runs without a projection."""
    cfg = getattr(ttesting, preset)
    cp = cfg.code_predictor_config
    has_proj = cfg.hidden_size != cp.hidden_size
    assert has_proj == (preset == "TALKER_1B7")
    for rows in (1, 32):
        build.check_layer_shapes(rows, cfg.hidden_size, cfg.num_attention_heads,
                                 cfg.num_key_value_heads, cfg.resolved_head_dim,
                                 cfg.intermediate_size,
                                 tstep.pick_mlp_chunks(cfg.intermediate_size))
        tsub.check_frame_shapes(rows, cfg.hidden_size, cp, cp.vocab_size,
                                cfg.num_code_groups - 1, has_proj)
    with pytest.raises(ValueError):   # one launch takes at most 32 rows
        tsub.check_frame_shapes(33, cfg.hidden_size, cp, cp.vocab_size,
                                cfg.num_code_groups - 1, has_proj)
