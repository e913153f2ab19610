"""The bandwidth probes' twins (`stream_sum_ref`, `shaped_sum_ref`, which the
CUDA wrappers run for CPU tensors) against the Pallas kernel bodies of
benchmarks/dma_peak.py run in interpret mode, and the probe arithmetic of
`qwen3_tts_tpu_torch/utils/dma_peak.py` against the script's.

Inputs are random from a numpy seed (the script streams ones, which would
hide a wrong index). The JAX kernels accumulate in f32 in their own order,
the twins in int64 / float64: the stream sums are integers small enough to
be exact in f32, so they must be equal; the shaped sums agree to f32
rounding of the largest partial sum (tolerance below).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from qwen3_tts_tpu_torch.ops.cuda import dma_peak as tdp
from qwen3_tts_tpu_torch.utils import dma_peak as udp
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(L=2, B=2, Hkv=2, Sc=8, S_buf=16, D=128, Wr=16, H=256)


@pytest.fixture(scope="module")
def jdp():
    """benchmarks/dma_peak.py, imported by path, in interpret mode."""
    saved = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(
        "dma_peak_jax", os.path.join(REPO, "benchmarks", "dma_peak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if saved is None:
        os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    else:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = saved
    mod.INTERPRET = True
    return mod


def _params():
    return pltpu.CompilerParams(dimension_semantics=("arbitrary", "arbitrary"))


def jax_stream(jdp, x: np.ndarray, block_rows: int, P: int) -> np.ndarray:
    """The script's stream pallas_call on x (n * block_rows, 1024)."""
    n = x.shape[0] // block_rows
    fn = pl.pallas_call(
        jdp._stream_kernel, grid=(P, n),
        in_specs=[pl.BlockSpec((block_rows, 1024), lambda p, i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1024,), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1024,), jnp.float32)],
        interpret=jdp.INTERPRET, compiler_params=_params())
    return np.asarray(fn(jnp.asarray(x)))


def jax_shaped(jdp, w, k, v, s1, s2, P, L, B, Hkv, Sc, S_buf, D, Wr, H, contig):
    """The script's shaped pallas_call, with its specs, on the given arrays."""
    nS = S_buf // Sc
    if contig:
        kv_spec = pl.BlockSpec((1, B, Hkv, Sc, D), lambda p, i: (i, 0, 0, 0, 0),
                               memory_space=pltpu.VMEM)
    else:
        kv_spec = pl.BlockSpec((1, B, Hkv, Sc, D), lambda p, i: (i // nS, 0, 0, i % nS, 0),
                               memory_space=pltpu.VMEM)
    vec = pl.BlockSpec((1, 1, H), lambda p, i: (i // nS, 0, 0), memory_space=pltpu.VMEM)
    fn = pl.pallas_call(
        jdp._shaped_kernel, grid=(P, L * nS),
        in_specs=[pl.BlockSpec((1, Wr, H), lambda p, i: (i // nS, 0, 0),
                               memory_space=pltpu.VMEM), kv_spec, kv_spec, vec, vec],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((128,), jnp.float32),
        scratch_shapes=[pltpu.VMEM((128,), jnp.float32)],
        interpret=jdp.INTERPRET, compiler_params=_params())
    args = [jnp.asarray(w), jnp.asarray(k.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(v.float().numpy()).astype(jnp.bfloat16), jnp.asarray(s1),
            jnp.asarray(s2)]
    return np.asarray(fn(*args))


def shaped_arrays(seed, L, B, Hkv, Sc, S_buf, D, Wr, H, contig):
    """numpy int8 w, bf16 torch k/v, f32 s1/s2 from a numpy seed."""
    r = np.random.default_rng(seed)
    nS = S_buf // Sc
    kv_shape = (L * nS, B, Hkv, Sc, D) if contig else (L, B, Hkv, S_buf, D)
    w = r.integers(-128, 128, size=(L, Wr, H), dtype=np.int8)
    k, v = (torch.from_numpy(r.normal(size=kv_shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    s1, s2 = (r.normal(size=(L, 1, H)).astype(np.float32) for _ in range(2))
    return w, k, v, s1, s2


@pytest.mark.parametrize("P,block_rows,n", [(1, 8, 3), (3, 8, 5), (3, 13, 2)])
def test_stream_twin_matches_jax_kernel(jdp, P, block_rows, n):
    x = np.random.default_rng(P * 100 + block_rows).integers(
        -128, 128, size=(n * block_rows, 1024), dtype=np.int8)
    got = tdp.stream_sum(torch.from_numpy(x), P)
    assert got.dtype == torch.float32 and got.shape == (1024,)
    np.testing.assert_array_equal(got.numpy(), jax_stream(jdp, x, block_rows, P))


@pytest.mark.parametrize("contig", [False, True])
@pytest.mark.parametrize("P", [1, 3])
def test_shaped_twin_matches_jax_kernel(jdp, P, contig):
    w, k, v, s1, s2 = shaped_arrays(7 + P, **TINY, contig=contig)
    nS = TINY["S_buf"] // TINY["Sc"]
    out, side = tdp.shaped_sum(torch.from_numpy(w), k, v, torch.from_numpy(s1),
                               torch.from_numpy(s2), P, nS, contig)
    want = jax_shaped(jdp, w, k, v, s1, s2, P, **TINY, contig=contig)
    # f32 accumulation in the JAX kernel: each step adds an f32 partial of up
    # to ~|w column sum| * nS * L * P, rounded at 2^-24 relative; 1e-6 of the
    # largest output covers that sequence of roundings many times over.
    np.testing.assert_allclose(out.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    # the sideband: passes x every weight block's column sums over all H
    np.testing.assert_array_equal(side.numpy(),
                                  (P * w.astype(np.int64).sum(axis=1)).astype(np.float32))


def test_stream_twin_partial_sums_exact(monkeypatch):
    """The twin's int64 sum over row parts equals numpy's, ragged last part."""
    monkeypatch.setattr(tdp, "_PART_ROWS", 7)
    x = np.random.default_rng(3).integers(-128, 128, size=(45, 1024), dtype=np.int8)
    got = tdp.stream_sum_ref(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(),
                                  (4 * x.astype(np.int64).sum(0)).astype(np.float32))


def test_wrappers_on_cpu_run_the_twins():
    x = torch.from_numpy(np.random.default_rng(4).integers(-128, 128, size=(24, 1024),
                                                           dtype=np.int8))
    w, k, v, s1, s2 = shaped_arrays(5, **TINY, contig=False)
    w, s1, s2 = (torch.from_numpy(a) for a in (w, s1, s2))
    before = (tdp.stream_sum.launches, tdp.shaped_sum.launches)
    assert torch.equal(tdp.stream_sum(x, 2, block_rows=5), tdp.stream_sum_ref(x, 2))
    for a, b in zip(tdp.shaped_sum(w, k, v, s1, s2, 2, 2),
                    tdp.shaped_sum_ref(w, k, v, s1, s2, 2, 2)):
        assert torch.equal(a, b)
    assert (tdp.stream_sum.launches, tdp.shaped_sum.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        tdp.stream_sum(x.to("meta"), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tdp.shaped_sum(w.to("meta"), k, v, s1, s2, 1, 2)


def test_bytes_moved_match_the_script(jdp, monkeypatch):
    """Bytes per pass: the stream buffer's x.nbytes and the shaped `moved`
    of benchmarks/dma_peak.py, for the same knobs (each run at 1 -> 2
    passes, one repetition)."""
    for mod in (jdp, udp):
        monkeypatch.setattr(mod, "P1", 1)
        monkeypatch.setattr(mod, "P2", 2)
        monkeypatch.setattr(mod, "REPS", 1)
    total, block_mb = 40 * 1024 + 100, 0.008
    _, want = jdp.stream_bw(total, block_mb)
    rows, block_rows = udp.stream_shape(total, block_mb)
    assert (rows, block_rows) == (40, 8)
    assert udp.stream_bw(total, block_mb, device="cpu")[1] == want == rows * 1024
    for contig in (False, True):
        _, moved = jdp.shaped_bw(**TINY, contiguous_kv=contig)
        assert udp.shaped_bw(**TINY, contiguous_kv=contig, device="cpu")[1] == moved


def test_slope_bw_arithmetic(jdp, monkeypatch):
    """GB/s = (P2 - P1) x bytes / (t(P2) - t(P1)): the constant cancels; the
    script's `_slope_bw` gives the same number from the same times."""
    def fake_time(fn, device=None):
        return 1e-3 + fn * 4e-3          # build(P) returns P: 4 ms a pass

    got = udp._slope_bw(lambda P: P, 8e9, time_fn=fake_time)
    assert got == pytest.approx(8e9 / 4e-3 / 1e9)
    monkeypatch.setattr(jdp, "_time", lambda fn: fake_time(fn))
    monkeypatch.setattr(jdp, "P1", udp.P1)
    monkeypatch.setattr(jdp, "P2", udp.P2)
    assert jdp._slope_bw(lambda P: P, 8e9) == pytest.approx(got)
