"""Checkpoint I/O and weight transforms of the port against the JAX package
(bit-exact: these are data movement and one IEEE division per element)."""

import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu import weights as jw
from qwen3_tts_tpu.config import CodePredictorConfig, TalkerConfig
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu_torch import weights as tw
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = TalkerConfig(
    vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
    text_hidden_size=32, text_vocab_size=40, num_code_groups=3,
    code_predictor_config=CodePredictorConfig(
        vocab_size=16, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        num_code_groups=3))


def _as_bits(x):
    """Leaf -> numpy array comparable bit for bit (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_trees_equal(t_tree, j_tree, path=""):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree), path
        for k in j_tree:
            _assert_trees_equal(t_tree[k], j_tree[k], f"{path}.{k}")
        return
    if j_tree is None:
        assert t_tree is None, path
        return
    np.testing.assert_array_equal(_as_bits(t_tree), _as_bits(j_tree), err_msg=path)


def test_safetensors_reader_matches_reference(tmp_path):
    from safetensors.numpy import load_file, save_file

    r = np.random.default_rng(0)
    data = {
        "a.f32": r.normal(size=(3, 4)).astype(np.float32),
        "a.f16": r.normal(size=(5,)).astype(np.float16),
        "b.bf16": r.normal(size=(2, 3, 2)).astype(ml_dtypes.bfloat16),
        "c.i64": r.integers(-9, 9, size=(4,)).astype(np.int64),
        "c.i8": r.integers(-127, 127, size=(2, 8)).astype(np.int8),
        "d.bool": r.random((3,)) < 0.5,
        "e.scalar": np.asarray(2.5, np.float32),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(data, path)
    want = load_file(path)
    got = tw.read_safetensors(path)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_as_bits(got[k]), _as_bits(want[k]), err_msg=k)
    assert got["b.bf16"].dtype == torch.bfloat16


@pytest.mark.parametrize("quantize", [False, True])
def test_from_jax_tree_round_trip(quantize):
    params = random_talker_params(TINY, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    if quantize:
        params = jw.quantize_talker_params(params)
    got = tw.from_jax_tree(params)
    _assert_trees_equal(got, params)
    if quantize:
        q = got["layers"]["self_attn"]["qkv_proj"]["weight"]
        assert q["q"].dtype == torch.int8 and q["s"].dtype == torch.float32
    assert got["code_predictor"]["proj"] is not None  # 16 != 32: projection kept


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_weight_int8_bit_equal(dtype):
    r = np.random.default_rng(1)
    w = (r.normal(0, 0.05, (3, 24, 40)) * r.uniform(0.1, 3, (3, 24, 1))).astype(dtype)
    w[0, 0] = 0.0   # all-zero row: the 1e-12 scale floor
    want = jw.quantize_weight_int8(jnp.asarray(w))
    got = tw.quantize_weight_int8(tw.from_jax_tree(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


def test_checkpoint_load_and_prepare_match(tmp_path):
    """The same safetensors file through both packages' loaders and
    prepare_talker_params gives the same tree."""
    from qwen3_tts_tpu.models.talker import prepare_talker_params as j_prepare
    from qwen3_tts_tpu_torch.models.talker import prepare_talker_params as t_prepare

    params = random_talker_params(TINY, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    sd = jw.talker_params_to_state_dict(params, TINY)
    jw.save_safetensors(str(tmp_path / "model.safetensors"), sd)
    j_tree = jw.load_safetensors_dir(str(tmp_path))
    t_tree = tw.load_safetensors_dir(str(tmp_path))
    _assert_trees_equal(t_prepare(t_tree["talker"], TINY),
                        j_prepare(j_tree["talker"], TINY))


def test_matmul_t_int8_and_plain():
    r = np.random.default_rng(2)
    x = r.normal(size=(3, 40)).astype(np.float32)
    w = r.normal(size=(24, 40)).astype(np.float32)
    jq = jw.quantize_weight_int8(jnp.asarray(w))
    tq = tw.quantize_weight_int8(torch.tensor(w))
    for jwt, twt in ((jnp.asarray(w), torch.tensor(w)), (jq, tq)):
        np.testing.assert_allclose(tw.matmul_t(torch.tensor(x), twt).numpy(),
                                   np.asarray(jw.matmul_t(jnp.asarray(x), jwt)),
                                   rtol=1e-5, atol=1e-5)


def test_port_imports_no_jax():
    """Importing every module of the port, chip_smoke and chip_profile, in a fresh
    interpreter leaves jax and every module of the JAX package out of
    sys.modules (the port must run where neither is installed)."""
    code = ("import importlib, pkgutil, sys; import qwen3_tts_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "[importlib.import_module(m) for m in mods + ['chip_smoke', 'chip_profile']]; "
            "assert 'qwen3_tts_tpu_torch.ops.cuda.prefill_attention' in mods, mods; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'qwen3_tts_tpu' or m.startswith('qwen3_tts_tpu.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
