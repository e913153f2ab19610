"""The port's CAM++ x-vector against the JAX package: the network on the
same weights (the port's numpy fabricator `campplus_state`, non-trivial
batch-norm statistics), the ONNX initializer reader on hand-encoded models
(the encoders of tests/test_campplus.py), the loader's two formats and its
refusal of a file it cannot parse (no onnxruntime route), the kaldi fbank
copy, and `XVectorExtractor.extract_code` end to end.

Tolerances (fp32 on the CPU): embeddings relative L2 1e-5; the reference
mel atol 1e-4; fbank and the reader exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.models.codec25 import campplus as jcam
from qwen3_tts_tpu.models.codec25.model import XVectorExtractor as JXVec
from qwen3_tts_tpu.utils import kaldi as jkaldi
from qwen3_tts_tpu.utils.onnx_weights import read_onnx_initializers as j_read_onnx
from qwen3_tts_tpu_torch.models.codec25 import campplus as tcam
from qwen3_tts_tpu_torch.models.codec25.model import XVectorExtractor as TXVec
from qwen3_tts_tpu_torch.utils import kaldi as tkaldi
from qwen3_tts_tpu_torch.utils.onnx_weights import read_onnx_initializers as t_read_onnx
from qwen3_tts_tpu_torch.utils.onnx_weights import write_onnx_initializers
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, campplus_state
from qwen3_tts_tpu_torch.weights import save_safetensors
from tests.test_campplus import TINY, _encode_model

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

TINY_KW = dict(feat_dim=TINY["feat_dim"], embedding_size=TINY["embedding_size"],
               growth_rate=TINY["growth_rate"], bn_size=TINY["bn_size"],
               init_channels=TINY["init_channels"], m_channels=TINY["m_channels"],
               num_blocks=TINY["num_blocks"], kernels=(3,) * len(TINY["num_blocks"]),
               dilations=TINY["dilations"], seg_len=100)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("T", [37, 120, 200])
def test_campplus_forward_matches_jax(T):
    """Segment pooling over one, two and a partial second segment of 100."""
    tcfg, jcfg = tcam.CAMPPlusConfig(**TINY_KW), jcam.CAMPPlusConfig(**TINY_KW)
    flat = campplus_state(tcfg, seed=1)
    feats = np.random.default_rng(T).normal(0, 1, (2, T, tcfg.feat_dim)).astype(np.float32)
    want = np.asarray(jcam.campplus_forward({k: jnp.asarray(v) for k, v in flat.items()},
                                            jcfg, jnp.asarray(feats)))
    got = tcam.campplus_embed({k: torch.from_numpy(v) for k, v in flat.items()}, tcfg,
                              torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, tcfg.embedding_size)
    assert rel_l2(got, want) < 1e-5


def test_campplus_state_has_every_key_jax_reads():
    """The fabricator's names are the JAX network's: a missing key would
    raise there; a key nothing reads would be a fabricator typo."""
    tcfg = tcam.CAMPPlusConfig(**TINY_KW)
    flat = campplus_state(tcfg, seed=0)
    read = set()

    class Probe(dict):
        def __getitem__(self, k):
            read.add(k)
            return super().__getitem__(k)

        def get(self, k, d=None):
            if k in self:
                read.add(k)
            return super().get(k, d)

    jcam.campplus_forward(Probe({k: jnp.asarray(v) for k, v in flat.items()}),
                          jcam.CAMPPlusConfig(**TINY_KW),
                          jnp.zeros((1, 40, tcfg.feat_dim), jnp.float32))
    assert read == set(flat)
    assert any(k.endswith("running_var") and not np.allclose(v, 1) for k, v in flat.items())


@pytest.mark.parametrize("use_raw", [True, False])
def test_onnx_reader_matches_jax(tmp_path, use_raw):
    tensors = {k: v for k, v in list(campplus_state(tcam.CAMPPlusConfig(**TINY_KW),
                                                    seed=2).items())[:12]}
    path = str(tmp_path / "m.onnx")
    with open(path, "wb") as f:
        f.write(_encode_model(tensors, use_raw))
    got, want = t_read_onnx(path), j_read_onnx(path)
    assert set(got) == set(want) == set(tensors)
    for k in tensors:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], tensors[k])


def test_onnx_writer_reads_back_in_both_packages(tmp_path):
    """The port's initializer writer (the smoke's campplus.onnx): float32
    and int64 tensors, a one-element one, read back exactly by both
    readers."""
    rng = np.random.default_rng(3)
    tensors = {"xvector.tdnn.linear.weight": rng.normal(size=(8, 4, 5)).astype(np.float32),
               "head.bn1.num_batches_tracked": np.asarray([-7], np.int64),
               "ids": np.arange(-3, 4, dtype=np.int64)}
    path = str(tmp_path / "w.onnx")
    write_onnx_initializers(path, tensors)
    for read in (t_read_onnx, j_read_onnx):
        got = read(path)
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("fmt", ["onnx", "safetensors"])
def test_load_campplus_params_formats(tmp_path, fmt):
    flat = campplus_state(tcam.CAMPPlusConfig(**TINY_KW), seed=3)
    path = str(tmp_path / f"campplus.{fmt}")
    if fmt == "onnx":
        with open(path, "wb") as f:
            f.write(_encode_model(flat))
    else:
        save_safetensors(path, flat)
    params = tcam.load_campplus_params(path)
    assert set(params) == set(flat)
    for k, v in flat.items():
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), v)


def test_load_campplus_params_refuses_unparsed_file(tmp_path):
    """A file without the CAM++ initializers raises with the reader's
    message; nothing falls back to another runtime."""
    path = str(tmp_path / "other.onnx")
    with open(path, "wb") as f:
        f.write(_encode_model({"renamed.weight": np.ones((2, 2), np.float32)}))
    with pytest.raises(ValueError, match="no CAM\\+\\+"):
        tcam.load_campplus_params(path)
    with pytest.raises(ValueError, match="no CAM\\+\\+"):
        TXVec(path)


def test_kaldi_fbank_copy_matches_jax():
    wav = np.random.default_rng(4).uniform(-0.5, 0.5, (16000,)).astype(np.float32)
    np.testing.assert_array_equal(tkaldi.fbank(wav), jkaldi.fbank(wav))


def test_extract_code_matches_jax(tmp_path):
    """A full-width campplus.onnx (both extractors run CAMPPlusConfig()):
    peak normalisation, the reference mel, the host fbank, CAM++ and the
    unit-norm x-vector."""
    path = str(tmp_path / "campplus.onnx")
    with open(path, "wb") as f:
        f.write(_encode_model(campplus_state(tcam.CAMPPlusConfig(), seed=5)))
    audio = np.random.default_rng(6).uniform(-0.3, 0.3, (24000,)).astype(np.float32)
    jx, jm = JXVec(path).extract_code(audio)
    tx, tm = TXVec(path, device="cpu").extract_code(audio)
    assert tx.shape == (192,) and abs(np.linalg.norm(tx) - 1) < 1e-5
    assert rel_l2(tx, jx) < 1e-5
    assert tm.shape == jm.shape and tm.shape[1] == 80
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    with pytest.raises(RuntimeError, match="CAM"):
        TXVec(None).extract_code(audio)
