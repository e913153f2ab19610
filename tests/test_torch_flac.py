"""The port's FLAC decoder with its native fast path (`utils/flac.py`,
`utils/native.py`, `native/flac_fast.c`) against the JAX package's.

Exact throughout: the encoder writes the JAX package's bytes; the native C
loops and the pure-Python path decode the same samples; both equal the JAX
decoder's."""

import numpy as np
import pytest

from qwen3_tts_tpu.utils import flac as jflac
from qwen3_tts_tpu_torch.utils import flac as tflac
from qwen3_tts_tpu_torch.utils import native
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)


def _audio(channels, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 24000
    x = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.normal(size=n)
    if channels == 2:
        x = np.stack([x, 0.5 * np.cos(2 * np.pi * 110 * t)], axis=1)
    return np.clip(x, -1, 1).astype(np.float32)


def test_native_library_builds_into_the_checkout():
    lib = native.flac_fast()
    assert lib is not None
    path = native.library_path("flac_fast")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("mode", ["verbatim", "fixed1"])
def test_native_and_python_paths_equal_jax(tmp_path, monkeypatch, mode, channels):
    x = _audio(channels, seed=channels)
    path, jpath = str(tmp_path / "t.flac"), str(tmp_path / "j.flac")
    tflac.write_flac(path, x, 24000, mode=mode, block_size=1024)
    jflac.write_flac(jpath, x, 24000, mode=mode, block_size=1024)
    with open(path, "rb") as f, open(jpath, "rb") as g:
        payload = f.read()
        assert payload == g.read()
    assert tflac._native_lib() is not None
    fast, sr = tflac.read_flac(path)
    from_bytes, _ = tflac.read_flac(payload)
    monkeypatch.setenv("QWEN3_TTS_NO_NATIVE", "1")
    assert tflac._native_lib() is None
    slow, sr2 = tflac.read_flac(path)
    want, jsr = jflac.read_flac(path)
    assert sr == sr2 == jsr == 24000
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(from_bytes, slow)
    np.testing.assert_array_equal(slow, np.asarray(want))
    assert np.abs(slow - x).max() <= 2.0 ** -15   # lossless at 16 bits
