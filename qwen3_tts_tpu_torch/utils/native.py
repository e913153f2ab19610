"""Build-on-first-use loader for the port's native (C) helpers (counterpart
of `qwen3_tts_tpu/utils/native.py`).

Compiles `qwen3_tts_tpu_torch/native/<name>.c` with the system C compiler
into a content-addressed shared object under the checkout's build/native/
and binds it through ctypes: no build step at install time, and a
pure-Python fallback always exists (callers treat `load_library() is None`
as "fall back").
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_CACHE: dict = {}


def _compiler() -> Optional[str]:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if not cand:
            continue
        try:
            subprocess.run([cand, "--version"], capture_output=True, timeout=30)
            return cand
        except (OSError, subprocess.TimeoutExpired):
            continue
    return None


def library_path(name: str) -> Path:
    """Where native/<name>.c is built: keyed by a hash of the source."""
    digest = hashlib.sha256((NATIVE_DIR / f"{name}.c").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load native/<name>.c. Returns None when no
    compiler is available or compilation fails — callers must fall back."""
    if name in _CACHE:
        return _CACHE[name]
    lib = None
    try:
        so = library_path(name)
        if not so.exists():
            cc = _compiler()
            if cc is None:
                _CACHE[name] = None
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(so.name + f".tmp{os.getpid()}")
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                            str(NATIVE_DIR / f"{name}.c")],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic for concurrent builders
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError):
        lib = None
    _CACHE[name] = lib
    return lib


def flac_fast() -> Optional[ctypes.CDLL]:
    """The FLAC bitstream hot loops (native/flac_fast.c), with argtypes
    bound. None -> use the Python path."""
    lib = load_library("flac_fast")
    if lib is None:
        return None
    if not getattr(lib, "_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        szp = ctypes.POINTER(ctypes.c_size_t)
        lib.flac_rice_decode.argtypes = [u8p, ctypes.c_size_t, szp,
                                         ctypes.c_int64, ctypes.c_int32, i64p]
        lib.flac_rice_decode.restype = ctypes.c_int
        lib.flac_lpc_restore.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, i32p,
                                         ctypes.c_int32]
        lib.flac_lpc_restore.restype = None
        lib.flac_read_signed.argtypes = [u8p, ctypes.c_size_t, szp,
                                         ctypes.c_int64, ctypes.c_int32, i64p]
        lib.flac_read_signed.restype = ctypes.c_int
        lib._bound = True
    return lib
