"""Build and load the hand-written Hopper kernels (`qwen3_tts_tpu_torch/csrc`).

The sources have a plain C interface and are compiled with nvcc into one
shared library, loaded with ctypes: no PyTorch headers, so a build takes
seconds. Each `.cu` compiles in its own nvcc process, all started together,
and one more nvcc links the objects. The build happens at first use, into
`build/kernels/` at the root of the checkout, keyed by a hash of the sources
and flags, so a fresh checkout builds everything on its first call and
later calls reuse it.

Every entry point takes a pointer to an argument struct and a CUDA stream
and returns `cudaGetLastError()` after its launches; `check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("common.cuh", "subtalker.cu", "talker_step.cu", "prefill_attention.cu",
           "dma_peak.cu")
# widest row a kernel keeps in shared memory (48 KB of floats, the default
# dynamic limit: k_row_norm's rows, k_sample's logits)
MAX_SMEM_ROW = 12288
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libqwen3_tts_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [s for s in SOURCES if s.endswith(".cu")]
        objs = [os.path.join(tmp, s[:-3] + ".o") for s in cus]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(cus, objs)]
        errors = []
        for p in procs:
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{' '.join(p.args)} ({p.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)
    return out


class LayerWeights(ctypes.Structure):
    """Mirror of `LayerWeights` in csrc/common.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "qkv_q", "o_q", "gu_q", "dn_q", "qkv_s", "o_s", "gu_s", "dn_s",
        "ln1", "ln2", "qn", "kn")]


class LayerScratch(ctypes.Structure):
    """Mirror of `LayerScratch` in csrc/common.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("xq", "xs", "qkv", "q", "o", "gu")]


class KVPtrs(ctypes.Structure):
    """Mirror of `KVPtrs` in csrc/common.cuh (ks NULL: a bf16 cache)."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("kc", "vc", "ks", "vs", "knew", "vnew")]


class TalkerStepArgs(ctypes.Structure):
    """Mirror of `TalkerStepArgs` in csrc/talker_step.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "H", "heads", "kvh", "D", "inter", "nseg", "L", "S_buf", "S_att",
        "window", "ld_valid")]
        + [("eps", ctypes.c_float), ("scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("embed", "cosr", "sinr", "ci", "valid")]
        + [("w", LayerWeights), ("fnw", ctypes.c_void_p), ("kv", KVPtrs),
           ("t", LayerScratch), ("x", ctypes.c_void_p), ("h", ctypes.c_void_p)])


class SubtalkerArgs(ctypes.Structure):
    """Mirror of `SubtalkerArgs` in csrc/subtalker.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "Ht", "Hc", "heads", "kvh", "D", "inter", "V", "Qm1", "L",
        "has_proj", "do_sample")]
        + [("eps", ctypes.c_float), ("scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in (
            "x0", "cosr", "sinr", "gumbel", "temp", "topk", "projw", "projb")]
        + [("w", LayerWeights)]
        + [(n, ctypes.c_void_p) for n in ("fnw", "lm_heads", "embeds", "kc", "vc")]
        + [("t", LayerScratch)]
        + [(n, ctypes.c_void_p) for n in (
            "x", "xraw", "hn", "logits", "codes", "emb_sum")])


class FlashPrefillArgs(ctypes.Structure):
    """Mirror of `FlashPrefillArgs` in csrc/prefill_attention.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "T", "Hq", "Hkv", "D", "window")]
                + [("scale", ctypes.c_float)]
                + [(n, ctypes.c_longlong) for n in (
                    "sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh")]
                + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "start", "out")])


class StreamArgs(ctypes.Structure):
    """Mirror of `StreamArgs` in csrc/dma_peak.cu."""
    _fields_ = ([(n, ctypes.c_longlong) for n in ("rows", "block_rows")]
                + [(n, ctypes.c_int) for n in ("passes", "grid")]
                + [(n, ctypes.c_void_p) for n in ("x", "acc", "out")])


class ShapedArgs(ctypes.Structure):
    """Mirror of `ShapedArgs` in csrc/dma_peak.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "L", "Wr", "H", "BH", "Hkv", "Sc", "nS", "passes", "grid", "w_rows", "runs")]
        + [(n, ctypes.c_longlong) for n in (
            "k_sl", "k_sc", "k_sb", "k_sh", "v_sl", "v_sc", "v_sb", "v_sh")]
        + [(n, ctypes.c_void_p) for n in (
            "w", "k", "v", "s1", "s2", "colsum", "kvpart", "scpart", "out", "side")])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.qt_flash_prefill.argtypes = [ctypes.POINTER(FlashPrefillArgs), ctypes.c_void_p]
    lib.qt_flash_prefill.restype = ctypes.c_int
    lib.qt_talker_step.argtypes = [ctypes.POINTER(TalkerStepArgs), ctypes.c_void_p]
    lib.qt_talker_step.restype = ctypes.c_int
    lib.qt_kv_store_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p]
    lib.qt_kv_store_rows.restype = ctypes.c_int
    lib.qt_subtalker_frame.argtypes = [ctypes.POINTER(SubtalkerArgs), ctypes.c_void_p]
    lib.qt_subtalker_frame.restype = ctypes.c_int
    lib.qt_dma_max_grid.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.qt_dma_max_grid.restype = ctypes.c_int
    lib.qt_stream_sum.argtypes = [ctypes.POINTER(StreamArgs), ctypes.c_void_p]
    lib.qt_stream_sum.restype = ctypes.c_int
    lib.qt_shaped_sum.argtypes = [ctypes.POINTER(ShapedArgs), ctypes.c_void_p]
    lib.qt_shaped_sum.restype = ctypes.c_int
    lib.qt_error_string.argtypes = [ctypes.c_int]
    lib.qt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.qt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> int:
    """Device pointer of a tensor (None -> NULL)."""
    return 0 if t is None else t.data_ptr()


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).contiguous()


def same_device(device, **tensors) -> None:
    """Every tensor handed to a kernel must live on the launch device (a host
    pointer in a kernel is an illegal address, not an error it can report)."""
    for name, t in tensors.items():
        if t is not None:
            require(t.device == device, f"{name} is on {t.device}, want {device}")


def int8_layer_weights(layers, device) -> tuple:
    """(LayerWeights struct, tensors kept alive) for a stacked int8 layer tree
    on `device`. Norm weights go to f32 (the kernels read f32; bf16 -> f32 is
    exact)."""
    attn, mlp = layers["self_attn"], layers["mlp"]
    ts = {
        "qkv_q": attn["qkv_proj"]["weight"]["q"], "qkv_s": attn["qkv_proj"]["weight"]["s"],
        "o_q": attn["o_proj"]["weight"]["q"], "o_s": attn["o_proj"]["weight"]["s"],
        "gu_q": mlp["gate_up_proj"]["weight"]["q"], "gu_s": mlp["gate_up_proj"]["weight"]["s"],
        "dn_q": mlp["down_proj"]["weight"]["q"], "dn_s": mlp["down_proj"]["weight"]["s"],
        "ln1": layers["input_layernorm"]["weight"],
        "ln2": layers["post_attention_layernorm"]["weight"],
        "qn": attn["q_norm"]["weight"], "kn": attn["k_norm"]["weight"],
    }
    same_device(device, **ts)
    for name, t in ts.items():
        if name.endswith("_q"):
            require(t.dtype == torch.int8 and t.is_contiguous(),
                    f"{name}: want a contiguous int8 tensor")
        else:
            ts[name] = f32(t)
    return LayerWeights(**{k: ptr(v) for k, v in ts.items()}), ts


def layer_scratch(B: int, H: int, heads: int, kvh: int, D: int, inter: int,
                  nseg: int, device) -> tuple:
    """(LayerScratch struct, tensors kept alive) for one decoder layer chain."""
    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    ts = {
        "xq": empty(B, max(H, heads * D, inter), dtype=torch.int8),
        "xs": empty(B, max(1, nseg), dtype=torch.float32),
        "qkv": empty(B, (heads + 2 * kvh) * D, dtype=torch.float32),
        "q": empty(B, heads * D, dtype=torch.bfloat16),
        "o": empty(B, heads * D, dtype=torch.bfloat16),
        "gu": empty(B, 2 * inter, dtype=torch.bfloat16),
    }
    return LayerScratch(**{k: ptr(v) for k, v in ts.items()}), ts


def check_layer_shapes(H: int, heads: int, kvh: int, D: int, inter: int,
                       nseg: int) -> None:
    """What the layer chain's kernels accept (16-byte vector loads, one
    128-thread block per head, at most 8 query heads per kv head)."""
    require(D <= 128 and D % 8 == 0, f"head_dim {D} must be a multiple of 8, <= 128")
    require(heads % kvh == 0 and heads // kvh <= 8,
            f"{heads} query heads over {kvh} kv heads: groups of at most 8")
    for name, v in (("hidden", H), ("heads*head_dim", heads * D),
                    ("intermediate/chunks", inter // nseg)):
        require(v % 16 == 0, f"{name} = {v} must be a multiple of 16")
    require(inter % nseg == 0, f"{nseg} chunks do not divide {inter}")
    # the row norm keeps one row in (default, <= 48 KB) shared memory
    require(max(H, heads * D) <= MAX_SMEM_ROW,
            f"rows of {max(H, heads * D)} exceed {MAX_SMEM_ROW} floats")
