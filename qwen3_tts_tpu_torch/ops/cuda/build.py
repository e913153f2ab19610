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

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("common.cuh", "subtalker.cu", "talker_step.cu", "prefill_attention.cu",
           "dma_peak.cu")
# widest logits row the sub-talker's sampling keeps in shared memory
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


class EngineScratch(ctypes.Structure):
    """Mirror of `EngineScratch` in csrc/common.cuh."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "qkv", "o", "prod", "part_ml", "part_acc", "bar", "cnt", "amax", "xq_g", "xs_g")]


class KVPtrs(ctypes.Structure):
    """Mirror of `KVPtrs` in csrc/common.cuh (ks NULL: a bf16 cache)."""
    _fields_ = [(n, ctypes.c_void_p) for n in ("kc", "vc", "ks", "vs")]


class TalkerStepArgs(ctypes.Structure):
    """Mirror of `TalkerStepArgs` in csrc/talker_step.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "H", "heads", "kvh", "D", "inter", "nseg", "L", "S_buf", "S_att",
        "window", "ld_valid", "kv_splits", "kv_cps", "cache_rows")]
        + [("eps", ctypes.c_float), ("scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("embed", "cosr", "sinr", "ci", "valid")]
        + [("w", LayerWeights), ("fnw", ctypes.c_void_p), ("kv", KVPtrs),
           ("t", EngineScratch), ("zero_bytes", ctypes.c_longlong),
           ("x", ctypes.c_void_p), ("h", ctypes.c_void_p)])


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
        + [("t", EngineScratch), ("zero_bytes", ctypes.c_longlong),
           ("part_off", ctypes.c_longlong)]
        + [(n, ctypes.c_void_p) for n in (
            "x", "xraw", "logits", "codes", "emb_sum")])


class GemmProbeArgs(ctypes.Structure):
    """Mirror of `GemmProbeArgs` in csrc/talker_step.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "N", "K", "ldx", "ldw", "paired")]
                + [(n, ctypes.c_void_p) for n in ("x", "wq", "ws", "out", "bar", "xq_g",
                                                  "xs_g")])


class BarrierProbeArgs(ctypes.Structure):
    """Mirror of `BarrierProbeArgs` in csrc/talker_step.cu."""
    _fields_ = [("n", ctypes.c_int), ("bar", ctypes.c_void_p)]


class FlashPrefillArgs(ctypes.Structure):
    """Mirror of `FlashPrefillArgs` in csrc/prefill_attention.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "T", "Hq", "Hkv", "D", "window", "grid")]
                + [("scale", ctypes.c_float)]
                + [(n, ctypes.c_longlong) for n in (
                    "sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh")]
                + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "out", "items", "item_off")])


class FlashProbeArgs(ctypes.Structure):
    """Mirror of `FlashProbeArgs` in csrc/prefill_attention.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in ("B", "T", "Hq", "Hkv", "b", "hq", "q_lo", "k0")]
                + [(n, ctypes.c_longlong) for n in (
                    "sqb", "sqt", "sqh", "skb", "skt", "skh", "svb", "svt", "svh")]
                + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "s", "o")])


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
    lib.qt_flash_probe.argtypes = [ctypes.POINTER(FlashProbeArgs), ctypes.c_void_p]
    lib.qt_flash_probe.restype = ctypes.c_int
    lib.qt_talker_step.argtypes = [ctypes.POINTER(TalkerStepArgs), ctypes.c_void_p]
    lib.qt_talker_step.restype = ctypes.c_int
    lib.qt_kv_store_rows.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.qt_kv_store_rows.restype = ctypes.c_int
    lib.qt_subtalker_frame.argtypes = [ctypes.POINTER(SubtalkerArgs), ctypes.c_void_p]
    lib.qt_subtalker_frame.restype = ctypes.c_int
    for fn, args in ((lib.qt_talker_step_geometry, TalkerStepArgs),
                     (lib.qt_subtalker_frame_geometry, SubtalkerArgs)):
        fn.argtypes = [ctypes.POINTER(args), ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    lib.qt_gemm_probe.argtypes = [ctypes.POINTER(GemmProbeArgs), ctypes.c_void_p]
    lib.qt_gemm_probe.restype = ctypes.c_int
    lib.qt_barrier_probe.argtypes = [ctypes.POINTER(BarrierProbeArgs), ctypes.c_void_p]
    lib.qt_barrier_probe.restype = ctypes.c_int
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


def launch_geometry(fn, args) -> tuple:
    """(grid blocks, bytes of dynamic shared memory) of the cooperative
    launch a decode kernel makes for `args`; fn is the library's
    `qt_*_geometry` of that kernel."""
    grid, smem = ctypes.c_int(), ctypes.c_int()
    check(load_library(), fn(args, ctypes.byref(grid), ctypes.byref(smem)),
          "launch geometry")
    return grid.value, smem.value


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


_CONVERTED: "OrderedDict[tuple, tuple]" = OrderedDict()
_STATE: "OrderedDict[tuple, LaunchState]" = OrderedDict()
MAX_CACHED = 256   # entries either cache keeps (the least recently used go first)
# (device index or None, list) collecting the LaunchStates used inside a
# graph capture (`pinning`)
_PINNING: list = []


def converted(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t` as a contiguous `dtype` tensor for a kernel. A weight that needs a
    copy (a bf16 norm weight read as f32) is converted once and kept while
    the source tensor lives and is not written to."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    key = (id(t), dtype)
    hit = _CONVERTED.get(key)
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    out = t.to(dtype).contiguous()
    _CONVERTED[key] = (weakref.ref(t), t._version, out)
    while len(_CONVERTED) > MAX_CACHED:
        _CONVERTED.popitem(last=False)
    return out


class LaunchState:
    """What a decode wrapper keeps between calls of one (device, stream,
    shape, weights): the scratch tensors, the argument struct with every
    pointer that does not change, and what `make` added. Scratch is never
    shared across streams: the stream is part of the key. A captured CUDA
    graph bakes the scratch pointers into its nodes, so each graph holds
    the states it captured and counts itself in `pins`; the cache never
    evicts a pinned state."""

    def __init__(self, weights):
        self.refs = [(weakref.ref(t), t._version) for t in weights]
        self.pins = 0

    def holds(self, weights) -> bool:
        return (len(self.refs) == len(weights)
                and all(r() is t and v == t._version for (r, v), t in zip(self.refs, weights)))


def launch_state(key: tuple, weights, make) -> LaunchState:
    """The cached `LaunchState` for `key` (which names the wrapper, the
    device, the stream and the shape), built by `make(state)` at first use or
    when one of the `weights` tensors is another object or was written to."""
    key = key + tuple(id(t) for t in weights)
    state = _STATE.get(key)
    if state is None or not state.holds(weights):
        state = LaunchState(weights)
        make(state)
        _STATE[key] = state
        while len(_STATE) > MAX_CACHED:
            victim = next((k for k, s in _STATE.items() if not s.pins), None)
            if victim is None:
                break
            del _STATE[victim]
    else:
        _STATE.move_to_end(key)
    for device, got in _PINNING:
        if device is None or key[1] == device:
            got.append(state)
    return state


@contextlib.contextmanager
def pinning(device: Optional[int] = None):
    """Collect, in a list, every `LaunchState` a wrapper uses inside the
    block (a graph capture), for `pin`; with `device`, only the states of
    that CUDA device index (the second item of a state's key), so that a
    capture on one card pins nothing of another."""
    got: list = []
    entry = (device, got)
    _PINNING.append(entry)
    try:
        yield got
    finally:
        _PINNING[:] = [e for e in _PINNING if e is not entry]


def pin(states) -> "callable":
    """Count a graph in each of `states` (so the cache keeps them) and
    return the function that takes the count back when the graph goes."""
    uniq = list({id(s): s for s in states}.values())
    for s in uniq:
        s.pins += 1

    def unpin():
        for s in uniq:
            s.pins -= 1
    return unpin


def layer_weight_tensors(layers) -> dict:
    """name -> tensor of `LayerWeights`' fields, from a stacked layer tree."""
    attn, mlp = layers["self_attn"], layers["mlp"]
    return {
        "qkv_q": attn["qkv_proj"]["weight"]["q"], "qkv_s": attn["qkv_proj"]["weight"]["s"],
        "o_q": attn["o_proj"]["weight"]["q"], "o_s": attn["o_proj"]["weight"]["s"],
        "gu_q": mlp["gate_up_proj"]["weight"]["q"], "gu_s": mlp["gate_up_proj"]["weight"]["s"],
        "dn_q": mlp["down_proj"]["weight"]["q"], "dn_s": mlp["down_proj"]["weight"]["s"],
        "ln1": layers["input_layernorm"]["weight"],
        "ln2": layers["post_attention_layernorm"]["weight"],
        "qn": attn["q_norm"]["weight"], "kn": attn["k_norm"]["weight"],
    }


def int8_layer_weights(ts: dict, device) -> tuple:
    """(LayerWeights struct, tensors kept alive) for `layer_weight_tensors`
    on `device`. Norm weights and scales go to f32 (the kernels read f32;
    bf16 -> f32 is exact)."""
    same_device(device, **ts)
    out = {}
    for name, t in ts.items():
        if name.endswith("_q"):
            require(t.dtype == torch.int8 and t.is_contiguous(),
                    f"{name}: want a contiguous int8 tensor")
            out[name] = t
        else:
            out[name] = converted(t, torch.float32)
    return LayerWeights(**{k: ptr(v) for k, v in out.items()}), out


# most window splits of the talker step's attention (sizes its partials)
KV_SPLITS_MAX = 16
ENGINE_MAX_ROWS = 32   # ENG_MAX_ROWS in csrc/common.cuh


def engine_scratch(B: int, H: int, heads: int, kvh: int, D: int, inter: int, nseg: int,
                   instances: int, device) -> tuple:
    """(EngineScratch struct, bytes of its zeroed region, tensors kept alive)
    for launches of `instances` layer runs (layers, times positions) over B
    rows. The barrier words, the attention's arrival counts and the
    product's maxima are one int32 tensor, which the launch zeroes on its
    stream."""
    def empty(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    G = heads // kvh
    items = B * kvh * KV_SPLITS_MAX
    n_bar = 4   # the grid barrier's two words, padded to 16 bytes
    n_cnt = -(-B * kvh // 4) * 4
    zeroed = torch.zeros((n_bar + n_cnt + instances * B * nseg,), dtype=torch.int32,
                         device=device)
    ts = {
        "qkv": empty(B, (heads + 2 * kvh) * D, dtype=torch.float32),
        "o": empty(B, heads * D, dtype=torch.bfloat16),
        "prod": empty(B, inter, dtype=torch.bfloat16),
        "part_ml": empty(items, G, 2, dtype=torch.float32),
        "part_acc": empty(items, G, D, dtype=torch.float32),
        "bar": zeroed, "cnt": zeroed[n_bar:], "amax": zeroed[n_bar + n_cnt:],
        "xq_g": empty(B, max(H, heads * D, inter), dtype=torch.int8),
        "xs_g": empty(B, nseg, dtype=torch.float32),
    }
    return (EngineScratch(**{k: ptr(v) for k, v in ts.items()}),
            zeroed.numel() * zeroed.element_size(), ts)


def sm_count(device) -> int:
    """Streaming multiprocessors of `device`: the blocks of an engine launch."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def row_tiles(B: int, max_rows: int = ENGINE_MAX_ROWS) -> list:
    """Row slices of equal size covering B rows: ceil(B / max_rows) tiles
    of ceil(B / tiles) rows (48 -> 2 x 24, 64 -> 2 x 32). Where the tiles do
    not divide B the last one ends at row B and repeats a few rows of the
    one before, which compute the same values again (rows are independent
    in both decode kernels). Equal tiles let one `launch_state`, keyed by
    the tile's rows, serve every tile."""
    n = -(-B // max_rows)
    t = -(-B // n)
    return [slice(min(i * t, B - t), min(i * t, B - t) + t) for i in range(n)]


def layer_misfit(B: int, H: int, heads: int, kvh: int, D: int, inter: int,
                 nseg: int) -> Optional[str]:
    """The first rule of what one launch of the layer engine accepts
    (csrc/common.cuh) that these shapes break, or None: at most 32 rows (the
    wrappers run larger batches as `row_tiles`), a head_dim of 64 or 128,
    at most 2 query heads per kv head, every GEMM's K in whole 256-column
    warp loads (at most 16 of them) and its N in whole 8-row units."""
    if not 1 <= B <= ENGINE_MAX_ROWS:
        return f"batch {B}: the engine takes 1..{ENGINE_MAX_ROWS} rows"
    if D not in (64, 128):
        return f"head_dim {D} must be 64 or 128"
    if heads % kvh or heads // kvh > 2:
        return (f"{heads} query heads over {kvh} kv heads: the attention is built for "
                "groups of at most 2 (ATT_MAX_G in csrc/common.cuh)")
    if inter % nseg:
        return f"{nseg} chunks do not divide {inter}"
    for name, v in (("hidden", H), ("heads*head_dim", heads * D),
                    ("intermediate/chunks", inter // nseg)):
        if v % 256 or v > 4096:
            return f"{name} = {v} must be a multiple of 256, at most 4096"
    if inter % 8:
        return f"intermediate {inter} must be a multiple of 8"
    return None


def check_layer_shapes(B: int, H: int, heads: int, kvh: int, D: int, inter: int,
                       nseg: int) -> None:
    """Raise ValueError with `layer_misfit`'s rule where the shapes break one."""
    misfit = layer_misfit(B, H, heads, kvh, D, inter, nseg)
    require(misfit is None, misfit)
