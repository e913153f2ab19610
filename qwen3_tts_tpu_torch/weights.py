"""Checkpoint loading and saving: safetensors <-> nested dicts of torch
tensors.

Counterpart of `qwen3_tts_tpu/weights.py`. The safetensors format is read
and written with numpy alone (8-byte little-endian header length, a JSON
header, then raw little-endian tensor bytes), so neither the `safetensors`
package nor JAX is needed; `talker_params_to_state_dict` turns a prepared
talker tree back into the reference's names (the SFT checkpoint). Parameter trees keep the torch state-dict path components
as keys, exactly as the JAX package organises them, so a prepared tree from
either package converts to the other leaf by leaf (`from_jax_tree`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "BF16": np.uint16,   # raw bits; viewed as torch.bfloat16 below
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Read one .safetensors file into CPU torch tensors (numpy parser)."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = info["dtype"]
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: unsupported safetensors dtype {dt!r}")
        start, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np.dtype(_ST_DTYPES[dt]).newbyteorder("<"),
                            count=(end - start) // np.dtype(_ST_DTYPES[dt]).itemsize,
                            offset=start).reshape(info["shape"])
        t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=True))
        out[name] = t.view(torch.bfloat16) if dt == "BF16" else t
    return out


def unflatten_state_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    """'a.b.0.weight': x  ->  {'a': {'b': {'0': {'weight': x}}}}"""
    out: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten_state_dict(nested: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{'a': {'b': x}} -> {'a.b': x} (the inverse of unflatten_state_dict)."""
    out: Dict[str, Any] = {}
    for k, v in nested.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_state_dict(v, key))
        else:
            out[key] = v
    return out


def numeric_children(d: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Return children with integer-string keys, in numeric order."""
    keys = sorted((k for k in d.keys() if k.isdigit()), key=int)
    return [d[k] for k in keys]


def stack_layers(layers: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a homogeneous list of per-layer trees along a new leading axis."""
    layers = list(layers)
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([l[k] for l in layers]) for k in first}
    return torch.stack(layers, dim=0)


def map_tensors(tree, fn):
    """Apply fn to every tensor leaf of a nested dict (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def resolve_checkpoint_dir(name_or_path: str, allow_patterns=None) -> str:
    """A local checkpoint directory as given; otherwise a Hugging Face repo
    id, fetched by `huggingface_hub.snapshot_download` (its local snapshot
    directory) where that package imports, else FileNotFoundError, as in
    the JAX package."""
    if os.path.isdir(name_or_path):
        return name_or_path
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{name_or_path} is not a local directory and huggingface_hub "
            "is unavailable to download it") from e
    return snapshot_download(name_or_path, allow_patterns=allow_patterns)


def load_safetensors_dir(model_dir: str, dtype: Optional[torch.dtype] = None,
                         key_filter: Optional[str] = None,
                         device="cpu") -> Dict[str, Any]:
    """Load all *.safetensors in a checkpoint dir into a nested tensor tree.

    Supports the sharded-index layout (`model.safetensors.index.json`) as
    well as single-file checkpoints. `key_filter` is an optional regex on
    state-dict keys; floating tensors are cast to `dtype` when given.
    """
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted({os.path.join(model_dir, v)
                        for v in index["weight_map"].values()})
    else:
        files = sorted(os.path.join(model_dir, f) for f in os.listdir(model_dir)
                       if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {model_dir}")

    pat = re.compile(key_filter) if key_filter else None
    flat: Dict[str, Any] = {}
    for path in files:
        for k, v in read_safetensors(path).items():
            if pat and not pat.search(k):
                continue
            if dtype is not None and v.is_floating_point():
                v = v.to(dtype)
            flat[k] = v.to(device)
    return unflatten_state_dict(flat)


_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items() if k != "BF16"}


def _st_array(value):
    """(safetensors dtype name, little-endian numpy array) of a numpy array or
    torch tensor; bf16 tensors travel as their uint16 bit patterns."""
    if torch.is_tensor(value):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.int16).numpy().view(np.uint16)
        value = t.numpy()
    arr = np.asarray(value)
    if arr.dtype not in _ST_NAMES:
        raise ValueError(f"unsupported dtype for safetensors: {arr.dtype}")
    return _ST_NAMES[arr.dtype], arr


def save_safetensors(path: str, state_dict: Dict[str, Any]) -> None:
    """Write a .safetensors file with numpy alone: an 8-byte little-endian
    header length, a JSON header (dtype, shape, data_offsets per tensor,
    names sorted as the `safetensors` package writes them) padded with
    spaces to a multiple of 8, then each tensor's raw little-endian bytes.
    Values are numpy arrays or torch tensors (bf16 included)."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in sorted(state_dict):
        dtype, arr = _st_array(state_dict[name])
        data = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(np.asarray([len(head)], "<u8").tobytes())
        f.write(head)
        for data in blobs:
            f.write(data)


def _unfuse_layers(stacked: Dict[str, Any], heads: int, kv_heads: int,
                   head_dim: int) -> Dict[str, Any]:
    """Split fused qkv / gate_up stacks back into reference-format weights."""
    attn = stacked["self_attn"]
    qkv = attn["qkv_proj"]["weight"]
    nq, nkv = heads * head_dim, kv_heads * head_dim
    gu = stacked["mlp"]["gate_up_proj"]["weight"]
    inter = gu.shape[-2] // 2
    return {
        "self_attn": {
            "q_proj": {"weight": qkv[..., :nq, :]},
            "k_proj": {"weight": qkv[..., nq:nq + nkv, :]},
            "v_proj": {"weight": qkv[..., nq + nkv:, :]},
            "o_proj": attn["o_proj"],
            "q_norm": attn["q_norm"],
            "k_norm": attn["k_norm"],
        },
        "mlp": {
            "gate_proj": {"weight": gu[..., :inter, :]},
            "up_proj": {"weight": gu[..., inter:, :]},
            "down_proj": stacked["mlp"]["down_proj"],
        },
        "input_layernorm": stacked["input_layernorm"],
        "post_attention_layernorm": stacked["post_attention_layernorm"],
    }


def talker_params_to_state_dict(prepared: Dict[str, Any], cfg,
                                prefix: str = "talker") -> Dict[str, torch.Tensor]:
    """Invert `prepare_talker_params`: the stacked tree (unquantized) ->
    reference-format state-dict names, as detached CPU tensors (for saving
    a checkpoint after finetuning)."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, t):
        out[name] = t.detach().cpu()

    def unstack(tree: Dict[str, Any], base: str):
        for k, v in flatten_state_dict(tree).items():
            for i in range(v.shape[0]):
                put(f"{base}.{i}.{k}", v[i])

    cp_cfg = cfg.code_predictor_config
    unstack(_unfuse_layers(prepared["layers"], cfg.num_attention_heads,
                           cfg.num_key_value_heads, cfg.resolved_head_dim),
            f"{prefix}.model.layers")
    put(f"{prefix}.model.norm.weight", prepared["norm"]["weight"])
    put(f"{prefix}.model.codec_embedding.weight", prepared["codec_embedding"])
    put(f"{prefix}.model.text_embedding.weight", prepared["text_embedding"])
    for k, v in flatten_state_dict(prepared["text_projection"]).items():
        put(f"{prefix}.text_projection.{k}", v)
    put(f"{prefix}.codec_head.weight", prepared["codec_head"])

    cp = prepared["code_predictor"]
    unstack(_unfuse_layers(cp["layers"], cp_cfg.num_attention_heads,
                           cp_cfg.num_key_value_heads, cp_cfg.head_dim),
            f"{prefix}.code_predictor.model.layers")
    put(f"{prefix}.code_predictor.model.norm.weight", cp["norm"]["weight"])
    for i in range(cp["embeddings"].shape[0]):
        put(f"{prefix}.code_predictor.model.codec_embedding.{i}.weight", cp["embeddings"][i])
    for i in range(cp["lm_heads"].shape[0]):
        put(f"{prefix}.code_predictor.lm_head.{i}.weight", cp["lm_heads"][i])
    if cp.get("proj") is not None:
        put(f"{prefix}.code_predictor.small_to_mtp_projection.weight", cp["proj"]["weight"])
        put(f"{prefix}.code_predictor.small_to_mtp_projection.bias", cp["proj"]["bias"])
    return out


def from_jax_tree(tree, device="cpu"):
    """Convert a JAX-package parameter tree (jax or numpy leaves, including
    stacked layers and int8 {"q", "s"} dicts) into torch tensors on `device`.

    numpy's bfloat16 (ml_dtypes) is not a dtype torch.from_numpy accepts, so
    bf16 leaves travel as their uint16 bit patterns and are viewed back.
    """
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def quantize_weight_int8(w: torch.Tensor, axis: int = -1) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric int8 weight quantization.

    w: (..., O, I) torch-layout matmul weight. Returns {"q": int8, "s":
    per-row fp32 scales} with w ~= q * s[..., None]. Same formula as the JAX
    package: scale = max(amax / 127, 1e-12), round half to even, clip +-127.
    """
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=axis, keepdim=True)
    # a tensor divisor: on CUDA a Python scalar divides as a reciprocal multiply
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(axis).to(torch.float32)}


def quantize_talker_params(prepared: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 for the talker and code-predictor layer matmuls and
    the codec head. Embedding tables and norms keep their dtype."""
    out = dict(prepared)

    def quantize_layers(layers):
        layers = dict(layers)
        attn = dict(layers["self_attn"])
        for name in ("qkv_proj", "o_proj"):
            attn[name] = {"weight": quantize_weight_int8(attn[name]["weight"])}
        layers["self_attn"] = attn
        mlp = dict(layers["mlp"])
        for name in ("gate_up_proj", "down_proj"):
            mlp[name] = {"weight": quantize_weight_int8(mlp[name]["weight"])}
        layers["mlp"] = mlp
        return layers

    out["layers"] = quantize_layers(prepared["layers"])
    out["codec_head"] = quantize_weight_int8(prepared["codec_head"])
    cp = dict(prepared["code_predictor"])
    cp["layers"] = quantize_layers(cp["layers"])
    out["code_predictor"] = cp
    return out


def is_int8(w) -> bool:
    return isinstance(w, dict) and "q" in w


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T supporting raw tensors and weight-only int8 dicts."""
    if is_int8(w):
        y = x @ w["q"].T.to(x.dtype)
        return y * w["s"].to(x.dtype)
    return x @ w.T.to(x.dtype)


def weight_rows(w) -> int:
    """Output-row count of a matmul_t weight (raw tensor or int8 dict)."""
    return (w["q"] if is_int8(w) else w).shape[-2]
