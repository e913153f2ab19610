"""Device mesh, the tensor-parallel plan and its collectives (counterpart of
`qwen3_tts_tpu/parallel/mesh.py`).

The JAX package places a parameter tree on a ("dp", "tp") jax Mesh and lets
GSPMD insert the collectives. Here each rank is one process of a
`torch.distributed` world and the collectives are explicit:

- `make_mesh(dp, tp)`: rank r is (dp index r // tp, tp index r % tp), the
  JAX package's devices reshaped (dp, tp); each row of the grid is a tp
  process group, each column a dp group.
- `talker_param_specs`: the HF tensor-parallel plan as the JAX package
  writes it (colwise qkv / gate_up on axis -2, rowwise o_proj / down on
  axis -1, the codec head and the code predictor's lm heads over the
  vocabulary, embeddings replicated; an int8 `s` takes the weight's spec
  less its last entry), as tuples comparable with `PartitionSpec`s.
- `tp_shard_plan` / `shard_talker_params`: what each rank keeps. Explicit
  TP needs **head-aligned** shards, not the contiguous split GSPMD can
  afford: a rank's fused qkv rows are its Hq/tp query heads, then its
  Hkv/tp key heads, then its Hkv/tp value heads, and its gate_up rows its
  slice of gate, then the matching slice of up; o_proj and down are split by
  input column, the heads over the vocabulary. A stack whose KV heads (or
  MLP width, or a head's vocabulary) tp does not divide stays replicated,
  where the JAX package's `_validate_spec` replicates an axis.
- `copy_to_tp`, `reduce_from_tp`: Megatron's f and g (identity forward and
  all-reduce backward at the input of a column-parallel matmul; all-reduce
  forward and identity backward after a row-parallel one), so replicated
  weights get equal gradients on every rank; `gather_from_tp`: vocabulary
  shards into whole logits (its backward takes this rank's slice);
  `gather_rows`: a batch sharded over dp back to full size.
- `shard_slot_state`: a serving engine's slots and staging rows over dp,
  its KV heads over tp, `tts_pad` replicated.

Only `all_reduce` and `broadcast` are used: gloo supports nothing else on
CUDA tensors, and ranks that share one card must use gloo (NCCL refuses two
ranks on one device). A gather is an all-reduce of a zero buffer into which
each rank has written its slice. bf16 and fp16 tensors are reduced in fp32.
Under a mesh every planned collective runs, also over a group of one rank,
so a one-rank NCCL mesh still initialises and reduces.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (dp, tp) grid and its two process groups."""

    dp: int
    tp: int
    dp_rank: int
    tp_rank: int
    dp_group: Any
    tp_group: Any
    device: torch.device

    def rows(self, n: int) -> slice:
        """This dp rank's share of n batch rows (dp must divide n)."""
        if n % self.dp:
            raise ValueError(f"{n} rows do not split over dp={self.dp}")
        k = n // self.dp
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)

    def noise_rows(self, n_local: int):
        """(full batch, this rank's rows) of a batch sharded evenly over dp:
        the sampling draws noise for the full batch and keeps these rows,
        so a sharded run samples what the unsharded run samples."""
        return n_local * self.dp, slice(self.dp_rank * n_local, (self.dp_rank + 1) * n_local)


def make_mesh(dp: int = 1, tp: int = 1, device="cuda",
              backend: Optional[str] = None) -> Optional[Mesh]:
    """A ("dp", "tp") mesh over the process group the launcher set up (the
    torchrun environment initialises one if none exists). `backend=None`
    is NCCL on `cuda` and gloo on `cpu`; ranks sharing one card pass
    "gloo". Raises if dp * tp exceeds the world; ranks past dp * tp take no
    part and get None. On `cuda` without an index the rank's card is
    LOCAL_RANK modulo the cards present."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("make_mesh: no process group; launch under torchrun "
                             "or call torch.distributed.init_process_group first")
        dist.init_process_group(backend, init_method="env://")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp * tp > world:
        raise ValueError(f"need {dp * tp} ranks, have {world}")
    # every rank creates every group, in one order
    tp_groups = [dist.new_group([i * tp + j for j in range(tp)], backend=backend)
                 for i in range(dp)]
    dp_groups = [dist.new_group([i * tp + j for i in range(dp)], backend=backend)
                 for j in range(tp)]
    if rank >= dp * tp:
        return None
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(dp, tp, rank // tp, rank % tp, dp_groups[rank % tp], tp_groups[rank // tp],
                device)


def tp_splits(n: int, mesh: Optional[Mesh]) -> bool:
    """Whether a dimension of n heads (or features) is split over tp."""
    return mesh is not None and n % mesh.tp == 0


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group, out of place; bf16 / fp16 in fp32, bool as
    int32."""
    wide = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
            torch.bool: torch.int32}.get(x.dtype, x.dtype)
    y = x.detach().to(wide, memory_format=torch.contiguous_format, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        n = x.shape[-1]
        ctx.lo, ctx.n = rank * n, n
        full = x.new_zeros(x.shape[:-1] + (n * size,))
        full[..., rank * n:(rank + 1) * n] = x
        return all_reduce(full, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.lo:ctx.lo + ctx.n], None, None, None


def copy_to_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Identity forward, all-reduce backward over tp (the input of a
    column-parallel matmul, or a replicated weight used on local heads)."""
    return x if mesh is None else _CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """All-reduce forward over tp, identity backward (the partial sums of a
    row-parallel matmul)."""
    return x if mesh is None else _ReduceFromTP.apply(x, mesh.tp_group)


def gather_from_tp(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Shards of the last axis (in tp order) -> the whole axis on every
    rank; the backward keeps this rank's slice."""
    if mesh is None:
        return x
    return _GatherFromTP.apply(x, mesh.tp_group, mesh.tp_rank, mesh.tp)


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This dp rank's rows of a batch (leading axis, an even share) -> the
    full batch on every rank."""
    if mesh is None:
        return x
    n = x.shape[0]
    full = x.new_zeros((n * mesh.dp,) + tuple(x.shape[1:]))
    full[mesh.dp_rank * n:(mesh.dp_rank + 1) * n] = x
    return all_reduce(full, mesh.dp_group)


# ---------------------------------------------------------------------------
# The tensor-parallel plan
# ---------------------------------------------------------------------------

# Path pattern -> spec of the prepared talker tree, verbatim from the JAX
# package (talker rules anchored at the root so the code-predictor rules
# below stay reachable).
_TALKER_RULES = [
    (r"^layers/self_attn/qkv_proj/weight$", (None, "tp", None)),
    (r"^layers/self_attn/o_proj/weight$", (None, None, "tp")),
    (r"^layers/mlp/gate_up_proj/weight$", (None, "tp", None)),
    (r"^layers/mlp/down_proj/weight$", (None, None, "tp")),
    (r"codec_head$", ("tp", None)),           # colwise_rep -> shard vocab
    (r"codec_embedding$", (None, None)),
    (r"text_embedding$", (None, None)),
    (r"code_predictor/layers/self_attn/qkv_proj/weight$", (None, "tp", None)),
    (r"code_predictor/layers/self_attn/o_proj/weight$", (None, None, "tp")),
    (r"code_predictor/layers/mlp/gate_up_proj/weight$", (None, "tp", None)),
    (r"code_predictor/layers/mlp/down_proj/weight$", (None, None, "tp")),
    (r"code_predictor/lm_heads$", (None, "tp", None)),
    (r"code_predictor/embeddings$", (None, None, None)),
]


def _base_path(path: str):
    """(the weight's path, whether the leaf is an int8 scale)."""
    if path.endswith("/q"):
        return path[:-2], False
    if path.endswith("/s"):
        return path[:-2], True
    return path, False


def _spec_for(path: str) -> tuple:
    # an int8 weight's `q` carries the weight's spec, its per-row scales `s`
    # the spec less its last entry
    base, is_scale = _base_path(path)
    for pat, spec in _TALKER_RULES:
        if re.search(pat, base):
            return spec[:-1] if is_scale else spec
    return ()   # replicated


def talker_param_specs(params: Params) -> Params:
    """The spec tree of a prepared talker param tree (None leaves kept)."""
    def assign(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: assign(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        return None if tree is None else _spec_for(prefix)

    return assign(params)


class Shard(NamedTuple):
    """One leaf's split: this rank keeps `index` along `axis` (negative)
    of a dimension of `full` entries."""

    axis: int
    index: torch.Tensor
    full: int


def _rows(w) -> torch.Tensor:
    return w["q"] if isinstance(w, dict) else w


def _geometry(stack: Params):
    """(head_dim, Hq, Hkv, intermediate) of a stacked layer tree, from its
    shapes."""
    attn = stack["self_attn"]
    D = attn["q_norm"]["weight"].shape[-1]
    Hq = _rows(attn["o_proj"]["weight"]).shape[-1] // D
    Hkv = (_rows(attn["qkv_proj"]["weight"]).shape[-2] // D - Hq) // 2
    inter = _rows(stack["mlp"]["gate_up_proj"]["weight"]).shape[-2] // 2
    return D, Hq, Hkv, inter


def _span(lo: int, n: int) -> torch.Tensor:
    return torch.arange(lo, lo + n)


def _shard_for(path: str, spec: tuple, shape, params: Params, mesh: Mesh) -> Optional[Shard]:
    if "tp" not in spec:
        return None
    axis = spec.index("tp") - len(spec)
    n, tp, r = shape[axis], mesh.tp, mesh.tp_rank
    base, _ = _base_path(path)
    if "layers/" in base:
        stack = params["code_predictor"]["layers"] if base.startswith("code_predictor/") \
            else params["layers"]
        D, Hq, Hkv, inter = _geometry(stack)
        if base.endswith("qkv_proj/weight"):
            if Hkv % tp:
                return None
            hq, hk = Hq // tp, Hkv // tp
            index = torch.cat([_span(r * hq * D, hq * D), _span((Hq + r * hk) * D, hk * D),
                               _span((Hq + Hkv + r * hk) * D, hk * D)])
            return Shard(axis, index, n)
        if base.endswith("gate_up_proj/weight"):
            if inter % tp:
                return None
            k = inter // tp
            return Shard(axis, torch.cat([_span(r * k, k), _span(inter + r * k, k)]), n)
        if (Hkv if base.endswith("o_proj/weight") else inter) % tp:
            return None
    if n % tp:
        return None
    return Shard(axis, _span(r * (n // tp), n // tp), n)


def tp_shard_plan(params: Params, mesh: Mesh) -> Params:
    """A tree like `params`: each leaf this rank's `Shard`, or None where
    the leaf is replicated (or absent)."""
    def plan(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: plan(v, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
        if tree is None:
            return None
        return _shard_for(prefix, _spec_for(prefix), tree.shape, params, mesh)

    return plan(params)


def _zip_map(fn, tree, plan):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, plan[k]) for k, v in tree.items()}
    if tree is None:
        return None
    return tree if plan is None else fn(tree, plan)


def shard_talker_params(params: Params, mesh: Mesh, plan: Optional[Params] = None) -> Params:
    """This rank's local shards of a prepared talker tree (head-aligned;
    replicated leaves are the same tensors)."""
    plan = tp_shard_plan(params, mesh) if plan is None else plan
    return _zip_map(lambda t, s: t.index_select(t.ndim + s.axis, s.index.to(t.device)),
                    params, plan)


def unshard_talker_params(local: Params, plan: Params, mesh: Mesh) -> Params:
    """The inverse of `shard_talker_params` on every rank (a collective over
    tp: each rank writes its rows into a zero buffer, then all-reduce)."""
    def whole(t, s):
        dim = t.ndim + s.axis
        shape = list(t.shape)
        shape[dim] = s.full
        full = t.new_zeros(shape)
        full.index_copy_(dim, s.index.to(t.device), t.detach())
        return all_reduce(full, mesh.tp_group)

    return _zip_map(whole, local, plan)


def shard_slot_state(state, mesh: Mesh):
    """This rank's share of a serving engine's slot state (the counterpart
    of the JAX package's placement): slots and staging rows over dp, the
    KV caches' heads over tp when tp divides them, `tts_pad` replicated.
    Fields with a leading layer axis (the two KV caches) shard their second
    axis. Every slice is a copy, so the full state can be freed."""
    def rows(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        n = x.shape[axis]
        if n % mesh.dp:
            raise ValueError(f"{n} slots or staging rows do not split over dp={mesh.dp}")
        return x.narrow(axis, mesh.dp_rank * (n // mesh.dp), n // mesh.dp)

    def heads(x: torch.Tensor) -> torch.Tensor:
        H = x.shape[2]
        return x if H % mesh.tp else x.narrow(2, mesh.tp_rank * (H // mesh.tp), H // mesh.tp)

    out = {}
    for f in dataclasses.fields(state):
        x = getattr(state, f.name)
        if f.name == "tts_pad":
            out[f.name] = x
        elif dataclasses.is_dataclass(x):   # a KVCache: (L, B, Hkv, S[, D])
            out[f.name] = type(x)(*(None if t is None else heads(rows(t, 1)).clone()
                                    for t in (x.k, x.v, x.k_scale, x.v_scale)))
        else:
            out[f.name] = rows(x).clone()
    return type(state)(**out)
