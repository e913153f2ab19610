"""Single-speaker SFT loss and optimizer step (counterpart of
`qwen3_tts_tpu/finetune/train.py`, which rebuilds finetuning/sft_12hz.py):
torch autograd where the JAX package takes `jax.value_and_grad`.

Loss (sft_12hz.py:69-124):
- embedding fusion: text_embedding * text_mask + codec_embedding *
  codec_mask, the speaker embedding at slot 6, plus the per-codebook
  sub-code embeddings over codec frames (85-98);
- talker cross entropy on codec_0_labels shifted by one (100-105);
- sub-talker cross entropy over frame positions, each frame's codes
  conditioned on the talker hidden at the frame's own position, dense over
  every position and masked to the frames (107-111);
- total = talker + 0.3 * sub-talker (113).

The talker runs its training route (`talker_prefill(..., cache=None,
allow_flash=False)`): attention over the call's fresh K/V, no cache write,
no flash kernel (it has no backward). The optimizer is the JAX package's
`optax.MultiSteps(chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=0.01)), k)`: gradients averaged over k calls (a running mean in
the params' dtype, as MultiSteps keeps it), the average clipped by optax's
rule (scaled by max / norm only when norm >= max), then `torch.optim.AdamW`
(eps 1e-8, decoupled decay; states in the params' dtype). On a CUDA device
with no mesh one mini-step is one replay of a captured graph
(`make_train_step`, `runtime/graphs.py` `TrainGraphs`), the counterpart of
the JAX package's `sft.py` and its `jax.jit(make_train_step(...))`.

Under a mesh (`parallel/mesh.py`) each rank holds its tensor-parallel
shards and its dp share of the batch rows. The talker and sub-talker run
their TP collectives (`decoder_stack`), the vocabulary heads are gathered
whole, and each cross entropy divides this rank's sum by the valid count of
the whole batch (an all-reduce over dp), so the gradients summed over dp
are the whole batch's. `SFTOptimizer` sums the squares of the sharded
leaves over tp and counts the replicated ones once, so the clip sees the
unsharded norm.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import TalkerConfig
from ..models.talker import StackDims, _cp_project, decoder_stack, talker_prefill, text_project
from ..ops.attention import mask_to_bias
from ..ops.rope import default_inv_freq, rope_tables
from ..parallel.mesh import Mesh, all_reduce, copy_to_tp, gather_from_tp, tp_splits

Params = Dict[str, Any]


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean cross entropy over the labels that are not ignored (HF loss
    semantics); under a mesh this rank's share of the whole batch's mean."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    count = valid.sum()
    if mesh is not None:
        count = all_reduce(count, mesh.dp_group)
    return nll.sum() / count.clamp_min(1)


def _vocab_logits(equation: str, h: torch.Tensor, w: torch.Tensor, vocab: int,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """fp32 logits of a vocabulary head as an einsum, gathered whole when
    the mesh splits the vocabulary (`models/talker.py::head_logits`)."""
    mesh = mesh if tp_splits(vocab, mesh) else None
    return gather_from_tp(torch.einsum(equation, copy_to_tp(h.to(torch.float32), mesh),
                                       w.to(torch.float32)), mesh)


def fuse_embeddings(params: Params, cfg: TalkerConfig, batch: Dict[str, torch.Tensor],
                    speaker_embedding: torch.Tensor) -> torch.Tensor:
    """sft_12hz.py:86-98 embedding fusion. Returns (B, T, H)."""
    input_ids = batch["input_ids"].long()            # (B, T, 2)
    text_emb = params["text_embedding"][input_ids[..., 0]]
    if text_emb.shape[-1] != cfg.hidden_size:
        # the reference SFT adds raw text embeddings (sft_12hz.py:88), which
        # assumes text_hidden == hidden; project where a config has them differ
        text_emb = text_project(params, cfg, text_emb)
    text_emb = text_emb * batch["text_embedding_mask"].to(text_emb.dtype)
    codec_emb = params["codec_embedding"][input_ids[..., 1]]
    codec_emb = codec_emb * batch["codec_embedding_mask"].to(codec_emb.dtype)
    codec_emb = torch.cat([codec_emb[:, :6], speaker_embedding.to(codec_emb.dtype)[:, None],
                           codec_emb[:, 7:]], dim=1)
    emb = text_emb + codec_emb
    cp_tables = params["code_predictor"]["embeddings"]
    cmask = batch["codec_mask"][..., None].to(emb.dtype)
    codec_ids = batch["codec_ids"].long()
    for i in range(1, cfg.num_code_groups):
        emb = emb + cp_tables[i - 1][codec_ids[..., i]] * cmask
    return emb


def _sub_talker_dense(params: Params, cfg: TalkerConfig, hidden: torch.Tensor,
                      codec_ids: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Dense code-predictor teacher forcing. hidden: (N, H_talker)
    conditioning vectors; codec_ids: (N, Q). Returns logits (N, Q-1, V)
    for codes 1..Q-1."""
    cp_cfg = cfg.code_predictor_config
    cp = params["code_predictor"]
    dims = StackDims.from_code_predictor(cp_cfg, mesh)
    N, Q = hidden.shape[0], cfg.num_code_groups
    dtype, dev = hidden.dtype, hidden.device
    codec_ids = codec_ids.long()
    seq = [hidden[:, None, :], params["codec_embedding"][codec_ids[:, 0]][:, None, :].to(dtype)]
    for i in range(1, Q - 1):
        seq.append(cp["embeddings"][i - 1][codec_ids[:, i]][:, None, :].to(dtype))
    x = _cp_project(cp, torch.cat(seq, dim=1))      # (N, Q, Hc)
    pos = torch.arange(Q, device=dev)[None, :].expand(N, Q)
    cos, sin = rope_tables(pos, default_inv_freq(dims.head_dim, cp_cfg.rope_theta, device=dev))
    ok = torch.arange(Q, device=dev)[None, :] <= torch.arange(Q, device=dev)[:, None]
    bias = mask_to_bias(ok)[None, None].expand(N, 1, Q, Q)
    h = decoder_stack(cp["layers"], cp["norm"], dims, x, cos, sin, bias, None, 0)
    # code i's logits from position i through lm_head[i-1] (reference 1235-1238)
    return _vocab_logits("nqh,qvh->nqv", h[:, 1:], cp["lm_heads"], cp_cfg.vocab_size, mesh)


def sft_loss(params: Params, cfg: TalkerConfig, batch: Dict[str, torch.Tensor],
             speaker_embedding: torch.Tensor, mesh: Optional[Mesh] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of `batch`; under a mesh, of this rank's rows, as its share
    of the whole batch's loss (module docstring)."""
    emb = fuse_embeddings(params, cfg, batch, speaker_embedding)
    B, T, H = emb.shape
    # allow_flash=False: SFT batches are right-padded and differentiated,
    # both outside the flash kernel's contract
    _, hidden, _ = talker_prefill(params, cfg, emb[:, :-1], batch["attention_mask"][:, :-1],
                                  None, allow_flash=False, mesh=mesh)
    logits = _vocab_logits("bth,vh->btv", hidden, params["codec_head"], cfg.vocab_size, mesh)
    talker_loss = _cross_entropy(logits, batch["codec_0_labels"][:, 1:], mesh=mesh)

    # the dense sub-talker over all positions, masked to the frame positions
    cmask = batch["codec_mask"][:, :T - 1]
    flat_hidden = hidden.reshape(B * (T - 1), H)
    flat_codes = batch["codec_ids"][:, :T - 1].reshape(B * (T - 1), -1)
    sub_logits = _sub_talker_dense(params, cfg, flat_hidden, flat_codes, mesh)
    sub_labels = torch.where(cmask.reshape(-1, 1), flat_codes[:, 1:],
                             torch.full_like(flat_codes[:, 1:], -100))
    sub_loss = _cross_entropy(sub_logits, sub_labels, mesh=mesh)
    loss = talker_loss + 0.3 * sub_loss
    return loss, {"talker_loss": talker_loss, "sub_talker_loss": sub_loss}


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree in a fixed (sorted-key) order; None
    leaves (an absent projection) skipped."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in param_leaves(params[k])]
    return [] if params is None else [params]


def trainable(params: Params) -> Params:
    """A copy of `params` whose leaves are fresh tensors that require grad
    (each a leaf of its own, not a view of a fused or stacked load)."""
    if isinstance(params, dict):
        return {k: trainable(v) for k, v in params.items()}
    if params is None:
        return None
    return params.detach().clone().requires_grad_(True)


class SFTOptimizer:
    """optax.MultiSteps(chain(clip_by_global_norm(clip_norm),
    adamw(lr, weight_decay)), every_k_schedule=grad_accum) over the leaves of
    a parameter tree, with `torch.optim.AdamW` as its inner update.

    `accumulate(grads)` folds one call's gradients into the running mean
    (copies of them: the caller's tensors stay as they are); on every
    grad_accum-th call it clips the mean, steps AdamW and returns True (the
    params changed). `last_norm` is the global norm of the mean the last update
    clipped (before clipping), read from the device when asked.

    The device work reads nothing back to the host, so that one mini-step
    can be captured as a CUDA graph (`runtime/graphs.py` `TrainGraphs`):
    the mini-step counter lives on the host (`begin` / `finish`), the fold
    divides by a device scalar that `begin` fills (`count`, n + 1), the
    clip is optax's select on the device, and the fold, the norm and the
    clip run over the leaf lists with `torch._foreach_*` (one launch per
    operation and dtype), in place: `apply` folds in the gradients it is
    handed (a mini-step's own, thrown away after it), the clip works in
    the mean, which AdamW reads as the gradient and which is zeroed after
    the step. So a mini-step holds no params-sized temporary beyond its
    gradients. On CUDA, AdamW is
    `capturable` (its step counts live on the device); on the CPU it keeps
    its default settings.

    Under a mesh the leaves are this rank's shards and `sharded` (one bool
    per leaf, `param_flags` of the plan) marks the tensor-parallel ones:
    their squares are summed over tp, the replicated leaves counted once."""

    def __init__(self, params: Params, lr: float = 2e-5, weight_decay: float = 0.01,
                 clip_norm: float = 1.0, grad_accum: int = 1, mesh: Optional[Mesh] = None,
                 sharded: Optional[List[bool]] = None):
        self.leaves = param_leaves(params)
        self.mesh = mesh
        self.sharded = list(sharded) if sharded is not None else [False] * len(self.leaves)
        device = self.leaves[0].device
        self.adamw = torch.optim.AdamW(self.leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay,
                                       capturable=device.type == "cuda")
        self.clip_norm = float(clip_norm)
        self.grad_accum = int(grad_accum)
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.leaves]
        self.count = torch.ones((), dtype=torch.float32, device=device)   # the fold's n + 1
        self.norm = torch.zeros((), dtype=torch.float32, device=device)   # the last update's
        self.updates = 0
        self.version = 0    # bumped where the AdamW state tensors are replaced
        self._dtypes: Dict[torch.dtype, List[int]] = {}
        for i, p in enumerate(self.leaves):
            self._dtypes.setdefault(p.dtype, []).append(i)

    @property
    def last_norm(self) -> Optional[float]:
        return float(self.norm) if self.updates else None

    def begin(self) -> bool:
        """Fill the fold's count for this mini-step (a device fill, nothing
        read back); whether it ends with an update."""
        self.count.fill_(self.mini_step + 1)
        return self.mini_step + 1 >= self.grad_accum

    def finish(self, update: bool) -> None:
        """Advance the host's mini-step counter past a mini-step `begin`
        started."""
        self.mini_step = 0 if update else self.mini_step + 1
        self.updates += int(update)

    def accumulate(self, grads: List[torch.Tensor]) -> bool:
        update = self.begin()
        self.apply([g.clone() for g in grads], update)
        self.finish(update)
        return update

    def apply(self, grads: List[torch.Tensor], update: bool) -> None:
        """The device work of one mini-step: fold `grads` into the running
        mean (MultiSteps' rule, acc += (g - acc) / count; `grads` hold the
        step afterwards); with `update`, clip the mean in place, step AdamW
        on it and zero it."""
        with torch.no_grad():
            for dt, idx in self._dtypes.items():
                acc = [self.acc[i] for i in idx]
                step = [grads[i].to(dt) for i in idx]
                torch._foreach_sub_(step, acc)
                torch._foreach_div_(step, self.count.to(dt))
                torch._foreach_add_(acc, step)
            if not update:
                return
            norm = self.global_norm(self.acc)
            self.norm.copy_(norm)
            self.clip_(norm)
            for p, a in zip(self.leaves, self.acc):
                p.grad = a
            self.adamw.step()
            for p in self.leaves:
                p.grad = None
            torch._foreach_zero_(self.acc)

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        squares = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)).square()
        if self.mesh is None:
            return torch.sqrt(squares.sum())
        flags = torch.tensor(self.sharded, device=squares.device)
        split = torch.where(flags, squares, 0.0).sum()
        whole = torch.where(flags, 0.0, squares).sum()
        return torch.sqrt(all_reduce(split, self.mesh.tp_group) + whole)

    def clip_(self, norm: torch.Tensor) -> None:
        """optax's clip_by_global_norm of the mean, in place: acc where
        norm < clip_norm, else acc / norm * clip_norm (norm and clip_norm in
        each leaf's dtype), as a select on the device."""
        free = norm < self.clip_norm
        one = torch.ones_like(norm)
        for dt, idx in self._dtypes.items():
            acc = [self.acc[i] for i in idx]
            torch._foreach_div_(acc, torch.where(free, one, norm).to(dt))
            torch._foreach_mul_(acc, torch.where(free, one, self.clip_norm).to(dt))

    def state_dict(self) -> Dict[str, Any]:
        return {"adamw": self.adamw.state_dict(), "mini_step": self.mini_step,
                "acc": [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.version += 1   # new AdamW state tensors: captured steps must go
        self.mini_step = int(state["mini_step"])
        for a, s in zip(self.acc, state["acc"]):
            a.copy_(s)


def param_flags(params: Params, plan: Params) -> List[bool]:
    """One bool per `param_leaves(params)` entry: whether the plan
    (`parallel/mesh.py::tp_shard_plan`) splits that leaf over tp."""
    if isinstance(params, dict):
        return [f for k in sorted(params) for f in param_flags(params[k], plan[k])]
    return [] if params is None else [plan is not None]


def default_optimizer(params: Params, lr: float = 2e-5, weight_decay: float = 0.01,
                      clip_norm: float = 1.0, grad_accum: int = 1,
                      mesh: Optional[Mesh] = None,
                      sharded: Optional[List[bool]] = None) -> SFTOptimizer:
    """AdamW + global-norm clipping (sft_12hz.py:60, 117-118), accumulating
    `grad_accum` calls per update (the JAX driver's MultiSteps)."""
    return SFTOptimizer(params, lr=lr, weight_decay=weight_decay, clip_norm=clip_norm,
                        grad_accum=grad_accum, mesh=mesh, sharded=sharded)


def mini_step(cfg: TalkerConfig, optimizer: SFTOptimizer, params: Params,
              batch: Dict[str, torch.Tensor], speaker_embedding: torch.Tensor,
              update: bool) -> Dict[str, torch.Tensor]:
    """The device work of one mini-step, the body a training graph captures
    (`runtime/graphs.py` `TrainGraphs`): forward and backward, then
    `optimizer.apply(grads, update)` (which works in the fresh gradients).
    Returns the losses as device scalars."""
    mesh = optimizer.mesh
    for p in optimizer.leaves:
        p.grad = None
    with torch.enable_grad():
        loss, metrics = sft_loss(params, cfg, batch, speaker_embedding.detach(), mesh)
        loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in optimizer.leaves]
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["loss"] = loss.detach()
    if mesh is not None:
        grads = [all_reduce(g, mesh.dp_group) for g in grads]
        metrics = {k: all_reduce(v, mesh.dp_group) for k, v in metrics.items()}
    optimizer.apply(grads, update)
    for p in optimizer.leaves:
        p.grad = None
    return metrics


def make_train_step(cfg: TalkerConfig, optimizer: SFTOptimizer):
    """(params, batch, speaker_embedding) -> metrics. One call is one
    mini-step: forward and backward, then the optimizer folds the gradients
    in (and updates the params in place on every grad_accum-th call).
    `params` are the optimizer's leaves (`trainable`); a leaf the loss does
    not reach gets a zero gradient, as `jax.grad` gives it, so AdamW still
    decays it. The speaker embedding carries no gradient. Under the
    optimizer's mesh the batch is this rank's rows, the gradients are summed
    over dp before the optimizer folds them in, and the losses reported are
    the whole batch's.

    On a CUDA device with no mesh (outside `graphs.eager()`) each call is
    one replay of the captured mini-step of its (B, T, phase), the JAX
    `sft.py`'s `jax.jit(make_train_step(...))`: the first call of a key runs
    eagerly and is the real step, the capture follows it
    (`runtime/graphs.py` `TrainGraphs`). Elsewhere the step is eager."""
    from ..runtime import graphs

    owner: List[Any] = []

    def train_step(params: Params, batch: Dict[str, torch.Tensor],
                   speaker_embedding: torch.Tensor) -> Dict[str, Any]:
        if optimizer.mesh is None and graphs.enabled(optimizer.leaves[0].device):
            if not owner:
                owner.append(graphs.TrainGraphs(optimizer, lambda p, b, s, u: mini_step(
                    cfg, optimizer, p, b, s, u)))
            return owner[0].step(params, batch, speaker_embedding)
        update = optimizer.begin()
        metrics = mini_step(cfg, optimizer, params, batch, speaker_embedding, update)
        optimizer.finish(update)
        metrics["updated"] = update
        return metrics

    return train_step
