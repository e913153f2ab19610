"""Token sampling with HF-generate semantics (counterpart of
`qwen3_tts_tpu/ops/sampling.py`).

Order of the logits processors, as in the JAX package and HF generate:
repetition penalty over previously generated ids, suppress list, EOS ban
(min_new_tokens), then temperature -> top-k -> top-p, then a categorical
draw (or argmax when greedy).

A categorical draw is `argmax(logits + gumbel)`, exactly the form
`jax.random.categorical` takes. The Gumbel noise comes from an explicit
`torch.Generator`, or is passed in as `noise` (tests hand both packages the
same draw, since a JAX key and a torch generator give different numbers).
`noise_rows=(n, rows)` draws the noise of an n-row batch and keeps `rows`
(a slice or an index tensor): a batch sharded over data-parallel ranks
samples what the whole batch samples from one seeded generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NEG_INF = float(torch.finfo(torch.float32).min)
_TINY = float(torch.finfo(torch.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    do_sample: bool = True
    top_k: int = 50
    top_p: float = 1.0
    temperature: float = 0.9
    repetition_penalty: float = 1.05

    def as_row(self) -> np.ndarray:
        """The per-request sampling row [temp, top_p, rep_pen, do_sample,
        top_k] (numpy (5,) f32) that process_and_sample_rows consumes."""
        return np.array([self.temperature, self.top_p,
                         self.repetition_penalty, float(self.do_sample),
                         float(self.top_k)], np.float32)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(torch.clamp(u, min=_TINY)))


def _categorical(logits: torch.Tensor, generator, noise, noise_rows=None) -> torch.Tensor:
    if noise is None and noise_rows is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    elif noise is None:
        n, rows = noise_rows
        noise = gumbel_noise((n,) + tuple(logits.shape[1:]), generator, logits.device)[rows]
    return torch.argmax(logits + noise.to(logits.device), dim=-1)


def _penalize(logits, presence, pen, suppress_mask, ban_eos, eos_id):
    if presence is not None:
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(presence, penalized, logits)
    if suppress_mask is not None:
        logits = logits.masked_fill(suppress_mask[None, :], NEG_INF)
    if ban_eos is not None and eos_id is not None:
        # built by a comparison: a scalar stored by index would be a host
        # copy, which a CUDA graph capture refuses
        eos_col = torch.arange(logits.shape[-1], device=logits.device) == eos_id
        logits = logits.masked_fill(ban_eos[:, None] & eos_col[None, :], NEG_INF)
    return logits


def process_and_sample_rows(logits: torch.Tensor, rows: torch.Tensor,
                            top_k: int,
                            presence: Optional[torch.Tensor] = None,
                            suppress_mask: Optional[torch.Tensor] = None,
                            ban_eos: Optional[torch.Tensor] = None,
                            eos_id: Optional[int] = None,
                            all_greedy: bool = False,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None,
                            noise_rows=None) -> torch.Tensor:
    """Per-ROW sampling: each row carries [temperature, top_p,
    repetition_penalty, do_sample, top_k] (`rows` (B, 5)). `top_k` is the
    candidate width (rows narrow within it; row k <= 0 keeps every
    candidate). Greedy rows take the argmax of the penalized logits.
    `all_greedy` skips the sampling machinery. `noise` is the Gumbel draw:
    (B, top_k) on the top-k path, (B, V) on the full-vocabulary path;
    `noise_rows` as in the module docstring."""
    logits = logits.to(torch.float32)
    temp = torch.clamp(rows[:, 0], min=1e-6)[:, None]
    top_p = rows[:, 1][:, None]
    pen = rows[:, 2][:, None]
    do_sample = rows[:, 3] > 0.5
    row_k = rows[:, 4][:, None]

    logits = _penalize(logits, presence, pen, suppress_mask, ban_eos, eos_id)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy:
        return greedy
    warped = logits / temp
    V = logits.shape[-1]
    if 0 < top_k < V:
        vals, idx = torch.topk(warped, top_k, dim=-1)   # sorted descending
        rank = torch.arange(top_k, device=logits.device)[None, :].to(torch.float32)
        kmask = (row_k <= 0) | (rank < row_k)
        vals = torch.where(kmask, vals, torch.full_like(vals, NEG_INF))
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p
        keep[..., 0].fill_(True)
        vals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
        choice = _categorical(vals, generator, noise, noise_rows)
        sampled = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    else:
        sorted_logits = torch.sort(warped, dim=-1, descending=True).values
        rank = torch.arange(V, device=logits.device)[None, :].to(torch.float32)
        kmask = (row_k <= 0) | (rank < row_k)
        kvals = torch.where(kmask, sorted_logits,
                            torch.full_like(sorted_logits, NEG_INF))
        probs = torch.softmax(kvals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = ((cum - probs) < top_p) & kmask
        keep_sorted[..., 0].fill_(True)
        kth = torch.where(keep_sorted, sorted_logits,
                          torch.full_like(sorted_logits, float("inf"))
                          ).amin(dim=-1, keepdim=True)
        warped = torch.where(warped < kth, torch.full_like(warped, NEG_INF), warped)
        sampled = _categorical(warped, generator, noise, noise_rows).to(torch.int32)
    return torch.where(do_sample, sampled, greedy)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """HF TopPLogitsWarper (keeps at least one token)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    keep_sorted[..., 0].fill_(True)
    kth = torch.where(keep_sorted, sorted_logits,
                      torch.full_like(sorted_logits, float("inf"))
                      ).amin(dim=-1, keepdim=True)
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def process_and_sample(logits: torch.Tensor, params: SamplingParams,
                       presence: Optional[torch.Tensor] = None,
                       suppress_mask: Optional[torch.Tensor] = None,
                       ban_eos: Optional[torch.Tensor] = None,
                       eos_id: Optional[int] = None,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       noise_rows=None) -> torch.Tensor:
    """logits: (B, V) -> sampled ids (B,) int32, with one SamplingParams for
    the whole batch. `noise` and `noise_rows` as in process_and_sample_rows."""
    logits = _penalize(logits.to(torch.float32), presence,
                       params.repetition_penalty, suppress_mask, ban_eos, eos_id)
    if not params.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / params.temperature
    k = params.top_k
    if 0 < k < logits.shape[-1]:
        # sample within the top-k subset and map back through the indices
        vals, idx = torch.topk(logits, k, dim=-1)
        if params.top_p < 1.0:
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            keep = (cum - probs) < params.top_p
            keep[..., 0].fill_(True)
            vals = torch.where(keep, vals, torch.full_like(vals, NEG_INF))
        choice = _categorical(vals, generator, noise, noise_rows)
        return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    logits = apply_top_p(logits, params.top_p)
    return _categorical(logits, generator, noise, noise_rows).to(torch.int32)
