"""Whether what the timed path served is correct, by the plain reference.

Run once the window has closed, the peak memory read and the program's
state freed. For a sample of the requests the server finished, drawn from
the seed (up to `n` greedy and `n` sampled requests, and the longest of
each kind), the reference (`portbench/reference/`) draws the run's weights
again from the seed, quantises the talker itself, rebuilds each prompt from
the request's inputs (the task file's `reference_prompt`), and runs once
over it with the served tokens. Where the program computed some of those
inputs itself at submit (a clone's reference codes and speaker embedding),
the record carries them as `served_inputs`, and the reference takes them as
it takes the served tokens: each stage from the program's own output of the
stage before, the task's own numbers judging that output. Five numbers are
compared, then the task's own (`CHECK_NAMES`), each against the
configuration's limit (`check_limits` in its file):

  code0_gap         greedy requests: the widest gap by which a served code-0
                    token's logit (the EOS that ended a request included)
                    lies below the best of the reference's processed logits
                    at that step, in units of that row's standard deviation
  subcode_gap       the same over the served codebooks 1..Q-1 of every frame
                    (the sub-talker's logits, teacher-forced)
  code0_topk_gap    sampled requests: the widest gap by which a served code-0
                    token's logit lies below the top_k-th best (the
                    generation's `top_k`) of the reference's processed
                    logits, in the same units: a token the reference would
                    not let the sampler draw
  subcode_topk_gap  the same over the sampled codebooks 1..Q-1
                    (`subtalker_top_k`)
  audio_err         the largest absolute difference of a streamed packet's
                    samples from the reference vocoder over the same served
                    codes with the packet's left context (the reference
                    frames the task's `context_frames` names lead the
                    served ones), over the greedy requests of the sample and
                    the longest request the run finished, relative to the
                    largest reference sample
  <task's names>    the task file's `check_readings` over the same sample

The control (`readings(..., control=True)`) reads the same numbers with the
reference itself in the program's place in the next lower precision: the
talker's matmuls in int4 instead of int8 (at each position of a greedy
request the token the int4 reference ranks first; of a sampled request the
worst of the tokens it would let the sampler draw, its own top_k), the
vocoder with TF32 on; the task reads its own control for its own numbers.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import weights
from portbench.reference import talker as rt
from portbench.reference import vocoder as rv

NAMES = ("code0_gap", "subcode_gap", "code0_topk_gap", "subcode_topk_gap", "audio_err")


def names(task) -> tuple:
    """The numbers a run of `task` compares: the five, then the task's."""
    return NAMES + tuple(getattr(task, "CHECK_NAMES", ()))


def require_limits(cfg: Dict[str, Any], task) -> None:
    """Raise, naming them, where the configuration has no limit for a
    number the run would compare."""
    missing = [n for n in names(task) if n not in cfg.get("check_limits", {})]
    if missing:
        raise KeyError(f"configuration {cfg.get('name')!r} has no check_limits for "
                       f"{missing}, which task {task.__name__} compares")


def host_copy(served_inputs):
    """A task's served inputs (a dict, or None) with each tensor value
    copied to the host, in its dtype."""
    if served_inputs is None:
        return None
    return {k: v.detach().to("cpu") if isinstance(v, torch.Tensor) else v
            for k, v in served_inputs.items()}


def _longest(reqs):
    return max(reqs, key=lambda r: (len(r["frames"]), -r["index"]))


def sample(served: List[Dict[str, Any]], seed: int, n: int):
    """(token sample, audio sample) of the finished requests: of the greedy
    and of the sampled ones, up to n each drawn from the seed plus the
    longest of each kind; the audio sample holds those whose packets were
    kept (the greedy ones) and the longest request of all."""
    rng = np.random.default_rng([int(seed), 7])
    picked = []
    for greedy in (True, False):
        pool = sorted((r for r in served if r["greedy"] == greedy), key=lambda r: r["index"])
        if not pool:
            continue
        chosen = [pool[i] for i in sorted(rng.choice(len(pool), min(n, len(pool)),
                                                     replace=False))]
        longest = _longest(pool)
        if all(r["index"] != longest["index"] for r in chosen):
            chosen.append(longest)
        picked += chosen
    audio = [r for r in picked if r["packets"] is not None]
    if served:
        longest = _longest(served)
        if all(r["index"] != longest["index"] for r in audio):
            audio.append(longest)
    return picked, audio


def _std_units(proc: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(proc)
    x = torch.where(finite, proc, torch.zeros_like(proc))
    n = finite.sum(-1).clamp_min(1)
    mean = x.sum(-1) / n
    var = (torch.where(finite, proc - mean[..., None], torch.zeros_like(proc)) ** 2).sum(-1) / n
    return var.sqrt().clamp_min(1e-12)


def _token_readings(cfg, task, ref, low, reqs, device) -> Dict[str, float]:
    gen = cfg["generation"]
    k0, ks = int(gen["top_k"]), int(gen["subtalker_top_k"])
    eos = cfg["talker"]["codec_eos_token_id"]
    out = dict.fromkeys(NAMES[:4], 0.0)
    for r in reqs:
        frames = torch.as_tensor(np.asarray(r["frames"], np.int64), device=device)
        prompt, trailing, pad = task.reference_prompt(cfg, ref, r)
        logits, hidden = ref.talker_pass(prompt, trailing, pad, frames)
        rows = len(frames) + 1 if r["ended_by_eos"] else len(frames)
        proc = rt.code0_processed(logits, frames[:, 0], cfg, gen["repetition_penalty"],
                                  r["min_new_tokens"])[:rows]
        sub = ref.sub_pass(hidden, frames)
        if low is None:
            tok0 = torch.cat([frames[:, 0], torch.full((1,), eos, device=device,
                                                       dtype=torch.long)])[:rows, None]
            toks = frames[:, 1:, None]
        else:
            l_logits, l_hidden = low.talker_pass(*task.reference_prompt(cfg, low, r), frames)
            l_proc = rt.code0_processed(l_logits, frames[:, 0], cfg, gen["repetition_penalty"],
                                        r["min_new_tokens"])[:rows]
            l_sub = low.sub_pass(l_hidden, frames)
            # what the lower precision would serve: its best token (greedy),
            # or any of its own top_k (sampled)
            tok0 = l_proc.topk(1 if r["greedy"] else k0, dim=-1).indices
            toks = l_sub.topk(1 if r["greedy"] else ks, dim=-1).indices
        if r["greedy"]:
            names = ("code0_gap", "subcode_gap")
            g0, gs = rt.gaps(proc, tok0[..., 0]), rt.gaps(sub, toks[..., 0])
        else:
            names = ("code0_topk_gap", "subcode_topk_gap")
            g0, gs = rt.topk_gaps(proc, tok0, k0), rt.topk_gaps(sub, toks, ks)
        for name, g, p in zip(names, (g0, gs), (proc, sub)):
            if g.numel():
                out[name] = max(out[name], float((g / _std_units(p)).max()))
    return out


def _lead_frames(task, cfg, rec):
    """The reference frames that lead the request's stream (the task's
    `context_frames`), or None."""
    lead = getattr(task, "context_frames", None)
    return None if lead is None else lead(cfg, rec)


def _history(task, cfg, rec):
    """(the frames the request's packets are vocoded over: its reference
    frames, then its served ones; the number of reference frames)."""
    served = np.asarray(rec["frames"], np.int64)
    lead = _lead_frames(task, cfg, rec)
    if lead is None or len(lead) == 0:
        return served, 0
    lead = np.asarray(lead, np.int64)
    return np.concatenate([lead, served.reshape(-1, lead.shape[1])]), len(lead)


def _audio_reading(cfg, task, voc, reqs, device, tf32: bool) -> float:
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    worst, peak = 0.0, 0.0
    try:
        for r in reqs:
            hist, ctx0 = _history(task, cfg, r)
            hist = torch.as_tensor(hist, device=device)
            for start, count, wav in r["packets"]:
                if count == 0:
                    continue
                want = rv.packet(voc, cfg["vocoder"], hist, start, count, ctx0,
                                 r["left_context"])
                got = torch.as_tensor(np.asarray(wav, np.float32), device=device)
                worst = max(worst, float((got - want).abs().max()))
                peak = max(peak, float(want.abs().max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return worst / peak if peak > 0 else float("inf")


def readings(cfg: Dict[str, Any], seed: int, device, task, tokens: List[Dict[str, Any]],
             audio: List[Dict[str, Any]], control: bool = False) -> Dict[str, float]:
    """The five numbers, then the task's own, over the sampled requests
    (records with `frames` (n, Q), `greedy`, `ended_by_eos`, `packets`
    [(start, count, samples)], `served_inputs`, the request's inputs) of a
    mix whose task file is `task`. `control`: the control's readings
    instead. A number the task declares and does not read is NaN."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        tree = weights.talker_tree(cfg, seed, device)
        ref = rt.ReferenceTalker(cfg, tree, bits=cfg["check_bits"])
        low = rt.ReferenceTalker(cfg, tree, bits=cfg["control_bits"]) if control else None
        out = _token_readings(cfg, task, ref, low, tokens, device)
        del ref, low, tree
        voc = weights.vocoder_tree(cfg, seed, device)
        out["audio_err"] = _audio_reading(cfg, task, voc, audio, device, tf32=control)
        del voc
        own_names = getattr(task, "CHECK_NAMES", ())
        if own_names:
            own = task.check_readings(cfg, seed, device, tokens, audio, control)
            out.update({n: float(own.get(n, float("nan"))) for n in own_names})
    return out


def verdict(cfg: Dict[str, Any], values: Dict[str, float], tokens: List[Dict[str, Any]],
            compared=NAMES) -> Dict[str, Any]:
    """{name: {"value", "limit"}} of the `compared` numbers (`names(task)`),
    in that order, and whether every value is within its limit (a run whose
    token sample lacks a greedy or a sampled request is not correct)."""
    limits = cfg["check_limits"]
    table = {k: {"value": values[k], "limit": limits[k]} for k in compared}
    kinds = {bool(r["greedy"]) for r in tokens}
    ok = kinds == {True, False} and all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
                                        for v in table.values())
    return {"correct": bool(ok), "table": table}


def served_record(req: Dict[str, Any], frames: np.ndarray, packets, max_frames: int,
                  left_context: int, min_new_tokens: int,
                  served_inputs=None) -> Dict[str, Any]:
    """A finished request as the check reads it: its inputs, the served
    frames and packets (None where the run kept none), the server's
    settings that shape its tokens, and what the task's submit returned
    (`served_inputs`: what the program computed from the inputs, or None)."""
    return dict(req, frames=frames, packets=packets, ended_by_eos=len(frames) < max_frames,
                left_context=left_context, min_new_tokens=min_new_tokens,
                served_inputs=served_inputs)
