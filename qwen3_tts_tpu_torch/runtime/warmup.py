"""Serving warm-up: pay the one-time costs before live traffic does
(counterpart of `qwen3_tts_tpu/runtime/warmup.py`).

The JAX package compiles its generation programs at first use; a server
calls `warmup_model` once at startup so that live traffic only hits the jit
cache. The port's first-use costs are the kernels' nvcc build (the first
launch builds the library from csrc/), the capture of the frame loop's CUDA
graphs of each (batch, prefill bucket) and of the vocoder's whole-call
decode graphs of each batch (runtime/graphs.py), and cuDNN's choice of
convolution for the vocoder. The decode contexts live in a bounded LRU
(graphs.MAX_CONTEXTS), so warm at most that many (batch, bucket) pairs.

`warmup_model` warms the generate / stream API; a `TTSServer` has its own
warm-up, `TTSServer.warmup` (every serve-tick graph, the staging prefill,
the egress, first-packet and completion vocoder shapes).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch


def warmup_model(model, prefill_buckets: Sequence[int] = (32, 64),
                 batch_sizes: Sequence[int] = (1,),
                 max_new_tokens: Optional[int] = None,
                 verbose: bool = True) -> float:
    """Run the generation path once per (batch, prefill bucket), routed
    exactly like `Qwen3TTSModel._run` (generate_frames up to 1024 new
    tokens, chunked above), through every frame up to max_new_tokens, so
    each graph a call of that shape can replay is captured; then vocode the
    codes once, which captures the whole-call decode graphs of that batch.
    On the CPU this runs the eager loop and captures nothing.

    `model`: a Qwen3TTSModel. Returns the warm-up's seconds."""
    from .generate import generate_frames, generate_frames_chunked

    cfg = model.config.talker_config
    kw = model._merge_generate_kwargs()
    if max_new_tokens is not None:
        kw["max_new_tokens"] = max_new_tokens
    gen_cfg = model._generation_config(kw)
    run = (generate_frames_chunked if gen_cfg.max_new_tokens > 1024
           else generate_frames)

    t0 = time.time()
    params = model.talker_params
    dtype = params["codec_embedding"].dtype
    dev, H = model.device, cfg.hidden_size
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for B in batch_sizes:
            for L in prefill_buckets:
                embeds = torch.zeros((B, L, H), dtype=dtype, device=dev)
                mask = torch.ones((B, L), dtype=torch.int32, device=dev)
                trailing = torch.zeros((B, 32, H), dtype=dtype, device=dev)
                pad = torch.zeros((1, 1, H), dtype=dtype, device=dev)
                out = run(params, cfg, gen_cfg, embeds, mask, trailing, pad, gen,
                          stop_at_eos=False)
                if model.speech_tokenizer is not None:
                    codes = out.codes[:, :max(1, gen_cfg.max_new_tokens - 1)].cpu().numpy()
                    model.speech_tokenizer.decode([{"audio_codes": c} for c in codes])
                else:
                    out.lengths.cpu()
                if verbose:
                    print(f"[warmup] B={B} L={L} done at {time.time() - t0:.1f}s")
    return time.time() - t0
