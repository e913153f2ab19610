"""Plain PyTorch reference of the Qwen3-TTS 12 Hz talker and its code
predictor (sub-talker), teacher-forced over a served request.

Written from the published architecture (Qwen3 decoder layers: GQA with
per-head QK-RMSNorm, SwiGLU MLP, RMSNorm pre-norms, 1-D RoPE, since the
talker's 3-axis mrope carries identical positions for TTS) and the prompt
layout of the reference `modeling_qwen3_tts.py`. Everything runs in float32
with TF32 off; the layer matmul weights and the codec head are quantised
here, per output channel and symmetric, to `bits` (8: what the program
serves; 4: the control), from the same drawn bf16 tree the program got.
Embedding tables, norms, the text projection, the sub-talker's small-to-MTP
projection and its lm heads keep their drawn values, as the program keeps
them. No KV cache, no batching, no kernels: one causal pass over the whole
sequence of a request.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict[str, Any]
F32 = torch.float32


def quantize_rows(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-output-row quantisation of (..., O, I) to `bits`,
    returned dequantised in float32 (scale = amax / (2**(bits-1) - 1),
    clamped at 1e-12; round half to even)."""
    wf = w.to(F32)
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(wf.abs().amax(dim=-1, keepdim=True) / torch.full_like(wf[..., :1], qmax),
                        min=1e-12)
    return torch.clamp(torch.round(wf / scale), -qmax, qmax) * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, heads, D) at positions pos (T,)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32, device=x.device) / D))
    ang = pos.to(F32)[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    half = D // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


class DecoderStack:
    """One stack of decoder layers, weights dequantised to float32."""

    def __init__(self, tree: Tree, dims: Dict[str, Any], bits: Optional[int]):
        self.dims = dims
        n = tree["input_layernorm"]["weight"].shape[0]

        def mat(w):
            return quantize_rows(w, bits) if bits else w.to(F32)

        a, m = tree["self_attn"], tree["mlp"]
        self.layers = [{
            "qkv": mat(a["qkv_proj"]["weight"][i]), "o": mat(a["o_proj"]["weight"][i]),
            "gu": mat(m["gate_up_proj"]["weight"][i]), "dn": mat(m["down_proj"]["weight"][i]),
            "qn": a["q_norm"]["weight"][i].to(F32), "kn": a["k_norm"]["weight"][i].to(F32),
            "ln1": tree["input_layernorm"]["weight"][i].to(F32),
            "ln2": tree["post_attention_layernorm"]["weight"][i].to(F32),
        } for i in range(n)]

    def __call__(self, h: torch.Tensor, norm_w: torch.Tensor) -> torch.Tensor:
        """h (B, T, H) float32, causal over T, positions 0..T-1 -> normed
        hiddens (B, T, H)."""
        d = self.dims
        B, T, _ = h.shape
        Hq, Hkv, D, eps = d["heads"], d["kv_heads"], d["head_dim"], d["eps"]
        pos = torch.arange(T, device=h.device)
        causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
        for lp in self.layers:
            x = rms_norm(h, lp["ln1"], eps)
            qkv = x @ lp["qkv"].T
            q = qkv[..., :Hq * D].reshape(B, T, Hq, D)
            k = qkv[..., Hq * D:(Hq + Hkv) * D].reshape(B, T, Hkv, D)
            v = qkv[..., (Hq + Hkv) * D:].reshape(B, T, Hkv, D)
            q, k = rms_norm(q, lp["qn"], eps), rms_norm(k, lp["kn"], eps)
            q, k = rope(q, pos, d["theta"]), rope(k, pos, d["theta"])
            g = Hq // Hkv
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
            s = s.masked_fill(~causal, float("-inf"))
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v).reshape(B, T, Hq * D)
            h = h + o @ lp["o"].T
            x = rms_norm(h, lp["ln2"], eps)
            gu = x @ lp["gu"].T
            inter = gu.shape[-1] // 2
            h = h + (F.silu(gu[..., :inter]) * gu[..., inter:]) @ lp["dn"].T
        return rms_norm(h, norm_w, eps)


class ReferenceTalker:
    """The talker and sub-talker of configuration `cfg` over the drawn tree
    `tree` (bf16, the layout of `portbench/weights.py`), quantised to
    `bits`."""

    def __init__(self, cfg: Dict[str, Any], tree: Tree, bits: Optional[int] = 8):
        t, cp = cfg["talker"], cfg["code_predictor"]
        self.cfg, self.tree = cfg, tree
        self.t = t
        self.Q = t["num_code_groups"]
        self.talker = DecoderStack(tree["layers"], dict(
            heads=t["num_attention_heads"], kv_heads=t["num_key_value_heads"],
            head_dim=t["head_dim"], eps=t["rms_norm_eps"], theta=t["rope_theta"]), bits)
        self.head = quantize_rows(tree["codec_head"], bits) if bits else tree["codec_head"].to(F32)
        sub = tree["code_predictor"]
        self.sub = DecoderStack(sub["layers"], dict(
            heads=cp["num_attention_heads"], kv_heads=cp["num_key_value_heads"],
            head_dim=cp["head_dim"], eps=cp["rms_norm_eps"], theta=cp["rope_theta"]), bits)
        self.sub_heads = sub["lm_heads"].to(F32)
        self.sub_emb = sub["embeddings"]          # (Q-1, Vc, H), kept in its dtype
        self.proj = sub["proj"]

    # -- prompt assembly ------------------------------------------------

    def _text(self, ids: Sequence[int]) -> torch.Tensor:
        tp = self.tree["text_projection"]
        dev = self.head.device
        x = self.tree["text_embedding"][torch.as_tensor(np.asarray(ids, np.int64), device=dev)]
        x = x.to(F32)
        x = F.silu(x @ tp["linear_fc1"]["weight"].to(F32).T + tp["linear_fc1"]["bias"].to(F32))
        return x @ tp["linear_fc2"]["weight"].to(F32).T + tp["linear_fc2"]["bias"].to(F32)

    def _codec(self, ids: Sequence[int]) -> torch.Tensor:
        dev = self.head.device
        return self.tree["codec_embedding"][torch.as_tensor(list(ids), device=dev)].to(F32)

    def frame_embed(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, Q) codes -> (n, H): codebook 0 from the talker's table, the
        rest from the code predictor's."""
        out = self.tree["codec_embedding"][frames[:, 0].long()].to(F32)
        for j in range(1, self.Q):
            out = out + self.sub_emb[j - 1][frames[:, j].long()].to(F32)
        return out

    def _prefix(self, req: Dict[str, Any]):
        """The rows every streaming prompt starts with: the role, then the
        think block (with the language), the speaker and codec_pad over
        tts_pad ... tts_bos. Returns (prefix (P, H), the codec_bos row,
        tts_eos, tts_pad, the request's text ids)."""
        t, tts = self.t, self.cfg["tts"]
        dev = self.head.device
        ids = [int(x) for x in req["input_id"]]
        pad_bos_eos = self._text([tts["tts_bos_token_id"], tts["tts_eos_token_id"],
                                  tts["tts_pad_token_id"]])
        tts_bos, tts_eos, tts_pad = pad_bos_eos[0], pad_bos_eos[1], pad_bos_eos[2]
        if req.get("language_id") is None:
            think = [t["codec_nothink_id"], t["codec_think_bos_id"], t["codec_think_eos_id"]]
        else:
            think = [t["codec_think_id"], t["codec_think_bos_id"], int(req["language_id"]),
                     t["codec_think_eos_id"]]
        codec = self._codec(think + [t["codec_pad_id"], t["codec_bos_id"]])
        bos_row = codec[-1]
        parts = [codec[:-2]]
        if req.get("speaker_embed") is not None:
            spk = torch.as_tensor(req["speaker_embed"]).to(device=dev, dtype=F32)
            parts.append(spk.reshape(1, -1))
        parts.append(codec[-2:])
        codec_embed = torch.cat(parts)                               # (m, H)
        m = codec_embed.shape[0]
        text_track = torch.cat([tts_pad.expand(m - 2, -1), tts_bos[None]])
        prefix = torch.cat([self._text(ids[:3]), text_track + codec_embed[:-1]])
        return prefix, bos_row, tts_eos, tts_pad, ids

    def prompt(self, req: Dict[str, Any]):
        """The streaming prompt of one request: (embeds (T, H), trailing
        text (Tt, H), tts_pad (H,)). `req` holds `input_id` (the tokenized
        assistant text), `language_id` (None: auto) and `speaker_embed`
        ((H,) tensor or None)."""
        prefix, bos_row, tts_eos, tts_pad, ids = self._prefix(req)
        prompt = torch.cat([prefix, self._text(ids[3:4]) + bos_row[None]])
        trailing = torch.cat([self._text(ids[4:-5]), tts_eos[None]])
        return prompt, trailing, tts_pad

    def icl_prompt(self, req: Dict[str, Any]):
        """The streaming voice-clone (ICL) prompt of one request, the layout
        of the published `generate_icl_prompt` with `non_streaming_mode`
        off: (embeds (T, H), trailing text (Tt, H), tts_pad (H,)). `req`
        holds what `prompt` takes (`speaker_embed`: the request's speaker
        embedding) and `ref_id` (the tokenized reference text,
        `<|im_start|>assistant\\n{text}<|im_end|>\\n`) and `ref_code` ((n, Q)
        reference codes). After the prefix, the reference text, the target
        text and tts_eos lie position by position over codec_bos and each
        reference frame's embeddings summed over its codebooks; a longer
        text leaves the rest as the trailing text, a shorter one is padded
        with tts_pad (and tts_pad trails). Departures: only the streaming
        layout (the server's); the speaker embedding is taken in float32 as
        given, where the published model holds it in its own dtype."""
        prefix, bos_row, tts_eos, tts_pad, ids = self._prefix(req)
        ref_ids = [int(x) for x in req["ref_id"]]
        text = torch.cat([self._text(ref_ids[3:-2] + ids[3:-5]), tts_eos[None]])
        codes = torch.as_tensor(np.asarray(req["ref_code"], np.int64), device=bos_row.device)
        codec = torch.cat([bos_row[None], self.frame_embed(codes)])
        t_len, c_len = text.shape[0], codec.shape[0]
        if t_len > c_len:
            icl, trailing = text[:c_len] + codec, text[c_len:]
        else:
            icl = torch.cat([text, tts_pad.expand(c_len - t_len, -1)]) + codec
            trailing = tts_pad[None]
        return torch.cat([prefix, icl]), trailing, tts_pad

    # -- teacher-forced passes ------------------------------------------

    def talker_pass(self, prompt: torch.Tensor, trailing: torch.Tensor, tts_pad: torch.Tensor,
                    frames: torch.Tensor):
        """The talker over the prompt and the served frames (n, Q): the
        code-0 logits before each frame and after the last ((n + 1, V)), and
        the hidden that conditions each frame's sub-talker ((n, H))."""
        n = frames.shape[0]
        text = torch.stack([trailing[i] if i < trailing.shape[0] else tts_pad
                            for i in range(n)]) if n else prompt[:0]
        x = torch.cat([prompt, self.frame_embed(frames) + text]) if n else prompt
        h = self.talker(x[None], self.tree["norm"]["weight"])[0]
        T = prompt.shape[0]
        hid = h[T - 1:]                                              # (n + 1, H)
        return hid @ self.head.T, hid[:n]

    def sub_pass(self, hidden: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """The sub-talker over each served frame, teacher-forced: the logits
        of codebooks 1..Q-1 ((n, Q-1, Vc))."""
        emb = [self.tree["codec_embedding"][frames[:, 0].long()].to(F32)]
        emb += [self.sub_emb[j - 1][frames[:, j].long()].to(F32) for j in range(1, self.Q - 1)]
        x = torch.stack([hidden] + emb, dim=1)                        # (n, Q, H)
        if self.proj is not None:
            x = x @ self.proj["weight"].to(F32).T + self.proj["bias"].to(F32)
        h = self.sub(x, self.tree["code_predictor"]["norm"]["weight"])
        return torch.einsum("njc,jvc->njv", h[:, 1:], self.sub_heads)


def code0_processed(logits: torch.Tensor, code0: torch.Tensor, cfg: Dict[str, Any],
                    penalty: float, min_new_tokens: int) -> torch.Tensor:
    """The code-0 logits as the sampler ranks them, HF-generate's order:
    the repetition penalty over the code-0 ids emitted before each step,
    the suppressed ids (the top 1024 of the vocabulary but EOS) and EOS
    banned before `min_new_tokens` frames. logits (n + 1, V); code0 (n,)
    the served frames' code 0."""
    t = cfg["talker"]
    V, eos = t["vocab_size"], t["codec_eos_token_id"]
    out = logits.clone()
    seen = torch.zeros(V, dtype=torch.bool, device=logits.device)
    for i in range(out.shape[0]):
        if i and penalty != 1.0:
            seen[int(code0[i - 1])] = True
            row = out[i]
            out[i] = torch.where(seen, torch.where(row > 0, row / penalty, row * penalty), row)
    ids = torch.arange(V, device=logits.device)
    out[:, (ids >= V - 1024) & (ids != eos)] = float("-inf")
    out[:min_new_tokens, eos] = float("-inf")
    return out


def gaps(processed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the best of its row."""
    best = processed.max(dim=-1).values
    return best - processed.gather(-1, tokens.long()[..., None])[..., 0]


def topk_gaps(processed: torch.Tensor, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """How far the lowest of each row's tokens (tokens (..., m)) lies below
    the k-th best logit of its row, or 0 where every one is within it."""
    kth = processed.topk(k, dim=-1).values[..., -1]
    worst = processed.gather(-1, tokens.long()).min(dim=-1).values
    return torch.clamp(kth - worst, min=0)
