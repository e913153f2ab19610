"""Continuous-batching serving of the port against the JAX package: the
engine (`runtime/batching.py`) and `TTSServer` (`runtime/server.py`).

Both packages load the tiny checkpoints of tests/test_torch_pipeline.py and
tests/test_torch_voice_clone.py. Tolerances:
- fp32 greedy, plain route: engine codes equal the JAX engine's (bf16 and
  int8 KV), and equal across host sync granularities, staging bursts and
  admission mid-stream;
- the fused route (the talker-step twin on the CPU, the JAX kernel in
  interpret mode, bf16 weights and activations, W8A8): frame agreement
  >= 0.9 with the JAX fused engine, because a one-ulp bf16 difference can
  flip a near-tie and the row then diverges;
- server audio against `generate_custom_voice` and between packets and
  results: atol 1e-5 (the same codes; the vocoder runs other batch shapes).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
from qwen3_tts_tpu.runtime import batching as jbatch
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime.prompts import build_prompt as j_build_prompt
from qwen3_tts_tpu_torch.ops.cuda.talker_step import talker_step_fused_cache
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
from qwen3_tts_tpu_torch.runtime import batching as tbatch
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime.server import AudioPacket, AudioResult, TTSServer
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests import test_torch_voice_clone as clone
from tests.test_torch_pipeline import _models, checkpoint  # noqa: F401
from tests.test_torch_voice_clone import ckpt  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

REQ_TEXTS = ["first sample text", "the second one", "and request three",
             "a fourth, longer request", "five"]
M = 8   # max_new_tokens
AUDIO_TOL = dict(atol=1e-5, rtol=0)


def _prompts(jm, n):
    """(prompt (1, T, H), trailing (1, Tt, H), pad) per request, from the
    JAX prompt builder (streaming text layout, as the server uses)."""
    specs = jm._specs_custom_voice(REQ_TEXTS[:n], "vivian", "english", None, False)
    return [j_build_prompt(jm.talker_params, jm.config.talker_config, jm.config, s)
            for s in specs]


def _requests(mod, prompts, to, ids=None, max_frames=M - 1):
    out = []
    for i, (p, tr, pad) in enumerate(prompts):
        out.append(mod.Request(
            request_id=i if ids is None else ids[i], inputs_embeds=to(p),
            attn_mask=to(np.ones((1, p.shape[1]), np.int32)), trailing=to(tr),
            trailing_len=tr.shape[1], tts_pad=to(pad), max_frames=max_frames))
    return out


def _greedy(mod, S, **flags):
    return mod.GenerationConfig(max_new_tokens=M, sampling=S(do_sample=False),
                                subtalker=S(do_sample=False), **flags)


def _t_engine(tm, gen_cfg, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_trailing", 32)
    return tbatch.ContinuousBatchingEngine(tm.talker_params, tm.config.talker_config,
                                           gen_cfg, max_len=80, prefill_bucket=40,
                                           dtype=tm.talker_params["codec_embedding"].dtype,
                                           **kw)


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {c.request_id: c.codes for c in engine.run_until_drained()}


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_plain_route_matches_jax(checkpoint, kv_quant):  # noqa: F811
    """Three requests over two slots (the third installs when a slot
    frees): the port's fp32 greedy codes equal the JAX engine's."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    prompts = _prompts(jm, 3)
    jeng = jbatch.ContinuousBatchingEngine(
        jm.talker_params, jm.config.talker_config, _greedy(jgen, JS, kv_quant=kv_quant),
        num_slots=2, max_len=80, max_trailing=32, prefill_bucket=40, dtype=jnp.float32)
    want = _drain(jeng, _requests(jbatch, prompts, jnp.asarray))
    got = _drain(_t_engine(tm, _greedy(tgen, TS, kv_quant=kv_quant)),
                 _requests(tbatch, prompts, from_jax_tree))
    assert set(got) == set(want) == {0, 1, 2}
    for rid in want:
        assert len(got[rid]) > 0
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_engine_sync_granularity_burst_and_admission(checkpoint):  # noqa: F811
    """One reference run (3 ticks per sync); then 1 tick per sync, a burst
    of five requests over two staging rows, and requests admitted while
    others decode: every request's codes are the reference's."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    prompts = _prompts(jm, 5)
    gen_cfg = _greedy(tgen, TS)
    reqs = _requests(tbatch, prompts, from_jax_tree)
    want = _drain(_t_engine(tm, gen_cfg, ticks_per_sync=3), reqs)
    assert set(want) == set(range(5))
    for ticks in (1, 3):
        got = _drain(_t_engine(tm, gen_cfg, ticks_per_sync=ticks), reqs)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"ticks={ticks}")
    burst = _t_engine(tm, gen_cfg, staging_rows=2)
    got = _drain(burst, reqs)
    assert not burst.staged_rows_busy and not burst.pending
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    # admission mid-stream: two requests decode before the other three arrive
    eng = _t_engine(tm, gen_cfg, ticks_per_sync=2)
    for r in reqs[:2]:
        eng.submit(r)
    done = {}
    for _ in range(2):
        done.update({c.request_id: c.codes for c in eng.step()})
    assert eng.frames_acc, "the first requests should still be decoding"
    got = {**done, **_drain(eng, reqs[2:])}
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_engine_cancel_quarantine_and_zero_budget(checkpoint):  # noqa: F811
    """A request cancelled mid-stream never completes and its id stays in
    quarantine while chunks launched before the cancel are in flight; a
    zero-frame budget completes at the next step with no frames."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    reqs = _requests(tbatch, _prompts(jm, 3), from_jax_tree)
    eng = _t_engine(tm, _greedy(tgen, TS), ticks_per_sync=2)
    for r in reqs[:2]:
        eng.submit(r)
    eng.step()
    eng.step()
    assert eng._unprocessed and 0 in eng.frames_acc
    assert eng.cancel(0) and not eng.cancel(99)
    with pytest.raises(ValueError, match="already in flight"):
        eng.submit(reqs[0])            # quarantined until pre-cancel chunks sync
    zero = dataclasses.replace(reqs[2], request_id=7, max_frames=0)
    eng.submit(zero)
    out = eng.run_until_drained()
    ids = [c.request_id for c in out]
    assert 0 not in ids and ids.count(1) == 1 and ids.count(7) == 1
    assert next(c for c in out if c.request_id == 7).codes.shape == (0, 4)
    assert not eng._cancelled
    eng.submit(reqs[0])                # reusable once every chunk synced
    assert [c.request_id for c in eng.run_until_drained()] == [0]
    # a mesh-sharded engine exists since the parallel slice (its checks:
    # tests/test_torch_parallel.py); the fused step is refused under one
    with pytest.raises(ValueError, match="mesh"):
        _t_engine(tm, _greedy(tgen, TS, fused_talker_step=True), mesh=object())


@pytest.mark.parametrize("kv_quant", [False, True])
def test_engine_fused_route_agrees_with_jax(kv_quant):
    """fused_talker_step engines (the port's twin with per-row write slots,
    the JAX kernel in interpret mode), bf16 and int8 KV: sync-granularity
    invariant, and in frame agreement with the JAX fused engine."""
    from tests.test_pallas_talker_step import _tiny_talker

    cfg, params = _tiny_talker()
    rng = np.random.default_rng(11)
    B, T = 2, 8
    embeds = rng.normal(0, 0.3, (B, T, cfg.hidden_size))
    trailing = rng.normal(0, 0.3, (B, 3, cfg.hidden_size))
    prompts = [(jnp.asarray(embeds[b:b + 1], jnp.bfloat16),
                jnp.asarray(trailing[b:b + 1], jnp.bfloat16),
                jnp.zeros((1, 1, cfg.hidden_size), jnp.bfloat16)) for b in range(B)]
    flags = dict(fused_talker_step=True, kv_quant=kv_quant)
    jeng = jbatch.ContinuousBatchingEngine(params, cfg, _greedy(jgen, JS, **flags),
                                           num_slots=2, max_len=120, max_trailing=8,
                                           dtype=jnp.bfloat16, ticks_per_sync=3)
    want = _drain(jeng, _requests(jbatch, prompts, jnp.asarray, max_frames=M - 3))
    tparams = from_jax_tree(params)
    got = {}
    launches = (talker_step_fused_cache.launches, talker_step_fused_cache.launches_int8_kv)
    for ticks in (3, 1):
        eng = tbatch.ContinuousBatchingEngine(tparams, cfg, _greedy(tgen, TS, **flags),
                                              num_slots=2, max_len=120, max_trailing=8,
                                              dtype=torch.bfloat16, ticks_per_sync=ticks)
        assert eng.max_len % 128 == 0 and eng.state.cache.quantized == kv_quant
        got[ticks] = _drain(eng, _requests(tbatch, prompts, from_jax_tree,
                                           max_frames=M - 3))
    assert (talker_step_fused_cache.launches,
            talker_step_fused_cache.launches_int8_kv) == launches   # twins on the CPU
    agree, n = 0.0, 0
    for rid in range(B):
        np.testing.assert_array_equal(got[1][rid], got[3][rid])
        a, w = got[3][rid], np.asarray(want[rid])
        k = min(len(a), len(w))
        assert k > 0
        agree += (a[:k] == w[:k]).all(axis=1).sum()
        n += k
    assert agree / n >= 0.9, agree / n


def test_fused_engine_cuts_budgets_to_the_buffer():
    """A frame budget past the KV buffer is cut to it, so every per-row write
    slot stays inside (the twin raises IndexError past it, the kernel
    traps): on the fused int8-KV route with EOS banned, the request ends
    after max_len - prefill_bucket - 1 frames."""
    from tests.test_pallas_talker_step import _tiny_talker

    cfg, params = _tiny_talker()
    rng = np.random.default_rng(12)
    prompt = (jnp.asarray(rng.normal(0, 0.3, (1, 8, cfg.hidden_size)), jnp.bfloat16),
              jnp.asarray(rng.normal(0, 0.3, (1, 3, cfg.hidden_size)), jnp.bfloat16),
              jnp.zeros((1, 1, cfg.hidden_size), jnp.bfloat16))
    gen_cfg = _greedy(tgen, TS, fused_talker_step=True, kv_quant=True, min_new_tokens=10**6)
    eng = tbatch.ContinuousBatchingEngine(from_jax_tree(params), cfg, gen_cfg, num_slots=2,
                                          max_len=120, max_trailing=8, prefill_bucket=112,
                                          dtype=torch.bfloat16)
    assert eng.max_len == 128
    got = _drain(eng, _requests(tbatch, [prompt], from_jax_tree, max_frames=10**6))
    assert got[0].shape == (128 - 112 - 1, cfg.num_code_groups)


# -- TTSServer --------------------------------------------------------------


def _server(model, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("prefill_bucket", 48)
    kw.setdefault("max_trailing", 32)
    return TTSServer(model, **kw)


def test_server_results_and_streams_match_generate(checkpoint):  # noqa: F811
    """Greedy non-streamed results equal generate_custom_voice (streaming
    text layout); a streamed request's packets cover its frames in order,
    one final, and concatenate to its non-streamed audio; int16 output is
    the float result in PCM16."""
    _, tm = _models(checkpoint, jnp.float32, torch.float32)
    kw = dict(do_sample=False, subtalker_dosample=False)
    texts = REQ_TEXTS[:3]
    codes = {}
    srv = _server(tm, overrides=kw, max_new_tokens=M,
                  code_sink=lambda rid, fr: codes.setdefault(rid, []).extend(fr))
    for i, t in enumerate(texts):
        srv.submit_custom_voice(f"r{i}", text=t, speaker="vivian", language="english")
    srv.submit_custom_voice("s0", text=texts[0], speaker="vivian", language="english",
                            stream=True)
    events = srv.run_until_drained()
    assert not srv.busy
    results = {e.request_id: e for e in events if isinstance(e, AudioResult)}
    want, sr = tm.generate_custom_voice(texts, speaker="vivian", language="english",
                                        non_streaming_mode=False, max_new_tokens=M, **kw)
    assert set(results) == {"r0", "r1", "r2"}
    for i in range(3):
        assert results[f"r{i}"].sample_rate == sr and results[f"r{i}"].wav.shape == want[i].shape
        np.testing.assert_allclose(results[f"r{i}"].wav, want[i], **AUDIO_TOL)
    pkts = [e for e in events if isinstance(e, AudioPacket) and e.request_id == "s0"]
    assert pkts and pkts[-1].final and sum(p.final for p in pkts) == 1
    total = 0
    for p in pkts:
        assert p.frame_start == total and p.wav.shape[0] == p.frame_count * srv.up
        total += p.frame_count
    np.testing.assert_allclose(np.concatenate([p.wav for p in pkts]), results["r0"].wav,
                               **AUDIO_TOL)
    # the code sink saw every request's frames, in order: the same codes for
    # the same text, streamed or not
    assert set(codes) == {"r0", "r1", "r2", "s0"} and len(codes["s0"]) == total
    np.testing.assert_array_equal(np.stack(codes["s0"]), np.stack(codes["r0"]))
    pcm = _server(tm, overrides=kw, max_new_tokens=M, output_dtype="int16")
    pcm.submit_custom_voice("p", text=texts[1], speaker="vivian", language="english")
    (res,) = [e for e in pcm.run_until_drained() if isinstance(e, AudioResult)]
    assert res.wav.dtype == np.int16 and res.wav.shape == want[1].shape
    # PCM16 of the same audio: at most one step where a float difference of
    # the vocoder's batch shapes crosses a rounding boundary
    assert np.abs(res.wav - np.round(np.clip(want[1], -1, 1) * 32767)).max() <= 1


def test_server_cancel_mid_stream(checkpoint):  # noqa: F811
    _, tm = _models(checkpoint, jnp.float32, torch.float32)
    srv = _server(tm, overrides=dict(do_sample=False, subtalker_dosample=False),
                  max_new_tokens=M, packet_frames=2)
    srv.submit_custom_voice("a", text=REQ_TEXTS[0], speaker="vivian", stream=True)
    srv.submit_custom_voice("b", text=REQ_TEXTS[1], speaker="vivian", stream=True)
    seen = []
    while not any(e.request_id == "a" for e in seen):
        seen += srv.step()
    assert srv.cancel("a") and not srv.cancel("a")
    rest = srv.run_until_drained()
    assert not any(e.request_id == "a" for e in rest)
    assert [e for e in seen + rest if e.request_id == "b"][-1].final


def test_server_clone_context_is_per_request(ckpt):  # noqa: F811
    """An ICL clone stream's packets are the same alone and beside an
    x-vector-only stream: each request keeps its own vocoder context."""
    _, tm = clone._models(ckpt)
    icl, xvec = clone._prompts(tm)

    def run(items):
        srv = _server(tm, overrides=dict(do_sample=False, subtalker_dosample=False),
                      max_new_tokens=M, packet_frames=2, left_context=4, max_trailing=48,
                      prefill_bucket=96)
        for rid, item in items.items():
            srv.submit_voice_clone(rid, text="clone me please", voice_clone_prompt=[item],
                                   stream=True)
        out = {}
        for e in srv.run_until_drained():
            out.setdefault(e.request_id, []).append(e)
        return out

    alone, mixed = run({"icl": icl}), run({"icl": icl, "xv": xvec})
    assert set(mixed) == {"icl", "xv"}
    assert [p.frame_count for p in alone["icl"]] == [p.frame_count for p in mixed["icl"]]
    for a, m in zip(alone["icl"], mixed["icl"]):
        np.testing.assert_allclose(a.wav, m.wav, **AUDIO_TOL)


def test_server_fused_talker_step_default(checkpoint):  # noqa: F811
    """The server's serve step follows the model's own default: kernel 2 on
    an int8 model on a CUDA device where the talker's shapes fit it (the
    port departs here from the JAX rule, which serves the plain route
    unless asked, on the card's A/B of the two routes), the plain route on
    the CPU and, on the card, at these tiny widths, which kernel 2 does not
    take; `overrides` still chooses either, and the fused step carries whole
    128-slot KV chunks into the engine. A vocoder device on a CUDA card the
    host lacks raises."""
    from qwen3_tts_tpu_torch.ops.cuda.talker_step import config_misfit

    _, tm = _models(checkpoint, jnp.bfloat16, torch.bfloat16, quantize="int8")
    assert _server(tm).gen_cfg.fused_talker_step is False
    tm.device = torch.device("cuda")   # the default is decided by the device type
    assert config_misfit(tm.config.talker_config) is not None
    assert not tm._generation_config(tm._merge_generate_kwargs()).fused_talker_step
    assert _server(tm).gen_cfg.fused_talker_step is False
    srv = _server(tm, overrides={"fused_talker_step": True})
    assert srv.gen_cfg.fused_talker_step and srv.engine.max_len % 128 == 0
    assert _server(tm, overrides={"fused_talker_step": False}).gen_cfg.fused_talker_step is False
    srv = _server(tm, overrides={"fused_talker_step": True, "kv_quant": True})
    assert srv.gen_cfg.fused_talker_step and srv.gen_cfg.kv_quant
    assert srv.engine.max_len % 128 == 0 and srv.engine.state.cache.quantized
    # a vocoder device on a CUDA card that is absent raises (no fallback to
    # the CPU)
    with pytest.raises(RuntimeError, match="CUDA"):
        _server(tm, vocoder_device="cuda:1")
