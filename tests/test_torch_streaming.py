"""Streaming synthesis of the port against the JAX package: `decode_chunk`,
`StreamingSession`, the API's post-EOS silencing and `stream_voice_clone`
with per-row vocoder context.

Both packages load the tiny checkpoints of tests/test_torch_pipeline.py and
tests/test_torch_voice_clone.py. Tolerances:
- fp32 greedy: frame starts, frame counts and per-row active frames equal;
  packet waveforms atol 1e-4 (the vocoder's fp32 convolutions sum in
  another order, as the pipeline tests hold whole waveforms);
- `decode_chunk` against the frame loop of the port itself: codes equal,
  sampled (both draw the same noise from one generator in one order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime import streaming as jstream
from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime import streaming as tstream
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests import test_torch_voice_clone as clone
from tests.test_torch_voice_clone import ckpt  # noqa: F401
from tests.test_torch_pipeline import TEXTS, _models, checkpoint  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

SMALL = dict(warmup_schedule=(2, 3), steady_chunk=4, vocoder_left_context=3)
WAV_TOL = dict(atol=1e-4, rtol=0)


def _inputs(jm, non_streaming=False):
    specs = jm._specs_custom_voice(TEXTS, "vivian", "english", None, non_streaming)
    return assemble_prompt_specs(jm.talker_params, jm.config.talker_config, jm.config,
                                 specs, bucket=32)


def test_decode_chunk_equals_frame_loop(checkpoint):  # noqa: F811
    """Chunks of 2, 4 and 5 frames (attend buckets of 32 slots) give the
    codes and lengths of generate_frames, sampled, from one seed."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    tc = tm.config.talker_config
    inputs = [from_jax_tree(x) for x in _inputs(jm)]
    gen_cfg = tgen.GenerationConfig(max_new_tokens=12,
                                    sampling=TS(do_sample=True, top_k=20, temperature=1.0),
                                    subtalker=TS(do_sample=True, top_k=20))
    base = tgen.generate_frames(tm.talker_params, tc, gen_cfg, *inputs,
                                torch.Generator().manual_seed(11))
    T = inputs[0].shape[1]
    S = tgen.kv_capacity(gen_cfg, T)
    gen = torch.Generator().manual_seed(11)
    state, const = tgen.init_decode_state(tm.talker_params, tc, gen_cfg, *inputs, gen, S)
    frames, actives, emitted = [], [], 0
    for k in (2, 4, 5):
        attend = tgen.attend_bucket_for(T + emitted + k + 1, S, 32)
        state, fr, act = tgen.decode_chunk(tm.talker_params, tc, gen_cfg, const, state, k,
                                           gen, attend_len=attend)
        assert fr.shape == (len(TEXTS), k, tc.num_code_groups) and act.shape == fr.shape[:2]
        frames.append(fr)
        actives.append(act)
        emitted += k
    codes, active = torch.cat(frames, dim=1), torch.cat(actives, dim=1)
    lens = active.sum(dim=1)
    np.testing.assert_array_equal(lens.numpy(), base.lengths.numpy())
    for b in range(len(TEXTS)):
        np.testing.assert_array_equal(codes[b, :lens[b]].numpy(),
                                      base.codes[b, :lens[b]].numpy())


@pytest.mark.parametrize("kv_quant", [False, True])
def test_streaming_session_matches_jax(checkpoint, kv_quant):  # noqa: F811
    """fp32 greedy StreamingSession: the same packets as the JAX session,
    with a bf16 and with an int8 KV cache."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    tc = jm.config.talker_config
    inputs = _inputs(jm)
    flags = dict(max_new_tokens=12, kv_quant=kv_quant)
    jsess = jstream.StreamingSession(
        jm.talker_params, tc,
        jgen.GenerationConfig(sampling=JS(do_sample=False), subtalker=JS(do_sample=False),
                              **flags),
        jm.speech_tokenizer.dec_params, jm.speech_tokenizer.config.decoder_config,
        jstream.StreamingConfig(**SMALL))
    tsess = tstream.StreamingSession(
        tm.talker_params, tc,
        tgen.GenerationConfig(sampling=TS(do_sample=False), subtalker=TS(do_sample=False),
                              **flags),
        tm.speech_tokenizer.dec_params, tm.speech_tokenizer.config.decoder_config,
        tstream.StreamingConfig(**SMALL))
    want = list(jsess.run(*inputs, jax.random.PRNGKey(0)))
    got = list(tsess.run(*[from_jax_tree(x) for x in inputs], torch.Generator()))
    assert len(got) == len(want) >= 2
    assert got[0].frame_count == 2    # the first packet after the warm-up chunk
    for g, w in zip(got, want):
        assert (g.frame_start, g.frame_count) == (w.frame_start, w.frame_count)
        np.testing.assert_array_equal(g.active_frames, np.asarray(w.active_frames))
        assert g.wav.dtype == np.float32 and g.wav.shape == w.wav.shape
        np.testing.assert_allclose(g.wav, w.wav, **WAV_TOL)
    wavs, first = tsess.synthesize(*[from_jax_tree(x) for x in inputs], torch.Generator())
    lens = sum(p.active_frames for p in got)
    assert first > 0
    assert [w.shape[0] for w in wavs] == [int(n) * tm.speech_tokenizer.config.
                                          decoder_config.total_upsample for n in lens]


def test_stream_api_silences_rows_after_eos(checkpoint, monkeypatch):  # noqa: F811
    """The API's post-EOS handling, on packets where row 0 stops early: its
    samples past its last active frame are zero and columns no row uses
    are dropped, as the JAX package's `_stream_run` does."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    up = tm.speech_tokenizer.config.decoder_config.total_upsample
    rng = np.random.default_rng(5)
    packets = [(0, 3, [3, 3]), (3, 4, [1, 4]), (7, 4, [0, 2]), (11, 2, [0, 0])]

    class FakeSession:
        def __init__(self, *a, **k):
            pass

        def run(self, *a, **k):
            for start, count, active in packets:
                yield tstream.StreamPacket(
                    wav=rng.uniform(-1, 1, (2, count * up)).astype(np.float32),
                    frame_start=start, frame_count=count,
                    active_frames=np.asarray(active), latency_s=0.01)

    monkeypatch.setattr(tstream, "StreamingSession", FakeSession)
    out = list(tm.stream_custom_voice(TEXTS, speaker="vivian", language="english",
                                      do_sample=False, subtalker_dosample=False,
                                      max_new_tokens=4))
    assert len(out) == 3   # the all-inactive packet yields nothing
    for (wav, sr), (_, count, active) in zip(out, packets):
        assert sr == 1000 and wav.dtype == np.float32
        assert wav.shape == (2, max(active) * up)
        for b, n in enumerate(active):
            assert (wav[b, n * up:] == 0).all()
            assert (wav[b, :n * up] != 0).all()


def test_stream_voice_clone_mixed_context_matches_jax(ckpt):
    """stream_voice_clone on a batch of one ICL and one x-vector-only item:
    the same packets as the JAX package (fp32 greedy), the ICL row with its
    own reference frames as vocoder context and the x-vector row with none;
    and the ICL row alone streams the same audio as in the mixed batch."""
    jm, tm = clone._models(ckpt)
    items = clone._prompts(tm)
    kw = dict(language="english", voice_clone_prompt=items, seed=0, **clone.GREEDY)
    want = list(jm.stream_voice_clone(clone.TEXTS, **kw))
    got = list(tm.stream_voice_clone(clone.TEXTS, **kw))
    assert len(got) == len(want) >= 2
    for (g, sr), (w, _) in zip(got, want):
        assert sr == 1000 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **WAV_TOL)
    alone = list(tm.stream_voice_clone(clone.TEXTS[:1], language="english",
                                       voice_clone_prompt=items[:1], seed=0,
                                       **clone.GREEDY))
    mixed_icl = np.concatenate([g[0] for g, _ in got])
    alone_icl = np.concatenate([g[0] for g, _ in alone])
    n = alone_icl.shape[0]
    assert n > 0 and mixed_icl[:n].shape == alone_icl.shape
    np.testing.assert_allclose(mixed_icl[:n], alone_icl, **WAV_TOL)
