"""The port's frame loop with a device frame counter (the form a CUDA graph
captures) and its generators' results, against the JAX package
(`runtime/generate.py`), plus the graph layer's host-side rules.

On the CPU the frame loop runs eagerly: graph capture and replay need the
card, where chip_smoke.py holds the graphed loop against the eager one
(codes, lengths and hidden states equal). Here both packages load the tiny
checkpoint of tests/test_torch_pipeline.py. Tolerances:
- fp32 greedy: codes, active flags, lengths and frame counters equal;
- hidden states: rtol 1e-4, atol 1e-4 (the same math in fp32, float sums in
  another order), and exactly zero on inactive frames.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import TTSModelConfig
from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import save_safetensors, talker_params_to_state_dict
from qwen3_tts_tpu_torch.ops.cuda import build
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_pipeline_parity import MODEL_TINY
from tests.test_torch_pipeline import TEXTS, _models, checkpoint  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

HIDDEN_TOL = dict(rtol=1e-4, atol=1e-4)
M = 12   # max_new_tokens


@pytest.fixture(scope="module")
def eos_checkpoint(checkpoint, tmp_path_factory):  # noqa: F811
    """The pipeline checkpoint with the codec head's EOS row set to 1.02x
    the row of the code greedy decoding picks most from the third frame on,
    so greedy rows reach EOS inside the budget (the fixture's own weights
    never do)."""
    path, vocoder = checkpoint
    _, tm, _, t_in, _, tcfg = _setup(checkpoint)
    codes = tgen.generate_frames(tm.talker_params, tm.config.talker_config, tcfg, *t_in,
                                 torch.Generator().manual_seed(0)).codes
    x = int(torch.mode(codes[:, 2:, 0].flatten()).values)
    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    params = random_talker_params(tc, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda v: v * 3.0, params)   # as the fixture
    head = params["codec_head"]
    params["codec_head"] = head.at[tc.codec_eos_token_id].set(1.02 * head[x])
    d = tmp_path_factory.mktemp("torch_graphs_eos_ckpt")
    save_safetensors(str(d / "model.safetensors"), talker_params_to_state_dict(params, tc))
    with open(d / "config.json", "w") as f:
        json.dump(MODEL_TINY, f)
    return str(d), vocoder


def _setup(checkpoint, non_streaming=True):  # noqa: F811
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    specs = jm._specs_custom_voice(TEXTS, "vivian", "english", None, non_streaming)
    j_in = assemble_prompt_specs(jm.talker_params, jm.config.talker_config, jm.config,
                                 specs, bucket=32)
    t_in = [from_jax_tree(x) for x in j_in]
    jcfg = jgen.GenerationConfig(max_new_tokens=M, sampling=JS(do_sample=False),
                                 subtalker=JS(do_sample=False))
    tcfg = tgen.GenerationConfig(max_new_tokens=M, sampling=TS(do_sample=False),
                                 subtalker=TS(do_sample=False))
    return jm, tm, j_in, t_in, jcfg, tcfg


def test_tensor_indexed_frame_step_and_decode_chunk_match_jax(checkpoint):  # noqa: F811
    """One frame_step, then decode_chunk over two chunks (3 frames at an
    attend bucket, then 5 at the whole buffer), greedy: frames, active
    flags, hidden rows, lengths and the frame counter equal the JAX
    package's. The port's counter is a device scalar and its state needs no
    graph context on the CPU."""
    jm, tm, j_in, t_in, jcfg, tcfg = _setup(checkpoint)
    tc = tm.config.talker_config
    T = t_in[0].shape[1]
    S = tgen.kv_capacity(tcfg, T)
    js, jc = jgen.init_decode_state(jm.talker_params, jm.config.talker_config, jcfg, *j_in,
                                    jax.random.PRNGKey(0), S)
    gen = torch.Generator().manual_seed(0)
    ts, tconst = tgen.init_decode_state(tm.talker_params, tc, tcfg, *t_in, gen, S)
    assert ts.t.ndim == 0 and ts.t.dtype == torch.int32 and ts.graphs is None
    assert tconst.prefill_len.ndim == 0 and int(tconst.prefill_len) == T

    js, jfr, jh, jact = jgen.frame_step(jm.talker_params, jm.config.talker_config,
                                        jcfg.canonical(), jc, js)
    ts, tfr, th, tact = tgen.frame_step(tm.talker_params, tc, tcfg, tconst, ts, gen)
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    np.testing.assert_array_equal(tfr.numpy(), np.asarray(jfr))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **HIDDEN_TOL)

    emitted = 1
    for k, bucket in ((3, 32), (5, None)):
        attend = None if bucket is None else tgen.attend_bucket_for(T + emitted + k + 1, S,
                                                                    bucket)
        js, jfr, jact = jgen.decode_chunk(jm.talker_params, jm.config.talker_config, jcfg,
                                          jc, js, k, attend_len=attend)
        ts, tfr, tact = tgen.decode_chunk(tm.talker_params, tc, tcfg, tconst, ts, k, gen,
                                          attend_len=attend)
        jact = np.asarray(jact)
        assert tfr.shape == (len(TEXTS), k, tc.num_code_groups)
        np.testing.assert_array_equal(tact.numpy(), jact)
        np.testing.assert_array_equal(tfr.numpy()[jact], np.asarray(jfr)[jact])
        emitted += k
    assert int(ts.t) == int(js.t) == emitted
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))


@pytest.mark.parametrize("kv_quant", [False, True])
def test_generate_frames_hidden_matches_jax(eos_checkpoint, kv_quant):
    """generate_frames' GenerationResult has the JAX package's three fields:
    codes and lengths equal, hidden (B, max_frames, H) within tolerance and
    zero from each row's length on (rows end at EOS inside the budget),
    with a bf16 and with an int8 KV cache."""
    jm, tm, j_in, t_in, jcfg, tcfg = _setup(eos_checkpoint)
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    tcfg = dataclasses.replace(tcfg, kv_quant=kv_quant)
    tc = tm.config.talker_config
    jr = jgen.generate_frames(jm.talker_params, jm.config.talker_config, jcfg, *j_in,
                              jax.random.PRNGKey(0))
    tr = tgen.generate_frames(tm.talker_params, tc, tcfg, *t_in,
                              torch.Generator().manual_seed(0))
    B, H = len(TEXTS), tc.hidden_size
    assert tr.codes.shape == (B, M - 1, tc.num_code_groups)
    assert tr.hidden.shape == np.asarray(jr.hidden).shape == (B, M - 1, H)
    assert tr.hidden.dtype == t_in[0].dtype
    np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(jr.codes))
    np.testing.assert_allclose(tr.hidden.numpy(), np.asarray(jr.hidden), **HIDDEN_TOL)
    lengths = tr.lengths.tolist()
    assert min(lengths) > 0 and max(lengths) < M - 1, lengths
    for b, n in enumerate(lengths):
        assert not tr.hidden[b, n:].any() and tr.hidden[b, :n].abs().sum(-1).all()


def test_generate_frames_chunked_hidden_is_empty(checkpoint):  # noqa: F811
    """generate_frames_chunked (chunks of 4 frames, 32-slot attend buckets):
    the codes and lengths of generate_frames and the JAX chunked generator,
    and an empty (B, 0, H) hidden, as the JAX function returns."""
    jm, tm, j_in, t_in, jcfg, tcfg = _setup(checkpoint)
    tc = tm.config.talker_config
    jr = jgen.generate_frames_chunked(jm.talker_params, jm.config.talker_config, jcfg,
                                      *j_in, jax.random.PRNGKey(0), chunk=4,
                                      attend_bucket=32)
    tr = tgen.generate_frames_chunked(tm.talker_params, tc, tcfg, *t_in,
                                      torch.Generator().manual_seed(0), chunk=4,
                                      attend_bucket=32)
    full = tgen.generate_frames(tm.talker_params, tc, tcfg, *t_in,
                                torch.Generator().manual_seed(0))
    assert tr.hidden.shape == np.asarray(jr.hidden).shape == (len(TEXTS), 0, tc.hidden_size)
    for res in (jr, full):
        np.testing.assert_array_equal(tr.codes.numpy(), np.asarray(res.codes))
        np.testing.assert_array_equal(tr.lengths.numpy(), np.asarray(res.lengths))


@pytest.mark.parametrize("chunked", [False, True])
def test_stop_at_eos_false_runs_every_frame(eos_checkpoint, chunked, monkeypatch):
    """The warm-up's route (`stop_at_eos=False`) steps every frame up to
    max_new_tokens and returns the same result as the call that stops at
    EOS (frames past EOS are inactive)."""
    _, tm, _, t_in, _, tcfg = _setup(eos_checkpoint)
    tc = tm.config.talker_config
    run = tgen.generate_frames_chunked if chunked else tgen.generate_frames
    kw = dict(chunk=4, attend_bucket=32) if chunked else {}
    stopped = run(tm.talker_params, tc, tcfg, *t_in, torch.Generator().manual_seed(0), **kw)
    assert int(stopped.lengths.max()) < M - 1    # EOS comes before the budget
    steps = []
    real = tgen.frame_step
    monkeypatch.setattr(tgen, "frame_step", lambda *a, **k: steps.append(1) or real(*a, **k))
    full = run(tm.talker_params, tc, tcfg, *t_in, torch.Generator().manual_seed(0),
               stop_at_eos=False, **kw)
    assert len(steps) == M - 1
    for a, b in zip(full, stopped):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_generation_config_canonical_matches_jax():
    """canonical() resets the knobs that travel as sampling rows and keeps
    what shapes the captured work, field for field as the JAX package."""
    kw = dict(max_new_tokens=99, min_new_tokens=3, kv_quant=True, fused_subtalker=True)
    s = dict(do_sample=True, top_k=17, top_p=0.8, temperature=0.7, repetition_penalty=1.3)
    t = tgen.GenerationConfig(sampling=TS(**s), subtalker=TS(**s), **kw).canonical()
    j = jgen.GenerationConfig(sampling=JS(**s), subtalker=JS(**s), **kw).canonical()
    for f in dataclasses.fields(t):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        assert (dataclasses.asdict(tv) if dataclasses.is_dataclass(tv) else tv) == \
            (dataclasses.asdict(jv) if dataclasses.is_dataclass(jv) else jv), f.name
    other = tgen.GenerationConfig(sampling=TS(**dict(s, temperature=1.2)),
                                  subtalker=TS(**s), **kw)
    assert other.canonical() == t and other != tgen.GenerationConfig(sampling=TS(**s),
                                                                      subtalker=TS(**s), **kw)


def test_graphs_off_the_card(checkpoint):  # noqa: F811
    """The CPU never takes the graph path, and `graphs.eager()` turns it off
    for a CUDA device too (checked by device type: no CUDA call)."""
    assert not graphs.enabled("cpu") and graphs.enabled("cuda")
    with graphs.eager():
        assert not graphs.enabled("cuda")
        with graphs.eager():
            pass
        assert not graphs.enabled("cuda")
    assert graphs.enabled("cuda")
    _, tm, _, t_in, _, tcfg = _setup(checkpoint)
    assert graphs.decode_context(tm.talker_params, tm.config.talker_config, tcfg, 2, 64,
                                 torch.float32, torch.float32, "cpu") is None
    assert graphs.stats("cpu")["captures"] == 0


def test_launch_states_pinned_by_a_graph_survive_eviction(monkeypatch):
    """`build.launch_state` evicts the least recently used unpinned states
    past MAX_CACHED; the states a capture used (collected by `pinning`)
    stay while the graph pins them, and go once it unpins."""
    monkeypatch.setattr(build, "_STATE", build.OrderedDict())
    monkeypatch.setattr(build, "MAX_CACHED", 3)
    w = [torch.zeros(2) for _ in range(8)]

    def get(i):
        return build.launch_state(("t", i), [w[i]], lambda st: None)

    with build.pinning() as used:
        a, b = get(0), get(1)
    assert used == [a, b]
    unpin = build.pin(used + [a])
    assert a.pins == b.pins == 1
    for i in range(2, 8):
        get(i)
    assert build._STATE[("t", 0, id(w[0]))] is a and build._STATE[("t", 1, id(w[1]))] is b
    assert len(build._STATE) == 3
    assert get(1) is b     # a hit, not a rebuild
    unpin()
    assert a.pins == b.pins == 0
    get(2)
    get(3)
    assert ("t", 0, id(w[0])) not in build._STATE and len(build._STATE) == 3
