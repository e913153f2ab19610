"""The vocoder's graphed programs and the serving warm-up of the port
against the JAX package.

- the server's packet egress (`_vocode_rows_compact`), its first-packet
  extract (`_first_packet_extract`, and the extract + vocoder program
  `_first_packet_vocode`), the stream's `_vocode_slice` and the tokenizer's
  whole-call decode: the same numpy-seeded codes through both packages'
  functions, with the vocoder tree carried across by `from_jax_tree`;
- the warm-up plan: the engine's attend buckets, the staging buckets, the
  server's egress shapes (`qwen3_tts_tpu/runtime/server.py::TTSServer.warmup`);
- greedy engine codes after `warmup_staging`, and a server's after
  `TTSServer.warmup`;
- `graphs.CodecGraphs`' keys, LRU and copies, with a stand-in for the CUDA
  capture (the real one runs only on the card: chip_smoke.py's
  `codec_graphs` and `server_warmup` phases).

Tolerances: float samples within 1e-5 (the same fp32 math; the
convolutions sum in another order), PCM16 samples and integer outputs
exactly; greedy codes exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.models.codec12 import decoder as jdec
from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
from qwen3_tts_tpu.runtime import batching as jbatch
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime import server as jserver
from qwen3_tts_tpu.runtime import streaming as jstream
from qwen3_tts_tpu.utils.testing import random_vocoder_params
from qwen3_tts_tpu_torch.models.codec12 import decoder as tdec
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
from qwen3_tts_tpu_torch.runtime import batching as tbatch
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.runtime import server as tserver
from qwen3_tts_tpu_torch.runtime import streaming as tstream
from qwen3_tts_tpu_torch.runtime.server import AudioPacket, AudioResult, TTSServer
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_pipeline import DEC_CFG, _models, checkpoint  # noqa: F401
from tests.test_torch_serving import REQ_TEXTS, _prompts, _requests

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

FLOAT_TOL = dict(atol=1e-5, rtol=0)
Q = DEC_CFG.num_quantizers
UP = DEC_CFG.total_upsample


@pytest.fixture(scope="module")
def vocoder():
    """One tiny vocoder tree: (JAX tree, the port's tree)."""
    tree = random_vocoder_params(DEC_CFG, jax.random.PRNGKey(5))
    return tree, from_jax_tree(tree)


def _codes(rng, *shape):
    """Codes with out-of-range ids at both ends (both packages clamp)."""
    return rng.integers(-3, DEC_CFG.codebook_size + 3, shape).astype(np.int32)


@pytest.mark.parametrize("pcm16", [False, True])
def test_vocode_rows_compact_matches_jax(vocoder, pcm16):
    """Server egress: rows of (C + F) codes cut at each row's context."""
    jp, tp = vocoder
    rng = np.random.default_rng(0)
    C, F_ = 6, 4
    codes, ctx = _codes(rng, 3, Q, C + F_), np.array([0, 6, 3], np.int32)
    want = np.asarray(jserver._vocode_rows_compact(jp, DEC_CFG, jnp.asarray(codes),
                                                   jnp.asarray(ctx), F=F_, pcm16=pcm16))
    got = tserver._vocode_rows_compact(tp, DEC_CFG, torch.from_numpy(codes),
                                       torch.from_numpy(ctx), F_, pcm16=pcm16).numpy()
    assert got.shape == want.shape == (3, F_ * UP) and got.dtype == want.dtype
    if pcm16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FLOAT_TOL)


def _aux(rng, B, ticks, K):
    """A packed chunk aux (serve_chunk's layout): slot 0 holds request 7
    from tick 1, slot 1 request 3 for ticks 0-1 then request 9 from tick 2,
    slot 2 emits nothing; random frames."""
    frames = _codes(rng, B, ticks, Q).clip(0)
    req = np.full((B, ticks), -1, np.int32)
    emit = np.zeros((B, ticks), np.int32)
    req[0, 1:], emit[0, 1:] = 7, 1
    req[1, :2], emit[1, :2] = 3, 1
    req[1, 2:], emit[1, 2:] = 9, 1
    tail = np.zeros(B * ticks + 2 * K + B, np.int32)
    return np.concatenate([frames.reshape(-1), emit.reshape(-1), req.reshape(-1), tail])


@pytest.mark.parametrize("pcm16", [False, True])
def test_first_packet_extract_and_vocode_match_jax(vocoder, pcm16):
    """The first-packet extract (rids 7, 3, 9, an absent 5 and -1 padding)
    equals the JAX one exactly; extract + vocoder equals the JAX extract
    then `_vocode_rows_compact` at zero context."""
    jp, tp = vocoder
    B, ticks, K, F_ = 3, 5, 4, 4
    T = 3 + F_
    aux = _aux(np.random.default_rng(1), B, ticks, K)
    rids = np.array([7, 3, 9, 5, -1, -1], np.int32)
    jcodes, jcounts = jserver._first_packet_extract(jnp.asarray(aux), jnp.asarray(rids), B=B,
                                                    ticks=ticks, Q=Q, F=F_, T=T)
    tcodes, tcounts = tserver._first_packet_extract(torch.from_numpy(aux),
                                                    torch.from_numpy(rids), B, ticks, Q, F_, T)
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert list(tcounts.numpy()) == [4, 2, 3, 0, 0, 0]
    want = np.asarray(jserver._vocode_rows_compact(jp, DEC_CFG, jcodes,
                                                   jnp.zeros((len(rids),), jnp.int32), F=F_,
                                                   pcm16=pcm16))
    wav, counts = tserver._first_packet_vocode(tp, DEC_CFG, torch.from_numpy(aux),
                                               torch.from_numpy(rids), B, ticks, Q, F_, T,
                                               pcm16=pcm16)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    if pcm16:
        np.testing.assert_array_equal(wav.numpy(), want)
    else:
        np.testing.assert_allclose(wav.numpy(), want, **FLOAT_TOL)


@pytest.mark.parametrize("emit_start,k,ctx_cap", [(0, 1, 0), (3, 4, 3), (9, 5, 6)])
def test_vocode_slice_matches_jax(vocoder, emit_start, k, ctx_cap):
    """A stream's packet: k new frames per row with per-row left context
    (rows with no, some and capped context)."""
    jp, tp = vocoder
    rng = np.random.default_rng(emit_start)
    buf = _codes(rng, 3, Q, 16).astype(np.int64)
    ctx = np.array([0, min(2, emit_start), emit_start], np.int64)
    want = np.asarray(jstream._vocode_slice(jp, DEC_CFG, jnp.asarray(buf), jnp.asarray(ctx),
                                            emit_start, k=k, ctx_cap=ctx_cap))
    got = tstream._vocode_slice(tp, DEC_CFG, torch.from_numpy(buf), torch.from_numpy(ctx),
                                emit_start, k, ctx_cap)
    assert got.shape == want.shape == (3, k * UP)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLOAT_TOL)


@pytest.mark.parametrize("pcm16", [False, True])
def test_chunked_decode_matches_jax(vocoder, pcm16):
    """Whole-call decode: a first chunk and two steady chunks with left
    context; PCM16 inside each chunk equals the JAX compiled decode's
    `to_pcm16`."""
    jp, tp = vocoder
    codes = _codes(np.random.default_rng(3), 2, Q, 18).clip(0)
    want = jdec.chunked_decode(jp, DEC_CFG, jnp.asarray(codes), chunk_size=6,
                               left_context_size=3)
    want = np.asarray(jdec.to_pcm16(want) if pcm16 else want)
    got = tdec.chunked_decode(tp, DEC_CFG, torch.from_numpy(codes), chunk_size=6,
                              left_context_size=3, pcm16=pcm16).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if pcm16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **FLOAT_TOL)


def _greedy(mod, S):
    return mod.GenerationConfig(max_new_tokens=24, sampling=S(do_sample=False),
                                subtalker=S(do_sample=False))


def _engines(checkpoint, max_len, staging_rows=None):  # noqa: F811
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    kw = dict(num_slots=2, max_len=max_len, max_trailing=32, prefill_bucket=40,
              staging_rows=staging_rows)
    jeng = jbatch.ContinuousBatchingEngine(jm.talker_params, jm.config.talker_config,
                                           _greedy(jgen, JS), dtype=jnp.float32, **kw)
    teng = tbatch.ContinuousBatchingEngine(tm.talker_params, tm.config.talker_config,
                                           _greedy(tgen, TS), dtype=torch.float32, **kw)
    return jm, tm, jeng, teng


@pytest.mark.parametrize("max_len", [256, 640, 3072])
def test_attend_buckets_match_jax(checkpoint, max_len):  # noqa: F811
    _, _, jeng, teng = _engines(checkpoint, max_len)
    assert teng._attend_buckets() == list(jeng._attend_buckets())
    assert teng._attend_buckets()[-1] == max_len
    # on the CPU the ticks run eagerly: nothing to capture
    assert teng._graphs is None and teng.warmup_serve() >= 0


def test_warmup_staging_buckets_and_untouched_state(checkpoint, monkeypatch):  # noqa: F811
    """Both engines prefill the buckets up to staging_rows (3: buckets 1
    and 2) with all-invalid rows, and the port's slot state is untouched."""
    _, _, jeng, teng = _engines(checkpoint, 80, staging_rows=3)
    seen = {"jax": [], "torch": []}
    for mod, tag in ((jbatch, "jax"), (tbatch, "torch")):
        real = mod.stage_requests

        def rec(params, cfg, state, gen_cfg, embeds, *a, real=real, tag=tag, **k):
            seen[tag].append(len(embeds))
            return real(params, cfg, state, gen_cfg, embeds, *a, **k)

        monkeypatch.setattr(mod, "stage_requests", rec)
    before = {f: getattr(teng.state, f) for f in vars(teng.state)}
    before = {f: (v.clone() if torch.is_tensor(v) else [t.clone() for t in vars(v).values()
                                                        if t is not None])
              for f, v in before.items()}
    jeng.warmup_staging()
    teng.warmup_staging()
    assert seen["torch"] == seen["jax"] == [1, 2]
    assert teng._tts_pad_dev is None
    for f, v in before.items():
        now = getattr(teng.state, f)
        now = [now] if torch.is_tensor(now) else [t for t in vars(now).values() if t is not None]
        for a, b in zip(now, v if isinstance(v, list) else [v]):
            assert torch.equal(a, b), f


def _drain(engine, reqs):
    for r in reqs:
        engine.submit(r)
    return {c.request_id: c.codes for c in engine.run_until_drained()}


def test_codes_unchanged_by_warmup_staging(checkpoint):  # noqa: F811
    """Three greedy requests over two slots with 4 tokens of trailing text
    each and 23 frames, so every row reads the pad embedding after its
    fourth frame: the port's codes after `warmup_staging` equal its codes
    without it and the JAX engine's without it. The JAX engine's own
    warm-up keeps the zero pad embedding it warmed with for every later
    request, so its codes after it differ."""
    jm, _, jeng, teng = _engines(checkpoint, 80)
    prompts = [(p, tr[:, :4], pad) for p, tr, pad in _prompts(jm, 3)]
    want = _drain(jeng, _requests(jbatch, prompts, jnp.asarray, max_frames=23))
    cold = _drain(teng, _requests(tbatch, prompts, from_jax_tree, max_frames=23))
    _, _, jwarm_eng, warm_eng = _engines(checkpoint, 80)
    warm_eng.warmup_staging()
    warm = _drain(warm_eng, _requests(tbatch, prompts, from_jax_tree, max_frames=23))
    assert set(warm) == set(cold) == set(want) == {0, 1, 2}
    for rid in want:
        assert len(warm[rid]) > 4
        np.testing.assert_array_equal(cold[rid], np.asarray(want[rid]))
        np.testing.assert_array_equal(warm[rid], cold[rid])
    jwarm_eng.warmup_staging()
    jwarm = _drain(jwarm_eng, _requests(jbatch, prompts, jnp.asarray, max_frames=23))
    assert not all(np.array_equal(np.asarray(jwarm[r]), np.asarray(want[r])) for r in want)


@pytest.mark.parametrize("num_slots,packet_frames", [(1, 25), (6, 25), (8, 3)])
def test_server_egress_shapes_follow_the_jax_rule(checkpoint, num_slots,  # noqa: F811
                                                  packet_frames):
    """(N, T, F) of the warm-up's egress vocoder calls. The (N, F) pairs
    are the JAX rule's: N over 1, 2, 4, ... below num_slots, then
    num_slots; F over {_frame_bucket(1), _frame_bucket(packet_frames)}
    (qwen3_tts_tpu/runtime/server.py:297-306). The port's rule adds the
    frames vocoded: T = F (no row has context) and T = left_context + F.
    Every piece `_vocode_wave` can cut from a wave is among them, and the
    fast first packet's shapes are the row buckets at T = F =
    _frame_bucket(1)."""
    _, tm = _models(checkpoint, jnp.float32, torch.float32)
    srv = TTSServer(tm, num_slots=num_slots, packet_frames=packet_frames, prefill_bucket=48,
                    max_trailing=32, max_new_tokens=8)
    n, combos = 1, []
    while n < num_slots:
        combos.append(n)
        n <<= 1
    combos.append(num_slots)
    fset = sorted({srv._frame_bucket(1), srv._frame_bucket(packet_frames)})
    lc = srv.left_context
    assert srv.egress_shapes() == [(N, T, F_) for N in sorted(set(combos)) for F_ in fset
                                   for T in (F_, lc + F_)]
    live = {(N, F_ + c, F_) for d in range(1, num_slots + 1)
            for F_ in {srv._frame_bucket(k) for k in range(1, packet_frames + 1)}
            for c in (0, lc) for N in srv._row_pieces(d, F_ + c)}
    assert live <= set(srv.egress_shapes())
    f = srv._frame_bucket(1)
    assert srv.first_packet_shapes() == [(N, f, f) for N in sorted(set(combos))]


def test_server_warmup_runs_eagerly_and_keeps_results(checkpoint):  # noqa: F811
    """`TTSServer.warmup` on the CPU runs the egress, first-packet and
    completion vocoder calls eagerly (every egress shape once) and captures
    nothing; the warmed server's greedy results and packets equal a cold
    server's."""
    _, tm = _models(checkpoint, jnp.float32, torch.float32)
    kw = dict(num_slots=2, prefill_bucket=48, max_trailing=32, max_new_tokens=8,
              overrides=dict(do_sample=False, subtalker_dosample=False),
              output_dtype="int16")
    calls = []
    real = tserver._vocode_rows_compact

    def rec(p, cfg, codes, ctx, F_, pcm16=False):
        calls.append((codes.shape[0], F_, pcm16))
        return real(p, cfg, codes, ctx, F_, pcm16)

    out = {}
    for warm in (False, True):
        srv = TTSServer(tm, **kw)
        if warm:
            tserver._vocode_rows_compact = rec
            try:
                assert srv.warmup() > 0
            finally:
                tserver._vocode_rows_compact = real
            assert calls == [(n, f, True) for n, _, f in srv.egress_shapes()]
        srv.submit_custom_voice("r", text=REQ_TEXTS[0], speaker="vivian")
        srv.submit_custom_voice("s", text=REQ_TEXTS[1], speaker="vivian", stream=True)
        out[warm] = srv.run_until_drained()
    assert graphs.stats("cpu")["captures"] == 0
    cold, warm = out[False], out[True]
    assert [(type(e), e.request_id) for e in cold] == [(type(e), e.request_id) for e in warm]
    assert any(isinstance(e, AudioResult) for e in warm)
    assert any(isinstance(e, AudioPacket) for e in warm)
    for a, b in zip(cold, warm):
        assert a.wav.dtype == np.int16
        np.testing.assert_array_equal(a.wav, b.wav)


class _FakeGraph:
    """Stands in for a captured graph on the CPU: a replay runs the body on
    the static inputs and writes the static outputs."""

    def __init__(self, run):
        self.run = run

    def replay(self, dev, generator):
        dev.replays += 1
        self.run()


def test_codec_graph_keys_lru_and_copies(monkeypatch):
    """One capture per key (program, static args, pcm16, input shapes and
    dtypes, params identity); replays read the inputs copied into the
    static buffers; callers get copies of the outputs; at most
    MAX_CODEC_GRAPHS graphs."""
    dev = graphs._Device.__new__(graphs._Device)
    dev.device, dev.captures, dev.replays = torch.device("cpu"), 0, 0
    dev.contexts = graphs.OrderedDict()
    monkeypatch.setattr(graphs, "MAX_CODEC_GRAPHS", 3)
    dev.codec = graphs.CodecGraphs(dev, graphs.MAX_CODEC_GRAPHS)

    def fake_capture(d, generator, warm, body):
        assert generator is None
        warm(None)
        body(None)
        d.captures += 1
        return None

    def fake_codec_capture(self, params, body, inputs):
        bufs = tuple(x.clone() for x in inputs)
        outs = []
        fake_capture(self.dev, None, lambda _: body(*bufs), lambda _: outs.extend(body(*bufs)))

        def run():
            for o, v in zip(outs, body(*bufs)):
                o.copy_(v)

        return graphs._CodecGraph(params, bufs, tuple(outs), _FakeGraph(run))

    monkeypatch.setattr(graphs.CodecGraphs, "_capture", fake_codec_capture)
    monkeypatch.setattr(graphs.CodecGraphs, "_load",
                        staticmethod(lambda bufs, xs: [b.copy_(x) for b, x in zip(bufs, xs)]))
    params = {"_codebooks": torch.zeros(1)}

    def call(x, program="rows", static=(4,), pcm16=False, p=params):
        return dev.codec.run(p, DEC_CFG, program, static, pcm16, lambda a: (a * 2,), (x,))

    a = call(torch.ones(2))[0]
    b = call(torch.full((2,), 3.0))[0]
    assert dev.captures == 1 and dev.replays == 2
    assert a.tolist() == [2.0, 2.0] and b.tolist() == [6.0, 6.0]   # a is a copy
    call(torch.ones(2), pcm16=True)
    call(torch.ones(2, dtype=torch.int32))
    assert dev.captures == 3 and len(dev.codec.graphs) == 3
    call(torch.ones(3))                     # a new shape: the oldest key goes
    call(torch.ones(2), p=dict(params))     # other params: another graph
    assert dev.captures == 5 and len(dev.codec.graphs) == 3
    call(torch.ones(2))
    assert dev.captures == 6
