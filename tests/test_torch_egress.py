"""The server's packet egress and fast first packet vocode only what they
deliver (`runtime/server.py` `_vocode_wave`, `_dispatch_fast_first`,
`_row_pieces`): a call whose rows have no context vocodes F frames, not
left_context + F, and a wave of rows is cut into row-bucket pieces instead
of padded, unless one padded call costs less card time.

- the packets of every wave of 1 to num_slots rows, with no context, mixed
  contexts and full context, equal one call at (row_bucket(n),
  left_context + F), the rule the port kept before: PCM16 samples exactly,
  float samples within 1e-5 (the same fp32 math over fewer frames and
  rows; the convolutions may sum in another order);
- the fast first packet at T = F equals the JAX extract at T =
  left_context + F followed by the JAX `_vocode_rows_compact`, and the
  server's pieces equal one call padded with -1 rids;
- the work counters against a hand count of a drained run's calls, and no
  padding row where the rule splits;
- every (N, T, F) the egress and the fast first packet can ask for is one
  `warmup()` captures.

A tiny model with random weights drawn in memory, as
tests/test_torch_tracing.py builds it; the vocoder of
tests/test_torch_codec_graphs.py against the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qwen3_tts_tpu_torch.runtime.server as server_mod
from qwen3_tts_tpu.runtime import server as jserver
from qwen3_tts_tpu_torch.config import CodecV2Config, CodecV2DecoderConfig, TTSModelConfig
from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer
from qwen3_tts_tpu_torch.runtime.server import AudioPacket, TTSServer
from qwen3_tts_tpu_torch.utils.metrics import MetricsRegistry
from qwen3_tts_tpu_torch.utils.testing import (bounded_torch_threads, random_talker_params,
                                               random_vocoder_params)
from tests.test_codec12_decoder import TINY as DEC_TINY
from tests.test_pipeline_parity import MODEL_TINY
from tests.test_torch_codec_graphs import DEC_CFG, FLOAT_TOL, _aux, vocoder  # noqa: F401
from tests.test_torch_pipeline import FakeTokenizer

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

GREEDY = dict(do_sample=False, subtalker_dosample=False)
TEXTS = ["first sample text", "the second one", "and request three", "a fourth, longer one"]


@pytest.fixture(scope="module")
def model():
    cfg = TTSModelConfig.from_dict(MODEL_TINY)
    gen = torch.Generator().manual_seed(1)
    dec = CodecV2DecoderConfig(**DEC_TINY)
    tok = Qwen3TTSTokenizer.from_params(
        CodecV2Config(decoder_config=dec, output_sample_rate=1000,
                      decode_upsample_rate=dec.total_upsample),
        dec_params=random_vocoder_params(dec, gen))
    return Qwen3TTSModel(cfg, random_talker_params(cfg.talker_config, gen, dtype=torch.float32),
                         None, tok, FakeTokenizer(), {}, device="cpu")


def _server(model, **kw):
    kw.setdefault("num_slots", 6)
    return TTSServer(model, overrides=GREEDY, max_new_tokens=8, metrics=MetricsRegistry(),
                     prefill_bucket=48, max_trailing=32, **kw)


def _wave(rng, srv, n, F_, contexts):
    """n rows laid out as `_emit_packets` lays them: c context frames, k
    <= F_ new ones, a zero tail to left_context + F_."""
    lc, Q = srv.left_context, srv._Q
    V = srv.dec_cfg.codebook_size
    ctx = {"none": np.zeros(n, np.int32), "full": np.full(n, lc, np.int32),
           "mixed": rng.integers(0, lc + 1, n).astype(np.int32)}[contexts]
    if contexts == "mixed" and n > 1:
        ctx[0] = 0
    batch = np.zeros((n, Q, lc + F_), np.int32)
    for i in range(n):
        k = int(rng.integers(1, F_ + 1))
        batch[i, :, :ctx[i] + k] = rng.integers(0, V, (Q, ctx[i] + k))
    return batch, ctx


@pytest.mark.parametrize("contexts", ["none", "mixed", "full"])
@pytest.mark.parametrize("pcm16", [False, True])
def test_wave_packets_equal_one_padded_call(model, contexts, pcm16):
    """Waves of 1 to num_slots rows at F in {4, packet_frames}: the pieces'
    samples equal one `_vocode_rows_compact` call over the rows padded to
    `_row_bucket(n)` at T = left_context + F."""
    srv = _server(model, output_dtype="int16" if pcm16 else "float32")
    rng = np.random.default_rng(7)
    lc, Q = srv.left_context, srv._Q
    for F_ in sorted({srv._frame_bucket(1), srv._frame_bucket(srv.packet_frames)}):
        for n in range(1, srv.num_slots + 1):
            batch, ctx = _wave(rng, srv, n, F_, contexts)
            got = srv._vocode_wave(batch, ctx, F_).numpy()
            N = srv._row_bucket(n)
            codes = np.zeros((N, Q, lc + F_), np.int32)
            pad_ctx = np.zeros(N, np.int32)
            codes[:n], pad_ctx[:n] = batch, ctx
            want = server_mod._vocode_rows_compact(
                srv.dec_params, srv.dec_cfg, torch.from_numpy(codes), torch.from_numpy(pad_ctx),
                F_, pcm16=pcm16)[:n].numpy()
            assert got.shape == want.shape == (n, F_ * srv.up) and got.dtype == want.dtype
            if pcm16:
                np.testing.assert_array_equal(got, want, err_msg=f"n={n} F={F_}")
            else:
                np.testing.assert_allclose(got, want, **FLOAT_TOL, err_msg=f"n={n} F={F_}")


@pytest.mark.parametrize("pcm16", [False, True])
def test_first_packet_at_f_frames_matches_jax_at_full_width(vocoder, pcm16):  # noqa: F811
    """`_first_packet_vocode` at T = F (no zero tail) equals the JAX
    extract at T = left_context + F followed by the JAX
    `_vocode_rows_compact` at zero context."""
    jp, tp = vocoder
    B, ticks, K, F_, lc = 3, 5, 4, 4, 25
    aux = _aux(np.random.default_rng(1), B, ticks, K)
    rids = np.array([7, 3, 9, 5], np.int32)
    jcodes, jcounts = jserver._first_packet_extract(jnp.asarray(aux), jnp.asarray(rids), B=B,
                                                    ticks=ticks, Q=DEC_CFG.num_quantizers,
                                                    F=F_, T=lc + F_)
    want = np.asarray(jserver._vocode_rows_compact(jp, DEC_CFG, jcodes,
                                                   jnp.zeros((len(rids),), jnp.int32), F=F_,
                                                   pcm16=pcm16))
    wav, counts = server_mod._first_packet_vocode(tp, DEC_CFG, torch.from_numpy(aux),
                                                  torch.from_numpy(rids), B, ticks,
                                                  DEC_CFG.num_quantizers, F_, F_, pcm16=pcm16)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert list(counts.numpy()) == [4, 2, 3, 0]
    if pcm16:
        np.testing.assert_array_equal(wav.numpy(), want)
    else:
        np.testing.assert_allclose(wav.numpy(), want, **FLOAT_TOL)


def _serve_aux(rng, srv):
    """A chunk aux of the server's engine shape (serve_chunk's layout):
    slot s holds request 10 + s from tick s % 3 on; random frames."""
    eng = srv.engine
    B, ticks, K, Q = eng.num_slots, eng.ticks_per_sync, eng.staging_rows, srv._Q
    frames = rng.integers(0, srv.dec_cfg.codebook_size, (B, ticks, Q)).astype(np.int32)
    req = np.full((B, ticks), -1, np.int32)
    emit = np.zeros((B, ticks), np.int32)
    for s in range(B):
        req[s, s % 3:], emit[s, s % 3:] = 10 + s, 1
    tail = np.zeros(B * ticks + 2 * K + B, np.int32)
    return np.concatenate([frames.reshape(-1), emit.reshape(-1), req.reshape(-1), tail])


@pytest.mark.parametrize("pcm16", [False, True])
def test_fast_first_pieces_equal_one_padded_call(model, pcm16):
    """`_dispatch_fast_first` over 1 to num_slots waiting requests (one of
    them absent from the chunk) equals one `_first_packet_vocode` call of
    `_row_bucket(n)` rids padded with -1 at T = left_context + F."""
    srv = _server(model, output_dtype="int16" if pcm16 else "float32")
    eng = srv.engine
    aux = torch.from_numpy(_serve_aux(np.random.default_rng(3), srv))
    eng._unprocessed.append((aux, None, None, None))
    F_ = srv._frame_bucket(1)
    try:
        for n in range(1, srv.num_slots + 1):
            waiting = [10 + s for s in range(n)]
            waiting[-1] = 99 if n > 2 else waiting[-1]
            rids, wav, counts = srv._dispatch_fast_first(waiting)
            N = srv._row_bucket(n)
            arr = np.full((N,), -1, np.int32)
            arr[:n] = waiting
            want, want_counts = server_mod._first_packet_vocode(
                srv.dec_params, srv.dec_cfg, aux, torch.from_numpy(arr), eng.num_slots,
                eng.ticks_per_sync, srv._Q, F_, srv.left_context + F_, pcm16=pcm16)
            assert rids == waiting
            np.testing.assert_array_equal(counts[:n].numpy(), want_counts[:n].numpy())
            if pcm16:
                np.testing.assert_array_equal(wav[:n].numpy(), want[:n].numpy())
            else:
                np.testing.assert_allclose(wav[:n].numpy(), want[:n].numpy(), **FLOAT_TOL)
    finally:
        eng._unprocessed.clear()


@pytest.mark.parametrize("n,T,pieces", [(13, 50, [8, 4, 1]), (13, 29, [8, 4, 1]),
                                        (13, 4, [16]), (17, 4, [16, 1]), (24, 4, [16, 8]),
                                        (31, 4, [32]), (32, 50, [32]), (3, 25, [2, 1]),
                                        (3, 4, [4])])
def test_row_pieces_weigh_padding_against_a_replay(model, n, T, pieces):
    """At 32 slots: a padding row of T frames costs FRAME_ROW_MS * T of card
    time, one more replay REPLAY_FLOOR_MS (4.4 ms against 0.21 ms a
    frame-row): at T = 4 up to five padding rows are cheaper than a
    replay, at T >= 25 none is."""
    assert _server(model, num_slots=32)._row_pieces(n, T) == pieces


@pytest.mark.parametrize("fast_first", [True, False])
def test_counters_equal_a_hand_count_of_the_calls(model, fast_first):
    """A drained run (four streams and one non-streamed request on 3 slots,
    4-frame packets): `server.vocode_frames_computed` is N x T of every
    egress and first-packet call, `server.vocode_calls` their number; a
    wave cut into several pieces vocodes no padding row; first packets
    vocode F frames a row, through the fast path or without it through
    the egress."""
    calls, cuts = [], []
    egress, first = server_mod._vocode_rows_compact, server_mod._first_packet_vocode

    def egress_spy(params, cfg, codes, ctx, F_, pcm16=False):
        calls.append(("egress", codes.shape[0], codes.shape[2], F_))
        return egress(params, cfg, codes, ctx, F_, pcm16=pcm16)

    def first_spy(params, cfg, aux, rids, B, ticks, Q, F_, T, pcm16=False):
        calls.append(("first", len(rids), T, F_))
        return first(params, cfg, aux, rids, B, ticks, Q, F_, T, pcm16=pcm16)

    srv = _server(model, num_slots=3, packet_frames=4, fast_first_packet=fast_first)
    pieces = srv._row_pieces

    def pieces_spy(n, T):
        got = pieces(n, T)
        cuts.append((n, got))
        return got

    mp = pytest.MonkeyPatch()
    mp.setattr(server_mod, "_vocode_rows_compact", egress_spy)
    mp.setattr(server_mod, "_first_packet_vocode", first_spy)
    mp.setattr(srv, "_row_pieces", pieces_spy)
    try:
        for i, stream in enumerate((True, True, False, True, True)):
            srv.submit_custom_voice(f"r{i}", text=TEXTS[i % len(TEXTS)], speaker="vivian",
                                    language="english", stream=stream)
        events = srv.run_until_drained()
    finally:
        mp.undo()
    c = srv.metrics.snapshot()["counters"]
    pkts = [e for e in events if isinstance(e, AudioPacket)]
    assert len({p.request_id for p in pkts}) == 4
    assert c["server.vocode_frames_delivered"] == sum(p.frame_count for p in pkts)
    assert calls and c["server.vocode_calls"] == len(calls)
    assert c["server.vocode_frames_computed"] == sum(n * t for _, n, t, _ in calls)
    assert all(t == f for kind, _, t, f in calls if kind == "first")
    assert any(kind == "first" for kind, *_ in calls) == fast_first
    if not fast_first:
        assert any(kind == "egress" and t == f for kind, _, t, f in calls)
    assert cuts and all(sum(got) == n for n, got in cuts if len(got) > 1)


@pytest.mark.parametrize("num_slots,packet_frames", [(1, 25), (6, 25), (8, 3), (32, 25)])
def test_every_call_shape_is_warmed(model, num_slots, packet_frames, monkeypatch):
    """Every (N, T, F) that `_vocode_wave` (waves of 1 to num_slots rows,
    each F, no, mixed and full context) and `_dispatch_fast_first` (1 to
    num_slots waiting requests) ask for is an `egress_shapes()` or a
    `first_packet_shapes()` entry, and every entry is asked for."""
    srv = _server(model, num_slots=num_slots, packet_frames=packet_frames)
    seen = {"egress": set(), "first": set()}

    def egress(params, cfg, codes, ctx, F_, pcm16=False):
        seen["egress"].add((codes.shape[0], codes.shape[2], F_))
        return torch.zeros((codes.shape[0], F_ * srv.up))

    def first(params, cfg, aux, rids, B, ticks, Q, F_, T, pcm16=False):
        seen["first"].add((len(rids), T, F_))
        return torch.zeros((len(rids), F_ * srv.up)), torch.zeros(len(rids), dtype=torch.int32)

    monkeypatch.setattr(server_mod, "_vocode_rows_compact", egress)
    monkeypatch.setattr(server_mod, "_first_packet_vocode", first)
    rng = np.random.default_rng(num_slots)
    srv.engine._unprocessed.append((torch.zeros(1, dtype=torch.int32), None, None, None))
    try:
        for n in range(1, num_slots + 1):
            srv._dispatch_fast_first(list(range(n)))
            for F_ in {srv._frame_bucket(k) for k in range(1, packet_frames + 1)}:
                for contexts in ("none", "mixed", "full"):
                    srv._vocode_wave(*_wave(rng, srv, n, F_, contexts), F_)
    finally:
        srv.engine._unprocessed.clear()
    assert seen["egress"] <= set(srv.egress_shapes())
    assert seen["first"] <= set(srv.first_packet_shapes())
    # the warm-up captures nothing these waves never ask for
    assert seen["egress"] == set(srv.egress_shapes())
    assert seen["first"] == set(srv.first_packet_shapes())
