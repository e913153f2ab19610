"""The 25 Hz (V1) tokenizer's four programs, two of them as graphs, on the
CPU, with the CUDA capture replaced by the stand-in of
`test_torch_front_graphs.py` (it captures by running the body once and
replays by running it again):

- the DiT sampler, its per-call conditioning hoisted out of the steps, bit
  for bit the loop that calls `dit_forward` at every step, with and
  without CFG;
- the sampler's step graph (`graphs.step_loop`): a key's first call runs
  eagerly, its second captures (the capture's warm pass is the first
  step) and replays the other steps, or with DIT_CAPTURE_CALL 1 the first
  call captures; equal to the eager route on inputs its capture never saw
  and on another step count, within 1e-4 relative L2 of the JAX
  `dit_sample`; keyed by the shapes it reads and guidance_scale;
- CAM++ through `front_call`: a shape's first call runs eagerly, its
  second captures, later ones replay, equal to the eager route, one graph
  per shape; BigVGAN and the Whisper-VQ encode capture nothing;
- the device constants (the DiT's RoPE tables and time grid, BigVGAN's
  kaiser filters, the Whisper mel's window and filterbank, the sinusoid
  table) built once per (arguments, device);
- the encoder's window mask, built on the device from the valid length,
  equal to the per-window lengths of the JAX package's numpy code for
  whole and partial last windows;
- V1 lengths past each program's bound evict only that program's graphs;
- BigVGAN's cuDNN flag put back after a forward, also one that raises;
- a V1 batch of two code counts decoded through both packages'
  `Qwen3TTSTokenizer.decode` with the same noise: the trimmed waveforms
  agree (atol 5e-5, the end-to-end test's), at the tiny config's true
  samples per code and at 4x it (the released config's trim, which the
  port mirrors); through the graphs the padded shape is the key.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_tts_tpu.config import DiTConfig as JDiTCfg
from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
from qwen3_tts_tpu.models.codec25 import dit as jdit
from qwen3_tts_tpu_torch.config import BigVGANConfig, DiTConfig, WhisperVQEncoderConfig
from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
from qwen3_tts_tpu_torch.models.codec25 import bigvgan as tbig
from qwen3_tts_tpu_torch.models.codec25 import campplus as tcam
from qwen3_tts_tpu_torch.models.codec25 import dit as tdit
from qwen3_tts_tpu_torch.models.codec25 import encoder as tenc
from qwen3_tts_tpu_torch.models.codec25 import mel as tmel
from qwen3_tts_tpu_torch.ops import stft
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, campplus_state
from qwen3_tts_tpu_torch.weights import save_safetensors
from tests.test_torch_campplus import TINY_KW
from tests.test_torch_codec25 import (BIGVGAN_CFG, DIT_CFG, ENC_TINY, TOK_JSON,  # noqa: F401
                                      _dit_inputs, rel_l2, state)
from tests.test_torch_front_graphs import fake_front  # noqa: F401

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

DIT = DiTConfig.from_dict(DIT_CFG)
V1_OWNERS = ("dit_step", "campplus")


def _loop_sample(params, cfg, codes, xvector, ref_mel, noise, num_steps, guidance_scale,
                 sway=-1.0):
    """The sampler as one `dit_forward` call a step: the conditioning
    (speaker encoder, CFG halves, RoPE tables, block biases) recomputed in
    every step."""
    B, Tc = codes.shape
    T = Tc * cfg.repeats
    table = params["text_embed"]["codec_embed"]["weight"]
    code = table[codes.long()].repeat_interleave(cfg.repeats, dim=1)
    uncond = table[torch.zeros_like(codes).long()].repeat_interleave(cfg.repeats, dim=1)
    spk = xvector[:, None, :].expand(-1, T, -1)
    ts = tdit.time_schedule(num_steps, sway)
    y = noise
    for i in range(num_steps - 1):
        t0, t1 = ts[i], ts[i + 1]
        if guidance_scale >= 1e-5:
            out = tdit.dit_forward(params, cfg, torch.cat([y, y]),
                                   torch.cat([spk, torch.zeros_like(spk)]),
                                   torch.cat([ref_mel, torch.zeros_like(ref_mel)]),
                                   torch.cat([code, uncond]), t0.expand(2 * B))
            c, u = torch.chunk(out, 2, dim=0)
            v = c + (c - u) * guidance_scale
        else:
            v = tdit.dit_forward(params, cfg, y, spk, ref_mel, code, t0.expand(B))
        y = y + v * (t1 - t0)
    return y.permute(0, 2, 1)


def _sample_args(params, d):
    return (params, DIT) + tuple(torch.from_numpy(np.asarray(d[k]))
                                 for k in ("codes", "xvec", "ref_mel", "noise"))


@pytest.mark.parametrize("guidance_scale", [0.5, 0.0])
def test_hoisted_sampler_is_the_per_step_loop_bit_for_bit(state, guidance_scale):  # noqa: F811
    _, _, ttree = state
    assert len(DIT.look_ahead_layers) + len(DIT.look_backward_layers) > 0
    args = _sample_args(ttree["decoder"]["dit"], _dit_inputs())
    with torch.no_grad():
        want = _loop_sample(*args, num_steps=4, guidance_scale=guidance_scale)
        got = tdit.dit_sample(*args, num_steps=4, guidance_scale=guidance_scale)
    assert torch.equal(got, want)
    assert torch.equal(args[-1], torch.from_numpy(_dit_inputs()["noise"]))   # not written


def test_dit_step_graph_replays_every_step(fake_front, state):  # noqa: F811
    _, jtree, ttree = state
    params = ttree["decoder"]["dit"]
    a, b = _dit_inputs(seed=4), _dit_inputs(seed=11)    # one shape, other values

    def run(d, **kw):
        with torch.no_grad():
            return tdit.dit_sample(*_sample_args(params, d), **{"num_steps": 4, **kw})

    got = [run(a)]     # eager
    assert (fake_front.captures, fake_front.replays) == (0, 0)
    got += [run(a)]    # captured: the warm pass is the first step, 2 replays
    assert (fake_front.captures, fake_front.replays) == (1, 2)
    got += [run(b), run(b, num_steps=6)]   # the grid is not in the key
    assert (fake_front.captures, fake_front.replays) == (1, 10)
    got += [run(b, guidance_scale=0.0) for _ in range(2)]    # another key
    assert (fake_front.captures, fake_front.replays) == (2, 12)
    keys = list(fake_front.dit_step.graphs)
    assert [k[2:4] for k in keys] == [("dit_step", (0.5,)), ("dit_step", (0.0,))]
    width = DIT.enc_dim + DIT.emb_dim + DIT.enc_emb_dim
    assert [k[5][0][0] for k in keys] == [(2, 12, DIT.mel_dim)] * 2    # y: (B, Tc * repeats)
    assert [k[5][3][0] for k in keys] == [(4, 12, width), (2, 12, width)]   # the CFG batch
    assert not fake_front.campplus.graphs
    with graphs.eager():
        want = [run(a), run(a), run(b), run(b, num_steps=6), run(b, guidance_scale=0.0),
                run(b, guidance_scale=0.0)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    j = jdit.dit_sample(jtree["decoder"]["dit"], JDiTCfg.from_dict(DIT_CFG),
                        *(jnp.asarray(a[k]) for k in ("codes", "xvec", "ref_mel", "noise")),
                        num_steps=4, guidance_scale=0.5)
    assert rel_l2(got[0].numpy(), np.asarray(j)) < 1e-4


def test_dit_step_graph_captured_at_the_first_call_when_set(fake_front, state,  # noqa: F811
                                                          monkeypatch):
    """DIT_CAPTURE_CALL 1: a key's first call captures (its warm pass the
    first step) and replays the other steps; nothing runs eagerly."""
    monkeypatch.setattr(graphs, "DIT_CAPTURE_CALL", 1)
    params = state[2]["decoder"]["dit"]
    a, b = _dit_inputs(seed=4), _dit_inputs(seed=11)

    def run(d, **kw):
        with torch.no_grad():
            return tdit.dit_sample(*_sample_args(params, d), **{"num_steps": 4, **kw})

    got = [run(a)]
    assert (fake_front.captures, fake_front.replays) == (1, 2)
    got += [run(b), run(b, num_steps=6)]
    assert (fake_front.captures, fake_front.replays) == (1, 10)
    assert not fake_front.dit_step.seen and len(fake_front.dit_step.graphs) == 1
    with graphs.eager():
        want = [run(a), run(b), run(b, num_steps=6)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _program_cases(ttree):
    """program -> (its call, three inputs: a shape, the same shape with
    other values, another shape)."""
    rng = np.random.default_rng(12)
    enc_cfg = WhisperVQEncoderConfig.from_dict(ENC_TINY)
    cam_cfg = tcam.CAMPPlusConfig(**TINY_KW)
    cam = {k: torch.from_numpy(v) for k, v in campplus_state(cam_cfg, seed=1).items()}

    def mel(n, seed, amp=0.5):
        wav = np.random.default_rng(seed).uniform(-amp, amp, (n,)).astype(np.float32)
        return tmel.get_mel_audio(wav, padding=True, audio_vq_ds_rate=2, n_mels=80)

    def randn(*shape):
        return torch.from_numpy(rng.normal(-1, 1, shape).astype(np.float32))

    big = ttree["decoder"]["bigvgan"], BigVGANConfig.from_dict(BIGVGAN_CFG)
    enc = ttree["encoder"]["tokenizer"], enc_cfg
    return {
        "bigvgan": (lambda m: tbig.bigvgan_forward(*big, m),
                    [randn(2, 80, 20), randn(2, 80, 20), randn(2, 80, 24)]),
        "v1_encode": (lambda m: tenc.encode_mel_to_codes(*enc, m),
                      [mel(3000, 0), mel(3000, 1, amp=0.05), mel(5200, 2)]),
        "campplus": (lambda f: tcam.campplus_embed(cam, cam_cfg, f),
                     [randn(1, 37, 16), randn(1, 37, 16), randn(1, 50, 16)]),
    }


@pytest.mark.parametrize("program", ["campplus"])
def test_program_is_captured_at_a_shapes_second_call(fake_front, state, program):  # noqa: F811
    fn, (a, b, c) = _program_cases(state[2])[program]
    owner = getattr(fake_front, program)
    with torch.no_grad():
        got = [fn(a)]
        assert (fake_front.captures, len(owner.graphs)) == (0, 0)     # first call: eager
        got += [fn(a)]
        assert (fake_front.captures, fake_front.replays) == (1, 1)    # second: capture
        got += [fn(b), fn(c)]                                         # a replay; c eager
        assert (fake_front.captures, fake_front.replays) == (1, 2)
        got += [fn(c)]
        with graphs.eager():
            want = [fn(x) for x in (a, a, b, c, c)]
    assert fake_front.captures == 2
    assert [k[2] for k in owner.graphs] == [program] * 2
    assert [k[5] for k in owner.graphs] == [((tuple(x.shape), torch.float32),) for x in (a, c)]
    for o in set(V1_OWNERS) - {program}:
        assert not getattr(fake_front, o).graphs
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[2], got[1])


@pytest.mark.parametrize("program", ["bigvgan", "v1_encode"])
def test_program_runs_eagerly_with_the_graph_layer_on(fake_front, state, program):  # noqa: F811
    """BigVGAN and the Whisper-VQ encode capture nothing at any call, and
    give what `graphs.eager()` gives."""
    fn, (a, b, c) = _program_cases(state[2])[program]
    with torch.no_grad():
        got = [fn(x) for x in (a, a, a, b, c, c)]
        with graphs.eager():
            want = [fn(x) for x in (a, a, a, b, c, c)]
    assert (fake_front.captures, fake_front.replays) == (0, 0)
    assert not any(getattr(fake_front, o).graphs or getattr(fake_front, o).seen
                   for o in V1_OWNERS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_v1_constants_are_built_once_per_device(monkeypatch, state):  # noqa: F811
    _, _, ttree = state
    calls = {}

    def counting(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((tdit, "_rope_np"), (tdit, "time_schedule"),
                         (tbig, "_kaiser_sinc_filter"), (tenc, "sinusoid_positions"),
                         (stft, "hann_window"), (stft, "mel_filterbank")):
        counting(module, name)
    for cached in (tdit._dit_rope_tables, tdit.time_grid, tbig._device_filter,
                   tenc._device_sinusoids):
        cached.cache_clear()
    monkeypatch.setattr(stft, "_MEL_CONSTANTS", {})
    cases = _program_cases(ttree)
    args = _sample_args(ttree["decoder"]["dit"], _dit_inputs())
    with torch.no_grad():
        for _ in range(2):
            tdit.dit_sample(*args, num_steps=4)
            cases["bigvgan"][0](cases["bigvgan"][1][0])
            cases["v1_encode"][0](cases["v1_encode"][1][0])   # its mel included
    assert calls == {"_rope_np": 1, "time_schedule": 1, "_kaiser_sinc_filter": 1,
                     "sinusoid_positions": 1, "hann_window": 1, "mel_filterbank": 1}


@pytest.mark.parametrize("T_mel", [4, 12, 16, 20, 28, 32, 36, 64, 68])
def test_window_mask_is_the_per_window_lengths(T_mel):
    """The JAX package's numpy lengths: every window whole but the last."""
    W = ENC_TINY["n_window"]
    n = -(-T_mel // (2 * W))
    win_lens = np.full((n,), W, np.int64)
    win_lens[-1] = tmel.get_T_after_cnn(T_mel) - W * (n - 1)
    want = np.arange(W)[None, :] < win_lens[:, None]
    np.testing.assert_array_equal(tenc.window_mask(T_mel, W, "cpu").numpy(), want)


def test_window_mask_cases_hold_whole_and_partial_last_windows():
    W = ENC_TINY["n_window"]
    last = {T: tenc.window_mask(T, W, "cpu")[-1].sum().item() for T in (4, 20, 32, 68)}
    assert last == {4: 2, 20: 2, 32: 8, 68: 2}


def _stand_in_graphs(fake_front):  # noqa: F811
    """A vocoder, an encode and an ECAPA graph over stand-in params."""
    double = lambda x: (x * 2,)   # noqa: E731
    graphs.codec_call({"d": torch.zeros(1)}, None, "rows", (2,), False, double, torch.ones(2))
    for program in ("encode", "ecapa"):
        for _ in range(2):
            graphs.front_call({program: torch.zeros(1)}, None, program, (), double,
                              torch.ones(3))
    return {o: list(getattr(fake_front, o).graphs) for o in ("codec", "encode", "ecapa")}


def test_v1_lengths_past_each_bound_evict_only_their_own(fake_front, monkeypatch,  # noqa: F811
                                                          state):  # noqa: F811
    for owner in V1_OWNERS:
        monkeypatch.setattr(getattr(fake_front, owner), "bound", 2)
    before = _stand_in_graphs(fake_front)
    ttree = state[2]
    cases = _program_cases(ttree)
    rng = np.random.default_rng(13)
    cam_cfg = tcam.CAMPPlusConfig(**TINY_KW)
    with torch.no_grad():
        for i, Tc in enumerate((3, 4, 5, 6)):
            d = _dit_inputs(B=1, Tc=Tc, seed=20 + i)
            feats = torch.from_numpy(rng.normal(0, 1, (1, 30 + i, 16)).astype(np.float32))
            for _ in range(2):
                tdit.dit_sample(*_sample_args(ttree["decoder"]["dit"], d), num_steps=3)
                cases["campplus"][0](feats)
    assert {o: list(getattr(fake_front, o).graphs) for o in before} == before
    dit_keys = [k[5][0][0] for k in fake_front.dit_step.graphs]
    assert dit_keys == [(1, 10, DIT.mel_dim), (1, 12, DIT.mel_dim)]   # Tc 5 and 6
    assert [k[5][0][0] for k in fake_front.campplus.graphs] == [(1, 32, 16), (1, 33, 16)]
    assert cam_cfg.feat_dim == 16
    assert fake_front.captures == 3 + 4 * 2


def test_bigvgan_puts_back_the_cudnn_flag(state, monkeypatch):  # noqa: F811
    """Inside a forward cuDNN is deterministic and the forward holds its
    lock; after it, even one that raised, the flag is what it was."""
    big = state[2]["decoder"]["bigvgan"], BigVGANConfig.from_dict(BIGVGAN_CFG)
    mel = torch.zeros(1, 80, 6)
    seen = []
    real = tbig._forward

    def forward(*a):
        seen.append((torch.backends.cudnn.deterministic, tbig._DETERMINISTIC.locked()))
        return real(*a)

    monkeypatch.setattr(tbig, "_forward", forward)
    for prev in (False, True):
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", prev)
        tbig.bigvgan_forward(*big, mel)
        assert torch.backends.cudnn.deterministic is prev
    monkeypatch.setattr(tbig, "_forward", lambda *a: 1 / 0)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    with pytest.raises(ZeroDivisionError):
        tbig.bigvgan_forward(*big, mel)
    assert torch.backends.cudnn.deterministic is False and not tbig._DETERMINISTIC.locked()
    assert seen == [(True, True), (True, True)]


@pytest.mark.parametrize("up", [16, 64])
def test_mixed_length_batch_matches_jax_decode(fake_front, tmp_path, state, up):  # noqa: F811
    """Rows of 6 and 3 codes: the port decodes the padded (2, 6) batch and
    trims each row to n_i * decode_upsample_rate samples, as the JAX
    package does. 16 is the tiny config's true samples per code (2 frames a
    code, 8 samples a frame); at 64, 4x it as in the released config, the
    3-code row keeps its padding's samples in both packages."""
    flat, _, _ = state
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(TOK_JSON, decode_upsample_rate=up), f)
    save_safetensors(str(tmp_path / "model.safetensors"), flat)
    jtok, ttok = JTok.from_pretrained(str(tmp_path)), TTok.from_pretrained(str(tmp_path),
                                                                           device="cpu")
    rng = np.random.default_rng(14)
    enc = {"audio_codes": [rng.integers(0, 30, (6,)), rng.integers(0, 30, (3,))],
           "xvectors": [rng.normal(0, 0.3, (DIT.enc_emb_dim,)).astype(np.float32)
                        for _ in range(2)],
           "ref_mels": [rng.normal(0, 0.3, (n, DIT.mel_dim)).astype(np.float32)
                        for n in (10, 7)]}
    want, _ = jtok.decode(enc)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 6 * DIT.repeats,
                                                                 DIT.mel_dim), jnp.float32))
    got = [ttok.decode(enc, noise=noise)[0] for _ in range(3)]
    # 9 steps: eager, then the DiT's capture and its 8 replays, then 9
    # replays; BigVGAN eager each time
    assert (fake_front.captures, fake_front.replays) == (1, 8 + 9)
    assert [k[5][0][0] for k in fake_front.dit_step.graphs] == [(2, 12, DIT.mel_dim)]
    assert [len(w) for w in want] == [min(6 * up, 96), min(3 * up, 96)]
    for rows in got:
        for g, w in zip(rows, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=5e-5)
