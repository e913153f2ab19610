"""The port's SFT against the JAX package: the embedding fusion, the loss
and its gradients (torch autograd against `jax.value_and_grad`), optimizer
cycles with gradient accumulation (against optax's MultiSteps over
clip_by_global_norm + adamw, with the clip binding and not), the collate
layout, the state-dict export and the writer's files, data preparation
through the 12 Hz tokenizer, the training-state checkpoint round trip, and
`sft.main` end to end against the JAX driver on one tiny base checkpoint
(both packages' codes from the reloaded epoch checkpoint equal).

Tolerances:
- fusion, loss: fp32, 1e-6 relative; gradients: relative L2 2e-4 per leaf
  (each package's fp32 gradients are 2e-5 to 7e-5 from an fp64 run of the
  port's loss on these inputs);
- optimizer cycles: per-leaf relative L2 of the parameter change 1e-3
  (Adam divides each gradient element by its own magnitude, so elements
  with |g| near eps=1e-8 carry the packages' float differences into the
  update); the collate arrays and the state-dict export: equal;
- sft.main (both drivers train in bf16, one epoch of two AdamW updates at
  lr 1e-3, about one bf16 ulp of a weight each): config.json and the file
  layout equal; every element within 2 ulps + 4e-3 (two updates of either
  sign); each trained tensor's change from the base points the same way in
  both packages (cosine >= 0.6; bf16 rounding makes the rest differ); the
  speaker row (the bf16 speaker encoder of each package) within relative
  L2 2e-2; the reloaded checkpoint's fp32 greedy codes equal in both
  packages.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qwen3_tts_tpu.config import TTSModelConfig as JTTSCfg
from qwen3_tts_tpu.finetune import data as jdata
from qwen3_tts_tpu.finetune import sft as jsft
from qwen3_tts_tpu.finetune import train as jtrain
from qwen3_tts_tpu.inference import model as jmodel
from qwen3_tts_tpu.utils.testing import random_talker_params
from qwen3_tts_tpu.weights import flatten_state_dict as j_flatten
from qwen3_tts_tpu.weights import load_safetensors_dir as j_load_dir
from qwen3_tts_tpu.weights import talker_params_to_state_dict as j_to_sd
from qwen3_tts_tpu_torch.config import TTSModelConfig
from qwen3_tts_tpu_torch.finetune import checkpoint as tckpt
from qwen3_tts_tpu_torch.finetune import data as tdata
from qwen3_tts_tpu_torch.finetune import sft as tsft
from qwen3_tts_tpu_torch.finetune import train as ttrain
from qwen3_tts_tpu_torch.inference import model as tmodel
from qwen3_tts_tpu_torch.utils.audio import write_wav
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, speaker_encoder_state
from qwen3_tts_tpu_torch.weights import (flatten_state_dict, from_jax_tree,
                                         read_safetensors, save_safetensors,
                                         talker_params_to_state_dict)
from tests.test_pipeline_parity import MODEL_TINY
from tests.test_torch_pipeline import FakeTokenizer

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

Q = MODEL_TINY["talker_config"]["num_code_groups"]
# the talker's cache-free training route against a prefill into a zero cache
# (fp32, 2 layers, hiddens up to ~9: 5.8e-6 and 1.4e-5 from the JAX package's
# measured on one host)
TRAIN_ROUTE_TOL = dict(rtol=5e-5, atol=5e-5)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _base_json():
    """MODEL_TINY as a base checkpoint: the speaker encoder's x-vector rides
    the codec track (enc_dim = the talker width)."""
    d = json.loads(json.dumps(MODEL_TINY))
    d["tts_model_type"] = "base"
    d["speaker_encoder_config"].update(mel_dim=128, enc_dim=d["talker_config"]["hidden_size"])
    return d


@pytest.fixture(scope="module")
def talker():
    """(config, JAX fp32 params, port fp32 params) from one JAX fabrication."""
    cfg = TTSModelConfig.from_dict(MODEL_TINY)
    params = random_talker_params(cfg.talker_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    return cfg, params, from_jax_tree(params)


def _items(rng, n, mel_len=12):
    out = []
    for _ in range(n):
        tl, cl = int(rng.integers(9, 14)), int(rng.integers(3, 7))
        out.append({"text_ids": rng.integers(1, 40, (1, tl)),
                    "audio_codes": rng.integers(0, 60, (cl, Q)),
                    "ref_mel": rng.normal(0, 1, (1, mel_len, 16)).astype(np.float32)})
    return out


def _batches(cfg, seed, n_batches=1, B=2):
    """Collated batches (numpy, without ref_mels) and a speaker vector each."""
    rng = np.random.default_rng(seed)
    ds = tdata.TTSDataset([], None, cfg, num_code_groups=Q)
    out = []
    for _ in range(n_batches):
        b = ds.collate(_items(rng, B))
        b.pop("ref_mels")
        spk = rng.normal(0, 0.5, (B, cfg.talker_config.hidden_size)).astype(np.float32)
        out.append((b, spk))
    return out


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def test_collate_matches_jax():
    cfg, jcfg = TTSModelConfig.from_dict(MODEL_TINY), JTTSCfg.from_dict(MODEL_TINY)
    items = _items(np.random.default_rng(0), 3)
    want = jdata.TTSDataset([], None, jcfg, num_code_groups=Q).collate(items, pad_to_multiple=16)
    got = tdata.TTSDataset([], None, cfg, num_code_groups=Q).collate(items, pad_to_multiple=16)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["input_ids"].shape[1] % 16 == 0


def test_fuse_embeddings_matches_jax(talker):
    cfg, jp, tp = talker
    (b, spk), = _batches(cfg, 1)
    want = np.asarray(jtrain.fuse_embeddings(jp, cfg.talker_config, _jbatch(b), jnp.asarray(spk)))
    got = ttrain.fuse_embeddings(tp, cfg.talker_config, _tbatch(b), torch.from_numpy(spk))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, 6].numpy(), np.asarray(want)[:, 6], rtol=1e-6)


def test_sft_loss_and_grads_match_jax(talker):
    """Loss value and every leaf's gradient; the leaves the loss does not
    reach (text_projection is used here: text width 48 != 64) have zero
    gradients in both."""
    cfg, jp, tp = talker
    tc = cfg.talker_config
    (b, spk), = _batches(cfg, 2)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jtrain.sft_loss, has_aux=True),
                                  static_argnums=1)(jp, tc, _jbatch(b), jnp.asarray(spk))
    params = ttrain.trainable(tp)
    loss, metrics = ttrain.sft_loss(params, tc, _tbatch(b), torch.from_numpy(spk))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for k in ("talker_loss", "sub_talker_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-6)
    jflat = j_flatten(jgrads)
    tflat = {k: v for k, v in flatten_state_dict(params).items() if v is not None}
    assert set(tflat) == {k for k, v in jflat.items() if v is not None}
    for k, p in tflat.items():
        want = np.asarray(jflat[k])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        if not np.any(want):
            assert not np.any(got), k
        else:
            assert rel_l2(got, want) < 2e-4, (k, rel_l2(got, want))


def test_talker_training_route_equals_a_zero_cache(talker):
    """`cache=None` attends the call's fresh K/V: the hiddens of a prefill
    into a zero cache of length T (T1), and of the JAX package's zero-cache
    prefill, within TRAIN_ROUTE_TOL in fp32. Not to the bit: the cache route attends
    over transposed views of the cache, the training route over views of
    the fused qkv product, so BLAS meets other layouts and sums in an order
    that depends on the host (max abs 5.8e-6 apart on one, 0 on another)."""
    from qwen3_tts_tpu.models import talker as jtalker
    from qwen3_tts_tpu_torch.models.talker import KVCache, StackDims, talker_prefill

    cfg, jp, tp = talker
    tc = cfg.talker_config
    emb = torch.randn(2, 10, tc.hidden_size, generator=torch.Generator().manual_seed(0))
    mask = torch.ones(2, 10, dtype=torch.long)
    mask[1, 7:] = 0                       # right padding, as SFT batches have
    dims = StackDims.from_talker(tc)
    cache = KVCache.zeros(tc.num_hidden_layers, 2, 10, dims.kv_heads, dims.head_dim,
                          dtype=torch.float32)
    _, want, _ = talker_prefill(tp, tc, emb, mask, cache, allow_flash=False)
    _, got, none = talker_prefill(tp, tc, emb, mask, None, allow_flash=False)
    assert none is None
    jcache = jtalker.KVCache.zeros(tc.num_hidden_layers, 2, 10, dims.kv_heads, dims.head_dim,
                                   dtype=jnp.float32)
    _, jax_h, _ = jtalker.talker_prefill(jp, tc, jnp.asarray(emb.numpy()),
                                         jnp.asarray(mask.numpy()), jcache, allow_flash=False)
    torch.testing.assert_close(got, want, **TRAIN_ROUTE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_h), **TRAIN_ROUTE_TOL)


@pytest.mark.parametrize("clip_norm", [0.05, 1e6], ids=["clip_binds", "clip_free"])
def test_optimizer_cycles_match_optax(talker, clip_norm):
    """Two optimizer cycles of grad_accum=2 (four train steps over two
    alternating batches) against optax.MultiSteps(chain(clip, adamw), 2)."""
    cfg, jp, tp = talker
    tc = cfg.talker_config
    batches = _batches(cfg, 3, n_batches=2)
    lr = 1e-3
    jopt = optax.MultiSteps(jtrain.default_optimizer(lr=lr, clip_norm=clip_norm),
                            every_k_schedule=2)
    jstate = jopt.init(jp)
    jstep = jax.jit(jtrain.make_train_step(tc, jopt))
    params = ttrain.trainable(tp)
    opt = ttrain.default_optimizer(params, lr=lr, clip_norm=clip_norm, grad_accum=2)
    tstep = ttrain.make_train_step(tc, opt)
    jparams, norms = jp, []
    for i in range(4):
        b, spk = batches[i % 2]
        jparams, jstate, jm = jstep(jparams, jstate, _jbatch(b), jnp.asarray(spk))
        tm = tstep(params, _tbatch(b), torch.from_numpy(spk))
        assert tm["updated"] == (i % 2 == 1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        if tm["updated"]:
            norms.append(opt.last_norm)
    # the mean's norm is ~2-4: the clip binds at 0.05 and not at 1e6
    assert all((n >= clip_norm) == (clip_norm < 1) for n in norms), norms
    jflat, t0, j0 = j_flatten(jparams), flatten_state_dict(tp), j_flatten(jp)
    for k, p in flatten_state_dict(params).items():
        if p is None:
            continue
        want = np.asarray(jflat[k]) - np.asarray(j0[k])
        got = p.detach().numpy() - t0[k].numpy()
        assert np.any(want), k     # every leaf moved (AdamW decays unused ones too)
        assert rel_l2(got, want) < 1e-3, (k, rel_l2(got, want))
    assert opt.adamw.state[opt.leaves[0]]["step"] == 2


def test_state_dict_export_and_writer_match_jax(talker, tmp_path):
    """talker_params_to_state_dict equals JAX's, key for key and value for
    value; the port's writer's file loads in both packages (fp32 and bf16)."""
    cfg, jp, tp = talker
    want = j_to_sd(jp, cfg.talker_config)
    got = talker_params_to_state_dict(tp, cfg.talker_config)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for dtype in (torch.float32, torch.bfloat16):
        path = tmp_path / f"{dtype}".replace("torch.", "")
        path.mkdir()
        save_safetensors(str(path / "model.safetensors"),
                         {k: v.to(dtype) for k, v in got.items()})
        jtree = j_flatten(j_load_dir(str(path), dtype=jnp.float32))
        ttree = read_safetensors(str(path / "model.safetensors"))
        assert set(jtree) == set(ttree) == set(want)
        for k in want:
            expect = torch.tensor(np.asarray(want[k])).to(dtype).float().numpy()
            np.testing.assert_array_equal(np.asarray(jtree[k]), expect, err_msg=k)
            assert ttree[k].dtype == dtype
            np.testing.assert_array_equal(ttree[k].float().numpy(), expect, err_msg=k)


def test_checkpoint_round_trip(talker, tmp_path):
    """save / latest / restore of params and the optimizer's state, keep=2
    pruning, and an interrupted save that does not count."""
    cfg, _, tp = talker
    params = ttrain.trainable(tp)
    opt = ttrain.default_optimizer(params, lr=1e-3, grad_accum=2)
    step = ttrain.make_train_step(cfg.talker_config, opt)
    (b, spk), = _batches(cfg, 4)
    for _ in range(3):
        step(params, _tbatch(b), torch.from_numpy(spk))
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    for s in (1, 2, 3):
        tckpt.save_train_state(d, s, params, opt.state_dict(), keep=2)
    (tmp_path / "ckpt" / "step_00000009.tmp-1").mkdir()
    assert tckpt.latest_step(d) == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()
                  if not p.name.endswith("tmp-1")) == ["step_00000002", "step_00000003"]
    rparams, rstate, rstep = tckpt.restore_train_state(d, template=params)
    assert rstep == 3
    for k, v in flatten_state_dict(params).items():
        if v is not None:
            torch.testing.assert_close(flatten_state_dict(rparams)[k], v.detach(), rtol=0, atol=0)
    opt2 = ttrain.default_optimizer(ttrain.trainable(rparams), lr=1e-3, grad_accum=2)
    opt2.load_state_dict(rstate)
    assert opt2.mini_step == opt.mini_step == 1
    for a, b2 in zip(opt.acc, opt2.acc):
        torch.testing.assert_close(a, b2, rtol=0, atol=0)
    s1, s2 = opt.adamw.state_dict()["state"], opt2.adamw.state_dict()["state"]
    assert set(s1) == set(s2)
    for i in s1:
        torch.testing.assert_close(s1[i]["exp_avg_sq"], s2[i]["exp_avg_sq"], rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(str(tmp_path / "none"))


def test_prepare_data_matches_jax(tmp_path):
    """Both packages' prepare_data through their 12 Hz tokenizers (the same
    tiny Mimi encoder) write the same rows."""
    from qwen3_tts_tpu.config import CodecV2Config as JCodecCfg
    from qwen3_tts_tpu.config import MimiEncoderConfig as JMimiCfg
    from qwen3_tts_tpu.inference.tokenizer import Qwen3TTSTokenizer as JTok
    from qwen3_tts_tpu.models.codec12 import encoder as jenc
    from qwen3_tts_tpu_torch.config import CodecV2Config, MimiEncoderConfig
    from qwen3_tts_tpu_torch.inference.tokenizer import Qwen3TTSTokenizer as TTok
    from qwen3_tts_tpu_torch.models.codec12 import encoder as tenc
    from qwen3_tts_tpu_torch.utils.testing import mimi_encoder_state
    from tests.test_codec12_encoder import TINY as ENC_TINY
    from tests.test_torch_voice_clone import CODEC_KW, DEC_CFG

    enc = mimi_encoder_state(MimiEncoderConfig.from_dict(ENC_TINY), 2)
    jcfg = JCodecCfg(encoder_config=JMimiCfg.from_dict(ENC_TINY), decoder_config=DEC_CFG,
                     **CODEC_KW)
    jtok = JTok.from_params(jcfg, enc_params=jenc.prepare_encoder_params(
        jax.tree_util.tree_map(jnp.asarray, enc), jcfg.encoder_config))
    tcfg = CodecV2Config(encoder_config=MimiEncoderConfig.from_dict(ENC_TINY),
                         decoder_config=DEC_CFG, **CODEC_KW)
    ttok = TTok.from_params(tcfg, enc_params=tenc.prepare_encoder_params(
        from_jax_tree(enc), tcfg.encoder_config))
    rng = np.random.default_rng(5)
    rows = []
    for i, n in enumerate((400, 300, 520)):
        write_wav(str(tmp_path / f"a{i}.wav"), rng.uniform(-0.5, 0.5, n), 1000)
        rows.append({"audio": str(tmp_path / f"a{i}.wav"), "text": f"line {i}",
                     "ref_audio": str(tmp_path / "a0.wav")})
    with open(tmp_path / "in.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    assert jdata.prepare_data(str(tmp_path / "in.jsonl"), str(tmp_path / "j.jsonl"), jtok,
                              batch_size=2) == 3
    assert tdata.prepare_data(str(tmp_path / "in.jsonl"), str(tmp_path / "t.jsonl"), ttok,
                              batch_size=2) == 3
    with open(tmp_path / "j.jsonl") as fj, open(tmp_path / "t.jsonl") as ft:
        want, got = [json.loads(x) for x in fj], [json.loads(x) for x in ft]
    assert got == want
    assert all(np.asarray(r["audio_codes"]).shape[1] == 4 for r in got)


@pytest.mark.parametrize("flags", [("--dp", "2"), ("--tp", "2"), ("--dp", "2", "--tp", "2")])
def test_sft_dp_tp_must_equal_the_world_size(flags):
    """Without a launcher the world is one rank: any --dp x --tp other than
    1 raises before anything loads (tests/test_torch_parallel.py runs the
    2-rank case)."""
    with pytest.raises(ValueError, match="must equal the world size 1"):
        tsft.main(["--init_model_path", "x", "--train_jsonl", "y", *flags])


@pytest.fixture(scope="module")
def sft_runs(tmp_path_factory):
    """A tiny base checkpoint, four training rows sharing one reference
    clip, and one epoch of each package's sft.main on them (batch 2,
    grad_accum 1: two updates)."""
    d = tmp_path_factory.mktemp("sft")
    base = d / "base"
    base.mkdir()
    cfg_json = _base_json()
    tc = TTSModelConfig.from_dict(cfg_json)
    params = random_talker_params(tc.talker_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
    sd = {k: np.asarray(v) for k, v in j_to_sd(params, tc.talker_config).items()}
    sd.update(flatten_state_dict(speaker_encoder_state(tc.speaker_encoder_config, 1),
                                 "speaker_encoder"))
    save_safetensors(str(base / "model.safetensors"), sd)
    with open(base / "config.json", "w") as f:
        json.dump(cfg_json, f)
    rng = np.random.default_rng(6)
    write_wav(str(d / "ref.wav"), 0.3 * np.sin(np.arange(9600) / 7.0), 24000)
    with open(d / "train.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"text": f"training line number {i}",
                                "audio_codes": rng.integers(0, 60, (5 + i, Q)).tolist(),
                                "ref_audio": str(d / "ref.wav")}) + "\n")
    argv = ["--init_model_path", str(base), "--train_jsonl", str(d / "train.jsonl"),
            "--batch_size", "2", "--grad_accum", "1", "--lr", "1e-3", "--num_epochs", "1",
            "--speaker_name", "newvoice", "--speaker_row", "1030"]
    jsft.main(argv + ["--output_model_path", str(d / "jax")], processor=FakeTokenizer())
    tsft.main(argv + ["--output_model_path", str(d / "port"), "--device", "cpu"],
              processor=FakeTokenizer())
    return d / "jax" / "checkpoint-epoch-0", d / "port" / "checkpoint-epoch-0", params


def test_sft_main_matches_jax(sft_runs):
    jdir, tdir, base = sft_runs
    with open(jdir / "config.json") as fj, open(tdir / "config.json") as ft:
        jc, tcj = json.load(fj), json.load(ft)
    assert tcj == jc
    assert tcj["tts_model_type"] == "custom_voice"
    assert tcj["talker_config"]["spk_id"] == {"newvoice": 1030}
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    want = {k: np.asarray(v) for k, v in j_flatten(j_load_dir(str(jdir))).items()}
    got = {k: v.numpy() for k, v in read_safetensors(str(tdir / "model.safetensors")).items()}
    assert set(got) == set(want) and not any(k.startswith("speaker_encoder") for k in got)
    base_sd = j_to_sd(base, JTTSCfg.from_dict(MODEL_TINY).talker_config)
    spk_key = "talker.model.codec_embedding.weight"
    moved = 0
    for k in want:
        g, w = got[k].astype(np.float64), want[k].astype(np.float64)
        b = base_sd[k].astype(np.float32).astype(np.float64)
        assert got[k].dtype == np.float32 and g.shape == w.shape, k
        if k == spk_key:   # the speaker row is compared below
            g, w, b = (np.delete(x, 1030, axis=0) for x in (g, w, b))
        assert np.all(np.abs(g - w) <= 2 * np.abs(w) * 2.0 ** -7 + 4e-3), k
        ug, uw = (g - b).ravel(), (w - b).ravel()
        if np.any(uw):
            moved += 1
            cos = ug @ uw / np.sqrt((ug @ ug) * (uw @ uw))
            assert cos >= 0.6, (k, cos)
    assert moved > len(want) // 2       # the training changed most tensors
    row = got[spk_key][1030]
    assert rel_l2(row, want[spk_key][1030]) < 2e-2
    assert rel_l2(row, base_sd[spk_key][1030]) > 0.5   # the learned speaker, not the base row


def test_sft_checkpoint_reloads_and_speaks(sft_runs):
    """The port's epoch checkpoint reloads in both packages (fp32) as a
    custom-voice model with the new speaker; greedy codes equal."""
    _, tdir, _ = sft_runs
    jm = jmodel.Qwen3TTSModel.from_pretrained(str(tdir), dtype=jnp.float32)
    tm = tmodel.Qwen3TTSModel.from_pretrained(str(tdir), dtype=torch.float32, device="cpu")
    assert tm.tts_model_type == "custom_voice" and tm.get_supported_speakers() == ["newvoice"]
    assert tm.speaker_encoder_params is None
    texts = ["a new voice speaks", "and a second line"]
    codes = []
    for m in (jm, tm):
        m.processor = FakeTokenizer()
        specs = m._specs_custom_voice(texts, "newvoice", "english", None, True)
        gen = m._generation_config(m._merge_generate_kwargs(
            do_sample=False, subtalker_dosample=False, max_new_tokens=10))
        codes.append(m._run(specs, gen, seed=0))
    assert all(c.shape[0] > 0 for c in codes[1])
    for ct, cj in zip(codes[1], codes[0]):
        np.testing.assert_array_equal(ct, cj)
