"""The port's DP / TP plans (`parallel/mesh.py`) against the JAX package.

The plan: the port's specs equal the JAX package's `talker_param_specs`
entry by entry (float and int8 trees); the head-aligned shards reassemble
to the unsharded tree, and differ from the contiguous split the JAX spec
literally names (on the tiny config, 4 query / 2 KV heads, a contiguous
qkv split gives rank 0 every query head).

The execution: gloo ranks on the CPU, spawned fresh (`spawn_ranks`: a rank
imports no JAX; this module imports JAX only inside the parent's fixtures
and tests, and each rank reports whether `jax` reached its sys.modules).
One spawn per mesh shape runs every check of that shape; the parent
computes the references and compares. Tolerances:
- fp32 greedy `generate_frames` codes and lengths at (dp, tp) in {(2, 1),
  (1, 2), (2, 2)} equal the JAX package's unsharded run; a sampled run
  (one seeded generator, the whole batch's noise drawn on every rank)
  equals the port's unsharded run; a contiguous qkv / gate_up split gives
  other logits (max abs > 0.1, logits of magnitude ~3) where the
  head-aligned one agrees (1e-4);
- a mesh engine at (2, 1) and (1, 2): every request's codes equal the
  unsharded engine's (port and JAX);
- SFT at dp=2 and tp=2: the loss within 1e-5 relative and every leaf's
  gradient within 2e-4 relative L2 of the single-process port and of
  `jax.value_and_grad` (the existing finetune tolerance); two optimizer
  cycles, the clip binding and not: the clip norms within 1e-4 relative,
  the same clip decisions, each leaf's parameter change within the
  existing 1e-3 relative L2 of optax's (Adam divides by each element's own
  gradient magnitude, so tiny elements carry the reduction order's
  differences into the update);
- `sft.main` under 2 ranks (dp=2 and tp=2, bf16): config.json and files
  equal the single-process run's; every element within the existing
  finetune rule (2 bf16 ulps + 4e-3) and the speaker row within 2e-2;
- the fused kernels under a mesh raise ValueError.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from qwen3_tts_tpu_torch.parallel import mesh as tmesh
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, spawn_ranks

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

M = 12   # max_new_tokens of the generation checks


class _Tok:
    """The char-hash stand-in text tokenizer of tests/test_torch_pipeline.py
    (kept here so a rank imports nothing of JAX)."""

    def __call__(self, text, return_tensors=None, **kw):
        ids = [1 + (ord(c) * 7 + i) % 39 for i, c in enumerate(text)][:24]
        ids = ids + [1] * max(0, 9 - len(ids))
        return {"input_ids": np.asarray([ids], dtype=np.int64)}


def _fake_mesh(tp=1, tp_rank=0, dp=1, dp_rank=0):
    return tmesh.Mesh(dp, tp, dp_rank, tp_rank, None, None, torch.device("cpu"))


# ---------------------------------------------------------------------------
# Rank programs (no JAX)
# ---------------------------------------------------------------------------


def _gen_cfg(sample: bool):
    from qwen3_tts_tpu_torch.ops.sampling import SamplingParams
    from qwen3_tts_tpu_torch.runtime.generate import GenerationConfig

    return GenerationConfig(max_new_tokens=M,
                            sampling=SamplingParams(do_sample=sample, repetition_penalty=1.05),
                            subtalker=SamplingParams(do_sample=sample))


def _generate(params, cfg, inputs, sample: bool, mesh=None):
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames

    with torch.no_grad():
        out = generate_frames(params, cfg, _gen_cfg(sample), *map(torch.from_numpy, inputs),
                              torch.Generator().manual_seed(3), mesh=mesh)
    return out.codes.numpy(), out.lengths.numpy()


def _engine(params, cfg, reqs, mesh=None):
    from qwen3_tts_tpu_torch.runtime.batching import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(params, cfg, _gen_cfg(False), num_slots=4, max_len=64,
                                   max_trailing=8, prefill_bucket=16, dtype=torch.float32,
                                   mesh=mesh)
    for rid, (e, tr, pad, mf) in enumerate(reqs):
        eng.submit(Request(request_id=rid, inputs_embeds=torch.from_numpy(e),
                           attn_mask=torch.ones((1, e.shape[1]), dtype=torch.int32),
                           trailing=torch.from_numpy(tr), trailing_len=tr.shape[1],
                           tts_pad=torch.from_numpy(pad), max_frames=mf))
    return {c.request_id: np.asarray(c.codes) for c in eng.run_until_drained()}


def _sft(params, cfg, batches, clip, mesh=None):
    """Four train steps (grad_accum 2: two cycles) at lr 1e-3. Returns
    (losses, clip norms, the first step's gradients, the params after),
    gradients and params unsharded, flat."""
    from qwen3_tts_tpu_torch.finetune import train
    from qwen3_tts_tpu_torch.weights import flatten_state_dict

    plan = sharded = None
    if mesh is not None:
        plan = tmesh.tp_shard_plan(params, mesh)
        sharded = train.param_flags(params, plan)
        params = tmesh.shard_talker_params(params, mesh, plan)
    p = train.trainable(params)
    opt = train.default_optimizer(p, lr=1e-3, clip_norm=clip, grad_accum=2, mesh=mesh,
                                  sharded=sharded)
    step = train.make_train_step(cfg, opt)
    rows = slice(None) if mesh is None else mesh.rows(batches[0][1].shape[0])
    losses, norms, grads = [], [], None

    def whole(tree):
        tree = tree if mesh is None else tmesh.unshard_talker_params(tree, plan, mesh)
        return {k: v.detach().numpy().copy() for k, v in flatten_state_dict(tree).items()
                if v is not None}

    for i in range(4):
        b, spk = batches[i % 2]
        m = step(p, {k: torch.as_tensor(v[rows]) for k, v in b.items()},
                 torch.as_tensor(spk[rows]))
        losses.append(float(m["loss"]))
        if i == 0:   # after one mini-step the running mean is its gradients
            acc = iter(opt.acc)
            grads = whole(_tree_like(p, acc))
        if m["updated"]:
            norms.append(opt.last_norm)
    return losses, norms, grads, whole(p)


def _tree_like(tree, leaves):
    """A tree shaped like `tree` whose leaves come from `leaves` in
    `param_leaves` order (sorted keys)."""
    if isinstance(tree, dict):
        return {k: _tree_like(tree[k], leaves) for k in sorted(tree)}
    return None if tree is None else next(leaves)


def _contiguous_logits(params, cfg, inputs, mesh):
    """talker_prefill logits with the head-aligned shards and with a
    contiguous split of the fused qkv / gate_up rows."""
    from qwen3_tts_tpu_torch.models.talker import talker_prefill

    plan = tmesh.tp_shard_plan(params, mesh)
    aligned = tmesh.shard_talker_params(params, mesh, plan)
    contiguous = dict(aligned, layers=dict(aligned["layers"]))
    lay = params["layers"]
    for grp, name in (("self_attn", "qkv_proj"), ("mlp", "gate_up_proj")):
        w = lay[grp][name]["weight"]
        n = w.shape[-2] // mesh.tp
        contiguous["layers"][grp] = dict(aligned["layers"][grp])
        contiguous["layers"][grp][name] = {"weight": w[:, mesh.tp_rank * n:(mesh.tp_rank + 1) * n]}
    e, m = (torch.from_numpy(x) for x in inputs[:2])
    with torch.no_grad():
        return [talker_prefill(p, cfg, e, m, None, allow_flash=False, mesh=mesh)[0].numpy()
                for p in (aligned, contiguous)]


def _rank_program(rank, world, dp, tp, data):
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    mesh = tmesh.make_mesh(dp, tp, device="cpu")
    tc = TTSModelConfig.from_dict(data["model_json"]).talker_config
    params = from_jax_tree(data["params"])
    local = tmesh.shard_talker_params(params, mesh)
    out = {"greedy": _generate(local, tc, data["inputs"], False, mesh),
           "sampled": _generate(local, tc, data["inputs"], True, mesh)}
    if dp * tp == 2:
        out["engine"] = _engine(local, tc, data["requests"], mesh)
        sft_params = from_jax_tree(data["sft_params"])
        out["sft"] = {clip: _sft(sft_params, tc, data["batches"], clip, mesh)
                      for clip in (0.05, 1e6)}
        from qwen3_tts_tpu_torch.finetune import sft

        sft.main(data["sft_argv"] + ["--dp", str(dp), "--tp", str(tp)], processor=_Tok())
    if tp == 2:
        out["contiguous"] = _contiguous_logits(params, tc, data["inputs"], mesh)
    if (dp, tp) == (2, 1):
        try:
            tmesh.make_mesh(2, 2, device="cpu")
        except ValueError as e:
            out["too_big"] = str(e)
    out["jax_loaded"] = "jax" in sys.modules
    return out


# ---------------------------------------------------------------------------
# Parent: references and spawns
# ---------------------------------------------------------------------------


SHAPES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.utils.audio import write_wav
    from qwen3_tts_tpu_torch.utils.testing import speaker_encoder_state
    from qwen3_tts_tpu_torch.weights import (flatten_state_dict, save_safetensors,
                                             talker_params_to_state_dict, from_jax_tree)
    from tests.test_pipeline_parity import MODEL_TINY
    from tests.test_torch_finetune import _base_json, _batches

    tc = TTSModelConfig.from_dict(MODEL_TINY)
    jp = random_talker_params(tc.talker_config, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = jax.tree_util.tree_map(lambda x: np.asarray(x) * 3.0, jp)
    rng = np.random.default_rng(5)
    B, T, Tt, H = 4, 6, 3, tc.talker_config.hidden_size
    embeds = rng.normal(0, 0.3, (B, T, H)).astype(np.float32)
    mask = np.ones((B, T), np.int64)
    mask[1, :2] = mask[3, :1] = 0
    embeds[1, :2] = embeds[3, :1] = 0.0
    inputs = (embeds, mask, rng.normal(0, 0.3, (B, Tt, H)).astype(np.float32),
              rng.normal(0, 0.3, (1, 1, H)).astype(np.float32))
    requests = []
    for i in range(5):
        n = int(rng.integers(4, 9))
        requests.append((rng.normal(0, 0.3, (1, n, H)).astype(np.float32),
                         rng.normal(0, 0.3, (1, 3, H)).astype(np.float32), inputs[3], 5 + i))

    # sft.main's base checkpoint and rows (as tests/test_torch_finetune.py)
    d = tmp_path_factory.mktemp("parallel_sft")
    (d / "base").mkdir()
    cfg_json = _base_json()
    btc = TTSModelConfig.from_dict(cfg_json)
    sd = talker_params_to_state_dict(from_jax_tree(jp), btc.talker_config)
    sd.update({k: torch.from_numpy(np.asarray(v)) for k, v in flatten_state_dict(
        speaker_encoder_state(btc.speaker_encoder_config, 1), "speaker_encoder").items()})
    save_safetensors(str(d / "base" / "model.safetensors"), sd)
    with open(d / "base" / "config.json", "w") as f:
        json.dump(cfg_json, f)
    write_wav(str(d / "ref.wav"), 0.3 * np.sin(np.arange(9600) / 7.0), 24000)
    with open(d / "train.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"text": f"training line number {i}",
                                "audio_codes": rng.integers(0, 60, (5 + i, 4)).tolist(),
                                "ref_audio": str(d / "ref.wav")}) + "\n")
    argv = ["--init_model_path", str(d / "base"), "--train_jsonl", str(d / "train.jsonl"),
            "--batch_size", "2", "--grad_accum", "1", "--lr", "1e-3", "--num_epochs", "1",
            "--speaker_name", "newvoice", "--speaker_row", "1030", "--device", "cpu"]
    data = {"model_json": MODEL_TINY, "params": jp, "sft_params": jp, "inputs": inputs,
            "requests": requests, "batches": _batches(tc, 3, n_batches=2)}
    runs = {}
    for dp, tp in SHAPES:
        out = str(d / f"out_{dp}x{tp}")
        runs[(dp, tp)] = spawn_ranks(_rank_program, dp * tp, dp, tp,
                                     dict(data, sft_argv=argv + ["--output_model_path", out]))
        runs[(dp, tp)][0]["sft_dir"] = out
    from qwen3_tts_tpu_torch.finetune import sft

    sft.main(argv + ["--output_model_path", str(d / "single")], processor=_Tok())
    return dict(data, cfg=tc, runs=runs, single=str(d / "single"), cfg_json=cfg_json)


def _jax_reference_codes(w):
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSModelConfig as JCfg
    from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
    from qwen3_tts_tpu.runtime import generate as jgen

    tc = JCfg.from_dict(w["model_json"]).talker_config
    gen_cfg = jgen.GenerationConfig(max_new_tokens=M,
                                    sampling=JS(do_sample=False, repetition_penalty=1.05),
                                    subtalker=JS(do_sample=False))
    params = jax.tree_util.tree_map(jnp.asarray, w["params"])
    out = jgen.generate_frames(params, tc, gen_cfg, *map(jnp.asarray, w["inputs"]),
                               jax.random.PRNGKey(0))
    return np.asarray(out.codes), np.asarray(out.lengths)


@pytest.mark.parametrize("dp,tp", SHAPES)
def test_sharded_generation_matches_unsharded(world, dp, tp):
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    want_codes, want_lens = _jax_reference_codes(world)
    sampled = _generate(from_jax_tree(world["params"]), world["cfg"].talker_config,
                        world["inputs"], True)
    assert want_lens.min() > 1
    for res in world["runs"][(dp, tp)]:
        assert not res["jax_loaded"]
        codes, lens = res["greedy"]
        np.testing.assert_array_equal(lens, want_lens)
        for b in range(codes.shape[0]):
            np.testing.assert_array_equal(codes[b, :lens[b]], want_codes[b, :want_lens[b]])
        np.testing.assert_array_equal(res["sampled"][0], sampled[0])
        np.testing.assert_array_equal(res["sampled"][1], sampled[1])


def test_head_aligned_split_is_what_agrees(world):
    """At tp=2 the head-aligned shards give the unsharded prefill's logits;
    the contiguous split of the fused rows does not."""
    from qwen3_tts_tpu_torch.models.talker import talker_prefill
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    e, m = (torch.from_numpy(x) for x in world["inputs"][:2])
    with torch.no_grad():
        want = talker_prefill(from_jax_tree(world["params"]), world["cfg"].talker_config, e, m,
                              None, allow_flash=False)[0].numpy()
    for res in world["runs"][(1, 2)]:
        aligned, contiguous = res["contiguous"]
        np.testing.assert_allclose(aligned, want, rtol=0, atol=1e-4)
        assert np.abs(contiguous - want).max() > 0.1


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_mesh_engine_matches_unsharded(world, dp, tp):
    import jax.numpy as jnp

    from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
    from qwen3_tts_tpu.runtime import batching as jbatch
    from qwen3_tts_tpu.runtime import generate as jgen
    from qwen3_tts_tpu.config import TTSModelConfig as JCfg
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    want = _engine(from_jax_tree(world["params"]), world["cfg"].talker_config, world["requests"])
    import jax

    jeng = jbatch.ContinuousBatchingEngine(
        jax.tree_util.tree_map(jnp.asarray, world["params"]),
        JCfg.from_dict(world["model_json"]).talker_config,
        jgen.GenerationConfig(max_new_tokens=M, sampling=JS(do_sample=False,
                                                            repetition_penalty=1.05),
                              subtalker=JS(do_sample=False)),
        num_slots=4, max_len=64, max_trailing=8, prefill_bucket=16, dtype=jnp.float32)
    for rid, (e, tr, pad, mf) in enumerate(world["requests"]):
        jeng.submit(jbatch.Request(request_id=rid, inputs_embeds=jnp.asarray(e),
                                   attn_mask=jnp.ones((1, e.shape[1]), jnp.int32),
                                   trailing=jnp.asarray(tr), trailing_len=tr.shape[1],
                                   tts_pad=jnp.asarray(pad), max_frames=mf))
    jwant = {c.request_id: np.asarray(c.codes) for c in jeng.run_until_drained()}
    assert set(want) == set(jwant) == set(range(len(world["requests"])))
    for rid in want:
        assert len(want[rid]) > 0
        np.testing.assert_array_equal(want[rid], jwant[rid])
    for res in world["runs"][(dp, tp)]:
        got = res["engine"]
        assert set(got) == set(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clip_binds", "clip_free"])
@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_sft_step_matches_single_process_and_optax(world, dp, tp, clip):
    import jax
    import jax.numpy as jnp
    import optax

    from qwen3_tts_tpu.finetune import train as jtrain
    from qwen3_tts_tpu.weights import flatten_state_dict as j_flatten
    from qwen3_tts_tpu_torch.weights import from_jax_tree

    tc = world["cfg"].talker_config
    losses, norms, grads, after = _sft(from_jax_tree(world["sft_params"]), tc,
                                       world["batches"], clip)
    jp = jax.tree_util.tree_map(jnp.asarray, world["sft_params"])
    (b0, spk0) = world["batches"][0]
    jbatch = {k: jnp.asarray(v) for k, v in b0.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtrain.sft_loss, has_aux=True),
                                 static_argnums=1)(jp, tc, jbatch, jnp.asarray(spk0))
    jopt = optax.MultiSteps(jtrain.default_optimizer(lr=1e-3, clip_norm=clip),
                            every_k_schedule=2)
    jstate, jparams = jopt.init(jp), jp
    jstep = jax.jit(jtrain.make_train_step(tc, jopt))
    for i in range(4):
        b, spk = world["batches"][i % 2]
        jparams, jstate, _ = jstep(jparams, jstate, {k: jnp.asarray(v) for k, v in b.items()},
                                   jnp.asarray(spk))
    jg, j0, j1 = j_flatten(jgrads), j_flatten(jp), j_flatten(jparams)
    for res in world["runs"][(dp, tp)]:
        got_losses, got_norms, got_grads, got_after = res["sft"][clip]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        np.testing.assert_allclose(got_losses[0], float(jloss), rtol=1e-5)
        np.testing.assert_allclose(got_norms, norms, rtol=1e-4)
        assert [n >= clip for n in got_norms] == [n >= clip for n in norms]
        assert set(got_grads) == set(grads)
        for k, g in got_grads.items():
            want = np.asarray(jg[k])
            if not np.any(want):
                assert not np.any(g), k
                continue
            assert _rel(g, grads[k]) < 2e-4, (k, _rel(g, grads[k]))
            assert _rel(g, want) < 2e-4, (k, _rel(g, want))
        for k, v in got_after.items():
            w = np.asarray(j1[k]) - np.asarray(j0[k])
            assert _rel(v - np.asarray(j0[k]), w) < 1e-3, (k, _rel(v - np.asarray(j0[k]), w))


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)])
def test_sft_main_under_two_ranks_writes_the_single_process_checkpoint(world, dp, tp):
    import os

    from qwen3_tts_tpu_torch.weights import read_safetensors

    single = os.path.join(world["single"], "checkpoint-epoch-0")
    got_dir = os.path.join(world["runs"][(dp, tp)][0]["sft_dir"], "checkpoint-epoch-0")
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(single))
    with open(os.path.join(got_dir, "config.json")) as f1, \
            open(os.path.join(single, "config.json")) as f2:
        assert json.load(f1) == json.load(f2)
    want = {k: v.numpy() for k, v in read_safetensors(os.path.join(single, "model.safetensors")).items()}
    got = {k: v.numpy() for k, v in read_safetensors(os.path.join(got_dir, "model.safetensors")).items()}
    assert set(got) == set(want)
    spk_key = "talker.model.codec_embedding.weight"
    for k, w in want.items():
        g = got[k]
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if k == spk_key:
            assert _rel(g[1030], w[1030]) < 2e-2
            g, w = np.delete(g, 1030, axis=0), np.delete(w, 1030, axis=0)
        assert np.all(np.abs(g - w) <= 2 * np.abs(w) * 2.0 ** -7 + 4e-3), k


def test_make_mesh_refuses_more_ranks_than_the_world(world):
    assert world["runs"][(2, 1)][0]["too_big"] == "need 4 ranks, have 2"


def test_specs_equal_the_jax_plan():
    """The fake trees of tests/test_parallel.py (float and int8) and a real
    prepared tree, int8 too: every spec equals the JAX package's, entry by
    entry."""
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.parallel.mesh import talker_param_specs as jspecs
    from qwen3_tts_tpu.utils.testing import random_talker_params
    from qwen3_tts_tpu.weights import quantize_talker_params
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from tests.test_pipeline_parity import MODEL_TINY

    fake = {
        "layers": {"self_attn": {"qkv_proj": {"weight": 0}, "o_proj": {"weight": 0}},
                   "mlp": {"gate_up_proj": {"weight": 0}, "down_proj": {"weight": 0}}},
        "codec_head": 0,
        "code_predictor": {"proj": None},
    }
    quant = {
        "layers": {"self_attn": {"qkv_proj": {"weight": {"q": 0, "s": 0}}}},
        "codec_head": {"q": 0, "s": 0},
        "code_predictor": {"layers": {"mlp": {"down_proj": {"weight": {"q": 0, "s": 0}}}}},
    }
    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    real = random_talker_params(tc, jax.random.PRNGKey(0), dtype=jnp.float32)
    trees = [fake, quant, real, quantize_talker_params(real)]
    for tree in trees:
        want = jax.tree_util.tree_leaves(jspecs(tree), is_leaf=lambda x: x is None or
                                         isinstance(x, jax.sharding.PartitionSpec))
        got = jax.tree_util.tree_leaves(tmesh.talker_param_specs(tree),
                                        is_leaf=lambda x: x is None or isinstance(x, tuple))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g == tuple(w), (g, w)
    assert tmesh.talker_param_specs(quant)["layers"]["self_attn"]["qkv_proj"]["weight"] == {
        "q": (None, "tp", None), "s": (None, "tp")}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_head_aligned_shards_reassemble(tp, quantized):
    """Each rank's qkv rows are its query heads, then its key heads, then
    its value heads; its gate_up rows its gate slice then its up slice;
    int8 scales of rowwise weights stay whole; placing every rank's shard at
    its plan's index rebuilds the unsharded tree exactly. At tp=4 the tiny
    config's 2 KV heads do not split: attention stays replicated, the MLP
    and the vocabulary heads still split (the JAX package's per-axis
    fallback to replication)."""
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from qwen3_tts_tpu_torch.weights import flatten_state_dict, quantize_talker_params
    from tests.test_pipeline_parity import MODEL_TINY

    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    full = random_talker_params(tc, torch.Generator().manual_seed(0), dtype=torch.float32)
    if quantized:
        full = quantize_talker_params(full)
    flat = {k: v for k, v in flatten_state_dict(full).items() if v is not None}
    rebuilt = {k: torch.zeros_like(v) for k, v in flat.items()}
    D, Hq, Hkv = tc.resolved_head_dim, tc.num_attention_heads, tc.num_key_value_heads
    attn_split = Hkv % tp == 0
    for r in range(tp):
        mesh = _fake_mesh(tp=tp, tp_rank=r)
        plan = flatten_state_dict(tmesh.tp_shard_plan(full, mesh))
        local = flatten_state_dict(tmesh.shard_talker_params(full, mesh))
        for k, v in flat.items():
            s = plan.get(k)
            if s is None:
                assert local[k] is flat[k], k
                rebuilt[k] = v
            else:
                assert local[k].shape[s.axis] * tp == v.shape[s.axis], k
                rebuilt[k].index_copy_(v.ndim + s.axis, s.index, local[k])
        qkv_key = "layers.self_attn.qkv_proj.weight" + (".q" if quantized else "")
        if attn_split:
            hq, hk = Hq // tp, Hkv // tp
            w = flat[qkv_key]
            want = torch.cat([w[:, r * hq * D:(r + 1) * hq * D],
                              w[:, (Hq + r * hk) * D:(Hq + (r + 1) * hk) * D],
                              w[:, (Hq + Hkv + r * hk) * D:(Hq + Hkv + (r + 1) * hk) * D]], 1)
            assert torch.equal(local[qkv_key], want)
            contiguous = w[:, r * w.shape[1] // tp:(r + 1) * w.shape[1] // tp]
            assert not torch.equal(local[qkv_key], contiguous)
        else:
            assert plan.get(qkv_key) is None
        gu_key = "layers.mlp.gate_up_proj.weight" + (".q" if quantized else "")
        inter = tc.intermediate_size // tp
        w = flat[gu_key]
        assert torch.equal(local[gu_key], torch.cat(
            [w[:, r * inter:(r + 1) * inter],
             w[:, tc.intermediate_size + r * inter:tc.intermediate_size + (r + 1) * inter]], 1))
        if quantized:
            assert plan.get("layers.mlp.down_proj.weight.s") is None
            assert plan.get("layers.mlp.gate_up_proj.weight.s") is not None
    for k, v in flat.items():
        assert torch.equal(rebuilt[k], v), k


def test_slot_state_shards_over_dp_and_tp():
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.runtime.batching import init_slot_state
    from tests.test_pipeline_parity import MODEL_TINY

    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    state = init_slot_state(tc, 4, 32, 8, torch.float32, prefill_bucket=8, staging_rows=6)
    state.cache.k.copy_(torch.arange(state.cache.k.numel(), dtype=torch.float32)
                        .reshape(state.cache.k.shape))
    state.req_id.copy_(torch.arange(4))
    local = tmesh.shard_slot_state(state, _fake_mesh(tp=2, tp_rank=1, dp=2, dp_rank=1))
    assert torch.equal(local.cache.k, state.cache.k[:, 2:4, 1:2])
    assert local.staged.k.shape[1:3] == (3, 1)
    assert torch.equal(local.req_id, torch.tensor([2, 3], dtype=torch.int32))
    assert local.tts_pad is state.tts_pad
    with pytest.raises(ValueError, match="dp=3"):
        tmesh.shard_slot_state(state, _fake_mesh(dp=3))


def test_fused_kernels_raise_under_a_mesh():
    from qwen3_tts_tpu_torch.config import TTSModelConfig
    from qwen3_tts_tpu_torch.models.talker import code_predictor_frame_dispatch
    from qwen3_tts_tpu_torch.runtime.batching import ContinuousBatchingEngine
    from qwen3_tts_tpu_torch.runtime.generate import generate_frames
    from qwen3_tts_tpu_torch.utils.testing import random_talker_params
    from tests.test_pipeline_parity import MODEL_TINY

    tc = TTSModelConfig.from_dict(MODEL_TINY).talker_config
    params = random_talker_params(tc, torch.Generator().manual_seed(0), dtype=torch.float32)
    mesh = _fake_mesh()
    x = torch.zeros((2, 4, tc.hidden_size))
    for flag in ("fused_subtalker", "fused_talker_step"):
        cfg = dataclasses.replace(_gen_cfg(False), **{flag: True})
        with pytest.raises(ValueError, match="mesh"):
            generate_frames(params, tc, cfg, x, torch.ones((2, 4)), x[:, :1], x[:1, :1],
                            torch.Generator(), mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            ContinuousBatchingEngine(params, tc, cfg, num_slots=2, max_len=64, mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        code_predictor_frame_dispatch(params, tc, x[:, :1], x[:, :1], None, fused=True,
                                      mesh=mesh)
