"""The prefill stage of the port as it runs under CUDA graphs, against the
JAX package, on the CPU.

On the card, `init_decode_state` is one replay of a graph context's prefill
graph and the engine's staging prefill one replay of a staging graph
(runtime/graphs.py); chip_smoke.py holds both to the eager route there (KV
cache max abs 0, equal codes). Here:
- the kernels' fit predicates (`build.layer_misfit`, `subtalker` and
  `talker_step` `config_misfit`) on `TalkerConfig()` and the released
  presets, and the defaults they set: an int8 model on a CUDA device
  defaults to a kernel only where its shapes fit; a flag the caller names
  stays, and the kernel's launch check still raises;
- `flash_plan`'s shapes, fixed for one (B, T, Hkv, CTAs) whatever the
  starts, and the plan built from a host mask: its work items, walked tile
  by tile in fp32, give `flash_prefill_ref`'s output in fp64 within 1e-5;
- the eager `init_decode_state` fed a host mask against the JAX
  `init_decode_state`: KV cache and consts within 1e-4 (fp32, the prefill's
  sums in another order), the first code0 equal, greedy and with the same
  injected Gumbel noise in both;
- the prefill graph's route (`DecodeGraphs.prefill`) and the staging
  graphs (`ServeGraphs.stage`) with a stand-in for the CUDA capture (as in
  tests/test_torch_codec_graphs.py): their state equal to the eager
  route's exactly (the same CPU arithmetic), their keys and bounds;
- `stage_rows`' fixed-N merge against the JAX `stage_requests` on a batch
  with padding rows: staged KV, hidden and the integer fields within 1e-4
  / equal;
- grouped prompt assembly (`assemble_prompt_specs`) and the engine's
  `_pad_request` rows against the JAX package's: exactly in fp32 where the
  arithmetic is the same ops (the padding), and within 1e-6 relative where
  a projection sums in another order (a row of a batched matmul); bf16
  within 1e-2 (one bf16 ulp of the projection's output).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.ops.sampling import SamplingParams as JS
from qwen3_tts_tpu.runtime import batching as jbatch
from qwen3_tts_tpu.runtime import generate as jgen
from qwen3_tts_tpu.runtime.prompts import assemble_prompt_specs as j_assemble
from qwen3_tts_tpu_torch.config import TalkerConfig
from qwen3_tts_tpu_torch.models import talker as ttalker
from qwen3_tts_tpu_torch.ops import sampling as tsampling
from qwen3_tts_tpu_torch.ops.cuda import build, subtalker, talker_step
from qwen3_tts_tpu_torch.ops.cuda import prefill_attention as tpa
from qwen3_tts_tpu_torch.ops.sampling import SamplingParams as TS
from qwen3_tts_tpu_torch.runtime import batching as tbatch
from qwen3_tts_tpu_torch.runtime import generate as tgen
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.runtime.prompts import assemble_prompt_specs as t_assemble
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, TALKER_0B6, TALKER_1B7
from qwen3_tts_tpu_torch.weights import from_jax_tree
from tests.test_torch_pipeline import TEXTS, _models, checkpoint  # noqa: F401
from tests.test_torch_prefill_route import open_flash_route
from tests.test_torch_serving import _greedy, _prompts, _requests

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

STATE_TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT_TOL = dict(rtol=1e-6, atol=1e-6)   # fp32 rows of a projection
M = 8
# a talker whose only misfit for kernel 2 is its 4 query heads per kv head
G4 = TalkerConfig(hidden_size=256, intermediate_size=1536, num_attention_heads=8,
                  num_key_value_heads=2, head_dim=64, num_code_groups=16)


@pytest.mark.parametrize("name,cfg,fits", [
    ("bare", TalkerConfig(), False), ("0.6B", TALKER_0B6, True), ("1.7B", TALKER_1B7, True),
    ("G=4", G4, None)])
def test_fit_predicates(name, cfg, fits):
    """TalkerConfig()'s bare defaults fit neither kernel (8 query heads per
    kv head, 32 code groups); both released presets fit both; G=4 keeps
    kernel 2 off for its groups alone."""
    sub, step = subtalker.config_misfit(cfg), talker_step.config_misfit(cfg)
    if fits is None:
        assert "query heads over 2 kv heads" in step and sub is None
    elif fits:
        assert sub is None and step is None
    else:
        assert "16 slots" in sub and "groups of at most 2" in step
    # the predicate is the launch check's rule: the check raises with it
    D = cfg.resolved_head_dim
    args = (1, cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, D,
            cfg.intermediate_size, talker_step.pick_mlp_chunks(cfg.intermediate_size))
    if step is None:
        build.check_layer_shapes(*args)
    else:
        with pytest.raises(ValueError, match="must be|groups|chunks"):
            build.check_layer_shapes(*args)


def test_int8_cuda_defaults_follow_the_fit(checkpoint):  # noqa: F811
    """An int8 model on a CUDA device: the tiny talker defaults to the plain
    route for both kernels, the G=4 one for kernel 2 (its code predictor
    fits kernel 1); a named flag is kept, and kernel 2's launch check then
    raises; the 1.7B widths default to both kernels; the server takes the
    model's default."""
    _, tm = _models(checkpoint, jnp.float32, torch.float32, quantize="int8")
    tm.device = torch.device("cuda")   # the default is decided by the device type
    base = tm.config
    for cfg, sub in ((base.talker_config, False), (G4, True)):
        tm.config = dataclasses.replace(base, talker_config=cfg)
        g = tm._generation_config(tm._merge_generate_kwargs())
        assert g.fused_subtalker == sub and not g.fused_talker_step
        g = tm._generation_config(tm._merge_generate_kwargs(fused_talker_step=True,
                                                            fused_subtalker=True))
        assert g.fused_subtalker and g.fused_talker_step
    tm.config = dataclasses.replace(base, talker_config=TALKER_1B7)
    g = tm._generation_config(tm._merge_generate_kwargs())
    assert g.fused_subtalker and g.fused_talker_step
    tm.config = base
    # what a named flag meets at the first frame on the card: the raise
    # comes before any CUDA call
    tc, params = base.talker_config, tm.talker_params
    kv = torch.zeros((1, 1, 1, 128, 1))
    with pytest.raises(ValueError, match="must be"):
        talker_step._step_launch(params, tc, torch.zeros(1, 1, tc.hidden_size),
                                 torch.zeros(1), 0, None, kv, kv)
    from tests.test_torch_serving import _server

    assert _server(tm).gen_cfg.fused_talker_step is False


@pytest.mark.parametrize("B,T,Hkv,ctas", [(2, 2304, 8, 132), (4, 300, 2, 7), (1, 64, 2, 200)])
def test_flash_plan_shapes_do_not_depend_on_starts(B, T, Hkv, ctas):
    rng = np.random.default_rng(T)
    want = tpa.plan_shapes(B, T, Hkv, ctas)
    for starts in ([0] * B, [T] * B, rng.integers(0, T + 1, B).tolist()):
        items, offsets = tpa.flash_plan(T, starts, None, Hkv, ctas)
        assert (items.shape, offsets.shape) == want


def _walk_plan(q, k, v, items, scale):
    """The kernel's work list as plain code: each item's query tile
    attends its visited key tiles (masked per key as the kernel masks edge
    tiles), then its rows are normalised; padding rows stay zero."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    out = torch.zeros_like(q)
    for b, hk, q_lo, kt_lo, kt_hi, _, _, s in items.tolist():
        rows = torch.arange(q_lo, min(q_lo + tpa.FP_BQ, T))
        keys = torch.arange(kt_lo * tpa.FP_BK, min((kt_hi + 1) * tpa.FP_BK, T))
        if kt_lo > kt_hi or not len(keys):
            continue
        ok = (keys[None] <= rows[:, None]) & (keys[None] >= s)
        for h in range(hk * G, (hk + 1) * G):
            sc = q[b, rows, h] @ k[b, keys, hk].T * scale
            sc = torch.where(ok, sc, torch.full_like(sc, float("-inf")))
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
            o = p @ v[b, keys, hk] / p.sum(-1, keepdim=True).clamp_min(1e-30)
            out[b, rows, h] = torch.where(ok.any(-1, keepdim=True), o, torch.zeros_like(o))
    return out


def test_flash_prefill_with_a_host_plan_matches_the_twin():
    """The plan built from a host mask (`graphs._load_plan`, as a prefill
    graph loads it) covers the twin's output; `flash_prefill` takes it."""
    B, T, Hq, Hkv, D = 2, 300, 4, 2, 32
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, T, h, D)).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    starts = [5, 170]
    mask = (torch.arange(T)[None] >= torch.tensor(starts)[:, None]).to(torch.int32)
    cfg = dataclasses.replace(TalkerConfig(), num_key_value_heads=Hkv)
    plan = tuple(torch.zeros(s, dtype=torch.int32) for s in tpa.plan_shapes(B, T, Hkv, 3))
    graphs._load_plan(plan, cfg, mask)
    items, offsets = tpa.flash_plan(T, starts, None, Hkv, 3)
    assert np.array_equal(plan[0].numpy(), items) and np.array_equal(plan[1].numpy(), offsets)
    start = torch.tensor(starts, dtype=torch.int32)
    want = tpa.flash_prefill_ref(q.double(), k.double(), v.double(), start)
    np.testing.assert_allclose(_walk_plan(q, k, v, plan[0], D ** -0.5).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    got = tpa.flash_prefill(q, k, v, start, plan=plan)
    np.testing.assert_array_equal(got.numpy(), tpa.flash_prefill_ref(q, k, v, start).numpy())


def _prefill_inputs(checkpoint, kv_quant=False, sampled=False):  # noqa: F811
    """Both packages' models and one batch of prompts: (jm, tm, JAX gen_cfg,
    port gen_cfg, JAX inputs, port inputs (the mask on the host))."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    specs = [m._specs_custom_voice(TEXTS, "vivian", "english", None, True) for m in (jm, tm)]
    j_in = j_assemble(jm.talker_params, jm.config.talker_config, jm.config, specs[0],
                      bucket=32)
    t_in = t_assemble(tm.talker_params, tm.config.talker_config, tm.config, specs[1],
                      bucket=32)
    assert t_in[1].device.type == "cpu"
    kw = dict(max_new_tokens=M, kv_quant=kv_quant)
    jcfg = jgen.GenerationConfig(sampling=JS(do_sample=sampled, top_k=8),
                                 subtalker=JS(do_sample=False), **kw)
    tcfg = tgen.GenerationConfig(sampling=TS(do_sample=sampled, top_k=8),
                                 subtalker=TS(do_sample=False), **kw)
    return jm, tm, jcfg, tcfg, j_in, t_in


@pytest.mark.parametrize("sampled", [False, True])
def test_init_decode_state_matches_jax(checkpoint, monkeypatch, sampled):  # noqa: F811
    jm, tm, jcfg, tcfg, j_in, t_in = _prefill_inputs(checkpoint, sampled=sampled)
    B, T = t_in[1].shape
    S = T + M + 1
    noise = np.random.default_rng(3).gumbel(size=(B, 8)).astype(np.float32)
    if sampled:   # the same Gumbel draw in both packages
        monkeypatch.setattr(jax.random, "categorical",
                            lambda key, x, axis=-1: jnp.argmax(x + noise, axis=axis))
        monkeypatch.setattr(tsampling, "gumbel_noise",
                            lambda shape, gen, dev: torch.from_numpy(noise))
        jax.clear_caches()
    js, jc = jgen.init_decode_state(jm.talker_params, jm.config.talker_config, jcfg, *j_in,
                                    jax.random.PRNGKey(0), S)
    ts, tc = tgen.init_decode_state(tm.talker_params, tm.config.talker_config, tcfg, *t_in,
                                    torch.Generator().manual_seed(0), S)
    np.testing.assert_array_equal(ts.code0.numpy(), np.asarray(js.code0))
    # the port's cache is (L, B, Hkv, S, D); the JAX cache (L, B, S, Hkv, D)
    for t_c, j_c in ((ts.cache.k, js.cache.k), (ts.cache.v, js.cache.v)):
        np.testing.assert_allclose(t_c.permute(0, 1, 3, 2, 4).numpy(), np.asarray(j_c),
                                   **STATE_TOL)
    np.testing.assert_allclose(ts.last_hidden.numpy(), np.asarray(js.last_hidden), **STATE_TOL)
    for f in ("valid_prefill", "seq_lens", "prefill_len", "samp_row", "sub_row"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), f)
    np.testing.assert_allclose(tc.tts_pad_embed.numpy(), np.asarray(jc.tts_pad_embed),
                               **PROMPT_TOL)
    if sampled:
        jax.clear_caches()


class _FakeGraph:
    """A captured graph's stand-in: a replay runs the body again, drawing
    from the caller's generator."""

    def __init__(self, body):
        self.body, self.launches = body, []

    def replay(self, dev, generator):
        dev.replays += 1
        self.body(generator)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph layer on the CPU: one stand-in device whose captures run
    the warm pass (on a throwaway generator) and keep the body."""
    dev = graphs._Device.__new__(graphs._Device)
    dev.device, dev.captures, dev.replays = torch.device("cpu"), 0, 0
    dev.contexts = graphs.OrderedDict()

    def fake_capture(d, generator, warm, body):
        warm(torch.Generator().manual_seed(99))
        d.captures += 1
        return _FakeGraph(body)

    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(graphs, "enabled", lambda device: True)
    monkeypatch.setattr(graphs, "_device", lambda device: dev)
    monkeypatch.setattr(build, "sm_count", lambda device: 5)
    return dev


@pytest.mark.parametrize("route", ["dense", "flash", "misfit"])
def test_prefill_graph_route_matches_eager(checkpoint, monkeypatch, fake_graphs,  # noqa: F811
                                           route):
    """`init_decode_state` through a graph context (stand-in capture)
    equals the eager route's state and consts exactly, sampled; one graph
    per prompt length T, at most MAX_GRAPHS_PER_CONTEXT of a context; the
    flash route's plan buffers hold `flash_plan` of the host mask. "misfit":
    T past the threshold, but the fp32 tiny talker is not kernel 3's shape
    (`flash_misfit`): the key, the buffers and the prefill are the dense
    route's, and no plan is built."""
    if route == "flash":
        open_flash_route(monkeypatch)
    elif route == "misfit":
        monkeypatch.setattr(ttalker, "FLASH_PREFILL_MIN_T", 8)
        monkeypatch.setattr(tpa, "flash_plan", None)   # building a plan would raise
        monkeypatch.setattr(tpa, "flash_prefill_ref", None)
    monkeypatch.setattr(graphs, "MAX_GRAPHS_PER_CONTEXT", 2)
    _, tm, _, tcfg, _, t_in = _prefill_inputs(checkpoint, kv_quant=True, sampled=True)
    cfg, params = tm.config.talker_config, tm.talker_params
    B, T = t_in[1].shape
    S = T + 64 + M + 1   # one KV buffer for every T below: one context

    def init(inputs, seed=0):
        gen = torch.Generator().manual_seed(seed)
        return tgen.init_decode_state(params, cfg, tcfg, *inputs, gen, S)

    def wider(n):
        """The batch with n more positions of left padding."""
        e, mask, tr, pad = t_in
        return (torch.nn.functional.pad(e, (0, 0, n, 0)), torch.nn.functional.pad(mask, (n, 0)),
                tr, pad)

    gs, gc = init(t_in)
    assert gs.graphs is not None and fake_graphs.captures == 1 and fake_graphs.replays == 1
    with monkeypatch.context() as m:
        m.setattr(graphs, "enabled", lambda device: False)
        es, ec = init(t_in)
    assert es.graphs is None
    for f in ("code0", "presence", "done", "lengths", "t"):
        assert torch.equal(getattr(gs, f), getattr(es, f)), f
    assert torch.equal(gs.last_hidden, es.last_hidden)
    for f in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(gs.cache, f), getattr(es.cache, f)), f
    for f in ("valid_prefill", "seq_lens", "prefill_len", "samp_row", "sub_row",
              "tts_pad_embed", "suppress"):
        assert torch.equal(getattr(gc, f), getattr(ec, f)), f
    n = min(ec.trailing_text.shape[1], gc.trailing_text.shape[1])   # the frames read
    assert torch.equal(gc.trailing_text[:, :n], ec.trailing_text[:, :n])
    assert (gc.trailing_text[:, n:] == gc.tts_pad_embed).all()
    ctx = gs.graphs
    (key, g), = ctx.graphs.items()
    assert key == ("prefill", T, route == "flash")
    assert len(g.static) == (4 if route == "flash" else 2)
    if route == "flash":
        starts = (T - t_in[1].sum(-1)).tolist()
        assert np.array_equal(g.static[2].numpy(),
                              tpa.flash_plan(T, starts, None, cfg.num_key_value_heads, 5)[0])
    del gs, gc, es, ec
    # the context is free again: the same T replays, a new T captures
    init(t_in, seed=1)
    assert fake_graphs.captures == 1 and fake_graphs.replays == 2
    init(wider(32))
    init(wider(64))
    assert fake_graphs.captures == 3 and len(ctx.graphs) == 2   # the oldest went
    assert ("prefill", T, route == "flash") not in ctx.graphs


def test_stage_rows_matches_jax_with_padding_rows(checkpoint):  # noqa: F811
    """Three requests and a padding row staged into rows 3, 0 and 2 of a
    4-row pool, greedy fp32: the port's fixed-N merge writes what the JAX
    `stage_requests` writes; the padding row and pool row 1 stay as they
    were."""
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    cfg = tm.config.talker_config
    prompts = _prompts(jm, 3)
    Lp, Tt, K = 40, 32, 4
    rows = [tbatch._pad_request(from_jax_tree(p), torch.ones((1, p.shape[1]), dtype=torch.int32),
                                from_jax_tree(tr), Lp, Tt, torch.float32) for p, tr, _ in prompts]
    rows.append((torch.zeros(Lp, cfg.hidden_size), torch.zeros(Lp, dtype=torch.int32),
                 torch.zeros(Tt, cfg.hidden_size)))
    meta = np.array([[7, 5, 3, 3, 1], [8, 6, 2, 0, 1], [9, 4, 1, 2, 1], [-1, 0, 0, 0, 0]],
                    np.int32)
    srow = np.tile(TS(do_sample=False).as_row(), (4, 1))
    pad = from_jax_tree(prompts[0][2])
    jstate = jbatch.init_slot_state(jm.config.talker_config, 2, 80, Tt, jnp.float32,
                                    prefill_bucket=Lp, staging_rows=K)
    jstate = jbatch.stage_requests(
        jm.talker_params, jm.config.talker_config, jstate, _greedy(jgen, JS),
        tuple(jnp.asarray(r[0].numpy()) for r in rows),
        tuple(jnp.asarray(r[1].numpy()) for r in rows),
        tuple(jnp.asarray(r[2].numpy()) for r in rows), jnp.asarray(meta),
        jnp.asarray(pad.numpy()), jax.random.PRNGKey(0), jnp.asarray(srow), jnp.asarray(srow))
    tstate = tbatch.init_slot_state(cfg, 2, 80, Tt, torch.float32, prefill_bucket=Lp,
                                    staging_rows=K)
    before = tstate.staged.k[:, 1].clone()
    tbatch.stage_requests(tm.talker_params, cfg, tstate, _greedy(tgen, TS),
                          *(torch.stack([r[i] for r in rows]) for i in range(3)), meta, pad,
                          torch.Generator().manual_seed(0), torch.from_numpy(srow),
                          torch.from_numpy(srow))
    assert tstate.staged_valid.tolist() == [True, False, True, True]
    assert torch.equal(tstate.staged.k[:, 1], before)
    np.testing.assert_array_equal(tstate.staged_valid.numpy(), np.asarray(jstate.staged_valid))
    for f in ("staged_code0", "staged_seq_len", "staged_trailing_len", "staged_max_frames",
              "staged_req_id", "staged_kv_valid"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                      f)
    for f in ("staged_hidden", "staged_trailing", "staged_sampling", "tts_pad"):
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)),
                                   err_msg=f, **STATE_TOL)
    for t_c, j_c in ((tstate.staged.k, jstate.staged_k), (tstate.staged.v, jstate.staged_v)):
        np.testing.assert_allclose(t_c.permute(0, 1, 3, 2, 4).numpy(), np.asarray(j_c),
                                   **STATE_TOL)


@pytest.mark.parametrize("route", ["dense", "flash", "misfit"])
def test_staging_graphs_match_eager_engine(checkpoint, monkeypatch, fake_graphs,  # noqa: F811
                                           route):
    """An engine with its staging (and tick) graphs on the stand-in
    capture: `warmup_staging` captures one staging graph per request count
    up to staging_rows; five sampled requests then capture no staging graph
    and get the eager engine's codes. "misfit": the prefill bucket past the
    threshold, the fp32 tiny talker not kernel 3's shape: no plan buffers,
    no plan built, no flash call."""
    if route == "flash":
        open_flash_route(monkeypatch)
    elif route == "misfit":
        monkeypatch.setattr(ttalker, "FLASH_PREFILL_MIN_T", 8)
        monkeypatch.setattr(tpa, "flash_plan", None)   # building a plan would raise
        monkeypatch.setattr(tpa, "flash_prefill_ref", None)
    jm, tm = _models(checkpoint, jnp.float32, torch.float32)
    reqs = _requests(tbatch, _prompts(jm, 5), from_jax_tree)
    gen_cfg = tgen.GenerationConfig(max_new_tokens=M, sampling=TS(top_k=8),
                                    subtalker=TS(top_k=8))

    def engine():
        return tbatch.ContinuousBatchingEngine(
            tm.talker_params, tm.config.talker_config, gen_cfg, num_slots=2, max_len=80,
            prefill_bucket=40, max_trailing=32, staging_rows=4, dtype=torch.float32, seed=3)

    eng = engine()
    assert eng._graphs is not None
    eng.warmup_staging()
    assert sorted(eng._graphs.staging) == [1, 2, 4] and fake_graphs.captures == 3
    plan = eng._graphs.staging[4].static[7:]
    assert len(plan) == (2 if route == "flash" else 0)
    got = {}
    for r in reqs:
        eng.submit(r)
    got = {c.request_id: c.codes for c in eng.run_until_drained()}
    assert sorted(eng._graphs.staging) == [1, 2, 4]
    with monkeypatch.context() as m:
        m.setattr(graphs, "enabled", lambda device: False)
        eager = engine()
        assert eager._graphs is None
        eager.warmup_staging()
        for r in reqs:
            eager.submit(r)
        want = {c.request_id: c.codes for c in eager.run_until_drained()}
    assert set(got) == set(want) == set(range(5))
    for rid in want:
        assert len(want[rid]) > 0
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("dtype,tol", [("fp32", None), ("bf16", 1e-2)])
def test_grouped_assembly_matches_jax(checkpoint, dtype, tol):  # noqa: F811
    """Two groups (two texts of one length, one of another, one of them
    with an instruct block): the rows, the host mask and the trailing text
    against the JAX package's."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16,
                                                                   torch.bfloat16)
    jm, tm = _models(checkpoint, jdt, tdt)
    texts = ["same length a", "same length b", "a longer third text"]
    outs = []
    for m, assemble in ((jm, j_assemble), (tm, t_assemble)):
        specs = m._specs_custom_voice(texts, "vivian", "english", None, False)
        specs += m._specs_custom_voice(texts[:1], "vivian", None, "speak slowly", True)
        outs.append([np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32))
                     for x in assemble(m.talker_params, m.config.talker_config, m.config,
                                       specs, bucket=32)])
    for i, (j, t) in enumerate(zip(*outs)):
        assert t.shape == j.shape
        if i == 1:   # the mask
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **(PROMPT_TOL if tol is None
                                                else dict(rtol=tol, atol=tol)))


def test_pad_request_rows_match_jax(checkpoint):  # noqa: F811
    """`_pad_request` (one pad per tensor, the mask on the host) against the
    JAX `_pad_request_fn`: equal, a trailing text cut at the engine's Tt."""
    jm, _ = _models(checkpoint, jnp.float32, torch.float32)
    (p, tr, _), = _prompts(jm, 1)
    T = p.shape[1]
    mask = np.ones((1, T), np.int32)
    mask[0, :2] = 0
    for Tt in (32, tr.shape[1] - 1):
        want = jbatch._pad_request_fn(T, tr.shape[1], 40, Tt, jnp.float32)(p, mask, tr)
        got = tbatch._pad_request(from_jax_tree(p), torch.from_numpy(mask), from_jax_tree(tr),
                                  40, Tt, torch.float32)
        assert got[1].device.type == "cpu" and got[1].dtype == torch.int32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("warmup", [False, True])
def test_demo_warms_the_server_before_wrapping_it(monkeypatch, warmup):
    """Under --warmup the demo calls `TTSServer.warmup()` (the engine's
    serve, staging and vocoder graphs) before `ThreadedTTSServer` takes the
    server to its loop thread; without it, it does not."""
    import types

    from qwen3_tts_tpu_torch.cli import demo
    from qwen3_tts_tpu_torch.inference.model import Qwen3TTSModel
    from qwen3_tts_tpu_torch.runtime import server, warmup as warm_mod

    calls = []
    model = types.SimpleNamespace(tts_model_type="custom_voice")
    monkeypatch.setattr(Qwen3TTSModel, "from_pretrained",
                        classmethod(lambda cls, *a, **k: model))
    monkeypatch.setattr(warm_mod, "warmup_model", lambda m, **k: calls.append("model") or 0.0)

    class Server:
        def __init__(self, m, **kw):
            assert m is model
            calls.append("server")

        def warmup(self):
            calls.append("warmup")
            return 0.0

    monkeypatch.setattr(server, "TTSServer", Server)
    monkeypatch.setattr(server, "ThreadedTTSServer",
                        lambda srv: calls.append("threaded") or srv)
    monkeypatch.setattr(demo._HttpDemo, "serve", lambda self, *a: calls.append("serve"))
    demo.main(["ckpt"] + (["--warmup"] if warmup else []))
    want = ["server", "threaded", "serve"]
    assert calls == (["model", "server", "warmup", "threaded", "serve"] if warmup else want)


@pytest.mark.parametrize("fails", [False, True])
def test_capture_runs_without_cyclic_gc(monkeypatch, fails):
    """No cyclic garbage collection inside a capture (a dead server's graphs
    torn down there invalidate it, as a 48-slot server's staging capture
    showed on the card), before it the warm pass runs with it, and after it,
    failed or not, collection is on again. The capture runs with its
    graph device current."""
    import contextlib
    import gc

    class Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    dev = graphs._Device.__new__(graphs._Device)
    dev.device, dev.stream, dev.pool, dev.captures = torch.device("cpu"), Stream(), None, 0
    seen = []
    monkeypatch.setattr(torch.cuda, "device", lambda d: seen.append(("device", d))
                        or contextlib.nullcontext())

    def body(gen):
        seen.append(("body", gc.isenabled()))
        if fails:
            raise RuntimeError("capture failed")

    assert gc.isenabled()
    with pytest.raises(RuntimeError) if fails else contextlib.nullcontext():
        graphs.capture(dev, None, lambda gen: seen.append(("warm", gc.isenabled())), body)
    assert seen == [("device", dev.device), ("warm", True), ("body", False)] and gc.isenabled()
