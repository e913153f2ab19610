"""The port's SFT step as captured graphs, on the CPU: the optimizer the
graphs capture against optax, and the graph owner's logic with a stand-in
capture.

- `SFTOptimizer` (the fold by a device count, the norm kept on the device,
  optax's clip as a device select, `torch._foreach_*` over the leaves)
  against `optax.MultiSteps(chain(clip_by_global_norm, adamw), k)` on
  seeded gradients: grad_accum 1 and 2, the clip binding and free; the
  params and both AdamW moments after two updates within 1e-5 relative L2
  per leaf (fp32; the gradients are O(1), far from Adam's eps, and the
  packages differ by float rounding only: 2e-8 to 2.2e-7 measured);
- the optimizer's own work reads nothing back from the device inside a
  step (no `aten._local_scalar_dense`; AdamW's step aside, which is
  capturable on CUDA only), and its fold, norm and clip dispatch the
  same number of operations for 3 leaves as for 12 (one per operation,
  not per leaf), every multi-tensor operation but the norm in place (no
  params-sized temporary);
- `TrainGraphs` through `make_train_step` with `graphs.capture` replaced by
  a recorder whose replay runs the captured body: one graph per (B, T,
  phase), the first call of a key eager and the real step, replays after
  it on batches and speaker vectors their capture never saw, params and
  losses bit-equal to the eager route's; the LRU bound; a mesh or
  `graphs.eager()` never reaches the owner; a replaced AdamW state
  (`load_state_dict`) drops the graphs.
"""

import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.finetune import train as jtrain
from qwen3_tts_tpu_torch.config import TTSModelConfig
from qwen3_tts_tpu_torch.finetune import data as tdata
from qwen3_tts_tpu_torch.finetune import train as ttrain
from qwen3_tts_tpu_torch.runtime import graphs
from qwen3_tts_tpu_torch.utils.testing import bounded_torch_threads, random_talker_params
from qwen3_tts_tpu_torch.weights import flatten_state_dict
from tests.test_pipeline_parity import MODEL_TINY

_threads = pytest.fixture(autouse=True, scope="module")(bounded_torch_threads)

CFG = TTSModelConfig.from_dict(MODEL_TINY)
TC = CFG.talker_config
Q = TC.num_code_groups


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _tree(rng, n_leaves):
    """A params tree of `n_leaves` fp32 leaves of mixed shapes."""
    shapes = [(7, 5), (11,), (3, 4, 2)]
    return {f"w{i:02d}": torch.from_numpy(rng.normal(0, 1, shapes[i % 3]).astype(np.float32))
            for i in range(n_leaves)}


def _adam_state(state):
    """optax's ScaleByAdamState inside a MultiSteps(chain(...)) state."""
    leaves = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return next(x for x in leaves if isinstance(x, optax.ScaleByAdamState))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("clip_norm", [0.5, 1e6], ids=["clip_binds", "clip_free"])
def test_optimizer_matches_optax_multisteps(accum, clip_norm):
    rng = np.random.default_rng(accum)
    tree = _tree(rng, 6)
    lr = 1e-2
    jopt = optax.MultiSteps(jtrain.default_optimizer(lr=lr, clip_norm=clip_norm),
                            every_k_schedule=accum)
    jparams = {k: jnp.asarray(v.numpy()) for k, v in tree.items()}
    jstate = jopt.init(jparams)
    params = ttrain.trainable(tree)
    opt = ttrain.default_optimizer(params, lr=lr, clip_norm=clip_norm, grad_accum=accum)
    norms = []
    for i in range(2 * accum):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in tree.items()}
        upd, jstate = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate,
                                  jparams)
        jparams = optax.apply_updates(jparams, upd)
        updated = opt.accumulate([torch.from_numpy(grads[k]) for k in sorted(grads)])
        assert updated == ((i + 1) % accum == 0)
        if updated:
            norms.append(opt.last_norm)
    assert torch.is_tensor(opt.norm) and opt.updates == 2
    # the mean's norm is ~6 / sqrt(accum): the clip binds at 0.5 and not at 1e6
    assert all((n >= clip_norm) == (clip_norm < 1) for n in norms), norms
    adam = _adam_state(jstate)
    for k, p in sorted(params.items()):
        assert rel_l2(p.detach().numpy(), jparams[k]) < 1e-5, k
        st = opt.adamw.state[p]
        assert rel_l2(st["exp_avg"].numpy(), adam.mu[k]) < 1e-5, k
        assert rel_l2(st["exp_avg_sq"].numpy(), adam.nu[k]) < 1e-5, k
        assert int(st["step"]) == 2


class _Ops(TorchDispatchMode):
    """The aten operations dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _dispatched(n_leaves):
    """(ops of a fold, ops of the norm and the clip, ops of a whole update
    cycle) of an optimizer over `n_leaves` leaves, grad_accum 2."""
    rng = np.random.default_rng(n_leaves)
    params = ttrain.trainable(_tree(rng, n_leaves))
    opt = ttrain.default_optimizer(params, clip_norm=0.5, grad_accum=2)
    grads = [torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
             for p in opt.leaves]
    with _Ops() as fold:
        opt.apply(grads, update=False)
    with _Ops() as clip:
        opt.clip_(opt.global_norm(opt.acc))
    # the CPU's AdamW (not capturable) reads its step count to the host;
    # on CUDA it is capturable and keeps the count on the device
    steps = []
    opt.adamw.step = lambda: steps.append(1)
    with _Ops() as cycle:
        opt.accumulate(grads)
        opt.accumulate(grads)
    assert steps == [1]
    return fold.ops, clip.ops, cycle.ops


def test_optimizer_runs_foreach_and_reads_nothing_back():
    fold3, clip3, cycle3 = _dispatched(3)
    fold12, clip12, cycle12 = _dispatched(12)
    assert fold3 == fold12 and clip3 == clip12, (fold3, clip3)
    assert all(op.startswith("aten._foreach") for op in fold3), fold3
    # in place: the fold in the gradients, the clip in the mean
    assert not [op for op in fold3 + clip3 if op.startswith("aten._foreach")
                and not op.endswith("_") and op != "aten._foreach_norm"], (fold3, clip3)
    for ops in (cycle3, cycle12):
        assert "aten._local_scalar_dense" not in ops and "aten.item" not in ops


# ---------------------------------------------------------------------------
# The training-graph owner, with a stand-in capture
# ---------------------------------------------------------------------------


class _FakeGraph:
    """A stand-in captured graph: a replay runs the recorded body."""

    def __init__(self, body):
        self.body = body

    def replay(self, dev, generator):
        dev.replays += 1
        self.body(generator)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The graph layer on the CPU: a stand-in device whose captures run the
    warm pass and record the body (run by each replay)."""
    dev = graphs._Device.__new__(graphs._Device)
    dev.device, dev.captures, dev.replays = torch.device("cpu"), 0, 0
    dev.contexts = graphs.OrderedDict()
    dev.train = graphs.weakref.WeakSet()
    warm_calls = []

    def fake_capture(d, generator, warm, body):
        assert generator is None
        warm(None)
        warm_calls.append(1)
        d.captures += 1
        return _FakeGraph(body)

    monkeypatch.setattr(graphs, "capture", fake_capture)
    monkeypatch.setattr(graphs, "enabled", lambda device: not graphs._EAGER[0])
    monkeypatch.setattr(graphs, "_device", lambda device: dev)
    dev.warm_calls = warm_calls
    return dev


def _batch(seed, text_len, B=2):
    """A collated SFT batch (torch tensors, no ref mels) and a speaker
    vector per row."""
    rng = np.random.default_rng(seed)
    items = [{"text_ids": rng.integers(1, 40, (1, text_len)),
              "audio_codes": rng.integers(0, 60, (4, Q)),
              "ref_mel": np.zeros((1, 4, 16), np.float32)} for _ in range(B)]
    b = tdata.TTSDataset([], None, CFG, num_code_groups=Q).collate(items, pad_to_multiple=16)
    b.pop("ref_mels")
    spk = rng.normal(0, 0.5, (B, TC.hidden_size)).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in b.items()}, torch.from_numpy(spk)


def _trainer(accum=2):
    params = ttrain.trainable(random_talker_params(TC, torch.Generator().manual_seed(0),
                                                   dtype=torch.float32))
    opt = ttrain.default_optimizer(params, lr=1e-3, clip_norm=0.5, grad_accum=accum)
    return params, opt, ttrain.make_train_step(TC, opt)


def _owner(opt):
    owners = [t for t in graphs._device("cpu").train if t.optimizer is opt]
    assert len(owners) == 1
    return owners[0]


def test_train_graphs_keys_first_call_eager_and_equal_to_eager(fake_graphs):
    """Two shapes (T = 32 and 48) through eight mini-steps at grad_accum 2:
    the keys are (B, T, phase); each key's first call is the real step (the
    capture's warm pass); the four replays get batches and speaker vectors
    their key's capture never saw, so their losses differ from the
    capture's; params, AdamW states and losses bit-equal to the eager
    route's."""
    s0, s1, s2 = _batch(1, 5), _batch(7, 5), _batch(8, 5)
    l0, l1 = _batch(2, 30), _batch(9, 30)
    assert s0[0]["input_ids"].shape[1] == 32 and l0[0]["input_ids"].shape[1] == 48
    # captures: fold s0, update s1, fold l0, update l1; replays: fold s2,
    # update s0, fold s1, update s2
    order = [s0, s1, l0, l1, s2, s0, s1, s2]
    params, opt, step = _trainer()
    before = {k: v.detach().clone() for k, v in flatten_state_dict(params).items()
              if v is not None}
    got = []
    for i, (b, spk) in enumerate(order):
        m = step(params, b, spk)
        got.append(m)
        if i == 1:   # the first update: its key's first call, run eagerly
            assert fake_graphs.replays == 0 and fake_graphs.captures == 2
            moved = [k for k, v in flatten_state_dict(params).items()
                     if v is not None and not torch.equal(v.detach(), before[k])]
            assert moved and opt.adamw.state
    owner = _owner(opt)
    assert [k[:3] for k in owner.graphs] == [(2, 48, "fold"), (2, 48, "fold+update"),
                                             (2, 32, "fold"), (2, 32, "fold+update")]
    assert fake_graphs.captures == 4 and fake_graphs.replays == 4
    assert len(fake_graphs.warm_calls) == 4
    for replay, capture in ((4, 0), (5, 1), (6, 0), (7, 1)):
        assert not torch.equal(got[replay]["loss"], got[capture]["loss"]), replay

    eparams, eopt, estep = _trainer()
    with graphs.eager():
        want = [estep(eparams, b, spk) for b, spk in order]
    assert fake_graphs.captures == 4 and fake_graphs.replays == 4   # eager: no owner call
    for g, w in zip(got, want):
        assert g["updated"] == w["updated"]
        for k in ("loss", "talker_loss", "sub_talker_loss"):
            assert torch.equal(g[k], w[k]), k
    flat, eflat = flatten_state_dict(params), flatten_state_dict(eparams)
    for k, v in flat.items():
        if v is not None:
            assert torch.equal(v.detach(), eflat[k].detach()), k
            s, es = opt.adamw.state[v], eopt.adamw.state[eflat[k]]
            assert torch.equal(s["exp_avg"], es["exp_avg"]) and torch.equal(
                s["exp_avg_sq"], es["exp_avg_sq"]), k
    assert opt.last_norm == eopt.last_norm and opt.mini_step == eopt.mini_step == 0


def test_train_graphs_lru_and_version(fake_graphs, monkeypatch):
    """At most MAX_TRAIN_GRAPHS graphs, least recently used out first; an
    evicted key's next call is eager again; `load_state_dict` (new AdamW
    state tensors) drops every graph."""
    monkeypatch.setattr(graphs, "MAX_TRAIN_GRAPHS", 2)
    params, opt, step = _trainer(accum=1)
    shapes = [_batch(3, 5), _batch(4, 30), _batch(5, 40)]   # T = 32, 48, 64
    for b, spk in shapes:
        step(params, b, spk)
    owner = _owner(opt)
    assert [k[:3] for k in owner.graphs] == [(2, 48, "fold+update"), (2, 64, "fold+update")]
    step(params, *shapes[1])                 # a replay, now the newest
    assert fake_graphs.captures == 3 and fake_graphs.replays == 1
    step(params, *shapes[0])                 # evicted: eager again, then captured
    assert fake_graphs.captures == 4 and fake_graphs.replays == 1
    assert [k[1] for k in owner.graphs] == [48, 32]
    opt.load_state_dict(opt.state_dict())
    step(params, *shapes[0])
    assert fake_graphs.captures == 5 and len(owner.graphs) == 1


def test_mesh_and_eager_never_reach_the_owner(fake_graphs, monkeypatch):
    """A step under a mesh or inside `graphs.eager()` is the eager step:
    the owner is neither made nor called."""
    def refuse(*a, **k):
        raise AssertionError("the training-graph owner was reached")

    monkeypatch.setattr(graphs.TrainGraphs, "__init__", refuse)
    ran = []
    real = ttrain.mini_step

    def recorder(*a, **k):
        ran.append(a[1].mesh)
        if a[1].mesh is not None:   # no process group here: skip the collectives
            a[1].mesh = None
            try:
                return real(*a, **k)
            finally:
                a[1].mesh = "mesh"
        return real(*a, **k)

    monkeypatch.setattr(ttrain, "mini_step", recorder)
    b, spk = _batch(6, 5)
    params, opt, step = _trainer()
    with graphs.eager():
        m = step(params, b, spk)
    assert not m["updated"] and ran == [None]
    opt.mesh = "mesh"
    m = step(params, b, spk)
    assert m["updated"] and ran == [None, "mesh"]
    assert fake_graphs.captures == 0 and fake_graphs.replays == 0
