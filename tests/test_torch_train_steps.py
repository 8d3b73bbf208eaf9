"""Torch port: the lr schedule, the SGD train step and the eval step
(``yolo_for_turbines_tpu_torch/train/steps.py``) against the JAX package's
``train/steps.py``.

The mini model (tests/helpers.py) at 64px, float32 on the CPU, on
calibrated weights (``step_weights``: every layer normalized, the running
means on the batches' own means, so that the JAX train-mode moments,
shifted by the running mean, are exact to f32 rounding). Warmup is off so
that the lr is the peak lr from step 0: with warmup on, step 0's lr is
1e-6 * lr and an update is below a parameter's f32 spacing.

Each of the three steps starts from the JAX state before it (parameters,
running statistics, momentum trace, step count), so steps 2 and 3 test the
update with a momentum buffer that is not zero. Two runs left to
themselves cannot be held leaf by leaf: the gradient of this network is
ill-conditioned, a 1e-5 relative change of the parameters moving the worst
leaf's gradient by 7-14% (measured in float64 at B = 2, 4 and 8, 64 and
128px), so f32 rounding in step 1 outgrows any per-leaf gate by step 3.
Each gate below stands beside the largest value measured with it (port
against JAX, this CPU).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.train import steps as jsteps
from yolo_for_turbines_tpu.train.loss import total_yolo_loss as jax_total_loss
from yolo_for_turbines_tpu_torch.config import ANCHORS, TrainConfig, grid_sizes_for
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.models.convert import trainable_from_numpy, trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.darknet_weights import frozen_parameter_names
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan
from yolo_for_turbines_tpu_torch.train import steps

SIZE = 64
BATCH = 2
STEPS = 3
LR = 1e-3
# loss terms, relative: measured 4.5e-6
LOSS_RTOL = 1e-4
# per-leaf relative RMS of gradients, updates (new - old) and momentum
# buffers: measured 1.6e-4 (gradients), 2.3e-4 (updates), 1.4e-4 (buffers)
LEAF_RTOL = 1e-3
# running statistics, per leaf, relative RMS: measured 2.1e-6
STATS_RTOL = 1e-4
# total loss of steps left to themselves, relative: measured 2.1e-6,
# 6.7e-5 and 1.7e-2 at steps 1, 2 and 3
FREE_LOSS_RTOL = 5e-2


def _cfg(**kw):
    base = dict(lr=LR, batch_size=BATCH, max_num_steps=100, warmup_enabled=False,
                compute_dtype="float32")
    base.update(kw)
    return TrainConfig(**base), JaxTrainConfig(**base)


def _batches(seed):
    """STEPS seeded (images, targets) batches, targets from assign_targets."""
    rng = np.random.default_rng(seed)
    anchors = np.asarray(ANCHORS, np.float32).reshape(-1, 2)
    out = []
    for _ in range(STEPS):
        x = rng.uniform(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
        per_image = []
        for _ in range(BATCH):
            boxes = [[*rng.uniform(0.1, 0.9, 2), *rng.uniform(0.05, 0.6, 2),
                      int(rng.integers(2))] for _ in range(int(rng.integers(1, 5)))]
            per_image.append(assign_targets(boxes, anchors, grid_sizes_for(SIZE)))
        out.append((x, tuple(np.stack([t[i] for t in per_image]) for i in range(3))))
    return out


def _scaled():
    gs = np.asarray(grid_sizes_for(SIZE), np.float32)
    return np.asarray(ANCHORS, np.float32) * gs[:, None, None]


def _leaves(tree):
    """(path, array) of every non-None leaf, in a fixed order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.array(v, np.float64)) for p, v in flat]


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _rel_rms(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _worst(got_tree, want_tree):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want] and got
    return max(_rel_rms(g, w) for (_, g), (_, w) in zip(got, want))


def _sub(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.asarray(x, np.float64) - np.asarray(y, np.float64),
                                  a, b)


def _tree_of(port, values):
    """A tree in the JAX layout holding ``values(p)`` for each parameter."""
    twin = copy.deepcopy(port)
    with torch.no_grad():
        for p, q in zip(port.parameters(), twin.parameters()):
            q.copy_(values(p))
    return trainable_to_numpy(twin)[0]


_GRAD_FNS = {}


def _jax_grad_fn(model):
    """The JAX step's loss gradient, jitted once per model."""
    if model not in _GRAD_FNS:
        anchors = jnp.asarray(_scaled())

        def loss_fn(p, s, x, y):
            preds, _ = model.apply(p, s, x, train=True, compute_dtype=jnp.float32)
            return jax_total_loss(preds, y, anchors)[0]

        _GRAD_FNS[model] = jax.jit(jax.grad(loss_fn))
    return _GRAD_FNS[model]


def _jax_run(model, params, stats, cfg, batches, frozen_mask=None):
    """STEPS JAX train steps: per step the loss terms, the gradients at the
    step's input, the params and stats after it and the momentum trace."""
    # copies: on the CPU the JAX state may alias numpy memory, which the
    # donating step then overwrites
    state, tx, _ = jsteps.create_train_state(model, cfg, params=_copy(params),
                                             batch_stats=_copy(stats), frozen_mask=frozen_mask)
    step = jsteps.make_train_step(model, tx, cfg)
    anchors = jnp.asarray(_scaled())
    grad_fn = _jax_grad_fn(model)
    out = []
    for x, y in batches:
        x, y = jnp.asarray(x), tuple(map(jnp.asarray, y))
        grads = _copy(grad_fn(state.params, state.batch_stats, x, y))
        state, metrics = step(state, x, y, anchors)
        trace = optax.tree_utils.tree_get(state.opt_state, "trace")
        out.append({"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
                    "params": _copy(state.params), "stats": _copy(state.batch_stats),
                    "trace": _copy(trace)})
    return out


def _record(port, state, metrics):
    params, stats = trainable_to_numpy(port)
    zero = torch.zeros_like
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": _tree_of(port, lambda p: p.grad if p.grad is not None else zero(p)),
        "params": params, "stats": stats,
        "trace": _tree_of(port, lambda p: state.optimizer.state[p]["momentum_buffer"]
                          if p in state.optimizer.state else zero(p)),
    }


def _port_run(port, cfg, batches, frozen=()):
    """Port train steps from the module's state, left to themselves."""
    state = steps.create_train_state(port, cfg, frozen)
    step = steps.make_train_step(cfg)
    anchors = torch.from_numpy(_scaled())
    out = []
    for x, y in batches:
        metrics = step(state, torch.from_numpy(x), tuple(map(torch.from_numpy, y)), anchors)
        out.append(_record(port, state, metrics))
    return state, out


def _port_step_from(model, cfg, before, step_i, batch):
    """One port train step from a JAX state (``before``: params, stats and
    momentum trace after ``step_i`` steps)."""
    port = _port(model, before["params"], before["stats"])
    state = steps.create_train_state(port, cfg)
    state.step = step_i
    trace = _port(model, before["trace"], before["stats"])
    for p, buf in zip(port.parameters(), trace.parameters()):
        state.optimizer.state[p]["momentum_buffer"] = buf.detach().clone()
    x, y = batch
    metrics = steps.make_train_step(cfg)(state, torch.from_numpy(x),
                                         tuple(map(torch.from_numpy, y)),
                                         torch.from_numpy(_scaled()))
    assert state.step == step_i + 1
    return _record(port, state, metrics)


def _port(model, params, stats):
    return trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")


def step_weights(seed: int = 11):
    """``eval_weights`` with the running statistics taken again, without
    jitter, over the images of every batch the tests step on.

    The JAX moments are shifted by the running mean, and their gradient
    cancels two large terms when that mean is off the batch mean: on the
    jittered eval statistics the JAX gradients of some BN leaves are 10%
    off a float64 gradient (the port's 6e-5). With the mean tracking the
    batch they are 5e-5 off it."""
    model, params, stats = eval_weights(seed=seed, size=SIZE, calibrated=True)
    port = _port(model, params, stats)
    bns = [m for m in port.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    images = np.concatenate([x for seed_ in (12, 13, 14, 15) for x, _ in _batches(seed_)])
    with torch.no_grad():
        for bn in bns:
            bn.reset_running_stats()
            bn.momentum = None  # the cumulative average of one batch is that batch
        port.train()(torch.from_numpy(images))
    params, stats = trainable_to_numpy(port)
    return model, params, stats


@pytest.fixture(scope="module")
def weights():
    return step_weights()


@pytest.fixture(scope="module")
def runs(weights):
    """Per step: the JAX state before it, the port's step from that state
    and the JAX step's result."""
    model, params, stats = weights
    cfg, jcfg = _cfg()
    batches = _batches(12)
    want = _jax_run(model, params, stats, jcfg, batches)
    start = {"params": params, "stats": stats,
             "trace": jax.tree_util.tree_map(np.zeros_like, params)}
    befores = [start] + want[:-1]
    got = [_port_step_from(model, cfg, befores[i], i, batches[i]) for i in range(STEPS)]
    return befores, got, want


@pytest.mark.parametrize("step_i", range(STEPS))
def test_loss_terms_match_jax(runs, step_i):
    _, got, want = runs
    g, w = got[step_i]["metrics"], want[step_i]["metrics"]
    assert set(g) == set(w) == {"loss", "box_loss", "obj_loss", "no_obj_loss", "class_loss"}
    for k in w:
        assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("step_i", range(STEPS))
def test_gradients_match_jax(runs, step_i):
    _, got, want = runs
    assert _worst(got[step_i]["grads"], want[step_i]["grads"]) <= LEAF_RTOL


@pytest.mark.parametrize("step_i", range(STEPS))
def test_updates_and_momentum_match_jax(runs, step_i):
    befores, got, want = runs
    before = befores[step_i]["params"]
    # the updates move every leaf, weight-decayed BN scale and bias and the
    # heads' conv bias included
    for _, u in _leaves(_sub(got[step_i]["params"], before)):
        assert np.abs(u).max() > 0
    assert _worst(_sub(got[step_i]["params"], before),
                  _sub(want[step_i]["params"], before)) <= LEAF_RTOL
    assert _worst(got[step_i]["trace"], want[step_i]["trace"]) <= LEAF_RTOL


@pytest.mark.parametrize("step_i", range(STEPS))
def test_running_statistics_match_jax(runs, step_i):
    _, got, want = runs
    assert _worst(got[step_i]["stats"], want[step_i]["stats"]) <= STATS_RTOL


def test_first_update_is_decayed_sgd(runs):
    """Step 0 from scratch: buffer = g + wd * p, update = -lr * buffer (the
    port's own numbers, so the identity is exact to f32 rounding)."""
    befores, got, _ = runs
    wd = TrainConfig().weight_decay
    for (_, g), (_, p), (_, b), (_, new) in zip(_leaves(got[0]["grads"]),
                                                _leaves(befores[0]["params"]),
                                                _leaves(got[0]["trace"]),
                                                _leaves(got[0]["params"])):
        np.testing.assert_allclose(b, g + wd * p, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(new, p - LR * b, rtol=1e-5, atol=1e-8)


def test_steps_left_to_themselves_stay_finite_and_track_jax(weights):
    """Three steps run free from the same start: the first agrees leaf by
    leaf (the gates above); after it the losses drift apart only as far as
    the ill-conditioned gradient lets f32 rounding grow, and every number
    stays finite."""
    model, params, stats = weights
    cfg, jcfg = _cfg()
    batches = _batches(12)
    want = _jax_run(model, params, stats, jcfg, batches)
    _, got = _port_run(_port(model, params, stats), cfg, batches)
    for k, w in want[0]["metrics"].items():
        assert abs(got[0]["metrics"][k] - w) <= LOSS_RTOL * abs(w)
    assert _worst(got[0]["grads"], want[0]["grads"]) <= LEAF_RTOL
    for g, w in zip(got, want):
        assert all(math.isfinite(v) for v in g["metrics"].values())
        assert abs(g["metrics"]["loss"] - w["metrics"]["loss"]) <= FREE_LOSS_RTOL * w["metrics"]["loss"]


def _frozen_mask(params, n_entries):
    """True at every leaf of the first ``n_entries`` plan entries."""
    return [jax.tree_util.tree_map(lambda _: i < n_entries, p) for i, p in enumerate(params)]


def test_frozen_leaves_match_jax_and_stay_bit_for_bit(weights):
    model, params, stats = weights
    cfg, jcfg = _cfg()
    batches = _batches(13)[:2]
    mask = _frozen_mask(params, 3)
    want = _jax_run(model, params, stats, jcfg, batches, frozen_mask=mask)
    port = _port(model, params, stats)
    names = frozen_parameter_names(port, mask)
    assert len(names) == 4 + 4 * 2  # conv 0, conv 1, one residual block
    state, got = _port_run(port, cfg, batches, frozen=names)
    assert not any(p.requires_grad for n, p in port.named_parameters() if n in names)
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == len(list(port.parameters())) - len(names)
    flags = [f for _, f in _leaves(mask)]
    for g, w in zip(got, want):
        for flag, (path, a), (_, b), (_, p0) in zip(
                flags, _leaves(g["params"]), _leaves(w["params"]), _leaves(params)):
            if flag:
                assert np.array_equal(a, p0) and np.array_equal(b, p0), path
    # frozen BN layers still update their running statistics
    assert _worst(got[0]["stats"], want[0]["stats"]) <= STATS_RTOL
    assert not np.array_equal(_leaves(got[0]["stats"])[0][1], _leaves(stats)[0][1])
    moved = _sub(got[0]["params"], params)
    want_moved = _sub(want[0]["params"], params)
    for flag, (path, a), (_, b) in zip(flags, _leaves(moved), _leaves(want_moved)):
        if not flag:
            assert _rel_rms(a, b) <= LEAF_RTOL, path


def test_eval_step_matches_jax_and_mutates_nothing(weights):
    model, params, stats = weights
    cfg, jcfg = _cfg()
    x, y = _batches(14)[0]
    jstate, _, _ = jsteps.create_train_state(model, jcfg, params=params, batch_stats=stats)
    want = jsteps.make_eval_step(model, jcfg)(jstate, jnp.asarray(x), tuple(map(jnp.asarray, y)),
                                              jnp.asarray(_scaled()))
    port = _port(model, params, stats).train()
    state = steps.create_train_state(port, cfg)
    before = copy.deepcopy(port.state_dict())
    got = steps.make_eval_step(cfg)(state, torch.from_numpy(x), tuple(map(torch.from_numpy, y)),
                                    torch.from_numpy(_scaled()))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    assert port.training and state.step == 0 and not state.optimizer.state
    assert all(p.grad is None for p in port.parameters())


_SCHEDULES = [
    dict(lr=0.1, max_num_steps=1000, warmup=0.01),
    dict(lr=3e-3, max_num_steps=500, warmup=0.05, decay_lr=True),
    dict(lr=1e-2, max_num_steps=200, warmup_enabled=False),
    dict(lr=1e-2, max_num_steps=200, warmup_enabled=False, decay_lr=True),
    dict(lr=1e-3, max_num_steps=20, warmup=0.5, decay_lr=True),
]


@pytest.mark.parametrize("kw", _SCHEDULES)
def test_schedule_matches_jax_at_every_step(kw):
    cfg, jcfg = TrainConfig(**kw), JaxTrainConfig(**kw)
    hyper, jhyper = steps.hyper_from_config(cfg), jsteps.hyper_from_config(jcfg)
    assert {k: np.float32(v) for k, v in hyper.items()} == {k: np.float32(v) for k, v in jhyper.items()}
    sched = jsteps.warmup_schedule(jcfg)
    n = cfg.max_num_steps + 2
    want = np.asarray(jax.vmap(lambda s: jsteps.scheduled_lr(s, jhyper))(
        jnp.arange(n, dtype=jnp.int32)), np.float64)
    got = np.asarray([steps.scheduled_lr(s, hyper) for s in range(n)])
    # the JAX in-step schedule: measured 0 (the same f32 operations)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # optax's schedules compute init + (end - init) * frac with f32
    # cancellation at the 1e-7 scale (as tests/test_train.py allows)
    opt = np.asarray([float(sched(s)) for s in range(n)])
    np.testing.assert_allclose(got, opt, rtol=1e-4, atol=1e-8)


def test_compute_dtype_names():
    assert steps.compute_dtype_of("bfloat16") is torch.bfloat16
    assert steps.compute_dtype_of("float32") is torch.float32
    with pytest.raises(ValueError):
        steps.compute_dtype_of("float16")


def test_bf16_autocast_step_keeps_f32_parameters(weights):
    """bfloat16 is autocast: the parameters, their gradients and the loss
    stay float32, and the loss is finite."""
    model, params, stats = weights
    cfg, _ = _cfg(compute_dtype="bfloat16")
    port = _port(model, params, stats)
    state = steps.create_train_state(port, cfg)
    x, y = _batches(15)[0]
    metrics = steps.make_train_step(cfg)(state, torch.from_numpy(x),
                                         tuple(map(torch.from_numpy, y)),
                                         torch.from_numpy(_scaled()))
    assert all(v.dtype == torch.float32 and math.isfinite(float(v)) for v in metrics.values())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in port.parameters())
    assert state.step == 1
