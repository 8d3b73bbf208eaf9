"""Torch port: the CSPDarknet-53 and YOLOv3-tiny families (plans, max pool,
the folded forward, the trainable module and ``fold()``) against the JAX
package.

CSP on the mini CSP model (``tests/helpers.py::MINI_CSP_LAYERS``), tiny on
its real plan with 2 classes, both at 64px, the same numpy trees in both
packages, float32 on the CPU. Weights as in ``tests/test_torch_trainable.py``
(``torch_eval_weights.py``): randomised BN statistics and calibrated ones.
Gates: heads within 1e-5 relative RMS on randomised statistics and 1e-4 on
calibrated ones (eval mode and the folded forward), running statistics
1e-4 per leaf, the folded tree 1e-6 of ``fold_params``; plans and max pools exactly.
Train-mode heads: 1e-4 for tiny (measured 5e-6) and 2e-3 for the mini CSP
model, where f32 rounding alone moves the heads far: on one torch thread
the port's f32 forward is 4e-4 to 9e-4 relative RMS from a float64 forward
of the same module, the JAX one 7e-5 to 2e-4, and the two up to 1.2e-3
apart (this CPU; with torch's thread pool the port's distance is 1e-4 to
2e-4). Both families' heads are also held to that float64 forward.
"""

import copy
import dataclasses
import hashlib
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_CSP_LAYERS, MINI_LAYERS
from test_torch_yolov4 import model_cfg as yolov4_cfg, small_cfg as yolov4_small
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.models import blocks as jblocks
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import yolov3 as ty
from yolo_for_turbines_tpu_torch.models.blocks import maxpool2d
from yolo_for_turbines_tpu_torch.models.convert import (
    folded_from_numpy,
    folded_to_numpy,
    load_trainable,
    trainable_from_numpy,
    trainable_to_numpy,
)
from yolo_for_turbines_tpu_torch.models.darknet_weights import frozen_parameter_names
from yolo_for_turbines_tpu_torch.serving import tree_to_spec
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan, init_plan

SIZE = 64
HEAD_RTOL = {"random": 1e-5, "calibrated": 1e-4}
TRAIN_HEAD_RTOL = {"csp": 2e-3, "tiny": 1e-4}
# the port's train-mode heads against its own float64 forward: measured up
# to 8.9e-4 (CSP) and 8.2e-6 (tiny)
F64_HEAD_RTOL = {"csp": 2e-3, "tiny": 5e-5}
# running statistics after one train-mode pass, per leaf, relative RMS (the
# gate of tests/test_torch_train_steps.py)
STATS_RTOL = 1e-4

FAMILIES = {
    "csp": dict(num_classes=2, layer_config=MINI_CSP_LAYERS),
    "tiny": dict(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)),
}


def jax_model(family, activation="leaky_relu"):
    return jyolo.YOLOv3(JaxModelConfig(activation=activation, **FAMILIES[family]))


def _as_port_plan(jax_plan):
    """The JAX plan's entries as the port's dataclasses (same fields)."""
    return tuple(getattr(ty, type(e).__name__)(**dataclasses.asdict(e)) for e in jax_plan)


@pytest.mark.parametrize("kw", [
    dict(backbone="cspdarknet53"),
    dict(backbone="cspdarknet53", num_classes=2, activation="mish"),
    dict(backbone="yolov3_tiny", strides=(32, 16)),
    dict(backbone="yolov3_tiny", num_classes=2, strides=(32, 16)),
    dict(num_classes=2, layer_config=MINI_CSP_LAYERS),
    # layer_config wins over the backbone, in both packages
    dict(backbone="yolov3_tiny", layer_config=MINI_CSP_LAYERS),
])
def test_plan_matches_jax(kw):
    got = build_plan(ModelConfig(**kw))
    want = jyolo.YOLOv3(JaxModelConfig(**kw)).plan
    assert got == _as_port_plan(want)
    assert len(got) == len(want) > 0


def test_csp_plan_marks_routes_and_the_first_stage():
    stages = [e for e in build_plan(ModelConfig(backbone="cspdarknet53"))
              if isinstance(e, ty.PlanCSP)]
    assert [(e.channels, e.num_blocks, e.save_route, e.first_stage) for e in stages] == [
        (64, 1, False, True), (128, 2, False, False), (256, 8, True, False),
        (512, 8, True, False), (1024, 4, False, False)]
    assert (stages[0].branch_ch, stages[0].hidden_ch) == (64, 32)
    assert (stages[1].branch_ch, stages[1].hidden_ch) == (64, 64)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (13, 13)])
@pytest.mark.parametrize("kernel,stride", [(2, 2), (2, 1), (3, 1), (3, 2)])
def test_maxpool2d_matches_jax(dtype, hw, kernel, stride):
    rng = np.random.default_rng(hw[0] * 10 + kernel * 3 + stride)
    if dtype == "int8":
        # the pad value -128 never appears in a code, so a pad that wins a
        # window would show
        x = rng.integers(-127, 128, (2, *hw, 5)).astype(np.int8)
    else:
        x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    want = np.asarray(jblocks.maxpool2d(jnp.asarray(x), kernel, stride))
    got = maxpool2d(torch.from_numpy(x).permute(0, 3, 1, 2), kernel, stride)
    assert got.dtype == torch.from_numpy(x).dtype
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_maxpool2d_stride1_pads_bottom_right():
    # SAME for a 2-wide window pads 0 before and 1 after: the last row and
    # column see only themselves
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    y = maxpool2d(x, 2, 1)
    assert tuple(y.shape) == (1, 1, 4, 4)
    assert float(y[0, 0, 0, 0]) == 5.0 and float(y[0, 0, 3, 3]) == 15.0
    assert float(y[0, 0, 3, 0]) == 13.0


def _rel_rms(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module", params=[(f, k) for f in FAMILIES for k in HEAD_RTOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def trees(request):
    family, kind = request.param
    model, params, stats = eval_weights(seed=3, size=SIZE, calibrated=kind == "calibrated",
                                        model=jax_model(family))
    x = np.random.default_rng(4).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    return model, params, stats, x, HEAD_RTOL[kind]


def _port(model, params, stats):
    return trainable_from_numpy(build_plan(model.cfg), params, stats, model.cfg, device="cpu")


_APPLY = {}


def _jax_apply(model, params, stats, x, train, s2d):
    """The JAX ``apply`` in f32, compiled once per model and mode."""
    key = (model, train, s2d)
    if key not in _APPLY:
        _APPLY[key] = jax.jit(lambda p, s, x: jyolo.apply(
            model.plan, p, s, x, activation=model.cfg.activation, train=train,
            compute_dtype=jnp.float32, s2d_stem=s2d))
    return _APPLY[key](params, stats, jnp.asarray(x))


@pytest.mark.parametrize("s2d", [True, False])
def test_eval_heads_match_jax(trees, s2d):
    model, params, stats, x, rtol = trees
    port = _port(model, params, stats).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want, _ = _jax_apply(model, params, stats, x, False, s2d)
    assert len(got) == len(want) == len(model.cfg.strides)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _rel_rms(g.numpy(), w) <= rtol


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("s2d", [True, False])
def test_train_mode_heads_and_running_stats_match_jax(family, s2d):
    model, params, stats = eval_weights(seed=5, size=SIZE, model=jax_model(family))
    x = np.random.default_rng(6).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    port = _port(model, params, stats).train()
    f64 = copy.deepcopy(port).double()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        ref = f64(torch.from_numpy(x).double())
    want, want_stats = _jax_apply(model, params, stats, x, True, s2d)
    for g, w, r in zip(got, want, ref):
        assert _rel_rms(g.numpy(), w) <= TRAIN_HEAD_RTOL[family]
        assert _rel_rms(g.numpy(), r.numpy()) <= F64_HEAD_RTOL[family]
    _, got_stats = trainable_to_numpy(port)
    got_leaves, want_leaves = _leaves(got_stats), _leaves(want_stats)
    assert len(got_leaves) == len(want_leaves) > 0
    assert max(_rel_rms(g, w) for g, w in zip(got_leaves, want_leaves)) <= STATS_RTOL


def test_fold_matches_fold_params(trees):
    model, params, stats, _, _ = trees
    got = _port(model, params, stats).fold()
    want = jyolo.fold_params(model.plan, params, stats)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_folded_forward_matches_apply_inference(trees):
    model, params, stats, x, rtol = trees
    folded = jax.tree_util.tree_map(np.asarray, jyolo.fold_params(model.plan, params, stats))
    want = jax.jit(lambda f, x: jyolo.apply_inference(
        model.plan, f, x, activation=model.cfg.activation, compute_dtype=jnp.float32,
        raw_heads=True))(folded, jnp.asarray(x))
    port = folded_from_numpy(build_plan(model.cfg), folded, model.cfg).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(want) == len(model.cfg.strides)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel_rms(g.numpy(), w) <= rtol


def test_bridge_round_trips_are_exact(trees):
    model, params, stats, _, _ = trees
    p2, s2 = trainable_to_numpy(_port(model, params, stats))
    assert jax.tree_util.tree_structure((p2, s2)) == jax.tree_util.tree_structure((params, stats))
    for a, b in zip(_leaves((params, stats)), _leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)
    folded = jax.tree_util.tree_map(np.asarray, jyolo.fold_params(model.plan, params, stats))
    back = folded_to_numpy(folded_from_numpy(build_plan(model.cfg), folded, model.cfg))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(folded)
    for a, b in zip(_leaves(folded), _leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_init_plan_has_the_folded_tree_structure(family):
    # the structure fold() gives, which test_fold_matches_fold_params holds
    # to the JAX fold_params
    model = jax_model(family)
    tree = jax.tree_util.tree_map(
        np.asarray, init_plan(build_plan(model.cfg), torch.Generator().manual_seed(2)))
    want = YOLOv3(model.cfg, generator=torch.Generator().manual_seed(2)).fold()
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for g, w in zip(_leaves(tree), _leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32


# the port-only bridge cases: the mini Darknet-53 and CSP models, tiny, and
# YOLOv4 at a sixteenth of its widths (tests/test_torch_yolov4.py's), which
# no JAX-backed bridge test covers
PORT_FAMILIES = {
    "darknet53": lambda: ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
    "csp": lambda: ModelConfig(**FAMILIES["csp"]),
    "tiny": lambda: ModelConfig(**FAMILIES["tiny"]),
    "yolov4": lambda: yolov4_cfg(yolov4_small()),
}
# init_plan's seed-0 draws for each of them, recorded from the per-entry
# init that the module traversal replaced: a digest of every leaf's bytes
# in tree order, and each leaf's shape, exact sum and first element
INIT_PLAN_DRAWS = json.loads((Path(__file__).parent / "init_plan_draws.json").read_text())


def _path_leaves(tree, path=()):
    """(path, leaf) of a nested dict / list tree, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _path_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _path_leaves(v, path + (k,))
    else:
        yield path, tree


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _assert_same_tree(got, want):
    """Bit for bit, with the same structure, dict key order and dtypes."""
    spec_g, leaves_g = tree_to_spec(got)
    spec_w, leaves_w = tree_to_spec(want)
    assert json.dumps(spec_g) == json.dumps(spec_w)
    for k, w in leaves_w.items():
        assert leaves_g[k].dtype == w.dtype and leaves_g[k].tobytes() == w.tobytes()


@pytest.mark.parametrize("family", list(PORT_FAMILIES))
def test_port_bridges_round_trip_exactly(family):
    """Port only: a folded tree through the folded module and back, and a
    trainable pair of trees (every leaf redrawn, so that nothing passes by
    staying at its init) through the trainable module and back, bit for bit
    and in key order; an all-True mask names every parameter, in
    ``named_parameters()``'s order."""
    c = PORT_FAMILIES[family]()
    plan = build_plan(c)
    tree = init_plan(plan, torch.Generator().manual_seed(0))
    _assert_same_tree(folded_to_numpy(folded_from_numpy(plan, tree, c)), tree)

    rng = np.random.default_rng(1)
    params, stats = (_map_tree(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), t)
                     for t in trainable_to_numpy(YOLOv3(c, generator=torch.Generator())))
    port = YOLOv3(c, generator=torch.Generator().manual_seed(2))
    load_trainable(port, params, stats)
    got_params, got_stats = trainable_to_numpy(port)
    _assert_same_tree(got_params, params)
    _assert_same_tree(got_stats, stats)
    assert frozen_parameter_names(port, _map_tree(lambda _: True, params)) == [
        n for n, _ in port.named_parameters()]


def _malformed(tree, fault):
    """``tree`` (a per-entry list) with one fault: an entry missing, a
    residual stage's last block missing or doubled, or a weight transposed."""
    tree = copy.deepcopy(tree)
    stage = next(t for t in tree if "blocks" in t)
    if fault == "entries":
        tree.pop()
    elif fault == "short":
        stage["blocks"].pop()
    elif fault == "long":
        stage["blocks"].append(copy.deepcopy(stage["blocks"][-1]))
    else:
        stage["blocks"][0]["conv2"]["w"] = stage["blocks"][0]["conv2"]["w"].transpose(0, 1, 3, 2)
    return tree


@pytest.mark.parametrize("fault,message", [
    ("entries", "entries"), ("short", "no leaf at path"), ("long", "holds"),
    ("shape", "weight")])
def test_bridges_reject_a_malformed_tree(fault, message):
    c = PORT_FAMILIES["darknet53"]()
    plan = build_plan(c)
    folded = _map_tree(np.asarray, init_plan(plan, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match=message):
        folded_from_numpy(plan, _malformed(folded, fault), c)
    port = YOLOv3(c, generator=torch.Generator().manual_seed(1))
    params, stats = trainable_to_numpy(port)
    stats = _malformed(stats, fault) if fault == "entries" else stats
    with pytest.raises(ValueError, match=message):
        load_trainable(port, _malformed(params, fault), stats)


@pytest.mark.parametrize("family", list(PORT_FAMILIES))
def test_init_plan_draws_are_pinned(family):
    """A change of init_plan's draw order or of a shape moves a sum, a first
    element or the digest."""
    tree = init_plan(build_plan(PORT_FAMILIES[family]()), torch.Generator().manual_seed(0))
    digest = hashlib.sha256()
    got = {}
    for path, t in _path_leaves(tree):
        digest.update(t.numpy().tobytes())
        got["/".join(map(str, path))] = [list(t.shape), math.fsum(t.flatten().tolist()),
                                         float(t.flatten()[0])]
    assert got == INIT_PLAN_DRAWS[family]["leaves"]
    assert digest.hexdigest() == INIT_PLAN_DRAWS[family]["sha256"]


def test_csp_stage_names_map_the_jax_tree():
    model = jax_model("csp")
    port = YOLOv3(model.cfg, generator=torch.Generator().manual_seed(0))
    i = next(i for i, e in enumerate(port.plan) if isinstance(e, ty.PlanCSP))
    names = {n.split(".", 2)[2] for n, _ in port.named_parameters() if n.startswith(f"layers.{i}.")}
    assert {n.rsplit(".", 2)[0] for n in names} == {
        "split1", "split2", "blocks.0.conv1", "blocks.0.conv2", "transition", "fuse"}
