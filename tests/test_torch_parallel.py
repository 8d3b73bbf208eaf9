"""Torch port: data parallelism (``yolo_for_turbines_tpu_torch/parallel``,
the mesh entry points of ``train/steps.py``, ``inference.py`` and
``train/trainer.py``) against the JAX package's ``parallel/mesh.py`` paths
and the port's single-process paths.

Ranks are gloo processes spawned on the CPU (``torch_dist.py``: a file
store, one torch thread each, a 60 s group timeout and a deadline on the
parent), one spawn per group of checks: 2 ranks for the DP train step of
the mini Darknet-53 and of tiny, the DP predictor, a broadcast after a
routed call, and the DP Trainer; 4 ranks for the DP step over 4 ranks and
over a 2x2 ("dcn", "data") mesh. The JAX references run in this process on
its 8 virtual CPU devices (tests/conftest.py).

Gates are the JAX tests' own (tests/test_parallel.py): a step's loss
within 1e-4 relative, its parameters within rtol 2e-4 and atol 2e-5; the
predictor's masks equal and boxes within 1e-5; the Trainer's first-epoch
loss within 1e-3, its parameters after two epochs at cosine > 0.9999 and
relative distance < 1e-2, its val loss within 2e-2 and mAP within 0.15.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS, mini_model
from torch_dist import run_ranks
from torch_parallel_ranks import dp_four, dp_two, initial_vector, one_step, tiny_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.models.yolov3 import PlanHead as JaxPlanHead
from yolo_for_turbines_tpu.models.yolov3 import YOLOv3 as JaxYOLOv3
from yolo_for_turbines_tpu.parallel import mesh as jmesh
from yolo_for_turbines_tpu.train import steps as jsteps
from yolo_for_turbines_tpu_torch.config import ANCHORS, ModelConfig, grid_sizes_for
from yolo_for_turbines_tpu_torch.data.dataset import assign_targets
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    PlanConv,
    PlanHead,
    PlanResidual,
    init_plan,
)
from yolo_for_turbines_tpu_torch.parallel import mesh as pmesh

LOSS_RTOL = 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
BOX_ATOL = 1e-5
# float64 mesh step against the float64 single-process step: relative
# distance of the updates (measured 2.0e-11, DP over 2 ranks)
F64_UPDATE_RTOL = 1e-8
OBJECTNESS_GAIN = 3e4  # spread scores: no near-ties for top-K (test_torch_predictor.py)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _step_case(model, b=8, size=64, seed=0):
    """JAX init trees, a batch and anchors as tests/test_parallel.py makes
    them (one object per image on the coarsest grid)."""
    rng = np.random.default_rng(seed)
    params, stats = model.init(jax.random.PRNGKey(0))
    strides = model.strides
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    targets = [np.zeros((b, 3, size // s, size // s, 6), np.float32) for s in strides]
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    anchors = np.abs(rng.normal(1.0, 0.3, (len(strides), 3, 2))).astype(np.float32)
    return {"params": _np(params), "stats": _np(stats), "images": images, "targets": targets,
            "anchors": anchors}


def _jax_step(model, case, mesh=None, shardings=None):
    """The JAX f32 train step: plain, on ``mesh``, or jitted with explicit
    (data, replicated) ``shardings`` as tests/test_parallel.py's multislice
    test does."""
    cfg = JaxTrainConfig(lr=1e-3, max_num_steps=10, compute_dtype="float32")
    state, tx, _ = jsteps.create_train_state(model, cfg, params=case["params"],
                                             batch_stats=case["stats"])
    images, targets = case["images"], tuple(case["targets"])
    anchors = jnp.asarray(case["anchors"])
    if shardings is not None:
        data, repl = shardings
        step = jax.jit(lambda s, x, y, a: jsteps.make_train_step(model, tx, cfg)(s, x, y, a),
                       in_shardings=(repl, data, (data,) * len(targets), repl),
                       out_shardings=(repl, repl))
        new, m = step(state, jax.device_put(images, data),
                      tuple(jax.device_put(t, data) for t in targets), anchors)
    elif mesh is not None:
        step = jsteps.make_train_step(model, tx, cfg, mesh=mesh)
        sx, sy = jmesh.shard_batch((images, targets), mesh)
        new, m = step(state, sx, tuple(sy), anchors)
    else:
        step = jsteps.make_train_step(model, tx, cfg)
        new, m = step(state, jnp.asarray(images), tuple(map(jnp.asarray, targets)), anchors)
    return float(m["loss"]), _np(new.params)


def _assert_params(got, want):
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)


def _assert_step(result, loss, params):
    assert result["metrics"]["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
    _assert_params(result["params"], params)


def update_distance(got, want, old) -> float:
    """Relative distance of two updates (new - old), over every parameter
    at once."""
    return float(np.linalg.norm((got - old) - (want - old)) / np.linalg.norm(want - old))


def assert_f64_step(result, case):
    """The float64 step on the mesh against the single-process float64
    step. In f32 this model's gradient at init is mostly rounding (the f32
    update sits 0.81 from the float64 one, relative), so the f32 gates
    above cannot see a gradient error under lr * atol; in float64 the mesh
    step reads 2.0e-11 from the single-process one."""
    want = one_step(case, dtype=torch.float64)[1]
    assert update_distance(result["f64"], want, initial_vector(case)) < F64_UPDATE_RTOL


# ---------------------------------------------------------------------------
# Inputs of the 2-rank group
# ---------------------------------------------------------------------------


def _folded_with_spread_scores():
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(3))
    folded = _np(model.fold(params, stats))
    for entry, p in zip(model.plan, folded):
        if isinstance(entry, JaxPlanHead):
            w = p["conv2"]["w"].copy()
            w[..., 4 :: entry.num_classes + 5] *= OBJECTNESS_GAIN
            p["conv2"] = {"w": w, "b": p["conv2"]["b"]}
    return folded


def _one_scale_case():
    """A model whose 16x16x512 residual stage is routed (K2's class) at
    32px: each rank gets its own weights."""
    cfg = ModelConfig(num_classes=2, strides=(2,))
    plan = (PlanConv(3, 512, 3, 2), PlanResidual(512, 1), PlanHead(512, 2))
    trees = []
    for seed in (10, 11):
        tree = init_plan(plan, torch.Generator().manual_seed(seed))
        trees.append(jax.tree_util.tree_map(lambda t: t.numpy(), tree))
    x = np.random.default_rng(12).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    anchors = np.asarray(ANCHORS, np.float32)[:1]
    return {"one_scale_cfg": cfg, "one_scale_plan": plan, "one_scale_trees": trees,
            "one_scale_x": x, "one_scale_anchors": anchors}


def _trainer_batches(seed=11, n_train=2, n_val=6, b=8, size=64):
    """Seeded images with 1 to 4 boxes each, targets by assign_targets."""
    rng = np.random.default_rng(seed)
    anchors = np.asarray(ANCHORS, np.float32).reshape(-1, 2)

    def batch(n):
        x = rng.uniform(size=(n, size, size, 3)).astype(np.float32)
        per_image = []
        for _ in range(n):
            boxes = [[*rng.uniform(0.2, 0.8, 2), *rng.uniform(0.1, 0.5, 2),
                      int(rng.integers(2))] for _ in range(int(rng.integers(1, 5)))]
            per_image.append(assign_targets(boxes, anchors, grid_sizes_for(size)))
        return x, tuple(np.stack([t[i] for t in per_image]) for i in range(3))

    return [batch(b) for _ in range(n_train)], [batch(n_val)]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The 2-rank spawn and its inputs."""
    darknet = _step_case(mini_model())
    darknet["model_cfg"] = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    tiny_jax = JaxYOLOv3(JaxModelConfig(num_classes=2, backbone="yolov3_tiny",
                                        strides=(32, 16)))
    tiny = _step_case(tiny_jax, seed=1)
    tiny["model_cfg"] = tiny_cfg()
    batches, val_batches = _trainer_batches()
    case = {
        "darknet": darknet, "tiny": tiny, "folded": _folded_with_spread_scores(),
        "serve_x": np.random.default_rng(8).uniform(size=(8, 64, 64, 3)).astype(np.float32),
        "trainer": {"train_cfg": dict(lr=2e-4, batch_size=8, max_num_steps=100,
                                      warmup_enabled=False, multi_scale=False,
                                      image_size=64, compute_dtype="float32"),
                    "batches": batches, "val_batches": val_batches},
        **_one_scale_case(),
    }
    results = run_ranks(dp_two, 2, tmp_path_factory.mktemp("dp_two"), case)
    return case, results


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank spawn and its inputs."""
    case = _step_case(mini_model())
    case["model_cfg"] = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    return case, run_ranks(dp_four, 4, tmp_path_factory.mktemp("dp_four"), case)


# ---------------------------------------------------------------------------
# Meshes without ranks
# ---------------------------------------------------------------------------


def test_mesh_of_one_rank_without_a_process_group():
    mesh = pmesh.create_mesh(device="cpu")
    assert mesh.axis_names == ("data",) and mesh.shape == (1,) and mesh.group is None
    assert mesh.device == torch.device("cpu") and mesh.active
    with pytest.raises(ValueError, match="world has 1"):
        pmesh.create_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        pmesh.create_multislice_mesh(2, 2, device="cpu")


def test_mesh_takes_the_local_rank_device(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pmesh.rank_device("cuda") == torch.device("cuda", 3)
    assert pmesh.rank_device(None) == torch.device("cuda", 3)
    assert pmesh.rank_device("cpu") == torch.device("cpu")


def test_mesh_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.create_mesh()


def test_pad_batch_to_multiple_matches_jax():
    x = np.ones((5, 3), np.float32)
    (padded,), n = pmesh.pad_batch_to_multiple((x,), 8)
    (jpadded,), jn = jmesh.pad_batch_to_multiple((x,), 8)
    assert padded.shape == (8, 3) and n == jn == 5
    np.testing.assert_array_equal(padded, np.asarray(jpadded))
    (same,), n2 = pmesh.pad_batch_to_multiple((np.ones((8, 3), np.float32),), 8)
    assert same.shape == (8, 3) and n2 == 8
    tree, n3 = pmesh.pad_batch_to_multiple({"a": np.ones((3, 2)), "b": [np.zeros(3, np.int8)]}, 4)
    assert tree["a"].shape == (4, 2) and tree["b"][0].shape == (4,) and n3 == 3
    assert tree["b"][0].dtype == np.int8 and not tree["a"][3].any()


def test_shardings_take_the_ranks_rows():
    mesh = pmesh.Mesh(("dcn", "data"), (2, 2), rank=3, device=torch.device("cpu"))
    x = np.arange(16).reshape(8, 2)
    np.testing.assert_array_equal(pmesh.batch_sharding(mesh).take(x), x[6:8])
    np.testing.assert_array_equal(pmesh.replicated_sharding(mesh).take(x), x)
    assert mesh.axis_index("dcn") == 1 and mesh.axis_index("data") == 1
    with pytest.raises(ValueError, match="pad_batch_to_multiple"):
        pmesh.batch_sharding(mesh).take(x[:6])


def test_prefetch_places_only_the_shard():
    from yolo_for_turbines_tpu_torch.data.loader import prefetch_to_device

    mesh = pmesh.Mesh(("data",), (2,), rank=1, device=torch.device("cpu"))
    sharding = pmesh.batch_sharding(mesh)
    batch = (np.arange(8, dtype=np.float32).reshape(4, 2), (np.arange(4, dtype=np.float32),))
    out = list(prefetch_to_device([batch], "cpu", sharding=lambda b: (
        sharding.take(b[0]), tuple(sharding.take(t) for t in b[1]))))
    x, (y,) = out[0]
    np.testing.assert_array_equal(x.numpy(), batch[0][2:])
    np.testing.assert_array_equal(y.numpy(), [2.0, 3.0])


def test_trainer_mesh_of_one_rank_runs_the_plain_step():
    from yolo_for_turbines_tpu_torch.config import TrainConfig
    from yolo_for_turbines_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(batch_size=2, image_size=64, multi_scale=False, compute_dtype="float32")
    t = Trainer(tc, model_cfg=ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                mesh=pmesh.create_mesh(device="cpu"))
    assert t.device == torch.device("cpu") and t.is_main
    with pytest.raises(ValueError, match="not the mesh's"):
        Trainer(tc, model_cfg=ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                device="cuda", mesh=pmesh.create_mesh(device="cpu"))


def test_train_refuses_a_world_the_batch_does_not_divide(monkeypatch):
    from yolo_for_turbines_tpu_torch.train import trainer

    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="largest divisor that fits is 2"):
        trainer.data_parallel_mesh(8, device="cpu")


# ---------------------------------------------------------------------------
# Two ranks
# ---------------------------------------------------------------------------


def test_two_rank_mesh(two):
    _, results = two
    for rank, r in enumerate(results):
        assert r["mesh"] == (("data",), (2,), rank, "cpu")


@pytest.fixture(scope="module")
def darknet_refs(two):
    """The JAX step on 1 and 2 devices, and the port's single-process step."""
    case = two[0]["darknet"]
    model = mini_model()
    return {"jax_dp2": _jax_step(model, case, mesh=jmesh.create_mesh(2)),
            "port": one_step(case)}


def test_dp_train_step_matches_jax_sharded_step(two, darknet_refs):
    loss, params = darknet_refs["jax_dp2"]
    _assert_step(two[1][0]["darknet"], loss, params)


def test_dp_train_step_matches_single_process_step(two, darknet_refs):
    metrics, (params, stats) = darknet_refs["port"]
    got = two[1][0]["darknet"]
    _assert_step(got, metrics["loss"], params)
    assert_f64_step(got, two[0]["darknet"])
    # running statistics from the global batch's moments
    _assert_params(got["stats"], stats)


def test_dp_replicas_stay_identical(two):
    for key in ("darknet", "tiny"):
        prints = {r[key]["fingerprint"] for r in two[1]}
        assert len(prints) == 1, (key, prints)
        losses = {r[key]["metrics"]["loss"] for r in two[1]}
        assert len(losses) == 1, (key, losses)


def test_dp_tiny_train_step_matches_single_process_step(two):
    # the JAX trainer refuses tiny on a mesh (three target shardings for a
    # two-scale model): the port's tiny DP step is held to its own
    # single-process step
    metrics, (params, _) = one_step(two[0]["tiny"])
    _assert_step(two[1][0]["tiny"], metrics["loss"], params)
    assert_f64_step(two[1][0]["tiny"], two[0]["tiny"])


def test_dp_predictor_matches_single_process(two):
    case, results = two
    plain = Predictor.from_folded(ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                                  case["folded"], device="cpu", image_size=64, max_boxes=64,
                                  compute_dtype=torch.float32)
    kept, mask = plain.predict_batch(case["serve_x"])
    assert mask.any()
    for r in results:  # the whole batch on every rank
        got_kept, got_mask = r["predictor"]
        np.testing.assert_array_equal(got_mask, mask.numpy())
        np.testing.assert_allclose(got_kept, kept.numpy(), rtol=0, atol=BOX_ATOL)


def test_dp_predictor_refuses_a_ragged_batch(two):
    assert all(r["ragged_refused"] for r in two[1])


def test_dp_predictor_serves_weights_broadcast_after_a_routed_call(two):
    case, results = two
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy

    def served(tree):
        model = folded_from_numpy(case["one_scale_plan"], tree, case["one_scale_cfg"])
        pred = Predictor(model, device="cpu", anchors=case["one_scale_anchors"],
                         image_size=32, max_boxes=16)
        return [t.numpy() for t in pred.predict_batch(case["one_scale_x"])]

    before = served(case["one_scale_trees"][0])  # rank 0's weights
    doubled = jax.tree_util.tree_map(np.copy, case["one_scale_trees"][0])
    doubled[1]["blocks"][0]["conv1"]["w"] *= 2.0
    after = served(doubled)
    assert not np.array_equal(before[0], after[0])
    for r in results:
        for got, want in zip(r["broadcast"]["first"], before):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(r["broadcast"]["second"], after):
            np.testing.assert_array_equal(got, want)
    # on rank 1 the broadcast wrote the weight without bumping its version:
    # the stage could not have noticed by itself
    assert results[1]["broadcast"]["version_kept"]


def test_dp_trainer_matches_single_process_trainer(two):
    for r in two[1]:
        t = r["trainer"]
        assert t["same_init"]
        assert t["lossn"] == pytest.approx(t["loss1"], rel=1e-3)
        assert t["cos"] > 0.9999, t["cos"]
        assert t["rel"] < 1e-2, t["rel"]
        assert t["vlossn"] == pytest.approx(t["vloss1"], rel=2e-2)
        assert t["mapn"] == pytest.approx(t["map1"], abs=0.15)
    assert len({r["trainer"]["fingerprint"] for r in two[1]}) == 1


# ---------------------------------------------------------------------------
# Four ranks
# ---------------------------------------------------------------------------


def test_dp_four_ranks_matches_jax_sharded_step(four):
    case, results = four
    loss, params = _jax_step(mini_model(), case, mesh=jmesh.create_mesh(4))
    _assert_step(results[0]["darknet"], loss, params)
    assert_f64_step(results[0]["darknet"], case)
    assert len({r["darknet"]["fingerprint"] for r in results}) == 1


def test_multislice_mesh_train_step_matches_jax(four):
    case, results = four
    for rank, r in enumerate(results):
        assert r["multislice_axes"] == (("dcn", "data"), (2, 2), rank // 2, rank % 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mesh = jmesh.create_multislice_mesh(2, 2)
    from jax.sharding import NamedSharding, PartitionSpec as P

    loss, params = _jax_step(mini_model(), case,
                             shardings=(jmesh.batch_sharding(mesh), NamedSharding(mesh, P())))
    _assert_step(results[0]["multislice"], loss, params)
    assert_f64_step(results[0]["multislice"], case)
    assert len({r["multislice"]["fingerprint"] for r in results}) == 1
