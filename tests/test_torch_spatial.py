"""Torch port: spatial partitioning (``parallel/spatial.py``: row sharding
with explicit halos, the layout policy, and the spatial entry points of the
folded forward, ``Predictor``, the train step and ``Trainer``) against the
JAX package's GSPMD spatial paths (tests/test_spatial.py).

One spawn of 4 gloo ranks on the CPU (``torch_dist.py``) forms a 2x2
("data", "space") mesh and runs every check; the JAX references run in
this process on a (2, 2) mesh of its 8 virtual CPU devices. At 128px the
mini model's rows shard 2-way down to 16 rows (8 per shard) and are
gathered below; at 64px down to 16 rows at stride 4. Gates are the JAX
tests' own: the folded forward within rtol and atol 1e-5 of the JAX
spatial forward; the predictor's masks equal to the plain predictor's and
boxes within rtol 1e-4, atol 1e-5 (the int8 predictor's too, against the
plain int8 predictor on the same qparams, its raw heads within 1e-5); the train step's loss within 1e-4 and
parameters within rtol 2e-4, atol 2e-5 of the JAX spatial step; the
Trainer's epoch loss within 1e-3 and parameters within rtol 2e-2, atol
5e-4 of the single-process Trainer (the JAX test's measured f32 noise
floor of one lr 2e-4 step).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS, mini_model
from torch_dist import run_ranks
from torch_parallel_ranks import sp_four
from test_torch_parallel import assert_f64_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import TrainConfig as JaxTrainConfig
from yolo_for_turbines_tpu.parallel import spatial as jspatial
from yolo_for_turbines_tpu.train import steps as jsteps
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.parallel import mesh as pmesh
from yolo_for_turbines_tpu_torch.parallel import spatial as pspatial


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mesh():
    with warnings.catch_warnings():  # 4 of the 8 virtual devices
        warnings.simplefilter("ignore")
        return jspatial.create_spatial_mesh(n_space=2, n_data=2)


def _step_case(rng):
    """tests/test_spatial.py::test_spatial_train_step_matches_single_device's
    inputs."""
    b, size = 4, 64
    images = rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)
    targets = [np.zeros((b, 3, size // s, size // s, 6), np.float32) for s in (32, 16, 8)]
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    targets[2][:, 1, 3, 2] = [0.25, 0.75, 0.5, 0.5, 1.0, 0.0]
    anchors = np.abs(rng.normal(1.0, 0.3, (3, 3, 2))).astype(np.float32)
    params, stats = mini_model().init(jax.random.PRNGKey(0))
    return {"params": _np(params), "stats": _np(stats), "images": images, "targets": targets,
            "anchors": anchors, "model_cfg": ModelConfig(num_classes=2, layer_config=MINI_LAYERS)}


def _trainer_case(rng):
    """tests/test_spatial.py::test_trainer_spatial_epoch_matches_single_device's
    batch."""
    images = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    targets = tuple(np.zeros((8, 3, 64 // s, 64 // s, 6), np.float32) for s in (32, 16, 8))
    targets[0][:, 0, 1, 1] = [0.5, 0.5, 1.0, 1.0, 1.0, 1.0]
    targets[1][:, 2, 0, 3] = [0.8, 0.2, 0.4, 0.4, 1.0, 1.0]
    return {"train_cfg": dict(lr=2e-4, batch_size=8, max_num_steps=100, warmup_enabled=False,
                              multi_scale=False, image_size=64, compute_dtype="float32"),
            "batches": [(images, targets)]}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.default_rng(0)
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(1))
    case = {
        "folded": _np(model.fold(params, stats)),
        "forward_x": rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32),
        "serve_x": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
        "step": _step_case(rng),
        "trainer": _trainer_case(rng),
    }
    return case, run_ranks(sp_four, 4, tmp_path_factory.mktemp("sp_four"), case)


# ---------------------------------------------------------------------------
# The layout policy and the factories
# ---------------------------------------------------------------------------


def _policy(shape, rank=0):
    mesh = pmesh.Mesh(("data", pspatial.SPACE_AXIS), shape, rank, torch.device("cpu"))
    return pspatial.row_constraint(mesh)


def test_row_constraint_policy():
    """tests/test_spatial.py::test_row_constraint_policy's ladder: rows stay
    sharded only while the height divides the space axis and holds >= 8
    rows per shard."""
    assert pspatial.MIN_ROWS_PER_SHARD == jspatial.MIN_ROWS_PER_SHARD == 8
    policy = _policy((2, 4))
    sharded, gathered = ("data", "space"), ("data",)
    for h in (416, 104, 52, 32):
        assert policy.spec((2, h, h, 8)) == sharded, h
    for h in (26, 16, 13, 8):
        assert policy.spec((2, h, h, 8)) == gathered, h
    assert pspatial.row_constraint(pmesh.Mesh(("data",), (4,), 0, torch.device("cpu"))) is None
    assert _policy((8, 1)) is None


def test_row_constraint_policy_matches_jax():
    jmesh = jspatial.create_spatial_mesh(n_space=4, n_data=2)
    constrain = jspatial.row_constraint(jmesh)
    policy = _policy((2, 4))
    for h in (416, 208, 104, 64, 52, 40, 32, 26, 24, 16, 13, 12, 8, 4):
        out = jax.jit(constrain)(jnp.zeros((2, h, h, 4), jnp.float32))
        spec = tuple(out.sharding.spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        assert spec == policy.spec((2, h, h, 4)), (h, spec)


def test_layout_slices_and_keeps_the_ranks_rows():
    policy = _policy((1, 2), rank=1)
    x = torch.arange(2 * 3 * 32 * 4, dtype=torch.float32).reshape(2, 3, 32, 4)
    y, rows = policy.constrain(x, pspatial.Rows(policy, False))
    assert rows.sharded and torch.equal(y, x[:, :, 16:])
    z, rows2 = policy.constrain(y, rows)  # already laid out: unchanged
    assert z is y and rows2 == rows


def test_spatial_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pspatial.create_spatial_mesh(n_space=2, device="cpu")
    mesh = pspatial.create_spatial_mesh(device="cpu")  # the world of one rank
    assert mesh.shape == (1, 1) and pspatial.row_constraint(mesh) is None


def test_single_rank_halo_pads_like_the_unsharded_ops():
    # one rank on the space axis: the halo is the image's own edges
    x = torch.randn(2, 3, 6, 5)
    got = pspatial.halo(x, 1, 1, 0.0, None)
    np.testing.assert_array_equal(got.numpy(), torch.nn.functional.pad(x, (0, 0, 1, 1)).numpy())
    got = pspatial.halo(x, 0, 1, float("-inf"), None)
    assert torch.isinf(got[:, :, -1]).all() and torch.equal(got[:, :, :6], x)


# ---------------------------------------------------------------------------
# Four ranks on a 2x2 ("data", "space") mesh
# ---------------------------------------------------------------------------


def test_spatial_mesh_factories(four):
    _, results = four
    for rank, r in enumerate(results):
        messages, shape, active = r["idle"]
        assert shape == (1, 2) and active == (rank < 2)
        assert any("only the first 2 of 4" in m for m in messages), messages
        assert r["default"] == ((1, 4), 0)  # full cover: no warning
        assert r["too_big_refused"]
        assert r["coords"] == (rank // 2, rank % 2)


def test_spatial_forward_matches_jax_spatial_forward(four):
    """The folded forward with rows sharded 2-way, at 128px (16 rows per
    shard at stride 8, 8 at stride 16, the 4-row deepest grid gathered)."""
    case, results = four
    model = mini_model()
    mesh = _jax_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P

    sp_fn = jax.jit(
        lambda p, xx: model.apply_folded(p, xx, compute_dtype=jnp.float32, raw_heads=True),
        in_shardings=(NamedSharding(mesh, P()), jspatial.spatial_image_sharding(mesh)),
        out_shardings=NamedSharding(mesh, P()))
    want = sp_fn(case["folded"], jax.device_put(jnp.asarray(case["forward_x"]),
                                                jspatial.spatial_image_sharding(mesh)))
    for rank, r in enumerate(results):
        d = rank // 2  # this rank's image
        for got, ref in zip(r["forward"], want):
            np.testing.assert_allclose(got, np.asarray(ref)[d:d + 1], rtol=1e-5, atol=1e-5)


def test_spatial_predictor_matches_plain(four):
    case, results = four
    plain = Predictor.from_folded(ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                                  case["folded"], device="cpu", image_size=64, max_boxes=64,
                                  compute_dtype=torch.float32)
    kept, mask = plain.predict_batch(case["serve_x"])
    for r in results:
        assert r["predictor_kernels_off"]
        got_kept, got_mask = r["predictor"]
        np.testing.assert_array_equal(got_mask, mask.numpy())
        np.testing.assert_allclose(got_kept, kept.numpy(), rtol=1e-4, atol=1e-5)


def test_spatial_int8_predictor_matches_plain_int8(four):
    """int8 under SP: halos of s8 codes through the layer path's im2col,
    rank 0's calibration broadcast (the ranks calibrated on different
    batches), against the plain int8 predictor on the same qparams."""
    case, results = four
    assert len({r["int8_qparams"] for r in results}) == 1
    plain = Predictor.from_folded(ModelConfig(num_classes=2, layer_config=MINI_LAYERS),
                                  case["folded"], device="cpu", image_size=64, max_boxes=64,
                                  compute_dtype=torch.float32)
    plain.set_qparams(pmesh.tree_map(
        lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a,
        results[0]["int8_tree"]))
    kept, mask = plain.predict_batch(case["serve_x"])
    heads = plain.raw_heads(case["serve_x"])
    for rank, r in enumerate(results):
        got_kept, got_mask = r["int8_predictor"]
        np.testing.assert_array_equal(got_mask, mask.numpy())
        np.testing.assert_allclose(got_kept, kept.numpy(), rtol=1e-4, atol=1e-5)
        d = rank // 2
        for got, want in zip(r["int8_heads"], heads):
            np.testing.assert_allclose(got, want.numpy()[d:d + 1], rtol=1e-5, atol=1e-5)


def test_spatial_train_step_matches_jax_spatial_step(four):
    case, results = four
    step_case = case["step"]
    model = mini_model()
    cfg = JaxTrainConfig(lr=1e-3, max_num_steps=10, compute_dtype="float32")
    state, tx, _ = jsteps.create_train_state(model, cfg, params=step_case["params"],
                                             batch_stats=step_case["stats"])
    mesh = _jax_mesh()
    step = jsteps.make_train_step(model, tx, cfg, mesh=mesh)
    sx, st = jspatial.shard_spatial_batch(step_case["images"], tuple(step_case["targets"]),
                                          mesh)
    new, m = step(state, sx, st, jnp.asarray(step_case["anchors"]))
    got = results[0]["step"]
    assert got["metrics"]["loss"] == pytest.approx(float(m["loss"]), rel=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(got["params"]),
                    jax.tree_util.tree_leaves(_np(new.params))):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)
    assert_f64_step(got, step_case)
    assert len({r["step"]["fingerprint"] for r in results}) == 1
    assert len({r["step"]["metrics"]["loss"] for r in results}) == 1


def test_spatial_trainer_epoch_matches_single_process(four):
    _, results = four
    for r in results:
        t = r["trainer"]
        assert t["loss2"] == pytest.approx(t["loss1"], rel=1e-3)
    t = results[0]["trainer"]
    for a, b in zip(t["p1"], t["p2"]):
        np.testing.assert_allclose(b, a, rtol=2e-2, atol=5e-4)
    assert len({r["trainer"]["fingerprint"] for r in results}) == 1
