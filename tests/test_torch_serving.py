"""Torch port: the bundle writer and the hermetic export (serving.py) against
the JAX package's serving.py.

- ``tree_to_spec`` gives the JAX codec's spec JSON and bitwise npz leaves
  for the same folded tree, and for the int8 tree taken JAX -> port
  (``qparams_from_numpy``) -> back (``qparams_to_numpy``), for the mini
  Darknet-53, the mini CSP model and tiny.
- A bundle the port writes is read by the JAX ``load_predictor_bundle``,
  unchanged, and its detections match the port's under
  tests/test_torch_predictor.py's gates (mini Darknet-53 at 128px, K = 256,
  objectness columns scaled so that scores are distinct: masks equal, boxes
  within atol 1e-5); and the other way round.
- The port's round trips serve bit for bit (f32, bf16, int8; every family).
- ``ExportedPredictor`` equals the live predictor bit for bit (f32 and
  int8, as the JAX tests/test_serving.py asserts for its export); the
  exported graph calls aten ops only, and its file holds no weights.

On the CPU the live predictor runs the plain NMS sweep and the layer paths,
as the exported program does on every device.
"""

import functools
import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_CSP_LAYERS, MINI_LAYERS, mini_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu import serving as jserving
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.inference import Predictor as JaxPredictor
from yolo_for_turbines_tpu.models.yolov3 import PlanHead, YOLOv3 as JaxYOLOv3
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch import serving
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy, qparams_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan

SIZE, K = 128, 256
OBJECTNESS_GAIN = 3e4
FAMILIES = {
    "darknet53": (dict(num_classes=2, layer_config=MINI_LAYERS), cfg.ANCHORS),
    "csp": (dict(num_classes=2, layer_config=MINI_CSP_LAYERS), cfg.ANCHORS),
    "tiny": (dict(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)), cfg.TINY_ANCHORS),
}


@functools.lru_cache(maxsize=None)
def _family(name):
    """A JAX model of the family, a seeded folded tree of its plan (numpy, in
    the JAX layout: the port's ``init_plan``), the anchors and a seeded 64px
    batch (made once per family; nothing here changes them)."""
    kw, anchors = FAMILIES[name]
    model = JaxYOLOv3(JaxModelConfig(**kw))
    folded = init_plan(build_plan(cfg.ModelConfig(**kw)), torch.Generator().manual_seed(3))
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return model, folded, anchors, x


@pytest.fixture(scope="module")
def shared():
    """tests/test_torch_predictor.py's setup: the mini Darknet-53 with its
    objectness columns scaled, f32 predictors of both packages, and the
    port's predictor quantized on a seeded batch."""
    model = mini_model()
    params, stats = model.init(jax.random.PRNGKey(7))
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    for entry, p in zip(model.plan, folded):
        if isinstance(entry, PlanHead):
            w = p["conv2"]["w"].copy()
            w[..., 4 :: entry.num_classes + 5] *= OBJECTNESS_GAIN
            p["conv2"] = {"w": w, "b": p["conv2"]["b"]}
    x = np.random.default_rng(8).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    calib = np.random.default_rng(10).uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    port = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=SIZE, max_boxes=K)
    port_q = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=SIZE,
                                   max_boxes=K).quantize(calib)
    jax_pred = JaxPredictor(model, folded, image_size=SIZE, max_boxes=K,
                            compute_dtype=jnp.float32)
    return model, folded, x, calib, port, port_q, jax_pred


def _assert_same_detections(got, want):
    """Keep masks equal, boxes within atol 1e-5, and consecutive top-K
    scores further apart than the two packages' scores differ."""
    (kept_t, keep_t), (kept_j, keep_j) = got, want
    kept_t, keep_t = kept_t.numpy(), keep_t.numpy()
    kept_j, keep_j = np.asarray(kept_j), np.asarray(keep_j)
    gaps = -np.diff(kept_j[..., 4], axis=1)
    assert (kept_j[..., 4] > 0.5).all()
    assert gaps.min() > 2 * np.abs(kept_t[..., 4] - kept_j[..., 4]).max()
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_allclose(kept_t, kept_j, rtol=0, atol=1e-5)
    assert 0 < int(keep_t.sum()) < keep_t.size


def _assert_equal_outputs(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def test_tree_codec_roundtrip():
    tree = {
        "layers": [
            {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.zeros(3, np.int8), "stride": 2},
            None,
        ],
        "scales": torch.ones(4),
        "mode": "int8",
        "nested": ({"q": torch.ones(2, dtype=torch.bfloat16) / 3}, 0.5, True),
    }
    spec, leaves = serving.tree_to_spec(tree)
    # bf16 leaves are stored widened to f32 in the npz, and recorded as bf16
    assert all(a.dtype.name != "bfloat16" for a in leaves.values())
    assert spec["k"]["nested"]["v"][0]["k"]["q"]["dtype"] == "bfloat16"
    back = serving.spec_to_tree(json.loads(json.dumps(spec)), leaves)
    np.testing.assert_array_equal(back["nested"][0]["q"],
                                  (torch.ones(2, dtype=torch.bfloat16) / 3).float().numpy())
    assert isinstance(back["nested"], tuple) and isinstance(back["layers"], list)
    assert back["layers"][1] is None
    assert back["layers"][0]["stride"] == 2 and back["mode"] == "int8"
    assert back["layers"][0]["b"].dtype == np.int8
    np.testing.assert_array_equal(back["layers"][0]["w"], tree["layers"][0]["w"])
    np.testing.assert_array_equal(back["scales"], np.ones(4, np.float32))
    # the JAX reader decodes the same bytes, bf16 included
    jback = jserving.spec_to_tree(json.loads(json.dumps(spec)), leaves)
    assert jback["nested"][0]["q"].dtype == np.dtype(jnp.bfloat16)
    np.testing.assert_array_equal(jback["nested"][0]["q"].astype(np.float32),
                                  back["nested"][0]["q"])


def _assert_same_codec(tree_port, tree_jax):
    spec_t, leaves_t = serving.tree_to_spec(tree_port)
    spec_j, leaves_j = jserving.tree_to_spec(tree_jax)
    assert json.dumps(spec_t) == json.dumps(spec_j)
    assert list(leaves_t) == list(leaves_j)
    for k, a in leaves_j.items():
        assert leaves_t[k].dtype == a.dtype and leaves_t[k].shape == a.shape
        assert leaves_t[k].tobytes() == a.tobytes()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_folded_spec_matches_jax(family):
    _, folded, _, _ = _family(family)
    _assert_same_codec(folded, folded)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_quantized_spec_matches_jax(family):
    model, folded, anchors, x = _family(family)
    jq = JaxPredictor(model, folded, anchors=anchors, image_size=64,
                      compute_dtype=jnp.float32).quantize(x)
    qtree = jax.tree_util.tree_map(np.asarray, jq._qparams)
    plan = Predictor.from_folded(model.cfg, folded, device="cpu").model.plan
    back = qparams_to_numpy(plan, qparams_from_numpy(plan, qtree, "cpu"))
    # the tree as the JAX save_predictor encodes it
    _assert_same_codec(back, jq._qparams)


# ---------------------------------------------------------------------------
# Bundles across the two packages
# ---------------------------------------------------------------------------


def test_port_bundle_is_read_by_jax(shared, tmp_path):
    _, _, x, _, port, _, _ = shared
    out = serving.save_predictor(port, tmp_path / "bundle")
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["framework"] == "yolo_for_turbines_tpu_torch"
    assert manifest["format_version"] == 1 and manifest["exports"] == {}
    assert manifest["predictor"]["compute_dtype"] == "float32"
    # no pickle anywhere in the artifact
    assert sorted(f.name for f in out.iterdir()) == ["folded.npz", "manifest.json"]
    loaded = jserving.load_predictor_bundle(out, use_pallas_nms=False)
    assert (loaded.image_size, loaded.max_boxes) == (SIZE, K)
    _assert_same_detections(port.predict_batch(x), loaded.predict_batch(x))


def test_port_int8_bundle_is_read_by_jax(shared, tmp_path):
    # the two int8 forwards use the same int8 numbers but different
    # leaky_relu forms, which may move a requant code at a .5 tie: the
    # predictor tests' gates
    _, _, x, _, _, port_q, _ = shared
    out = serving.save_predictor(port_q, tmp_path / "qbundle")
    loaded = jserving.load_predictor_bundle(out, use_pallas_nms=False)
    assert loaded._qparams is not None
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, loaded._qparams))
    want = jax.tree_util.tree_leaves(qparams_to_numpy(port_q.model.plan, port_q._qparams))
    assert len(got) == len(want)
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
    _assert_same_detections(port_q.predict_batch(x), loaded.predict_batch(x))


def test_jax_bundle_is_read_by_the_port(shared, tmp_path):
    _, _, x, _, port, _, jax_pred = shared
    jserving.save_predictor(jax_pred, tmp_path / "jbundle")
    loaded = serving.load_predictor_bundle(tmp_path / "jbundle", device="cpu")
    _assert_equal_outputs(loaded.predict_batch(x), port.predict_batch(x))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_bundle_round_trip_bitwise(family, kind, tmp_path):
    model, folded, anchors, x = _family(family)
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    pred = Predictor.from_folded(model.cfg, folded, device="cpu", anchors=anchors,
                                 image_size=64, max_boxes=32, conf_threshold=0.2,
                                 compute_dtype=dtype)
    if kind == "int8":
        pred.quantize(x)
    out = serving.save_predictor(pred, tmp_path / "b")
    loaded = serving.load_predictor_bundle(out, device="cpu")
    assert loaded.compute_dtype == dtype
    assert (loaded._qparams is not None) == (kind == "int8")
    np.testing.assert_array_equal(loaded.anchors, pred.anchors)
    _assert_equal_outputs(loaded.predict_batch(x), pred.predict_batch(x))


def test_save_needs_the_full_precision_tree(shared, tmp_path):
    # the rule of Predictor.quantize: a module cast to bf16 is not saved
    from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy

    model, folded, x, _, port, _, _ = shared
    module = folded_from_numpy(port.model.plan, folded, model.cfg)
    with pytest.raises(ValueError, match="full-precision"):
        serving.save_predictor(Predictor(module, device="cpu", compute_dtype=torch.bfloat16),
                               tmp_path / "bf16")
    # an f32 module saves its own weights: the same bundle as from_folded's
    f32 = Predictor(folded_from_numpy(port.model.plan, folded, model.cfg), device="cpu",
                    image_size=SIZE, max_boxes=K)
    loaded = serving.load_predictor_bundle(serving.save_predictor(f32, tmp_path / "f32"),
                                           device="cpu")
    _assert_equal_outputs(loaded.predict_batch(x), port.predict_batch(x))


def test_entry_points_need_a_card(tmp_path, monkeypatch, shared):
    out = serving.save_predictor(shared[4], tmp_path / "b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.load_predictor_bundle(out)
    with pytest.raises(RuntimeError, match="CUDA"):
        serving.ExportedPredictor(out)


# ---------------------------------------------------------------------------
# The exported program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def exported(shared, tmp_path_factory):
    """f32 and int8 bundles of the shared predictors, each with one
    exported program at B = 2."""
    _, _, _, _, port, port_q, _ = shared
    out = {}
    for kind, pred in (("f32", port), ("int8", port_q)):
        path = serving.save_predictor(pred, tmp_path_factory.mktemp(kind))
        out[kind] = (path, serving.add_export_to_bundle(path, batch_size=2))
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_exported_matches_live(shared, exported, kind):
    _, _, x, _, port, port_q, _ = shared
    path, blob = exported[kind]
    manifest = json.loads((path / "manifest.json").read_text())
    (name, meta), = manifest["exports"].items()
    assert name == blob.name == f"serve_b2_s{SIZE}.pt2"
    assert meta == {"format": "torch.export", "batch_size": 2, "image_size": SIZE,
                    "platforms": ["cpu", "cuda"], "quantized": kind == "int8"}
    pred = serving.ExportedPredictor(path, device="cpu")
    live = port_q if kind == "int8" else port
    _assert_equal_outputs(pred.predict_batch(x), live.predict_batch(x))


@pytest.fixture(scope="module")
def programs(exported):
    return {kind: torch.export.load(blob) for kind, (_, blob) in exported.items()}


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_exported_graph_is_aten_only_and_holds_no_weights(exported, programs, kind):
    path, blob = exported[kind]
    program = programs[kind]
    targets = {n.target for n in program.graph.nodes if n.op == "call_function"}
    ops = {t for t in targets if isinstance(t, torch._ops.OpOverload)}
    assert {t.namespace for t in ops} == {"aten"}
    assert {str(t) for t in targets - ops} <= {"<built-in function getitem>"}
    # the weights are call-time inputs: no parameter, no example input, and
    # the constants are a few scalars and the anchors
    assert not program.state_dict
    assert program.example_inputs is None
    with zipfile.ZipFile(blob) as z:
        data = sum(i.file_size for i in z.infolist()
                   if "/data/" in i.filename and not i.filename.endswith(".json"))
    assert data < 1024
    assert blob.stat().st_size < (path / "folded.npz").stat().st_size


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_exported_program_moves_to_another_device(programs, kind):
    # every device literal the CPU trace baked in is moved with the program
    # (ExportedPredictor moves it to the card the same way)
    from torch.export.passes import move_to_device_pass

    def devices(program):
        found = set()
        for node in program.graph.nodes:
            if "device" in node.kwargs:
                found.add(torch.device(node.kwargs["device"]).type)
            if node.target == torch.ops.aten.to.device:
                found.add(torch.device(node.args[1]).type)
        return found | {t.device.type for t in program.constants.values()}

    assert devices(programs[kind]) == {"cpu"}
    assert devices(move_to_device_pass(programs[kind], "meta")) == {"meta"}


def test_save_predictor_overwrite_clears_stale_exports(shared, exported, tmp_path):
    import shutil

    port = shared[4]
    out = tmp_path / "owbundle"
    shutil.copytree(exported["f32"][0], out)
    blob = out / "exports" / exported["f32"][1].name
    assert blob.exists()
    # the JAX reader of the weights ignores the port's exports
    jserving.load_predictor_bundle(out, use_pallas_nms=False)
    out2 = serving.save_predictor(port, out)
    assert json.loads((out2 / "manifest.json").read_text())["exports"] == {}
    assert not blob.exists() and not (out2 / "exports").exists()


def test_exported_predictor_refusals(shared, exported, tmp_path):
    import shutil

    # an export lowered for the int8 tree, in a bundle whose int8 tree is gone
    path = tmp_path / "mm"
    shutil.copytree(exported["int8"][0], path)
    (path / "quantized.npz").unlink()
    manifest = json.loads((path / "manifest.json").read_text())
    del manifest["quantized_spec"]
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="no quantized.npz"):
        serving.ExportedPredictor(path, device="cpu")
    # a JAX export (StableHLO), indexed as the JAX package indexes it
    manifest["exports"] = {"serve_b2_s128.jaxexport": {
        "batch_size": 2, "image_size": SIZE, "platforms": ["cpu", "tpu"], "quantized": False}}
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="jaxexport"):
        serving.ExportedPredictor(path, device="cpu")
    # a device type the export was not indexed for
    path = tmp_path / "cpu_only"
    shutil.copytree(exported["f32"][0], path)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["exports"]["serve_b2_s128.pt2"]["platforms"] = ["cuda"]
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="not cpu"):
        serving.ExportedPredictor(path, device="cpu")
    with pytest.raises(ValueError, match="no exports"):
        serving.ExportedPredictor(serving.save_predictor(shared[4], tmp_path / "none"),
                                  device="cpu")


# ---------------------------------------------------------------------------
# The export CLI
# ---------------------------------------------------------------------------


def test_export_cli(tmp_path, monkeypatch):
    """CLI plumbing end to end: weights arg -> predictor -> int8 calibration
    on a folder of JPEGs -> bundle with one exported bucket. The real
    ``load_predictor`` builds the full-width model, so it is swapped for a
    mini-model loader; the calibration, save and export below it are the
    production ones."""
    from PIL import Image

    import yolo_for_turbines_tpu_torch.inference as inference
    from yolo_for_turbines_tpu_torch.tools.export import main

    model, folded, _, _ = _family("darknet53")
    seen = {}

    def fake_load_predictor(weights_path, **kw):
        seen.update(kw, weights_path=weights_path)
        return Predictor.from_folded(model.cfg, folded, device=kw["device"],
                                     image_size=kw["image_size"], max_boxes=16)

    monkeypatch.setattr(inference, "load_predictor", fake_load_predictor)
    calib = tmp_path / "calib"
    calib.mkdir()
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(
            calib / f"{i}.jpg")
    out = main([
        "--weights", str(tmp_path / "mini.weights"), "--out", str(tmp_path / "clibundle"),
        "--num-classes", "80", "--image-size", "64", "--quantize-calib-dir", str(calib),
        "--calib-images", "2", "--export-batch", "1", "--export-platforms", "cpu",
        "--device", "cpu",
    ])
    assert seen["num_classes"] == 80 and seen["image_size"] == 64
    assert seen["device"] == "cpu" and seen["backbone"] == "darknet53"
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["format_version"] == 1 and "quantized_spec" in manifest
    (name, meta), = manifest["exports"].items()
    assert meta["batch_size"] == 1 and meta["platforms"] == ["cpu"] and meta["quantized"]
    assert (out / "exports" / name).stat().st_size > 0
    # the calibration batch: the first two JPEGs through the C++ letterbox
    imgs = [np.asarray(Image.open(calib / f"{i}.jpg")) for i in range(2)]
    want = Predictor.from_folded(model.cfg, folded, device="cpu", image_size=64).quantize(
        inference._letterbox_batch(imgs, 64, 0))
    loaded = serving.load_predictor_bundle(out, device="cpu")
    got_leaves = jax.tree_util.tree_leaves(loaded._qparams)
    want_leaves = jax.tree_util.tree_leaves(want._qparams)
    assert all(torch.equal(g, w) for g, w in zip(got_leaves, want_leaves))


def test_export_cli_needs_a_card(tmp_path, monkeypatch):
    from yolo_for_turbines_tpu_torch.tools.export import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--weights", str(tmp_path / "none.weights"), "--out", str(tmp_path / "b")])
