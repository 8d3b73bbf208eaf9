"""Torch port: the demo CLI (tools/demo.py), the k-means anchors
(tools/anchors.py), plotting (utils/plotting.py) and profiling
(utils/profiling.py) against the JAX package's.

The demo's cases are tests/test_demo_cli.py's, on the CPU with a tiny
checkpoint of the port's trainer. The anchors must equal the JAX module's
bit for bit for the same seed (the same numpy draws). The port draws boxes
with PIL where the JAX package uses matplotlib: the colours must be
matplotlib's ``tab20b`` and the outlines land on the pixels the boxes name.
"""

import json
import re

import numpy as np
import pytest
import torch
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.tools import anchors as janchors
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.config import ModelConfig, TrainConfig
from yolo_for_turbines_tpu_torch.tools import anchors as tanchors
from yolo_for_turbines_tpu_torch.tools.demo import run_cli
from yolo_for_turbines_tpu_torch.utils import plotting
from yolo_for_turbines_tpu_torch.utils.profiling import StepTimer, trace_scope

CLASSES = ["dirt", "damage"]


# ---------------------------------------------------------------------------
# The demo CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A checkpoint of the port's trainer for the 2-class mish tiny model,
    its anchors JSON and a seeded JPEG."""
    from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3
    from yolo_for_turbines_tpu_torch.train.checkpoint import save_checkpoint
    from yolo_for_turbines_tpu_torch.train.steps import create_train_state

    root = tmp_path_factory.mktemp("demo")
    model = YOLOv3(ModelConfig(num_classes=2, activation="mish", backbone="yolov3_tiny",
                               strides=(32, 16)), generator=torch.Generator().manual_seed(0))
    ckpt = root / "best_model_demo.ckpt"
    save_checkpoint(create_train_state(model, TrainConfig()), ckpt)
    anchors_json = root / "anchors.json"
    anchors_json.write_text(json.dumps({"anchors": np.asarray(cfg.TINY_ANCHORS).tolist()}))
    img_path = root / "photo.jpg"
    Image.fromarray(np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)).save(
        img_path)
    return ckpt, anchors_json, img_path


def test_cli_checkpoint_path_with_custom_anchors(tiny_checkpoint, tmp_path, capsys):
    """--checkpoint + --anchors serves a checkpoint of the port's trainer end
    to end: the PNG has the image's size, and the printed count is
    predict_image's on the same predictor."""
    from yolo_for_turbines_tpu_torch.inference import load_predictor_from_checkpoint

    ckpt, anchors_json, img_path = tiny_checkpoint
    out = tmp_path / "pred.png"
    run_cli([
        "--checkpoint", str(ckpt), "--anchors", str(anchors_json),
        "--backbone", "yolov3_tiny", "--num-classes", "2",
        "--activation", "mish", "--image", str(img_path),
        "--out", str(out), "--device", "cpu",
    ])
    assert Image.open(out).size == (128, 96)
    printed = int(re.search(r"\((\d+) detections\)", capsys.readouterr().out).group(1))
    pred = load_predictor_from_checkpoint(ckpt, anchors=cfg.TINY_ANCHORS,
                                          backbone="yolov3_tiny", device="cpu")
    image = np.array(Image.open(img_path).convert("RGB"), dtype=np.uint8)
    assert printed == len(pred.predict_image(image))


def test_cli_weights_and_checkpoint_mutually_exclusive():
    with pytest.raises(SystemExit):
        run_cli(["--weights", "a", "--checkpoint", "b", "--image", "c"])
    with pytest.raises(SystemExit):
        run_cli(["--image", "c"])  # one source is required


def test_cli_missing_model_file_exits(tmp_path):
    img = tmp_path / "x.jpg"
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(img)
    with pytest.raises(SystemExit) as e:
        run_cli(["--checkpoint", str(tmp_path / "nope.ckpt"), "--image", str(img)])
    assert e.value.code == 2


def test_cli_needs_a_card(tiny_checkpoint, tmp_path, monkeypatch):
    ckpt, _, img_path = tiny_checkpoint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_cli(["--checkpoint", str(ckpt), "--backbone", "yolov3_tiny", "--num-classes", "2",
                 "--image", str(img_path), "--out", str(tmp_path / "p.png")])


# ---------------------------------------------------------------------------
# k-means anchors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    """Label txts of seeded boxes, one file holding a single row."""
    root = tmp_path_factory.mktemp("labels")
    rng = np.random.default_rng(5)
    for i in range(12):
        n = 1 if i == 0 else int(rng.integers(2, 6))
        rows = np.column_stack([rng.integers(0, 2, n), rng.uniform(0.2, 0.8, (n, 2)),
                                rng.uniform(0.02, 0.6, (n, 2))])
        np.savetxt(root / f"im{i}.txt", rows, fmt="%.6f")
    return root


def test_load_wh_boxes_and_iou_match_jax(labels):
    boxes = tanchors.load_wh_boxes(labels)
    np.testing.assert_array_equal(boxes, janchors.load_wh_boxes(labels))
    cents = boxes[:9]
    np.testing.assert_array_equal(tanchors.iou_wh(boxes, cents), janchors.iou_wh(boxes, cents))
    with pytest.raises(ValueError):
        tanchors.load_wh_boxes(labels / "none")


@pytest.mark.parametrize("init", ["kmeans++", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_kmeans_anchors_match_jax(labels, seed, init):
    boxes = tanchors.load_wh_boxes(labels)
    cents, mean_iou = tanchors.kmeans_anchors(boxes, 9, 300, seed, init)
    want, want_iou = janchors.kmeans_anchors(boxes, 9, 300, seed, init)
    np.testing.assert_array_equal(cents, want)
    assert mean_iou == want_iou
    assert tanchors.group_by_scale(cents) == janchors.group_by_scale(want)
    # area-sorted, largest scale first
    area = cents[:, 0] * cents[:, 1]
    assert (np.diff(area) <= 0).all()


def test_anchors_cli_writes_what_the_demo_reads(labels, tmp_path, capsys):
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    tanchors.main(["--labels", str(labels), "--out", str(out_t), "--seed", "1"])
    janchors.main(["--labels", str(labels), "--out", str(out_j), "--seed", "1"])
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())
    anchors = np.asarray(json.loads(out_t.read_text())["anchors"], np.float32)
    assert anchors.shape == (3, 3, 2)


# ---------------------------------------------------------------------------
# Plotting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 20, 80])
def test_colors_are_matplotlibs_tab20b(n):
    matplotlib = pytest.importorskip("matplotlib")
    cmap = matplotlib.colormaps["tab20b"]
    want = [tuple(c[:3]) for c in cmap(np.linspace(0, 1, n))]
    got = [tuple(v / 255 for v in c) for c in plotting.class_colors(n)]
    assert got == want


def test_box_edges_land_on_their_pixels():
    img = np.zeros((120, 160, 3), np.uint8)
    box = [0.5, 0.5, 0.5, 0.5, 0.9, 1]  # corners (40, 30) and (120, 90)
    out = np.asarray(plotting.plot_image_with_boxes(img, [box], CLASSES))
    assert out.shape == img.shape
    color = plotting.class_colors(2)[1]
    assert plotting.box_corners(box, 120, 160) == (40, 30, 120, 90)
    # line width max(1, int(0.003 * 160)) = 1: the outline is one pixel
    # on the four edges (below the label), nothing inside or outside
    for y, x in ((60, 40), (60, 120), (90, 80), (30, 100)):
        assert tuple(out[y, x]) == color, (y, x)
    for y, x in ((60, 41), (60, 119), (89, 80), (60, 39), (91, 80), (60, 80)):
        assert tuple(out[y, x]) == (0, 0, 0), (y, x)


def test_huge_and_non_finite_boxes():
    # an untrained head's exp gives boxes far larger than the image: their
    # edges stay off the image (as matplotlib clips them), drawn at once
    img = np.zeros((60, 80, 3), np.uint8)
    boxes = [[0.5, 0.5, 1e30, 1e30, 0.9, 0], [0.5, 0.5, float("inf"), 0.2, 0.9, 1],
             [float("nan"), 0.5, 0.2, 0.2, 0.9, 1]]
    out = np.asarray(plotting.plot_image_with_boxes(img, boxes, CLASSES))
    assert plotting.box_corners(boxes[0], 60, 80, margin=2) == (-2, -2, 82, 62)
    # nothing but the first box's label, at its (clipped) top-left corner
    assert (out[12:, :] == 0).all() and (out[:, 40:] == 0).all()


def test_line_width_and_label():
    img = np.zeros((700, 1000, 3), np.uint8)
    out = np.asarray(plotting.plot_image_with_boxes(img, [[0.5, 0.5, 0.4, 0.4, 0.8, 0]],
                                                    CLASSES))
    color = plotting.class_colors(2)[0]
    # max(1, int(0.003 * 1000)) = 3 pixels, drawn inward from the corner
    x0 = plotting.box_corners([0.5, 0.5, 0.4, 0.4], 700, 1000)[0]
    assert [tuple(out[350, x]) for x in range(x0 - 1, x0 + 4)] == [
        (0, 0, 0), color, color, color, (0, 0, 0)]
    # the label: white (anti-aliased) text on the class colour at the
    # top-left corner
    y0 = plotting.box_corners([0.5, 0.5, 0.4, 0.4], 700, 1000)[1]
    patch = out[y0 - 2 : y0 + 8, x0 - 2 : x0 + 20].reshape(-1, 3)
    assert (patch.min(axis=1) > 200).any() and (patch == color).all(axis=1).any()
    assert (out[: y0 - 20] == 0).all()


def test_plot_without_boxes_returns_the_image(rng):
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    out = plotting.plot_image_with_boxes(img, [], CLASSES)
    assert isinstance(out, Image.Image)
    np.testing.assert_array_equal(np.asarray(out), img)


def test_plot_original_unletterboxes_like_jax(rng):
    from yolo_for_turbines_tpu.data.augment import unletterbox_boxes

    img = rng.integers(0, 255, (100, 300, 3), dtype=np.uint8)
    boxes = [[0.5, 0.5, 0.2, 0.1, 0.9, 0], [0.3, 0.45, 0.1, 0.05, 0.6, 1]]
    out = plotting.plot_original(img, (416, 416), boxes, CLASSES)
    assert out.size == (300, 100)
    want = plotting.plot_image_with_boxes(
        img, unletterbox_boxes(boxes, (100, 300), (416, 416)), CLASSES)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(want))


def test_plot_savefig(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    img = np.zeros((40, 50, 3), np.uint8)
    out = plotting.plot_image_with_boxes(img, [[0.5, 0.5, 0.2, 0.2, 0.9, 0]], CLASSES,
                                         image_name="saved", savefig=True)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "saved.png")),
                                  np.asarray(out))


# ---------------------------------------------------------------------------
# Profiling
# ---------------------------------------------------------------------------


def test_step_timer():
    t = StepTimer(capacity=3)
    assert t.summary() == {}
    for _ in range(5):
        with t.measure():
            pass
    s = t.summary()
    assert s["steps"] == 3 and len(t.samples) == 3
    assert 0 <= s["p50_s"] <= s["p90_s"] <= s["p99_s"]
    assert set(s) == {"steps", "mean_s", "p50_s", "p90_s", "p99_s"}


def test_trace_scope_writes_a_loadable_trace(tmp_path):
    with trace_scope(tmp_path / "trace") as log_dir:
        torch.ones(8) @ torch.ones(8)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert log_dir == tmp_path / "trace" and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


# ---------------------------------------------------------------------------
# Training stability probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("what,skip", [("train", 1), ("steps", 5)])
def test_train_stability_summary(what, skip):
    from yolo_for_turbines_tpu_torch.tools.train_stability import summarize

    losses = [13.0] * skip + [40.0, 5.0]
    rows = [{"lr": 1e-3, "nan_stop": False, "losses": losses},
            {"lr": 1e-3, "nan_stop": True, "losses": [13.0] * skip + [9.0]},
            {"lr": 2e-4, "nan_stop": False, "losses": [13.0] * skip + [6.0, 5.0]}]
    assert summarize(rows, what) == {
        "0.001": {"runs": 2, "nan_stops": 1, "max_loss_after_start": [40.0, 9.0]},
        "0.0002": {"runs": 1, "nan_stops": 0, "max_loss_after_start": [6.0]}}


def test_train_stability_needs_a_card_by_default(tmp_path):
    from yolo_for_turbines_tpu_torch.tools import train_stability

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA|cuda"):
        train_stability.main(["--what", "steps", "--process", "0", "--work-dir", str(tmp_path)])
