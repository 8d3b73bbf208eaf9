"""Torch port: the host data layer (``yolo_for_turbines_tpu_torch/data/`` and
the train augmenter ``native/augment.cpp``) against the JAX package's
``data/`` and ``native/packer.cpp``.

Every comparison is bit for bit: the same seeded generator through the
same numpy, PIL and C++ code gives the same pixels and labels. The
dataset's per-item child generators are drawn under a lock in call order,
so these tests call ``__getitem__`` in one thread or run the loader with
one worker (with several, which item gets which child depends on the
interleaving, in both packages).
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu import native as jnative
from yolo_for_turbines_tpu.data import augment as jaug
from yolo_for_turbines_tpu.data import dataset as jds
from yolo_for_turbines_tpu.data import loader as jloader
from yolo_for_turbines_tpu.data import mosaic as jmosaic
from yolo_for_turbines_tpu.data import splits as jsplits
from yolo_for_turbines_tpu.data import synthetic as jsynth
from yolo_for_turbines_tpu_torch import native
from yolo_for_turbines_tpu_torch.config import MULTI_SCALE_TRAIN_SIZES, TURBINE_ANCHORS
from yolo_for_turbines_tpu_torch.data import augment as aug
from yolo_for_turbines_tpu_torch.data import dataset as ds
from yolo_for_turbines_tpu_torch.data import loader
from yolo_for_turbines_tpu_torch.data import mosaic
from yolo_for_turbines_tpu_torch.data import splits
from yolo_for_turbines_tpu_torch.data import synthetic


def _both_native():
    if jnative.load_library() is None:
        pytest.fail("the JAX package's packer did not build: g++ is needed here")
    assert native.load_library() is not None, "the port's packers did not build"


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _image(seed, h=90, w=120):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


BOXES = np.array([[0.5, 0.5, 0.3, 0.4, 1], [0.1, 0.2, 0.15, 0.3, 0],
                  [0.95, 0.9, 0.2, 0.3, 1], [0.7, 0.3, 0.05, 0.05, 0]])


# --- augment --------------------------------------------------------------


def test_box_geometry_matches_jax():
    _equal(aug.clip_boxes_min_visibility(BOXES * [1.4, 1.3, 2, 2, 1] - [0.2, 0.1, 0, 0, 0]),
           jaug.clip_boxes_min_visibility(BOXES * [1.4, 1.3, 2, 2, 1] - [0.2, 0.1, 0, 0, 0]))
    _equal(aug.shift_scale_boxes(BOXES, 1.3, 0.05, -0.04),
           jaug.shift_scale_boxes(BOXES, 1.3, 0.05, -0.04))
    img = _image(0)
    _equal(aug.hflip(img, BOXES), jaug.hflip(img, BOXES))
    _equal(aug.letterbox(img, BOXES, 64), jaug.letterbox(img, BOXES, 64))


@pytest.mark.parametrize("seed", range(3))
def test_random_augmentations_match_jax(seed):
    img = _image(seed)
    _equal(aug._draw_hsv_shifts(np.random.default_rng(seed)),
           jaug._draw_hsv_shifts(np.random.default_rng(seed)))
    _equal(aug.apply_hsv_shift(img, 0.01, -0.1, 0.05), jaug.apply_hsv_shift(img, 0.01, -0.1, 0.05))
    _equal(aug.hsv_jitter(img, np.random.default_rng(seed)),
           jaug.hsv_jitter(img, np.random.default_rng(seed)))
    _equal(aug.shift_scale(img, BOXES, np.random.default_rng(seed)),
           jaug.shift_scale(img, BOXES, np.random.default_rng(seed)))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("letterbox_first", [True, False])
def test_train_transform_matches_jax(use_native, letterbox_first):
    """The train pipeline on both paths: the rng is drawn in the same order
    (hsv gate, shifts, affine gate, affine parameters, flip gate), so pixels
    and labels agree bit for bit, and the generators end in the same state."""
    if use_native:
        _both_native()
    for seed in range(8):
        img = _image(seed, 60 + seed, 80)
        got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = aug.Transform(64, True, letterbox_first, use_native)(img, BOXES, got_rng)
        want = jaug.Transform(64, True, letterbox_first, use_native)(img, BOXES, want_rng)
        _equal(got, want)
        assert got_rng.uniform() == want_rng.uniform()


def test_native_and_numpy_labels_agree():
    """The C++ path draws the numpy path's parameters: the same labels."""
    _both_native()
    for seed in range(8):
        img = _image(seed)
        a = aug.Transform(64, True, use_native=True)(img, BOXES, np.random.default_rng(seed))
        b = aug.Transform(64, True, use_native=False)(img, BOXES, np.random.default_rng(seed))
        _equal(a["bboxes"], b["bboxes"])
        assert a["image"].shape == b["image"].shape == (64, 64, 3)


def test_test_and_image_transforms_match_jax():
    assert aug.test_transforms.__test__ is False
    img = _image(5)
    _equal(aug.test_transforms(64)(img, BOXES), jaug.test_transforms(64)(img, BOXES))
    _equal(aug.set_only_image_transforms(64)(img), jaug.set_only_image_transforms(64)(img))
    assert aug.set_train_transforms(64, mosaic=True) == aug.Transform(64, True, False)


# --- native ---------------------------------------------------------------


@pytest.mark.parametrize("params", [
    dict(),
    dict(do_affine=True, scale=1.3, dx=0.04, dy=-0.05),
    dict(flip=True, do_hsv=True, dh=0.01, ds=-0.15, dv=0.1),
    dict(do_affine=True, scale=1.45, dx=-0.06, dy=0.06, flip=True, do_hsv=True,
         dh=-0.011, ds=0.19, dv=-0.15),
])
@pytest.mark.parametrize("hw", [(90, 120), (200, 50), (64, 64)])
def test_native_train_augment_matches_jax(params, hw):
    _both_native()
    img = _image(sum(hw), *hw)
    got = native.train_augment(img, 64, **params)
    assert got.dtype == np.float32 and got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, jnative.train_augment(img, 64, **params))


def test_native_mosaic_cutout_matches_jax():
    _both_native()
    imgs = [_image(i, 40 + 17 * i, 90 - 11 * i) for i in range(4)]
    geoms = [mosaic._resized_dims(*im.shape[:2], 64) for im in imgs]
    for yx in ((0, 0), (25, 38), (64, 64), (30, 5)):
        got = native.mosaic_cutout(imgs, geoms, 64, *yx)
        np.testing.assert_array_equal(got, jnative.mosaic_cutout(imgs, geoms, 64, *yx))


@pytest.mark.parametrize("use_native", [False, True])
def test_mosaic_matches_jax(use_native):
    if use_native:
        _both_native()
    imgs = [_image(i, 50 + 10 * i, 70) for i in range(4)]
    anns = [BOXES[:2], BOXES[2:], np.zeros((0, 5)), BOXES[1:3]]
    for seed in range(6):
        got = mosaic.mosaic_augmentation(imgs, anns, 64, np.random.default_rng(seed), use_native)
        want = jmosaic.mosaic_augmentation(imgs, anns, 64, np.random.default_rng(seed),
                                           use_native)
        _equal(got, want)
    assert mosaic.mosaic_augmentation(imgs, [np.zeros((0, 5))] * 4, 64) == (-1, -1)


# --- dataset, loader ------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """12 synthetic JPEGs with labels (the JAX generator), two of them made
    negatives (label files removed), split 70 / 30."""
    root = tmp_path_factory.mktemp("data")
    jsynth.generate_synthetic_dataset(root, num_images=12, image_size=(120, 88), seed=3)
    for i in (4, 9):
        os.remove(root / "labels" / f"syn{i:05d}.txt")
    jsplits.create_csv_files(root / "images", root / "labels", root,
                             {"train": 0.7, "val": 0.3}, image_ext=".jpg")
    return root


def _datasets(root, split="train", **kw):
    args = dict(csv_split_file=root / f"{split}.csv", img_folder=root / "images",
                annotation_folder=root / "labels", anchors=TURBINE_ANCHORS, image_size=64,
                grid_sizes=(2, 4, 8), num_classes=2, seed=5)
    args.update(kw)
    tf = args.pop("tf", None)
    got = ds.YOLODataset(transform=tf and tf(aug), **args)
    want = jds.YOLODataset(transform=tf and tf(jaug), **args)
    return got, want


@pytest.mark.parametrize("kind", ["train", "multi_scale", "mosaic", "val", "cache"])
def test_dataset_items_match_jax(data_dir, kind):
    kw = {
        "train": dict(tf=lambda m: m.set_train_transforms(64, mosaic=False)),
        "multi_scale": dict(tf=lambda m: m.set_train_transforms(64, mosaic=False),
                            multi_scale=True),
        "mosaic": dict(tf=lambda m: m.set_train_transforms(64, mosaic=True), mosaic=True),
        "val": dict(split="val", tf=lambda m: m.test_transforms(64)),
        "cache": dict(tf=lambda m: m.set_train_transforms(64, mosaic=False),
                      multi_scale=True, cache_images=True),
    }[kind]
    got, want = _datasets(data_dir, **kw)
    assert len(got) == len(want) > 0
    assert got.annotations == want.annotations
    for _ in range(2):  # a second epoch (and the cache's hits)
        for i in range(len(got)):
            _equal(got[i], want[i])
    if kind in ("multi_scale", "cache"):
        for _ in range(3):  # change_scale draws from the dataset's generator
            got.change_scale()
            want.change_scale()
            assert got.image_size == want.image_size in MULTI_SCALE_TRAIN_SIZES
            assert got.grid_sizes == want.grid_sizes
            _equal(got[0], want[0])


def test_dataset_draft_decode_and_boxes_match_jax(data_dir):
    got, want = _datasets(data_dir)
    for i in range(len(got)):
        _equal(got.load_image(i), want.load_image(i))
        lbl = got.annotations[i][1]
        if lbl is not None and (data_dir / "labels" / lbl).exists():
            _equal(got.load_boxes(data_dir / "labels" / lbl),
                   want.load_boxes(data_dir / "labels" / lbl))


def test_collate_matches_jax():
    rng = np.random.default_rng(0)
    samples = [(rng.uniform(size=(h, w, 3)).astype(np.float32),
                tuple(rng.uniform(size=(3, s, s, 6)).astype(np.float32) for s in (2, 4, 8)))
               for h, w in ((64, 64), (60, 64), (64, 50))]
    _equal(loader.collate(samples), jloader.collate(samples))


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_order_and_batches_match_jax(data_dir, shuffle, drop_last):
    got_ds, want_ds = _datasets(data_dir, tf=lambda m: m.set_train_transforms(64, mosaic=False))
    got = loader.DataLoader(got_ds, 3, shuffle=shuffle, num_workers=1, drop_last=drop_last, seed=4)
    want = jloader.DataLoader(want_ds, 3, shuffle=shuffle, num_workers=1, drop_last=drop_last,
                              seed=4)
    assert len(got) == len(want)
    for _ in range(2):
        _equal([b.tolist() for b in got._batch_indices()],
               [b.tolist() for b in want._batch_indices()])
    for a, b in zip(got, want):
        _equal(a, b)


def test_get_loaders_match_jax(data_dir):
    kw = dict(batch_size=4, anchors=TURBINE_ANCHORS, image_folder=data_dir / "images",
              annotation_folder=data_dir / "labels", num_workers=1, image_size=64)
    got = loader.get_loaders(data_dir, **kw)
    want = jloader.get_loaders(data_dir, **kw)
    assert [len(x) for x in got[:2]] == [len(x) for x in want[:2]]
    assert got[2].multi_scale and got[1].dataset.multi_scale is False
    for a, b in zip(got[1], want[1]):  # val: no randomness
        _equal(a, b)


def test_dataloader_delivers_producer_errors_and_stops():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise ValueError("corrupt sample")

    with pytest.raises(ValueError, match="corrupt sample"):
        for _ in loader.DataLoader(Broken(), batch_size=2, num_workers=2):
            pass

    class Slow:
        def __len__(self):
            return 40

        def __getitem__(self, i):
            return np.zeros((2, 2, 3), np.float32), (np.zeros((1,), np.float32),)

    it = iter(loader.DataLoader(Slow(), batch_size=2, num_workers=2, prefetch=1))
    next(it)
    it.close()  # the producer sees the stop event and ends
    import threading

    assert not any(t.name == "DataLoader-producer" and t.is_alive()
                   for t in threading.enumerate())


def test_prefetch_to_device_on_the_cpu_yields_the_batches():
    batches = [(np.full((2, 4, 4, 3), i, np.float32),
                (np.full((2, 3, 1, 1, 6), -i, np.float32),)) for i in range(5)]
    out = list(loader.prefetch_to_device(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for (x, y), (bx, by) in zip(out, batches):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), bx)
        np.testing.assert_array_equal(y[0].numpy(), by[0])
    # a consumer that stops early closes the source
    closed = []

    def source():
        try:
            yield from batches
        finally:
            closed.append(True)

    gen = loader.prefetch_to_device(source(), "cpu")
    next(gen)
    gen.close()
    assert closed == [True]


# --- splits, synthetic ----------------------------------------------------


def test_synthetic_set_is_byte_identical(tmp_path):
    synthetic.generate_synthetic_dataset(tmp_path / "port", num_images=5, image_size=(96, 64),
                                         seed=9)
    jsynth.generate_synthetic_dataset(tmp_path / "jax", num_images=5, image_size=(96, 64), seed=9)
    for sub in ("images", "labels"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names and len(names) == 5
        match, mismatch, errors = filecmp.cmpfiles(tmp_path / "port" / sub,
                                                   tmp_path / "jax" / sub, names, shallow=False)
        assert mismatch == [] and errors == []


def test_splits_are_byte_identical(data_dir, tmp_path):
    split_map = {"train": 0.6, "val": 0.25, "test": 0.15}
    splits.create_csv_files(data_dir / "images", data_dir / "labels", tmp_path / "port",
                            split_map, image_ext=".jpg")
    jsplits.create_csv_files(data_dir / "images", data_dir / "labels", tmp_path / "jax",
                             split_map, image_ext=".jpg")
    for name in split_map:
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == (
            tmp_path / "jax" / f"{name}.csv").read_bytes()
    for lbl in sorted(os.listdir(data_dir / "labels")):
        assert splits.check_boxes(data_dir / "labels", lbl) == jsplits.check_boxes(
            data_dir / "labels", lbl)
    bad = tmp_path / "bad.txt"
    np.savetxt(bad, np.array([[0, 1.5, 0.5, 0.2, 0.3]]), fmt="%.6f")
    assert splits.check_boxes(tmp_path, "bad.txt") is False


def test_splits_cli_matches_jax(data_dir, tmp_path, capsys):
    args = ["--images", str(data_dir / "images"), "--labels", str(data_dir / "labels"),
            "--image-ext", ".jpg", "--train", "0.5", "--val", "0.5", "--test", "0"]
    splits.main(args + ["--out", str(tmp_path / "port")])
    jsplits.main(args + ["--out", str(tmp_path / "jax")])
    assert "train.csv, val.csv" in capsys.readouterr().out
    for name in ("train", "val"):
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == (
            tmp_path / "jax" / f"{name}.csv").read_bytes()
