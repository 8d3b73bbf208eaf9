"""Torch port: the single-image letterbox on the card (kernel K10,
``csrc/letterbox.cu``), its tables and its plain version.

On the CPU: Pillow's 8-bit bilinear tables (``pil_bilinear_tables``) and
the two integer passes of the plain version equal ``Image.resize(...,
BILINEAR)`` bit for bit, and the plain letterbox equals ``letterbox`` and
the division by 255; the tiles, the LRU of tables and the refusals. On the
card (marker ``cuda``; skipped without one) K10 equals the plain version bit
for bit, and ``Predictor.predict_image`` runs it once a request and never
PIL: ``python -m pytest tests/test_torch_letterbox.py -m cuda --noconftest
-q``."""

import ctypes
import re

import numpy as np
import pytest
import torch
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.data.augment import letterbox, letterbox_box_geometry
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan, init_plan
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import letterbox_kernel as lk

from helpers import MINI_LAYERS

# (w, h): the stream cell's three sizes, a 12 MP photo, a portrait frame,
# one side of 3, an upsample, a single pixel, and a frame already of the
# letterbox's size (no resize)
FRAMES = [(640, 480), (1280, 960), (1920, 1080), (4000, 3000), (731, 1289), (417, 3),
          (3, 417), (100, 80), (1, 1), (416, 312)]
SIZE = 416


def _frame(w, h, seed=0):
    return np.random.default_rng(seed + w * 7919 + h).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit for bit (floats compared as their words)."""
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("w,h", FRAMES)
def test_tables_and_plain_passes_are_pillows_resize(w, h):
    img = _frame(w, h)
    nh, nw, _, _ = letterbox_box_geometry(h, w, SIZE)
    want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    assert _same(lk.resize_reference(img, nh, nw), want)


@pytest.mark.parametrize("w,h", [(640, 480), (1920, 1080), (731, 1289), (3, 417), (1, 1),
                                 (416, 312)])
def test_plain_letterbox_is_letterbox_and_the_division(w, h):
    img = _frame(w, h, seed=1)
    lb, _ = letterbox(img, None, SIZE)
    want = lb.astype(np.float32) / 255.0
    got = lk.letterbox_reference(img, SIZE)
    assert _same(got, want)
    # and through the wrapper, on the CPU
    out = lk.letterbox(torch.from_numpy(img), SIZE)
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, SIZE, SIZE, 3)
    assert _same(out[0].numpy(), want)


def test_the_1_255_table_is_numpys():
    """All 256 values: the plain version's division, float32 by float32,
    is numpy's float32 division by the float 255.0."""
    v = np.arange(256, dtype=np.uint8).astype(np.float32)
    assert _same(v / np.float32(255.0), v / 255.0)
    assert _same((torch.from_numpy(v) / 255.0).numpy(), v / 255.0)


@pytest.mark.parametrize("n", [1, 7, 416])
def test_an_unchanged_side_is_one_tap_of_one(n):
    bounds, coeffs = lk.pil_bilinear_tables(n, n)
    assert bounds.tolist() == [[i, 1] for i in range(n)]
    assert coeffs.shape == (n, 1) and (coeffs == 1 << lk.PRECISION_BITS).all()


@pytest.mark.parametrize("n_in,n_out", [(1920, 416), (1080, 234), (417, 416), (80, 333),
                                        (1, 416), (4000, 416)])
def test_tables_sum_to_one_in_fixed_point(n_in, n_out):
    """Each row's weights sum to 1 << 22 within half a unit per tap, its
    taps lie inside the source, and the bounds never go back."""
    bounds, coeffs = lk.pil_bilinear_tables(n_in, n_out)
    assert bounds.dtype == coeffs.dtype == np.int32 and len(bounds) == len(coeffs) == n_out
    assert (bounds[:, 0] >= 0).all() and (bounds[:, 1] >= 1).all()
    assert (bounds[:, 0] + bounds[:, 1] <= n_in).all()
    assert (np.diff(bounds[:, 0]) >= 0).all()
    assert (np.diff(bounds[:, 0] + bounds[:, 1]) >= 0).all()
    assert (np.abs(coeffs.sum(1) - (1 << 22)) <= coeffs.shape[1]).all()
    past = np.arange(coeffs.shape[1])[None, :] >= bounds[:, 1:2]
    assert (coeffs[past] == 0).all()


def test_the_launcher_is_declared_as_the_library_binds_it():
    source = (kernels.CSRC_DIR / "letterbox.cu").read_text()
    found = re.search(r'extern "C" int letterbox_launch\(([^)]*)\)', source)
    assert found
    params = [p.strip() for p in found.group(1).split(",")]
    argtypes, _ = kernels._SIGNATURES["letterbox_launch"]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is ctypes.c_void_p), param
    assert re.search(r"constexpr int kThreads = (\d+);", source).group(1) == str(lk.THREADS)


@pytest.mark.parametrize("w,h,size,rows,cols", [
    (1920, 1080, SIZE, 16, 64), (4000, 3000, SIZE, 16, 64), (20000, 15000, SIZE, 4, 64),
    (417, 3, SIZE, 16, 64), (40, 200000, SIZE, 1, 17), (1, 400000, 16, 1, 1)])
def test_a_plan_fits_its_tile_in_shared_memory(w, h, size, rows, cols):
    """The tallest band that fits 48 KB at 64 columns, else one row by
    fewer columns (beyond 48 KB only at one column)."""
    p = lk.plan(h, w, size, "cpu")
    nh, nw, top, left = letterbox_box_geometry(h, w, size)
    assert (p.nh, p.nw, p.top, p.left) == (nh, nw, top, left)
    assert (p.band_rows, p.tile_cols) == (rows, cols)
    assert p.smem <= (lk.SMEM_DEFAULT if cols > 1 else lk.SMEM_MAX)
    hb, hk = lk.pil_bilinear_tables(w, nw)
    vb, vk = lk.pil_bilinear_tables(h, nh)
    want = np.concatenate([hb.ravel(), hk.ravel(), vb.ravel(), vk.ravel()])
    assert p.table.dtype == torch.int32 and np.array_equal(p.table.numpy(), want)
    assert (p.hks, p.vks) == (hk.shape[1], vk.shape[1])


def test_a_frame_too_tall_for_one_cta_is_refused():
    with pytest.raises(ValueError, match="beyond one CTA's shared memory"):
        lk.plan(2_000_000, 1, 16, "cpu")


def test_the_tables_are_made_once_per_geometry_and_the_oldest_dropped(monkeypatch):
    monkeypatch.setattr(lk, "TABLES_KEPT", 2)
    tables = lk.LetterboxTables("cpu")
    a = tables.get(480, 640, SIZE)
    assert tables.get(480, 640, SIZE) is a and tables.builds == 1
    tables.get(1080, 1920, SIZE)
    tables.get(480, 640, SIZE)  # now the most recent
    tables.get(960, 1280, SIZE)  # drops 1080p
    assert tables.builds == 3
    assert tables.get(480, 640, SIZE) is a and tables.builds == 3
    tables.get(1080, 1920, SIZE)
    assert tables.builds == 4


@pytest.mark.parametrize("frame", [
    np.zeros((48, 80), np.uint8), np.zeros((48, 80, 4), np.uint8),
    np.zeros((48, 80, 3), np.float32), np.zeros((0, 80, 3), np.uint8),
    torch.zeros((48, 80, 3), dtype=torch.int16)])
def test_the_wrapper_refuses_what_k10_does_not_take(frame):
    with pytest.raises(ValueError):
        lk.check_frame(frame)
    with pytest.raises(ValueError):
        lk.letterbox(torch.as_tensor(frame), SIZE)


def test_off_the_cpu_only_cuda():
    meta = torch.empty((48, 80, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.letterbox(meta, SIZE)


def test_the_cpu_predictor_keeps_the_host_letterbox():
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    tree = init_plan(build_plan(cfg), torch.Generator().manual_seed(0))
    pred = Predictor.from_folded(cfg, tree, device="cpu", image_size=64, max_boxes=8)
    before = lk.launches
    assert pred._tables is None
    pred.predict_image(_frame(80, 48))
    assert lk.launches == before


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K10 runs only there")
    return torch.device("cuda", 0)


def _card_predictor(card, size=SIZE):
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    tree = init_plan(build_plan(cfg), torch.Generator().manual_seed(0))
    return Predictor.from_folded(cfg, tree, device=card, image_size=size, max_boxes=8)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", FRAMES + [(5000, 7), (33, 2000)])
def test_card_kernel_is_the_plain_letterbox(card, w, h):
    img = _frame(w, h, seed=2)
    before = lk.launches
    got = lk.letterbox(torch.from_numpy(img).to(card), SIZE)
    torch.cuda.synchronize()
    assert lk.launches == before + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, SIZE, SIZE, 3)
    assert _same(got[0].cpu().numpy(), lk.letterbox_reference(img, SIZE))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,size", [(40, 200000, SIZE), (1, 400000, 16)])
def test_card_kernel_takes_bands_beyond_the_default_tile(card, w, h, size):
    """A band of one row over fewer columns, and one column in more than 48
    KB of shared memory (``test_a_plan_fits_its_tile_in_shared_memory``)."""
    img = _frame(w, h, seed=4)
    got = lk.letterbox(torch.from_numpy(img).to(card), size)
    assert _same(got[0].cpu().numpy(), lk.letterbox_reference(img, size))


@pytest.mark.cuda
def test_card_kernel_gives_every_value_and_takes_views(card):
    """A frame of all 256 values unchanged (only the pad and the division)
    and resized; a non-contiguous frame, on the host and on the device."""
    ramp = np.tile(np.arange(256, dtype=np.uint8), 3 * 192).reshape(192, 256, 3)
    for img in (ramp, np.ascontiguousarray(ramp[::2, ::-1])):
        want = lk.letterbox_reference(img, 256)
        got = lk.letterbox(torch.from_numpy(img).to(card), 256)
        assert _same(got[0].cpu().numpy(), want)
    big = _frame(1920, 1080, seed=3)
    view = big[::-1, 100:1700]  # negative stride, a column slice
    want = lk.letterbox_reference(np.ascontiguousarray(view), SIZE)
    dev = torch.from_numpy(big).to(card).flip(0)[:, 100:1700]
    assert not dev.is_contiguous()
    assert _same(lk.letterbox(dev, SIZE)[0].cpu().numpy(), want)
    # and a predictor's request: the model's input
    pred = _card_predictor(card)
    seen = []
    heads = pred._heads
    pred._heads = lambda x: seen.append(x.clone()) or heads(x)
    pred.predict_image(view)
    assert len(seen) == 1 and _same(seen[0][0].cpu().numpy(), want)


@pytest.mark.cuda
def test_card_refuses_what_k10_does_not_take(card):
    pred = _card_predictor(card, size=64)
    for frame in (np.zeros((48, 80), np.uint8), np.zeros((48, 80, 4), np.uint8),
                  np.zeros((48, 80, 3), np.float32)):
        with pytest.raises(ValueError, match="HWC uint8 frame with 3 channels"):
            pred.predict_image(frame)
    with pytest.raises(ValueError):
        lk.letterbox(torch.zeros((48, 80, 3), dtype=torch.float32, device=card), 64)
    tables = lk.LetterboxTables("cpu")
    with pytest.raises(ValueError, match="tables on cpu"):
        lk.letterbox(torch.zeros((48, 80, 3), dtype=torch.uint8, device=card), 64, tables)


@pytest.mark.cuda
def test_card_predict_image_runs_k10_once_and_never_pil(card, monkeypatch):
    def no_pil(*args, **kwargs):
        raise AssertionError("PIL's resize ran on the card's path")

    monkeypatch.setattr(Image.Image, "resize", no_pil)
    pred = _card_predictor(card)
    sizes = [(640, 480), (1280, 960), (1920, 1080)]
    before = lk.launches
    for _ in range(2):
        for w, h in sizes:
            assert isinstance(pred.predict_image(_frame(w, h)), list)
    assert lk.launches == before + 6
    # each size's tables made once
    assert pred._tables.builds == len(sizes)
    # a batch of letterboxed inputs (the offline paths) launches no K10
    pred.predict_batch(torch.rand((2, SIZE, SIZE, 3), device=card))
    assert lk.launches == before + 6
