"""Torch port: the max pools of the folded forward (kernel K8,
``csrc/maxpool.cu``) and their routing in ``models/blocks.py``.

On the CPU: the plain versions (``maxpool_pyramid_reference``,
``maxpool2x2_reference``) are the aten composition, against pools over an
explicit -inf pad, at both window orders the models use (SPP's ``(13, 9, 5,
1)``, SPPCSPC's ``(1, 5, 9, 13)``), at odd and even sides and widths of 8,
64, 512 and one off a multiple of 8, with NaN and -inf planted. K8's own
arithmetic (separable 5-wide maxima cascaded to 9 and 13, each pass
skipping what lies outside the loaded rows, in one band or in bands of rows
with halos; four cells per 2x2 output, at stride 2 and 1) is emulated in
torch and equals them too. ``apply_pyramid`` and ``apply_maxpool2x2`` give
the same values for inputs in NCHW memory, off a 16-byte boundary or off a
multiple of 8 channels, in the input's layout. The router sends every bf16
CUDA tensor that needs no grad to K8 and keeps CPU, float32, grad-requiring
and s8 inputs on aten, where the pyramid's concat is counted; the counter
stays 0. YOLOv4 and YOLOv7 forwards on the card's route (emulated) give the
heads of the aten route and engage K8 once and six times.

On the card (marker ``cuda``; skipped without one): K8 equals the aten
composition by value (NaN in the same places) at YOLOv4's 19x19x512 and
YOLOv7's 20x20x512 pyramids at B = 1, 2 and 64, on planes split into bands,
at each of YOLOv7's five MP geometries and at tiny's stride-1 pool; the
wrappers raise on what the kernel does not take, and the router launches it
for each of those inputs all the same; a YOLOv4 and a YOLOv7
``predict_batch`` launch it 1 and 6 times, with the heads of the aten
route. Run them on a card with ``python -m pytest tests/test_torch_maxpool.py
-m cuda --noconftest``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import blocks
from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    YOLOV4_LAYER_CONFIG,
    YOLOV7_LAYER_CONFIG,
    build_plan,
    init_plan,
)
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import maxpool_kernel as mk
from yolo_for_turbines_tpu_torch.utils import profiling

CL = torch.channels_last
ORDERS = [(13, 9, 5, 1), (1, 5, 9, 13)]
# YOLOv7's MP inputs at 640px: (side, channels)
MP_GEOMETRIES = [(160, 256), (80, 512), (40, 1024), (80, 128), (40, 256)]


def _nhwc(b, c, h, w, seed, dtype=torch.bfloat16, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, c, h, w), generator=g).to(dtype).to(device).contiguous(
        memory_format=CL)


def _same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal as values: NaN in the same places, every other element equal
    (-inf included; +0 equals -0)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(na, nb)
            and bool((a.masked_fill(na, 0) == b.masked_fill(nb, 0)).all()))


def _padded_pyramid(x, windows):
    """The pools over an explicit -inf pad, concatenated."""
    return torch.cat([x if k == 1 else F.max_pool2d(
        F.pad(x, (k // 2,) * 4, value=float("-inf")), k, 1) for k in windows], dim=1)


def _pass(t, grow, dim):
    """One of K8's separable passes: the max over ``grow`` cells on each
    side along ``dim``, skipping those outside the plane."""
    m, n = t.clone(), t.shape[dim]
    for d in range(1, min(grow, n - 1) + 1):
        lo, hi = m.narrow(dim, d, n - d), m.narrow(dim, 0, n - d)
        lo.copy_(torch.maximum(lo, t.narrow(dim, 0, n - d)))
        hi.copy_(torch.maximum(hi, t.narrow(dim, d, n - d)))
    return m


def _k8_pyramid(x, windows, band=None):
    """K8's pyramid as the kernel computes it: the distinct windows from
    the smallest up, each a row pass then a column pass grown from the
    last; with a ``band``, each band of that many rows from its own rows
    and ``halo`` more on each side, keeping the band's rows alone."""
    h = x.shape[2]
    band = band or h
    halo = (max(windows) - 1) // 2
    bands = []
    for r0 in range(0, h, band):
        r1 = min(h, r0 + band)
        l0 = max(0, r0 - halo)
        plane = x[:, :, l0 : min(h, r1 + halo)]
        slots, radius = {1: plane}, 0
        for k in sorted(set(windows) - {1}):
            grow = (k - 1) // 2 - radius
            plane = _pass(_pass(plane, grow, 3), grow, 2)
            slots[k], radius = plane, (k - 1) // 2
        bands.append(torch.cat([slots[k] for k in windows], dim=1)[:, :, r0 - l0 : r1 - l0])
    return torch.cat(bands, dim=2).contiguous(memory_format=CL)


def _k8_2x2(x, stride=2):
    """K8's 2x2 pass: the four cells of each output, floor sizes at stride
    2; at stride 1 the last row and column stand in for those past them."""
    h, w = x.shape[2], x.shape[3]
    if stride == 2:
        h, w = h // 2 * 2, w // 2 * 2
    rows = [torch.arange(0, h, stride), torch.arange(0, h, stride).add(1).clamp(max=h - 1)]
    cols = [torch.arange(0, w, stride), torch.arange(0, w, stride).add(1).clamp(max=w - 1)]
    v = [x[:, :, i][:, :, :, j] for i in rows for j in cols]
    return torch.maximum(torch.maximum(v[0], v[1]), torch.maximum(v[2], v[3])).contiguous(
        memory_format=CL)


def _planted(x, seed):
    """NaN at a few cells, -inf over a 3x3 patch and over one whole channel."""
    x = x.clone()
    g = torch.Generator().manual_seed(seed)
    b, c, h, w = x.shape
    for _ in range(3):
        i = [int(torch.randint(n, (1,), generator=g)) for n in (b, c, h, w)]
        x[i[0], i[1], i[2], i[3]] = float("nan")
    x[:, 0, : min(3, h), : min(3, w)] = float("-inf")
    x[:, c - 1] = float("-inf")
    return x


@pytest.mark.parametrize("c", [8, 64, 512, 12])
@pytest.mark.parametrize("side", [1, 13, 19, 20, 41])
@pytest.mark.parametrize("windows", ORDERS)
def test_plain_pyramid_is_the_aten_composition(windows, side, c):
    x = _nhwc(2, c, side, side, side * 1000 + c)
    before = mk.launches
    got = mk.maxpool_pyramid_reference(x, windows)
    assert got.shape == (2, 4 * c, side, side) and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, _padded_pyramid(x, windows))
    # the CPU wrapper and the router take it, the router's concat counted
    assert torch.equal(mk.maxpool_pyramid(x, windows), got)
    counted = profiling.concat_bytes
    assert torch.equal(blocks.maxpool_pyramid(x, windows), got)
    assert profiling.concat_bytes - counted == got.nbytes
    assert mk.launches == before
    # K8's cascade of separable passes gives the same values
    assert torch.equal(_k8_pyramid(x, windows), got)


@pytest.mark.parametrize("side", [1, 13, 20, 41])
@pytest.mark.parametrize("windows", ORDERS + [(1,), (3, 7), (11,)])
def test_nan_and_inf_stay_where_aten_puts_them(windows, side):
    x = _planted(_nhwc(2, 16, side, side, side), side + 1)
    want = _padded_pyramid(x, windows)
    got = mk.maxpool_pyramid_reference(x, windows)
    assert _same_values(got, want) and _same_values(_k8_pyramid(x, windows), want)
    # a NaN reaches every cell whose window holds it
    nan = torch.isnan(x).float()
    for s, k in enumerate(windows):
        reach = F.max_pool2d(nan, k, 1, padding=k // 2) > 0 if k > 1 else nan > 0
        assert torch.equal(torch.isnan(got[:, s * 16 : (s + 1) * 16]), reach)
    # a channel of -inf stays -inf in every slot
    assert all(bool(torch.isneginf(got[:, s * 16 + 15]).all()) for s in range(len(windows)))


@pytest.mark.parametrize("c", [8, 64, 12])
@pytest.mark.parametrize("side", [2, 3, 13, 20, 41])
def test_plain_2x2_is_the_aten_pool(side, c):
    x = _planted(_nhwc(2, c, side, side, side + c), c)
    want = F.max_pool2d(x, 2, 2)
    before = mk.launches
    for got in (mk.maxpool2x2_reference(x), mk.maxpool2x2(x), blocks.maxpool2d(x, 2, 2),
                _k8_2x2(x)):
        assert _same_values(got, want) and got.shape == (2, c, side // 2, side // 2)
    assert mk.launches == before


@pytest.mark.parametrize("c", [8, 12])
@pytest.mark.parametrize("side", [1, 2, 13, 20])
def test_plain_2x2_at_stride_1_is_the_same_pool(side, c):
    """Tiny's last pool: 2x2 at stride 1 over the plane padded with -inf
    after its last row and column, as ``maxpool2d`` pools it on the CPU."""
    x = _planted(_nhwc(2, c, side, side, side + c), c)
    want = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
    before = mk.launches
    for got in (mk.maxpool2x2_reference(x, 1), mk.maxpool2x2(x, 1), blocks.maxpool2d(x, 2, 1),
                _k8_2x2(x, 1)):
        assert _same_values(got, want) and got.shape == (2, c, side, side)
    assert mk.launches == before


@pytest.mark.parametrize("band", [1, 2, 5, 7, 13])
@pytest.mark.parametrize("windows", ORDERS + [(3, 1), (1, 15)])
def test_k8_bands_give_the_whole_planes_values(windows, band):
    """A plane split into bands of rows, each pooled from its rows and a
    halo of the largest window's radius on each side as K8 does for planes
    beyond its shared memory, gives the values of the whole plane."""
    x = _planted(_nhwc(2, 8, 31, 9, band), band)
    want = _padded_pyramid(x, windows)
    assert _same_values(_k8_pyramid(x, windows, band), want)
    assert _same_values(_k8_pyramid(x, windows), want)


def _layouts(c, seed):
    """(name, tensor) of a (2, c, 11, 9) bf16 plane: channels_last, NCHW, a
    channels_last view off a 16-byte boundary, and a channel slice."""
    x = _nhwc(2, c, 11, 9, seed)
    base = torch.empty(x.numel() + 8, dtype=torch.bfloat16)
    off = base[1 : 1 + x.numel()].view(2, 11, 9, c).permute(0, 3, 1, 2)
    off.copy_(x)
    wide = _nhwc(2, c + 16, 11, 9, seed + 1)
    return [("nhwc", x), ("nchw", x.contiguous()), ("off 16 bytes", off),
            ("channel slice", wide[:, 3 : 3 + c])]


@pytest.mark.parametrize("c", [8, 12, 3, 64])
def test_apply_copies_what_the_kernel_does_not_read_and_keeps_the_layout(c):
    """``apply_pyramid`` and ``apply_maxpool2x2`` (the CPU's plain versions
    under them) give the aten composition's values for every layout and
    width, padded to 8 channels and cut back, in the input's layout."""
    for name, x in _layouts(c, c):
        assert mk._operand(x).is_contiguous(memory_format=CL)
        assert mk._operand(x).shape[1] % 8 == 0 and mk._operand(x).data_ptr() % 16 == 0
        nchw = name == "nchw" and c > 1
        for windows in ORDERS:
            got = mk.apply_pyramid(x, windows)
            assert torch.equal(got, _padded_pyramid(x, windows)), (name, windows)
            assert got.is_contiguous() if nchw else got.is_contiguous(memory_format=CL)
        for stride in (2, 1):
            got = mk.apply_maxpool2x2(x, stride)
            assert torch.equal(got, mk.maxpool2x2_reference(x, stride)), (name, stride)
            assert got.is_contiguous() if nchw else got.is_contiguous(memory_format=CL)
    aligned = _nhwc(2, 16, 11, 9, 0)
    assert mk._operand(aligned) is aligned


@pytest.mark.parametrize("windows", [(), (2,), (0,), (5, 4), (1,) * 9])
def test_the_wrapper_refuses_windows_it_cannot_pool(windows):
    with pytest.raises(ValueError):
        mk.maxpool_pyramid(_nhwc(1, 8, 5, 5, 0), windows)


def test_pyramid_planes_the_kernel_takes():
    """Whole planes up to 7,264 pixels, and bands of rows with their halos
    (12 rows for windows up to 13) of at most 558 pixels a row."""
    assert mk._pyramid_fits(85, 85, (13,)) and mk._pyramid_fits(4000, 558, (13, 9, 5, 1))
    assert not mk._pyramid_fits(4000, 559, (13, 9, 5, 1))
    assert mk._pyramid_fits(1, 7264, (13,)) and not mk._pyramid_fits(1, 7265, (13,))
    assert mk._pyramid_fits(100, 1000, (3, 1)) and not mk._pyramid_fits(100, 2500, (3, 1))


@pytest.mark.parametrize("name", ["maxpool_pyramid_launch", "maxpool2x2_launch"])
def test_launchers_are_declared_as_the_library_binds_them(name):
    """Each launcher's parameters in ``csrc/maxpool.cu`` match the ctypes
    argument types it is bound with, one for one."""
    source = (kernels.CSRC_DIR / "maxpool.cu").read_text()
    found = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", source)
    assert found, name
    params = [p.strip() for p in found.group(1).split(",")]
    argtypes, _ = kernels._SIGNATURES[name]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        pointer = "*" in param
        assert pointer == (argtype in (ctypes.c_void_p,) or hasattr(argtype, "contents")), param


class _Like:
    """What ``pool_wins`` reads of a tensor."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, grad=False):
        self.is_cuda, self.dtype, self.requires_grad = cuda, dtype, grad


@pytest.mark.parametrize("x,grad_mode,wins", [
    (_Like(), True, True),
    (_Like(grad=True), False, True),  # no_grad / inference: nothing to differentiate
    (_Like(grad=True), True, False),  # a trainable module under autograd
    (_Like(cuda=False), True, False),
    (_Like(dtype=torch.float32), True, False),
    (_Like(dtype=torch.int8), True, False),  # the int8 path's s8 codes
])
def test_routing_takes_only_what_the_kernel_takes(x, grad_mode, wins):
    with torch.set_grad_enabled(grad_mode):
        assert blocks.pool_wins(x) is wins


def test_the_card_route_pools_2x2_windows_alone(monkeypatch):
    """On the card's route ``maxpool2d`` launches K8 for 2x2 windows at
    stride 2 and 1 and raises for any other window or stride."""
    x = _nhwc(1, 8, 6, 6, 0)
    calls = []
    monkeypatch.setattr(blocks, "pool_wins", lambda t: True)
    monkeypatch.setattr(mk, "maxpool2x2", lambda t, stride: calls.append(stride) or t)
    blocks.maxpool2d(x, 2, 2)
    blocks.maxpool2d(x, 2, 1)
    assert calls == [2, 1]
    monkeypatch.undo()
    monkeypatch.setattr(blocks, "pool_wins", lambda t: True)
    for kernel, stride in ((3, 1), (3, 2), (2, 3)):
        with pytest.raises(ValueError):
            blocks.maxpool2d(x, kernel, stride)


def test_grad_requiring_input_stays_differentiable():
    x = _nhwc(1, 8, 7, 7, 3, torch.float32).requires_grad_()
    blocks.maxpool_pyramid(x, (1, 5, 9, 13)).sum().backward()
    # each pool passes its gradient to its maxima: slot 1 gives 1 per cell
    assert x.grad is not None and bool((x.grad >= 1).all())
    y = blocks.maxpool2d(x, 2, 2)
    assert y.requires_grad


def test_s8_codes_stay_on_the_strided_views():
    x = torch.randint(-127, 128, (2, 16, 6, 6), dtype=torch.int8).contiguous(memory_format=CL)
    before = mk.launches
    got = blocks.maxpool2d(x, 2, 2)
    assert got.dtype == torch.int8 and torch.equal(got, blocks.pool_valid(x, 2, 2))
    assert mk.launches == before


def _small(layers, div=16):
    """Every width of a YOLOv4 or YOLOv7 layer list divided by ``div``."""
    out = []
    for item in layers:
        item = list(item)
        if not isinstance(item[0], str):
            item[0] //= div
        elif item[0] in ("elan", "elanh"):
            item[1:] = [n // div for n in item[1:]]
        elif item[0] in ("mp", "sppcspc"):
            item[1] //= div
        elif item[0] == "lateral":
            item[2] //= div
        out.append(tuple(item))
    return tuple(out)


FAMILIES = {
    "yolov4": (YOLOV4_LAYER_CONFIG, "mish", 1),
    "yolov7": (YOLOV7_LAYER_CONFIG, "silu", 6),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plans_on_the_cards_route_give_the_same_heads(family, monkeypatch):
    """A small YOLOv4 and YOLOv7 (widths / 16, 96px, f32) with every pool
    sent down the card's route, K8 emulated: the heads equal the aten
    route's, and K8 is engaged once (SPP) and six times (SPPCSPC, five MP)
    per forward."""
    layers, activation, engaged = FAMILIES[family]
    model_cfg = ModelConfig(num_classes=3, activation=activation, strides=(8, 16, 32),
                            layer_config=_small(layers))
    plan = build_plan(model_cfg)
    model = folded_from_numpy(plan, init_plan(plan, torch.Generator().manual_seed(5)),
                              model_cfg).eval()
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = model(x)
    calls = []

    def pyramid(t, windows):
        calls.append(windows)
        return _k8_pyramid(t, windows)

    def two_by_two(t, stride):
        calls.append((2, stride))
        return _k8_2x2(t, stride)

    monkeypatch.setattr(blocks, "pool_wins", lambda t: True)
    monkeypatch.setattr(mk, "maxpool_pyramid", pyramid)
    monkeypatch.setattr(mk, "maxpool2x2", two_by_two)
    with torch.no_grad():
        got = model(x)
    assert len(calls) == engaged
    assert calls[0 if family == "yolov4" else 3] == ((13, 9, 5, 1) if family == "yolov4"
                                                     else (1, 5, 9, 13))
    assert all(_same_values(a, b) for a, b in zip(got, want))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K8 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("side", [19, 20])
@pytest.mark.parametrize("windows", ORDERS)
def test_card_pyramid_equals_aten(card, windows, side, batch):
    x = _nhwc(batch, 512, side, side, side * 100 + batch, device=card)
    if batch == 2:
        x = _planted(x, side)
    before = mk.launches
    got = mk.maxpool_pyramid(x, windows)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert got.is_contiguous(memory_format=CL)
    assert _same_values(got, mk.maxpool_pyramid_reference(x, windows))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c", [(1, 1, 8), (13, 13, 64), (41, 41, 24), (85, 85, 8),
                                   (7, 7, 1024), (86, 86, 8), (160, 160, 64), (40, 558, 8),
                                   (300, 97, 16)])
def test_card_pyramid_at_the_edges_of_what_it_takes(card, h, w, c):
    """Whole planes up to 85x85, and beyond them planes in bands of rows
    (down to one row a band at 558 pixels a row)."""
    x = _planted(_nhwc(2, c, h, w, h + w + c, device=card), c)
    for windows in ((13, 9, 5, 1), (1, 5, 9, 13), (3, 1)):
        got = mk.maxpool_pyramid(x, windows)
        torch.cuda.synchronize()
        assert _same_values(got, mk.maxpool_pyramid_reference(x, windows)), windows


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("side,c", MP_GEOMETRIES)
def test_card_2x2_equals_aten(card, side, c, batch):
    if batch == 64 and side * side * c > 80 * 80 * 512:
        batch = 16  # the widest planes at a quarter of the cell's batch
    x = _planted(_nhwc(batch, c, side, side, side + c, device=card), c)
    before = mk.launches
    got = mk.maxpool2x2(x)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert _same_values(got, mk.maxpool2x2_reference(x))
    odd = x[:, :, : side - 1, : side - 1].contiguous(memory_format=CL)  # floor sizes
    assert _same_values(mk.maxpool2x2(odd), mk.maxpool2x2_reference(odd))


@pytest.mark.cuda
@pytest.mark.parametrize("side,c", [(13, 512), (13, 8), (26, 256), (1, 8), (7, 24)])
def test_card_2x2_at_stride_1_equals_aten(card, side, c):
    """Tiny's last pool (13x13x512 at 416px), SAME with the pad after."""
    x = _planted(_nhwc(2, c, side, side, side + c, device=card), c)
    before = mk.launches
    got = mk.maxpool2x2(x, 1)
    torch.cuda.synchronize()
    assert mk.launches == before + 1 and got.shape == x.shape
    assert _same_values(got, mk.maxpool2x2_reference(x, 1))
    assert _same_values(blocks.maxpool2d(x, 2, 1), got)


@pytest.mark.cuda
def test_card_wrapper_raises_on_what_the_kernel_does_not_take(card):
    """The wrappers refuse NCHW memory, float32, a width off 8 channels, a
    view off a 16-byte boundary and rows too wide for a band; the router
    launches K8 for each bf16 one all the same, through a fresh copy, and
    gives the aten composition's values in the input's layout."""
    x = _nhwc(2, 64, 20, 20, 0, device=card)
    base = torch.empty(2 * 64 * 20 * 20 + 8, dtype=torch.bfloat16, device=card)
    misaligned = base[4 : 4 + x.numel()].view(2, 20, 20, 64).permute(0, 3, 1, 2)
    misaligned.copy_(x)
    odd = _planted(_nhwc(2, 12, 20, 20, 1, device=card), 1)
    wide = _nhwc(1, 8, 14, 600, 2, device=card)
    cases = [x.contiguous(), odd, misaligned, x[:, 8:48], x.float()]
    for t in cases:
        for call in (lambda t: mk.maxpool_pyramid(t, (5, 1)), mk.maxpool2x2):
            with pytest.raises(ValueError):
                call(t)
    with pytest.raises(ValueError):
        mk.maxpool_pyramid(wide, (13, 1))
    for t in cases[:-1]:
        before = mk.launches
        got = blocks.maxpool_pyramid(t, (13, 9, 5, 1))
        down = blocks.maxpool2d(t, 2, 2)
        torch.cuda.synchronize()
        assert mk.launches == before + 2
        assert _same_values(got, mk.maxpool_pyramid_reference(t, (13, 9, 5, 1)))
        assert _same_values(down, mk.maxpool2x2_reference(t))
        nchw = t.is_contiguous() and not t.is_contiguous(memory_format=CL)
        for y in (got, down):
            assert y.is_contiguous() if nchw else y.is_contiguous(memory_format=CL)
    # float32 keeps aten's pools
    before = mk.launches
    assert _same_values(blocks.maxpool_pyramid(cases[-1], (5, 1)),
                        mk.maxpool_pyramid_reference(cases[-1], (5, 1)))
    assert mk.launches == before


def _card_predictor(family, dev):
    from yolo_for_turbines_tpu_torch.inference import Predictor

    layers, activation, _ = FAMILIES[family]
    model_cfg = ModelConfig(backbone=family, activation=activation,
                            strides=cfg.strides_for(family))
    plan = build_plan(model_cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(7))
    anchors = cfg.YOLOV4_ANCHORS if family == "yolov4" else cfg.YOLOV7_ANCHORS
    return Predictor(folded_from_numpy(plan, tree, model_cfg), device=dev, anchors=anchors,
                     image_size=160)


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_card_launches_per_predict_batch_and_heads(card, family, monkeypatch):
    pred = _card_predictor(family, card)
    x = torch.from_numpy(np.random.default_rng(7).uniform(
        size=(2, 160, 160, 3)).astype(np.float32)).to(card)
    before = mk.launches
    pred.predict_batch(x)
    torch.cuda.synchronize()
    assert mk.launches - before == FAMILIES[family][2]
    with torch.inference_mode():
        heads = pred.model(x)
        monkeypatch.setattr(blocks, "pool_wins", lambda t: False)
        aten = pred.model(x)
    torch.cuda.synchronize()
    assert all(_same_values(a, b) for a, b in zip(heads, aten))


# ---------------------------------------------------------------------------
# The 3x3 stride-2 pad-1 pool (RT-DETR's ResNet-vd stem)
# ---------------------------------------------------------------------------


def _k8_3x3s2(x):
    """K8's 3x3 stride-2 pass: the nine cells of each window, the rows and
    columns outside the plane replaced by the window's centre row and
    column (inside the plane), which leave the max as it is."""
    h, w = x.shape[2], x.shape[3]
    ci, cj = torch.arange(0, h, 2), torch.arange(0, w, 2)
    out = None
    for di in (-1, 0, 1):
        rows = torch.where((ci + di >= 0) & (ci + di < h), ci + di, ci)
        for dj in (-1, 0, 1):
            cols = torch.where((cj + dj >= 0) & (cj + dj < w), cj + dj, cj)
            v = x[:, :, rows][:, :, :, cols]
            out = v if out is None else torch.maximum(out, v)
    return out.contiguous(memory_format=CL)


@pytest.mark.parametrize("c", [8, 64, 12])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (5, 7), (13, 13), (20, 21), (320, 16)])
def test_plain_3x3s2_is_the_aten_pool_and_the_kernels_pass(h, w, c):
    """The plain version is aten's padded pool, and K8's pass (clamped
    rows and columns) gives its values, NaN and -inf planted."""
    x = _planted(_nhwc(2, c, h, w, h * 31 + w + c, torch.float32), c)
    want = F.max_pool2d(x, 3, 2, 1)
    assert tuple(want.shape[2:]) == ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    assert _same_values(mk.maxpool3x3s2(x), want)
    assert _same_values(mk.maxpool3x3s2_reference(x), want)
    assert _same_values(_k8_3x3s2(x), want)


def test_the_stem_pool_pads_with_minus_infinity():
    """Every value negative: a zero pad would show at the plane's edges."""
    x = -1 - torch.rand(1, 8, 6, 6)
    got = blocks.maxpool3x3s2(x)
    assert bool((got < -1).all()) and got[0, 0, 0, 0] == x[0, 0, :2, :2].max()


def test_the_card_route_pools_the_stem_in_k8(monkeypatch):
    """On the card's route ``maxpool3x3s2`` launches K8 through the router
    (any layout and width), inside ``forward.pool``; elsewhere aten's."""
    x = _nhwc(1, 8, 6, 6, 0, torch.float32)
    calls = []
    monkeypatch.setattr(blocks, "pool_wins", lambda t: True)
    monkeypatch.setattr(mk, "apply_maxpool3x3s2", lambda t: calls.append(t.shape) or t)
    blocks.maxpool3x3s2(x)
    assert calls == [x.shape]
    monkeypatch.undo()
    before = mk.launches
    assert torch.equal(blocks.maxpool3x3s2(x), F.max_pool2d(x, 3, 2, 1)) and mk.launches == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profiling.time.perf_counter()
        blocks.maxpool3x3s2(x)
    assert [s.name for s in profiling.spans(since=t0)] == ["forward.pool"]


def test_the_stem_pool_launcher_is_declared_as_the_library_binds_it():
    source = (kernels.CSRC_DIR / "maxpool.cu").read_text()
    found = re.search(r'extern "C" int maxpool3x3s2_launch\(([^)]*)\)', source)
    assert found
    params = [p.strip() for p in found.group(1).split(",")]
    argtypes, _ = kernels._SIGNATURES["maxpool3x3s2_launch"]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        assert ("*" in param) == (argtype is ctypes.c_void_p), param


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("h,w,c", [(320, 320, 64), (7, 9, 8), (1, 1, 16), (40, 40, 256)])
def test_card_3x3s2_equals_aten(card, h, w, c, batch):
    """K8's 3x3 stride-2 pool against aten's by value (the stem's 320x320x64
    at 640px, odd sides), NaN and -inf planted at B = 2: one launch."""
    x = _nhwc(batch, c, h, w, h + w + c + batch, device=card)
    if batch == 2:
        x = _planted(x, h)
    before = mk.launches
    got = mk.maxpool3x3s2(x)
    torch.cuda.synchronize()
    assert mk.launches == before + 1
    assert got.is_contiguous(memory_format=CL)
    assert _same_values(got, mk.maxpool3x3s2_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 12, 64])
@pytest.mark.parametrize("layout", ["nchw", "misaligned"])
def test_card_3x3s2_router_takes_any_layout_and_width(card, c, layout):
    x = _planted(_nhwc(2, c, 11, 10, c, device=card), 5)
    if layout == "nchw":
        x = x.contiguous()
    else:
        base = torch.empty(x.numel() + 8, dtype=x.dtype, device=card)
        x = base[1 : x.numel() + 1].view(2, 11, 10, c).permute(0, 3, 1, 2).copy_(x)
    got = mk.apply_maxpool3x3s2(x)
    assert _same_values(got, mk.maxpool3x3s2_reference(x))
    assert got.is_contiguous() == (layout == "nchw")
