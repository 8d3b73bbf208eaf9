"""Torch port: an int8 conv's product (kernel K7, ``csrc/conv_int8.cu``) and
the routing of ``models/quantize.py::_conv_i8`` to it.

On the CPU: the router keeps CPU tensors, ``portable`` and sharded rows on
the plain version (the im2col copy and ``int_mm``); the card's route
(``apply_int8_conv``, called directly on CPU tensors) sends every product
to the wrapper with the arguments K7 takes, which on the CPU gives the
plain version's sums: the geometries K7 takes as they are (a strided or
misaligned input copied first), every other one as a 1x1 product over its
im2col matrix (the stem's over a block-diagonal weight), a Cout off a
multiple of 16 padded and cut. Whole forwards on that route give the
plain heads. The span ``int8.conv`` opens once per product, 55 per
Darknet-53 forward outside K4's stage, and never nests with
``int8.epilogue``; ``pack_int8`` makes each K-major weight copy once,
whatever ``kernel_operands`` says; the wrapper refuses what the kernel
does not take; ``int8.conv_roofline`` counts 46.28 G operations per image
on ``yolov3-coco416``.

On the card (marker ``cuda``; skipped without one): K7's i32 sums equal the
plain version's bit for bit at every product geometry of Darknet-53,
CSPDarknet-53 and tiny, at B = 1, 2 and 128, on sides 13, 26 and 52, on
misaligned and strided views and on both branches of a split conv, and a
Cout of 8 and 24 is padded and cut; the int8 Darknet-53
predictor reads the same trunk codes and heads with K7 as without, and
launches K7 55 times, K6 53 and K4 8 per ``predict_batch``. Run them on a
card with ``python -m pytest tests/test_torch_int8_conv.py -m cuda
--noconftest``.
"""

import importlib.util
import json
import time
import types

import numpy as np
import pytest
import torch

from helpers import MINI_CSP_LAYERS, MINI_LAYERS
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import quantize as tq
from yolo_for_turbines_tpu_torch.models.cspdarknet import PlanCSP, conv_shapes
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    PlanConv,
    PlanResidual,
    PlanUpsample,
    build_plan,
    init_plan,
)
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import int8_conv_kernel as ck
from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk
from yolo_for_turbines_tpu_torch.utils import profiling

# int8 conv products of the full-width Darknet-53 outside K4's 26x26x512
# stage: 53 convs, two of them split at a concat into two products each
DARKNET53_PRODUCTS = 55
K4_STAGE_PRODUCTS = 16


def products(plan):
    """(Cin, Cout, kernel, stride) of every int8 conv product of one
    layer-path forward of ``plan``, in order; a conv after an upsample is
    two products (the upsampled trunk, then the route)."""
    out, up = [], None
    for entry in plan:
        if isinstance(entry, PlanConv):
            parts = [entry.in_ch] if up is None else [up, entry.in_ch - up]
            out += [(c, entry.out_ch, entry.kernel, entry.stride) for c in parts]
        elif isinstance(entry, PlanResidual):
            c = entry.channels
            out += [(c, c // 2, 1, 1), (c // 2, c, 3, 1)] * entry.num_blocks
        elif isinstance(entry, PlanCSP):
            s = conv_shapes(entry)
            blocks = [(*s["conv1"], 1), (*s["conv2"], 1)] * entry.num_blocks
            fuse = (s["fuse"][0] // 2, s["fuse"][1], 1, 1)
            out += [(*s["split1"], 1), (*s["split2"], 1), *blocks, (*s["transition"], 1),
                    fuse, fuse]
        up = entry.in_ch if isinstance(entry, PlanUpsample) else None
    return out


def _model(layers=None, backbone="darknet53", size=64, classes=2):
    cfg = ModelConfig(num_classes=classes, layer_config=layers, backbone=backbone)
    plan = build_plan(cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, size, size, 3))
                         .astype(np.float32))
    return plan, tq.quantize_folded(plan, tree, x, cfg.activation), x


@pytest.fixture(scope="module")
def darknet53():
    """The full Darknet-53 plan with 2 classes at 64px, quantized."""
    return _model()


def _forward(plan, qp, x, **kw):
    return tq.apply_inference_int8(plan, qp, x, raw_heads=True, compute_dtype=torch.float32,
                                   **kw)


def _spy(monkeypatch):
    """The wrapper spied on: each call's (Cin, weight shape, kernel,
    stride, pad), and that its input is contiguous and 16-byte aligned. On
    the CPU the wrapper computes the plain version's sums."""
    calls = []
    wrapper = ck.int8_conv

    def spy(xq, wk, kernel, stride, pad):
        assert xq.is_contiguous() and xq.data_ptr() % 16 == 0
        calls.append((xq.shape[-1], tuple(wk.shape), kernel, stride, pad))
        return wrapper(xq, wk, kernel, stride, pad)

    monkeypatch.setattr(ck, "int8_conv", spy)
    return calls


@pytest.fixture
def on_card(monkeypatch):
    """``_conv_i8`` as it runs on the card, on CPU tensors: every product
    outside ``portable`` through ``apply_int8_conv`` inside its span, the
    wrapper spied on (``_spy``)."""
    calls = _spy(monkeypatch)
    plain = tq._conv_i8

    def card(xq, wmat, kernel, stride, pad, rows=None, wk=None, portable=False):
        if portable:
            return plain(xq, wmat, kernel, stride, pad, rows, wk, portable)
        with profiling.span("int8.conv"):
            return ck.apply_int8_conv(xq, wmat, wk, kernel, stride, pad)

    monkeypatch.setattr(tq, "_conv_i8", card)
    return calls


ROUTES = [
    # Darknet-53's geometries
    ((32, 288, 3, 2, 1), "direct"),
    ((64, 64, 1, 1, 0), "direct"),
    ((32, 288, 3, 1, 1), "direct"),
    ((1024, 1024, 1, 1, 0), "direct"),
    ((512, 4608, 3, 1, 1), "direct"),
    ((768, 768, 1, 1, 0), "direct"),
    # the stem: 27 columns padded to 32
    ((3, 32, 3, 1, 1), "im2col"),
    # tiny's 16-channel 3x3: 144 columns, read as 160
    ((16, 144, 3, 1, 1), "im2col"),
    # geometries K7 does not take from the NHWC input
    ((64, 1600, 5, 1, 2), "im2col"),
    ((64, 576, 3, 3, 1), "im2col"),
    ((64, 576, 3, 1, 0), "im2col"),
    ((48, 432, 3, 1, 1), "im2col"),
    ((16, 16, 1, 1, 0), "im2col"),
]


@pytest.mark.parametrize("geometry,want", ROUTES)
def test_route_of_each_geometry(geometry, want):
    assert ck.route(*geometry) == want


def _codes(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


def _router_case(case):
    """A conv's codes, ``_wmat`` and K-major weights, and its geometry."""
    kernel, stride, cin, cout, pad = {
        "cin 3": (3, 1, 3, 32, 1), "cin 3, odd positions": (3, 1, 3, 32, 1),
        "cin 16": (3, 1, 16, 32, 1), "kernel 1 stride 2": (1, 2, 64, 32, 0),
        "kernel 5": (5, 1, 64, 32, 2), "stride 3": (3, 3, 64, 32, 1), "pad 0": (3, 1, 64, 32, 0),
        "cout 8": (3, 1, 64, 8, 1), "cout 24, cin 3": (3, 1, 3, 24, 1),
    }.get(case, (3, 1, 64, 32, 1))
    xq = _codes((2, 9 if case == "cin 3, odd positions" else 8, 11, cin), 1)
    wmat = tq._wmat(_codes((kernel, kernel, cin, cout), 2))
    return xq, wmat, ck.kmajor(wmat, cin, kernel), (kernel, stride, pad)


@pytest.mark.parametrize("case", ["cpu", "portable", "rows"])
def test_router_keeps_the_plain_version(monkeypatch, case):
    """``_conv_i8`` keeps CPU tensors, ``portable`` and sharded rows on the
    plain version: the wrapper is never called."""
    calls = _spy(monkeypatch)
    monkeypatch.setattr(tq, "apply_int8_conv", lambda *args: calls.append(args))
    xq, wmat, wk, geom = _router_case(case)
    kw = {"wk": wk, "portable": case == "portable"}
    if case == "rows":
        # a row shard whose halo rows are the image's edges: code 0
        kw["rows"] = types.SimpleNamespace(sharded=True,
                                           layout=types.SimpleNamespace(space_group=None))
        monkeypatch.setattr("yolo_for_turbines_tpu_torch.parallel.spatial.halo",
                            lambda t, top, bottom, _, group: torch.nn.functional.pad(
                                t, (0, 0, top, bottom)))
    got = tq._conv_i8(xq, wmat, *geom, **kw)
    assert got.dtype == torch.int32
    assert torch.equal(got, ck.int8_conv_reference(xq, wmat, *geom))
    assert calls == []


CARD_ROUTES = {
    "kernel 3": [(64, (32, 576), 3, 1, 1)],
    "kernel 1 stride 2": [(64, (32, 64), 1, 2, 0)],
    # copied into a fresh tensor first
    "misaligned": [(64, (32, 576), 3, 1, 1)],
    "strided": [(64, (32, 576), 3, 1, 1)],
    # the stem's 32 columns, four positions to a 128-byte row
    "cin 3": [(128, (128, 128), 1, 1, 0)],
    # 2 * 9 * 11 positions: one to a row, against the first block
    "cin 3, odd positions": [(32, (32, 32), 1, 1, 0)],
    # 144 columns read as 160, one position to a row
    "cin 16": [(160, (32, 160), 1, 1, 0)],
    # geometries K7 does not take from the NHWC input: their im2col matrix
    "kernel 5": [(1600, (32, 1600), 1, 1, 0)],
    "stride 3": [(576, (32, 576), 1, 1, 0)],
    "pad 0": [(576, (32, 576), 1, 1, 0)],
    # Cout padded to 16 with zero weights, then cut
    "cout 8": [(64, (16, 576), 3, 1, 1)],
    "cout 24, cin 3": [(128, (128, 128), 1, 1, 0)],
}


@pytest.mark.parametrize("case", list(CARD_ROUTES))
def test_card_route_launches_the_kernel_for_every_product(monkeypatch, case):
    """``apply_int8_conv`` (``_conv_i8``'s route on the card), on CPU
    tensors: every product reaches the wrapper once, with the arguments K7
    takes, and the sums are the plain version's."""
    calls = _spy(monkeypatch)
    xq, wmat, wk, geom = _router_case(case)
    if case == "misaligned":
        base = torch.empty(xq.numel() + 16, dtype=torch.int8)
        xq = base[1:xq.numel() + 1].view(xq.shape).copy_(xq)
    if case == "strided":
        xq = xq.transpose(1, 2).contiguous().transpose(1, 2)
    got = ck.apply_int8_conv(xq, wmat, wk, *geom)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, ck.int8_conv_reference(xq.contiguous(), wmat, *geom))
    assert calls == CARD_ROUTES[case]


def test_card_route_needs_the_kmajor_weights():
    xq, wmat, _, geom = _router_case("kernel 3")
    with pytest.raises(ValueError, match="K-major weights"):
        ck.apply_int8_conv(xq, wmat, None, *geom)


@pytest.mark.parametrize("family,layers", [("darknet53", MINI_LAYERS), ("csp", MINI_CSP_LAYERS)])
def test_routed_forward_gives_the_plain_heads(on_card, family, layers):
    """A whole int8 forward with every product sent to the wrapper (the
    mini models' Couts of 4 and 8 padded to 16) gives the plain forward's
    heads bit for bit."""
    plan, qp, x = _model(layers)
    plain = _forward(plan, qp, x, portable=True)
    assert on_card == []
    routed = _forward(plan, qp, x)
    assert len(on_card) == len(products(plan))
    assert all(torch.equal(a, b) for a, b in zip(routed, plain))


def test_full_darknet53_routes_all_55_products(on_card, darknet53, monkeypatch):
    """Darknet-53 with K4 taking its stage (its plain version on the CPU):
    the 53 other convs, two of them split, are 55 calls of the wrapper,
    the stem's as a 1x1 over its im2col rows; the heads are the plain
    forward's."""
    plan, qp, x = darknet53
    monkeypatch.setattr(tq, "apply_residual_stage_int8_fused",
                        lambda ops, xq, act, kmajor=None: rk.fused_residual_stage_int8(
                            xq, *ops, activation=act, kmajor=kmajor))
    plain = _forward(plan, qp, x, portable=True)
    routed = _forward(plan, qp, x)
    assert len(on_card) == DARKNET53_PRODUCTS
    assert on_card[0] == (128, (128, 128), 1, 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(routed, plain))


def _spans(plan, qp, x, **kw):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        _forward(plan, qp, x, **kw)
    return profiling.spans(since=t0)


@pytest.mark.parametrize("family,portable", [("darknet53", False), ("darknet53", True),
                                             ("csp", False), ("full", False)])
def test_span_round_every_product(family, portable, darknet53):
    """``int8.conv`` opens once per product and closes before its
    epilogue's span opens: the two never nest and never overlap. On the CPU
    the full Darknet-53's 26x26x512 stage takes the layer path at 64px (its
    side is 4, outside K4's geometry): 55 + 16 products."""
    if family == "full":
        plan, qp, x = darknet53
    else:
        plan, qp, x = _model(MINI_LAYERS if family == "darknet53" else MINI_CSP_LAYERS)
    spans = _spans(plan, qp, x, portable=portable)
    convs = [s for s in spans if s.name == "int8.conv"]
    epilogues = [s for s in spans if s.name == "int8.epilogue"]
    assert len(convs) == len(products(plan))
    if family == "full":
        assert len(convs) == DARKNET53_PRODUCTS + K4_STAGE_PRODUCTS
    by_id = {s.id: s.name for s in spans}
    assert not any(by_id.get(s.parent) in ("int8.conv", "int8.epilogue") for s in spans)
    timeline = sorted([(s.t0, s.t1, s.name) for s in convs + epilogues])
    assert all(a[1] <= b[0] for a, b in zip(timeline, timeline[1:]))


@pytest.mark.parametrize("kernel_operands", [True, False])
def test_pack_makes_each_kmajor_copy_once(darknet53, monkeypatch, kernel_operands):
    """``pack_int8`` makes the K-major copy of every layer-path weight (the
    stem's block-diagonal), ``_wmat`` transposed, with or without K4's
    operands; a forward makes none; a portable pack has none."""
    plan, qp, x = darknet53
    made = []
    kmajor = tq.kmajor

    def counting(wmat, cin, kernel):
        made.append(wmat.shape)
        return kmajor(wmat, cin, kernel)

    monkeypatch.setattr(tq, "kmajor", counting)
    packed = tq.pack_int8(plan, qp, torch.float32, kernel_operands=kernel_operands)
    assert len(made) == len(products(plan))
    pairs = _weight_pairs(packed)
    assert len(pairs) == len(made)
    stem_w, stem_k = pairs[0]
    assert stem_w.shape == (32, 32) and torch.equal(stem_k, torch.block_diag(*[stem_w] * 4).t())
    for w, k in pairs[1:]:
        assert k.is_contiguous() and torch.equal(k, w.t())
    made.clear()
    _forward(plan, qp, x, packed=packed)
    assert made == []
    # the portable forward's own pack (the exported program traces it)
    portable = _weight_pairs(tq.pack_int8(plan, qp, torch.float32, portable=True))
    assert made == [] and len(portable) == len(pairs)
    assert all(k is None for _, k in portable)


def _weight_pairs(packed):
    """(``_wmat`` weight, its K-major copy) of every conv of a packed plan."""
    pairs = []
    for q in packed[1:]:
        convs = [q] + q.get("blocks", []) + [q[k] for k in ("split1", "split2", "transition",
                                                            "fuse") if k in q]
        pairs += [(d[w], d[w + "k"]) for d in convs for w in ("w", "wa", "wb", "w1", "w2")
                  if w + "k" in d]
    return pairs


def _unfolded(xq, kernel, stride, pad, kp):
    """The im2col matrix by hand: each position's (kh, kw, Cin) window of
    the zero-padded input, then zero columns up to ``kp``."""
    xp = torch.nn.functional.pad(xq, (0, 0, pad, pad, pad, pad))
    win = xp.unfold(1, kernel, stride).unfold(2, kernel, stride)  # (B, Ho, Wo, C, kh, kw)
    rows = win.permute(0, 1, 2, 4, 5, 3).reshape(*win.shape[:3], -1)
    return torch.nn.functional.pad(rows, (0, kp - rows.shape[-1]))


@pytest.mark.parametrize("b,h,w,c,kernel,stride,kp", [
    (2, 9, 10, 3, 3, 1, 32), (2, 9, 11, 3, 3, 2, 32), (1, 5, 5, 32, 3, 1, 288),
    (2, 8, 8, 16, 3, 2, 144), (1, 6, 7, 4, 1, 1, 32)])
def test_im2col_gives_each_window(b, h, w, c, kernel, stride, kp):
    xq = _codes((b, h, w, c), 3)
    assert torch.equal(ck.im2col(xq, kernel, stride, kernel // 2, kp),
                       _unfolded(xq, kernel, stride, kernel // 2, kp))


def _wrong(case):
    xq, wk = _codes((2, 5, 5, 64), 4), _codes((32, 576), 5)
    args = dict(xq=xq, wk=wk, kernel=3, stride=1, pad=1)
    base = torch.empty(xq.numel() + 16, dtype=torch.int8)
    changes = {
        "x dtype": dict(xq=xq.int()),
        "x not 4-D": dict(xq=xq[0]),
        "x strided": dict(xq=xq.transpose(1, 2)),
        "x misaligned": dict(xq=base[1:xq.numel() + 1].view(xq.shape)),
        "weights dtype": dict(wk=wk.float()),
        "weights shape": dict(wk=wk[:, :288]),
        "weights strided": dict(wk=torch.stack([wk, wk], 1)[:, 0]),
        "weights device": dict(wk=wk.to("meta")),
        "kernel 5": dict(wk=_codes((32, 1600), 5), kernel=5, pad=2),
        "stride 3": dict(stride=3),
        "pad 0": dict(pad=0),
        "cin 16": dict(xq=_codes((2, 5, 5, 16), 4), wk=_codes((32, 144), 5)),
        "cout 8": dict(wk=_codes((8, 576), 5)),
    }
    args.update(changes[case])
    return args


WRONG = ("x dtype", "x not 4-D", "x strided", "x misaligned", "weights dtype", "weights shape",
         "weights strided", "weights device", "kernel 5", "stride 3", "pad 0", "cin 16",
         "cout 8")


@pytest.mark.parametrize("case", WRONG)
def test_wrapper_rejects_bad_input(case):
    with pytest.raises(ValueError, match="the kernel takes" if case in (
            "kernel 5", "stride 3", "pad 0", "cin 16", "cout 8") else "must be"):
        ck.int8_conv(**_wrong(case))


def test_wrapper_has_no_fallback_off_the_cpu():
    xq, wk = _codes((1, 4, 4, 32), 6).to("meta"), _codes((16, 32), 7).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.int8_conv(xq, wk, 1, 1, 0)


def test_launcher_is_declared_where_the_library_binds_it():
    source = (kernels.CSRC_DIR / "conv_int8.cu").read_text()
    assert ('extern "C" int int8_conv_launch(const void* x, const void* w, void* out, int batch, '
            'int H, int W,') in source
    argtypes, _ = kernels._SIGNATURES["int8_conv_launch"]
    assert len(argtypes) == 11


def _metric():
    path = kernels.PACKAGE_DIR.parent / "perfbench" / "metrics" / "int8.conv_roofline.py"
    spec = importlib.util.spec_from_file_location("int8_conv_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_roofline_counts_the_products_outside_the_heads_and_k4():
    root = kernels.PACKAGE_DIR.parent / "perfbench"
    cfg = json.loads((root / "configs" / "yolov3-coco416.json").read_text())
    from perfbench import roofline

    m = _metric()
    ops = m.conv_ops(cfg, 416, 1)
    assert round(ops / 1e9, 2) == 46.28
    assert abs(m.conv_ops(cfg, 416, 128) / roofline.PEAKS["int8_ops"] * 1e3 - 2.994) < 1e-3
    # the whole forward less the heads' convs and K4's 16: 65.86 G in all
    table = roofline.conv_table(cfg, 416)
    heads = sum(c["flops"] for c in table if c["path"][-1] in ("conv1", "conv2")
                and len(c["path"]) == 2)
    stage = sum(c["flops"] for c in roofline.stage_convs(cfg, 416, 512, 26))
    assert abs(roofline.forward_flops(cfg, 416) - heads - stage - ops) < 1.0


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 runs only there")
    return torch.device("cuda", 0)


def _geometries():
    """(Cin, Cout, kernel, stride) of every product of Darknet-53,
    CSPDarknet-53 and tiny at full width (80 classes)."""
    out = set()
    for backbone in ("darknet53", "cspdarknet53", "yolov3_tiny"):
        out |= set(products(build_plan(ModelConfig(backbone=backbone))))
    return sorted(out)


def _card_case(card, b, side, cin, cout, kernel, stride, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    xq = torch.randint(-127, 128, (b, side, side, cin), generator=g, device=card,
                       dtype=torch.int8)
    wmat = tq._wmat(torch.randint(-127, 128, (kernel, kernel, cin, cout), generator=g,
                                  device=card, dtype=torch.int8))
    return xq, wmat, ck.kmajor(wmat, cin, kernel)


def _plain_on_the_card(xq, wmat, kernel, stride):
    """The plain version's sums; cuBLAS's int8 product refuses some small
    products (a few hundred to a few thousand rows of 32 columns), so below
    B = 128 they are summed on the CPU (exact either way)."""
    if xq.shape[0] < 128:
        return ck.int8_conv_reference(xq.cpu(), wmat.cpu(), kernel, stride,
                                      kernel // 2).to(xq.device)
    return ck.int8_conv_reference(xq, wmat, kernel, stride, kernel // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [13, 26, 52])
@pytest.mark.parametrize("batch", [1, 2, 128])
def test_kernel_equals_the_plain_version(card, batch, side):
    for i, (cin, cout, kernel, stride) in enumerate(_geometries()):
        xq, wmat, wk = _card_case(card, batch, side, cin, cout, kernel, stride, i)
        before = ck.launches
        got = tq._conv_i8(xq, wmat, kernel, stride, kernel // 2, wk=wk)
        assert ck.launches - before == 1
        want = _plain_on_the_card(xq, wmat, kernel, stride)
        assert int((got != want).sum()) == 0, (batch, side, cin, cout, kernel, stride)


@pytest.mark.cuda
def test_kernel_on_misaligned_views_and_split_branches(card):
    xq, wmat, wk = _card_case(card, 2, 26, 256, 512, 3, 1, 7)
    want = _plain_on_the_card(xq, wmat, 3, 1)
    base = torch.empty(xq.numel() + 16, dtype=torch.int8, device=card)
    misaligned = base[1:xq.numel() + 1].view(xq.shape).copy_(xq)
    strided = xq.transpose(1, 2).contiguous().transpose(1, 2)
    before = ck.launches
    # a misaligned or strided view is copied, then K7 runs on the copy
    for view in (misaligned, strided):
        assert torch.equal(tq._conv_i8(view, wmat, 3, 1, 1, wk=wk), want)
    assert ck.launches == before + 2
    before = ck.launches
    # both branches of a split conv (26x26: the upsampled 256 channels and
    # the 512-channel route) launch K7 once each
    xa, wa, wak = _card_case(card, 2, 26, 256, 256, 1, 1, 8)
    xb, wb, wbk = _card_case(card, 2, 26, 512, 256, 1, 1, 9)
    for x, w, k in ((xa, wa, wak), (xb, wb, wbk)):
        assert torch.equal(tq._conv_i8(x, w, 1, 1, 0, wk=k), ck.int8_conv_reference(x, w, 1, 1, 0))
    assert ck.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(64, 8), (3, 24)])
def test_kernel_pads_and_cuts_an_odd_cout(card, cin, cout):
    """A Cout off a multiple of 16 runs on K7 with zero weights up to one;
    the extra channels are cut."""
    xq, wmat, wk = _card_case(card, 2, 26, cin, cout, 3, 1, 10)
    before = ck.launches
    got = tq._conv_i8(xq, wmat, 3, 1, 1, wk=wk)
    assert ck.launches == before + 1
    assert got.shape == (2, 26, 26, cout) and got.is_contiguous()
    assert torch.equal(got, _plain_on_the_card(xq, wmat, 3, 1))


@pytest.fixture(scope="module")
def int8_darknet53():
    """The 80-class Darknet-53 at 416px from seeded weights, quantized on two
    seeded images, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 runs only there")
    from yolo_for_turbines_tpu_torch.inference import Predictor

    cfg = ModelConfig()
    plan = build_plan(cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(0))
    pred = Predictor.from_folded(cfg, tree, device=torch.device("cuda", 0))
    rng = np.random.default_rng(0)
    pred.quantize(rng.uniform(size=(2, 416, 416, 3)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(size=(2, 416, 416, 3)).astype(np.float32)).cuda()
    return plan, pred, x


@pytest.mark.cuda
def test_predictor_reads_the_same_codes_with_k7(int8_darknet53, monkeypatch):
    plan, pred, x = int8_darknet53

    def forward():
        trunk = []
        heads = tq.apply_inference_int8(plan, pred._qparams, x, activation="leaky_relu",
                                        raw_heads=True, compute_dtype=pred.compute_dtype,
                                        packed=pred._packed, head_inputs=trunk)
        torch.cuda.synchronize()
        return trunk, heads

    before = ck.launches
    trunk, heads = forward()
    assert ck.launches - before == DARKNET53_PRODUCTS
    # the same forward with the plain version in K7's place (K4 and K6 kept)
    monkeypatch.setattr(tq, "apply_int8_conv",
                        lambda xq, wmat, wk, kernel, stride, pad: ck.int8_conv_reference(
                            xq, wmat, kernel, stride, pad))
    trunk_plain, heads_plain = forward()
    assert ck.launches - before == DARKNET53_PRODUCTS
    assert len(trunk) == len(trunk_plain) == 3
    for ta, tb in zip(trunk, trunk_plain):
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
    assert all(torch.equal(a, b) for a, b in zip(heads, heads_plain))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_launches_per_predict_batch(int8_darknet53, batch):
    from yolo_for_turbines_tpu_torch.ops.kernels import int8_epilogue_kernel as ik

    _, pred, x = int8_darknet53
    before = (ck.launches, ik.launches, rk.launches)
    pred.predict_batch(x[:batch])
    torch.cuda.synchronize()
    after = (ck.launches, ik.launches, rk.launches)
    assert [a - b for a, b in zip(after, before)] == [DARKNET53_PRODUCTS, 53, 8]
