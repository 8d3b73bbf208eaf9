"""Torch port: a folded conv's epilogue (kernel K5, ``csrc/epilogue.cu``) and
the routing of ``FoldedConv`` to it.

The plain version computes ``skip + act(y + bias)`` in f32 and rounds once:
against the same function in float64, rounded once, it is off by at most
half a bf16 step of the result plus the f32 arithmetic's own error, where
the composition it replaces (three bf16 roundings) is off by up to three
half steps. The routing leaves every input K5 does not take (CPU, float32,
NCHW memory, SP) on the composition of separate ops, bit for bit as before.
The kernel itself runs only on the card: ``chip_smoke.py`` phase k5 holds it
to the plain version there, and so do the tests marked ``cuda`` here
(SiLU, YOLOv7's activation), which skip without a card.
"""

import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import blocks as tblocks
from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
from yolo_for_turbines_tpu_torch.models.cspdarknet import CSPStage, PlanCSP
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    PlanResidual,
    ResidualStage,
    build_plan,
    init_plan,
)
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import epilogue_kernel as ek
from yolo_for_turbines_tpu_torch.parallel.spatial import Layout, create_spatial_mesh

from helpers import MINI_LAYERS, concat_routes

CL = torch.channels_last
F64_ACTS = {
    "identity": lambda t: t,
    "leaky_relu": lambda t: F.leaky_relu(t, 0.1),
    "mish": F.mish,
    "silu": lambda t: t * torch.sigmoid(t),
}


def _bf16(shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(torch.bfloat16)


def _nhwc(shape, seed, dtype=torch.bfloat16):
    return _bf16(shape, seed).to(dtype).contiguous(memory_format=CL)


def _half_step(t: torch.Tensor) -> torch.Tensor:
    """Half the spacing of bf16 numbers at |t| (8 significant bits)."""
    _, e = torch.frexp(t.double())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float64), e.double() - 9)


@pytest.mark.parametrize("c", [64, 21, 255])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("activation", ["identity", "leaky_relu", "mish", "silu"])
def test_plain_rounds_once(activation, with_skip, c):
    y = _nhwc((2, c, 3, 5), 1)
    bias = _bf16((c,), 2, 0.5)
    skip = _nhwc((2, c, 3, 5), 3) if with_skip else None
    t = y.double() + bias.double()[:, None, None]
    want = F64_ACTS[activation](t) + (skip.double() if with_skip else 0.0)
    before = ek.launches
    out = y.clone(memory_format=CL)
    got = ek.conv_epilogue(out, bias, activation, skip)
    # the CPU wrapper takes the plain version, in place
    assert got is out and ek.launches == before
    assert torch.equal(got, ek.conv_epilogue_reference(y, bias, activation, skip))
    assert got.dtype == torch.bfloat16 and got.is_contiguous(memory_format=CL)
    # f32 arithmetic before the one rounding: a few f32 steps of the terms
    f32_err = 2.0 ** -20 * (t.abs() + want.abs() + (skip.double().abs() if with_skip else 0.0))
    err = (got.double() - want).abs()
    bound = _half_step(torch.maximum(want.abs(), got.double().abs())) + f32_err
    assert bool((err <= bound).all()), float((err - bound).max())
    # three roundings (the composition) exceed that on some elements
    comp = F64_ACTS[activation]((y + bias[:, None, None]).float()).to(torch.bfloat16)
    if with_skip:
        comp = skip + comp
    if activation != "identity" or with_skip:
        assert bool(((comp.double() - want).abs() > bound).any())


class _Like:
    """What ``epilogue_wins`` reads of a tensor."""

    def __init__(self, cuda=True, dtype=torch.bfloat16, nhwc=True):
        self.is_cuda, self.dtype, self._nhwc = cuda, dtype, nhwc

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return self._nhwc if memory_format == CL else not self._nhwc


@pytest.mark.parametrize("x,act,skip,wins", [
    (_Like(), tblocks.leaky_relu, None, True),
    (_Like(), tblocks.mish, _Like(), True),
    (_Like(), None, None, True),  # a head's last 1x1: identity
    (_Like(cuda=False), tblocks.leaky_relu, None, False),
    (_Like(dtype=torch.float32), tblocks.leaky_relu, None, False),
    (_Like(dtype=torch.float16), tblocks.leaky_relu, None, False),
    (_Like(nhwc=False), tblocks.leaky_relu, None, False),
    (_Like(), tblocks.leaky_relu, _Like(nhwc=False), False),
    (_Like(), tblocks.leaky_relu, _Like(dtype=torch.float32), False),
    (_Like(), tblocks.leaky_relu, _Like(cuda=False), False),
    (_Like(), torch.relu, None, False),  # an activation K5 does not know
])
def test_routing_takes_only_what_the_kernel_takes(x, act, skip, wins):
    assert tblocks.epilogue_wins(x, act, skip) is wins


def _folded_conv(cin, cout, kernel, stride, seed, dtype):
    conv = tblocks.FoldedConv(cin, cout, kernel, stride)
    with torch.no_grad():
        conv.weight.copy_(_bf16(conv.weight.shape, seed, 0.3).float())
        conv.bias.copy_(_bf16((cout,), seed + 1, 0.5).float())
    return conv.to(dtype=dtype, memory_format=CL)


CASES = [(act, with_skip) for act in (None, tblocks.leaky_relu, tblocks.mish, tblocks.silu)
         for with_skip in (False, True)]


@pytest.mark.parametrize("memory_format", [CL, torch.contiguous_format])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,with_skip", CASES)
def test_folded_conv_keeps_the_composition_off_the_card(act, with_skip, dtype, memory_format):
    conv = _folded_conv(8, 16, 3, 1, 4, dtype)
    x = _nhwc((2, 8, 6, 5), 5, dtype).contiguous(memory_format=memory_format)
    skip = _nhwc((2, 16, 6, 5), 6, dtype) if with_skip else None
    before = ek.launches
    got = conv(x, act, skip=skip)
    want = F.conv2d(x, conv.weight, conv.bias, padding=1)
    want = act(want) if act is not None else want
    want = skip + want if with_skip else want
    assert ek.launches == before
    assert torch.equal(got, want)


def _stage_weights(stage, seed, dtype):
    with torch.no_grad():
        for i, p in enumerate(stage.parameters()):
            p.copy_(_bf16(p.shape, seed + i, 0.2).float())
    return stage.to(dtype=dtype, memory_format=CL)


@pytest.mark.parametrize("use_residual", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_residual_stage_layer_path_bit_for_bit(dtype, use_residual):
    entry = PlanResidual(channels=16, num_blocks=3, use_residual=use_residual)
    stage = _stage_weights(ResidualStage(entry), 10, dtype)
    x = _nhwc((2, 16, 7, 6), 11, dtype)
    act = tblocks.leaky_relu
    before = ek.launches
    got = stage(x, act, "leaky_relu", fuse=False)
    want = x
    for blk in stage.blocks:  # the layer path before K5: x + y after each block
        c1, c2 = blk["conv1"], blk["conv2"]
        y = act(F.conv2d(want, c1.weight, c1.bias))
        y = act(F.conv2d(y, c2.weight, c2.bias, padding=1))
        want = want + y if use_residual else y
    assert ek.launches == before
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csp_stage_bit_for_bit(dtype):
    stage = _stage_weights(CSPStage(PlanCSP(channels=16, num_blocks=2)), 20, dtype)
    x = _nhwc((2, 16, 6, 6), 21, dtype)
    act = tblocks.mish
    before = ek.launches
    got = stage(x, act)

    def conv(c, t):
        return act(F.conv2d(t, c.weight, c.bias, padding=c.padding))

    shortcut = conv(stage.split1, x)
    y = conv(stage.split2, x)
    for blk in stage.blocks:
        y = y + conv(blk["conv2"], conv(blk["conv1"], y))
    want = conv(stage.fuse, torch.cat([conv(stage.transition, y), shortcut], dim=1))
    assert ek.launches == before
    assert torch.equal(got, want)


@pytest.fixture
def routed(monkeypatch):
    """Every folded conv routed as on the card, the epilogue's calls
    recorded: on the CPU the wrapper runs the plain version."""
    calls = []

    def spy(y, bias, activation, skip):
        calls.append((activation, skip is not None))
        return ek.conv_epilogue(y, bias, activation, skip)

    monkeypatch.setattr(tblocks, "epilogue_wins", lambda x, act, skip=None: True)
    monkeypatch.setattr(tblocks, "conv_epilogue", spy)
    return calls


@pytest.mark.parametrize("act,with_skip", CASES)
def test_routed_conv_is_a_bias_free_conv_and_the_epilogue(routed, act, with_skip):
    conv = _folded_conv(8, 21, 1, 1, 30, torch.bfloat16)
    x = _nhwc((2, 8, 5, 4), 31)
    skip = _nhwc((2, 21, 5, 4), 32) if with_skip else None
    got = conv(x, act, skip=skip)
    name = tblocks.EPILOGUE_ACTIVATIONS[act]
    want = ek.conv_epilogue_reference(F.conv2d(x, conv.weight), conv.bias, name, skip)
    assert routed == [(name, with_skip)]
    assert torch.equal(got, want)


def test_routed_residual_stage_passes_each_block_input_as_skip(routed):
    stage = _stage_weights(ResidualStage(PlanResidual(channels=16, num_blocks=2)), 40,
                           torch.bfloat16)
    x = _nhwc((1, 16, 5, 5), 41)
    got = stage(x, tblocks.leaky_relu, "leaky_relu", fuse=False)
    assert routed == [("leaky_relu", False), ("leaky_relu", True)] * 2
    want = x
    for blk in stage.blocks:
        c1, c2 = blk["conv1"], blk["conv2"]
        y = ek.conv_epilogue_reference(F.conv2d(want, c1.weight), c1.bias, "leaky_relu")
        want = ek.conv_epilogue_reference(F.conv2d(y, c2.weight, padding=1), c2.bias,
                                          "leaky_relu", want)
    assert torch.equal(got, want)


def _mini_model(dtype):
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    plan = build_plan(cfg)
    model = folded_from_numpy(plan, init_plan(plan, torch.Generator().manual_seed(0)), cfg)
    return model.to(dtype=dtype, memory_format=CL).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_forward_off_the_card_and_under_sp_launches_nothing(routed, dtype):
    """The mini Darknet-53 at 64px: SP (a one-rank ``Layout``: every conv
    takes ``rows``) keeps the separate ops even where the router would say
    yes, bit for bit as the unrouted forward; the routed forward takes the
    epilogue once at every folded conv."""
    model = _mini_model(dtype)
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    before = ek.launches
    with torch.inference_mode():
        sp = model(x, layout=Layout(create_spatial_mesh(device="cpu")))
        assert routed == []
        routed_heads = model(x)
        n_routed = len(routed)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tblocks, "epilogue_wins", lambda x, act, skip=None: False)
            plain = model(x)
    assert ek.launches == before
    assert all(torch.equal(a, b) for a, b in zip(sp, plain))
    n_convs = sum(isinstance(m, tblocks.FoldedConv) for m in model.modules())
    assert n_routed == n_convs
    for r, p in zip(routed_heads, plain):
        assert r.shape == p.shape
        rel = float((r.float() - p.float()).norm() / p.float().norm())
        # measured 0 (f32) and at most 3.2e-5 (bf16: one rounding per layer
        # where there were up to three)
        assert rel < (1e-6 if dtype == torch.float32 else 1e-3), rel


WRONG = {
    "not 4-D": (lambda y, b, s: (y[0], b, s), "float \\(B, C, H, W\\)"),
    "integer": (lambda y, b, s: (y.to(torch.int16), b, s), "float \\(B, C, H, W\\)"),
    "NCHW memory": (lambda y, b, s: (y.contiguous(), b, s), "y must be stored channels_last"),
    "bias shape": (lambda y, b, s: (y, b[:-1], s), "bias must be"),
    "bias dtype": (lambda y, b, s: (y, b.float(), s), "bias must be"),
    "bias strided": (lambda y, b, s: (y, torch.stack([b, b], 1)[:, 0], s), "contiguous"),
    "skip shape": (lambda y, b, s: (y, b, s[:1]), "skip must be"),
    "skip dtype": (lambda y, b, s: (y, b, s.float()), "skip must be"),
    "skip NCHW": (lambda y, b, s: (y, b, s.contiguous()), "skip must be stored channels_last"),
    "skip is y": (lambda y, b, s: (y, b, y), "overlaps"),
}


@pytest.mark.parametrize("case", sorted(WRONG))
def test_wrapper_rejects_bad_input(case):
    make, match = WRONG[case]
    y, b, s = make(_nhwc((2, 16, 3, 3), 50), _bf16((16,), 51), _nhwc((2, 16, 3, 3), 52))
    with pytest.raises(ValueError, match=match):
        ek.conv_epilogue(y, b, "leaky_relu", s)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    y, b = _nhwc((2, 16, 3, 3), 53), _bf16((16,), 54)
    with pytest.raises(ValueError, match="unsupported activation"):
        ek.conv_epilogue(y, b, "gelu")
    # off the CPU only bf16, and only on CUDA: no silent fallback
    meta = torch.empty((2, 16, 3, 3), device="meta").contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="takes bf16"):
        ek.conv_epilogue(meta, torch.empty(16, device="meta"))
    meta = meta.to(torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.conv_epilogue(meta, torch.empty(16, device="meta", dtype=torch.bfloat16))


def test_launcher_is_declared_where_the_library_binds_it():
    source = (kernels.CSRC_DIR / "epilogue.cu").read_text()
    assert ('extern "C" int conv_epilogue_launch(void* y, const void* bias, const void* skip, '
            'long long rows,') in source
    argtypes, _ = kernels._SIGNATURES["conv_epilogue_launch"]
    assert len(argtypes) == 7 and "epilogue.cu" in {p.name for p in kernels.sources()}
    # the slice output: y, bias, skip, out, rows, C, pitch, keep, act, stream
    assert ('extern "C" int conv_epilogue_slice_launch(void* y, const void* bias, const void* '
            'skip, void* out,\n') in source
    assert "long long rows, int c, int pitch, int keep, int act," in source
    argtypes, restype = kernels._SIGNATURES["conv_epilogue_slice_launch"]
    assert len(argtypes) == 10 and argtypes[4] is ctypes.c_longlong and restype is ctypes.c_int


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 255, 512, 21])
@pytest.mark.parametrize("with_skip", [False, True])
def test_silu_kernel_equals_the_plain_version(card, c, with_skip):
    """K5 under SiLU against ``conv_epilogue_reference`` on the card (torch's
    CUDA silu, ``x / (1 + expf(-x))`` in f32): the same bits, as leaky and
    identity; the 255-channel head width wraps a vector across rows."""
    y = _nhwc((3, c, 7, 9), 60).to(card)
    bias = _bf16((c,), 61, 0.5).to(card)
    skip = _nhwc((3, c, 7, 9), 62).to(card) if with_skip else None
    before = ek.launches
    got = ek.conv_epilogue(y.clone(memory_format=CL), bias, "silu", skip)
    assert ek.launches == before + 1
    assert torch.equal(got, ek.conv_epilogue_reference(y, bias, "silu", skip))


@pytest.mark.cuda
def test_silu_kernel_on_a_misaligned_view(card):
    """A view one element into its storage takes the one-element variant."""
    y = _nhwc((2, 64, 5, 5), 63).to(card)
    bias = _bf16((64,), 64, 0.5).to(card)
    base = torch.empty(y.numel() + 8, dtype=torch.bfloat16, device=card)
    view = base[1:y.numel() + 1].view(2, 5, 5, 64).permute(0, 3, 1, 2).copy_(y)
    got = ek.conv_epilogue(view, bias, "silu")
    assert torch.equal(got, ek.conv_epilogue_reference(y, bias, "silu"))


# ---------------------------------------------------------------------------
# ReLU and the add-first order (RT-DETR's ResNet-vd bottlenecks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [64, 21, 255])
@pytest.mark.parametrize("add_first", [False, True])
@pytest.mark.parametrize("activation", ["relu", "identity"])
def test_plain_relu_and_add_first_round_once(activation, add_first, c):
    """``act(y + bias + skip)`` (or ``skip + act(y + bias)``) in f32,
    rounded once: within half a bf16 step of the float64 value plus f32's
    own error; a NaN passes and a negative sum gives +0."""
    y, skip = _nhwc((2, c, 3, 5), 70), _nhwc((2, c, 3, 5), 71)
    bias = _bf16((c,), 72, 0.5)
    got = ek.conv_epilogue_reference(y, bias, activation, skip, add_first=add_first).double()
    t = y.double() + bias.double()[:, None, None]
    act = (lambda v: v.clamp(min=0)) if activation == "relu" else (lambda v: v)
    want = act(t + skip.double()) if add_first else skip.double() + act(t)
    assert bool(((got - want).abs() <= _half_step(want) + 1e-6 * want.abs()).all())
    y[0, 0, 0, 0] = float("nan")
    out = ek.conv_epilogue_reference(y, bias, "relu", skip, add_first=add_first)
    assert torch.isnan(out[0, 0, 0, 0])


def test_add_first_takes_identity_and_relu_alone():
    y = _nhwc((1, 8, 2, 2), 73)
    for activation in ("leaky_relu", "mish", "silu"):
        with pytest.raises(ValueError, match="add-first"):
            ek.conv_epilogue(y, _bf16((8,), 74), activation, y.clone(memory_format=CL),
                             add_first=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_conv_adds_first_off_the_card(dtype):
    """``FoldedConv(x, relu, skip=s, add_first=True)`` off the card is the
    composition ``relu(conv(x) + b + s)``, and ``ConvBlock``'s the same."""
    gen = torch.Generator().manual_seed(75)
    conv = tblocks.FoldedConv(8, 16, 1)
    conv.weight.data.normal_(generator=gen)
    conv.bias.data.normal_(generator=gen)
    conv = conv.to(dtype)
    x = torch.randn(2, 8, 5, 5, generator=gen).to(dtype)
    s = torch.randn(2, 16, 5, 5, generator=gen).to(dtype)
    got = conv(x, tblocks.relu, skip=s, add_first=True)
    want = F.relu(F.conv2d(x, conv.weight, conv.bias) + s)
    assert torch.equal(got, want)
    assert torch.equal(conv(x, tblocks.relu, skip=s), s + F.relu(F.conv2d(x, conv.weight,
                                                                          conv.bias)))
    block = tblocks.ConvBlock(8, 16, 1, generator=gen).eval().to(dtype)
    y = block.bn(block.conv(x))
    assert torch.equal(block(x, tblocks.relu, skip=s, add_first=True), F.relu(y + s))


def test_relu_routes_to_the_kernel():
    assert tblocks.EPILOGUE_ACTIVATIONS[tblocks.relu] == "relu"
    assert ek.ACT_CODES["relu"] == 4 and ek.ADD_FIRST == 16
    source = (kernels.CSRC_DIR / "epilogue.cu").read_text()
    assert "kRelu = 4" in source and "kAddFirst = 16" in source


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 21, 32, 64, 255, 512, 1023, 2056])
@pytest.mark.parametrize("with_skip", [False, True])
@pytest.mark.parametrize("add_first", [False, True])
def test_relu_kernel_equals_the_plain_version(card, c, with_skip, add_first):
    """K5 under ReLU, in both orders, against ``conv_epilogue_reference`` on
    the card: the same bits at every width (heads' odd widths wrap a vector
    across rows)."""
    y = _nhwc((3, c, 7, 9), 80).to(card)
    bias = _bf16((c,), 81, 0.5).to(card)
    skip = _nhwc((3, c, 7, 9), 82).to(card) if with_skip else None
    before = ek.launches
    got = ek.conv_epilogue(y.clone(memory_format=CL), bias, "relu", skip, add_first=add_first)
    assert ek.launches == before + 1
    want = ek.conv_epilogue_reference(y, bias, "relu", skip, add_first=add_first)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["y", "skip"])
def test_add_first_kernel_on_a_misaligned_view(card, which):
    """A view one element into its storage takes the one-element variant."""
    y = _nhwc((2, 64, 5, 5), 83).to(card)
    skip = _nhwc((2, 64, 5, 5), 84).to(card)
    bias = _bf16((64,), 85, 0.5).to(card)
    base = torch.empty(y.numel() + 8, dtype=torch.bfloat16, device=card)
    view = base[1:y.numel() + 1].view(2, 5, 5, 64).permute(0, 3, 1, 2).copy_(
        y if which == "y" else skip)
    want = ek.conv_epilogue_reference(y, bias, "relu", skip, add_first=True)
    if which == "y":
        got = ek.conv_epilogue(view, bias, "relu", skip, add_first=True)
    else:
        got = ek.conv_epilogue(y.clone(memory_format=CL), bias, "relu", view, add_first=True)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# The result stored into a channel slice of a concat buffer
# ---------------------------------------------------------------------------

SENTINEL = -3.0  # a bf16 value the epilogue of these inputs never gives exactly


def _buffer(b, pitch, h, w, device="cpu"):
    buf = torch.full((b, pitch, h, w), SENTINEL, dtype=torch.bfloat16, device=device)
    return buf.contiguous(memory_format=CL)


# (C, the slice's channel offset, the buffer's channels): widths 8 to 2056,
# slices at the buffer's start, middle and end, and pitches that are and are
# not multiples of 8
SLICES = [(8, 0, 8), (8, 8, 24), (16, 3, 21), (64, 64, 128), (128, 0, 384), (255, 1, 256),
          (256, 256, 512), (512, 128, 1152), (1024, 0, 2048), (2056, 8, 2072)]


@pytest.mark.parametrize("c,offset,pitch", SLICES)
@pytest.mark.parametrize("activation,skip_order", [
    ("identity", None), ("leaky_relu", "after"), ("mish", None), ("silu", "after"),
    ("relu", "first"), ("identity", "first")])
@pytest.mark.parametrize("keep", [False, True])
def test_slice_output_is_the_plain_result(c, offset, pitch, activation, skip_order, keep):
    """``conv_epilogue(..., out=slice)`` stores the plain version's values
    in the slice, leaves every other channel of the buffer as it was (the
    sentinel planted there), and with ``keep`` writes ``y`` the same (else
    leaves it alone)."""
    y = _nhwc((2, c, 3, 2), 90)
    bias = _bf16((c,), 91, 0.5)
    skip = _nhwc((2, c, 3, 2), 92) if skip_order else None
    add_first = skip_order == "first"
    want = ek.conv_epilogue_reference(y, bias, activation, skip, add_first=add_first)
    buf = _buffer(2, pitch, 3, 2)
    out = buf[:, offset:offset + c]
    got_y = y.clone(memory_format=CL)
    got = ek.conv_epilogue(got_y, bias, activation, skip, add_first=add_first, out=out,
                           keep=keep)
    assert got is (got_y if keep else out)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    rest = torch.cat([buf[:, :offset], buf[:, offset + c:]], dim=1)
    assert bool((rest == SENTINEL).all())
    assert torch.equal(got_y, want if keep else y)


def test_folded_conv_stores_into_the_slice(monkeypatch):
    """``FoldedConv(..., out=slice)`` on K5's route (its plain version
    here) stores the value of ``FoldedConv(...)`` in the slice and counts
    its bytes as stored in place; off that route it copies them in and
    counts them as a copy."""
    from yolo_for_turbines_tpu_torch.utils import profiling

    conv = _folded_conv(8, 16, 3, 1, 93, torch.bfloat16)
    x = _nhwc((2, 8, 5, 4), 94)
    for wins in (True, False):
        monkeypatch.setattr(tblocks, "epilogue_wins", lambda *a, w=wins, **k: w)
        want = conv(x, tblocks.silu)
        buf = _buffer(2, 40, 5, 4)
        copied, stored = profiling.concat_bytes, profiling.concat_in_place_bytes
        kept = conv(x, tblocks.silu, out=buf[:, 16:32], keep=True)
        assert torch.equal(buf[:, 16:32], want) and torch.equal(kept, want)
        assert bool((buf[:, :16] == SENTINEL).all() and (buf[:, 32:] == SENTINEL).all())
        moved = (profiling.concat_in_place_bytes - stored, profiling.concat_bytes - copied)
        assert moved == ((want.nbytes, 0) if wins else (0, want.nbytes))


def _slice_of(y, pitch=None, offset=8):
    b, c, h, w = y.shape
    pitch = pitch or c + 16
    return _buffer(b, pitch, h, w)[:, offset:offset + c]


def _interleaved(y, s):
    """``y`` moved into the first rows of a pitch-32 buffer, ``s``, and that
    buffer's channels 16-31, which lie between those rows."""
    buf = _buffer(2, 32, 3, 3)
    dense = buf.permute(0, 2, 3, 1).reshape(-1)[:y.numel()].view(2, 3, 3, 16)
    return dense.permute(0, 3, 1, 2).copy_(y), s, buf[:, 16:32]


WRONG_OUT = {
    "shape": (lambda y, s: (y, s, _slice_of(y)[:, :-1]), "out must be"),
    "dtype": (lambda y, s: (y, s, _slice_of(y).float()), "out must be"),
    "NCHW buffer": (lambda y, s: (y, s, torch.zeros((2, 32, 3, 3), dtype=torch.bfloat16)[:, 8:24]),
                    "channel slice of a channels_last buffer"),
    "rows and columns swapped": (lambda y, s: (y, s, _buffer(2, 32, 3, 3)[:, 8:24].mT),
                                 "channel slice of a channels_last buffer"),
    "is y": (lambda y, s: (y, s, y), "overlaps y or skip"),
    "between y's rows": (_interleaved, "overlaps y or skip"),
    "is skip": (lambda y, s: (y, s, s), "overlaps y or skip"),
}


@pytest.mark.parametrize("case", sorted(WRONG_OUT))
def test_wrapper_rejects_a_bad_output(case):
    make, match = WRONG_OUT[case]
    y, s, out = make(_nhwc((2, 16, 3, 3), 95), _nhwc((2, 16, 3, 3), 96))
    with pytest.raises(ValueError, match=match):
        ek.conv_epilogue(y, _bf16((16,), 97), "leaky_relu", s, out=out)

@pytest.mark.cuda
@pytest.mark.parametrize("c,offset,pitch", SLICES + [(24, 8, 88), (21, 5, 27)])
@pytest.mark.parametrize("activation,skip_order", [
    ("leaky_relu", None), ("mish", None), ("silu", None), ("silu", "after"),
    ("relu", "first"), ("identity", None)])
@pytest.mark.parametrize("keep", [False, True])
def test_slice_kernel_equals_the_plain_version(card, c, offset, pitch, activation, skip_order,
                                               keep):
    """K5's slice output on the card: the plain version's bits in the slice
    (the 16-byte variant where C, the offset and the pitch are multiples of
    8, the one-element variant elsewhere), the sentinel everywhere else,
    and ``y`` rewritten only with ``keep``."""
    y = _nhwc((3, c, 7, 9), 98).to(card)
    bias = _bf16((c,), 99, 0.5).to(card)
    skip = _nhwc((3, c, 7, 9), 100).to(card) if skip_order else None
    add_first = skip_order == "first"
    want = ek.conv_epilogue_reference(y, bias, activation, skip, add_first=add_first)
    buf = _buffer(3, pitch, 7, 9, card)
    out = buf[:, offset:offset + c]
    got_y = y.clone(memory_format=CL)
    before = ek.launches
    ek.conv_epilogue(got_y, bias, activation, skip, add_first=add_first, out=out, keep=keep)
    assert ek.launches == before + 1
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    rest = torch.cat([buf[:, :offset], buf[:, offset + c:]], dim=1)
    assert bool((rest == SENTINEL).all())
    assert torch.equal(got_y.view(torch.int16), (want if keep else y).view(torch.int16))


def test_yolov3_concats_are_copies_into_one_buffer():
    """YOLOv3's concats ``[upsampled, route]`` on the card's route on the
    CPU: neither part is a K5 result, so both are copied into the buffer
    (the upsampled half from a broadcast view of the trunk, with no
    intermediate): heads equal the ``torch.cat`` route's bit for bit, and
    the bytes copied are the concats' bytes."""
    model = _mini_model(torch.float32)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32))
    (got, copied, stored), (want, cat_copied, cat_stored) = concat_routes(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert stored == cat_stored == 0 and copied == cat_copied > 0


class _Grad(_Like):
    def __init__(self, requires_grad=False, **kw):
        super().__init__(**kw)
        self.requires_grad = requires_grad


@pytest.mark.parametrize("x,folded,grad,wins", [
    (_Grad(), True, False, True),
    (_Grad(), False, False, False),  # the trainable model's ConvBlocks
    (_Grad(requires_grad=True), True, True, False),  # autograd
    (_Grad(requires_grad=True), True, False, True),  # no grad asked
    (_Grad(cuda=False), True, False, False),
    (_Grad(dtype=torch.float32), True, False, False),
    (_Grad(nhwc=False), True, False, False),
])
def test_concat_routing_takes_only_the_folded_card_route(x, folded, grad, wins):
    with torch.set_grad_enabled(grad):
        assert tblocks.concat_wins(x, tblocks.silu, folded) is wins


@pytest.mark.parametrize("in_place", [True, False])
def test_channel_concat_builds_what_torch_cat_builds(monkeypatch, in_place):
    """A conv part kept and one not, a part put in and an upsampled one, in
    any order: the buffer (or ``torch.cat``'s result) equals the concat of
    the parts, channels_last."""
    monkeypatch.setattr(tblocks, "epilogue_wins", lambda *a, **k: True)
    monkeypatch.setattr(tblocks, "concat_wins", lambda x, act, folded: in_place and folded)
    x = _nhwc((2, 8, 6, 4), 110, torch.float32)
    conv, conv2 = (_folded_conv(8, n, 1, 1, 111 + n, torch.float32) for n in (16, 8))
    route = _nhwc((2, 24, 6, 4), 113, torch.float32)
    low = _nhwc((2, 8, 3, 2), 114, torch.float32)
    cat = tblocks.ChannelConcat(x, tblocks.leaky_relu, (8, 16, 24, 8), (6, 4), folded=True)
    cat.put(2, route)
    kept = cat.conv(1, conv, x, tblocks.leaky_relu, keep=True)
    cat.upsampled(3, low)
    cat.conv(0, conv2, kept[:, :8].contiguous(memory_format=CL), tblocks.leaky_relu)
    got = cat.result()
    want = torch.cat([conv2(kept[:, :8].contiguous(memory_format=CL), tblocks.leaky_relu),
                      conv(x, tblocks.leaky_relu), route, tblocks.upsample2x(low)], dim=1)
    assert (cat.buf is not None) == in_place
    assert torch.equal(got, want) and got.is_contiguous(memory_format=CL)
