"""Torch port: an int8 conv's epilogue (kernel K6, ``csrc/epilogue.cu``) and
the routing of ``models/quantize.py::_epilogue`` to it.

On the CPU: the plain version (the in-place composition of aten ops the int8
layer path ran after every conv) gives the codes of the same f32 operations
written out one by one in the JAX package's order, bit for bit; the router
keeps it on the CPU and under ``portable`` and opens the span
``int8.epilogue`` once per int8 conv; the wrapper refuses what the kernel
does not take.

On the card (marker ``cuda``; skipped without one): K6's codes equal the
composition's bit for bit at every width, misaligned views included, and the
int8 Darknet-53 predictor reads the same trunk codes and heads with K6 as
with the composition, launching K6 53 times per ``predict_batch``. Run them
on a card with ``python -m pytest tests/test_torch_int8_epilogue.py -m
cuda --noconftest`` (``tests/conftest.py`` sets up JAX, which the port and
these tests do not need).
"""

import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers import MINI_CSP_LAYERS, MINI_LAYERS
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import quantize as tq
from yolo_for_turbines_tpu_torch.models.cspdarknet import PlanCSP
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    PlanConv,
    PlanResidual,
    PlanUpsample,
    build_plan,
    init_plan,
)
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import int8_epilogue_kernel as ik
from yolo_for_turbines_tpu_torch.utils import profiling

# Darknet-53's output widths, one that leaves a scalar tail of a 16-element
# vector (B*H*W*C % 16 != 0), and one whose channel period passes a block
WIDTHS = (32, 64, 128, 256, 512, 1024, 1023, 2056)
OPERANDS = ("plain", "residual", "branch", "both")
ACTIVATIONS = ("leaky_relu", "mish")
# int8 convs of the full-width Darknet-53 that take the epilogue: all 75 but
# K4's 26x26x512 stage (16) and the three heads' two bf16 convs (6)
DARKNET53_EPILOGUES = 53


def _operands(shape, seed, operands, device="cpu"):
    """i32 conv outputs, scales and codes in the ranges the int8 path gives
    them: y32 * d around +-10, so codes reach the clamp."""
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]

    def i32():
        return torch.randint(-(1 << 17), 1 << 17, shape, generator=g, dtype=torch.int32)

    d = torch.rand(c, generator=g) * 1e-4
    b = torch.randn(c, generator=g)
    s_out = torch.tensor(0.05)
    residual = extra = None
    if operands in ("residual", "both"):
        residual = (torch.randint(-127, 128, shape, generator=g, dtype=torch.int8),
                    torch.tensor(0.03))
    if operands in ("branch", "both"):
        extra = (i32(), torch.rand(c, generator=g) * 1e-4)
    to = lambda t: t.to(device)  # noqa: E731
    pair = lambda p: None if p is None else (to(p[0]), to(p[1]))  # noqa: E731
    return to(i32()), to(d), to(b), to(s_out), pair(residual), pair(extra)


def _by_hand(y32, d, b, s_out, activation, residual, extra):
    """The JAX package's epilogue as separate out-of-place f32 operations."""
    t = y32.float() * d
    if extra is not None:
        t = t + extra[0].float() * extra[1]
    t = t + b
    t = F.leaky_relu(t, 0.1) if activation == "leaky_relu" else F.mish(t)
    if residual is not None:
        t = t + residual[0].float() * residual[1]
    return torch.clamp(torch.round(t / s_out), -127, 127).to(torch.int8)


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_plain_version_gives_the_epilogue_codes(activation, operands, c):
    y32, d, b, s_out, residual, extra = _operands((2, 3, 5, c), c, operands)
    before = ik.launches
    got = tq._epilogue(y32, d, b, s_out, activation, residual=residual, extra=extra)
    plain = ik.int8_epilogue_reference(y32, d, b, s_out, activation, residual, extra)
    assert ik.launches == before
    assert got.dtype == torch.int8 and got.shape == y32.shape
    assert torch.equal(got, plain)
    assert torch.equal(plain, _by_hand(y32, d, b, s_out, activation, residual, extra))
    # the inputs are read, never written
    assert torch.equal(y32, _operands((2, 3, 5, c), c, operands)[0])
    # the codes reach the clamp
    assert int(got.max()) == 127


def test_wrapper_writes_into_out():
    y32, d, b, s_out, residual, extra = _operands((2, 3, 3, 32), 1, "both")
    out = torch.empty(y32.shape, dtype=torch.int8)
    got = ik.int8_epilogue(y32, d, b, s_out, "mish", residual, extra, out=out)
    assert got is out
    assert torch.equal(out, ik.int8_epilogue_reference(y32, d, b, s_out, "mish", residual, extra))


def _mini(layers, activation):
    cfg = ModelConfig(num_classes=2, layer_config=layers, activation=activation)
    plan = build_plan(cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(2, 64, 64, 3))
                         .astype(np.float32))
    return plan, tq.quantize_folded(plan, tree, x, activation), x


def _epilogues(plan):
    """(all, with a residual, with a second branch) int8 conv epilogues of
    one layer-path forward of ``plan``."""
    n = res = branch = 0
    after_up = False
    for entry in plan:
        if isinstance(entry, PlanConv):
            n, branch = n + 1, branch + after_up
        elif isinstance(entry, PlanResidual):
            n += 2 * entry.num_blocks
            res += entry.num_blocks if entry.use_residual else 0
        elif isinstance(entry, PlanCSP):
            n += 4 + 2 * entry.num_blocks
            res, branch = res + entry.num_blocks, branch + 1
        after_up = isinstance(entry, PlanUpsample)
    return n, res, branch


@pytest.mark.parametrize("family,layers,activation", [
    ("darknet53", MINI_LAYERS, "leaky_relu"),
    ("darknet53", MINI_LAYERS, "mish"),
    ("csp", MINI_CSP_LAYERS, "leaky_relu"),
])
def test_router_keeps_the_composition_off_the_card(monkeypatch, family, layers, activation):
    """Off the card every int8 conv's epilogue goes to the wrapper, which
    takes the plain version; under ``portable`` the plain version is called
    directly. Both give the same heads, and K6 never launches."""
    plan, qp, x = _mini(layers, activation)
    calls = []

    def spy(y32, d, b, s_out, act, residual=None, extra=None):
        calls.append((act, residual is not None, extra is not None))
        return ik.int8_epilogue(y32, d, b, s_out, act, residual, extra)

    kw = dict(activation=activation, raw_heads=True, compute_dtype=torch.float32)
    before = ik.launches
    portable = tq.apply_inference_int8(plan, qp, x, portable=True, **kw)
    monkeypatch.setattr(tq, "int8_epilogue", spy)
    # the portable path does not reach the wrapper
    tq.apply_inference_int8(plan, qp, x, portable=True, **kw)
    assert calls == []
    routed = tq.apply_inference_int8(plan, qp, x, **kw)
    assert ik.launches == before
    n, res, branch = _epilogues(plan)
    assert len(calls) == n
    assert all(act == activation for act, _, _ in calls)
    assert sum(r for _, r, _ in calls) == res and sum(e for _, _, e in calls) == branch
    assert res > 0 and branch > 0
    assert len(routed) == len(portable) == 3
    assert all(torch.equal(a, b) for a, b in zip(routed, portable))


@pytest.mark.parametrize("portable", [False, True])
def test_span_round_every_epilogue(portable):
    plan, qp, x = _mini(MINI_LAYERS, "leaky_relu")
    kw = dict(activation="leaky_relu", raw_heads=True, compute_dtype=torch.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        tq.apply_inference_int8(plan, qp, x, portable=portable, **kw)
    names = [s.name for s in profiling.spans(since=t0)]
    assert names.count("int8.epilogue") == _epilogues(plan)[0]
    # without a profiler no span is logged
    t1 = time.perf_counter()
    tq.apply_inference_int8(plan, qp, x, portable=portable, **kw)
    assert profiling.spans(since=t1) == []


def _bytes_of(t, quarter):
    """An int8 tensor shaped like ``t`` over a quarter of ``t``'s bytes."""
    n = t.numel()
    return t.view(torch.int8).view(-1)[quarter * n:(quarter + 1) * n].view(t.shape)


def _wrong(case):
    y32, d, b, s_out, residual, extra = _operands((2, 3, 3, 16), 5, "both")
    args = dict(y32=y32, d=d, b=b, s_out=s_out, activation="leaky_relu", residual=residual,
                extra=extra, out=None)
    rq, rs = residual
    yb, db = extra
    meta = torch.device("meta")
    changes = {
        "activation": dict(activation="relu"),
        "y32 dtype": dict(y32=y32.float()),
        "y32 not 4-D": dict(y32=y32[0]),
        "y32 strided": dict(y32=y32.transpose(1, 2)),
        "d shape": dict(d=d[:-1]),
        "d dtype": dict(d=d.double()),
        "d device": dict(d=d.to(meta)),
        "d strided": dict(d=torch.stack([d, d], 1)[:, 0]),
        "b shape": dict(b=b[None]),
        "s_out shape": dict(s_out=s_out[None]),
        "s_out dtype": dict(s_out=s_out.double()),
        "s_out device": dict(s_out=s_out.to(meta)),
        "residual dtype": dict(residual=(rq.int(), rs)),
        "residual shape": dict(residual=(rq[:1], rs)),
        "residual scale": dict(residual=(rq, rs[None])),
        "branch dtype": dict(extra=(yb.to(torch.int16), db)),
        "branch shape": dict(extra=(yb[:, :2], db)),
        "branch scales": dict(extra=(yb, db[:3])),
        "out dtype": dict(out=torch.empty(y32.shape, dtype=torch.uint8)),
        "out shape": dict(out=torch.empty((1, 3, 3, 16), dtype=torch.int8)),
        "out overlaps y32": dict(out=_bytes_of(y32, 0)),
        "out overlaps the residual": dict(out=rq),
        "out overlaps the branch": dict(out=_bytes_of(yb, 1)),
    }
    args.update(changes[case])
    return args


WRONG = ("activation", "y32 dtype", "y32 not 4-D", "y32 strided", "d shape", "d dtype",
         "d device", "d strided", "b shape", "s_out shape", "s_out dtype", "s_out device",
         "residual dtype", "residual shape", "residual scale", "branch dtype", "branch shape",
         "branch scales", "out dtype", "out shape", "out overlaps y32",
         "out overlaps the residual", "out overlaps the branch")


@pytest.mark.parametrize("case", WRONG)
def test_wrapper_rejects_bad_input(case):
    args = _wrong(case)
    with pytest.raises(ValueError, match="unsupported activation" if case == "activation"
                       else "overlaps" if "overlaps" in case else "must be"):
        ik.int8_epilogue(**args)


def test_wrapper_has_no_fallback_off_the_cpu():
    y32, d, b, s_out, _, _ = _operands((1, 2, 2, 16), 6, "plain", device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ik.int8_epilogue(y32, d, b, s_out, "leaky_relu")


def test_launcher_is_declared_where_the_library_binds_it():
    source = (kernels.CSRC_DIR / "epilogue.cu").read_text()
    assert ('extern "C" int int8_epilogue_launch(const void* y, const void* yb, const void* res, '
            'void* q,') in source
    argtypes, _ = kernels._SIGNATURES["int8_epilogue_launch"]
    assert len(argtypes) == 13


# --- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 runs only there")
    return torch.device("cuda", 0)


def _composition(y32, d, b, s_out, activation, residual, extra):
    """The plain version on the card: aten's ops there, the division by the
    0-dim device scale included."""
    torch.cuda.synchronize()
    return ik.int8_epilogue_reference(y32, d, b, s_out, activation, residual, extra)


@pytest.mark.cuda
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_kernel_equals_the_composition(card, activation, operands, c):
    ops = _operands((3, 7, 5, c), c, operands, card)
    before = ik.launches
    got = ik.int8_epilogue(*ops[:4], activation, *ops[4:])
    assert ik.launches == before + 1
    want = _composition(*ops[:4], activation, *ops[4:])
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert int((got != want).sum()) == 0


def _misaligned(t):
    """``t``'s values in a view one element into a larger buffer."""
    base = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = base[1:t.numel() + 1].view(t.shape)
    return view.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["y32", "residual", "branch", "out"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_kernel_on_misaligned_views(card, activation, which):
    y32, d, b, s_out, (rq, rs), (yb, db) = _operands((2, 13, 13, 64), 7, "both", card)
    want = _composition(y32, d, b, s_out, activation, (rq, rs), (yb, db))
    y32 = _misaligned(y32) if which == "y32" else y32
    rq = _misaligned(rq) if which == "residual" else rq
    yb = _misaligned(yb) if which == "branch" else yb
    out = torch.empty(y32.shape, dtype=torch.int8, device=card)
    out = _misaligned(out) if which == "out" else out
    got = ik.int8_epilogue(y32, d, b, s_out, activation, (rq, rs), (yb, db), out=out)
    assert got is out
    assert int((got != want).sum()) == 0


@pytest.fixture(scope="module")
def int8_darknet53():
    """The 80-class Darknet-53 at 416px from seeded weights, quantized on two
    seeded images, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 runs only there")
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
def test_predictor_reads_the_same_codes_with_k6(int8_darknet53, monkeypatch):
    plan, pred, x = int8_darknet53

    def forward():
        trunk = []
        heads = tq.apply_inference_int8(plan, pred._qparams, x, activation="leaky_relu",
                                        raw_heads=True, compute_dtype=pred.compute_dtype,
                                        packed=pred._packed, head_inputs=trunk)
        torch.cuda.synchronize()
        return trunk, heads

    before = ik.launches
    trunk, heads = forward()
    assert ik.launches - before == DARKNET53_EPILOGUES
    # the same forward with the composition in K6's place (K4 kept)
    monkeypatch.setattr(tq, "int8_epilogue", ik.int8_epilogue_reference)
    trunk_plain, heads_plain = forward()
    assert ik.launches - before == DARKNET53_EPILOGUES
    assert len(trunk) == len(trunk_plain) == 3
    for ta, tb in zip(trunk, trunk_plain):
        assert all(torch.equal(a, b) for a, b in zip(ta, tb))
    assert all(torch.equal(a, b) for a, b in zip(heads, heads_plain))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 2])
def test_k6_launches_per_predict_batch(int8_darknet53, batch):
    _, pred, x = int8_darknet53
    before = ik.launches
    pred.predict_batch(x[:batch])
    torch.cuda.synchronize()
    assert ik.launches - before == DARKNET53_EPILOGUES
