"""Torch port: the sampling core of RT-DETR's multi-scale deformable
attention (kernel K9, ``csrc/deform.cu``) and its routing.

The plain version (``ops/kernels/deform_kernel.py::deform_attention_
reference``) is held to the benchmark's independent reference
(``perfbench/reference/rtdetr.py::deform_core``, the source's
``deformable_attention_core_func``) on the CPU; the kernel runs only on the
card, where the tests marked ``cuda`` hold it to the plain version within
one bf16 rounding of its result (it sums the 12 samples in their order in
f32 and rounds once), and ``chip_smoke.py`` phase rtdetr times it."""

import ctypes
import re

import pytest
import torch

from perfbench.reference import rtdetr as rt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch.models import rtdetr
from yolo_for_turbines_tpu_torch.ops import kernels
from yolo_for_turbines_tpu_torch.ops.kernels import deform_kernel as dk

SHAPES = [(8, 8), (4, 4), (2, 2)]


def _inputs(b, q, heads, d, seed, device="cpu", shapes=SHAPES, spill=0.1):
    g = torch.Generator().manual_seed(seed)
    n = sum(h * w for h, w in shapes)
    value = torch.randn((b, n, heads * d), generator=g).to(torch.bfloat16)
    loc = torch.rand((b, q, heads, len(shapes), 4, 2), generator=g) * (1 + 2 * spill) - spill
    weights = torch.softmax(torch.randn((b, q, heads, len(shapes) * 4), generator=g), -1)
    return value.to(device), loc.to(device), weights.to(device)


@pytest.mark.parametrize("heads,d", [(8, 32), (4, 16), (2, 8)])
def test_plain_version_is_the_sources_core(heads, d):
    """Against the reference's ``deform_core`` (values in float32, the
    weights (B, Q, heads, levels, points)), samples partly off the planes."""
    value, loc, weights = _inputs(2, 7, heads, d, heads * d)
    got = dk.deform_attention_reference(value, SHAPES, loc, weights)
    want = rt.deform_core(value.float(), SHAPES, loc, weights.view(2, 7, heads, 3, 4))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, heads * d)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(dk.deform_attention(value, SHAPES, loc, weights), got)


def test_the_wrapper_refuses_what_disagrees():
    value, loc, weights = _inputs(1, 3, 8, 32, 1)
    with pytest.raises(ValueError, match="shapes disagree"):
        dk.deform_attention(value, [(8, 8), (4, 4)], loc[:, :, :, :2], weights)
    with pytest.raises(ValueError, match="shapes disagree"):
        dk.deform_attention(value[:, :-1], SHAPES, loc, weights)
    with pytest.raises(ValueError, match="value"):
        dk.deform_attention(value[0], SHAPES, loc, weights)
    # off the CPU only CUDA, and there only bf16 values: no silent fallback
    meta = torch.empty(value.shape, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        dk.deform_attention(meta, SHAPES, loc.to("meta"), weights.to("meta"))


class _Like:
    def __init__(self, cuda=True, dtype=torch.bfloat16):
        self.is_cuda, self.dtype = cuda, dtype


@pytest.mark.parametrize("value,wins", [(_Like(), True), (_Like(cuda=False), False),
                                        (_Like(dtype=torch.float32), False)])
def test_routing_takes_bf16_on_the_card(value, wins):
    assert rtdetr.deform_wins(value) is wins


def test_the_launcher_is_declared_as_the_library_binds_it():
    source = (kernels.CSRC_DIR / "deform.cu").read_text()
    found = re.search(r'extern "C" int deform_attention_launch\(([^)]*)\)', source)
    assert found
    params = [p.strip() for p in found.group(1).split(",")]
    argtypes, _ = kernels._SIGNATURES["deform_attention_launch"]
    assert len(params) == len(argtypes)
    for param, argtype in zip(params, argtypes):
        pointer = "*" in param
        assert pointer == (argtype is ctypes.c_void_p or hasattr(argtype, "contents")), param


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K9 runs only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,q,heads,d,shapes", [
    (2, 300, 8, 32, [(80, 80), (40, 40), (20, 20)]),
    (3, 7, 4, 16, SHAPES),
    (1, 5, 2, 8, [(3, 5), (2, 2)]),
    (64, 300, 8, 32, [(80, 80), (40, 40), (20, 20)]),
])
def test_card_kernel_equals_the_plain_version(card, b, q, heads, d, shapes):
    """Within one bf16 rounding of the plain version's float32 result (and
    f32 summation order), samples partly off the planes; one launch."""
    value, loc, weights = _inputs(b, q, heads, d, b + q, card, shapes)
    before = dk.launches
    got = dk.deform_attention(value, shapes, loc, weights)
    torch.cuda.synchronize()
    assert dk.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, q, heads * d)
    want = dk.deform_attention_reference(value, shapes, loc, weights)
    assert bool(((got.float() - want).abs() <= 2.0 ** -8 * want.abs() + 1e-5).all())
