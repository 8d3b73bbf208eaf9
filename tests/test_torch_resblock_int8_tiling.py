"""Torch port: what surrounds kernel K4 (``csrc/resblock_int8.cu``) and runs
on the CPU: an emulation of the kernel's tiling against the plain version,
the Python mirror of its shared-memory plan, the K-major weight copies, and
the router against the wrapper's geometry check.

The emulation (tests/k4_tiling.py) must equal
``fused_residual_stage_int8_reference`` code for code, for leaky_relu and
mish alike: it runs the plain version's torch ops in its order on exact
integer sums, so only an indexing fault can make it differ.
"""

import numpy as np
import pytest
import torch

import k4_tiling
from test_torch_resblock_int8 import _stage, _torch_pack
from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk
from yolo_for_turbines_tpu_torch.ops.kernels import resblock_kernel as k2

# the geometries the kernel is checked at on the card (C = 512): the router's
# 16x16 to 32x32 range and a non-square tile edge
GEOMETRIES = ((16, 16), (20, 20), (26, 26), (32, 32), (13, 29))


@pytest.mark.parametrize("activation", ["leaky_relu", "mish"])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_tiling_emulation_equals_plain_version(h, w, activation):
    xq, blocks, s_x, s1, s2 = _stage(100 * h + w, 2, h, w, 512, 1)
    ops = _torch_pack(blocks, s_x, s1, s2)
    x = torch.from_numpy(xq)
    want = rk.fused_residual_stage_int8_reference(x, *ops, activation=activation)
    got = k4_tiling.emulate_stage(x, ops, activation)
    assert got.dtype == torch.int8
    assert torch.equal(got, want)


def test_tiling_emulation_chains_blocks():
    # two blocks: the second reads the first one's codes, halo rows included
    xq, blocks, s_x, s1, s2 = _stage(11, 1, 9, 7, 512, 2)
    ops = _torch_pack(blocks, s_x, s1, s2)
    x = torch.from_numpy(xq)
    assert torch.equal(k4_tiling.emulate_stage(x, ops, "leaky_relu"),
                       rk.fused_residual_stage_int8_reference(x, *ops))


def test_kernel_swizzle_formula_is_the_hardware_rule():
    rows, cols = np.arange(256)[:, None], np.arange(128)[None, :]
    got = k4_tiling.sw128_offset(rows, cols)
    np.testing.assert_array_equal(got, k4_tiling.hw_swizzle(rows * 128 + cols))
    assert len(np.unique(got)) == got.size  # a permutation of the box's bytes


@pytest.mark.parametrize("w", range(1, k2.KERNEL_MAX_W + 1))
def test_smem_plan_fits_for_every_width(w):
    p = rk.smem_plan(w)
    assert p["smem_bytes"] <= k2.MAX_SMEM
    assert 1 <= p["th"] and p["th"] * (w + 2) <= 128
    assert p["n1"] <= 3 * 64  # three 64-row blocks of the 1x1
    # TMA destinations and wgmma operands in the 128-byte swizzle: 1024-aligned
    for off in (p["xchunk"], p["w1_off"], p["mid_block"], p["res_stride"], *p["slot_off"]):
        assert off % 1024 == 0
    assert p["end1"] == p["w1_off"] + 4 * 128 * 128 <= p["bar_off"]
    # mid holds every row a tap can reach from the tile's 128 positions
    assert (128 + 2 * (w + 2) + 2) * 128 <= p["mid_block"]
    # the ring lies past mid, its slots apart, under the barriers
    slots = sorted(p["slot_off"])
    assert slots[0] == 2 * p["mid_block"] and slots[-1] + 256 * 128 <= p["bar_off"]
    assert all(b - a == 256 * 128 for a, b in zip(slots, slots[1:]))
    # the slots filled during the 1x1 lie past the x tile and W1; the next does not
    assert 0 <= p["w2_early"] <= 5
    assert all(off >= p["end1"] for off in p["slot_off"][:p["w2_early"]])
    assert all(off < p["end1"] for off in p["slot_off"][p["w2_early"]:p["w2_early"] + 1])
    # both 128-channel residual boxes fit one ring slot
    assert p["res_bytes"] <= p["res_stride"] and 2 * p["res_stride"] <= 256 * 128


def test_kmajor_weights_are_transposes():
    _, blocks, s_x, s1, s2 = _stage(2, 1, 4, 4, 64, 3)
    ops = _torch_pack(blocks, s_x, s1, s2)
    w1t, w2t = rk.kmajor_weights(ops[0], ops[4])
    assert tuple(w1t.shape) == (3, 32, 64) and tuple(w2t.shape) == (3, 64, 9 * 32)
    assert w1t.is_contiguous() and w2t.is_contiguous()
    assert w1t.dtype == w2t.dtype == torch.int8
    for i in range(3):
        assert torch.equal(w1t[i], ops[0][i].t())
        # W2's K index is tap * C/2 + input channel
        assert torch.equal(w2t[i], ops[4][i].reshape(9 * 32, 64).t())


# Darknet-53's residual stages: (stride, channels)
_STAGES = ((2, 64), (4, 128), (8, 256), (16, 512), (32, 1024))


def _meta_args(h, w, c, n=2):
    ch = c // 2

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    xq = t(1, h, w, c, dtype=torch.int8)
    ops = (t(n, c, ch, dtype=torch.int8), t(n, ch), t(n, ch), t(n, ch),
           t(n, 9, ch, c, dtype=torch.int8), t(n, c), t(n, c), t(n, c), t(n, c))
    kmajor = (t(n, ch, c, dtype=torch.int8), t(n, c, 9 * ch, dtype=torch.int8))
    return xq, ops, kmajor


@pytest.mark.parametrize("stride,c", _STAGES)
@pytest.mark.parametrize("size", [320, 416, 512, 608])
def test_router_agrees_with_wrapper_and_bf16_router(size, stride, c):
    # the int8 router sends the kernel exactly what the bf16 router sends its
    # own, only geometries the wrapper's check accepts; what the kernel does
    # not take raises there
    hw = size // stride
    routed = rk.geometry_wins(hw, hw, c)
    assert routed == k2.stage_wins(hw, hw, c, torch.bfloat16, "cuda")
    assert routed == (c == 512 and size <= 512)
    xq, ops, kmajor = _meta_args(hw, hw, c)
    if routed:
        rk._check_cuda_args(xq, ops, "leaky_relu", kmajor)
    elif not k2.kernel_takes(hw, hw, c):
        with pytest.raises(ValueError, match="the kernel takes"):
            rk._check_cuda_args(xq, ops, "leaky_relu", kmajor)
        assert rk.apply_residual_stage_int8_fused(ops, xq, "leaky_relu", kmajor) is None


def test_wrapper_rejects_misshapen_kmajor_weights():
    xq, ops, kmajor = _meta_args(16, 16, 512)
    with pytest.raises(ValueError, match="K-major"):
        rk._check_cuda_args(xq, ops, "leaky_relu", (kmajor[0], kmajor[1].transpose(1, 2)))
