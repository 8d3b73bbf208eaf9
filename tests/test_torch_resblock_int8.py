"""Torch port: fused int8 residual stage (kernel K4's plain version, operand
packing and router) against the JAX Pallas kernel run in interpret mode.

Inputs are built as in tests/test_resblock_int8_kernel.py: random s8
activations, weights quantized with ``_wq``, seeded scales. The plain version
follows the Pallas formula in the same operation order, but its leaky_relu is
``F.leaky_relu`` where the JAX package's is the algebraic 0.55x + 0.45|x|, and
mish goes through another library; both can move a requant by one code at a
.5 tie. Tolerance: at most 1 code apart, on under 1% of the elements.
``pack_int8_stage`` is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu.models.quantize import _wq
from yolo_for_turbines_tpu.ops.pallas.resblock_int8_kernel import (
    fused_residual_stage_int8 as jax_fused_residual_stage_int8,
    pack_int8_stage as jax_pack_int8_stage,
)
from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk


def _make_stage(rng, c, n):
    blocks = []
    for _ in range(n):
        w1q, s1 = _wq(rng.normal(0, 0.5, (1, 1, c, c // 2)).astype(np.float32))
        w2q, s2 = _wq(rng.normal(0, 0.2, (3, 3, c // 2, c)).astype(np.float32))
        blocks.append({
            "w1q": np.array(w1q), "s1": np.array(s1),
            "b1": rng.normal(0, 0.1, (c // 2,)).astype(np.float32),
            "w2q": np.array(w2q), "s2": np.array(s2),
            "b2": rng.normal(0, 0.1, (c,)).astype(np.float32),
        })
    return blocks


def _stage(seed, b, h, w, c, n):
    rng = np.random.default_rng(seed)
    blocks = _make_stage(rng, c, n)
    xq = rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)
    s_x = np.float32(0.021)
    s1 = [np.float32(v) for v in rng.uniform(0.01, 0.05, n)]
    s2 = [np.float32(v) for v in rng.uniform(0.01, 0.05, n)]
    return xq, blocks, s_x, s1, s2


def _torch_blocks(blocks):
    return [{k: torch.from_numpy(v) for k, v in bp.items()} for bp in blocks]


def _torch_pack(blocks, s_x, s1, s2):
    scalar = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return rk.pack_int8_stage(_torch_blocks(blocks), scalar(s_x), [scalar(v) for v in s1],
                              [scalar(v) for v in s2])


@pytest.mark.parametrize("activation", ["leaky_relu", "mish"])
def test_plain_stage_matches_jax_kernel(activation):
    xq, blocks, s_x, s1, s2 = _stage(7, 2, 8, 8, 32, 4)
    ops_j = jax_pack_int8_stage([{k: jnp.asarray(v) for k, v in bp.items()} for bp in blocks],
                                jnp.float32(s_x), list(map(jnp.float32, s1)),
                                list(map(jnp.float32, s2)))
    want = np.asarray(jax_fused_residual_stage_int8(
        jnp.asarray(xq), *ops_j, chunk=2, activation=activation, interpret=True), np.int32)
    got = rk.fused_residual_stage_int8(torch.from_numpy(xq), *_torch_pack(blocks, s_x, s1, s2),
                                       activation=activation)
    assert got.dtype == torch.int8 and tuple(got.shape) == xq.shape
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_pack_int8_stage_matches_jax():
    _, blocks, s_x, s1, s2 = _stage(3, 1, 4, 4, 64, 3)
    want = jax_pack_int8_stage([{k: jnp.asarray(v) for k, v in bp.items()} for bp in blocks],
                               jnp.float32(s_x), list(map(jnp.float32, s1)),
                               list(map(jnp.float32, s2)))
    got = _torch_pack(blocks, s_x, s1, s2)
    assert len(got) == len(want) == 9
    names = ("w1q", "d1", "b1", "vm1", "w2q", "d2", "b2", "vout", "rres")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.dtype == (torch.int8 if name.startswith("w") else torch.float32), name
        assert g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize(
    "h,c,wins",
    [(208, 64, False), (104, 128, False), (52, 256, False), (26, 512, True),
     (13, 1024, False)],
)
def test_router_gate_on_darknet53_geometries(h, c, wins):
    # only the 26x26x512 stage at 416px takes the fused kernel, at any batch
    assert rk.geometry_wins(h, h, c) is wins
    if not wins:
        assert rk.apply_residual_stage_int8_fused(None, torch.zeros(1, h, h, c, dtype=torch.int8),
                                                  "leaky_relu") is None


def test_router_takes_plain_version_on_cpu():
    # smallest geometry of the class (16x16x512): a CPU tensor is routed to
    # the wrapper, which runs the plain version
    xq, blocks, s_x, s1, s2 = _stage(5, 1, 16, 16, 512, 1)
    ops = _torch_pack(blocks, s_x, s1, s2)
    x = torch.from_numpy(xq)
    got = rk.apply_residual_stage_int8_fused(ops, x, "leaky_relu")
    assert got is not None
    assert torch.equal(got, rk.fused_residual_stage_int8_reference(x, *ops))
    assert torch.equal(x, torch.from_numpy(xq))  # input left unchanged


def test_stage_rejects_unsupported_device():
    # only CPU tensors take the plain version; anything else is the kernel's
    # or an error, never a silent fallback
    _, blocks, s_x, s1, s2 = _stage(1, 1, 4, 4, 64, 1)
    ops = [t.to("meta") for t in _torch_pack(blocks, s_x, s1, s2)]
    with pytest.raises(ValueError, match="unsupported device"):
        rk.fused_residual_stage_int8(torch.zeros(1, 4, 4, 64, dtype=torch.int8, device="meta"),
                                     *ops)


def test_int_mm_is_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, (40, 72)).astype(np.int8)
    b = rng.integers(-127, 128, (72, 24)).astype(np.int8)
    got = rk.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int32) @ b.astype(np.int32))
