"""Torch port: the algorithm of the redesigned greedy-NMS kernel (K1,
``csrc/nms.cu``), emulated on the CPU (``tests/k1_sweep.py``: 32-bit suppress
words above the diagonal, a sweep that visits only set bits), against the
port's plain version and the JAX Pallas kernel in interpret mode; and
``batched_nms`` beyond 1024 candidates against the JAX ``batched_nms``.

Inputs are numpy-seeded with distinct scores. Tolerance: masks (and boxes)
equal. All three repeat the same f32 operations in the same order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k1_sweep import emulate_greedy_nms
from yolo_for_turbines_tpu.ops import nms as jnms
from yolo_for_turbines_tpu_torch.ops import nms as tnms
from yolo_for_turbines_tpu_torch.ops.kernels import nms_kernel

THR = 0.45


def _cands(k, b, seed, classes=3):
    """(B, K, 6) candidates sorted by descending distinct scores, (B, K) valid
    with the tail of each image invalid."""
    rng = np.random.default_rng(seed)
    cand = np.zeros((b, k, 6), np.float32)
    cand[..., 0:2] = rng.uniform(0.2, 0.8, (b, k, 2))
    cand[..., 2:4] = rng.uniform(0.05, 0.4, (b, k, 2))
    cand[..., 4] = np.sort(rng.permutation(b * k).reshape(b, k) + 0.5, axis=1)[:, ::-1] / (b * k)
    cand[..., 5] = rng.integers(0, classes, (b, k))
    valid = np.arange(k)[None, :] < np.maximum(1, k - rng.integers(0, k // 4 + 1, (b, 1)))
    return torch.from_numpy(cand), torch.from_numpy(valid)


def _pallas_interpret(cand, valid, thr, box_format):
    from jax.experimental import pallas as pl

    from yolo_for_turbines_tpu.ops.pallas import nms_kernel as jkernel

    orig = pl.pallas_call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(orig, interpret=True))
        return np.asarray(jkernel.greedy_nms_pallas.__wrapped__(
            jnp.asarray(cand.numpy()), jnp.asarray(valid.numpy()), thr, box_format=box_format))


@pytest.mark.parametrize("box_format", ["center", "corners"])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 100, 256])
def test_emulation_matches_plain_and_pallas(k, box_format):
    cand, valid = _cands(k, 3, seed=k)
    got = emulate_greedy_nms(cand, valid, THR, box_format)
    want = nms_kernel.greedy_nms_reference(cand, valid, THR, box_format)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _pallas_interpret(cand, valid, THR, box_format))
    if k >= 100:  # the inputs exercise suppression, not only validity
        assert 0 < int(got.sum()) < int(valid.sum())


@pytest.mark.parametrize("k", [100, 256])
def test_emulation_single_image(k):
    cand, valid = _cands(k, 1, seed=7 * k)
    got = emulate_greedy_nms(cand, valid, THR)
    assert torch.equal(got, nms_kernel.greedy_nms_reference(cand, valid, THR))
    np.testing.assert_array_equal(got.numpy(), _pallas_interpret(cand, valid, THR, "center"))


def test_emulation_all_invalid():
    cand, valid = _cands(100, 3, seed=1)
    valid = torch.zeros_like(valid)
    got = emulate_greedy_nms(cand, valid, THR)
    assert not got.any()
    assert torch.equal(got, nms_kernel.greedy_nms_reference(cand, valid, THR))
    np.testing.assert_array_equal(got.numpy(), _pallas_interpret(cand, valid, THR, "center"))


def _chain(k, b):
    """One class, boxes marching right by a hundredth of their width: each
    kept box clears a long run, and cleared boxes must clear nothing."""
    cand = np.zeros((b, k, 6), np.float32)
    cand[..., 0] = 0.2 + 0.002 * np.arange(k)[None, :] * (1 + np.arange(b)[:, None])
    cand[..., 1] = 0.5
    cand[..., 2:4] = 0.2
    cand[..., 4] = 1.0 - np.arange(k)[None, :] / (2.0 * k)
    return torch.from_numpy(cand), torch.ones(b, k, dtype=torch.bool)


@pytest.mark.parametrize("k", [100, 256])
def test_emulation_one_class_chains(k):
    cand, valid = _chain(k, 3)
    got = emulate_greedy_nms(cand, valid, THR)
    want = nms_kernel.greedy_nms_reference(cand, valid, THR)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _pallas_interpret(cand, valid, THR, "center"))
    # a chain: far fewer kept than valid, and more than one
    assert 1 < int(got[0].sum()) < k // 8


def test_emulation_nan_box_clears_nothing():
    cand, valid = _cands(100, 2, seed=3)
    cand[0, 5, 2] = float("nan")
    cand[1, 0, 0] = float("nan")
    got = emulate_greedy_nms(cand, valid, THR)
    assert torch.equal(got, nms_kernel.greedy_nms_reference(cand, valid, THR))
    assert bool(got[0, 5]) and bool(got[1, 0])  # nothing clears a NaN box either


@pytest.mark.parametrize("box_format", ["center", "corners"])
def test_batched_nms_beyond_1024_matches_jax(box_format):
    # max_boxes = 1500 of N = 2000: more candidates than one CTA of the CUDA
    # kernel sweeps from shared memory (its two-launch path on the card)
    b, n = 2, 2000
    rng = np.random.default_rng(11)
    boxes = np.zeros((b, n, 6), np.float32)
    boxes[..., 0:2] = rng.uniform(0.1, 0.9, (b, n, 2))
    boxes[..., 2:4] = rng.uniform(0.03, 0.3, (b, n, 2))
    boxes[..., 4] = (rng.permutation(b * n).reshape(b, n) + 0.5) / (b * n)
    boxes[..., 5] = rng.integers(0, 3, (b, n))
    kept_j, keep_j = jnms.batched_nms(boxes, THR, 0.1, max_boxes=1500, box_format=box_format)
    kept_t, keep_t = tnms.batched_nms(torch.from_numpy(boxes), THR, 0.1, max_boxes=1500,
                                      box_format=box_format)
    assert tuple(keep_t.shape) == (b, 1500) > (b, nms_kernel.FUSED_MAX_K)
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))


def test_wrapper_has_no_candidate_limit():
    # the K > 1024 ValueError of the first kernel is gone; on the CPU any K
    # takes the plain version
    assert not hasattr(nms_kernel, "MAX_K")
    cand, valid = _cands(1100, 1, seed=5)
    got = nms_kernel.greedy_nms(cand, valid, THR)
    assert tuple(got.shape) == (1, 1100)
    assert torch.equal(got, emulate_greedy_nms(cand, valid, THR))
