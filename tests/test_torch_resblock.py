"""Torch port: fused residual stage (kernel K2's plain version and router)
against the JAX Pallas kernel run in interpret mode.

The shapes are those of tests/test_resblock_kernel.py. Everything is f32 on
the CPU; atol=1e-5, rtol=1e-4 because the two sum the 1x1 and the nine 3x3
taps in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu.ops.pallas.resblock_kernel import (
    fused_residual_stage as jax_fused_residual_stage,
    stack_block_params as jax_stack_block_params,
)
from yolo_for_turbines_tpu_torch.models.yolov3 import PlanResidual, ResidualStage
from yolo_for_turbines_tpu_torch.models.blocks import get_activation
from yolo_for_turbines_tpu_torch.ops.kernels import resblock_kernel as rk

ATOL, RTOL = 1e-5, 1e-4


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _make_stage(n, c, seed=0):
    # the 1x1 weights are scaled to unit gain (unlike the JAX kernel test) so
    # activations stay O(1) over the chained blocks and an f32 tolerance
    # means the same thing at every block
    ch = c // 2
    return (
        _rand((n, 1, 1, c, ch), seed) / np.sqrt(c),
        _rand((n, ch), seed + 1) * 0.1,
        _rand((n, 3, 3, ch, c), seed + 2) * 0.2,
        _rand((n, c), seed + 3) * 0.1,
    )


def _both(x, params, chunk, activation):
    want = jax_fused_residual_stage(
        jnp.asarray(x), *map(jnp.asarray, params), chunk=chunk,
        activation=activation, interpret=True,
    )
    got = rk.fused_residual_stage(
        torch.from_numpy(x), *map(torch.from_numpy, params), activation=activation
    )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_stage_matches_jax_kernel(chunk):
    x = _rand((2, 6, 10, 16), 9)
    got, want = _both(x, _make_stage(4, 16), chunk, "leaky_relu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stage_mish_matches_jax_kernel():
    x = _rand((1, 5, 7, 8), 3)
    got, want = _both(x, _make_stage(2, 8, seed=11), 2, "mish")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_stage_rejects_unsupported_device():
    # only CPU tensors take the plain version; anything else is the kernel's
    # or an error, never a silent fallback
    params = [torch.from_numpy(p).to("meta") for p in _make_stage(1, 64)]
    with pytest.raises(ValueError, match="unsupported device"):
        rk.fused_residual_stage(torch.zeros(1, 4, 4, 64, device="meta"), *params)


def test_stage_leaves_input_unchanged():
    x = torch.from_numpy(_rand((1, 4, 4, 16), 1))
    before = x.clone()
    rk.fused_residual_stage(x, *map(torch.from_numpy, _make_stage(2, 16)))
    assert torch.equal(x, before)


@pytest.mark.parametrize(
    "h,c,wins",
    [(208, 64, False), (104, 128, False), (52, 256, False), (26, 512, True),
     (13, 1024, False)],
)
def test_router_gate_on_darknet53_geometries(h, c, wins):
    # only the 26x26x512 stage at 416px takes the fused kernel, at any batch
    assert rk.geometry_wins(h, h, c) is wins
    assert rk.stage_wins(h, h, c, torch.bfloat16, "cuda") is wins


def test_stack_block_params_matches_jax_layout():
    n, c = 3, 16
    w1s, b1s, w2s, b2s = _make_stage(n, c, seed=4)
    blocks_hwio = [
        {"conv1": {"w": w1s[i], "b": b1s[i]}, "conv2": {"w": w2s[i], "b": b2s[i]}}
        for i in range(n)
    ]
    blocks_oihw = [
        {k: {"w": torch.from_numpy(np.ascontiguousarray(np.transpose(bp[k]["w"], (3, 2, 0, 1)))),
             "b": torch.from_numpy(bp[k]["b"])} for k in ("conv1", "conv2")}
        for bp in blocks_hwio
    ]
    want = jax_stack_block_params(blocks_hwio)
    got = rk.stack_block_params(blocks_oihw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).reshape(n, c, c // 2))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("activation", ["leaky_relu", "mish"])
def test_model_stage_fused_route_matches_layers(activation):
    # smallest geometry the router takes (16x16x512): fused and layer-by-layer
    # paths of the module agree
    torch.manual_seed(0)
    stage = ResidualStage(PlanResidual(channels=512, num_blocks=1))
    with torch.no_grad():
        for blk in stage.blocks:
            for conv in blk.values():
                conv.weight.normal_(0, conv.weight[0].numel() ** -0.5)
                conv.bias.normal_(0, 0.1)
    x = torch.randn(1, 512, 16, 16)
    act = get_activation(activation)
    with torch.inference_mode():
        fused = stage(x, act, activation, fuse=True)
        layers = stage(x, act, activation, fuse=False)
    np.testing.assert_allclose(fused.numpy(), layers.numpy(), rtol=RTOL, atol=ATOL)


# Darknet-53's residual stages: (stride, channels)
_STAGES = ((2, 64), (4, 128), (8, 256), (16, 512), (32, 1024))


def _meta_stage(h, w, c, n=2):
    ch = c // 2

    def t(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")

    return (t(1, h, w, c), t(n, c, ch), t(n, ch, dtype=torch.float32),
            t(n, 3, 3, ch, c), t(n, c, dtype=torch.float32))


@pytest.mark.parametrize("size", range(320, 609, 32))
def test_routed_geometries_pass_the_wrapper_check(size):
    # every stage the router sends to the kernel at this input size passes
    # the wrapper's geometry check; the others raise it
    for stride, c in _STAGES:
        hw = size // stride
        if rk.stage_wins(hw, hw, c, torch.bfloat16, "cuda"):
            assert rk.kernel_takes(hw, hw, c)
            rk._check_cuda_args(*_meta_stage(hw, hw, c), "leaky_relu")
        elif not rk.kernel_takes(hw, hw, c):
            with pytest.raises(ValueError, match="the kernel takes"):
                rk._check_cuda_args(*_meta_stage(hw, hw, c), "leaky_relu")
    routed = [(size // s, c) for s, c in _STAGES
              if rk.stage_wins(size // s, size // s, c, torch.bfloat16, "cuda")]
    assert routed == ([(size // 16, 512)] if size <= 512 else [])


@pytest.mark.parametrize("size", range(320, 609, 32))
def test_router_sends_only_bf16_cuda_stages_to_the_kernel(size):
    # the CUDA kernel is bf16 only: a float32 or float16 stage on CUDA is
    # routed to the layer path at every Darknet-53 stage, a bf16 one where
    # the geometry wins; on the CPU the plain version takes every dtype
    for stride, c in _STAGES:
        hw = size // stride
        geometry = rk.geometry_wins(hw, hw, c)
        assert geometry == (c == 512 and size <= 512)
        assert rk.stage_wins(hw, hw, c, torch.bfloat16, "cuda") is geometry
        for dtype in (torch.float32, torch.float16):
            assert rk.stage_wins(hw, hw, c, dtype, "cuda") is False
            assert rk.stage_wins(hw, hw, c, dtype, "cpu") is geometry


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_direct_call_with_a_non_bf16_cuda_tensor_still_raises(dtype):
    # routing is the router's business; the wrapper itself takes bf16 or raises
    args = list(_meta_stage(26, 26, 512))
    args[0] = args[0].to(dtype)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        rk._check_cuda_args(*args, "leaky_relu")


def _filled_stage(channels, n, dtype):
    torch.manual_seed(1)
    stage = ResidualStage(PlanResidual(channels=channels, num_blocks=n))
    with torch.no_grad():
        for blk in stage.blocks:
            for conv in blk.values():
                conv.weight.normal_(0, 0.05)
                conv.bias.normal_(0, 0.1)
    return stage.to(dtype)


def test_stage_caches_kmajor_weights_equal_to_the_wrappers_transposes():
    stage = _filled_stage(512, 2, torch.bfloat16)
    w1s, b1s, w2s, b2s = stage.stacked()
    w1t, w2t = stage.kmajor()
    assert tuple(w1t.shape) == (2, 256, 512) and tuple(w2t.shape) == (2, 512, 9 * 256)
    assert w1t.is_contiguous() and w2t.is_contiguous() and w1t.dtype == torch.bfloat16
    # what the wrapper makes itself when a caller gives none
    want1, want2 = rk.kmajor_weights(w1s, w2s)
    assert torch.equal(w1t, want1) and torch.equal(w2t, want2)
    assert torch.equal(w1t, w1s.reshape(2, 512, 256).transpose(1, 2))
    assert torch.equal(w2t, w2s.reshape(2, 9 * 256, 512).transpose(1, 2))
    # row o of W2 holds output channel o: tap-major, then input channel
    conv2 = stage.blocks[1]["conv2"].weight  # OIHW
    assert torch.equal(w2t[1, 7].reshape(3, 3, 256), conv2[7].permute(1, 2, 0))
    # cached: the same tensors on the next call
    assert stage.kmajor()[0] is w1t and stage.stacked()[0] is w1s


def test_stage_drops_kmajor_weights_on_to_and_makes_none_it_cannot_use():
    stage = _filled_stage(512, 1, torch.bfloat16)
    first = stage.kmajor()
    assert first is not None
    stage.to(torch.float32)
    assert stage._kmajor is None and stage._stacked is None
    # the kernel takes bf16 and C = 512 only: no copies for anything else
    assert stage.kmajor() is None
    stage.to(torch.bfloat16)
    again = stage.kmajor()
    assert again is not None and again[0] is not first[0] and torch.equal(again[0], first[0])
    assert _filled_stage(64, 1, torch.bfloat16).kmajor() is None


def test_stage_drops_kernel_copies_on_load_state_dict():
    stage = _filled_stage(512, 1, torch.bfloat16)
    old1, old2 = stage.kmajor()
    other = {k: torch.randn_like(v.float()).to(v.dtype) for k, v in stage.state_dict().items()}
    stage.load_state_dict(other)
    assert stage._kmajor is None and stage._stacked is None
    w1s, _, w2s, _ = stage.stacked()
    want1, want2 = rk.kmajor_weights(w1s, w2s)
    new1, new2 = stage.kmajor()
    assert torch.equal(new1, want1) and torch.equal(new2, want2)
    assert not torch.equal(new1, old1) and not torch.equal(new2, old2)


def test_stage_forward_makes_no_kernel_copies_when_not_routed():
    # a call that stays on the layer path (the dtype-free geometry class
    # loses at 8x8) stacks nothing; a routed CPU call stacks but needs no
    # K-major copies, which only the CUDA kernel reads
    stage = _filled_stage(512, 1, torch.float32)
    act = get_activation("leaky_relu")
    with torch.inference_mode():
        stage(torch.zeros(1, 512, 8, 8), act, "leaky_relu", fuse=True)
        assert stage._stacked is None and stage._kmajor is None
        stage(torch.zeros(1, 512, 16, 16), act, "leaky_relu", fuse=True)
    assert stage._stacked is not None and stage._kmajor is None


def test_wrapper_rejects_misshapen_kmajor_weights():
    x, w1s, b1s, w2s, b2s = _meta_stage(16, 16, 512)
    good = (torch.empty(2, 256, 512, dtype=torch.bfloat16, device="meta"),
            torch.empty(2, 512, 9 * 256, dtype=torch.bfloat16, device="meta"))
    rk._check_cuda_args(x, w1s, b1s, w2s, b2s, "leaky_relu", good)
    with pytest.raises(ValueError, match="K-major"):
        rk._check_cuda_args(x, w1s, b1s, w2s, b2s, "leaky_relu",
                            (good[0], good[1].transpose(1, 2)))


@pytest.mark.parametrize("write", ["mul_", "copy_"])
def test_routed_call_serves_weights_written_in_place(write):
    # a stage routed once (its stacked copies made), then one block's 1x1
    # weight doubled in place: the next routed call must serve the new
    # weights, as the layer path does (before the copies were keyed on each
    # weight's storage and version, it returned the old output, 1.47
    # max-abs off the layer path)
    stage = _filled_stage(512, 1, torch.float32)
    act = get_activation("leaky_relu")
    x = torch.from_numpy(_rand((1, 512, 16, 16), 5))
    with torch.inference_mode():
        first = stage(x, act, "leaky_relu", fuse=True)
    assert stage._stacked is not None
    w = stage.blocks[0]["conv1"].weight
    with torch.no_grad():
        if write == "mul_":
            w.mul_(2.0)
        else:
            w.copy_(w * 2.0)
    with torch.inference_mode():
        routed = stage(x, act, "leaky_relu", fuse=True)
        layers = stage(x, act, "leaky_relu", fuse=False)
    assert not torch.allclose(routed, first)
    # the two paths sum 256 and 9 * 256 terms in different orders: measured
    # 1.1e-5 max-abs apart (one element of 131072 past ATOL); the stale
    # copies were 1.47 apart
    np.testing.assert_allclose(routed.numpy(), layers.numpy(), rtol=RTOL, atol=5e-5)


def test_drop_kernel_copies_forgets_a_stage_written_behind_torchs_back():
    # a write that leaves _version as it was (a collective writing the
    # storage directly) is the caller's to report: drop_kernel_copies()
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.models.yolov3 import FoldedYOLOv3

    model = FoldedYOLOv3(ModelConfig(num_classes=2), plan=(PlanResidual(512, 1),))
    stage = model.layers[0]
    stage.stacked()
    assert stage._stacked is not None
    model.drop_kernel_copies()
    assert stage._stacked is None and stage._kmajor is None


def test_routed_call_of_a_stage_made_in_inference_mode():
    # weights made under inference_mode have no version counter: the
    # routed call must still serve them (as the layer path does)
    act = get_activation("leaky_relu")
    x = torch.from_numpy(_rand((1, 512, 16, 16), 6))
    with torch.inference_mode():
        stage = _filled_stage(512, 1, torch.float32)
        routed = stage(x, act, "leaky_relu", fuse=True)
        layers = stage(x, act, "leaky_relu", fuse=False)
    assert stage._stacked is not None
    np.testing.assert_allclose(routed.numpy(), layers.numpy(), rtol=RTOL, atol=5e-5)
