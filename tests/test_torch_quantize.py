"""Torch port: int8 PTQ (models/quantize.py) against the JAX package.

Mini model (tests/helpers.py) at 64px, float32 heads, on the CPU. Tolerances:
- weight codes and scales (``_wq``, ``quantize_folded``) and the i32 conv
  products are exact: the same numpy code and integer arithmetic;
- calibrated activation scales within rtol 1e-5: both frameworks run the f32
  forward with full-precision convs (TF32 off, ``Precision.HIGHEST``) but
  sum in different orders;
- raw heads of ``apply_inference_int8`` from the same qparams: cosine > 0.999
  per head, the bound of tests/test_resblock_int8_kernel.py. The port's
  leaky_relu is ``F.leaky_relu`` and the JAX package's the algebraic
  0.55x + 0.45|x|; they differ by about one f32 ulp, which can flip a requant
  code at a .5 tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import mini_model
from yolo_for_turbines_tpu.models import quantize as jq
from yolo_for_turbines_tpu_torch.models import quantize as tq
from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import build_plan

SIZE = 64


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _x(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=["leaky_relu", "mish"])
def quantized(request):
    model = mini_model(activation=request.param)
    params, stats = model.init(jax.random.PRNGKey(3))
    folded = jax.tree_util.tree_map(np.asarray, model.fold(params, stats))
    xc = _x(4, 1)
    qj = jax.tree_util.tree_map(np.asarray, jq.quantize_folded(
        model.plan, folded, xc, request.param))
    plan = build_plan(model.cfg)
    return model, plan, folded, xc, qj


@pytest.mark.parametrize("shape", [(3, 3, 3, 32), (1, 1, 64, 32), (3, 3, 16, 24)])
def test_wq_matches_jax(shape):
    w = np.random.default_rng(0).normal(0, 0.3, shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 scale floor
    wq_j, s_j = jq._wq(w)
    wq_t, s_t = tq._wq(w)
    assert wq_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_calibrate_matches_jax(quantized):
    model, plan, folded, xc, qj = quantized
    got = tq.calibrate(plan, folded, torch.from_numpy(xc), model.cfg.activation)
    want = jq.calibrate(model.plan, folded, xc, model.cfg.activation)
    assert len(got) == len(want) == qj["scales"].shape[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_quantize_folded_weights_match_jax(quantized):
    model, plan, folded, xc, qj = quantized
    qt = tq.quantize_folded(plan, folded, torch.from_numpy(xc), model.cfg.activation)
    want = qparams_from_numpy(plan, qj, "cpu")
    for got_layer, want_layer in zip(qt["layers"], want["layers"]):
        got_leaves = jax.tree_util.tree_leaves(got_layer)
        want_leaves = jax.tree_util.tree_leaves(want_layer)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
    np.testing.assert_allclose(qt["scales"].numpy(), want["scales"].numpy(), rtol=1e-5, atol=0)


def test_qparams_from_numpy_types_and_shapes(quantized):
    _, plan, _, _, qj = quantized
    qp = qparams_from_numpy(plan, qj, "cpu")
    conv = qp["layers"][0]
    assert conv["wq"].dtype == torch.int8 and tuple(conv["wq"].shape) == (3, 3, 3, 4)
    assert conv["sw"].dtype == torch.float32 and conv["b"].dtype == torch.float32
    assert qp["scales"].dtype == torch.float32 and qp["scales"].dim() == 1
    bad = {"layers": list(qj["layers"]), "scales": qj["scales"]}
    bad["layers"][0] = dict(bad["layers"][0], wq=bad["layers"][0]["wq"][:, :, :, :2])
    with pytest.raises(ValueError, match="plan says"):
        qparams_from_numpy(plan, bad, "cpu")


@pytest.mark.parametrize("kernel,stride,cin", [(1, 1, 16), (3, 1, 8), (3, 2, 3), (3, 2, 16)])
def test_conv_i8_matches_jax(kernel, stride, cin):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.integers(-127, 128, (2, 9, 10, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (kernel, kernel, cin, 24)).astype(np.int8)
    pad = 1 if kernel == 3 else 0
    want = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(w), stride, pad))
    got = tq._conv_i8(torch.from_numpy(x), tq._wmat(torch.from_numpy(w)), kernel, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_inference_int8_matches_jax(quantized):
    model, plan, _, _, qj = quantized
    x = _x(2, 2)
    want = jq.apply_inference_int8(model.plan, qj, x, activation=model.cfg.activation,
                                   raw_heads=True, compute_dtype=jnp.float32, portable=True)
    got = tq.apply_inference_int8(plan, qparams_from_numpy(plan, qj, "cpu"),
                                  torch.from_numpy(x), activation=model.cfg.activation,
                                  raw_heads=True, compute_dtype=torch.float32)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32
        assert _cos(g.numpy(), w) > 0.999


@pytest.fixture(scope="module")
def wide_stage():
    """A plan with one 512-channel residual stage at half the input size,
    quantized from seeded weights on the CPU."""
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.models.yolov3 import init_plan

    cfg = ModelConfig(num_classes=2,
                      layer_config=((8, 3, 1), (512, 3, 2), ("B", 1), (16, 1, 1), "S"))
    plan = build_plan(cfg)
    tree = init_plan(plan, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).uniform(size=(1, 32, 32, 3)).astype(np.float32))
    return plan, tq.quantize_folded(plan, tree, x, "leaky_relu")


# the stage is (size/2)^2 x 512: K4's class is 16^2 <= h*w <= 32^2
@pytest.mark.parametrize("size,routed", [(16, False), (32, True), (64, True), (128, False)])
def test_pack_int8_packs_k4_operands_only_where_routed(wide_stage, size, routed):
    # K4's operands are packed for the C = 512 stage whatever the image size
    # (pack_int8 no longer takes one); whether a call is routed to the fused
    # stage is decided on the call's own shape
    from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk

    plan, qp = wide_stage
    packed = tq.pack_int8(plan, qp, torch.float32)
    stage = packed[3]  # packed[0] is the input scale
    assert stage["stage"] is not None and stage["stage_kmajor"] is not None
    # the narrow stem convs carry no fused operands
    assert all("stage" not in q for q in packed[1:3])
    w1t, w2t = stage["stage_kmajor"]
    w1q, w2q = stage["stage"][0], stage["stage"][4]
    assert tuple(w1t.shape) == (1, 256, 512) and tuple(w2t.shape) == (1, 512, 9 * 256)
    assert w1t.is_contiguous() and w2t.is_contiguous()
    assert torch.equal(w1t, w1q.transpose(1, 2))
    assert torch.equal(w2t, w2q.reshape(1, 9 * 256, 512).transpose(1, 2))
    # the layer path's weights are views of the quantized tree, not copies
    want = qp["layers"][2]["blocks"][0]
    got = stage["blocks"][0]
    assert got["w1"].data_ptr() == want["w1q"].data_ptr()
    assert got["w2"].data_ptr() == want["w2q"].data_ptr()
    # the call at this size is routed, or stays on the layer path
    xq = torch.zeros(1, size // 2, size // 2, 512, dtype=torch.int8)
    fused = rk.apply_residual_stage_int8_fused(stage["stage"], xq, "leaky_relu",
                                               kmajor=stage["stage_kmajor"])
    assert (fused is not None) == routed == rk.geometry_wins(size // 2, size // 2, 512)


@pytest.mark.parametrize("built,called", [(16, 32), (32, 16), (128, 64), (64, 128)])
def test_int8_codes_do_not_depend_on_the_size_a_predictor_was_built_for(
        wide_stage, built, called, monkeypatch):
    # a predictor made for one image size and called at another gives, bit
    # for bit, the trunk codes and heads of one made for the called size:
    # the fused stage multiplies by reciprocals where the layer path divides,
    # so routing fixed at build time would change the codes
    from yolo_for_turbines_tpu_torch.config import ModelConfig
    from yolo_for_turbines_tpu_torch.inference import Predictor
    from yolo_for_turbines_tpu_torch.models.yolov3 import FoldedYOLOv3
    from yolo_for_turbines_tpu_torch.ops.kernels import resblock_int8_kernel as rk

    plan, qp = wide_stage
    cfg = ModelConfig(num_classes=2,
                      layer_config=((8, 3, 1), (512, 3, 2), ("B", 1), (16, 1, 1), "S"))
    routed = []  # per forward: did the router take the fused stage

    def spy(*args, **kwargs):
        fused = rk.apply_residual_stage_int8_fused(*args, **kwargs)
        routed.append(fused is not None)
        return fused

    monkeypatch.setattr(tq, "apply_residual_stage_int8_fused", spy)
    x = torch.from_numpy(
        np.random.default_rng(called).uniform(size=(2, called, called, 3)).astype(np.float32))
    heads, trunks = [], []
    for size in (built, called):
        pred = Predictor(FoldedYOLOv3(cfg, plan), device="cpu", image_size=size)
        pred.set_qparams(qp)
        heads.append(pred.raw_heads(x))
        trunk = []
        tq.apply_inference_int8(plan, qp, x, compute_dtype=torch.float32, raw_heads=True,
                                packed=pred._packed, head_inputs=trunk)
        trunks.append(trunk)
    for a, b in zip(*heads):
        assert torch.equal(a, b)
    for a, b in zip(*trunks):
        assert len(a) == len(b) == 1 and torch.equal(a[0], b[0])
    # both took the same route, the one of the called size
    assert routed == [rk.geometry_wins(called // 2, called // 2, 512)] * 4


def test_apply_inference_int8_reports_head_inputs(quantized):
    # head_inputs receives the s8 trunk tensors each head reads and changes
    # nothing; the heads are those tensors dequantized and run through the
    # head convs
    model, plan, _, _, qj = quantized
    qp = qparams_from_numpy(plan, qj, "cpu")
    x = torch.from_numpy(_x(2, 5))
    kw = {"activation": model.cfg.activation, "compute_dtype": torch.float32, "raw_heads": True}
    trunk = []
    got = tq.apply_inference_int8(plan, qp, x, head_inputs=trunk, **kw)
    want = tq.apply_inference_int8(plan, qp, x, **kw)
    assert len(trunk) == len(got) == 3
    for t, g, w in zip(trunk, got, want):
        assert torch.equal(g, w)
        assert len(t) == 1 and t[0].dtype == torch.int8
        assert tuple(t[0].shape[:3]) == tuple(g.shape[:3])


def test_apply_inference_int8_head_layout(quantized):
    # raw_heads=False gives (B, A, S, S, 5+C) f32, the raw NHWC heads reshaped
    model, plan, _, _, qj = quantized
    qp = qparams_from_numpy(plan, qj, "cpu")
    x = torch.from_numpy(_x(1, 4))
    kw = {"activation": model.cfg.activation, "compute_dtype": torch.float32}
    raw = tq.apply_inference_int8(plan, qp, x, raw_heads=True, **kw)
    shaped = tq.apply_inference_int8(plan, qp, x, **kw)
    for r, s in zip(raw, shaped):
        b, h, w, _ = r.shape
        assert tuple(s.shape) == (b, 3, h, w, 7)
        assert torch.equal(s, r.reshape(b, h, w, 3, 7).permute(0, 3, 1, 2, 4))
