"""Torch port: int8 PTQ (models/quantize.py) of the CSPDarknet-53 and
YOLOv3-tiny families, and of the "requant" concat mode, against the JAX
package.

The mini CSP model, tiny with 2 classes, and two custom layer configs whose
upsample concat feeds a residual stage (the only way to reach "requant":
no built-in family does), all at 64px on the CPU, from calibrated weights
(``torch_eval_weights.py``) folded by the JAX ``fold_params``. Gates:
- calibrated activation scales: the same count, and within 5e-5 relative
  (both take the max of an f32 forward with full-precision convs, summed in
  other orders; the mini CSP model, the deepest and worst conditioned,
  spreads that rounding to 1.1e-5);
- weight codes, weight scales and biases of ``quantize_folded``: equal;
- raw heads of ``apply_inference_int8`` from the same qparams: cosine >
  0.999 per head (the two leaky_relu forms differ by an ulp and can move a
  requant code at a .5 tie, as in tests/test_torch_quantize.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import MINI_CSP_LAYERS
from torch_eval_weights import eval_weights
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.models import quantize as jq
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu_torch.models import quantize as tq
from yolo_for_turbines_tpu_torch.models.convert import qparams_from_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import PlanUpsample, build_plan

SIZE = 64
# calibrated scales, relative: measured up to 1.1e-5 (CSP), 2.6e-6 (tiny)
# and 7.1e-7 (requant)
SCALE_RTOL = 5e-5
HEAD_COS = 0.999

# An upsample concat followed by a residual stage: "S" (no skip) and ("B", 1)
_REQUANT_HEAD = ((8, 3, 1), (16, 3, 2), ("B", 8), (16, 3, 2), ("B", 1), "S", "U")
CONFIGS = {
    "csp": dict(num_classes=2, layer_config=MINI_CSP_LAYERS),
    "tiny": dict(num_classes=2, backbone="yolov3_tiny", strides=(32, 16)),
    "requant_S": dict(num_classes=2, layer_config=_REQUANT_HEAD + ("S",), strides=(4, 2)),
    "requant_B": dict(num_classes=2, layer_config=_REQUANT_HEAD + (("B", 1), "S"),
                      strides=(4, 2)),
}
CASES = [("csp", "leaky_relu"), ("tiny", "mish"), ("tiny", "leaky_relu"),
         ("requant_S", "leaky_relu"), ("requant_B", "mish")]


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _x(n, seed):
    return np.random.default_rng(seed).uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def quantized(request):
    name, activation = request.param
    model = jyolo.YOLOv3(JaxModelConfig(activation=activation, **CONFIGS[name]))
    _, params, stats = eval_weights(seed=7, size=SIZE, model=model)
    folded = jax.tree_util.tree_map(np.asarray, jyolo.fold_params(model.plan, params, stats))
    xc = _x(4, 1)
    qj = jax.tree_util.tree_map(np.asarray, jq.quantize_folded(model.plan, folded, xc,
                                                               activation))
    return name, model, build_plan(model.cfg), folded, xc, qj


def test_requant_configs_reach_requant_mode():
    for name in ("requant_S", "requant_B"):
        plan = build_plan(jyolo.YOLOv3(JaxModelConfig(**CONFIGS[name])).cfg)
        modes = [tq._concat_mode(plan[i + 1]) for i, e in enumerate(plan)
                 if isinstance(e, PlanUpsample)]
        assert modes == ["requant"], name


def test_calibrate_matches_jax(quantized):
    _, model, plan, folded, xc, qj = quantized
    got = tq.calibrate(plan, folded, torch.from_numpy(xc), model.cfg.activation)
    want = jq.calibrate(model.plan, folded, xc, model.cfg.activation)
    assert len(got) == len(want) == qj["scales"].shape[0]
    np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)


def test_quantize_folded_matches_jax(quantized):
    _, model, plan, folded, xc, qj = quantized
    qt = tq.quantize_folded(plan, folded, torch.from_numpy(xc), model.cfg.activation)
    want = qparams_from_numpy(plan, qj, "cpu")
    assert jax.tree_util.tree_structure(qt["layers"]) \
        == jax.tree_util.tree_structure(want["layers"])
    for g, w in zip(jax.tree_util.tree_leaves(qt["layers"]),
                    jax.tree_util.tree_leaves(want["layers"])):
        assert g.dtype == w.dtype and torch.equal(g, w)
    np.testing.assert_allclose(qt["scales"].numpy(), want["scales"].numpy(),
                               rtol=SCALE_RTOL, atol=0)


def test_apply_inference_int8_matches_jax(quantized):
    _, model, plan, _, _, qj = quantized
    x = _x(2, 2)
    want = jq.apply_inference_int8(model.plan, qj, x, activation=model.cfg.activation,
                                   raw_heads=True, compute_dtype=jnp.float32, portable=True)
    trunk = []
    got = tq.apply_inference_int8(plan, qparams_from_numpy(plan, qj, "cpu"),
                                  torch.from_numpy(x), activation=model.cfg.activation,
                                  raw_heads=True, compute_dtype=torch.float32,
                                  head_inputs=trunk)
    assert len(got) == len(want) == len(model.cfg.strides) == len(trunk)
    for g, w, t in zip(got, want, trunk):
        assert tuple(g.shape) == np.asarray(w).shape and g.dtype == torch.float32
        assert all(a.dtype == torch.int8 for a in t)
        assert _cos(g.numpy(), w) > HEAD_COS


@pytest.mark.parametrize("quantized", [("csp", "leaky_relu")], indirect=True,
                         ids=["csp-leaky_relu"])
def test_qparams_from_numpy_checks_csp_shapes(quantized):
    _, _, plan, _, _, qj = quantized
    i = next(i for i, layer in enumerate(qj["layers"]) if "fuse" in layer)
    bad = {"layers": list(qj["layers"]), "scales": qj["scales"]}
    bad["layers"][i] = dict(bad["layers"][i], fuse=dict(bad["layers"][i]["fuse"],
                                                        wq=bad["layers"][i]["fuse"]["wq"][..., :1]))
    with pytest.raises(ValueError, match="plan says"):
        qparams_from_numpy(plan, bad, "cpu")
