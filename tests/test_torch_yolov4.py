"""YOLOv4 in the port against the benchmark's plain reference
(``perfbench/reference/yolov4.py``, which imports nothing of the port), on
the CPU at a small size: the published layer list (``YOLOV4_LAYER_CONFIG``,
the configuration file's list) with every width divided by 16, a 96px
input and 3 classes, on seeded weights calibrated as the benchmark's
(``perfbench/weights_yolov4.py``). The published size is checked by shape
alone, on the meta device."""

import json

import numpy as np
import pytest
import torch

from perfbench.drivers import offline_yolov4
from perfbench.manifest import HERE
from perfbench.reference import model as ref
from perfbench.reference import postprocess as post
from perfbench.reference import yolov4 as v4
from perfbench import traffic, weights_yolov4
from helpers import concat_routes, conv_inputs_channels_last
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models import blocks
from yolo_for_turbines_tpu_torch.models.blocks import FoldedConv
from yolo_for_turbines_tpu_torch.models.convert import folded_from_numpy
from yolo_for_turbines_tpu_torch.models.cspdarknet import PlanCSP
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    YOLOV4_LAYER_CONFIG,
    FoldedYOLOv3,
    PlanConv,
    PlanJoin,
    PlanLateral,
    PlanSPP,
    PlanSave,
    PlanUpsample,
    YOLOv3,
    build_plan,
)
from yolo_for_turbines_tpu_torch.ops.decode import decode_raw_scale
from yolo_for_turbines_tpu_torch.ops.kernels import maxpool_kernel
from yolo_for_turbines_tpu_torch.utils import profiling

SIZE, CLASSES, DIV = 96, 3, 16


def published():
    return json.loads((HERE / "configs" / "yolov4-coco608.json").read_text())


def small_layers(layers):
    """Every width of the list divided by ``DIV``."""
    out = []
    for item in layers:
        item = list(item) if isinstance(item, (list, tuple)) else item
        if not isinstance(item[0], str):
            out.append([item[0] // DIV, item[1], item[2]])
        elif item[0] == "lateral":
            out.append([item[0], item[1], item[2] // DIV])
        else:
            out.append(item)
    return out


def small_cfg():
    return {**published(), "layers": small_layers(published()["layers"]),
            "num_classes": CLASSES, "image_size": SIZE}


def model_cfg(bench_cfg):
    layers = tuple(tuple(x) if isinstance(x, list) else x for x in bench_cfg["layers"])
    return ModelConfig(num_classes=bench_cfg["num_classes"], activation="mish",
                       strides=(8, 16, 32), layer_config=layers)


@pytest.fixture(scope="module")
def small():
    """(bench cfg, reference plan, reference tree, images): weights
    calibrated on the images, as the cell makes them."""
    c = small_cfg()
    x = traffic.device_images(torch.Generator().manual_seed(3), 4, SIZE, "cpu")
    plan, tree = weights_yolov4.folded(c, 11, x)
    return c, plan, tree, x


def _predictor(c, tree):
    return Predictor.from_folded(model_cfg(c), offline_yolov4.numpy_tree(tree), device="cpu",
                                 anchors=c["anchors"], image_size=SIZE,
                                 compute_dtype=torch.float32)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_published_list_is_the_configuration_files():
    assert [list(x) if isinstance(x, tuple) else x for x in YOLOV4_LAYER_CONFIG] \
        == published()["layers"]
    assert build_plan(ModelConfig(backbone="yolov4")) == build_plan(model_cfg(published()))
    assert cfg.strides_for("yolov4") == (8, 16, 32)
    assert np.allclose(np.asarray(cfg.YOLOV4_ANCHORS), published()["anchors"])


def test_published_size_by_shape_and_operations():
    """110 convs, heads of 255 channels at 76 / 38 / 19 for 608px (the
    port's forward on the meta device, which computes shapes alone), and
    128.39 GFLOP by the reference's table, within 0.1% of darknet's
    128.459."""
    c = published()
    model = FoldedYOLOv3(model_cfg(c)).to("meta")
    assert sum(isinstance(m, FoldedConv) for m in model.modules()) == 110
    heads = model(torch.empty(1, 608, 608, 3, device="meta"))
    assert [tuple(h.shape) for h in heads] == [(1, s, s, 255) for s in (76, 38, 19)]
    table = v4.conv_table(c, 608)
    assert len(table) == 110
    flops = v4.forward_flops(c, 608)
    assert flops == pytest.approx(128.39e9, rel=1e-4)
    assert flops == pytest.approx(128.459e9, rel=1e-3)
    assert c["published_gflop_per_image"] == pytest.approx(flops / 1e9, rel=1e-3)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_folded_heads_match_the_reference(small, seed):
    """Float32 on both sides, the same weights and images: only the order of
    f32 roundings differs. Each side's own heads lie 5e-6 to 4.2e-5
    (relative RMS) from a float64 witness of the reference (4 seeds; the
    CSP stages amplify rounding), the two 3.9e-6 to 1.3e-5 apart: 1e-4."""
    c, plan, tree, x = small
    if seed != 11:
        plan, tree = weights_yolov4.folded(c, seed, x)
    got = _predictor(c, tree).raw_heads(x)
    want = v4.folded_forward(plan, tree, x, c["activation"])
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, w) < 1e-4
        assert float(w.reshape(-1, w.shape[-1]).std(0).min()) > 1e-2  # not mere biases


@torch.no_grad()
def test_trainable_eval_matches_its_own_fold():
    """``YOLOv3(...).eval()`` against ``fold()`` served by ``FoldedYOLOv3``:
    BN with running statistics from one train-mode pass, scale U(0.5, 1.5)
    and shift N(0, 0.5). The eval-mode module's own f32 heads lie 5.7e-5 to
    2.8e-4 (relative RMS) from its float64 twin, normalised on one small
    batch's statistics; the fold, rounded once more per conv, 7.4e-5 to
    4.0e-4 from it (4 seeds): 2e-3."""
    mc = model_cfg(small_cfg())
    model = YOLOv3(mc, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.weight.copy_(torch.rand(bn.num_features, generator=gen) + 0.5)
        bn.bias.copy_(0.5 * torch.randn(bn.num_features, generator=gen))
        bn.reset_running_stats()
        bn.momentum = None
    x = traffic.device_images(torch.Generator().manual_seed(7), 4, SIZE, "cpu")
    model.train()(x)
    want = model.eval()(x)
    got = FoldedYOLOv3(mc)
    got = folded_from_numpy(got.plan, model.fold(), mc)(x)
    for g, w in zip(got, want):
        b, a, s, _, k = w.shape
        w = w.permute(0, 2, 3, 1, 4).reshape(b, s, s, a * k)
        assert rel(g, w) < 2e-3
        assert float(w.std()) > 1e-2


@pytest.mark.parametrize("alpha", [1.2, 1.1, 1.05])
def test_grid_sensitive_decode_matches_the_reference(alpha):
    """The centres, scores and classes by the same f32 operations in the
    same order: the same bits; the sizes from anchors scaled to cells and
    back (the program's) or not (the reference's): 1e-6 relative."""
    gen = torch.Generator().manual_seed(int(alpha * 100))
    s, anchors = 6, [[0.1, 0.2], [0.3, 0.25], [0.5, 0.6]]
    raw = 3 * torch.randn(2, s, s, 3 * (5 + CLASSES), generator=gen)
    got = decode_raw_scale(raw, torch.tensor(anchors) * s, s, CLASSES, alpha)
    want = v4.decode([raw], [anchors], CLASSES, [alpha])
    assert torch.equal(got[..., [0, 1, 4, 5]], want[..., [0, 1, 4, 5]])
    assert torch.allclose(got[..., 2:4], want[..., 2:4], rtol=1e-6, atol=0)
    # offsets reach (alpha - 1) / 2 past the cell on both sides
    off = got[..., 0] * s - torch.arange(s).repeat_interleave(3).repeat(s)[None]
    assert float(off.min()) < 0 and float(off.max()) > 1


def test_scale_one_is_bitwise_yolov3s_decode():
    """At scale_xy 1.0 the decode runs YOLOv3's operations (the ones below,
    as before the grid-sensitive decode was added): the same bits."""
    gen = torch.Generator().manual_seed(1)
    s, a, n = 13, 3, 5 + CLASSES
    raw = 3 * torch.randn(2, s, s, a * n, generator=gen).bfloat16()
    anchors = torch.tensor([[0.1, 0.2], [0.3, 0.25], [0.5, 0.6]]) * s
    y = raw.reshape(2, s, s, a, n)
    ar = torch.arange(s, dtype=torch.float32)
    box = y[..., 0:5].float()
    cx = (torch.sigmoid(box[..., 0:1]) + ar[None, None, :, None, None]) / s
    cy = (torch.sigmoid(box[..., 1:2]) + ar[None, :, None, None, None]) / s
    wh = torch.exp(box[..., 2:4]) * anchors.to(raw.dtype).float().reshape(1, 1, 1, a, 2) / s
    want = torch.cat([cx, cy, wh, torch.sigmoid(box[..., 4:5]),
                      torch.argmax(y[..., 5:], dim=-1)[..., None].float()], -1)
    got = decode_raw_scale(raw, anchors, s, CLASSES)
    assert torch.equal(got, want.reshape(2, s * s * a, 6))
    assert torch.equal(decode_raw_scale(raw, anchors, s, CLASSES, 1.0), got)


def test_predict_batch_boxes_match_the_reference(small):
    """The kept boxes of ``predict_batch`` against the reference's decode
    (each scale's scale_xy) and NMS of the same heads: every box has a
    partner (``reference/postprocess.py::mismatch``)."""
    c, plan, tree, x = small
    pred = _predictor(c, tree)
    assert pred.scale_xy == (1.2, 1.1, 1.05)
    heads = pred.raw_heads(x)
    kept, mask = pred.predict_batch(x)
    rows = v4.decode(heads, c["anchors"], CLASSES, v4.scale_xy(plan))
    want = post.kept_rows(*post.nms(rows, c["conf_threshold"], c["nms_iou_threshold"],
                                    c["max_boxes"]))
    bad, total = post.mismatch(post.kept_rows(kept, mask), want)
    assert total > 0 and bad == 0


def _reckoned_concat_bytes(plan, side: int, batch: int, itemsize: int = 4) -> int:
    """Bytes of every channel concat of a walk, from the plan alone."""
    total, c, named = 0, plan[0].in_ch, {}
    for e in plan:
        if isinstance(e, PlanConv):
            side, c = (side - 1) // e.stride + 1, e.out_ch
        elif isinstance(e, PlanCSP):
            total += 2 * e.branch_ch * side * side
        elif isinstance(e, PlanSPP):
            c *= len(e.kernels) + 1
            total += c * side * side
        elif isinstance(e, PlanSave):
            named[e.name] = c
        elif isinstance(e, PlanLateral):
            side, c = 2 * side, c + e.out_ch
            total += c * side * side
        elif isinstance(e, PlanJoin):
            c += named[e.route]
            total += c * side * side
        elif isinstance(e, PlanUpsample):
            raise AssertionError("no LIFO upsample in YOLOv4")
    return total * batch * itemsize


def _reckoned_copied_bytes(plan, side: int, batch: int, itemsize: int = 4) -> int:
    """Bytes the concats copy when they are written in place off the card:
    SPP's pyramid (aten's pools and their ``torch.cat`` there), the
    upsampled halves and the saved routes; K5 stores every other part."""
    total, c, named = 0, plan[0].in_ch, {}
    for e in plan:
        if isinstance(e, PlanConv):
            side, c = (side - 1) // e.stride + 1, e.out_ch
        elif isinstance(e, PlanSPP):
            c *= len(e.kernels) + 1
            total += c * side * side
        elif isinstance(e, PlanSave):
            named[e.name] = c
        elif isinstance(e, PlanLateral):
            total += c * 4 * side * side
            side, c = 2 * side, c + e.out_ch
        elif isinstance(e, PlanJoin):
            total += named[e.route] * side * side
            c += named[e.route]
    return total * batch * itemsize


def test_concats_written_in_place_give_the_same_heads(small):
    """The card's route on the CPU (every folded conv through K5's plain
    version, every concat a buffer its parts are written into): the heads
    equal the ``torch.cat`` route's bit for bit; the bytes copied in and
    the bytes K5 stored add up to every concat's, and K5 stores all but
    SPP's pyramid, the upsampled halves and the saved routes."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    (got, copied, stored), (want, cat_copied, cat_stored) = concat_routes(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    total = _reckoned_concat_bytes(model.plan, SIZE, 4)
    assert (cat_copied, cat_stored) == (total, 0)
    assert copied + stored == total
    assert copied == _reckoned_copied_bytes(model.plan, SIZE, 4)


def test_every_conv_takes_channels_last_input_with_the_concats_in_place(small, monkeypatch):
    """On the card's route the fuse convs read the concat buffers, the
    convs after a lateral or a join too: all channels_last."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    monkeypatch.setattr(blocks, "epilogue_wins", lambda t, act, skip=None: True)
    monkeypatch.setattr(profiling, "concat_in_place_bytes", 0)
    seen = conv_inputs_channels_last(model, x)
    assert len(seen) == 110 and all(seen) and profiling.concat_in_place_bytes > 0


def test_spans_once_per_forward_and_the_concat_counter(small):
    """Under a profiler the forward opens ``forward.backbone``,
    ``forward.spp`` and ``forward.neck`` once each, one after the other,
    and SPP's pyramid ``forward.pool`` inside ``forward.spp``; the counter
    grows by the bytes the plan's concats write."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    before = profiling.concat_bytes
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profiling.time.perf_counter()
        model(x)
    opened = profiling.spans(since=t0)
    names = [s.name for s in opened]
    assert names == ["forward.backbone", "forward.spp", "forward.pool", "forward.neck"]
    assert opened[2].parent == opened[1].id
    assert profiling.concat_bytes - before == _reckoned_concat_bytes(model.plan, SIZE, 4)


def test_darknet53_forward_opens_no_span():
    from helpers import mini_model

    model = FoldedYOLOv3(mini_model(2).cfg)
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profiling.time.perf_counter()
        model(torch.rand(1, 64, 64, 3))
    assert not [s for s in profiling.spans(since=t0) if s.name.startswith("forward.")]
    assert len(model._parts) == 1 and model._parts[0][0] is None


def test_every_conv_takes_channels_last_input(small):
    """What routes each conv to K5 on the card besides bf16 and CUDA: the
    concats, pools and upsamples keep the input's channels_last memory."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].is_contiguous(memory_format=torch.channels_last)))
        for m in model.modules() if isinstance(m, FoldedConv)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == 110 and all(seen)


@pytest.mark.parametrize("k", [5, 9, 13])
def test_odd_same_pool_is_the_padded_pool_and_keeps_channels_last(k):
    """SPP's pools, as the pyramid's plain version and the CPU route take
    them, and ``maxpool2d``'s SAME pool: the pool over an explicit -inf
    pad, stored channels_last."""
    x = torch.randn(2, 8, 11, 11).contiguous(memory_format=torch.channels_last)
    p = k // 2
    want = torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(x, (p, p, p, p), value=float("-inf")), k, 1)
    for got in (maxpool_kernel.maxpool_pyramid_reference(x, (k,)),
                blocks.maxpool_pyramid(x, (k,)), blocks.maxpool2d(x, k, 1)):
        assert torch.equal(got, want) and got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("what", ["quantize", "layout", "darknet", "train"])
def test_what_yolov4_does_not_take_raises(small, what, tmp_path):
    c, plan, tree, x = small
    if what == "quantize":
        with pytest.raises(ValueError, match="YOLOv4"):
            _predictor(c, tree).quantize(x)
    elif what == "layout":
        with pytest.raises(ValueError, match="YOLOv4"):
            _predictor(c, tree).model(x, layout=object())
    elif what == "darknet":
        from yolo_for_turbines_tpu_torch.models.darknet_weights import load_darknet_into

        with pytest.raises(ValueError, match="YOLOv4"):
            load_darknet_into(str(tmp_path / "yolov4.weights"), YOLOv3(model_cfg(c)))
    else:
        from yolo_for_turbines_tpu_torch.config import TrainConfig
        from yolo_for_turbines_tpu_torch.train.trainer import Trainer

        with pytest.raises(ValueError, match="YOLOv4"):
            Trainer(TrainConfig(), model_cfg=model_cfg(c), device="cpu")


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect

    for module in (v4, weights_yolov4, ref):
        tree = ast.parse(inspect.getsource(module))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith(("yolo_for_turbines", "jax"))]


def _tiny_bench(tmp_path):
    """The real BENCHMARK.json with the YOLOv4 configuration cut to the
    small size and the new cells' mixes to a few tiny batches, the first
    of which is checked (a window always makes it, however slow the
    host)."""
    from perfbench.manifest import Bench

    real = Bench.load(HERE.parent / "BENCHMARK.json")
    (tmp_path / "v4.json").write_text(json.dumps(small_cfg()))
    data = json.loads(json.dumps(real.data))
    for c in data["configs"]:
        if c["name"] == "yolov4-coco608":
            c["file"] = "v4.json"
        else:
            c["file"] = str(HERE.parent / c["file"])
    bench = Bench(data, tmp_path, HERE)
    mix = bench.mix
    bench.mix = lambda cell: {**mix(cell), "batch": 4, "pool": 2, "check_batches": 1,
                              "check_within": 1, "trace_iterations": 3,
                              "warm_iterations": 1}
    return bench


@pytest.mark.parametrize("variant", ["program", "control"])
def test_the_yolov4_cell_at_a_small_size(tmp_path, monkeypatch, variant):
    """The YOLOv4 cell through the harness on the CPU (float32): the
    program is correct and its traced run reports the new metrics; the
    control (the reference's forward through float8) is not. The concat
    counter starts at 0, as in the benchmark's fresh process."""
    import time

    from perfbench import run

    monkeypatch.setattr(profiling, "concat_bytes", 0)
    bench = _tiny_bench(tmp_path)
    cell = bench.cell("yolov4-coco608-offline-bf16")
    result = run.run_cell(bench, cell, 2**31 + 5, 0.5, variant == "program", "cpu",
                          time.perf_counter(), variant=variant, emit=lambda line: None)
    assert result["correct"] == (variant == "program"), result["checks"]
    if variant == "program":
        metrics = result["metrics"]
        assert {"v4.mfu", "v4.backbone_ms", "v4.spp_ms", "v4.neck_ms", "v4.concat_mb",
                "offline.forward_ms", "offline.pool_ms"} <= set(metrics)
        batch = bench.mix(cell)["batch"]
        plan = build_plan(model_cfg(small_cfg()))
        assert metrics["v4.concat_mb"]["value"] * 1e6 == pytest.approx(
            _reckoned_concat_bytes(plan, SIZE, batch))


def test_the_yolov4_cell_sees_a_wrong_decode(tmp_path, monkeypatch):
    """YOLOv3's decode in YOLOv4's place (every scale_xy 1.0): the kept
    boxes lose their partners."""
    import time

    from perfbench import run
    from yolo_for_turbines_tpu_torch import inference

    real_init = inference.Predictor.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.scale_xy = None

    monkeypatch.setattr(inference.Predictor, "__init__", init)
    bench = _tiny_bench(tmp_path)
    result = run.run_cell(bench, bench.cell("yolov4-coco608-offline-bf16"), 2**31 + 5, 0.5,
                          False, "cpu", time.perf_counter(), emit=lambda line: None)
    assert not result["correct"]
    assert result["checks"]["boxes_unmatched"]["value"] > 0.6


@pytest.mark.parametrize("variant", ["program", "control"])
def test_the_int8_cell_at_a_small_size(tmp_path, variant):
    """The int8 cell (``Predictor.quantize`` on the calibration
    images) on the CPU at the benchmark tests' small YOLOv3 list: the
    program is correct, the control (weights rounded to 4 bits first) is
    not."""
    import time

    from perfbench import run
    from perfbench.tests import tiny

    bench = _tiny_bench(tmp_path)
    (tmp_path / "v3.json").write_text(json.dumps(tiny.config("t", "leaky_relu")))
    next(c for c in bench.data["configs"] if c["name"] == "yolov3-coco416")["file"] = "v3.json"
    result = run.run_cell(bench, bench.cell("coco416-offline-int8"), 2**31 + 5, 0.5, False,
                          "cpu", time.perf_counter(), variant=variant, emit=lambda line: None)
    assert result["correct"] == (variant == "program"), result["checks"]
