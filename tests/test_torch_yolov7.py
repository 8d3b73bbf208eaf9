"""YOLOv7 in the port against the benchmark's plain reference
(``perfbench/reference/yolov7.py``, which imports nothing of the port), on
the CPU at a small size: the published layer list (``YOLOV7_LAYER_CONFIG``,
the configuration file's list) with every width divided by 16, a 96px
input and 3 classes, on seeded weights calibrated as the benchmark's
(``perfbench/weights_yolov7.py``). The published size is checked by shape
alone, on the meta device."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import traffic, weights_yolov7
from perfbench.drivers import offline_yolov4
from perfbench.manifest import HERE
from perfbench.reference import model as ref
from perfbench.reference import postprocess as post
from perfbench.reference import yolov7 as v7
from helpers import concat_routes, conv_inputs_channels_last
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models import blocks
from yolo_for_turbines_tpu_torch.models.blocks import (
    FoldedConv,
    ImplicitConv,
    RepConvBlock,
    silu,
)
from yolo_for_turbines_tpu_torch.models.convert import (
    folded_from_numpy,
    trainable_from_numpy,
    trainable_to_numpy,
)
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    YOLOV7_LAYER_CONFIG,
    FoldedYOLOv3,
    PlanConv,
    PlanLateral,
    PlanRepHead,
    PlanSave,
    YOLOv3,
    build_plan,
    param_count,
)
from yolo_for_turbines_tpu_torch.models.yolov7 import PlanELAN, PlanMP, PlanSPPCSPC
from yolo_for_turbines_tpu_torch.ops.decode import decode_raw_scale
from yolo_for_turbines_tpu_torch.utils import profiling

SIZE, CLASSES, DIV = 96, 3, 16
CELL = "yolov7-coco640-offline-bf16"


def published():
    return json.loads((HERE / "configs" / "yolov7-coco640.json").read_text())


def small_layers(layers):
    """Every width of the list divided by ``DIV``."""
    out = []
    for item in layers:
        item = list(item)
        if not isinstance(item[0], str):
            out.append([item[0] // DIV, item[1], item[2]])
        elif item[0] in ("elan", "elanh"):
            out.append([item[0]] + [n // DIV for n in item[1:]])
        elif item[0] in ("mp", "sppcspc"):
            out.append([item[0], item[1] // DIV] + item[2:])
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
    return ModelConfig(num_classes=bench_cfg["num_classes"], activation="silu",
                       strides=(8, 16, 32), layer_config=layers)


@pytest.fixture(scope="module")
def small():
    """(bench cfg, reference plan, reference tree, images): weights
    calibrated on the images, as the cell makes them."""
    c = small_cfg()
    x = traffic.device_images(torch.Generator().manual_seed(3), 4, SIZE, "cpu")
    plan, tree = weights_yolov7.folded(c, 11, x)
    return c, plan, tree, x


def _predictor(c, tree):
    return Predictor.from_folded(model_cfg(c), offline_yolov4.numpy_tree(tree), device="cpu",
                                 anchors=c["anchors"], image_size=SIZE,
                                 compute_dtype=torch.float32)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_published_list_is_the_configuration_files():
    assert [list(x) for x in YOLOV7_LAYER_CONFIG] == published()["layers"]
    mc = ModelConfig(backbone="yolov7", activation="silu", strides=cfg.strides_for("yolov7"))
    assert build_plan(mc) == build_plan(model_cfg(published()))
    assert cfg.strides_for("yolov7") == (8, 16, 32)
    assert np.allclose(np.asarray(cfg.YOLOV7_ANCHORS), published()["anchors"])
    heads = [e for e in build_plan(mc) if isinstance(e, PlanRepHead)]
    assert [(e.scale_xy, e.size_decode, e.mid) for e in heads] == \
        [(2.0, "square", 2 * e.in_ch) for e in heads] and len(heads) == 3


def test_published_size_by_shape_and_operations():
    """92 convs and 36,905,341 folded parameters (the paper's 36.9 M),
    heads of 255 channels at 80 / 40 / 20 for 640px (the port's forward on
    the meta device, which computes shapes alone), and 104.51 GFLOP by the
    reference's table (the paper's 104.7 counts the unfused training form);
    27.03 M concat elements and 22.2 GB of K5 bytes per 64 images."""
    c = published()
    model = FoldedYOLOv3(model_cfg(c)).to("meta")
    assert sum(isinstance(m, FoldedConv) for m in model.modules()) == 92
    assert param_count(model) == 36_905_341 == v7.param_count(c) == c["published_params"]
    heads = model(torch.empty(1, 640, 640, 3, device="meta"))
    assert [tuple(h.shape) for h in heads] == [(1, s, s, 255) for s in (80, 40, 20)]
    assert sum(h.shape[1] * h.shape[2] * 3 for h in heads) == 25_200
    assert len(v7.conv_table(c, 640)) == 92
    flops = v7.forward_flops(c, 640)
    assert flops == pytest.approx(104.51e9, rel=1e-4)
    assert flops == pytest.approx(c["published_gflop_per_image"] * 1e9, rel=3e-3)
    assert v7.concat_elements(c, 640) == pytest.approx(27.03e6, rel=1e-3)
    assert v7.epilogue_bytes(c, 640, 64) == pytest.approx(22.2e9, rel=2e-3)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_folded_heads_match_the_reference(small, seed):
    """Float32 on both sides, the same weights and images: only the order of
    f32 roundings differs (the program's SiLU is torch's, the reference's
    ``x * sigmoid(x)``). The two lie 4.5e-6 to 1.2e-5 apart (relative RMS,
    worst scale, 6 seeds); depth amplifies rounding, so the YOLOv4 test's
    1e-4."""
    c, plan, tree, x = small
    if seed != 11:
        plan, tree = weights_yolov7.folded(c, seed, x)
    got = _predictor(c, tree).raw_heads(x)
    want = v7.folded_forward(plan, tree, x)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g, w) < 1e-4
        assert float(w.reshape(-1, w.shape[-1]).std(0).min()) > 1e-2  # not mere biases


def _randomise_bn(model, seed):
    """BN scale U(0.5, 1.5), shift N(0, 0.5), running statistics from one
    train-mode pass; each implicit vector drawn around its identity."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
            m.bias.copy_(0.5 * torch.randn(m.num_features, generator=gen))
            m.reset_running_stats()
            m.momentum = None
        if isinstance(m, ImplicitConv):
            m.implicit_a.copy_(0.3 * torch.randn(m.implicit_a.shape, generator=gen))
            m.implicit_m.copy_(1 + 0.3 * torch.randn(m.implicit_m.shape, generator=gen))


@torch.no_grad()
def test_trainable_eval_matches_its_own_fold():
    """``YOLOv3(...).eval()`` on a YOLOv7 plan (RepConv and implicit heads in
    their training form) against ``fold()`` served by ``FoldedYOLOv3``: BN
    with running statistics from one train-mode pass, both sides in float64
    (the fold's tree is float32, as ``fold()`` gives it). They lie 9.2e-6 to
    1.6e-5 apart (relative RMS, 4 seeds): 1e-4. In float32 the eval module
    alone lies 2.3e-5 to 1.2e-4 from its float64 twin, which is rounding of
    the deep network and not the fold's."""
    mc = model_cfg(small_cfg())
    model = YOLOv3(mc, generator=torch.Generator().manual_seed(5))
    _randomise_bn(model, 6)
    x = traffic.device_images(torch.Generator().manual_seed(7), 4, SIZE, "cpu")
    model.train()(x)
    tree = model.fold()
    x = x.double()
    want = model.double().eval()(x)
    got = folded_from_numpy(build_plan(mc), tree, mc).double()(x)
    for g, w in zip(got, want):
        b, a, s, _, k = w.shape
        w = w.permute(0, 2, 3, 1, 4).reshape(b, s, s, a * k)
        assert rel(g, w) < 1e-4
        assert float(w.std()) > 1e-2


def _bn_dict(bn):
    return {"gamma": bn.weight, "beta": bn.bias, "mean": bn.running_mean,
            "var": bn.running_var}


@torch.no_grad()
@pytest.mark.parametrize("identity", [False, True])
def test_repconv_fold_is_the_references_reparameterisation(identity):
    """``RepConvBlock.folded()`` against ``reference/yolov7.py::repconv`` of
    the same branches, and the folded 3x3 + SiLU against the block's own
    eval forward; the identity branch exists where in == out and stride 1.
    The folded weights agree to 1 f32 rounding (2.4e-7 relative; measured
    0, the same operations in the same order), the forwards to 1e-6
    (measured 1.6e-7 to 2.3e-7, 3 seeds each)."""
    cin, cout = (8, 8) if identity else (8, 16)
    block = RepConvBlock(cin, cout, generator=torch.Generator().manual_seed(20))
    assert (block.bn_id is not None) == identity
    _randomise_bn(block, 21)
    x = torch.randn(3, cin, 7, 7, generator=torch.Generator().manual_seed(22))
    block.train()(x, silu)
    block.eval()
    got = block.folded()
    p = {"w3": block.conv.weight, "bn3": _bn_dict(block.bn), "w1": block.conv1x1.weight,
         "bn1": _bn_dict(block.bn1x1)}
    if identity:
        p["bn_id"] = _bn_dict(block.bn_id)
    want = v7.repconv(p)
    assert rel(got["w"], want["w"]) < 2.4e-7 and rel(got["b"], want["b"]) < 2.4e-7
    folded = silu(F.conv2d(x, got["w"], got["b"], padding=1))
    assert rel(folded, block(x, silu)) < 1e-6


@torch.no_grad()
def test_implicit_fold_is_the_references_reparameterisation():
    """``ImplicitConv.folded()`` against ``reference/yolov7.py::implicit``:
    ``W' = m W``, ``b' = m (b + W a)``, and its 1x1 against the block's own
    forward (measured 0 for the weights, 1.1e-7 to 1.2e-7 for the forward,
    3 seeds)."""
    block = ImplicitConv(16, 24, generator=torch.Generator().manual_seed(30))
    _randomise_bn(block, 31)
    got = block.folded()
    want = v7.implicit({"w": block.conv.weight, "b": block.conv.bias,
                        "ia": block.implicit_a, "im": block.implicit_m})
    assert rel(got["w"], want["w"]) < 2.4e-7 and rel(got["b"], want["b"]) < 2.4e-7
    x = torch.randn(2, 16, 5, 5, generator=torch.Generator().manual_seed(32))
    assert rel(F.conv2d(x, got["w"], got["b"]), block(x)) < 1e-6


@torch.no_grad()
def test_trainable_tree_round_trips_through_the_bridges():
    """``trainable_to_numpy`` then ``trainable_from_numpy`` carry every
    RepConv branch and implicit vector: the same eval forward, bit for
    bit."""
    mc = model_cfg(small_cfg())
    model = YOLOv3(mc, generator=torch.Generator().manual_seed(8))
    _randomise_bn(model, 9)
    x = traffic.device_images(torch.Generator().manual_seed(10), 2, SIZE, "cpu")
    model.train()(x)
    params, stats = trainable_to_numpy(model.eval())
    head = next(i for i, e in enumerate(model.plan) if isinstance(e, PlanRepHead))
    assert {"w1x1", "scale1x1", "bias1x1"} <= set(params[head]["conv1"])
    assert {"implicit_a", "implicit_m"} <= set(params[head]["conv2"])
    again = trainable_from_numpy(model.plan, params, stats, mc, device="cpu").eval()
    assert all(torch.equal(a, b) for a, b in zip(again(x), model(x)))


def _raw(seed, s=6):
    gen = torch.Generator().manual_seed(seed)
    return 3 * torch.randn(2, s, s, 3 * (5 + CLASSES), generator=gen)


ANCHORS = [[0.1, 0.2], [0.3, 0.25], [0.5, 0.6]]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_square_decode_matches_the_reference(seed):
    """The centres, scores and classes by the same f32 operations in the
    same order: the same bits; the sizes from anchors scaled to cells and
    back (the program's) or not (the reference's): 1e-6 relative. Sizes
    reach at most 4 anchors."""
    s, raw = 6, _raw(seed)
    got = decode_raw_scale(raw, torch.tensor(ANCHORS) * s, s, CLASSES, 2.0, "square")
    want = v7.decode([raw], [ANCHORS], CLASSES, [2.0])
    assert torch.equal(got[..., [0, 1, 4, 5]], want[..., [0, 1, 4, 5]])
    assert torch.allclose(got[..., 2:4], want[..., 2:4], rtol=1e-6, atol=0)
    ratio = got[..., 2].reshape(2, s, s, 3) / torch.tensor(ANCHORS)[:, 0]
    assert float(ratio.max()) <= 4.0 and float(ratio.min()) >= 0.0


def test_an_exp_decode_in_its_place_is_caught():
    """YOLOv4's ``exp`` size decode where YOLOv7's squared one belongs fails
    the comparison above by orders of magnitude."""
    s, raw = 6, _raw(4)
    got = decode_raw_scale(raw, torch.tensor(ANCHORS) * s, s, CLASSES, 2.0, "exp")
    want = v7.decode([raw], [ANCHORS], CLASSES, [2.0])
    assert not torch.allclose(got[..., 2:4], want[..., 2:4], rtol=1e-2, atol=0)
    assert rel(got[..., 2:4], want[..., 2:4]) > 0.5


def test_the_exp_decode_at_scale_one_stays_yolov3s():
    """At scale_xy 1.0 with the ``exp`` size decode, named or not, the
    decode runs YOLOv3's operations (written out below, as before the other
    modes were added): the same bits."""
    gen = torch.Generator().manual_seed(1)
    s, a, n = 13, 3, 5 + CLASSES
    raw = 3 * torch.randn(2, s, s, a * n, generator=gen).bfloat16()
    anchors = torch.tensor(ANCHORS) * s
    y = raw.reshape(2, s, s, a, n)
    ar = torch.arange(s, dtype=torch.float32)
    box = y[..., 0:5].float()
    cx = (torch.sigmoid(box[..., 0:1]) + ar[None, None, :, None, None]) / s
    cy = (torch.sigmoid(box[..., 1:2]) + ar[None, :, None, None, None]) / s
    wh = torch.exp(box[..., 2:4]) * anchors.to(raw.dtype).float().reshape(1, 1, 1, a, 2) / s
    want = torch.cat([cx, cy, wh, torch.sigmoid(box[..., 4:5]),
                      torch.argmax(y[..., 5:], dim=-1)[..., None].float()], -1)
    want = want.reshape(2, s * s * a, 6)
    assert torch.equal(decode_raw_scale(raw, anchors, s, CLASSES), want)
    assert torch.equal(decode_raw_scale(raw, anchors, s, CLASSES, 1.0, "exp"), want)


def test_predict_batch_boxes_match_the_reference(small):
    """The kept boxes of ``predict_batch`` against the reference's decode
    (each scale's scale_xy and squared sizes) and NMS of the same heads:
    every box has a partner (``reference/postprocess.py::mismatch``)."""
    c, plan, tree, x = small
    pred = _predictor(c, tree)
    assert pred.scale_xy == (2.0, 2.0, 2.0)
    assert pred.size_decode == ("square",) * 3
    heads = pred.raw_heads(x)
    kept, mask = pred.predict_batch(x)
    rows = v7.decode(heads, c["anchors"], CLASSES, v7.scale_xy(plan))
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
        elif isinstance(e, PlanELAN):
            total += e.cat_ch * side * side
            c = e.out_ch
        elif isinstance(e, PlanMP):
            side //= 2
            c = 2 * e.out_ch + (named[e.route] if e.route else 0)
            total += c * side * side
        elif isinstance(e, PlanSPPCSPC):
            total += (4 + 2) * e.out_ch * side * side
            c = e.out_ch
        elif isinstance(e, PlanSave):
            named[e.name] = c
        elif isinstance(e, PlanLateral):
            side, c = 2 * side, c + e.out_ch
            total += c * side * side
    return total * batch * itemsize


def test_spans_per_forward_and_the_concat_counter(small):
    """Under a profiler the forward opens ``forward.elan`` 8 times (4 ELAN,
    4 ELAN-H), ``forward.sppcspc`` once and ``forward.pool`` for each of the
    5 MP pools and inside ``forward.sppcspc`` for its pyramid, in the walk's
    order, and none of YOLOv4's spans; the counter grows by the bytes the
    plan's concats write, which is the reference's count of concat
    elements."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    before = profiling.concat_bytes
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profiling.time.perf_counter()
        model(x)
    names = [s.name for s in profiling.spans(since=t0)]
    opens = {PlanELAN: ["forward.elan"], PlanMP: ["forward.pool"],
             PlanSPPCSPC: ["forward.sppcspc", "forward.pool"]}
    assert names == [n for e in model.plan for n in opens.get(type(e), [])]
    assert names.count("forward.elan") == 8 and names.count("forward.pool") == 6
    counted = profiling.concat_bytes - before
    assert counted == _reckoned_concat_bytes(model.plan, SIZE, 4)
    assert counted == 4 * 4 * v7.concat_elements(c, SIZE)


def _reckoned_copied_bytes(plan, side: int, batch: int, itemsize: int = 4) -> int:
    """Bytes the concats copy when they are written in place off the card:
    SPPCSPC's pyramid (aten's pools and their ``torch.cat`` there), the
    upsampled halves and MP's saved routes; K5 stores every other part."""
    total, c, named = 0, plan[0].in_ch, {}
    for e in plan:
        if isinstance(e, PlanConv):
            side, c = (side - 1) // e.stride + 1, e.out_ch
        elif isinstance(e, PlanELAN):
            c = e.out_ch
        elif isinstance(e, PlanMP):
            side //= 2
            route = named[e.route] if e.route else 0
            total += route * side * side
            c = 2 * e.out_ch + route
        elif isinstance(e, PlanSPPCSPC):
            total += 4 * e.out_ch * side * side
            c = e.out_ch
        elif isinstance(e, PlanSave):
            named[e.name] = c
        elif isinstance(e, PlanLateral):
            total += c * 4 * side * side
            side, c = 2 * side, c + e.out_ch
    return total * batch * itemsize


def test_concats_written_in_place_give_the_same_heads(small):
    """The card's route on the CPU (every folded conv through K5's plain
    version, every concat a buffer its parts are written into, the ELANs'
    chain parts kept as tensors too): the heads equal the ``torch.cat``
    route's bit for bit; the bytes copied in and the bytes K5 stored add up
    to every concat's, and K5 stores all but SPPCSPC's pyramid, the
    upsampled halves and MP's routes."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    (got, copied, stored), (want, cat_copied, cat_stored) = concat_routes(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    total = _reckoned_concat_bytes(model.plan, SIZE, 4)
    assert (cat_copied, cat_stored) == (total, 0)
    assert copied + stored == total
    assert copied == _reckoned_copied_bytes(model.plan, SIZE, 4)


def test_every_conv_takes_channels_last_input_with_the_concats_in_place(small, monkeypatch):
    """On the card's route the fuse convs read the concat buffers and the
    chain convs the kept parts: all channels_last."""
    c, plan, tree, x = small
    model = _predictor(c, tree).model
    monkeypatch.setattr(blocks, "epilogue_wins", lambda t, act, skip=None: True)
    monkeypatch.setattr(profiling, "concat_in_place_bytes", 0)
    seen = conv_inputs_channels_last(model, x)
    assert len(seen) == 92 and all(seen) and profiling.concat_in_place_bytes > 0


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
    assert len(seen) == 92 and all(seen)


@pytest.mark.parametrize("what", ["quantize", "layout", "darknet", "train"])
def test_what_yolov7_does_not_take_raises(small, what, tmp_path):
    """One predicate refuses a YOLOv7 plan on each path, naming the family
    and its entries."""
    c, plan, tree, x = small
    match = r"YOLOv7 plan \(ELAN, MP, named routes, SPPCSPC, RepConv heads\)"
    if what == "quantize":
        with pytest.raises(ValueError, match="int8 PTQ does not take a " + match):
            _predictor(c, tree).quantize(x)
    elif what == "layout":
        with pytest.raises(ValueError, match="spatial partitioning does not take a " + match):
            _predictor(c, tree).model(x, layout=object())
    elif what == "darknet":
        from yolo_for_turbines_tpu_torch.models.darknet_weights import load_darknet_into

        with pytest.raises(ValueError, match="darknet reader does not take a " + match):
            load_darknet_into(str(tmp_path / "yolov7.weights"), YOLOv3(model_cfg(c)))
    else:
        from yolo_for_turbines_tpu_torch.config import TrainConfig
        from yolo_for_turbines_tpu_torch.train.trainer import Trainer

        with pytest.raises(ValueError, match="Trainer does not take a " + match):
            Trainer(TrainConfig(), model_cfg=model_cfg(c), device="cpu")


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect

    from perfbench.drivers import offline_yolov7

    for module in (v7, weights_yolov7, offline_yolov7):
        tree = ast.parse(inspect.getsource(module))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith("jax")]
    for module in (v7, weights_yolov7):
        tree = ast.parse(inspect.getsource(module))
        names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith("yolo_for_turbines")]


def _tiny_bench(tmp_path):
    """The real BENCHMARK.json with the YOLOv7 configuration cut to the
    small size and its mix to a few tiny batches, the first of which is
    checked (a window always makes it, however slow the host)."""
    from perfbench.manifest import Bench

    real = Bench.load(HERE.parent / "BENCHMARK.json")
    (tmp_path / "v7.json").write_text(json.dumps(small_cfg()))
    data = json.loads(json.dumps(real.data))
    for c in data["configs"]:
        c["file"] = "v7.json" if c["name"] == "yolov7-coco640" else str(HERE.parent / c["file"])
    bench = Bench(data, tmp_path, HERE)
    mix = bench.mix
    bench.mix = lambda cell: {**mix(cell), "batch": 4, "pool": 2, "check_batches": 1,
                              "check_within": 1, "trace_iterations": 3,
                              "warm_iterations": 1}
    return bench


@pytest.mark.parametrize("variant", ["program", "control"])
def test_the_yolov7_cell_at_a_small_size(tmp_path, monkeypatch, variant):
    """The YOLOv7 cell through the harness on the CPU (float32): the
    program is correct and its traced run reports the new metrics (K5's
    roofline none: no kernel runs on the CPU); the control (the reference's
    forward through float8) is not. The concat counter starts at 0, as in
    the benchmark's fresh process."""
    import time

    from perfbench import run

    monkeypatch.setattr(profiling, "concat_bytes", 0)
    bench = _tiny_bench(tmp_path)
    cell = bench.cell(CELL)
    result = run.run_cell(bench, cell, 2**31 + 5, 0.5, variant == "program", "cpu",
                          time.perf_counter(), variant=variant, emit=lambda line: None)
    assert result["correct"] == (variant == "program"), result["checks"]
    if variant == "program":
        metrics = result["metrics"]
        assert {"v7.mfu", "v7.elan_ms", "v7.sppcspc_ms", "v4.concat_mb", "offline.forward_ms",
                "offline.postproc_ms", "offline.device_idle", "offline.pool_ms"} <= set(metrics)
        assert "v7.epilogue_roofline" not in metrics
        assert not {"v4.mfu", "v4.backbone_ms", "v4.spp_ms", "v4.neck_ms"} & set(metrics)
        batch = bench.mix(cell)["batch"]
        plan = build_plan(model_cfg(small_cfg()))
        assert metrics["v4.concat_mb"]["value"] * 1e6 == pytest.approx(
            _reckoned_concat_bytes(plan, SIZE, batch))


def test_the_yolov7_cell_sees_a_wrong_decode(tmp_path, monkeypatch):
    """YOLOv4's decode in YOLOv7's place (every size decode ``exp``): the
    kept boxes lose their partners."""
    import time

    from perfbench import run
    from yolo_for_turbines_tpu_torch import inference

    real_init = inference.Predictor.__init__

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self.size_decode = None

    monkeypatch.setattr(inference.Predictor, "__init__", init)
    bench = _tiny_bench(tmp_path)
    result = run.run_cell(bench, bench.cell(CELL), 2**31 + 5, 0.5, False, "cpu",
                          time.perf_counter(), emit=lambda line: None)
    assert not result["correct"]
    assert result["checks"]["boxes_unmatched"]["value"] > 0.6
