"""RT-DETR-R50 in the port against the benchmark's plain reference
(``perfbench/reference/rtdetr.py``, which imports nothing of the port), on
the CPU in float32: a small instance (128px, one bottleneck per stage,
widths / 4, hidden 64, 4 heads, 32 queries, 2 decoder layers, 5 classes)
and the published widths at 64px with 32 queries, on seeded unfused
weights calibrated as the benchmark's (``perfbench/weights_rtdetr.py``),
which the port loads into its trainable model and folds itself. The
published size is checked by shape alone, on the meta device."""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import traffic, weights_rtdetr
from perfbench.drivers import offline_rtdetr
from perfbench.manifest import HERE
from perfbench.reference import rtdetr as rt
from helpers import concat_routes, conv_inputs_channels_last
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from yolo_for_turbines_tpu_torch import config as cfg
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.inference import Predictor
from yolo_for_turbines_tpu_torch.models import blocks, rtdetr
from yolo_for_turbines_tpu_torch.models.blocks import (
    FoldedConv,
    PooledConvBlock,
    RepConvBlock,
)
from yolo_for_turbines_tpu_torch.models.convert import (
    folded_from_numpy,
    trainable_from_numpy,
    trainable_to_numpy,
)
from yolo_for_turbines_tpu_torch.models.yolov3 import (
    FoldedYOLOv3,
    YOLOv3,
    build_plan,
    conv_paths,
    init_plan,
    param_count,
)
from yolo_for_turbines_tpu_torch.ops.kernels import deform_kernel, nms_kernel
from yolo_for_turbines_tpu_torch.utils import profiling

CELL = "rtdetr-coco640-offline-bf16"
SMALL_LAYERS = [["resnet_vd", 16, 1, 1, 1, 1], ["hybrid_encoder", 64, 4, 128, 1],
                ["detr_decoder", 64, 4, 3, 4, 32, 2, 128]]


def published():
    return json.loads((HERE / "configs" / "rtdetr-r50vd-coco640.json").read_text())


def small_cfg():
    return {**published(), "layers": SMALL_LAYERS, "num_classes": 5, "image_size": 128}


def wide_cfg():
    """The published widths and depths at 64px with 32 queries."""
    layers = [list(x) for x in published()["layers"]]
    layers[2][5] = 32
    return {**published(), "layers": layers, "image_size": 64}


def model_cfg(bench_cfg):
    layers = tuple(tuple(x) for x in bench_cfg["layers"])
    return ModelConfig(num_classes=bench_cfg["num_classes"], activation="relu",
                       backbone="rtdetr_r50vd", strides=(8, 16, 32), layer_config=layers)


def _setup(c, seed, n=2):
    x = traffic.device_images(torch.Generator().manual_seed(seed), n, c["image_size"], "cpu")
    unfused = weights_rtdetr.unfused(c, seed, x)
    return x, unfused


@pytest.fixture(scope="module")
def small():
    c = small_cfg()
    x, unfused = _setup(c, 3, 4)
    return c, x, unfused


def _folded_tree(c, unfused):
    params, stats = offline_rtdetr.program_trees(unfused)
    plan = build_plan(model_cfg(c))
    trainable = trainable_from_numpy(plan, params, stats, model_cfg(c), device="cpu").eval()
    return trainable, trainable.fold()


def _predictor(c, unfused):
    return Predictor.from_folded(model_cfg(c), _folded_tree(c, unfused)[1], device="cpu",
                                 image_size=c["image_size"], compute_dtype=torch.float32)


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def _check_outputs(got, want):
    logits, boxes, memory, idx = got
    r_memory, r_idx, r_logits, r_boxes = want
    assert torch.equal(idx, r_idx)
    assert rel(memory, r_memory) < 1e-5
    assert rel(logits, r_logits) < 1e-5
    assert rel(boxes, r_boxes) < 1e-5
    assert float(r_memory.std(1).min()) > 1e-2  # not mere biases


def test_published_list_is_the_configuration_files():
    c = published()
    assert [list(x) for x in rtdetr.RTDETR_LAYER_CONFIG] == c["layers"]
    mc = ModelConfig(backbone="rtdetr_r50vd", activation="relu",
                     strides=cfg.strides_for("rtdetr_r50vd"))
    assert build_plan(mc) == build_plan(model_cfg(c))
    assert cfg.strides_for("rtdetr_r50vd") == (8, 16, 32)
    dec = rtdetr.decoder_entry(build_plan(mc))
    assert dec == rtdetr.PlanDETRDecoder(256, 8, 3, 4, 300, 6, 1024, in_ch=256, num_classes=80)
    assert (dec.hidden, dec.heads, dec.levels, dec.points, dec.queries, dec.layers, dec.ffn) \
        == (c["hidden_dim"], c["nhead"], c["num_levels"], c["num_points"], c["num_queries"],
            c["num_decoder_layers"], c["decoder_dim_feedforward"])
    assert c["reduced"] == [] and c["num_top_queries"] == c["num_queries"]


def test_published_size_by_shape_and_operations():
    """85 folded convs; the unfused inference form's 42.9 M weights (the
    source's 42 M), 8.3 M more once folded (the ``d`` shortcuts as 2x2
    convs); rows (1, 300, 80) and (1, 300, 4) and 8,400 memory tokens at
    640px from the port's forward on the meta device, which computes
    shapes alone; 133.9 GFLOP by the reference's count (the paper's 136);
    K5's bytes per 64 images."""
    c = published()
    model = FoldedYOLOv3(model_cfg(c)).to("meta")
    assert sum(isinstance(m, FoldedConv) for m in model.modules()) == 85
    assert rt.param_count(c) == pytest.approx(c["published_params"], rel=0.03)
    shortcuts = sum(s["cout"] * s["cin"] for s in rt.leaf_specs(c) if s["kind"] == "pooled")
    repvgg = sum(s["cout"] * (s["cin"] + 3) for s in rt.leaf_specs(c) if s["kind"] == "rep")
    running = sum(2 * s["cout"] for s in rt.leaf_specs(c) if s["kind"] in ("conv", "pooled"))
    assert param_count(model) == rt.param_count(c) + 3 * shortcuts - repvgg - running // 2
    with torch.no_grad():
        logits, boxes, memory, idx = model(torch.empty(1, 640, 640, 3, device="meta"))
    assert tuple(logits.shape) == (1, 300, 80) and tuple(boxes.shape) == (1, 300, 4)
    assert tuple(memory.shape) == (1, 8400, 256) and tuple(idx.shape) == (1, 300)
    assert len(rt.conv_table(c, 640)) == 85
    flops = rt.forward_flops(c, 640)
    assert flops == pytest.approx(133.9e9, rel=2e-3)
    assert flops == pytest.approx(c["published_gflop_per_image"] * 1e9, rel=0.02)
    assert rt.epilogue_bytes(c, 640, 64) == pytest.approx(
        64 * sum(s["side_out"] ** 2 * s["cout"] * (6 if s["skip"] else 4)
                 for s in rt.conv_table(c, 640)))


def test_small_port_matches_the_reference(small):
    """Memory, selected tokens, final logits and boxes of the port's fold
    against the reference's fold of the same unfused tree: the same
    selection and 1e-5 relative."""
    c, x, unfused = small
    got = _predictor(c, unfused).raw_heads(x)
    want = rt.folded_forward(c, rt.reparameterise(c, unfused), x)
    _check_outputs(got, want)


def test_published_widths_match_the_reference():
    c = wide_cfg()
    x, unfused = _setup(c, 5, 2)
    got = _predictor(c, unfused).raw_heads(x)
    want = rt.folded_forward(c, rt.reparameterise(c, unfused), x)
    _check_outputs(got, want)


def test_the_ports_fold_against_the_unfused_reference(small):
    """The port's trainable model in eval mode (BN, RepVGG's two branches,
    the ``d`` shortcut's pool + 1x1) and its fold (one 3x3 per RepVGG, the
    shortcut one 2x2 stride-2 conv) against the reference's unfused
    forward: exact in real arithmetic, f32 rounding apart."""
    c, x, unfused = small
    trainable, folded = _folded_tree(c, unfused)
    want = rt.unfused_forward(c, unfused, x)
    with torch.no_grad():
        _check_outputs(trainable(x), want)
    plan = build_plan(model_cfg(c))
    served = folded_from_numpy(plan, folded, model_cfg(c)).eval()
    with torch.no_grad():
        _check_outputs(served(x), want)


def test_repvgg_without_identity_folds_as_the_reference():
    gen = torch.Generator().manual_seed(7)
    block = RepConvBlock(16, 16, generator=gen, identity=False).eval()
    assert block.bn_id is None
    for bn, suffix in ((block.bn, ""), (block.bn1x1, "1x1")):
        bn.weight.data.uniform_(0.5, 1.5, generator=gen)
        bn.bias.data.normal_(0, 0.5, generator=gen)
        bn.running_mean.normal_(0, 0.5, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    leaf = {"w": block.conv.weight.data, "gamma": block.bn.weight.data,
            "beta": block.bn.bias.data, "mean": block.bn.running_mean,
            "var": block.bn.running_var, "w1x1": block.conv1x1.weight.data,
            "gamma1x1": block.bn1x1.weight.data, "beta1x1": block.bn1x1.bias.data,
            "mean1x1": block.bn1x1.running_mean, "var1x1": block.bn1x1.running_var}
    fold = block.folded()
    w1, b1 = rt._fold_bn(leaf["w"], leaf)
    w2, b2 = rt._fold_bn(leaf["w1x1"], leaf, "1x1")
    assert torch.allclose(fold["w"], w1 + F.pad(w2, (1, 1, 1, 1)), atol=1e-7)
    assert torch.allclose(fold["b"], b1 + b2, atol=1e-7)
    x = torch.randn(2, 16, 9, 9, generator=gen)
    with torch.no_grad():
        y = block(x, F.silu)
        z = F.silu(F.conv2d(x, fold["w"], fold["b"], padding=1))
    assert rel(z, y) < 1e-6


def test_pooled_shortcut_folds_to_a_2x2_stride_2_conv():
    gen = torch.Generator().manual_seed(8)
    block = PooledConvBlock(8, 32, generator=gen).eval()
    block.bn.running_mean.normal_(0, 0.5, generator=gen)
    block.bn.running_var.uniform_(0.5, 2.0, generator=gen)
    x = torch.randn(2, 8, 12, 16, generator=gen)
    fold = block.folded()
    assert tuple(fold["w"].shape) == (32, 8, 2, 2)
    conv = FoldedConv(8, 32, 2, 2)
    conv.weight.data.copy_(fold["w"])
    conv.bias.data.copy_(fold["b"])
    with torch.no_grad():
        assert rel(conv(x), block(x)) < 1e-6


def test_position_embedding_is_the_sources_table():
    """A 2x3 plane at dim 8: ``om = (1, 0.01)``, the first half follows the
    row index of the source's (w, h) meshgrid, the second the column."""
    h, w, dim = 3, 3, 8
    om = [1.0, 1e-2]
    table = []
    for t in range(h * w):
        r, col = t // h, t % h
        table.append([np.sin(r * o) for o in om] + [np.cos(r * o) for o in om]
                     + [np.sin(col * o) for o in om] + [np.cos(col * o) for o in om])
    table = torch.tensor(table, dtype=torch.float32)
    assert torch.allclose(rtdetr.pos_embed(h, w, dim, "cpu"), table, atol=1e-6)
    assert torch.allclose(rt.pos_table(h, w, dim), table, atol=1e-6)
    assert torch.equal(rtdetr.pos_embed(20, 20, 256, "cpu"), rt.pos_table(20, 20, 256))


def test_priors_invalidate_the_finest_levels_border_ring():
    shapes = [(80, 80), (40, 40), (20, 20)]
    logit, valid = rtdetr.priors(shapes, "cpu")
    r_logit, r_valid = rt.priors(shapes, "cpu")
    assert torch.equal(valid, r_valid) and torch.equal(logit, r_logit)
    assert int((~valid).sum()) == 316 == 80 * 4 - 4
    assert bool((~valid[0, :6400]).sum() == 316) and bool(valid[0, 6400:].all())
    assert bool(torch.isinf(logit[~valid[..., 0]]).all())
    assert torch.allclose(torch.sigmoid(logit[0, 6400 + 41]),
                          torch.tensor([1.5 / 40, 1.5 / 40, 0.1, 0.1]))


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_postprocess_rows_and_mask_match_the_reference(threshold):
    gen = torch.Generator().manual_seed(9)
    logits = torch.randn(3, 20, 7, generator=gen) * 2 - 1
    boxes = torch.rand(3, 20, 4, generator=gen)
    rows, mask = rtdetr.postprocess(logits, boxes, 20, threshold)
    r_rows, r_mask = rt.postprocess(logits, boxes, 20, threshold)
    assert torch.equal(rows, r_rows) and torch.equal(mask, r_mask)
    assert bool((rows[..., 4][:, :-1] >= rows[..., 4][:, 1:]).all())
    q, k = int(rows[1, 0, 5]), int(torch.argmax(torch.sigmoid(logits[1]).flatten())) % 7
    assert q == k


def test_predict_batch_shapes_without_decode_or_nms(small, monkeypatch):
    """``((B, 300 -> Q, 6), (B, Q) bool)`` and no K1: ``batched_nms`` and
    the decode are never called."""
    from yolo_for_turbines_tpu_torch import inference

    c, x, unfused = small
    pred = _predictor(c, unfused)

    def refuse(*args, **kwargs):
        raise AssertionError("an RT-DETR predictor ran the YOLO postprocess")

    monkeypatch.setattr(inference, "batched_nms", refuse)
    monkeypatch.setattr(inference, "decode_raw_all", refuse)
    before = nms_kernel.launches
    kept, mask = pred.predict_batch(x)
    assert tuple(kept.shape) == (4, 32, 6) and tuple(mask.shape) == (4, 32)
    assert mask.dtype == torch.bool and nms_kernel.launches == before
    logits, boxes = pred.raw_heads(x)[:2]
    assert torch.equal((kept, mask)[0], rtdetr.postprocess(logits, boxes, 32, 0.5)[0])
    assert len(pred.predict_images([np.zeros((100, 80, 3), np.uint8)])) == 1


def test_spans_per_forward_and_the_samples_counter(small):
    """Under a profiler the forward opens ``detr.backbone``, ``.encoder`` and
    ``.decoder`` once each, the stem's pool ``forward.pool`` inside the
    backbone, and ``detr.deform`` once per decoder layer; the counter grows
    by B x queries x heads x levels x points per layer."""
    c, x, unfused = small
    model = _predictor(c, unfused).model
    before = profiling.deform_samples
    with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = profiling.time.perf_counter()
        model(x)
    names = [s.name for s in profiling.spans(since=t0)]
    assert names == ["detr.backbone", "forward.pool", "detr.encoder", "detr.decoder",
                     "detr.deform", "detr.deform"]
    assert profiling.deform_samples - before == 2 * 4 * 32 * 4 * 3 * 4


def test_every_conv_takes_channels_last_input(small):
    """What routes each conv to K5 on the card besides bf16 and CUDA: the
    pool, the attention's tokens turned back into a plane, the concats and
    the upsamples keep the input's channels_last memory."""
    c, x, unfused = small
    model = _predictor(c, unfused).model
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
    assert len(seen) == 41 and all(seen)


def test_concats_written_in_place_give_the_same_outputs(small):
    """CCFM's concats on the card's route on the CPU (every folded conv
    through K5's plain version, each concat a buffer its parts are written
    into): logits, boxes, memory and selection equal the ``torch.cat``
    route's bit for bit; each concat is half K5's (the input projection,
    the stride-2 conv) and half copied (the upsampled lateral output, the
    top-down output), together every concat's bytes."""
    c, x, unfused = small
    model = _predictor(c, unfused).model
    (got, copied, stored), (want, cat_copied, cat_stored) = concat_routes(model, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert cat_stored == 0 and copied == stored == cat_copied // 2 > 0


def test_every_conv_takes_channels_last_input_with_the_concats_in_place(small, monkeypatch):
    c, x, unfused = small
    model = _predictor(c, unfused).model
    monkeypatch.setattr(blocks, "epilogue_wins", lambda t, act, skip=None: True)
    seen = conv_inputs_channels_last(model, x)
    assert len(seen) == 41 and all(seen)


def test_trainable_tree_round_trips_through_the_bridges(small):
    """``trainable_to_numpy`` of the loaded model gives the trees it was
    loaded from, and ``init_plan`` draws a folded tree the module takes."""
    c, x, unfused = small
    params, stats = offline_rtdetr.program_trees(unfused)
    model = trainable_from_numpy(build_plan(model_cfg(c)), params, stats, model_cfg(c),
                                 device="cpu")
    p2, s2 = trainable_to_numpy(model)
    names = [(i, path) for i, path, _ in conv_paths(model.layers)]
    assert len(names) == len(unfused)
    from yolo_for_turbines_tpu_torch.models.yolov3 import tree_leaf

    for i, path in names:
        a, b = tree_leaf(params, (i, *path)), tree_leaf(p2, (i, *path))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k], np.float32), b[k])
        assert (tree_leaf(stats, (i, *path)) is None) == (tree_leaf(s2, (i, *path)) is None)
    plan = build_plan(model_cfg(c))
    tree = init_plan(plan, torch.Generator().manual_seed(1))
    served = folded_from_numpy(plan, tree, model_cfg(c)).eval()
    with torch.no_grad():
        logits, boxes, _, _ = served(x)
    assert bool(torch.isfinite(logits).all()) and bool(((boxes >= 0) & (boxes <= 1)).all())


def test_leaves_bear_the_sources_module_names(small):
    """Each leaf of the port's trees is at the path of the source's module
    below its entry (``backbone``, ``encoder``, ``decoder``)."""
    c, _, unfused = small
    model = FoldedYOLOv3(model_cfg(c))
    entries = ("backbone", "encoder", "decoder")
    got = [".".join([entries[i], *map(str, path)]) for i, path, _ in conv_paths(model.layers)]
    assert sorted(got) == sorted(unfused)
    assert "decoder.decoder.layers.1.cross_attn.sampling_offsets" in got
    assert "encoder.encoder.0.layers.0.self_attn.in_proj" in got
    assert "backbone.res_layers.1.blocks.0.short" in got


@pytest.mark.parametrize("what", ["quantize", "layout", "darknet", "train", "bundle", "export"])
def test_what_rtdetr_does_not_take_raises(small, what, tmp_path):
    """One predicate refuses an RT-DETR plan on each path, naming the family,
    its entries and what is missing."""
    c, x, unfused = small
    match = (r"an RT-DETR plan \(ResNet-vd backbone, hybrid encoder, deformable decoder\): ")
    if what == "quantize":
        with pytest.raises(ValueError, match="int8 PTQ does not take " + match + "no int8"):
            _predictor(c, unfused).quantize(x)
    elif what == "layout":
        with pytest.raises(ValueError,
                           match="spatial partitioning does not take " + match + "no halo"):
            _predictor(c, unfused).model(x, layout=object())
    elif what == "darknet":
        from yolo_for_turbines_tpu_torch.models.darknet_weights import load_darknet_into

        with pytest.raises(ValueError, match="darknet reader does not take " + match + "the layer"):
            load_darknet_into(str(tmp_path / "rtdetr.weights"), YOLOv3(model_cfg(c)))
    elif what == "train":
        from yolo_for_turbines_tpu_torch.config import TrainConfig
        from yolo_for_turbines_tpu_torch.train.trainer import Trainer

        with pytest.raises(ValueError, match="Trainer does not take " + match + "its training"):
            Trainer(TrainConfig(), model_cfg=model_cfg(c), device="cpu")
    else:
        from yolo_for_turbines_tpu_torch import serving

        pred = _predictor(c, unfused)
        with pytest.raises(ValueError, match=match + "its postprocess"):
            if what == "bundle":
                serving.save_predictor(pred, tmp_path / "bundle")
            else:
                serving.export_serving_module(pred, 1)
        assert not (tmp_path / "bundle").exists()


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect

    for module in (rt, weights_rtdetr, offline_rtdetr):
        tree = ast.parse(inspect.getsource(module))
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names if n.startswith("jax")]
    for module in (rt, weights_rtdetr):
        tree = ast.parse(inspect.getsource(module))
        names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        assert not [n for n in names if n.startswith("yolo_for_turbines")]


def _tiny_bench(tmp_path):
    """The real BENCHMARK.json with the RT-DETR configuration cut to the
    small size and its mix to a few tiny batches, the first of which is
    checked."""
    from perfbench.manifest import Bench

    real = Bench.load(HERE.parent / "BENCHMARK.json")
    (tmp_path / "rt.json").write_text(json.dumps(small_cfg()))
    data = json.loads(json.dumps(real.data))
    for c in data["configs"]:
        c["file"] = "rt.json" if c["name"] == "rtdetr-r50vd-coco640" else str(HERE.parent / c["file"])
    bench = Bench(data, tmp_path, HERE)
    mix = bench.mix
    bench.mix = lambda cell: {**mix(cell), "batch": 4, "pool": 2, "check_batches": 1,
                              "check_within": 1, "trace_iterations": 3,
                              "warm_iterations": 1}
    return bench


@pytest.mark.parametrize("variant", ["program", "control", "mean_score", "refs_transposed"])
def test_the_rtdetr_cell_at_a_small_size(tmp_path, monkeypatch, variant):
    """The RT-DETR cell through the harness on the CPU (float32): the
    program is correct and its traced run reports the new metrics (K5's
    roofline none: no kernel runs on the CPU); the control (the reference
    through float8) and each fault planted in the program are not, the
    faults by the check each is planted for."""
    import time

    from perfbench import run

    monkeypatch.setattr(profiling, "deform_samples", 0)
    bench = _tiny_bench(tmp_path)
    cell = bench.cell(CELL)
    result = run.run_cell(bench, cell, 2**31 + 7, 0.5, variant == "program", "cpu",
                          time.perf_counter(), variant=variant, emit=lambda line: None)
    assert result["correct"] == (variant == "program"), result["checks"]
    failed = {k for k, v in result["checks"].items() if v["value"] > v["limit"]}
    if variant in offline_rtdetr.FAULTS:
        assert failed == {{"mean_score": "select_missed",
                           "refs_transposed": "decoder_rel_rms"}[variant]}, result["checks"]
    if variant == "program":
        metrics = result["metrics"]
        assert {"detr.mfu", "detr.encoder_ms", "detr.decoder_ms", "detr.deform_ms",
                "detr.deform_msamples", "v4.concat_mb", "offline.forward_ms",
                "offline.postproc_ms", "offline.device_idle", "offline.pool_ms"} <= set(metrics)
        assert "detr.epilogue_roofline" not in metrics
        assert metrics["detr.deform_msamples"]["value"] * 1e6 == pytest.approx(4 * 32 * 48 * 2)
        checks = {k: v["value"] for k, v in result["checks"].items()}
        assert checks["select_missed"] == 0 and checks["memory_rel_rms"] < 1e-5


def test_the_rtdetr_cell_sees_a_wrong_sampler(tmp_path, monkeypatch):
    """The sampling grid's x and y swapped in the program's sampler (the
    row read for the column): the decoder's outputs lose the reference."""
    import time

    from perfbench import run

    import types

    shim = types.SimpleNamespace(**vars(F))
    shim.grid_sample = lambda v, grid, **k: F.grid_sample(v, grid.flip(-1), **k)
    monkeypatch.setattr(deform_kernel, "F", shim)
    bench = _tiny_bench(tmp_path)
    result = run.run_cell(bench, bench.cell(CELL), 2**31 + 9, 0.5, False, "cpu",
                          time.perf_counter(), emit=lambda line: None)
    assert not result["correct"], result["checks"]


def test_selection_misses_count_invalid_tokens_as_one():
    valid = [True] * 6 + [False] * 4
    got = torch.tensor([[0, 1, 6, 7]])
    assert offline_rtdetr.missed(got, torch.tensor([[0, 1, 8, 9]]), valid) == 0
    assert offline_rtdetr.missed(got, torch.tensor([[0, 2, 8, 9]]), valid) == 1
    assert offline_rtdetr.missed(got, torch.tensor([[0, 1, 2, 9]]), valid) == 1
    assert offline_rtdetr.missed(torch.tensor([[0, 1, 2, 3]]), torch.tensor([[6, 7, 8, 9]]),
                                 valid) == 4
