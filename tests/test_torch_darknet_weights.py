"""Torch port: darknet binary weights
(``yolo_for_turbines_tpu_torch/models/darknet_weights.py``) against the JAX
package's ``models/darknet_weights.py``.

A file the JAX package exports is read by both loaders: equal trees bit for
bit, the same float count and the same freeze mask, for the whole file and
for ``.conv.N`` cutoffs; the port's exporter writes the same bytes; the
port loads the file into its trainable module and names the parameters
that the mask freezes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from helpers import MINI_LAYERS, mini_model
from yolo_for_turbines_tpu.config import ModelConfig as JaxModelConfig
from yolo_for_turbines_tpu.models import darknet_weights as jdw
from yolo_for_turbines_tpu.models import yolov3 as jyolo
from yolo_for_turbines_tpu_torch.config import ModelConfig
from yolo_for_turbines_tpu_torch.models import darknet_weights as dw
from yolo_for_turbines_tpu_torch.models.convert import trainable_to_numpy
from yolo_for_turbines_tpu_torch.models.yolov3 import YOLOv3, build_plan


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The mini model's JAX init, exported by the JAX package, and a second
    init to load into."""
    model = mini_model(num_classes=2)
    params, stats = model.init(jax.random.PRNGKey(0))
    params, stats = jax.tree_util.tree_map(np.asarray, (params, stats))
    path = tmp_path_factory.mktemp("darknet") / "mini.weights"
    jdw.export_darknet_weights(model.plan, params, stats, str(path))
    other = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(7)))
    return model, params, stats, path, other


def _plan():
    return build_plan(ModelConfig(num_classes=2, layer_config=MINI_LAYERS))


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_plans_have_the_same_darknet_layout():
    def layout(plan):
        return [(type(e).__name__, dataclasses.astuple(e)) for e in plan]

    assert layout(_plan()) == layout(mini_model(num_classes=2).plan)
    for classes in (2, 80):
        full = build_plan(ModelConfig(num_classes=classes))
        assert dw.expected_num_floats(full) == jdw.expected_num_floats(
            jyolo.YOLOv3(JaxModelConfig(num_classes=classes)).plan)
    assert dw.expected_num_floats(build_plan(ModelConfig(num_classes=80))) == 62_001_757


@pytest.mark.parametrize("name", ["darknet53.conv.74", "x/yolov3.weights", "a.conv.4"])
def test_parse_cutoff_matches_jax(name):
    assert dw.parse_cutoff(name) == jdw.parse_cutoff(name)


def test_port_export_writes_the_same_bytes(exported, tmp_path):
    model, params, stats, path, _ = exported
    dw.export_darknet_weights(_plan(), params, stats, str(tmp_path / "port.weights"))
    assert (tmp_path / "port.weights").read_bytes() == path.read_bytes()
    got_h, got_w = dw.read_weights_file(str(path))
    want_h, want_w = jdw.read_weights_file(str(path))
    np.testing.assert_array_equal(got_h, want_h)
    np.testing.assert_array_equal(got_w, want_w)


# cutoffs: 4 = the first two convs; 9 = into the first residual block's
# second conv (odd: its BN loads, its conv does not); 74 = the whole mini file
@pytest.mark.parametrize("cutoff", [None, 4, 9, 74])
@pytest.mark.parametrize("freeze", [False, True])
def test_both_loaders_give_equal_trees_count_and_mask(exported, tmp_path, cutoff, freeze):
    model, _, _, path, (params2, stats2) = exported
    if cutoff is not None:
        cut = tmp_path / f"mini.conv.{cutoff}"
        cut.write_bytes(path.read_bytes())
        path = cut
    want = jdw.load_darknet_weights(str(path), model.plan, params2, stats2, freeze=freeze)
    got = dw.load_darknet_weights(str(path), _plan(), params2, stats2, freeze=freeze)
    _assert_trees_equal(got[0], want[0])
    _assert_trees_equal(got[1], want[1])
    assert jax.tree_util.tree_flatten(got[2]) == jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(bool, want[2]))
    assert got[3] == want[3] == dw.expected_num_floats(_plan())
    assert any(jax.tree_util.tree_leaves(got[2])) == freeze


@pytest.mark.parametrize("freeze", [False, True])
def test_load_into_the_module_and_name_frozen_parameters(exported, tmp_path, freeze):
    model, params, stats, path, (params2, stats2) = exported
    cut = tmp_path / "mini.conv.10"
    cut.write_bytes(path.read_bytes())
    want_p, want_s, mask, consumed = jdw.load_darknet_weights(
        str(cut), model.plan, params2, stats2, freeze=freeze)
    cfg = ModelConfig(num_classes=2, layer_config=MINI_LAYERS)
    port = YOLOv3(cfg, generator=torch.Generator().manual_seed(0))
    from yolo_for_turbines_tpu_torch.models.convert import load_trainable

    load_trainable(port, params2, stats2)  # start from the same second init
    names, got_consumed = dw.load_darknet_into(str(cut), port, freeze=freeze)
    assert got_consumed == consumed
    got_p, got_s = trainable_to_numpy(port)
    _assert_trees_equal(got_p, jax.tree_util.tree_map(np.asarray, want_p))
    _assert_trees_equal(got_s, jax.tree_util.tree_map(np.asarray, want_s))
    # cutoff 10 = 5 conv layers: conv 0, conv 1, the first block's pair and
    # conv 3, each {w, scale, bias}
    params_by_name = dict(port.named_parameters())
    if freeze:
        assert len(names) == 5 * 3 and set(names) <= params_by_name.keys()
        assert names[:3] == ["layers.0.conv.weight", "layers.0.bn.weight", "layers.0.bn.bias"]
        assert "layers.3.conv.weight" in names and "layers.4.blocks.0.conv1.conv.weight" not in names
    else:
        assert names == []
    n_true = sum(jax.tree_util.tree_leaves(jax.tree_util.tree_map(bool, mask)))
    assert len(names) == n_true


def test_heads_load_bias_and_weight(exported):
    """A full file fills the heads' bias convs ({w, b}) too."""
    model, params, stats, path, (params2, stats2) = exported
    got_p, _, mask, _ = dw.load_darknet_weights(str(path), _plan(), params2, stats2, freeze=True)
    head = next(i for i, e in enumerate(_plan()) if type(e).__name__ == "PlanHead")
    np.testing.assert_array_equal(got_p[head]["conv2"]["b"], params[head]["conv2"]["b"])
    np.testing.assert_array_equal(got_p[head]["conv2"]["w"], params[head]["conv2"]["w"])
    assert mask[head]["conv2"] == {"w": True, "b": True}
    port = YOLOv3(ModelConfig(num_classes=2, layer_config=MINI_LAYERS))
    names = dw.frozen_parameter_names(port, mask)
    assert f"layers.{head}.conv2.conv.bias" in names
    assert len(names) == len(list(port.parameters()))


def test_short_file_raises(exported, tmp_path):
    model, _, _, path, (params2, stats2) = exported
    short = tmp_path / "short.weights"
    short.write_bytes(path.read_bytes()[:-4])
    with pytest.raises(ValueError, match="exhausted"):
        dw.load_darknet_weights(str(short), _plan(), params2, stats2)
