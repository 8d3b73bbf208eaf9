"""The traffic generators: the same seed gives the same inputs; every seed
the same sizes and counts."""

import numpy as np
import torch

from perfbench import traffic
from perfbench.manifest import HERE
import json


def cfg():
    return json.loads((HERE / "configs" / "yolov3-turbines416.json").read_text())


def test_device_images_by_seed():
    a = traffic.device_images(torch.Generator().manual_seed(5), 2, 32, "cpu")
    b = traffic.device_images(torch.Generator().manual_seed(5), 2, 32, "cpu")
    c = traffic.device_images(torch.Generator().manual_seed(6), 2, 32, "cpu")
    assert a.shape == (2, 32, 32, 3) and torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1


def test_host_images_by_seed_same_sizes_for_every_seed():
    sizes = [[40, 30], [64, 48]]
    (a, oa), (b, ob) = traffic.host_images(2**31 + 9, sizes, 2), traffic.host_images(2**31 + 9, sizes, 2)
    c, oc = traffic.host_images(7, sizes, 2)
    assert oa == ob and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert [x.shape for x in a] == [x.shape for x in c] == [(30, 40, 3)] * 2 + [(48, 64, 3)] * 2
    assert sorted(oa) == sorted(oc) == [0, 1, 2, 3]
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_train_batch_by_seed():
    mix = json.loads((HERE / "traffic" / "train-b32.json").read_text())
    mix = {**mix, "batch": 3}
    small = {**cfg(), "image_size": 64}

    def make(seed):
        return traffic.train_batch(torch.Generator().manual_seed(seed),
                                   np.random.default_rng(seed), mix, small, "cpu")

    (xa, ta), (xb, tb), (xc, tc) = make(1), make(1), make(2)
    assert torch.equal(xa, xb) and all(torch.equal(p, q) for p, q in zip(ta, tb))
    assert not torch.equal(xa, xc)
    assert [tuple(t.shape) for t in ta] == [(3, 3, 2, 2, 6), (3, 3, 4, 4, 6), (3, 3, 8, 8, 6)]
    objects = sum(int((t[..., 4] == 1).sum()) for t in ta)
    assert 3 * 1 <= objects <= 3 * 4 * 3  # 1-4 boxes per image, one anchor per scale each


def test_assign_targets_marks_best_anchor_and_ignores():
    anchors = np.asarray(cfg()["anchors"], np.float64).reshape(-1, 2)
    grids = traffic.assign_targets([[0.5, 0.5, 0.2, 0.45, 1]], anchors, [13, 26, 52])
    assert sum(int((g[..., 4] == 1).sum()) for g in grids) == 3
    g = grids[0]
    a, i, j = [int(v[0]) for v in np.nonzero(g[..., 4] == 1)]
    assert (i, j) == (6, 6) and g[a, i, j, 5] == 1
    assert np.allclose(g[a, i, j, :4], [0.5, 0.5, 0.2 * 13, 0.45 * 13])
