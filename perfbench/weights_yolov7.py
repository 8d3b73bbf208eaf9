"""Weights of the YOLOv7 configuration from ``--seed``, made on the device.

:func:`folded` is ``weights.py::folded`` over YOLOv7's walk
(``reference/yolov7.py``), in its deploy form (RepConv and IDetect already
re-parameterised): each conv's weight drawn U(-1/sqrt(fan_in),
1/sqrt(fan_in)) from one draw; a BN conv calibrated on a few images of the
cell's own traffic (each output channel normalised over those images, then
a scale U(0.5, 1.5) and a shift N(0, 1)); each objectness row of a head's
last 1x1 scaled and shifted so that its logits on those images have mean
``weights.OBJECTNESS_MEAN`` and standard deviation
``weights.OBJECTNESS_STD``. YOLOv7 has no residual add, so no branch gain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import weights
from .reference import model as ref
from .reference import yolov7 as v7


@torch.no_grad()
def folded(cfg: dict, seed: int, images: torch.Tensor):
    """(plan, tree): the reference's plan and its folded tree (``{"w": OIHW,
    "b"}`` per conv, float32 on the images' device), calibrated on
    ``images`` (N, S, S, 3) in [0, 1]."""
    device = images.device
    plan = v7.parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    specs = v7.conv_specs(plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = {s["path"]: w for s, w in zip(specs, weights._draws(specs, gen, device))}
    channels = sum(s["cout"] for s in specs)
    gamma = torch.rand(channels, generator=gen, device=device) + 0.5
    beta = weights.SHIFT_STD * torch.randn(channels, generator=gen, device=device)
    head_bias = torch.rand(channels, generator=gen, device=device) * 2 - 1
    spec_of, offsets, at = {}, {}, 0
    for s in specs:
        spec_of[s["path"]], offsets[s["path"]] = s, at
        at += s["cout"]
    tree = v7.empty_tree(plan)
    c5 = cfg["num_classes"] + 5

    def conv(path, x, stride, act):
        spec, w, at = spec_of[path], drawn[path], offsets[path]
        node = ref.leaf(tree, path)
        pad = spec["k"] // 2
        if spec["bn"]:
            y = F.conv2d(x, w, stride=stride, padding=pad)
            mean, std = y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3)).clamp(min=1e-6)
            g = gamma[at : at + spec["cout"]] / std
            node["w"] = w * g[:, None, None, None]
            node["b"] = beta[at : at + spec["cout"]] - mean * g
        else:
            b = head_bias[at : at + spec["cout"]] * ref.uniform_bound(spec["cin"], spec["k"])
            w, b = w.clone(), b.clone()
            free = F.conv2d(x, w)
            for a in range(spec["cout"] // c5):
                row = a * c5 + 4
                gain = weights.OBJECTNESS_STD / free[:, row].std()
                w[row] *= gain
                b[row] = weights.OBJECTNESS_MEAN - gain * free[:, row].mean()
            node["w"], node["b"] = w, b
        y = F.conv2d(x, node["w"], node["b"], stride=stride, padding=pad)
        return v7.silu(y) if act else y

    with ref.exact_f32():
        v7.walk(plan, images.float().permute(0, 3, 1, 2), conv, lambda e, y: y)
    return plan, tree
