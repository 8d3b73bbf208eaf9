"""Plain float32 YOLOv4 in PyTorch: the reference of the YOLOv4 cell.

YOLOv4 (Bochkovskiy, Wang and Liao, arXiv:2004.10934) as darknet's
``cfg/yolov4.cfg`` builds it, read from the configuration file's layer list:

- ``[out, k, stride]``: a conv, BN folded (conv + bias), then the current
  activation;
- ``["C", n]``: a CSP stage of n residual blocks at the input's width c
  (CSPDarknet-53): a shortcut 1x1 and a main 1x1 to b channels (b = c in
  the first stage, c / 2 after), n blocks ``y + conv3x3(conv1x1(y, c / 2),
  b)``, a transition 1x1, and a 1x1 to c on ``[transition, shortcut]``;
- ``["act", name]``: the activation of every conv after it (mish in the
  backbone, leaky 0.1 from the neck on);
- ``["spp", 5, 9, 13]``: ``[pool13(x), pool9(x), pool5(x), x]``, stride-1
  max pools with SAME padding (-inf);
- ``["save", name]``: the trunk saved as a route;
- ``["lateral", route, out]``: ``[conv1x1(route, out), upsample2x(x)]``;
- ``["join", route]``: ``[x, route]``;
- ``["head", scale_xy]``: a 3x3 conv to twice the width and a 1x1 with a
  bias and no activation to A * (5 + C), a branch (the trunk continues from
  its input); heads in the list's order.

:func:`folded_forward` gives the raw NHWC heads, :func:`decode` the boxes
of YOLOv4's grid-sensitive decode (each scale's offset ``sigmoid(t) *
scale_xy - (scale_xy - 1) / 2``), :func:`conv_table` the operations of each
conv (2 k^2 Cin Cout Ho Wo, as ``roofline.py`` counts YOLOv3's).

Departures from darknet, shared with the program: BN is folded into each
conv (serving), and the score is the objectness alone (darknet multiplies
it by the class probability).

It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from .model import _conv, activation, leaf


def parse(layers, in_channels: int, num_classes: int, anchors_per_scale: int = 3) -> List[dict]:
    """The layer list as entries: ``conv`` (cin, cout, k, stride), ``csp``
    (c, n, b, h), ``act`` (name), ``spp`` (kernels), ``save`` (name),
    ``lateral`` (route, cin, cout), ``join`` (route) and ``head`` (cin, mid,
    out, scale_xy)."""
    out = []
    c = in_channels
    saved = {}
    first_csp = True
    for item in layers:
        tag = item[0] if isinstance(item[0], str) else None
        if tag is None:
            cout, k, s = item
            out.append({"kind": "conv", "cin": c, "cout": cout, "k": k, "stride": s})
            c = cout
        elif tag == "C":
            b = c if first_csp else c // 2
            out.append({"kind": "csp", "c": c, "n": item[1], "b": b, "h": c // 2})
            first_csp = False
        elif tag == "act":
            activation(item[1])
            out.append({"kind": "act", "name": item[1]})
        elif tag == "spp":
            out.append({"kind": "spp", "kernels": list(item[1:])})
            c *= len(item)
        elif tag == "save":
            out.append({"kind": "save", "name": item[1]})
            saved[item[1]] = c
        elif tag == "lateral":
            out.append({"kind": "lateral", "route": item[1], "cin": saved[item[1]],
                        "cout": item[2]})
            c += item[2]
        elif tag == "join":
            out.append({"kind": "join", "route": item[1]})
            c += saved[item[1]]
        elif tag == "head":
            out.append({"kind": "head", "cin": c, "mid": 2 * c,
                        "out": anchors_per_scale * (5 + num_classes), "scale_xy": float(item[1])})
        else:
            raise ValueError(f"unknown layer {item!r}")
    return out


def conv_specs(plan) -> List[dict]:
    """Every conv in the order of the walk: its path in the weight tree, cin,
    cout, k, stride, ``bn`` (all but a head's last 1x1) and ``branch`` (a
    CSP block's 3x3, the residual branch)."""
    specs = []

    def add(path, cin, cout, k, stride=1, bn=True, branch=False):
        specs.append({"path": path, "cin": cin, "cout": cout, "k": k, "stride": stride,
                      "bn": bn, "branch": branch})

    for i, e in enumerate(plan):
        if e["kind"] == "conv":
            add((i, "conv"), e["cin"], e["cout"], e["k"], e["stride"])
        elif e["kind"] == "csp":
            c, b, h = e["c"], e["b"], e["h"]
            add((i, "split1"), c, b, 1)
            add((i, "split2"), c, b, 1)
            for j in range(e["n"]):
                add((i, "blocks", j, "conv1"), b, h, 1)
                add((i, "blocks", j, "conv2"), h, b, 3, branch=True)
            add((i, "transition"), b, b, 1)
            add((i, "fuse"), 2 * b, c, 1)
        elif e["kind"] == "lateral":
            add((i, "conv"), e["cin"], e["cout"], 1)
        elif e["kind"] == "head":
            add((i, "conv1"), e["cin"], e["mid"], 3)
            add((i, "conv2"), e["mid"], e["out"], 1, bn=False)
    return specs


def empty_tree(plan) -> list:
    """A weight tree aligned with ``plan`` with an empty dict at each conv's
    path (``conv_specs``); ``{}`` for the entries without weights."""
    tree = []
    for e in plan:
        if e["kind"] in ("conv", "lateral"):
            tree.append({"conv": {}})
        elif e["kind"] == "csp":
            tree.append({"split1": {}, "split2": {}, "transition": {}, "fuse": {},
                         "blocks": [{"conv1": {}, "conv2": {}} for _ in range(e["n"])]})
        elif e["kind"] == "head":
            tree.append({"conv1": {}, "conv2": {}})
        else:
            tree.append({})
    return tree


def _pool_same(x, k: int):
    p = k // 2
    return F.max_pool2d(F.pad(x, (p, p, p, p), value=float("-inf")), k, 1)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def walk(plan, x, conv: Callable, head_out: Callable, act_name: str) -> List[torch.Tensor]:
    """``conv(path, x, stride, act)`` runs one conv and then ``act`` (None:
    none); ``head_out(entry, y)`` shapes a head. NCHW ``x``; heads in the
    list's order."""
    act = activation(act_name)
    named = {}
    heads = []
    for i, e in enumerate(plan):
        kind = e["kind"]
        if kind == "conv":
            x = conv((i, "conv"), x, e["stride"], act)
        elif kind == "csp":
            shortcut = conv((i, "split1"), x, 1, act)
            y = conv((i, "split2"), x, 1, act)
            for j in range(e["n"]):
                y = y + conv((i, "blocks", j, "conv2"),
                             conv((i, "blocks", j, "conv1"), y, 1, act), 1, act)
            y = conv((i, "transition"), y, 1, act)
            x = conv((i, "fuse"), torch.cat([y, shortcut], 1), 1, act)
        elif kind == "act":
            act = activation(e["name"])
        elif kind == "spp":
            x = torch.cat([_pool_same(x, k) for k in reversed(e["kernels"])] + [x], 1)
        elif kind == "save":
            named[e["name"]] = x
        elif kind == "lateral":
            x = torch.cat([conv((i, "conv"), named[e["route"]], 1, act), _up(x)], 1)
        elif kind == "join":
            x = torch.cat([x, named[e["route"]]], 1)
        elif kind == "head":
            y = conv((i, "conv1"), x, 1, act)
            heads.append(head_out(e, conv((i, "conv2"), y, 1, None)))
    return heads


def folded_forward(plan, tree, x_nhwc: torch.Tensor, act_name: str, quant=None):
    """Raw NHWC heads in float32, in the list's order: ``leaf(tree, path) =
    {"w": OIHW, "b"}`` per conv (BN folded in); ``quant`` (the control's
    lower precision) on every conv's input and weight."""

    def conv(path, x, stride, act):
        y = _conv(x, leaf(tree, path), stride, quant)
        return act(y) if act is not None else y

    x = x_nhwc.float().permute(0, 3, 1, 2)
    return walk(plan, x, conv, lambda e, y: y.permute(0, 2, 3, 1), act_name)


def scale_xy(plan) -> List[float]:
    return [e["scale_xy"] for e in plan if e["kind"] == "head"]


def decode(heads, anchors, num_classes: int, scales, dtype=torch.float32) -> torch.Tensor:
    """(B, sum(S * S * A), 6) float32 ``[cx, cy, w, h, score, class]`` rows
    from raw NHWC heads, cells-major (row, column, anchor), in the heads'
    order: ``cx = (sigmoid(tx) * scale_xy - (scale_xy - 1) / 2 + j) / S``
    (``cy`` likewise with the row i), ``w = exp(tw) * anchor_w`` (anchors
    normalised to the image), score ``sigmoid(t_obj)``, class the argmax;
    the box arithmetic in ``dtype`` (bfloat16 for the control)."""
    rows = []
    for raw, anc, alpha in zip(heads, anchors, scales):
        b, s = raw.shape[0], raw.shape[1]
        a = len(anc)
        y = raw.to(dtype).reshape(b, s, s, a, 5 + num_classes)
        grid = torch.arange(s, dtype=dtype, device=raw.device)
        anc = torch.as_tensor(np.asarray(anc, np.float32), device=raw.device).to(dtype)
        shift = (alpha - 1.0) / 2
        cx = (torch.sigmoid(y[..., 0]) * alpha - shift + grid[None, None, :, None]) / s
        cy = (torch.sigmoid(y[..., 1]) * alpha - shift + grid[None, :, None, None]) / s
        w = torch.exp(y[..., 2]) * anc[:, 0]
        h = torch.exp(y[..., 3]) * anc[:, 1]
        score = torch.sigmoid(y[..., 4])
        cls = torch.argmax(y[..., 5:], dim=-1).to(dtype)
        rows.append(torch.stack([cx, cy, w, h, score, cls], -1).reshape(b, -1, 6).float())
    return torch.cat(rows, 1)


def conv_table(cfg: dict, size: int) -> List[dict]:
    """Every conv at a ``size`` x ``size`` input: its spec, input and output
    side, and operations per image (2 k^2 Cin Cout Ho Wo)."""
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    by_entry = {}
    for s in conv_specs(plan):
        by_entry.setdefault(s["path"][0], []).append(s)
    out = []
    side = size
    saved = {}

    def add(spec, hin):
        hout = (hin + 2 * (spec["k"] // 2) - spec["k"]) // spec["stride"] + 1
        out.append({**spec, "side_in": hin, "side_out": hout,
                    "flops": 2.0 * spec["k"] ** 2 * spec["cin"] * spec["cout"] * hout * hout})
        return hout

    for i, e in enumerate(plan):
        if e["kind"] == "conv":
            side = add(by_entry[i][0], side)
        elif e["kind"] in ("csp", "head"):
            for s in by_entry[i]:
                add(s, side)
        elif e["kind"] == "save":
            saved[e["name"]] = side
        elif e["kind"] == "lateral":
            add(by_entry[i][0], saved[e["route"]])
            side *= 2
    return out


def forward_flops(cfg: dict, size: int) -> float:
    """Operations of one image's forward."""
    return sum(c["flops"] for c in conv_table(cfg, size))
