"""Plain float32 YOLOv7 in PyTorch: the reference of the YOLOv7 cell.

YOLOv7 (Wang, Bochkovskiy and Liao, arXiv:2207.02696) in the deploy form of
``cfg/deploy/yolov7.yaml`` (layers 0-105 of ``cfg/training/yolov7.yaml``
with RepConv and IDetect re-parameterised), read from the configuration
file's layer list. ``Conv(c, k, s)`` is a conv with padding k // 2 and BN
folded into a bias, then SiLU, ``x * sigmoid(x)``:

- ``[out, k, stride]``: ``Conv(x, out, k, stride)``;
- ``["elan", mid, q, out]`` and ``["elanh", mid, q, out]``: on x,
  ``a = Conv1x1(x, mid)``, ``b = Conv1x1(x, mid)``, the chain ``c1 =
  Conv3x3(b, q)``, ``c2 = Conv3x3(c1, q)``, ``c3 = Conv3x3(c2, q)``, ``c4 =
  Conv3x3(c3, q)``; ELAN (the backbone's) gives ``Conv1x1(cat[c4, c2, b, a],
  out)``, ELAN-H (the neck's) ``Conv1x1(cat[c4, c3, c2, c1, b, a], out)``;
- ``["mp", c]`` and ``["mp", c, route]``: ``cat[Conv3x3s2(Conv1x1(x, c), c),
  Conv1x1(maxpool2x2s2(x), c)]``, with the saved route as a third part when
  one is named;
- ``["sppcspc", c]`` (``c_ = c``): ``x1 = Conv1x1(Conv3x3(Conv1x1(x, c_)),
  c_)``, ``y1 = Conv3x3(Conv1x1(cat[x1, pool5(x1), pool9(x1), pool13(x1)],
  c_))``, ``y2 = Conv1x1(x, c_)``, out ``Conv1x1(cat[y1, y2], c)``; the
  pools stride 1, SAME, padded with -inf;
- ``["save", name]``: the trunk saved as a route;
- ``["lateral", route, out]``: ``[Conv1x1(route, out), upsample2x(x)]``;
- ``["head", scale_xy, "square"]``: a branch (the trunk continues from its
  input); deploy form ``Conv3x3(x, 2 * in)`` (RepConv, bias and SiLU), then a
  1x1 with a bias and no activation to ``A * (5 + C)`` (IDetect). Heads in
  the list's order, finest first (strides 8, 16, 32).

The training form of a head, which :func:`reparameterise` folds into the
deploy form (``repconv`` and ``implicit``):

- RepConv ``= SiLU(BN(conv3x3(x)) + BN(conv1x1(x)) [+ BN(x) when in == out
  and stride 1])``: each branch's BN folded into its kernel, the 1x1 kernel
  zero-padded into the 3x3's centre, the identity as a 3x3 kernel with a 1
  at the centre of its own channel, and the kernels and biases summed;
- IDetect's 1x1 ``= ImplicitM * (W (x + ImplicitA) + b)``, which folds to
  ``W' = m W`` and ``b' = m (b + W a)``.

The decode (:func:`decode`) at each scale of side S, with ``sigmoid`` the
logistic function and anchors in pixels / 640: ``cx = (2 sigmoid(tx) - 0.5
+ j) / S`` (``cy`` likewise with the row i), ``w = (2 sigmoid(tw))^2 *
anchor_w``, score ``sigmoid(t_obj)``, class the argmax.

Departures from YOLOv7, shared with the program: BN is folded into each
conv (serving), and the score is the objectness alone (YOLOv7 multiplies it
by the class probability).

It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from .model import _conv, leaf

# which chain outputs (1-4; 0 is b) each ELAN form joins, deepest first
PICKS = {"elan": (4, 2), "elanh": (4, 3, 2, 1)}
POOLS = (5, 9, 13)
BN_EPS = 1e-5


def silu(x):
    return x * torch.sigmoid(x)


def parse(layers, in_channels: int, num_classes: int, anchors_per_scale: int = 3) -> List[dict]:
    """The layer list as entries: ``conv`` (cin, cout, k, stride), ``elan``
    (cin, mid, q, cout, picks), ``mp`` (cin, c, route, route_c), ``sppcspc``
    (cin, c), ``save`` (name), ``lateral`` (route, cin, cout) and ``head``
    (cin, mid, out, scale_xy)."""
    out = []
    c = in_channels
    saved = {}
    for item in layers:
        tag = item[0] if isinstance(item[0], str) else None
        if tag is None:
            cout, k, s = item
            out.append({"kind": "conv", "cin": c, "cout": cout, "k": k, "stride": s})
            c = cout
        elif tag in PICKS:
            _, mid, q, cout = item
            out.append({"kind": "elan", "cin": c, "mid": mid, "q": q, "cout": cout,
                        "picks": PICKS[tag]})
            c = cout
        elif tag == "mp":
            route = item[2] if len(item) > 2 else None
            route_c = saved[route] if route is not None else 0
            out.append({"kind": "mp", "cin": c, "c": item[1], "route": route,
                        "route_c": route_c})
            c = 2 * item[1] + route_c
        elif tag == "sppcspc":
            out.append({"kind": "sppcspc", "cin": c, "c": item[1]})
            c = item[1]
        elif tag == "save":
            out.append({"kind": "save", "name": item[1]})
            saved[item[1]] = c
        elif tag == "lateral":
            out.append({"kind": "lateral", "route": item[1], "cin": saved[item[1]],
                        "cout": item[2]})
            c += item[2]
        elif tag == "head":
            if item[2:] != ["square"]:
                raise ValueError(f"a YOLOv7 head decodes sizes squared: {item!r}")
            out.append({"kind": "head", "cin": c, "mid": 2 * c,
                        "out": anchors_per_scale * (5 + num_classes),
                        "scale_xy": float(item[1])})
        else:
            raise ValueError(f"unknown layer {item!r}")
    return out


def conv_specs(plan) -> List[dict]:
    """Every conv: its path in the weight tree, cin, cout, k, stride and
    ``bn`` (all but a head's last 1x1)."""
    specs = []

    def add(path, cin, cout, k, stride=1, bn=True):
        specs.append({"path": path, "cin": cin, "cout": cout, "k": k, "stride": stride,
                      "bn": bn})

    for i, e in enumerate(plan):
        kind = e["kind"]
        if kind == "conv":
            add((i, "conv"), e["cin"], e["cout"], e["k"], e["stride"])
        elif kind == "elan":
            add((i, "a"), e["cin"], e["mid"], 1)
            add((i, "b"), e["cin"], e["mid"], 1)
            for j in range(4):
                add((i, "chain", j), e["mid"] if j == 0 else e["q"], e["q"], 3)
            add((i, "fuse"), len(e["picks"]) * e["q"] + 2 * e["mid"], e["cout"], 1)
        elif kind == "mp":
            add((i, "pool"), e["cin"], e["c"], 1)
            add((i, "reduce"), e["cin"], e["c"], 1)
            add((i, "down"), e["c"], e["c"], 3, 2)
        elif kind == "sppcspc":
            cin, c = e["cin"], e["c"]
            for name, shape in (("cv1", (cin, c, 1)), ("cv2", (cin, c, 1)), ("cv3", (c, c, 3)),
                                ("cv4", (c, c, 1)), ("cv5", (4 * c, c, 1)), ("cv6", (c, c, 3)),
                                ("cv7", (2 * c, c, 1))):
                add((i, name), *shape)
        elif kind == "lateral":
            add((i, "conv"), e["cin"], e["cout"], 1)
        elif kind == "head":
            add((i, "conv1"), e["cin"], e["mid"], 3)
            add((i, "conv2"), e["mid"], e["out"], 1, bn=False)
    return specs


def empty_tree(plan) -> list:
    """A weight tree aligned with ``plan`` with an empty dict at each conv's
    path (``conv_specs``); ``{}`` for the entries without weights."""
    tree = [{} for _ in plan]
    for s in conv_specs(plan):
        *keys, last = s["path"][1:]
        node = tree[s["path"][0]]
        for key in keys:  # an ELAN's ``chain``: a list, its indices in order
            node = node.setdefault(key, [])
        if isinstance(node, list):
            node.append({})
        else:
            node[last] = {}
    return tree


def _pool_same(x, k: int):
    p = k // 2
    return F.max_pool2d(F.pad(x, (p, p, p, p), value=float("-inf")), k, 1)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def walk(plan, x, conv: Callable, head_out: Callable, cat: Callable = None) -> List[torch.Tensor]:
    """``conv(path, x, stride, act)`` runs one conv and then SiLU when
    ``act``; ``head_out(entry, y)`` shapes a head; ``cat(parts)`` joins
    channels (``torch.cat`` along dim 1 unless given). NCHW ``x``; heads in
    the list's order."""
    cat = cat or (lambda parts: torch.cat(parts, 1))
    named = {}
    heads = []
    for i, e in enumerate(plan):
        kind = e["kind"]
        if kind == "conv":
            x = conv((i, "conv"), x, e["stride"], True)
        elif kind == "elan":
            a = conv((i, "a"), x, 1, True)
            chain = [conv((i, "b"), x, 1, True)]
            for j in range(4):
                chain.append(conv((i, "chain", j), chain[-1], 1, True))
            x = conv((i, "fuse"), cat([chain[p] for p in e["picks"]] + [chain[0], a]), 1, True)
        elif kind == "mp":
            parts = [conv((i, "down"), conv((i, "reduce"), x, 1, True), 2, True),
                     conv((i, "pool"), F.max_pool2d(x, 2, 2), 1, True)]
            if e["route"] is not None:
                parts.append(named[e["route"]])
            x = cat(parts)
        elif kind == "sppcspc":
            x1 = conv((i, "cv4"), conv((i, "cv3"), conv((i, "cv1"), x, 1, True), 1, True),
                      1, True)
            pooled = cat([x1] + [_pool_same(x1, k) for k in POOLS])
            y1 = conv((i, "cv6"), conv((i, "cv5"), pooled, 1, True), 1, True)
            y2 = conv((i, "cv2"), x, 1, True)
            x = conv((i, "cv7"), cat([y1, y2]), 1, True)
        elif kind == "save":
            named[e["name"]] = x
        elif kind == "lateral":
            x = cat([conv((i, "conv"), named[e["route"]], 1, True), _up(x)])
        elif kind == "head":
            y = conv((i, "conv1"), x, 1, True)
            heads.append(head_out(e, conv((i, "conv2"), y, 1, False)))
    return heads


def folded_forward(plan, tree, x_nhwc: torch.Tensor, quant=None):
    """Raw NHWC heads in float32, in the list's order: ``leaf(tree, path) =
    {"w": OIHW, "b"}`` per conv (BN folded in); ``quant`` (the control's
    lower precision) on every conv's input and weight."""

    def conv(path, x, stride, act):
        y = _conv(x, leaf(tree, path), stride, quant)
        return silu(y) if act else y

    x = x_nhwc.float().permute(0, 3, 1, 2)
    return walk(plan, x, conv, lambda e, y: y.permute(0, 2, 3, 1))


def scale_xy(plan) -> List[float]:
    return [e["scale_xy"] for e in plan if e["kind"] == "head"]


def decode(heads, anchors, num_classes: int, scales, dtype=torch.float32) -> torch.Tensor:
    """(B, sum(S * S * A), 6) float32 ``[cx, cy, w, h, score, class]`` rows
    from raw NHWC heads, cells-major (row, column, anchor), in the heads'
    order: ``cx = (sigmoid(tx) * scale_xy - (scale_xy - 1) / 2 + j) / S``,
    ``w = (2 sigmoid(tw))^2 * anchor_w`` (anchors normalised to the image),
    score ``sigmoid(t_obj)``, class the argmax; the box arithmetic in
    ``dtype`` (bfloat16 for the control)."""
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
        w = (torch.sigmoid(y[..., 2]) * 2) ** 2 * anc[:, 0]
        h = (torch.sigmoid(y[..., 3]) * 2) ** 2 * anc[:, 1]
        score = torch.sigmoid(y[..., 4])
        cls = torch.argmax(y[..., 5:], dim=-1).to(dtype)
        rows.append(torch.stack([cx, cy, w, h, score, cls], -1).reshape(b, -1, 6).float())
    return torch.cat(rows, 1)


def _bn_fold(w, bn, eps: float):
    """A bias-free conv ``w`` (OIHW) followed by BN ``{gamma, beta, mean,
    var}``, as one conv: ``(w * g / sqrt(v + eps), beta - mean * g /
    sqrt(v + eps))``."""
    inv = bn["gamma"] / torch.sqrt(bn["var"] + eps)
    return w * inv[:, None, None, None], bn["beta"] - bn["mean"] * inv


def repconv(p: dict, eps: float = BN_EPS) -> dict:
    """RepConv's training form ``{"w3", "bn3", "w1", "bn1"[, "bn_id"]}`` (OIHW
    kernels, BN ``{gamma, beta, mean, var}``) as one 3x3 conv ``{"w",
    "b"}``."""
    w, b = _bn_fold(p["w3"], p["bn3"], eps)
    w1, b1 = _bn_fold(p["w1"], p["bn1"], eps)
    w = w + F.pad(w1, (1, 1, 1, 1))
    b = b + b1
    if p.get("bn_id") is not None:
        c = w.shape[0]
        eye = torch.zeros_like(w)
        eye[torch.arange(c), torch.arange(c), 1, 1] = 1.0
        wi, bi = _bn_fold(eye, p["bn_id"], eps)
        w, b = w + wi, b + bi
    return {"w": w, "b": b}


def implicit(p: dict) -> dict:
    """IDetect's training-form 1x1 ``{"w", "b", "ia", "im"}`` (``ia`` over the
    input channels, ``im`` over the output ones) as one 1x1 ``{"w", "b"}``:
    ``W' = m W``, ``b' = m (b + W a)``."""
    w2 = p["w"][:, :, 0, 0]
    return {"w": p["im"][:, None, None, None] * p["w"],
            "b": p["im"] * (p["b"] + w2 @ p["ia"])}


def reparameterise(plan, tree, eps: float = BN_EPS) -> list:
    """A tree whose heads are in the training form (``conv1`` RepConv's,
    ``conv2`` IDetect's) as the deploy form's tree; every other entry as it
    is."""
    out = []
    for e, node in zip(plan, tree):
        if e["kind"] == "head":
            node = {"conv1": repconv(node["conv1"], eps), "conv2": implicit(node["conv2"])}
        out.append(node)
    return out


def conv_table(cfg: dict, size: int) -> List[dict]:
    """Every conv at a ``size`` x ``size`` input, in the order of the walk: its
    spec, input and output side, and operations per image (2 k^2 Cin Cout Ho
    Wo). The sides come from the walk itself on the meta device."""
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    spec_of = {s["path"]: s for s in conv_specs(plan)}
    out = []

    def conv(path, x, stride, act):
        s = spec_of[path]
        w = torch.empty(s["cout"], s["cin"], s["k"], s["k"], device="meta")
        y = F.conv2d(x, w, stride=stride, padding=s["k"] // 2)
        hin, hout = x.shape[2], y.shape[2]
        out.append({**s, "side_in": hin, "side_out": hout,
                    "flops": 2.0 * s["k"] ** 2 * s["cin"] * s["cout"] * hout * hout})
        return y

    walk(plan, torch.empty(1, cfg["in_channels"], size, size, device="meta"), conv,
         lambda e, y: y)
    return out


def forward_flops(cfg: dict, size: int) -> float:
    """Operations of one image's forward."""
    return sum(c["flops"] for c in conv_table(cfg, size))


def param_count(cfg: dict) -> int:
    """Weights and biases of the folded network."""
    return sum(c["cout"] * (c["cin"] * c["k"] ** 2 + 1) for c in conv_table(cfg, 32))


def concat_elements(cfg: dict, size: int) -> int:
    """Elements that the walk's channel concats write per image."""
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    spec_of = {s["path"]: s for s in conv_specs(plan)}
    total = [0]

    def conv(path, x, stride, act):
        s = spec_of[path]
        w = torch.empty(s["cout"], s["cin"], s["k"], s["k"], device="meta")
        return F.conv2d(x, w, stride=stride, padding=s["k"] // 2)

    def cat(parts):
        y = torch.cat(parts, 1)
        total[0] += y[0].numel()
        return y

    walk(plan, torch.empty(1, cfg["in_channels"], size, size, device="meta"), conv,
         lambda e, y: y, cat)
    return total[0]


def epilogue_bytes(cfg: dict, size: int, batch: int) -> float:
    """Bytes of every conv's epilogue at ``batch`` images: its output read and
    written once in bf16 (4 bytes an element; YOLOv7 has no residual add)."""
    return float(sum(batch * c["side_out"] ** 2 * c["cout"] * 4 for c in conv_table(cfg, size)))
