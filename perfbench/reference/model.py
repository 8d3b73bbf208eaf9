"""Plain float32 YOLOv3 in PyTorch: the benchmark's reference model.

It reads the layer list of a configuration file (the ``yolov3.cfg`` order
as a short list: ``[out, k, stride]`` convs, ``["B", n]`` residual stages,
``"S"`` a scale's head, ``"U"`` an upsample and concat) and computes, with
torch operations alone:

- :func:`folded_forward`: the serving forward over BN-folded weights
  (conv + bias + activation per layer), raw NHWC heads;
- :func:`train_forward`: the training forward (conv, batch-statistics BN,
  activation), heads ``(B, A, S, S, 5 + C)``, running statistics updated.

The walk is YOLOv3's (Redmon and Farhadi, arXiv:1804.02767): the 8-block
stages' outputs are saved as routes, each upsample is concatenated with the
last route saved (``[upsampled, route]``), and a head branches off the trunk,
which continues from the head's input. ``quant`` (the control's lower
precision) is applied to every conv's input and weight when given.

It imports nothing of the measured program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def parse(layers, in_channels: int, num_classes: int, anchors_per_scale: int = 3) -> List[dict]:
    """The layer list as entries: ``conv`` (cin, cout, k, stride), ``res`` (c,
    n, residual, route), ``head`` (cin, mid, out) and ``up`` (cin)."""
    out = []
    c = in_channels
    for item in layers:
        if isinstance(item, list) and item[0] == "B":
            out.append({"kind": "res", "c": c, "n": item[1], "residual": True,
                        "route": item[1] == 8})
        elif isinstance(item, list):
            cout, k, s = item
            out.append({"kind": "conv", "cin": c, "cout": cout, "k": k, "stride": s})
            c = cout
        elif item == "S":
            out.append({"kind": "res", "c": c, "n": 1, "residual": False, "route": False})
            out.append({"kind": "conv", "cin": c, "cout": c // 2, "k": 1, "stride": 1})
            c //= 2
            out.append({"kind": "head", "cin": c, "mid": 2 * c,
                        "out": anchors_per_scale * (5 + num_classes)})
        elif item == "U":
            out.append({"kind": "up", "cin": c})
            c *= 3  # the route has twice the channels
        else:
            raise ValueError(f"unknown layer {item!r}")
    return out


def conv_specs(plan) -> List[dict]:
    """Every conv in the order of the walk: its path in the weight tree, cin,
    cout, k, stride, and whether it is followed by BN (all but a head's last
    1x1)."""
    specs = []
    for i, e in enumerate(plan):
        if e["kind"] == "conv":
            specs.append({"path": (i, "conv"), "cin": e["cin"], "cout": e["cout"],
                          "k": e["k"], "stride": e["stride"], "bn": True})
        elif e["kind"] == "res":
            c = e["c"]
            for j in range(e["n"]):
                specs.append({"path": (i, j, "conv1"), "cin": c, "cout": c // 2, "k": 1,
                              "stride": 1, "bn": True})
                specs.append({"path": (i, j, "conv2"), "cin": c // 2, "cout": c, "k": 3,
                              "stride": 1, "bn": True})
        elif e["kind"] == "head":
            specs.append({"path": (i, "conv1"), "cin": e["cin"], "cout": e["mid"], "k": 3,
                          "stride": 1, "bn": True})
            specs.append({"path": (i, "conv2"), "cin": e["mid"], "cout": e["out"], "k": 1,
                          "stride": 1, "bn": False})
    return specs


def activation(name: str) -> Callable:
    if name == "leaky_relu":
        return lambda x: torch.where(x >= 0, x, 0.1 * x)
    if name == "mish":
        return lambda x: x * torch.tanh(F.softplus(x))
    raise ValueError(f"unknown activation {name!r}")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for convs and matmuls and no cuDNN autotuning, restored
    afterwards."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def _conv(x, p: Dict, stride: int, quant=None):
    w = p["w"]
    if quant is not None:
        x, w = quant(x), quant(w)
    k = w.shape[-1]
    return F.conv2d(x, w, p.get("b"), stride=stride, padding=k // 2)


def _walk(plan, x_nchw, conv_act: Callable, head_out: Callable) -> List[torch.Tensor]:
    """``conv_act(path, x, stride, act)`` runs one conv (and its BN and
    activation when ``act``); ``head_out(entry, y)`` shapes a head."""
    x = x_nchw
    routes: List[torch.Tensor] = []
    heads: List[torch.Tensor] = []
    for i, e in enumerate(plan):
        if e["kind"] == "conv":
            x = conv_act((i, "conv"), x, e["stride"], True)
        elif e["kind"] == "res":
            for j in range(e["n"]):
                y = conv_act((i, j, "conv1"), x, 1, True)
                y = conv_act((i, j, "conv2"), y, 1, True)
                x = x + y if e["residual"] else y
            if e["route"]:
                routes.append(x)
        elif e["kind"] == "head":
            y = conv_act((i, "conv1"), x, 1, True)
            heads.append(head_out(e, conv_act((i, "conv2"), y, 1, False)))
        elif e["kind"] == "up":
            x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), routes.pop()], 1)
    return heads


def leaf(tree, path):
    node = tree[path[0]]
    for key in path[1:]:
        node = node[key]
    return node


def folded_forward(plan, tree, x_nhwc: torch.Tensor, act_name: str, quant=None):
    """Raw NHWC heads, coarsest first, in float32: ``tree[path] = {"w": OIHW,
    "b"}`` per conv (BN folded in)."""
    act = activation(act_name)

    def conv_act(path, x, stride, use_act):
        y = _conv(x, leaf(tree, path), stride, quant)
        return act(y) if use_act else y

    x = x_nhwc.float().permute(0, 3, 1, 2)
    return _walk(plan, x, conv_act, lambda e, y: y.permute(0, 2, 3, 1))


def batch_norm_train(y, p: Dict):
    """Train-mode BN: normalise with the batch mean and biased variance over
    (N, H, W); the running statistics move by ``BN_MOMENTUM`` towards the
    batch mean and the unbiased variance (in place, outside autograd)."""
    n = y.numel() // y.shape[1]
    mean = y.mean(dim=(0, 2, 3))
    var = ((y - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    with torch.no_grad():
        p["mean"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
        p["var"].mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach() * n / (n - 1))
    inv = torch.rsqrt(var + BN_EPS)
    return (y - mean[None, :, None, None]) * (inv * p["gamma"])[None, :, None, None] \
        + p["beta"][None, :, None, None]


def train_forward(plan, tree, x_nhwc: torch.Tensor, act_name: str, num_classes: int,
                  anchors_per_scale: int = 3, quant=None):
    """Heads ``(B, A, S, S, 5 + C)`` in train mode: ``tree[path]`` holds
    ``w`` (OIHW), ``gamma``, ``beta``, ``mean``, ``var`` per BN conv and
    ``w``, ``b`` for a head's last 1x1."""
    act = activation(act_name)

    def conv_act(path, x, stride, use_act):
        p = leaf(tree, path)
        y = _conv(x, p, stride, quant)
        if "gamma" in p:
            y = batch_norm_train(y, p)
        return act(y) if use_act else y

    def head_out(e, y):
        b, _, h, w = y.shape
        return y.reshape(b, anchors_per_scale, 5 + num_classes, h, w).permute(0, 1, 3, 4, 2)

    return _walk(plan, x_nhwc.float().permute(0, 3, 1, 2), conv_act, head_out)


def fp8_quant(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale per tensor (its
    largest magnitude at 448, e4m3's largest finite value); the gradient
    passes straight through."""
    return _Fp8.apply(t)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.detach().abs().max().clamp(min=1e-12)
        scale = 448.0 / amax
        return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


def uniform_bound(cin: int, k: int) -> float:
    return 1.0 / math.sqrt(cin * k * k)
