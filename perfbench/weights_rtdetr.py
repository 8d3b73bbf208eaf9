"""Weights of the RT-DETR configuration from ``--seed``, made on the device.

:func:`unfused` draws the unfused tree (``reference/rtdetr.py``: conv + BN
leaves, RepVGG's two branches, the ``d`` shortcut's 1x1) on ``weights.py``'s
draws and constants, so that the program's own fold is what serves:

- each conv's weight (a RepVGG block's 3x3 and 1x1 alike) U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) from one draw; each BN calibrated on a few images of the
  cell's own traffic (its statistics those of its input over them), with a
  scale U(0.5, 1.5) and a shift N(0, ``weights.SHIFT_STD``), both times
  ``weights.BRANCH_GAIN`` on a bottleneck's last conv (small residual
  branches, as a trained ResNet's);
- each linear layer's weight and bias U(-1/sqrt(in), 1/sqrt(in)) (torch's
  init), each layer norm's scale 1 and shift 0 (the source's init), and
  each ``sampling_offsets`` bias the source's grid (head ``h`` points along
  the angle ``2 pi h / heads``, point ``p`` at ``p + 1`` times that unit
  step, the same on every level), so that the samples spread over each
  query's box;
- the last decoder layer's class head scaled and shifted so that its logits
  on those images have mean ``weights.OBJECTNESS_MEAN`` and standard
  deviation ``weights.OBJECTNESS_STD``: a few dozen of each image's 24,000
  scores lie above the 0.5 threshold.
"""

from __future__ import annotations

import math

import torch

from . import weights
from .reference import model as ref
from .reference import rtdetr as rt


def _offsets_bias(heads: int, levels: int, points: int, device) -> torch.Tensor:
    """The source's ``MSDeformableAttention._reset_parameters`` grid."""
    thetas = torch.arange(heads, dtype=torch.float32, device=device) * (2.0 * math.pi / heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True).values
    grid = grid.reshape(heads, 1, 1, 2).tile(1, levels, points, 1)
    scale = torch.arange(1, points + 1, dtype=torch.float32, device=device).reshape(1, 1, -1, 1)
    return (grid * scale).flatten()


@torch.no_grad()
def unfused(cfg: dict, seed: int, images: torch.Tensor) -> dict:
    """The unfused tree (float32 on the images' device), its BN statistics
    calibrated on ``images`` (N, S, S, 3) in [0, 1]."""
    device = images.device
    specs = rt.leaf_specs(cfg)
    z = rt.sizes(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = [s for s in specs if s["kind"] in ("conv", "pooled", "rep")]
    draws = [{"cout": s["cout"], "cin": s["cin"], "k": s["k"]} for s in convs]
    draws += [{"cout": s["cout"], "cin": s["cin"], "k": 1} for s in convs if s["kind"] == "rep"]
    drawn = iter(weights._draws(draws, gen, device))
    tree = {}
    for s in convs:
        tree[s["name"]] = {"w": next(drawn)}
    for s in convs:
        if s["kind"] == "rep":
            tree[s["name"]]["w1x1"] = next(drawn)
    channels = sum(s["cout"] * (2 if s["kind"] == "rep" else 1) for s in convs)
    gamma = torch.rand(channels, generator=gen, device=device) + 0.5
    beta = weights.SHIFT_STD * torch.randn(channels, generator=gen, device=device)
    at = 0
    for s in convs:
        for suffix in ("", "1x1") if s["kind"] == "rep" else ("",):
            gain = weights.BRANCH_GAIN if s["gain"] == "branch" else 1.0
            node = tree[s["name"]]
            node["gamma" + suffix] = gain * gamma[at : at + s["cout"]]
            node["beta" + suffix] = gain * beta[at : at + s["cout"]]
            node["mean" + suffix] = torch.zeros(s["cout"], device=device)
            node["var" + suffix] = torch.ones(s["cout"], device=device)
            at += s["cout"]
    linears = [s for s in specs if s["kind"] == "linear"]
    sizes = [s["cout"] * (s["cin"] + 1) for s in linears]
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    at = 0
    for s, n in zip(linears, sizes):
        bound = 1.0 / math.sqrt(s["cin"])
        wb = flat[at : at + n] * bound
        tree[s["name"]] = {"w": wb[: s["cout"] * s["cin"]].view(s["cout"], s["cin"]),
                           "b": wb[s["cout"] * s["cin"] :]}
        if s["name"].endswith("sampling_offsets"):
            tree[s["name"]]["b"] = _offsets_bias(z["d_heads"], z["levels"], z["points"], device)
        at += n
    for s in specs:
        if s["kind"] == "norm":
            tree[s["name"]] = {"w": torch.ones(s["n"], device=device),
                               "b": torch.zeros(s["n"], device=device)}
    with ref.exact_f32():
        net = rt.Net(cfg, tree, folded=False, calibrate=True)
        tgt = net(images)[4]
        head = tree[f"decoder.dec_score_head.{z['layers'] - 1}"]
        free = tgt @ head["w"].T + head["b"]
        gain = weights.OBJECTNESS_STD / free.std()
        head["w"] = head["w"] * gain
        head["b"] = weights.OBJECTNESS_MEAN + gain * (head["b"] - free.mean())
    return tree
