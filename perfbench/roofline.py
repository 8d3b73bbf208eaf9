"""The benchmark's yardstick for device work: the H100's published peaks and
the operations and bytes of the configurations' layers, counted from the
configuration file's layer list and never from the program's modules.

A conv counts 2 * k * k * Cin * Cout * Ho * Wo operations (a multiply and an
add per weight and output position); biases, BN, activations, upsamples and
concats are left out, as in the published 65.86 billion of YOLOv3-416. A
training step counts three forwards (the forward, and the two products of
its backward).
"""

from __future__ import annotations

from typing import Dict, List

from .reference.model import conv_specs, parse

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAKS = {
    "bf16_flops": 989e12,
    "int8_ops": 1979e12,
    "f32_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
}


def conv_table(cfg: dict, size: int) -> List[Dict]:
    """Every conv of the configuration at a ``size`` x ``size`` input: its
    spec, input and output side, and operations per image."""
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    sides = {}
    side = size
    out = []
    # the walk's sides: a stride-2 conv halves the side, an upsample doubles it
    for i, e in enumerate(plan):
        if e["kind"] == "up":
            side *= 2
            continue
        sides[i] = side
        if e["kind"] == "conv":
            side = (side + 2 * (e["k"] // 2) - e["k"]) // e["stride"] + 1
    for s in conv_specs(plan):
        i = s["path"][0]
        hin = sides[i]
        hout = (hin + 2 * (s["k"] // 2) - s["k"]) // s["stride"] + 1
        out.append({**s, "side_in": hin, "side_out": hout,
                    "flops": 2.0 * s["k"] ** 2 * s["cin"] * s["cout"] * hout * hout})
    return out


def forward_flops(cfg: dict, size: int) -> float:
    """Operations of one image's forward."""
    return sum(c["flops"] for c in conv_table(cfg, size))


def train_flops(cfg: dict, size: int) -> float:
    """Operations of one image's training step: three forwards."""
    return 3.0 * forward_flops(cfg, size)


def stage_convs(cfg: dict, size: int, channels: int, side: int) -> List[Dict]:
    """The convs of the residual stage (the 8-, 4-, 2- or 1-block stacks with
    shortcuts) of ``channels`` at ``side`` x ``side``."""
    plan = parse(cfg["layers"], cfg["in_channels"], cfg["num_classes"])
    return [c for c in conv_table(cfg, size)
            if plan[c["path"][0]]["kind"] == "res" and plan[c["path"][0]]["residual"]
            and plan[c["path"][0]]["c"] == channels and c["side_in"] == side]


def stage_bound_s(cfg: dict, size: int, channels: int, side: int, batch: int,
                  dtype_bytes: int = 2) -> float:
    """Least time of that stage for ``batch`` images on one H100 in bf16: the
    larger of its operations over the bf16 peak and its bytes (the input read
    and the output written once, each weight read once) over the HBM rate."""
    convs = stage_convs(cfg, size, channels, side)
    ops = batch * sum(c["flops"] for c in convs)
    weights = sum(c["cin"] * c["cout"] * c["k"] ** 2 for c in convs)
    nbytes = dtype_bytes * (2 * batch * side * side * channels + weights)
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
