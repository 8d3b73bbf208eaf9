"""Building blocks of the folded-inference model, in PyTorch.

Counterpart of ``yolo_for_turbines_tpu/models/blocks.py``. Inside the model
activations are NCHW tensors (stored channels_last on the card, so their
memory is NHWC) and conv weights are OIHW; the JAX package keeps NHWC / HWIO.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5  # torch BatchNorm2d default, needed for darknet-weight parity


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


def mish(x):
    return F.mish(x)


ACTIVATIONS = {"leaky_relu": leaky_relu, "mish": mish}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"Unsupported activation: {name}")
    return ACTIVATIONS[name]


def conv2d(x, w, stride: int, padding: int, bias=None):
    """NCHW conv with explicit symmetric padding and floor output sizes.

    ``padding=1`` on a stride-2 3x3 conv pads both sides like the JAX
    package's explicit ((1, 1), (1, 1)); torch's ``"same"`` would not."""
    return F.conv2d(x, w, bias, stride=stride, padding=padding)


def fold_conv_bn(params: Dict, stats: Dict) -> Dict:
    """Fold eval-mode BN into the conv: w' = w * g/sqrt(v+eps),
    b' = b - m*g/sqrt(v+eps). ``params['w']`` is OIHW."""
    inv = params["scale"] / torch.sqrt(stats["var"] + BN_EPS)
    w = params["w"] * inv[:, None, None, None]
    b = params["bias"] - stats["mean"] * inv
    return {"w": w, "b": b}


def upsample2x(x):
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
