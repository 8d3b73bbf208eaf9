"""Drivers: one per kind of traffic, each the only code that calls the
measured program (``yolo_for_turbines_tpu_torch``).

A driver is built from (configuration, mix, seed, device, variant); that is
the set-up. Then the harness calls ``warm()``, ``step(i)`` in the window
(each returns the images it completed), ``finish()`` at the window's close,
``spans()`` before a traced window, ``release()`` to free the program's
state, and ``check()`` for the numbers compared with the reference. The
variant is ``"program"`` in every benchmark run; ``control.py`` also builds
``"control"`` (the lower precision that the limits are set against) and,
for training, ``"half_batch"`` (half of each batch left out).
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..reference import model as ref


def load(kind: str):
    return importlib.import_module(f"{__name__}.{kind}").Driver


def seeded(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose of a seed (weights, images,
    ...), so that purposes draw unrelated numbers."""
    return torch.Generator(device=device).manual_seed(4 * int(seed) + purpose)


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from yolo_for_turbines_tpu_torch.config import ModelConfig

    layers = tuple(tuple(x) if isinstance(x, list) else x for x in cfg["layers"])
    return ModelConfig(num_classes=cfg["num_classes"], in_channels=cfg["in_channels"],
                       activation=cfg["activation"], strides=tuple(cfg["strides"]),
                       layer_config=layers)


def compute_dtype(cfg: dict, device: torch.device):
    """The configuration's dtype on the card; float32 on the CPU, where the
    program has no bf16 path."""
    if device.type != "cuda":
        return torch.float32
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]


def folded_numpy(plan, tree) -> list:
    """A folded tree in the layout the program's ``Predictor.from_folded``
    takes: HWIO numpy float32, ``{"conv"}`` / ``{"blocks"}`` / head entries."""

    def conv(p):
        return {"w": p["w"].permute(2, 3, 1, 0).contiguous().cpu().numpy(),
                "b": p["b"].cpu().numpy()}

    out = []
    for e, node in zip(plan, tree):
        if e["kind"] == "conv":
            out.append({"conv": conv(node["conv"])})
        elif e["kind"] == "res":
            out.append({"blocks": [{k: conv(b[k]) for k in ("conv1", "conv2")} for b in node]})
        elif e["kind"] == "head":
            out.append({k: conv(node[k]) for k in ("conv1", "conv2")})
        else:
            out.append({})
    return out


class RelRms:
    """||got - want|| / ||want|| accumulated over blocks, per key."""

    def __init__(self):
        self.num, self.den = {}, {}

    def add(self, key, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.double() - want.double()).pow(2).sum().item()
        self.num[key] = self.num.get(key, 0.0) + d
        self.den[key] = self.den.get(key, 0.0) + want.double().pow(2).sum().item()

    def worst(self) -> float:
        return max((self.num[k] / max(self.den[k], 1e-300)) ** 0.5 for k in self.num)


def reference_heads(plan, tree, x: torch.Tensor, act: str, block: int = 32):
    """The reference's raw heads of ``x`` in blocks of rows (float32, TF32
    off)."""
    outs = []
    with ref.exact_f32(), torch.no_grad():
        for i in range(0, x.shape[0], block):
            outs.append(ref.folded_forward(plan, tree, x[i : i + block], act))
    return [torch.cat(parts) for parts in zip(*outs)]


def sample(seed: int, within: int, count: int, key=None, per_key: int = 1) -> list:
    """``count`` distinct iteration indices below ``within``, drawn from the
    seed; with ``key``, at most ``per_key`` of them share a key."""
    rng = np.random.default_rng([int(seed), 7])
    picked, seen = [], {}
    for i in rng.permutation(within):
        k = None if key is None else key(int(i))
        if k is not None and seen.get(k, 0) >= per_key:
            continue
        picked.append(int(i))
        seen[k] = seen.get(k, 0) + 1
        if len(picked) == count:
            break
    return sorted(picked)
