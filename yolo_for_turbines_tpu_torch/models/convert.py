"""Weight bridge: a folded tree in the JAX layout -> the torch module.

The JAX package's ``fold_params`` (``models/yolov3.py``) gives a plan-aligned
list of ``{"conv": {w, b}}``, ``{"blocks": [{"conv1", "conv2"}, ...]}``,
``{"conv1", "conv2"}`` and ``{}`` entries with HWIO weights. Leaves may be
numpy arrays (also bf16 ones), torch tensors, or anything ``np.asarray``
takes. Both packages then compute the same function from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo_for_turbines_tpu.config import ModelConfig

from .yolov3 import FoldedConv, FoldedYOLOv3, Head, Plan, ResidualStage


def _to_f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@torch.no_grad()
def _fill(conv: FoldedConv, p) -> None:
    w = _to_f32(p["w"]).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if tuple(w.shape) != tuple(conv.weight.shape):
        raise ValueError(f"weight {tuple(w.shape)} != module {tuple(conv.weight.shape)}")
    conv.weight.copy_(w)
    conv.bias.copy_(_to_f32(p["b"]))


def folded_from_numpy(plan: Plan, folded, cfg: ModelConfig) -> FoldedYOLOv3:
    """Build the module for ``plan`` and fill it from a folded tree.

    ``cfg`` supplies the activation and the ``fuse_resblocks`` switch; the
    plan must be ``build_plan(cfg)`` of the model the tree was folded from.
    """
    model = FoldedYOLOv3(cfg, plan)
    if len(folded) != len(plan):
        raise ValueError(f"folded tree has {len(folded)} entries, plan {len(plan)}")
    for layer, p in zip(model.layers, folded):
        if isinstance(layer, FoldedConv):
            _fill(layer, p["conv"])
        elif isinstance(layer, ResidualStage):
            if len(p["blocks"]) != len(layer.blocks):
                raise ValueError("residual stage block count differs from the plan")
            for blk, bp in zip(layer.blocks, p["blocks"]):
                _fill(blk["conv1"], bp["conv1"])
                _fill(blk["conv2"], bp["conv2"])
        elif isinstance(layer, Head):
            _fill(layer.conv1, p["conv1"])
            _fill(layer.conv2, p["conv2"])
    return model
