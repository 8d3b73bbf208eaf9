"""Official darknet binary weights (yolov3.weights / darknet53.conv.74):
import and export (counterpart of
``yolo_for_turbines_tpu/models/darknet_weights.py``).

File format (parity with reference code/model.py:160-170, 227-337):
- 5 x int32 header, then a flat float32 stream.
- Per conv-with-BN layer, the stream holds **BN first, then conv**:
  beta, gamma, running_mean, running_var (each ``out_ch`` floats), then the
  conv weights in OIHW order. Per bias-conv (the head's final 1x1): bias
  (``out_ch``) then OIHW weights.
- Backbone-only files encode a cutoff in the filename: ``darknet53.conv.74``
  -> cutoff 74. The reference counts parameterized torch layers (each
  BatchNorm2d and each Conv2d, BN before its conv) and stops copying once
  the count reaches the cutoff while still advancing the read offset, so
  cutoff 74 loads 37 conv layers.
- ``freeze=True`` marks every copied layer frozen (the reference sets
  requires_grad=False only on layers it copied).
- A CSP stage has no darknet layout: the reader takes nothing for it (its
  weights stay as given, its loaded flags False) and goes on at the same
  offset, so later layers of a CSP plan read another plan's file at other
  offsets, as the JAX reader does; ``expected_num_floats`` counts it as 0
  and the exporter refuses it. Max pools and routes hold nothing.

:func:`load_darknet_weights` and :func:`export_darknet_weights` work on the
JAX layout's numpy ``(params, batch_stats)`` trees (HWIO weights), as the
JAX functions do, so the two packages read and write the same files and
give the same trees. :func:`load_darknet_into` loads a file into the
port's trainable module and names its frozen parameters.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .cspdarknet import SINGLE_CONVS, PlanCSP
from .yolov3 import (
    Plan,
    PlanConv,
    PlanHead,
    PlanMaxPool,
    PlanResidual,
    PlanRoute,
    PlanUpsample,
    YOLOv3,
    conv_paths,
    refuse_walk_only,
    tree_leaf,
)


class _Reader:
    def __init__(self, weights: np.ndarray, cutoff: Optional[int]):
        self.weights = weights
        self.param_idx = 0
        self.layer_id = 0
        self.cutoff = cutoff

    def _take(self, n: int) -> np.ndarray:
        chunk = self.weights[self.param_idx : self.param_idx + n]
        if chunk.size != n:
            raise ValueError(
                f"Weight file exhausted: needed {n} floats at offset "
                f"{self.param_idx}, only {chunk.size} left"
            )
        self.param_idx += n
        return chunk

    def _past_cutoff(self) -> bool:
        return self.cutoff is not None and self.layer_id >= self.cutoff

    def read_bn(self, out_ch: int):
        """Returns (beta, gamma, mean, var) or None if past cutoff."""
        skip = self._past_cutoff()
        self.layer_id += 1
        if skip:
            self.param_idx += 4 * out_ch
            return None
        beta = self._take(out_ch).copy()
        gamma = self._take(out_ch).copy()
        mean = self._take(out_ch).copy()
        var = self._take(out_ch).copy()
        return beta, gamma, mean, var

    def read_conv(self, out_ch: int, in_ch: int, k: int, bias: bool):
        """Returns (w_hwio, bias or None) or None if past cutoff."""
        n_w = out_ch * in_ch * k * k
        skip = self._past_cutoff()
        self.layer_id += 1
        if skip:
            if bias:
                self.param_idx += out_ch
            self.param_idx += n_w
            return None
        b = self._take(out_ch).copy() if bias else None
        w = self._take(n_w).reshape(out_ch, in_ch, k, k).transpose(2, 3, 1, 0).copy()
        return w, b


def parse_cutoff(weights_path: str) -> Optional[int]:
    """``darknet53.conv.74`` -> 74; full weight files -> None
    (reference: code/model.py:167-170)."""
    name = os.path.basename(str(weights_path))
    if ".conv" in name:
        return int(name.split(".")[-1])
    return None


def read_weights_file(weights_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (header int32[5], flat float32 weights)."""
    with open(weights_path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=5)
        weights = np.fromfile(f, dtype=np.float32)
    return header, weights


def _load_conv_with_bn(reader: _Reader, entry_params, entry_stats, in_ch, out_ch, k):
    """Load one BN+conv pair into (params, stats) dicts; returns loaded flag."""
    bn = reader.read_bn(out_ch)
    conv = reader.read_conv(out_ch, in_ch, k, bias=False)
    loaded = False
    if bn is not None:
        beta, gamma, mean, var = bn
        entry_params["bias"] = beta
        entry_params["scale"] = gamma
        entry_stats["mean"] = mean
        entry_stats["var"] = var
        loaded = True
    if conv is not None:
        entry_params["w"] = conv[0]
        loaded = True
    return loaded


def _copy_tree(tree):
    """Nested dicts and lists rebuilt, leaves as numpy arrays (None kept)."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def load_darknet_weights(
    weights_path: str,
    plan: Plan,
    params: List,
    batch_stats: List,
    freeze: bool = False,
):
    """Load a darknet binary into (params, batch_stats) trees.

    Returns (params, batch_stats, frozen_mask, floats_consumed). The trees
    are new nested structures (numpy leaves where loaded, the given leaves
    elsewhere); frozen_mask matches params' structure with True at frozen
    leaves, all False unless ``freeze``.
    """
    _, weights = read_weights_file(weights_path)
    reader = _Reader(weights, parse_cutoff(weights_path))
    params, batch_stats = _copy_tree(params), _copy_tree(batch_stats)
    loaded_flags: List = []  # parallel to params: per-conv-dict loaded bool

    for entry, p, s in zip(plan, params, batch_stats):
        if isinstance(entry, PlanConv):
            loaded = _load_conv_with_bn(
                reader, p["conv"], s["conv"], entry.in_ch, entry.out_ch, entry.kernel
            )
            loaded_flags.append({"conv": loaded})
        elif isinstance(entry, PlanResidual):
            flags = []
            c = entry.channels
            for bp, bs in zip(p["blocks"], s["blocks"]):
                l1 = _load_conv_with_bn(reader, bp["conv1"], bs["conv1"], c, c // 2, 1)
                l2 = _load_conv_with_bn(reader, bp["conv2"], bs["conv2"], c // 2, c, 3)
                flags.append({"conv1": l1, "conv2": l2})
            loaded_flags.append({"blocks": flags})
        elif isinstance(entry, PlanHead):
            c = entry.in_ch
            out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
            l1 = _load_conv_with_bn(reader, p["conv1"], s["conv1"], c, entry.mid, 3)
            conv = reader.read_conv(out_ch, entry.mid, 1, bias=True)
            if conv is not None:
                p["conv2"]["w"] = conv[0]
                p["conv2"]["b"] = conv[1]
            loaded_flags.append({"conv1": l1, "conv2": conv is not None})
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            loaded_flags.append({})
        elif isinstance(entry, PlanCSP):
            # nothing read: no darknet counterpart (see the module docstring)
            loaded_flags.append({k: False for k in SINGLE_CONVS}
                                | {"blocks": [{"conv1": False, "conv2": False}
                                              for _ in p["blocks"]]})
        else:
            raise TypeError(f"unknown plan entry {entry!r}")

    frozen_mask = [_expand_flags(p, f, freeze) for p, f in zip(params, loaded_flags)]
    return params, batch_stats, frozen_mask, reader.param_idx


def _expand_flags(p, f, freeze: bool):
    """Per-conv loaded flags -> per-leaf frozen mask (True = frozen)."""
    if isinstance(p, dict) and "w" in p:
        return {k: bool(f) and freeze for k in p}
    if isinstance(p, dict):
        return {k: _expand_flags(p[k], f[k], freeze) for k in p}
    if isinstance(p, list):
        return [_expand_flags(pi, fi, freeze) for pi, fi in zip(p, f)]
    raise TypeError(type(p))


# the JAX tree's leaf names -> the trainable ConvBlock's parameters
def frozen_parameter_names(model: YOLOv3, frozen_mask) -> List[str]:
    """The ``model.named_parameters()`` names of the leaves that
    ``frozen_mask`` (a :func:`load_darknet_weights` mask) marks frozen, in
    that order."""
    frozen = {id(block.leaves()[k])
              for i, path, block in conv_paths(model.layers)
              for k, v in tree_leaf(frozen_mask, (i, *path)).items() if v}
    return [name for name, p in model.named_parameters() if id(p) in frozen]


def load_darknet_into(weights_path: str, model: YOLOv3,
                      freeze: bool = False) -> Tuple[List[str], int]:
    """Load a darknet binary into the trainable module, in place on its
    device. Returns (names of the parameters to freeze, floats consumed):
    with ``freeze`` every parameter of a loaded layer, else none."""
    from .convert import load_trainable, trainable_to_numpy

    refuse_walk_only(model.plan, "the darknet reader",
                     "the layer order of such a weight file is not ported")
    params, stats = trainable_to_numpy(model)
    params, stats, mask, consumed = load_darknet_weights(
        weights_path, model.plan, params, stats, freeze=freeze)
    load_trainable(model, params, stats)
    return frozen_parameter_names(model, mask), consumed


def expected_num_floats(plan: Plan) -> int:
    """Total floats a full weight file must contain for this plan."""
    total = 0
    for entry in plan:
        if isinstance(entry, PlanConv):
            total += 4 * entry.out_ch + entry.out_ch * entry.in_ch * entry.kernel**2
        elif isinstance(entry, PlanResidual):
            c = entry.channels
            per_block = (4 * (c // 2) + (c // 2) * c) + (4 * c + c * (c // 2) * 9)
            total += entry.num_blocks * per_block
        elif isinstance(entry, PlanHead):
            c = entry.in_ch
            m = entry.mid
            out_ch = (entry.num_classes + 5) * entry.anchors_per_scale
            total += 4 * m + m * c * 9  # 3x3 conv with BN
            total += out_ch + out_ch * m  # 1x1 bias conv
    return total


def export_darknet_weights(plan: Plan, params, batch_stats, path: str):
    """Write (params, batch_stats) trees out in darknet binary format: the
    exact inverse of :func:`load_darknet_weights` with no cutoff."""
    chunks = [np.zeros(5, np.int32).tobytes()]

    def emit_bn_conv(p, s):
        chunks.append(np.asarray(p["bias"], np.float32).tobytes())
        chunks.append(np.asarray(p["scale"], np.float32).tobytes())
        chunks.append(np.asarray(s["mean"], np.float32).tobytes())
        chunks.append(np.asarray(s["var"], np.float32).tobytes())
        w = np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        chunks.append(w.tobytes())

    for entry, p, s in zip(plan, params, batch_stats):
        if isinstance(entry, PlanConv):
            emit_bn_conv(p["conv"], s["conv"])
        elif isinstance(entry, PlanResidual):
            for bp, bs in zip(p["blocks"], s["blocks"]):
                emit_bn_conv(bp["conv1"], bs["conv1"])
                emit_bn_conv(bp["conv2"], bs["conv2"])
        elif isinstance(entry, PlanHead):
            emit_bn_conv(p["conv1"], s["conv1"])
            chunks.append(np.asarray(p["conv2"]["b"], np.float32).tobytes())
            w = np.asarray(p["conv2"]["w"], np.float32).transpose(3, 2, 0, 1)
            chunks.append(w.tobytes())
        elif isinstance(entry, (PlanUpsample, PlanMaxPool, PlanRoute)):
            pass  # parameterless
        else:
            raise ValueError(
                f"cannot export plan entry {type(entry).__name__} to darknet format"
            )
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c)
