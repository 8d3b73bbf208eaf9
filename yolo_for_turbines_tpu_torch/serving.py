"""Read the serving bundles the JAX package writes (``serving.save_predictor``).

A bundle directory holds ``manifest.json`` (format version, model config,
predictor knobs, the pytree specs of the weights), ``folded.npz``
(full-precision folded weights) and, for a quantized predictor,
``quantized.npz`` (the int8 PTQ tree of ``models/quantize.py``). This reader
needs numpy and torch only.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .config import ModelConfig
from .inference import Predictor
from .models.convert import qparams_from_numpy

FORMAT_VERSION = 1

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def spec_to_tree(spec: dict, leaves):
    """Inverse of the JAX package's ``tree_to_spec``. Array leaves come back
    as numpy; bf16 leaves stay in the float32 they were stored as (their
    values are exact, and the predictor casts to its compute dtype)."""

    def rec(s):
        t = s["t"]
        if t == "none":
            return None
        if t == "dict":
            return {k: rec(v) for k, v in s["k"].items()}
        if t in ("list", "tuple"):
            out = [rec(v) for v in s["v"]]
            return out if t == "list" else tuple(out)
        if t in ("bool", "int", "float", "str"):
            return s["v"]
        a = np.asarray(leaves[s["key"]])
        if s["dtype"] not in (a.dtype.name, "bfloat16"):
            a = a.astype(np.dtype(s["dtype"]))
        return a

    return rec(spec)


def _tuplify(x):
    """JSON round-trips tuples as lists; ModelConfig needs hashable tuples."""
    return tuple(_tuplify(v) for v in x) if isinstance(x, list) else x


def load_predictor_bundle(path, device, compute_dtype=None) -> Predictor:
    """Rebuild a Predictor on ``device`` from a bundle directory.

    ``compute_dtype`` defaults to the one the bundle was saved with. A
    bundle with a quantized tree gives a predictor that serves int8."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"bundle format {manifest['format_version']} is newer than this "
            f"reader's {FORMAT_VERSION}"
        )
    m = dict(manifest["model"])
    m["strides"] = _tuplify(m["strides"])
    if m.get("layer_config") is not None:
        m["layer_config"] = _tuplify(m["layer_config"])
    model_cfg = ModelConfig(**m)

    with np.load(path / "folded.npz") as z:
        folded = spec_to_tree(manifest["folded_spec"], z)

    p = manifest["predictor"]
    if compute_dtype is None:
        compute_dtype = _DTYPES[p["compute_dtype"]]
    pred = Predictor.from_folded(
        model_cfg,
        folded,
        device=device,
        anchors=np.asarray(p["anchors"], np.float32),
        image_size=p["image_size"],
        conf_threshold=p["conf_threshold"],
        nms_iou_threshold=p["nms_iou_threshold"],
        max_boxes=p["max_boxes"],
        compute_dtype=compute_dtype,
    )
    if "quantized_spec" in manifest:
        with np.load(path / "quantized.npz") as z:
            qtree = spec_to_tree(manifest["quantized_spec"], z)
        pred.set_qparams(qparams_from_numpy(pred.model.plan, qtree, pred.device))
    return pred
