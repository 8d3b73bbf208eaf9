"""Serving bundles: write and read the pickle-free deployment artifact, and
export the serve pipeline as a hermetic ``torch.export`` program.

Counterpart of ``yolo_for_turbines_tpu/serving.py``, with the same bundle
layout, so that either package reads what the other writes:

    bundle/
      manifest.json      # format version, model config, predictor knobs,
                         # pytree specs, export index
      folded.npz         # full-precision folded conv weights (f32, host)
      quantized.npz      # optional: int8 PTQ tree (models/quantize.py)
      exports/*.pt2      # optional: torch.export serve programs

Weights travel at full precision; the reader re-applies the compute-dtype
cast a live ``Predictor`` does, so a round trip serves bit for bit what the
saved predictor served. The JAX package's exports (``*.jaxexport``) are
indexed in the same manifest; this reader refuses them, and the JAX reader
of the weights ignores the port's.

An export holds the program only: the parameters are call-time arguments
(the folded module's parameters by name, or the int8 tree), which
``ExportedPredictor`` loads from the bundle's npz. The exported pipeline is
portable: no fused residual stage (``fuse_resblocks=False``), the plain NMS
sweep and the int8 layer path (``portable=True``), as in the JAX package,
whose hermetic module cannot carry a kernel library either. A live
predictor from the same bundle runs the kernels.
"""

from __future__ import annotations

import dataclasses
import io
import json
import shutil
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import config as cfg
from .config import ModelConfig
from .inference import Predictor
from .models.convert import qparams_from_numpy, qparams_to_numpy
from .models.quantize import apply_inference_int8
from .models.yolov3 import refuse_walk_only
from .ops.decode import decode_raw_all
from .ops.nms import batched_nms
from .utils.device import resolve_device

FORMAT_VERSION = 1
FRAMEWORK = "yolo_for_turbines_tpu_torch"
EXPORT_FORMAT = "torch.export"

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}
# why an RT-DETR predictor makes no bundle and no export
BUNDLE_MISSING = ("its postprocess (the top queries, no NMS) and its weight tree's layout are "
                  "not ported to the bundle format or the exported program")


# ---------------------------------------------------------------------------
# Pytree <-> (JSON spec, npz leaves) codec, as the JAX package's
# ---------------------------------------------------------------------------


def _host_array(t) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name it is recorded under;
    bfloat16 (a tensor, or numpy's ml_dtypes type) is stored as f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(t)
    name = a.dtype.name
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def tree_to_spec(tree) -> Tuple[dict, dict]:
    """Encode a parameter tree as (JSON-safe spec, {key: np.ndarray}): the
    JAX package's ``tree_to_spec`` format. Leaves may be numpy arrays or
    tensors on any device."""
    leaves: dict = {}

    def rec(t):
        if t is None:
            return {"t": "none"}
        if isinstance(t, dict):
            return {"t": "dict", "k": {k: rec(v) for k, v in t.items()}}
        if isinstance(t, (list, tuple)):
            return {
                "t": "list" if isinstance(t, list) else "tuple",
                "v": [rec(v) for v in t],
            }
        if isinstance(t, bool):
            return {"t": "bool", "v": t}
        if isinstance(t, int) and not isinstance(t, np.generic):
            return {"t": "int", "v": t}
        if isinstance(t, float) and not isinstance(t, np.generic):
            return {"t": "float", "v": t}
        if isinstance(t, str):
            return {"t": "str", "v": t}
        a, orig = _host_array(t)
        key = f"L{len(leaves):05d}"
        leaves[key] = a
        return {"t": "arr", "key": key, "dtype": orig}

    return rec(tree), leaves


def spec_to_tree(spec: dict, leaves):
    """Inverse of :func:`tree_to_spec`. Array leaves come back as numpy;
    bf16 leaves stay in the float32 they were stored as (their values are
    exact, and the predictor casts to its compute dtype)."""

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


# ---------------------------------------------------------------------------
# Save / load
# ---------------------------------------------------------------------------


def save_predictor(pred: Predictor, path) -> Path:
    """Write ``pred`` as a bundle directory (the folded tree and, if it is
    quantized, the int8 tree), readable by this package's and the JAX
    package's ``load_predictor_bundle``.

    Overwriting a bundle resets its exports index and deletes its
    ``exports/`` directory: programs exported from the old weights are not
    left where a glob could pick them up."""
    refuse_walk_only(pred.model.plan, "the bundle writer", BUNDLE_MISSING, families=("RT-DETR",))
    folded_spec, folded_leaves = tree_to_spec(pred.full_precision_tree())
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if (path / "exports").is_dir():
        shutil.rmtree(path / "exports")
    np.savez(path / "folded.npz", **folded_leaves)

    manifest = {
        "format_version": FORMAT_VERSION,
        "framework": FRAMEWORK,
        "model": dataclasses.asdict(pred.model.cfg),
        "predictor": {
            "anchors": np.asarray(pred.anchors).tolist(),
            "image_size": pred.image_size,
            "conf_threshold": pred.conf_threshold,
            "nms_iou_threshold": pred.nms_iou_threshold,
            "max_boxes": pred.max_boxes,
            "compute_dtype": _DTYPE_NAMES[pred.compute_dtype],
        },
        "folded_spec": folded_spec,
        "exports": {},
    }
    if pred._qparams is not None:
        q_spec, q_leaves = tree_to_spec(qparams_to_numpy(pred.model.plan, pred._qparams))
        np.savez(path / "quantized.npz", **q_leaves)
        manifest["quantized_spec"] = q_spec

    (path / "manifest.json").write_text(json.dumps(manifest))
    return path


def _read_manifest(path: Path) -> dict:
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"bundle format {manifest['format_version']} is newer than this "
            f"reader's {FORMAT_VERSION}"
        )
    return manifest


def load_predictor_bundle(path, device="cuda", compute_dtype=None, mesh=None) -> Predictor:
    """Rebuild a Predictor on ``device`` (``"cuda"`` unless the caller asks
    for the CPU; it raises without a card) from a bundle directory of
    either package.

    ``compute_dtype`` defaults to the one the bundle was saved with. A
    bundle with a quantized tree gives a predictor that serves int8.
    ``mesh`` serves on a mesh of ranks (``Predictor``; the device is the
    mesh's), every rank loading the bundle."""
    device = resolve_device(device if mesh is None else mesh.device, "load_predictor_bundle")
    path = Path(path)
    manifest = _read_manifest(path)
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
        mesh=mesh,
    )
    if "quantized_spec" in manifest:
        with np.load(path / "quantized.npz") as z:
            qtree = spec_to_tree(manifest["quantized_spec"], z)
        pred.set_qparams(qparams_from_numpy(pred.model.plan, qtree, pred.device))
    return pred


# ---------------------------------------------------------------------------
# Hermetic export (torch.export)
# ---------------------------------------------------------------------------


def _portable_predictor(pred: Predictor) -> Predictor:
    """A CPU clone of ``pred`` for tracing the portable pipeline: the same
    weights, knobs and compute dtype, ``fuse_resblocks=False``, and the int8
    tree (if any) without K4's operands."""
    portable = Predictor.from_folded(
        dataclasses.replace(pred.model.cfg, fuse_resblocks=False),
        pred.full_precision_tree(),
        device="cpu",
        anchors=pred.anchors,
        image_size=pred.image_size,
        conf_threshold=pred.conf_threshold,
        nms_iou_threshold=pred.nms_iou_threshold,
        max_boxes=pred.max_boxes,
        compute_dtype=pred.compute_dtype,
    )
    if pred._qparams is not None:
        portable._qparams = qparams_from_numpy(pred.model.plan, pred._qparams, "cpu")
    return portable


def serve_params(pred: Predictor):
    """The call-time parameters of an exported program: the int8 tree of a
    quantized predictor, else its folded module's parameters by name (in
    the compute dtype and memory format the live predictor serves)."""
    if pred._qparams is not None:
        return pred._qparams
    return dict(pred.model.named_parameters())


class _ServeModule(torch.nn.Module):
    """The portable serve pipeline of a predictor as a function of
    ``(params, x)``: forward (``functional_call`` of the folded module, or
    the int8 layer path), decode, top-K and the plain NMS sweep."""

    def __init__(self, pred: Predictor):
        super().__init__()
        # held outside the module tree: its weights are call-time
        # arguments, not part of the program
        self.__dict__["pred"] = pred

    def forward(self, params, x):
        pred = self.pred
        model = pred.model
        grid_sizes = cfg.grid_sizes_for(x.shape[1], model.strides)
        scaled_anchors = torch.from_numpy(
            pred.anchors * np.asarray(grid_sizes, np.float32).reshape(-1, 1, 1)
        ).to(x.device)
        if pred._qparams is None:
            raw = torch.func.functional_call(model, params, (x,))
        else:
            raw = apply_inference_int8(model.plan, params, x, activation=model.cfg.activation,
                                       raw_heads=True, compute_dtype=pred.compute_dtype,
                                       portable=True)
        boxes = decode_raw_all(raw, scaled_anchors, grid_sizes, model.cfg.num_classes,
                               pred.scale_xy, pred.size_decode)
        return batched_nms(boxes, iou_threshold=pred.nms_iou_threshold,
                           obj_threshold=pred.conf_threshold, max_boxes=pred.max_boxes,
                           portable=True)


def export_serving_module(pred: Predictor, batch_size: int,
                          image_size: Optional[int] = None) -> bytes:
    """Serialize the portable serve pipeline (forward -> decode -> NMS) for
    one (batch, size) bucket as a ``torch.export`` program (``.pt2``
    bytes), traced on the CPU.

    The parameters stay call-time arguments, so the file holds the program
    and not the weights; its example inputs are dropped before saving.
    Loaded with ``torch.export.load``, its ``module()`` takes ``(params,
    x)``: ``serve_params`` of a predictor from the same bundle, and x (B, S,
    S, 3) f32 in [0, 1]; it returns ((B, K, 6) boxes, (B, K) mask). Device
    literals are the CPU's: ``ExportedPredictor`` moves the program to its
    device."""
    refuse_walk_only(pred.model.plan, "torch.export", BUNDLE_MISSING, families=("RT-DETR",))
    portable = _portable_predictor(pred)
    image_size = image_size or pred.image_size
    x = torch.zeros((batch_size, image_size, image_size, 3), dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(_ServeModule(portable), (serve_params(portable), x))
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def add_export_to_bundle(
    bundle_path,
    batch_size: int,
    image_size: Optional[int] = None,
    platforms: Sequence[str] = ("cpu", "cuda"),
) -> Path:
    """Export one (batch, size) serve bucket into an existing bundle
    (``exports/serve_b{B}_s{S}.pt2``) and index it in the manifest with the
    device types it may be moved to."""
    bundle_path = Path(bundle_path)
    manifest = _read_manifest(bundle_path)
    pred = load_predictor_bundle(bundle_path, device="cpu")
    image_size = image_size or pred.image_size
    blob = export_serving_module(pred, batch_size, image_size)
    (bundle_path / "exports").mkdir(exist_ok=True)
    name = f"serve_b{batch_size}_s{image_size}.pt2"
    (bundle_path / "exports" / name).write_bytes(blob)
    manifest.setdefault("exports", {})[name] = {
        "format": EXPORT_FORMAT,
        "batch_size": batch_size,
        "image_size": image_size,
        "platforms": list(platforms),
        "quantized": "quantized_spec" in manifest,
    }
    (bundle_path / "manifest.json").write_text(json.dumps(manifest))
    return bundle_path / "exports" / name


class ExportedPredictor:
    """Serve from a bundle's exported program: no model code of this
    package runs at call time, only the loaded graph of aten ops and the
    bundle's weights, on ``device`` (``"cuda"`` unless the caller asks for
    the CPU; it raises without a card)."""

    def __init__(self, bundle_path, name: Optional[str] = None, device="cuda"):
        from torch.export.passes import move_to_device_pass

        self.device = resolve_device(device, "ExportedPredictor")
        bundle_path = Path(bundle_path)
        manifest = _read_manifest(bundle_path)
        exports = manifest.get("exports") or {}
        if not exports:
            raise ValueError(f"{bundle_path} has no exports; run add_export_to_bundle")
        if name is None:
            if len(exports) > 1:
                raise ValueError(f"multiple exports {sorted(exports)}; pass name=")
            name = next(iter(exports))
        self.meta = exports[name]
        if self.meta.get("format") != EXPORT_FORMAT:
            raise ValueError(
                f"export {name} is not a {EXPORT_FORMAT} program (a .jaxexport is the JAX "
                "package's StableHLO module); export the bundle again with this package")
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(f"export {name} is for {self.meta['platforms']}, not "
                             f"{self.device.type}")
        # the export's own quantized flag picks the tree, not whichever
        # tree the bundle holds now
        if self.meta["quantized"] and "quantized_spec" not in manifest:
            raise ValueError(
                f"export {name} was lowered for the int8 tree but "
                f"{bundle_path} has no quantized.npz"
            )
        pred = load_predictor_bundle(bundle_path, device=self.device)
        if not self.meta["quantized"]:
            pred._qparams = None
        self._params = serve_params(pred)
        program = torch.export.load(bundle_path / "exports" / name)
        self._module = move_to_device_pass(program, self.device).module()

    def predict_batch(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, S, 3) float in [0, 1] with B, S matching the export.
        Returns ((B, K, 6), (B, K) bool) tensors on the predictor's device."""
        with torch.inference_mode():
            x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
            return self._module(self._params, x)
