"""Serving pipeline: letterbox -> folded forward -> decode -> NMS.

Counterpart of ``yolo_for_turbines_tpu/inference.py``. ``predict_batch``
runs the folded-BN forward with raw heads, the three-scale decode and the
fixed-shape class-aware NMS on the predictor's device and returns the K
survivors per image; ``predict_images`` and ``predict_image`` wrap it with
letterbox and un-letterbox. On CUDA the 26x26x512 residual stage runs the
fused kernel (``ops/kernels/resblock_kernel.py``) when the compute dtype is
bf16 (the kernel's only dtype; float32 and float16 take the cuDNN layer
path) and NMS runs the fused greedy kernel (``ops/kernels/nms_kernel.py``).

``quantize`` switches a predictor to the int8 PTQ path
(``models/quantize.py``): the same three entry points then run the int8
forward, whose 26x26x512 residual stage on CUDA is the fused int8 kernel
(``ops/kernels/resblock_int8_kernel.py``), and the same decode and NMS.

Every family serves: Darknet-53, CSPDarknet-53 and YOLOv3-tiny (two
scales); CSP and tiny have no stage the fused kernels take, and run K1
alone. ``load_predictor`` builds a predictor from a darknet weight file,
``load_predictor_from_checkpoint`` from a checkpoint of the port's
trainer; both run on ``device``, ``"cuda"`` unless the caller asks for the
CPU, and raise without a card.

``mesh=`` (``parallel/``) serves on a mesh of ranks, every rank handed the
same global batch, as the JAX ``Predictor(mesh=)``:

- data parallelism (``create_mesh``, ``create_multislice_mesh``): each
  rank serves its rows of the batch with the kernels unchanged (K1, K2 and
  K4, like the JAX ``shard_map`` branch), then the survivors are
  all-gathered, so ``predict_batch`` returns the whole batch on every rank.
  B must be a multiple of the mesh's size (``pad_batch_to_multiple``);
- spatial partitioning (``create_spatial_mesh``): each rank holds its rows
  of its data shard's images, convs exchange halo rows, the heads are
  gathered and decode and NMS run replicated over ``"space"``. As in the
  JAX spatial branch, and as in the portable export, no kernel runs: the
  fused stages are not routed (``fuse_resblocks=False``, which also packs
  no K4 operands), the int8 path takes its layer path with halos of s8
  codes, and NMS takes its plain sweep.

Replicas are made identical when the predictor is built (rank 0's weights
broadcast, ``sync_replicas``), so every rank of the mesh builds it.

Under a running ``torch.profiler`` (and only then: ``utils/profiling.py``)
``predict_image`` logs the spans ``predict_image`` > ``.letterbox``,
``predict_batch``, ``.fetch`` (the boxes' copy to the host, which waits for
the device) and ``.unletterbox``; ``predict_batch`` logs ``predict_batch`` >
``.input`` (the copy of the input and the anchors to the device),
``.forward`` and ``.postprocess`` (decode, NMS and the mesh's gather).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import config as cfg
from . import native
from .config import ModelConfig
from .data.augment import letterbox, unletterbox_boxes
from .models.convert import folded_from_numpy, folded_to_numpy
from .models.quantize import apply_inference_int8, pack_int8, quantize_folded
from .models.yolov3 import FoldedYOLOv3, YOLOv3, build_plan
from .ops.decode import decode_raw_all
from .ops.nms import batched_nms, nms_to_list
from .parallel import comm
from .parallel.mesh import batch_group, batch_sharding, tree_map
from .parallel.spatial import Layout, is_spatial, spatial_image_sharding
from .utils.device import resolve_device
from .utils.profiling import span


def _letterbox_batch(np_images: List[np.ndarray], size: int, num_threads: int) -> np.ndarray:
    """(N, size, size, 3) float32 in [0, 1]: the port's C++ packer
    (``native``) when it builds here, else numpy + PIL."""
    out = native.batch_letterbox(np_images, size, num_threads=num_threads)
    if out is not None:
        return out
    out = np.empty((len(np_images), size, size, 3), np.float32)
    for i, img in enumerate(np_images):
        lb, _ = letterbox(np.ascontiguousarray(img), None, size)
        out[i] = lb.astype(np.float32) / 255.0
    return out


class Predictor:
    """A folded model on a device plus the serving knobs.

    ``compute_dtype`` defaults to bf16 on CUDA and float32 on the CPU.
    ``device`` is the mesh's device when ``mesh`` is given (module
    docstring).
    """

    def __init__(
        self,
        model: FoldedYOLOv3,
        *,
        device=None,
        anchors=cfg.ANCHORS,
        image_size: int = cfg.DEF_IMAGE_SIZE,
        conf_threshold: float = cfg.CONF_THRESHOLD,
        nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
        max_boxes: int = 256,
        compute_dtype=None,
        folded=None,
        mesh=None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            if not mesh.active:
                raise ValueError(f"rank {mesh.rank} is idle on this mesh of {mesh.size} ranks")
            device = mesh.device
        if device is None:
            raise TypeError("Predictor needs a device (or a mesh)")
        self.device = torch.device(device)
        self.mesh = mesh
        self._layout = Layout(mesh) if is_spatial(mesh) else None
        if self._layout is not None:
            model.fuse_resblocks = False  # no kernel under SP
        # the full-precision folded tree (JAX layout) quantize() starts from:
        # int8 scales and codes must not compound the compute-dtype cast
        # below. from_folded hands over its tree (held, not copied); without
        # one, quantize() reads the module, which must then stay f32.
        self._folded_input = folded
        self._qparams = None
        self._packed = None
        if compute_dtype is None:
            compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.compute_dtype = compute_dtype
        # pre-cast weights once; channels_last keeps activations NHWC in memory
        self.model = model.to(
            device=self.device, dtype=compute_dtype, memory_format=torch.channels_last
        ).eval()
        self.anchors = np.asarray(anchors, np.float32)
        self.image_size = image_size
        self.conf_threshold = conf_threshold
        self.nms_iou_threshold = nms_iou_threshold
        self.max_boxes = max_boxes
        if mesh is not None:
            self.sync_replicas()

    def sync_replicas(self) -> None:
        """Overwrite every rank's weights (and int8 operands) with rank 0's:
        a broadcast over the mesh, then the kernels' weight copies dropped.
        A broadcast writes each weight's storage directly and leaves its
        ``_version`` as it was, so the fused stages would not notice it by
        themselves. Every rank of the mesh calls it."""
        comm.broadcast_module(self.model, self.mesh.group)
        self.model.drop_kernel_copies()
        if self._qparams is not None:
            self.set_qparams(self._qparams)

    @classmethod
    def from_folded(cls, model_cfg: ModelConfig, folded, *, device=None,
                    **kwargs) -> "Predictor":
        """Build from a folded tree in the JAX layout (``YOLOv3.fold`` output
        as numpy arrays; see ``models/convert.py``)."""
        model = folded_from_numpy(build_plan(model_cfg), folded, model_cfg)
        return cls(model, device=device, folded=folded, **kwargs)

    def full_precision_tree(self):
        """The folded tree in full precision (JAX layout): the one
        ``from_folded`` held or, for a predictor that computes in f32, its
        module's weights. ``quantize`` starts from it and a bundle stores it
        (``serving.save_predictor``); a module cast to another dtype has
        lost it, and this raises."""
        if self._folded_input is not None:
            return self._folded_input
        if self.compute_dtype != torch.float32:
            raise ValueError(
                "the full-precision weights are needed: build the predictor with "
                "Predictor.from_folded (or pass folded=) when compute_dtype is "
                f"{self.compute_dtype}")
        return folded_to_numpy(self.model)

    def quantize(self, calib_batch) -> "Predictor":
        """Switch this predictor to the int8 PTQ path: calibrate activation
        scales on ``calib_batch`` ((N, S, S, 3) in [0, 1]) in f32 on the
        predictor's device from the full-precision folded tree, quantize the
        weights, and pack the serving operands once. Returns self."""
        x = torch.as_tensor(calib_batch, dtype=torch.float32).to(self.device)
        self.set_qparams(quantize_folded(
            self.model.plan, self.full_precision_tree(), x, self.model.cfg.activation))
        return self

    def set_qparams(self, qparams) -> None:
        """Serve from a quantized tree (``quantize_folded`` or
        ``models/convert.py::qparams_from_numpy`` output on this device);
        the scale chain and the fused kernel's operands are packed here,
        once, for every image size: each ``predict_batch`` routes its
        residual stages on the shape of its own batch. With
        ``fuse_resblocks=False`` no operands are packed for the fused
        kernel, and every stage takes the int8 layer path. On a mesh rank
        0's tree is broadcast first, so every replica serves the same
        codes."""
        if self.mesh is not None:
            tree_map(lambda t: comm.broadcast_(t, self.mesh.group)
                     if isinstance(t, torch.Tensor) else t, qparams)
        self._qparams = qparams
        self._packed = pack_int8(self.model.plan, qparams, self.compute_dtype,
                                 kernel_operands=self.model.fuse_resblocks)

    def _shard(self, x) -> torch.Tensor:
        """This rank's part of a global batch, on the device: its rows (DP)
        or its rows of its data shard's images (SP); all of it without a
        mesh."""
        x = torch.as_tensor(x)
        if self.mesh is not None:
            sharding = spatial_image_sharding if self._layout else batch_sharding
            x = sharding(self.mesh).take(x)
        return x.to(self.device)

    def _heads(self, x) -> List[torch.Tensor]:
        if self._qparams is None:
            return self.model(x, layout=self._layout)
        return apply_inference_int8(
            self.model.plan, self._qparams, x, activation=self.model.cfg.activation,
            raw_heads=True, compute_dtype=self.compute_dtype, packed=self._packed,
            layout=self._layout,
        )

    def raw_heads(self, x) -> List[torch.Tensor]:
        """Raw NHWC heads, coarsest first, in ``compute_dtype``: the int8
        forward once quantized, else the folded forward. On a mesh, the
        heads of this rank's rows of the global batch ``x`` (whole images
        under SP)."""
        with torch.inference_mode():
            return self._heads(self._shard(x))

    def predict_batch(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, S, 3) float in [0, 1], numpy or tensor.

        Returns ((B, K, 6), (B, K) bool) tensors on the predictor's device;
        on a mesh, the whole batch's on every rank."""
        with span("predict_batch"), torch.inference_mode():
            with span("predict_batch.input"):
                grid_sizes = cfg.grid_sizes_for(x.shape[1], self.model.strides)
                x = self._shard(x)
                scaled_anchors = torch.from_numpy(
                    self.anchors * np.asarray(grid_sizes, np.float32).reshape(-1, 1, 1)
                ).to(self.device)
            with span("predict_batch.forward"):
                raw = self._heads(x)
            with span("predict_batch.postprocess"):
                boxes = decode_raw_all(
                    raw, scaled_anchors, grid_sizes, self.model.cfg.num_classes
                )
                kept, mask = batched_nms(
                    boxes,
                    iou_threshold=self.nms_iou_threshold,
                    obj_threshold=self.conf_threshold,
                    max_boxes=self.max_boxes,
                    portable=self._layout is not None,
                )
                if self.mesh is not None:
                    group = batch_group(self.mesh)
                    kept, mask = comm.all_gather(kept, group), comm.all_gather(mask, group)
            return kept, mask

    def predict_images(
        self, np_images: List[np.ndarray], num_threads: int = 0
    ) -> List[List[List[float]]]:
        """Batched serving: letterbox every HWC uint8 image, one
        ``predict_batch``, per-image boxes in each original frame."""
        x = _letterbox_batch(np_images, self.image_size, num_threads)
        kept, mask = self.predict_batch(x)
        kept, mask = kept.cpu().numpy(), mask.cpu().numpy()
        size = (self.image_size, self.image_size)
        return [
            unletterbox_boxes(nms_to_list(kept[i], mask[i]), img.shape[:2], size)
            for i, img in enumerate(np_images)
        ]

    def predict_image(self, np_image: np.ndarray) -> List[List[float]]:
        """One HWC uint8 image -> NMS boxes in the original image's
        normalized frame [cx, cy, w, h, score, class]."""
        with span("predict_image"):
            h0, w0 = np_image.shape[:2]
            with span("predict_image.letterbox"):
                img, _ = letterbox(np_image, None, self.image_size)
                x = (img.astype(np.float32) / 255.0)[None]
            kept, mask = self.predict_batch(x)
            with span("predict_image.fetch"):
                boxes = nms_to_list(kept[0], mask[0])
            with span("predict_image.unletterbox"):
                return unletterbox_boxes(boxes, (h0, w0), (self.image_size, self.image_size))


def _trainable(num_classes: int, activation: str, backbone: str, seed: int):
    """The trainable model of a backbone (strides follow it), seeded init,
    on the CPU."""
    model_cfg = ModelConfig(num_classes=num_classes, activation=activation, backbone=backbone,
                            strides=cfg.strides_for(backbone))
    return YOLOv3(model_cfg, generator=torch.Generator().manual_seed(seed))


def load_predictor(
    weights_path,
    num_classes: int = cfg.NUM_COCO_CLASSES,
    activation: str = "leaky_relu",
    anchors=cfg.ANCHORS,
    image_size: int = cfg.DEF_IMAGE_SIZE,
    conf_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
    seed: int = 0,
    backbone: str = "darknet53",
    device="cuda",
) -> Predictor:
    """A predictor on ``device`` from a darknet weight file (the official
    ``yolov3.weights`` layout, or ``yolov3-tiny.weights`` with
    ``backbone="yolov3_tiny"`` and ``anchors=config.TINY_ANCHORS``).

    The trainable model of the backbone is made from ``seed``, the file is
    read into it (``models/darknet_weights.py``; a CSP stage reads nothing
    and keeps its seeded weights), and its ``fold()`` serves."""
    from .models.darknet_weights import load_darknet_into

    device = resolve_device(device, "load_predictor")
    model = _trainable(num_classes, activation, backbone, seed)
    load_darknet_into(str(weights_path), model)
    return Predictor.from_folded(
        model.cfg, model.fold(), device=device, anchors=anchors, image_size=image_size,
        conf_threshold=conf_threshold, nms_iou_threshold=nms_iou_threshold)


def load_predictor_from_checkpoint(
    checkpoint_path,
    num_classes: int = cfg.NUM_TURBINE_CLASSES,
    activation: str = "mish",
    anchors=cfg.TURBINE_ANCHORS,
    image_size: int = cfg.DEF_IMAGE_SIZE,
    conf_threshold: float = cfg.CONF_THRESHOLD,
    nms_iou_threshold: float = cfg.NMS_IOU_THRESHOLD,
    backbone: str = "darknet53",
    device="cuda",
) -> Predictor:
    """A predictor on ``device`` from a checkpoint of the port's trainer
    (``train/checkpoint.py``): the trainable model of ``backbone`` restored
    from it, then ``fold()`` served. ``backbone``, ``num_classes`` and
    ``activation`` must be the training run's: the module's state must
    match the checkpoint's, key for key and shape for shape."""
    from .train.checkpoint import load_model_state

    device = resolve_device(device, "load_predictor_from_checkpoint")
    model = _trainable(num_classes, activation, backbone, 0)  # every tensor restored below
    load_model_state(model, checkpoint_path)
    return Predictor.from_folded(
        model.cfg, model.fold(), device=device, anchors=anchors, image_size=image_size,
        conf_threshold=conf_threshold, nms_iou_threshold=nms_iou_threshold)
