"""PyTorch + CUDA port of yolo_for_turbines_tpu: the 416px serving path
(bf16 and int8 PTQ), the eval path (the trainable Darknet-53 in eval mode,
the 4-term loss, decode, host and device mAP), the training path (SGD
steps, checkpoints, darknet weights, the numpy data layer, ``train()``),
and the deployment and tuning entry points (serving bundles and their
``torch.export`` programs, the export and demo CLIs, k-means anchors, ASHA
hyperparameter search).

The JAX package beside this one is the reference; module names mirror it
(``models/yolov3.py``, ``ops/nms.py``, ``inference.py``, ...). Its four
Pallas kernels are hand-written CUDA kernels for Hopper (``csrc/*.cu``,
built with nvcc for sm_90a at first use; see ``ops/kernels/__init__.py``).
CPU tensors take each kernel's plain torch version; CUDA tensors take the
kernel or raise.

This package imports torch and never jax.
"""

__version__ = "0.1.0"
