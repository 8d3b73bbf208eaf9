"""Darknet-53 YOLOv3 in PyTorch: the trainable module and the folded
inference module."""
