"""Folded-inference Darknet-53 YOLOv3 in PyTorch."""
