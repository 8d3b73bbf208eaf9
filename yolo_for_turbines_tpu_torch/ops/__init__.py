"""Decode, IoU and NMS on torch tensors, plus the CUDA kernels."""
