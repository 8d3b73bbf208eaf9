"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device, what: str = "this") -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (nothing runs
    on the CPU unless asked for). ``what`` names the caller in the error."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on CUDA and no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return device
