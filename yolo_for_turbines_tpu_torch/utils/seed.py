"""Seeding (reference: code/utils.py:850-860)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 424242) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; returns a CPU
    ``torch.Generator`` seeded the same, for parameter init."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
