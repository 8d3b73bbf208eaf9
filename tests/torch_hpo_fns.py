"""Picklable toy objectives for the ASHA driver's spawned trial workers
(tests/test_torch_hpo.py). A worker imports this module by name, so it
imports numpy only."""

import os
import time
from pathlib import Path


def toy_score(lr: float, epochs: int, full: int) -> float:
    """Best at lr = 0.01, growing with the epochs up to ``full``."""
    return max(0.0, 1 - abs(lr - 0.01) * 10) * min(1.0, epochs / full)


class RecordingTrainFn:
    """Records its pid and run interval to disk so a test can prove real
    multi-process overlap."""

    def __init__(self, out_dir, sleep_s=0.6):
        self.out_dir = str(out_dir)
        self.sleep_s = sleep_s

    def __call__(self, config, num_epochs, resume):
        start = time.time()
        time.sleep(self.sleep_s)
        epochs = (resume or 0) + num_epochs
        stamp = f"{os.getpid()} {start:.4f} {time.time():.4f}\n"
        with open(Path(self.out_dir) / f"run_{os.getpid()}_{start:.4f}.txt", "w") as f:
            f.write(stamp)
        return toy_score(config["lr"], epochs, 4), epochs


class FailingOnBadLr:
    def __call__(self, config, num_epochs, resume):
        if config["lr"] > 0.1:
            raise RuntimeError("diverged")
        epochs = (resume or 0) + num_epochs
        return 1.0 - abs(config["lr"] - 0.01), epochs


class AlwaysFails:
    def __call__(self, config, num_epochs, resume):
        raise RuntimeError("boom")
