"""Torch port: seeding, NaN guards and the metrics sink
(``yolo_for_turbines_tpu_torch/utils/``, ``train/metrics.py``) against the
JAX package's."""

import json
import math
import random

import numpy as np
import pytest
import torch

from yolo_for_turbines_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
from yolo_for_turbines_tpu.utils.seed import seed_everything as jax_seed_everything
from yolo_for_turbines_tpu_torch.train.metrics import MetricsLogger
from yolo_for_turbines_tpu_torch.utils import (
    checked_loss,
    debug_nans,
    debug_nans_scope,
    seed_everything,
)


def test_seed_everything_seeds_the_host_as_jax_does():
    jax_seed_everything(7)
    want = (random.random(), np.random.random())
    gen = seed_everything(7)
    assert (random.random(), np.random.random()) == want
    assert isinstance(gen, torch.Generator)
    a = torch.rand(3, generator=gen)
    assert torch.equal(a, torch.rand(3, generator=torch.Generator().manual_seed(7)))
    seed_everything(7)
    b = torch.rand(3)
    seed_everything(7)
    assert torch.equal(b, torch.rand(3))


def test_checked_loss_raises_on_a_non_finite_loss():
    fn = checked_loss(lambda v: (torch.tensor(v), {"x": 1}))
    assert fn(1.5)[1] == {"x": 1}
    for bad in (math.nan, math.inf):
        with pytest.raises(FloatingPointError, match="non-finite"):
            fn(bad)
    assert checked_loss(lambda: torch.tensor(2.0))() == 2.0


def test_debug_nans_switches_anomaly_mode():
    prev = torch.is_anomaly_enabled()
    try:
        debug_nans(False)
        with debug_nans_scope():
            assert torch.is_anomaly_enabled()
            x = torch.tensor([-1.0], requires_grad=True)
            # anomaly mode names the forward op, then the backward raises
            with pytest.raises(RuntimeError, match="nan"), pytest.warns(
                    UserWarning, match="SqrtBackward"):
                torch.sqrt(x).sum().backward()
        assert not torch.is_anomaly_enabled()
        debug_nans(True)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(prev)


def test_metrics_logger_writes_the_jax_rows(tmp_path, capsys):
    rows = [{"lr": np.float32(1e-3)}, {"train_loss": torch.tensor(2.5), "note": "x"}]
    for cls, sub in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        log = cls("run", config={"lr": 0.001, "anchors": [[1.0, 2.0]]}, out_dir=tmp_path / sub)
        for r in rows:
            log.log(r)
        log.log_model(tmp_path / "x.ckpt", "best")
        log.finish()
    got = [json.loads(line) for line in open(tmp_path / "port" / "run_metrics.jsonl")]
    want = [json.loads(line) for line in open(tmp_path / "jax" / "run_metrics.jsonl")]
    for g, w in zip(got, want):
        g.pop("t"), w.pop("t")
    assert got == want and len(got) == 3
    # and to stdout, one JSON object per row
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [{k: v for k, v in r.items() if k != "t"} for r in out] == got
