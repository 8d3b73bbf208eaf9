"""Training: the ``Trainer``'s ``train_step`` over a pool of device-resident
batches, the window's steps queued back to back and closed by one
synchronise.

Set-up builds one ``Trainer``, loads the seed's weights into its model, and
takes its first ``check_steps`` steps through the same call and batches the
window uses (rows that all differ); the window continues that same state.
Checked against the reference's float32 steps (TF32 off) on the same
batches from the same weights:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the first gradient as SGD got it (its momentum buffer after
  step 1, less the weight decay of the starting weights), per leaf, as the
  gap between the two norms over the larger of the reference's norm of that
  leaf and its median leaf's;
- ``change_gap``: the same of each leaf's change after the checked steps;
- ``stats_gap``: the same of each BN running mean's and variance's change.

Leaves whose reference gradient is under a thousandth of the median leaf's
move by rounding alone and are left out of ``grad_gap`` and ``change_gap``.

The control replaces the program's checked steps by the reference's with
every conv's input and weight rounded through float8 e4m3 (one scale per
tensor); ``half_batch`` runs the program's steps on the first half of each
batch.
"""

from __future__ import annotations

import contextlib
import numpy as np
import torch

from .. import traffic, weights
from ..reference import model as ref
from ..reference import train as rtrain
from . import model_config, seeded

SKIP_BELOW = 1e-3  # of the median leaf's reference gradient norm


def state_names(plan):
    """(conv path, program state-dict prefix) in walk order: the program's
    ``YOLOv3`` holds plan entry i as ``layers.i``, a residual block's convs
    as ``layers.i.blocks.j.conv1``, a head's as ``layers.i.conv1``."""
    out = []
    for s in ref.conv_specs(plan):
        p = s["path"]
        if len(p) == 3:
            out.append((p, f"layers.{p[0]}.blocks.{p[1]}.{p[2]}"))
        elif p[1] == "conv":
            out.append((p, f"layers.{p[0]}"))
        else:
            out.append((p, f"layers.{p[0]}.{p[1]}"))
    return out


def program_state(plan, tree) -> dict:
    state = {}
    for path, pre in state_names(plan):
        node = ref.leaf(tree, path)
        state[f"{pre}.conv.weight"] = node["w"]
        if "gamma" in node:
            state.update({f"{pre}.bn.weight": node["gamma"], f"{pre}.bn.bias": node["beta"],
                          f"{pre}.bn.running_mean": node["mean"],
                          f"{pre}.bn.running_var": node["var"]})
        else:
            state[f"{pre}.conv.bias"] = node["b"]
    return state


# (tree key, program suffix) of a leaf that SGD moves, and of a BN statistic
PARAM_KEYS = (("w", "conv.weight"), ("b", "conv.bias"), ("gamma", "bn.weight"),
              ("beta", "bn.bias"))
STAT_KEYS = (("mean", "bn.running_mean"), ("var", "bn.running_var"))


class Driver:
    call_span = contextlib.nullcontext  # the harness puts a span here when tracing

    def __init__(self, cfg: dict, mix: dict, seed: int, device, variant: str = "program"):
        from yolo_for_turbines_tpu_torch.config import TrainConfig
        from yolo_for_turbines_tpu_torch.train.trainer import Trainer

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, torch.device(device)
        self.variant = variant
        tc = cfg["train"]
        self.hyper = tc
        train_cfg = TrainConfig(
            lr=tc["lr"], momentum=tc["momentum"], weight_decay=tc["weight_decay"],
            batch_size=mix["batch"], warmup_enabled=tc["warmup_enabled"],
            activation=cfg["activation"], image_size=cfg["image_size"], multi_scale=False,
            compute_dtype=tc["dtype"] if self.device.type == "cuda" else "float32",
            max_num_steps=1 << 40)
        self.trainer = Trainer(train_cfg, model_config(cfg), anchors=cfg["anchors"],
                               device=self.device)
        self.plan, tree = weights.trainable(cfg, 4 * int(seed), self.device)
        state = program_state(self.plan, tree)
        missing = set(self.trainer.model.state_dict()) - set(state)
        if {k for k in missing if not k.endswith("num_batches_tracked")}:
            raise RuntimeError(f"the program's model has state the benchmark does not set: "
                               f"{sorted(missing)[:5]}")
        self.trainer.model.load_state_dict(state, strict=False)
        self.start = {k: v.detach().clone() for k, v in state.items()}
        gen = seeded(seed, 2, self.device)
        rng = np.random.default_rng([int(seed), 3])
        self.pool = [traffic.train_batch(gen, rng, mix, cfg, self.device)
                     for _ in range(mix["pool"])]
        side = cfg["image_size"]
        grids = np.asarray([side // s for s in cfg["strides"]], np.float32)
        self.anchors = torch.from_numpy(
            np.asarray(cfg["anchors"], np.float32) * grids[:, None, None]).to(self.device)
        if variant == "half_batch":
            inner = self.trainer.train_step
            half = mix["batch"] // 2

            def halved(state, images, targets, anchors):
                return inner(state, images[:half], tuple(t[:half] for t in targets), anchors)

            self.trainer.train_step = halved
        elif variant not in ("program", "control"):
            raise ValueError(f"no variant {variant!r} for training")
        self.first = self._checked_steps()
        self.attempted = 0

    def _call(self, i: int):
        x, y = self.pool[i % len(self.pool)]
        return self.trainer.train_step(self.trainer.state, x, y, self.anchors)

    def _checked_steps(self) -> dict:
        """The checked steps, through the window's own call (or, for the
        control, the reference's fp8 steps in its place): their losses, the
        first gradient, and the leaves' and statistics' changes."""
        n = self.mix["check_steps"]
        if self.variant == "control":
            return reference_steps(self, n, quant=ref.fp8_quant)
        model = self.trainer.model
        wd = self.hyper["weight_decay"]
        losses, grads = [], None
        for i in range(n):
            losses.append(self._call(i)["loss"])
            if i == 0:
                opt = self.trainer.state.optimizer
                params = dict(model.named_parameters())
                grads = {}
                for name, p in params.items():
                    buf = opt.state.get(p, {}).get("momentum_buffer")
                    grads[name] = (torch.zeros_like(p) if buf is None
                                   else buf.float() - wd * self.start[name])
        sd = model.state_dict()
        change = {k: (sd[k].float() - self.start[k]) for k in self.start}
        return {"losses": [float(v) for v in losses], "grads": grads, "change": change}

    def warm(self) -> None:
        for i in range(self.mix["warm_steps"]):
            self._call(self.mix["check_steps"] + i)
        self.finish()

    def step(self, i: int) -> int:
        with self.call_span():
            self._call(self.mix["check_steps"] + self.mix["warm_steps"] + i)
        self.attempted += 1
        return self.mix["batch"]

    def finish(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def spans(self):
        from ..trace import wrap_call

        wrap_call(self.trainer, "train_step", "Trainer.train_step")
        return []

    def call_name(self) -> str:
        return "train_step"

    def release(self) -> None:
        self.trainer = None

    def check(self):
        want = reference_steps(self, self.mix["check_steps"])
        got = self.first
        loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"]))
        norms = {k: float(v.norm()) for k, v in want["grads"].items()}
        median = float(np.median(list(norms.values())))
        moving = [k for k, v in norms.items() if v >= SKIP_BELOW * median]
        params = set(want["grads"])
        stats = [k for k in want["change"] if k not in params]
        return {
            "loss_gap": loss_gap,
            "grad_gap": norm_gap(got["grads"], want["grads"], moving),
            "change_gap": norm_gap(got["change"], want["change"], moving),
            "stats_gap": norm_gap(got["change"], want["change"], stats),
            "leaves_skipped": float(len(params) - len(moving)),
        }


def norm_gap(got: dict, want: dict, keys) -> float:
    """The largest gap between the norms of a leaf, over the larger of the
    reference's norm of that leaf and of its median leaf."""
    wn = {k: float(want[k].double().norm()) for k in keys}
    median = float(np.median(list(wn.values())))
    return max(abs(float(got[k].double().norm()) - wn[k]) / max(wn[k], median) for k in keys)


def reference_steps(driver: Driver, n: int, quant=None) -> dict:
    """The reference's first ``n`` steps on the driver's batches from the
    seed's weights, as the program-state names: losses, the first gradient,
    and every leaf's and statistic's change."""
    cfg, tc = driver.cfg, driver.hyper
    _, tree = weights.trainable(cfg, 4 * int(driver.seed), driver.device)
    names = dict(state_names(driver.plan))
    params, pnames, stats = [], [], []
    for path, pre in names.items():
        node = ref.leaf(tree, path)
        for key, suffix in PARAM_KEYS:
            if key in node:
                node[key].requires_grad_(True)
                params.append(node[key])
                pnames.append(f"{pre}.{suffix}")
        for key, suffix in STAT_KEYS:
            if key in node:
                stats.append((node[key], f"{pre}.{suffix}"))
    start = {n_: p.detach().clone() for n_, p in zip(pnames, params)}
    start.update({n_: t.clone() for t, n_ in stats})
    buffers = [None] * len(params)
    losses, grads = [], None
    with ref.exact_f32():
        for i in range(n):
            x, y = driver.pool[i % len(driver.pool)]
            for p in params:
                p.grad = None
            heads = ref.train_forward(driver.plan, tree, x, cfg["activation"], cfg["num_classes"],
                                      quant=quant)
            loss, _ = rtrain.total_loss(heads, y, driver.anchors)
            loss.backward()
            losses.append(loss.item())
            if i == 0:
                grads = {n_: p.grad.detach().clone() for n_, p in zip(pnames, params)}
            rtrain.sgd_step(params, buffers, tc["lr"], tc["momentum"], tc["weight_decay"])
            del heads, loss
    change = {n_: p.detach() - start[n_] for n_, p in zip(pnames, params)}
    change.update({n_: t - start[n_] for t, n_ in stats})
    return {"losses": losses, "grads": grads, "change": change}

