"""Hyperparameter search: ASHA (async successive halving) without Ray
(counterpart of ``yolo_for_turbines_tpu/train/hpo.py``, numpy only, with
the same RNG draws).

The reference drives Ray Tune's ASHAScheduler (reference: code/train.py:
241-284; metric mAP max, grace_period 2, reduction_factor 2, brackets 2)
with fractional-GPU scheduling that runs <=2 trials concurrently
(code/train.py:258-264). Trials are fully independent (no gradient
communication), so this driver implements the same successive-halving rung
logic directly.

Execution modes:
- `max_concurrent=1` (default): trials run sequentially in-process.
- `max_concurrent>1`: each trial lives in its OWN spawned subprocess for
  its whole lifetime (resume state stays inside the worker, exactly like a
  Ray trial actor); the parent schedules up to `max_concurrent` live
  workers and promotes/stops rungs asynchronously as results arrive. The
  `train_fn` must be picklable (trainer.make_hpo_train_fn returns a
  picklable HPOTrainFn). Workers are spawned, not forked: a CUDA context
  does not survive a fork.

The device belongs to the train function (``HPOTrainFn(device=...)``), so
the JAX driver's `trial_platform`, which flips each worker's JAX backend,
has no counterpart here.

API parity: `tune_model(...)` samples `num_samples` configs from a search
space, schedules them through ASHA rungs, and writes the best config to
`{model_folder}/best_config.json` in the reference's
{"config": ..., "mAP": ...} shape, readable by `load_config`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Search-space primitives (tune.uniform / loguniform / choice equivalents)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclasses.dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))


@dataclasses.dataclass(frozen=True)
class Choice:
    values: tuple

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]


@dataclasses.dataclass(frozen=True)
class GridSearch:
    values: tuple


def sample_config(space: Dict, rng) -> Dict:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if hasattr(v, "sample") else v
    return out


def expand_grid(space: Dict) -> List[Dict]:
    """Expand GridSearch axes into a list of partial configs."""
    grids = {k: v.values for k, v in space.items() if isinstance(v, GridSearch)}
    if not grids:
        return [dict()]
    import itertools

    keys = list(grids)
    return [
        dict(zip(keys, combo)) for combo in itertools.product(*grids.values())
    ]


# ---------------------------------------------------------------------------
# ASHA scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trial:
    config: Dict
    id: int
    bracket: int
    rung: int = 0
    score: float = -math.inf
    epochs_run: int = 0
    stopped: bool = False
    error: Optional[str] = None


class ASHAScheduler:
    """Successive halving: rung r of bracket b requires
    grace_period * rf^(r + b) epochs; only the top 1/rf of each rung's
    finishers advance (matching Ray's ASHA semantics for the reference's
    settings)."""

    def __init__(
        self,
        metric: str = "mAP",
        mode: str = "max",
        grace_period: int = 2,
        reduction_factor: int = 2,
        brackets: int = 2,
        max_t: int = 100,
    ):
        self.metric = metric
        self.sign = 1.0 if mode == "max" else -1.0
        self.grace = grace_period
        self.rf = reduction_factor
        self.brackets = brackets
        self.max_t = max_t
        self._rung_scores: Dict = {}

    def rung_budget(self, bracket: int, rung: int) -> int:
        return min(self.max_t, self.grace * (self.rf ** (rung + bracket)))

    def on_result(self, trial: Trial, score: float) -> bool:
        """Record a rung result; returns True if the trial should continue."""
        score *= self.sign
        trial.score = score
        key = (trial.bracket, trial.rung)
        self._rung_scores.setdefault(key, []).append(score)
        scores = self._rung_scores[key]
        if self.rung_budget(trial.bracket, trial.rung) >= self.max_t:
            return False
        # continue iff in the top 1/rf of results seen at this rung
        cutoff = np.percentile(scores, 100 * (1 - 1 / self.rf))
        if score >= cutoff:
            trial.rung += 1
            return True
        return False


def _trial_worker(conn, train_fn, config):
    """One trial's lifetime in a spawned subprocess: state stays here across
    rungs (the process IS the resume state, like a Ray trial actor).
    Protocol: recv ("run", n_epochs) -> send ("result", score) | ("error",
    msg); recv ("stop",) -> exit."""
    state = None
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            try:
                score, state = train_fn(config, msg[1], state)
                conn.send(("result", float(score)))
            except Exception as e:  # report, don't kill the whole search
                conn.send(("error", f"{type(e).__name__}: {e}"))
                break
    except EOFError:
        pass
    finally:
        conn.close()


def _run_trials_concurrent(
    trials: List[Trial],
    train_fn: Callable,
    sched: "ASHAScheduler",
    max_concurrent: int,
) -> List[Trial]:
    """Async ASHA over subprocess trials: up to `max_concurrent` live worker
    processes; rung promotion happens the moment a result arrives (matching
    Ray's async semantics — a rung never waits for stragglers)."""
    import multiprocessing as mp
    from multiprocessing.connection import wait as conn_wait

    ctx = mp.get_context("spawn")
    pending = list(trials)
    running: Dict = {}  # conn -> (trial, process)
    results: List[Trial] = []

    def send_next_rung(trial, conn):
        budget = sched.rung_budget(trial.bracket, trial.rung)
        conn.send(("run", budget - trial.epochs_run))
        trial.epochs_run = budget

    def launch(trial):
        parent_conn, child_conn = ctx.Pipe()
        proc = ctx.Process(
            target=_trial_worker,
            args=(child_conn, train_fn, trial.config),
            daemon=True,
        )
        proc.start()
        child_conn.close()
        send_next_rung(trial, parent_conn)
        running[parent_conn] = (trial, proc)

    def finish(conn, stopped_cleanly=True):
        trial, proc = running.pop(conn)
        trial.stopped = True
        if stopped_cleanly:
            try:
                conn.send(("stop",))
            except (BrokenPipeError, OSError):
                pass
        conn.close()
        proc.join(timeout=30)
        if proc.is_alive():
            proc.terminate()
            proc.join()
        results.append(trial)
        if pending:
            launch(pending.pop(0))

    while pending and len(running) < max_concurrent:
        launch(pending.pop(0))

    while running:
        for conn in conn_wait(list(running)):
            trial, _ = running[conn]
            try:
                msg = conn.recv()
            except EOFError:
                trial.error = "worker process died (EOF)"
                print(f"[hpo] trial {trial.id} failed: {trial.error}")
                finish(conn, stopped_cleanly=False)
                continue
            if msg[0] == "error":
                # failed trial scores -inf and is out of the running; keep
                # the message so an all-failed search raises, not silently
                # writes a garbage best_config.json
                trial.error = msg[1]
                print(f"[hpo] trial {trial.id} failed: {msg[1]}")
                finish(conn)
                continue
            if sched.on_result(trial, msg[1]):
                send_next_rung(trial, conn)
            else:
                finish(conn)
    return results


def tune_model(
    train_fn: Callable,
    param_space: Dict,
    num_samples: int,
    model_folder_path,
    identifier: str = "hpo",
    metric: str = "mAP",
    mode: str = "max",
    grace_period: int = 2,
    reduction_factor: int = 2,
    brackets: int = 2,
    max_epochs: int = 16,
    seed: int = 0,
    max_concurrent: int = 1,
) -> Dict:
    """Run ASHA over `num_samples` sampled configs.

    `train_fn(config, num_epochs, resume_state) -> (score, resume_state)`
    trains for `num_epochs` *additional* epochs and reports the metric.
    With `max_concurrent > 1`, trials run in spawned subprocesses (up to
    that many at once; train_fn must be picklable) with async rung
    promotion — the reference's Ray setup runs <=2 concurrent trials
    (code/train.py:258-264). The train function picks its device.
    Returns the best {"config", "mAP"} mapping (also written to
    best_config.json, parity with reference code/train.py:279-284).
    """
    rng = np.random.default_rng(seed)
    grid_parts = expand_grid(param_space)
    sampled_space = {
        k: v for k, v in param_space.items() if not isinstance(v, GridSearch)
    }
    trials: List[Trial] = []
    tid = 0
    while len(trials) < num_samples:
        for part in grid_parts:
            if len(trials) >= num_samples:
                break
            config = {**sample_config(sampled_space, rng), **part}
            trials.append(Trial(config=config, id=tid, bracket=tid % brackets))
            tid += 1

    sched = ASHAScheduler(
        metric, mode, grace_period, reduction_factor, brackets, max_t=max_epochs
    )
    if max_concurrent > 1:
        results = _run_trials_concurrent(trials, train_fn, sched, max_concurrent)
    else:
        results = []
        for trial in trials:
            resume_state = None
            while not trial.stopped:
                budget = sched.rung_budget(trial.bracket, trial.rung)
                add = budget - trial.epochs_run
                score, resume_state = train_fn(trial.config, add, resume_state)
                trial.epochs_run = budget
                if not sched.on_result(trial, score):
                    trial.stopped = True
            results.append(trial)

    # a trial that reported valid rung scores before later failing keeps its
    # best score (matching Ray: partial results count); raise only when NO
    # trial ever produced a score
    scored = [t for t in results if t.score > -math.inf]
    if not scored:
        errs = "; ".join(
            f"trial {t.id}: {t.error}" for t in results if t.error
        )
        raise RuntimeError(f"every HPO trial failed — {errs or 'no results'}")
    best = max(scored, key=lambda t: t.score)
    payload = {"config": best.config, metric: best.score * sched.sign}
    out = Path(model_folder_path)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "best_config.json", "w") as f:
        json.dump(payload, f)
    return payload


def load_config(model_folder, config_name: str) -> Dict:
    """Read back a best_config.json (reference: code/train.py:286-289)."""
    with open(Path(model_folder) / config_name) as f:
        return json.load(f)["config"]
