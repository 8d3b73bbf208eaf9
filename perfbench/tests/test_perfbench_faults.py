"""Whole runs of each cell at a tiny size on the CPU: a sound run is
correct; with the timed path broken underneath (each fault the cell can
have), or with the control in the program's place, it is not."""

import copy
import time

import pytest
import torch

from perfbench import run

CELLS = ("coco416-offline-bf16", "turbines416-stream-bf16", "turbines416-train-step")


def _run(bench, name, variant="program", seconds=1.5):
    return run.run_cell(bench, bench.cell(name), 2**31 + 17, seconds, False, "cpu",
                        time.perf_counter(), variant=variant, emit=lambda line: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_bench, name):
    result = _run(tiny_bench, name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_bench, name):
    assert not _run(tiny_bench, name, "control")["correct"]


@pytest.mark.parametrize("name", CELLS[:2])
def test_an_answer_altered_where_it_is_produced(tiny_bench, monkeypatch, name):
    from yolo_for_turbines_tpu_torch import inference

    real = inference.batched_nms

    def altered(*args, **kwargs):
        kept, mask = real(*args, **kwargs)
        return kept + torch.tensor([0.05, 0, 0, 0, 0, 0]), mask

    monkeypatch.setattr(inference, "batched_nms", altered)
    result = _run(tiny_bench, name)
    assert not result["correct"]
    assert result["checks"]["boxes_unmatched"]["value"] > result["checks"]["boxes_unmatched"]["limit"]


def _broken_step(monkeypatch, wrap):
    from yolo_for_turbines_tpu_torch.train import trainer

    real = trainer.make_train_step
    monkeypatch.setattr(trainer, "make_train_step", lambda *a, **k: wrap(real(*a, **k)))


def test_a_step_that_returns_its_state_unchanged(tiny_bench, monkeypatch):
    def wrap(step):
        def unchanged(state, images, targets, anchors):
            saved = (copy.deepcopy(state.model.state_dict()),
                     copy.deepcopy(state.optimizer.state_dict()), state.step)
            metrics = step(state, images, targets, anchors)
            state.model.load_state_dict(saved[0])
            state.optimizer.load_state_dict(saved[1])
            state.step = saved[2]
            return metrics
        return unchanged

    _broken_step(monkeypatch, wrap)
    result = _run(tiny_bench, "turbines416-train-step")
    assert not result["correct"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(tiny_bench, monkeypatch):
    def wrap(step):
        def halved(state, images, targets, anchors):
            half = images.shape[0] // 2
            return step(state, images[:half], tuple(t[:half] for t in targets), anchors)
        return halved

    _broken_step(monkeypatch, wrap)
    assert not _run(tiny_bench, "turbines416-train-step")["correct"]


@pytest.mark.chip
def test_control_on_the_card_at_the_cells_size(card):
    """The control at each cell's own size, three seeds (a few minutes)."""
    from perfbench import control
    from perfbench.manifest import HERE, Bench

    bench = Bench.load(HERE.parent / "BENCHMARK.json")
    for name in CELLS:
        limits = bench.limits(bench.cell(name))
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            r = control.reading(bench, bench.cell(name), seed, "control", 2.0, card)
            assert any(r[k] > v for k, v in limits.items()), (name, seed, r)
