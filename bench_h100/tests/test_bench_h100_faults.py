"""A run whose timed path is broken underneath comes out not correct: the
harness runs small on the CPU (its look for a card skipped), with each
fault a cell can have planted in the program. The exchange between chips
has no fault to plant: every cell runs on one chip."""

import pytest
import torch

from conftest import SEED, SMALL

from bench_h100 import harness

TRAIN = ["flagship.train", "autoreg.train_closed_loop"]


def run(cell):
    return harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"), 0.0,
                            overrides=SMALL)["result"]


@pytest.mark.parametrize("cell", TRAIN)
def test_sound_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    from motionmixerconv_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "update", lambda self: None)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["change_median_gap"]["value"] > 0.5


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from motionmixerconv_tpu_torch.train import AutoregressiveTrainer, Trainer

    cls = AutoregressiveTrainer if cell.startswith("autoreg") else Trainer
    whole = cls._train_loss

    def half(self, frames, starts, w, *args, **kw):
        w = w.clone()
        w[w.shape[0] // 2:] = 0.0  # the mean taken over the rest
        return whole(self, frames, starts, w, *args, **kw)

    monkeypatch.setattr(cls, "_train_loss", half)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_learning_rate_that_never_moves(cell, monkeypatch):
    from motionmixerconv_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "_schedule", lambda self: None)
    res = run(cell)
    assert not res["correct"]
    late, = (v for k, v in res["checks"].items()
             if k.startswith("late_change"))
    assert late["value"] > 1.0  # the step's rate is 10x the reference's


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_each_test_batch_left_out(cell, monkeypatch):
    from motionmixerconv_tpu_torch.train import Trainer

    whole = Trainer._stack_eval_batches

    def half(self, *args, **kw):
        starts, w, gids = whole(self, *args, **kw)
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0.0  # the mean taken over the rest
        return starts, w, gids

    monkeypatch.setattr(Trainer, "_stack_eval_batches", half)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["test_gap"]["value"] > res["checks"]["test_gap"]["limit"]
