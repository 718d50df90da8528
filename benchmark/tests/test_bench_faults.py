"""A run with the timed path broken underneath comes out not correct, and
a sound one correct: the driver on the CPU at the tiny model, past the
harness's look for a card."""

import time

import pytest

from conftest import tiny_cell
from drivers import train_step


def train(cell=None, patch=None):
    return train_step.run(cell or tiny_cell("train"), 2**31 + 17, 0.5, False,
                          time.perf_counter(), device="cpu", patch=patch)


def test_sound_training_run_is_correct():
    r = train()
    assert r.correct, r.checks
    assert r.steps >= 2 and r.audio_s > 0 and r.window_s > 0


def test_state_left_unchanged_is_caught(monkeypatch):
    from rnnt_tpu_torch.train import state

    monkeypatch.setattr(state.Optimizer, "apply_",
                        lambda self, model, grads, opt_state: None)
    r = train()
    assert not r.correct
    assert r.checks["change_gap"][0] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from rnnt_tpu_torch.train import steps

    inner = steps.batch_loss

    def half(model, cfg, batch, **kw):
        n = batch["labels"].shape[0] // 2
        return inner(model, cfg, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(steps, "batch_loss", half)
    r = train()
    assert not r.correct, r.checks


def test_a_small_leaf_updated_double_is_caught(monkeypatch):
    from rnnt_tpu_torch.train import state

    inner = state.Optimizer.apply_

    def double(self, model, grads, opt_state):
        grads = dict(grads)
        grads["joint.b1"] = grads["joint.b1"] * 2
        inner(self, model, grads, opt_state)

    monkeypatch.setattr(state.Optimizer, "apply_", double)
    r = train()
    assert not r.correct, r.checks
    assert r.checks["grad_gap_own_norm"][0] == pytest.approx(1.0, rel=1e-3)
    assert r.notes["readings"]["grad_gap_own_norm_leaf"] == "joint.b1"


def no_exchange():
    """Leave out the data-parallel gradient and loss sums (every rank)."""
    from rnnt_tpu_torch.parallel import mesh

    mesh.all_reduce_sum_ = lambda tensors, mesh_, group=None: None


@pytest.mark.parametrize("patch,correct", [(None, True),
                                           (no_exchange, False)])
def test_two_ranks_and_the_exchange_left_out(patch, correct):
    cell = tiny_cell("train", ranks=2)
    r = train(cell, patch)
    assert r.correct == correct, r.checks
    assert r.ranks == 2 and r.device["count"] == 2

