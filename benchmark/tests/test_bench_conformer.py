"""The Conformer cell's driver on the CPU at a tiny model: a sound run is
correct, and a run with the timed path broken underneath is not; the
operation counts add up; the cell's readers return nothing where a run
has nothing for them (a traced run's slice without the program's spans)."""

import dataclasses
import time

import pytest

from benchlib import conformer_flops as cf
from benchlib.result import read_metric
from benchlib.spec import Cell
from drivers import train_step_conformer


def tiny_m():
    from rnnt_tpu_torch.config import tiny_config

    return dataclasses.asdict(tiny_config(
        encoder_type="conformer", time_reduction_index=-1, encoder_layers=2,
        conformer_dim=32, conformer_heads=4, conformer_ffn_size=64,
        conformer_kernel_size=8, optimizer="adam", learning_rate=0.0022,
        compute_dtype="float32"))


def tiny_cell():
    tr = {"driver": "train_step_conformer", "batch": 4, "frames": 40,
          "labels": 5, "ranks": 1, "distinct_batches": 4,
          "loss_impl": "fused", "reference_steps": 3, "profile_steps": 2}
    lim = {"grad_gap": 1e-3, "change_gap": 0.02, "grad_gap_own_norm": 1e-3,
           "change_gap_own_norm": 0.02}
    return Cell(name="tiny.conformer", chips=1, config_name="tiny",
                config={"model": tiny_m()}, traffic_name="tiny", traffic=tr,
                limits=lim, end_to_end=[], per_layer=[])


def train():
    return train_step_conformer.run(tiny_cell(), 2**31 + 23, 0.5, False,
                                    time.perf_counter(), device="cpu")


def test_sound_conformer_run_is_correct():
    r = train()
    assert r.correct, r.checks
    assert r.steps >= 2 and r.audio_s > 0
    assert r.notes["counters"]["attention_launches_by_path"]["plain"] > 0
    # the leaves whose gradient is rounding alone are left out of the change
    assert all(n.endswith(("k_b", "dw_b"))
               for n in r.notes["left_out_leaves"])
    for name in ("train_audio_s_per_s", "conformer_mfu.train"):
        assert read_metric(name, r) > 0
    for name in ("mhsa_roofline.train", "conv_module_roofline.train",
                 "subsample_roofline.train"):
        assert read_metric(name, r) is None  # no traced slice


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from rnnt_tpu_torch.train import steps

    inner = steps.batch_loss

    def half(model, cfg, batch, **kw):
        n = batch["labels"].shape[0] // 2
        return inner(model, cfg, {k: v[:n] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(steps, "batch_loss", half)
    assert not train().correct


def test_state_left_unchanged_is_caught(monkeypatch):
    from rnnt_tpu_torch.train import state

    inner = state.Optimizer.apply_

    def frozen(self, model, grads, opt_state):
        inner(self, model, {n: g * 0 for n, g in grads.items()}, opt_state)

    monkeypatch.setattr(state.Optimizer, "apply_", frozen)
    r = train()
    assert not r.correct
    assert r.checks["change_gap"][0] == pytest.approx(1.0)


def test_operation_counts_add_up():
    m = tiny_m()
    B, T, U = 4, 40, 5
    s = cf.shapes(m, B, T)
    assert (s["Tp"], s["F2"]) == (10, 4)
    L = m["encoder_layers"]
    blocks = L * (2 * cf.ffn_cost(m, B, T)[1] + cf.mhsa_cost(m, B, T)[1]
                  + cf.conv_cost(m, B, T)[1])
    assert cf.forward_flops(m, B, T, U) > blocks + cf.subsample_cost(
        m, B, T)[1]
    assert cf.train_step_flops(m, B, T, U) == 3 * cf.forward_flops(m, B, T, U)
    # the FFN's products at its shapes: two [N, D] x [D, ffn] products
    assert cf.ffn_cost(m, B, T)[1] == 2 * 2 * (B * 10) * 32 * 64
    for mod in ("subsample", "mhsa", "conv", "ffn"):
        assert cf.module_least_s(mod, m, B, T) > 0
