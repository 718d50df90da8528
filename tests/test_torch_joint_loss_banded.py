"""Port banded loss (rnnt_tpu_torch.ops.joint_loss_banded, on the CPU the
plain versions of K6 and K7) vs the JAX package's
`rnnt_tpu.ops.joint_loss_banded` (its Pallas plane kernel in interpret mode)
on the same inputs: the band starts equal; the loss within 1e-5 and the
gradients of f, g, b1, w2 and b2 within 1e-4 (relative to the largest
element) in fp32 at bands 8 and 16 and at a band >= U+1; the wide band
equal to the port's fused loss; a fully pruned utterance at 1e9 with a zero
gradient in both packages; one train step with loss_impl="banded" against
JAX's at the fused train step test's bounds; and `cli.run_rnnt --loss_impl
banded` training on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.ops import joint_loss_banded as JB
from rnnt_tpu_torch.ops import joint_loss_banded as TB
from rnnt_tpu_torch.ops import joint_loss_fused as TF
from rnnt_tpu_torch.ops import lattice_cuda, planes_cuda

torch.set_num_threads(1)

B, T, U, J, V = 4, 24, 12, 16, 24


def _problem(seed=1, tl=(T, 3 * T // 4, T, T // 2),
             ll=(U, 3 * U // 4, U, U // 3)):
    rng = np.random.default_rng(seed)
    f = (rng.standard_normal((B, T, J)) * 0.5).astype(np.float32)
    g = (rng.standard_normal((B, U + 1, J)) * 0.5).astype(np.float32)
    b1 = (rng.standard_normal(J) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((J, V)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, (B, U)).astype(np.int32)
    return (f, g, b1, w2, b2, labels, np.asarray(tl, np.int32),
            np.asarray(ll, np.int32))


def _jax(problem, band, weights):
    """JAX's loss and gradients of sum(loss * weights) for f, g, b1, w2,
    b2."""
    args = [jnp.asarray(a) for a in problem]
    loss = JB.rnnt_loss_banded(*args, band=band)
    grads = jax.grad(lambda *p: jnp.sum(JB.rnnt_loss_banded(
        *p, *args[5:], band=band) * weights), argnums=range(5))(*args[:5])
    return np.asarray(loss), [np.asarray(x) for x in grads]


def _port(problem, band, weights, fn=None):
    """The port's loss and the gradients of sum(loss * weights)."""
    ts = [torch.from_numpy(a.copy()) for a in problem]
    for a in ts[:5]:
        a.requires_grad_()
    fn = fn or (lambda *a: TB.rnnt_loss_banded(*a, band=band))
    loss = fn(*ts)
    (loss * torch.from_numpy(weights)).sum().backward()
    return loss.detach().numpy(), [a.grad.numpy() for a in ts[:5]]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("band", [8, 16, 32])
def test_band_starts_match_jax(band):
    rng = np.random.default_rng(band)
    el = rng.integers(1, 60, 16).astype(np.int32)
    yl = rng.integers(0, 40, 16).astype(np.int32)
    want = JB.band_starts(jnp.asarray(el), jnp.asarray(yl), 60, 48, band)
    got = TB.band_starts(torch.from_numpy(el), torch.from_numpy(yl), 60, 48,
                         band)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("band", [8, 16, U + 1])
def test_loss_and_grads_match_jax(band):
    problem = _problem()
    w = np.arange(1.0, B + 1.0, dtype=np.float32)
    counts = (planes_cuda.joint_planes.launches,
              lattice_cuda.lattice_scan.launches)
    loss, grads = _port(problem, band, w)
    assert (planes_cuda.joint_planes.launches,
            lattice_cuda.lattice_scan.launches) == counts  # plain on CPU
    want, want_grads = _jax(problem, band, w)
    assert np.all(np.isfinite(loss))
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    for name, g, wg in zip(("f", "g", "b1", "w2", "b2"), grads, want_grads):
        assert g.shape == wg.shape
        assert _rel(g, wg) <= 1e-4, (name, _rel(g, wg))


def test_wide_band_equals_fused_loss():
    problem = _problem(seed=2)
    w = np.ones(B, np.float32)
    banded, b_grads = _port(problem, U + 1, w)
    fused, f_grads = _port(problem, None, w, fn=TF.rnnt_loss_fused)
    narrow, _ = _port(problem, 8, w)
    np.testing.assert_allclose(banded, fused, rtol=1e-5)
    for g, fg in zip(b_grads, f_grads):
        assert _rel(g, fg) <= 1e-4
    assert np.all(narrow >= fused - 1e-4)  # pruning only removes paths
    assert np.any(narrow > fused + 1e-3)


def test_fully_pruned_utterance_gives_1e9_and_zero_gradient():
    # utterance 3: 10 frames for 12 labels, band 8: the first t-tile's window
    # ends at u = 7, the second's starts past it, so no path survives
    problem = _problem(seed=3, tl=(T, T, T, 10), ll=(U // 2, U // 3, U, U))
    w = np.ones(B, np.float32)
    loss, grads = _port(problem, 8, w)
    want, want_grads = _jax(problem, 8, w)
    assert loss[3] == want[3] == 1e9
    assert np.all(loss[:3] < 1e3)
    np.testing.assert_allclose(loss[:3], want[:3], rtol=1e-5)
    for g, wg in zip(grads, want_grads):
        assert np.all(np.isfinite(g))
        assert _rel(g, wg) <= 1e-4
    f_grad, g_grad = grads[0], grads[1]
    assert np.all(f_grad[3] == 0) and np.all(g_grad[3] == 0)
    assert np.any(f_grad[2] != 0)


def test_train_step_matches_jax():
    """One step with loss_impl="banded" against JAX's make_train_step on the
    same parameters and batch, at the fused train-step test's bounds (loss
    rtol 1e-4 / atol 1e-3, parameters 1e-3)."""
    from rnnt_tpu.train.state import create_train_state as j_create
    from rnnt_tpu.train.steps import make_train_step as j_make_step
    from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
    from rnnt_tpu_torch.train import state as tstate
    from rnnt_tpu_torch.train.checkpoint import params_from_numpy
    from rnnt_tpu_torch.train.steps import make_train_step
    from torch_helpers import numpy_tree, torch_model

    cfg = tiny_config(learning_rate=0.02, grad_clip_norm=1.0, loss_band=8)
    rng = np.random.default_rng(0)
    Bt, Tt, Ut = 4, 24, 10
    labels = rng.integers(1, cfg.vocab_size, (Bt, Ut)).astype(np.int32)
    batch = {"mel_specs": rng.standard_normal(
                 (Bt, Tt, cfg.input_feat_size)).astype(np.float32),
             "pred_inp": np.concatenate([np.zeros((Bt, 1), np.int32),
                                         labels], 1),
             "labels": labels,
             "spec_lengths": np.array([Tt, Tt - 4, Tt, Tt // 2], np.int32),
             "label_lengths": np.array([Ut, Ut - 2, Ut, 3], np.int32)}
    js = j_create(jax.random.PRNGKey(0), cfg)
    model = torch_model(cfg, js.params).make_trainable_()
    tcfg = TorchConfig(**cfg.__dict__)
    ts = tstate.TrainState(step=0, model=model,
                           opt_state=tstate.Optimizer(tcfg).init(model))
    js, jm = j_make_step(cfg, loss_impl="banded", donate=False)(
        js, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))
    tm = make_train_step(tcfg, loss_impl="banded")(
        ts, {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
             else torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-3)
    want = params_from_numpy(numpy_tree(js.params))
    for name, t in ts.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_run_rnnt_trains_banded(tmp_path):
    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.config import tiny_config as t_tiny
    from rnnt_tpu_torch.data.records import write_shards

    d = tmp_path / "data"
    cfg = t_tiny(loss_band=8)
    cfg.save(str(d))
    rng = np.random.default_rng(0)

    def examples(n):
        for _ in range(n):
            t, u = int(rng.integers(20, 40)), int(rng.integers(3, 8))
            labels = rng.integers(1, cfg.vocab_size, u).astype(np.int32)
            yield {"mel_specs": rng.standard_normal(
                       (t, cfg.input_feat_size)).astype(np.float32),
                   "pred_inp": np.concatenate([[0], labels]).astype(np.int32),
                   "labels": labels, "spec_lengths": np.int32(t),
                   "label_lengths": np.int32(u)}

    for split, n in (("train", 8), ("dev", 4)):
        write_shards(examples(n), str(d / f"{split}-{{shard:05d}}.rnr"), 1)
    out = str(tmp_path / "run")
    common = ["--data_dir", str(d), "--output_dir", out, "--batch_size", "4",
              "--no-bf16", "--device", "cpu", "--pad_frames", "64",
              "--pad_tokens", "8", "--loss_impl", "banded"]
    run_rnnt.main(["--mode", "train", "--n_epochs", "1", "--steps_per_log",
                   "1", "--eval_size", "1", *common])
    with open(f"{out}/tb/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert any("eval_loss" in r for r in recs)
    metrics = run_rnnt.main(["--mode", "eval", "--checkpoint", out,
                             "--eval_size", "1", *common])
    assert np.isfinite(metrics["eval_loss"])
