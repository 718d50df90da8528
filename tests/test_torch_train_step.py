"""Port train step, optimizer and checkpoints (rnnt_tpu_torch.train) vs the
JAX package: 4 steps of `tiny_config` from the same parameters and batch
against `make_train_step` (losses rtol 1e-4 / atol 1e-3, parameters 1e-3,
the JAX package's own bounds between its fused and unfused steps), and
checkpoints that each package's restore reads from the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.train import checkpoint as jckpt
from rnnt_tpu.train.state import create_train_state as j_create
from rnnt_tpu.train.steps import make_train_step as j_make_step
from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
from rnnt_tpu_torch.train import checkpoint as tckpt
from rnnt_tpu_torch.train import state as tstate
from rnnt_tpu_torch.train.checkpoint import params_from_numpy
from rnnt_tpu_torch.train.steps import batch_loss, make_train_step

from torch_helpers import numpy_tree, torch_model

torch.set_num_threads(1)

SGD = dict(learning_rate=0.02, grad_clip_norm=1.0)
ADAM = dict(learning_rate=1e-3, grad_clip_norm=1.0, optimizer="adam",
            warmup_steps=2, lr_schedule="cosine", decay_steps=6,
            lr_final_factor=0.1)


def _batch(cfg, B=4, T=12, U=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, cfg.vocab_size, (B, U)).astype(np.int32)
    return {"mel_specs": rng.standard_normal(
                (B, T, cfg.input_feat_size)).astype(np.float32),
            "pred_inp": np.concatenate([np.zeros((B, 1), np.int32), labels],
                                       1),
            "labels": labels,
            "spec_lengths": np.array([T, T - 2, T, T // 2], np.int32)[:B],
            "label_lengths": np.array([U, U - 1, U, 2], np.int32)[:B]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_state(cfg, jstate):
    """The port's TrainState holding a JAX state's parameters (zero
    optimizer state, step 0)."""
    model = torch_model(cfg, jstate.params).make_trainable_()
    tcfg = TorchConfig(**cfg.__dict__)
    return tstate.TrainState(step=0, model=model,
                             opt_state=tstate.Optimizer(tcfg).init(model))


@pytest.mark.parametrize("opt,impl", [("sgd", "fused"), ("sgd", "ref"),
                                      ("adam", "fused"), ("adam", "ref")])
def test_four_steps_match_jax(opt, impl):
    cfg = tiny_config(**(SGD if opt == "sgd" else ADAM))
    batch = _batch(cfg)
    js = j_create(jax.random.PRNGKey(0), cfg)
    ts = _port_state(cfg, js)
    j_step = j_make_step(cfg, loss_impl=impl, donate=False)
    t_step = make_train_step(TorchConfig(**cfg.__dict__), loss_impl=impl)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, _torch_batch(batch)
    j_losses, t_losses, lrs = [], [], []
    for _ in range(4):
        js, jm = j_step(js, jb, jax.random.PRNGKey(1))
        tm = t_step(ts, tb)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
        lrs.append((float(jm["lr"]), tm["lr"]))
        np.testing.assert_allclose(float(tm["grad_norm_encoder"]),
                                   float(jm["grad_norm_encoder"]), rtol=1e-3)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(*zip(*lrs), rtol=1e-6)
    assert ts.step == int(js.step) == 4
    want = params_from_numpy(numpy_tree(js.params))
    for name, t in ts.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_loss_weight_masks_fillers():
    cfg = TorchConfig(**tiny_config().__dict__)
    model = tstate.create_train_state(cfg, device="cpu").model
    real = _torch_batch(_batch(cfg, B=2))
    padded = _torch_batch(_batch(cfg, B=4))
    for k in real:
        padded[k][:2] = real[k]
    padded["mel_specs"][2:] = 999.0
    padded["loss_weight"] = torch.tensor([1.0, 1.0, 0.0, 0.0])
    loss_pad, _ = batch_loss(model, cfg, padded, training=False)
    loss_real, _ = batch_loss(model, cfg, real, training=False)
    torch.testing.assert_close(loss_pad, loss_real, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_checkpoint_restores_in_jax_and_back(opt, tmp_path):
    cfg = tiny_config(**(SGD if opt == "sgd" else ADAM))
    tcfg = TorchConfig(**cfg.__dict__)
    ts = tstate.create_train_state(tcfg, device="cpu", seed=3)
    make_train_step(tcfg)(ts, _torch_batch(_batch(cfg)))
    tckpt.save_checkpoint(str(tmp_path), ts, tcfg)
    js = jckpt.restore_checkpoint(str(tmp_path), cfg)
    assert int(js.step) == ts.step == 1
    want = ts.model.state_dict()
    got = params_from_numpy(numpy_tree(js.params))
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
    j_opt = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt_state)]
    t_opt = [c[k] for c, k in tstate.Optimizer.slots(ts.opt_state)]
    assert len(j_opt) == len(t_opt)
    for a, b in zip(j_opt, t_opt):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(a, b)
    # and the JAX state, stepped once more and saved, resumes in the port
    js, _ = j_make_step(cfg, donate=False)(
        js, {k: jnp.asarray(v) for k, v in _batch(cfg).items()},
        jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(tmp_path / "jax"), js, cfg)
    back = tckpt.restore_checkpoint(str(tmp_path / "jax"), tcfg,
                                   device="cpu")
    assert back.step == 2
    want = params_from_numpy(numpy_tree(js.params))
    for name, t in back.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    j_opt = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt_state)]
    t_opt = [c[k] for c, k in tstate.Optimizer.slots(back.opt_state)]
    for a, b in zip(j_opt, t_opt):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(a, b)


def test_async_saver_prunes_and_init_from(tmp_path):
    tcfg = TorchConfig(**tiny_config(**SGD).__dict__)
    ts = tstate.create_train_state(tcfg, device="cpu")
    saver = tckpt.AsyncSaver()
    for step in range(1, 8):
        ts.step = step
        saver.save(str(tmp_path), ts, tcfg, keep=3)
        # the snapshot is taken at save(): later updates do not leak into it
        with torch.no_grad():
            ts.model.joint.b1.add_(1.0)
    saver.wait()
    assert tckpt.list_checkpoint_steps(str(tmp_path)) == [5, 6, 7]
    back = tckpt.restore_checkpoint(str(tmp_path), tcfg, device="cpu")
    assert back.step == 7
    torch.testing.assert_close(back.model.joint.b1,
                               ts.model.joint.b1.detach() - 1.0)
    warm = tckpt.init_from_checkpoint(str(tmp_path), tcfg.replace(
        optimizer="adam"), device="cpu")
    assert warm.step == 0 and "mu" in warm.opt_state
    torch.testing.assert_close(warm.model.joint.b1, back.model.joint.b1)
