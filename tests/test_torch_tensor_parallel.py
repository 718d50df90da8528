"""Vocab tensor parallelism of the port (rnnt_tpu_torch.parallel, the TP
branches of ops.joint_loss_fused and ops.joint_loss_banded) on the CPU.

- The plain versions with labels shifted into a shard's columns (ids
  below 0 and at or above V_local) against the JAX package's
  `_compute_planes` in Pallas interpret mode.
- gloo processes of `tests/torch_tp_worker.py` on (data, model) = (1, 2)
  and (2, 2) meshes: one train step, fused and banded, against one port
  process on the whole batch within 1e-5 relative (loss, every gradient
  the optimizer reads with W2 and b2 gathered from the shards, every
  updated parameter, the BatchNorm statistics: only the order of the sums
  differs) and against the JAX package's step on the matching CPU mesh
  (`tests/test_sharding.py`'s recipe) at `tests/test_torch_train_step.py`'s
  bounds (loss rtol 1e-4 / atol 1e-3, parameters 1e-3).  Clipping engages,
  and a control that clips by each shard's own norm must fail the
  parameter check.  A 31-symbol vocabulary at mp=2 stays replicated.

The command-line surface (run_rnnt, bench_tp, the dry run) is in
`tests/test_torch_tensor_parallel_cli.py`.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from rnnt_tpu.config import tiny_config
from rnnt_tpu.ops import joint_loss_fused as JF
from rnnt_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                    param_sharding_rules)
from rnnt_tpu.train.state import create_train_state as j_create
from rnnt_tpu.train.steps import make_train_step as j_make_step
from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
from rnnt_tpu_torch.ops import joint_loss_fused as TF
from rnnt_tpu_torch.ops import planes_cuda
from rnnt_tpu_torch.parallel import mesh as tmesh
from rnnt_tpu_torch.parallel.mesh import VOCAB_SHARDED, free_port
from rnnt_tpu_torch.train.checkpoint import params_from_numpy

import torch_tp_worker as W
from mh_harness import format_failure, run_workers
from torch_helpers import numpy_tree, torch_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# clip at 0.5: the tiny model's first gradient norm is far above it
CFG = tiny_config(vocab_size=32, learning_rate=0.05, grad_clip_norm=0.5,
                  loss_band=3)
B, T, U = 4, 12, 4
MESHES = [(1, 2), (2, 2)]


# ------------------------------------------- plain versions, shifted ids


@pytest.mark.parametrize("shard", [0, 1])
def test_plain_planes_with_shifted_labels_equal_jax(shard):
    """K6's plain version at V_local = 16 of 32 with the labels shifted as
    for each shard: emit is the JAX kernel's (NEG where the id is not in
    the shard), denom and blank its too."""
    rng = np.random.default_rng(shard)
    Bq, Tq, U1, J, V = 2, 5, 6, 8, 16
    f = rng.standard_normal((Bq, Tq, J)).astype(np.float32)
    g = rng.standard_normal((Bq, U1, J)).astype(np.float32)
    b1 = rng.standard_normal(J).astype(np.float32) * 0.1
    w2 = rng.standard_normal((J, V)).astype(np.float32) * 0.3
    b2 = rng.standard_normal(V).astype(np.float32) * 0.1
    y = rng.integers(0, 2 * V, (Bq, U1)).astype(np.int32) - shard * V
    assert (y < 0).any() or (y >= V).any()
    # interpret mode off the TPU
    want = JF._compute_planes(*(jnp.asarray(a) for a in (f, g, y, b1, w2,
                                                          b2)))
    got = planes_cuda.joint_planes_plain(
        *(torch.from_numpy(a) for a in (f, g, y, b1, w2, b2)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    out = (y < 0) | (y >= V)
    assert (got[2].numpy()[np.broadcast_to(out[:, None, :], got[2].shape)]
            == TF.NEG).all()


@pytest.mark.parametrize("mod", ["fused", "banded"])
def test_plain_backward_scatters_nothing_out_of_shard(mod):
    """The backward's logit gradient (the JAX one-hot of the shifted id)
    leaves every column alone for an out-of-shard id and drops the blank
    term off shard 0; in range it equals the one-process gradient."""
    rng = np.random.default_rng(7)
    V = 6
    logits = torch.from_numpy(rng.standard_normal((2, 3, 4, V))).float()
    den = torch.logsumexp(logits, -1)
    occ, gbl, gem = (torch.from_numpy(rng.random((2, 3, 4))).float()
                     for _ in range(3))
    y = torch.tensor([[-2, 0, 5, 6], [9, -1, 3, 2]])
    yb = y[:, None, :].expand(2, 3, 4) if mod == "banded" else y[:, None, :]
    got = TF.dlogits_(logits.clone(), den, occ, gbl, gem, yb, False)
    soft = torch.exp(logits - den[..., None]) * occ[..., None]
    onehot = torch.nn.functional.one_hot(
        torch.where((y >= 0) & (y < V), y, V), V + 1)[..., :V].float()
    want = soft - gem[..., None] * onehot[:, None]
    torch.testing.assert_close(got, want)
    own = TF.dlogits_(logits.clone(), den, occ, gbl, gem, yb, True)
    want[..., 0] -= gbl
    torch.testing.assert_close(own, want)


# ------------------------------------------------- the train step on gloo


def _global_batch():
    rng = np.random.default_rng(3)
    labels = rng.integers(1, 31, (B, U)).astype(np.int32)  # valid at V=31
    return {"mel_specs": rng.standard_normal(
                (B, T, CFG.input_feat_size)).astype(np.float32),
            "pred_inp": np.concatenate([np.zeros((B, 1), np.int32), labels],
                                       1),
            "labels": labels,
            "spec_lengths": np.array([T, T - 2, T, T // 2], np.int32),
            "label_lengths": np.array([U, U - 1, U, 2], np.int32),
            # the zero weight sits on data row 1 only: the denominator is
            # global
            "loss_weight": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}


def _launch(mode, d, world, model, timeout=180):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"),
             mode, str(r), str(world), str(model), str(port), d]
            for r in range(world)]
    res = run_workers(cmds, env=env, cwd=REPO, timeout=timeout,
                      stall_timeout=None)
    assert all(rc == 0 for rc, _ in res), format_failure(mode, res)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The JAX state and batch, the one-process results and every rank's
    on both meshes."""
    d = str(tmp_path_factory.mktemp("tp_step"))
    jstate = j_create(jax.random.PRNGKey(0), CFG)
    TorchConfig(**CFG.__dict__).save(d)
    torch.save(torch_model(CFG, jstate.params).state_dict(),
               os.path.join(d, "params.pt"))
    j31 = j_create(jax.random.PRNGKey(0), CFG.replace(vocab_size=31))
    torch.save(torch_model(CFG.replace(vocab_size=31), j31.params)
               .state_dict(), os.path.join(d, "params31.pt"))
    batch = _global_batch()
    np.savez(os.path.join(d, "batch.npz"), **batch)
    ranks = {}
    for data, model in MESHES:
        _launch("step", d, data * model, model)
        ranks[data, model] = [
            torch.load(os.path.join(d, f"step_{data}x{model}_rank{r}.pt"))
            for r in range(data * model)]
    one = W.run_cases(d, batch, slice(None), None)
    return jstate, batch, one, ranks


def _close(got, want, rtol=1e-5, what=""):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale,
                               msg=lambda m: f"{what}: {m}")


def _gathered(ranks, model, row, key, name):
    """A rank's tensor `name` of `key`, the data row's shards concatenated
    where it is vocab-sharded."""
    mine = [r for r in ranks if r["mesh"][0] == row]
    mine.sort(key=lambda r: r["mesh"][1])
    parts = [r[key][name] for r in mine]
    if name in VOCAB_SHARDED and model > 1:
        return torch.cat(parts, VOCAB_SHARDED[name])
    return parts[0]


def _check_against_one(ranks, ref, model, case, keys=("grads", "params")):
    """Every data row's gradients and updated parameters (BatchNorm
    statistics included), W2 and b2 gathered, against one process's."""
    for row in {r["mesh"][0] for r in ranks}:
        for key in keys:
            for n, want in ref[key].items():
                got = _gathered([r[case] | {"mesh": r["mesh"]}
                                 for r in ranks], model, row, key, n)
                _close(got, want, what=f"row {row} {key} {n}")


@pytest.mark.parametrize("case", ["fused", "banded", "v31"])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_ranks_equal_one_process(step_run, mesh, case):
    _, _, one, ranks = step_run
    ref, rs = one[case], ranks[mesh]
    assert ref["grad_norm"] > CFG.grad_clip_norm  # clipping engages
    sharded = case != "v31"
    for out in rs:
        got = out[case]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-5)
        local = tuple(got["params"]["joint.w2"].shape)
        assert local == (CFG.joint_size, ref["params"]["joint.w2"].shape[1]
                         // (mesh[1] if sharded else 1))
    _check_against_one(rs, ref, mesh[1] if sharded else 1, case)


@pytest.mark.parametrize("mesh", MESHES)
def test_per_shard_clipping_control_fails(step_run, mesh):
    """Clipping by each shard's own norm (no sum over the model group)
    moves the parameters off the one-process step; the global norm of the
    same ranks holds them (test_tp_ranks_equal_one_process)."""
    _, _, one, ranks = step_run
    _check_against_one(ranks[mesh], one["fused"], mesh[1], "control",
                       ("grads",))
    with pytest.raises(AssertionError, match="params"):
        _check_against_one(ranks[mesh], one["fused"], mesh[1], "control",
                           ("params",))


def _jax_step(jstate, batch, data, model, impl):
    """The JAX package's step on a (data, model) CPU mesh."""
    step_fn = j_make_step(CFG, loss_impl=impl, donate=False)
    mesh = make_mesh(data=data, model=model,
                     devices=jax.devices()[: data * model])
    params = jax.tree_util.tree_map(
        jax.device_put, jstate.params, param_sharding_rules(mesh,
                                                            jstate.params))
    opt = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())),
        jstate.opt_state)
    st = jstate._replace(params=params, opt_state=opt, step=jax.device_put(
        jstate.step, NamedSharding(mesh, P())))
    bsh = batch_sharding(mesh)
    with jax.sharding.set_mesh(mesh):
        return step_fn(st, {k: jax.device_put(jnp.asarray(v), bsh)
                            for k, v in batch.items()},
                       jax.random.PRNGKey(1))


@pytest.mark.parametrize("impl", ["fused", "banded"])
@pytest.mark.parametrize("mesh", MESHES)
def test_tp_ranks_equal_jax_on_its_mesh(step_run, mesh, impl):
    jstate, batch, _, ranks = step_run
    js, jm = _jax_step(jstate, batch, *mesh, impl)
    want = params_from_numpy(numpy_tree(js.params))
    rs = ranks[mesh]
    for out in rs:
        np.testing.assert_allclose(out[impl]["loss"], float(jm["loss"]),
                                   rtol=1e-4, atol=1e-3)
    for row in range(mesh[0]):
        for name, t in want.items():
            got = _gathered([r[impl] | {"mesh": r["mesh"]} for r in rs],
                            mesh[1], row, "params", name)
            np.testing.assert_allclose(got.numpy(), t.numpy(), rtol=1e-3,
                                       atol=1e-3, err_msg=name)


def test_mesh_groups_and_shards():
    """One rank: the (data, model) layout, the vocab shard's columns and
    the divisibility guard, without a process group."""
    m = tmesh.make_mesh(ranks=range(4), model=2)
    assert m.shape == {"data": 2, "model": 2} and m.group is None
    assert (m.data_index, m.shard_index, m.shard_count) == (0, 0, 2)
    assert m.vocab_shard(32) is None  # no model group without a group
    tp = tmesh.VocabShard(None, 1, 2)
    w = torch.arange(12.0).reshape(2, 6)
    assert torch.equal(tmesh.shard_columns(w, 1, tp), w[:, 3:])
    assert torch.equal(tmesh.shard_columns(w[0], 0, tp), w[0, 3:])
