"""Data parallelism of the port (rnnt_tpu_torch.parallel) on the CPU: two
gloo processes, each with half of a global batch, against one process on
the whole batch, and that one process against the JAX package's train
step; then `run_rnnt --multihost` with two ranks and `bench_scaling
--simulate 2`.

Bounds: 2 ranks vs 1 process within 1e-5 relative (the loss, every
gradient the optimizer reads, the input gradient, the BatchNorm running
statistics and the updated parameters: only the order of the sums
differs); 1 process vs JAX at `tests/test_torch_train_step.py`'s bounds
(loss rtol 1e-4 / atol 1e-3, parameters 1e-3).  The BatchNorm statistics
read only the input features, so no parameter gradient flows through
them: the input gradient is the one that does, and the control (the
statistics summed under no_grad) must fail it."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.train.state import create_train_state as j_create
from rnnt_tpu.train.steps import make_train_step as j_make_step
from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
from rnnt_tpu_torch.data import records as TR
from rnnt_tpu_torch.parallel.mesh import free_port
from rnnt_tpu_torch.train.checkpoint import params_from_numpy

import torch_dp_worker as W
from mh_harness import format_failure, run_workers
from torch_helpers import numpy_tree, torch_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# clip at 0.5: the tiny model's first gradient norm is far above it
CFG = tiny_config(learning_rate=0.05, grad_clip_norm=0.5, loss_band=3)
B, T, U = 4, 12, 4


def _global_batch():
    rng = np.random.default_rng(3)
    labels = rng.integers(1, CFG.vocab_size, (B, U)).astype(np.int32)
    return {"mel_specs": rng.standard_normal(
                (B, T, CFG.input_feat_size)).astype(np.float32),
            "pred_inp": np.concatenate([np.zeros((B, 1), np.int32), labels],
                                       1),
            "labels": labels,
            "spec_lengths": np.array([T, T - 2, T, T // 2], np.int32),
            "label_lengths": np.array([U, U - 1, U, 2], np.int32),
            # the zero weight sits on rank 1 only: the denominator is global
            "loss_weight": np.array([1.0, 1.0, 1.0, 0.0], np.float32)}


def _launch(mode, d, world=2, timeout=120):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"),
             mode, str(r), str(world), str(port), d] for r in range(world)]
    res = run_workers(cmds, env=env, cwd=REPO, timeout=timeout,
                      stall_timeout=None)
    assert all(rc == 0 for rc, _ in res), format_failure(mode, res)


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """The JAX state and batch, the one-process results and both ranks'."""
    d = str(tmp_path_factory.mktemp("dp_step"))
    jstate = j_create(jax.random.PRNGKey(0), CFG)
    tcfg = TorchConfig(**CFG.__dict__)
    tcfg.save(d)
    sd = torch_model(CFG, jstate.params).state_dict()
    torch.save(sd, os.path.join(d, "params.pt"))
    batch = _global_batch()
    np.savez(os.path.join(d, "batch.npz"), **batch)
    _launch("step", d)
    ranks = [torch.load(os.path.join(d, f"step_rank{r}.pt"))
             for r in range(2)]
    one = W.run_cases(tcfg, sd, batch, slice(None), None)
    return jstate, batch, one, ranks


def _close(got, want, rtol=1e-5, what=""):
    scale = float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * scale,
                               msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("impl", W.IMPLS)
def test_two_ranks_equal_one_process(step_run, impl):
    _, _, one, ranks = step_run
    ref = one[impl]
    assert ref["grad_norm"] > CFG.grad_clip_norm  # clipping fires
    for r, out in enumerate(ranks):
        got = out[impl]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   rtol=1e-5)
        assert got["grads"].keys() == ref["grads"].keys()
        for n, g in ref["grads"].items():
            _close(got["grads"][n], g, what=f"rank {r} grad {n}")
        for n, p in ref["params"].items():  # BatchNorm statistics included
            _close(got["params"][n], p, what=f"rank {r} {n}")
        _close(got["mel_grad"], ref["mel_grad"][2 * r: 2 * r + 2],
               what=f"rank {r} d loss / d mel")
    # every rank takes the identical update
    for n, p in ranks[0][impl]["params"].items():
        assert torch.equal(p, ranks[1][impl]["params"][n]), n


def test_running_statistics_are_the_global_batchs(step_run):
    _, batch, _, ranks = step_run
    x = torch.from_numpy(batch["mel_specs"]).double()
    mean = x.mean(dim=(0, 1))
    var = x.var(dim=(0, 1), unbiased=False)
    for out in ranks:
        p = out["fused"]["params"]
        _close(p["encoder.bn.mean"].double(), 0.01 * mean, what="mean")
        _close(p["encoder.bn.var"].double(), 0.99 + 0.01 * var, what="var")


def test_no_grad_statistics_control_fails_the_gradient_check(step_run):
    _, _, one, ranks = step_run
    want = one["fused"]["mel_grad"]
    for r, out in enumerate(ranks):
        got = out["control_mel_grad"]
        with pytest.raises(AssertionError):
            _close(got, want[2 * r: 2 * r + 2], what="control")
        # while the differentiable reduction passes the same check
        _close(out["fused"]["mel_grad"], want[2 * r: 2 * r + 2])


@pytest.mark.parametrize("impl", ["fused"])
def test_one_process_equals_jax_step(step_run, impl):
    jstate, batch, one, _ = step_run
    j_step = j_make_step(CFG, loss_impl=impl, donate=False)
    js, jm = j_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(1))
    np.testing.assert_allclose(one[impl]["loss"], float(jm["loss"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(one[impl]["grad_norm"], float(jm["grad_norm"]),
                               rtol=1e-3)
    want = params_from_numpy(numpy_tree(js.params))
    for name, t in one[impl]["params"].items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def _examples(n, rng, cfg):
    for _ in range(n):
        t, u = int(rng.integers(20, 40)), int(rng.integers(3, 8))
        labels = rng.integers(1, cfg.vocab_size, u).astype(np.int32)
        yield {"mel_specs": rng.standard_normal(
                   (t, cfg.input_feat_size)).astype(np.float32),
               "pred_inp": np.concatenate([[0], labels]).astype(np.int32),
               "labels": labels, "spec_lengths": np.int32(t),
               "label_lengths": np.int32(u)}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """run_rnnt --multihost on 2 ranks: 14 train examples in 3 shards (rank
    0 reads shards 0 and 2, 9 examples, 5 batches; rank 1 shard 1, 5
    examples, 3 batches), 6 dev examples in 3 shards."""
    d = str(tmp_path_factory.mktemp("dp_cli"))
    data = os.path.join(d, "data")
    cfg = TorchConfig(**tiny_config().__dict__)
    cfg.save(data)
    rng = np.random.default_rng(0)
    TR.write_shards(_examples(14, rng, cfg), f"{data}/train-{{shard:05d}}.rnr",
                    3)
    TR.write_shards(_examples(6, rng, cfg), f"{data}/dev-{{shard:05d}}.rnr", 3)
    _launch("cli", d, timeout=240)
    recs = []
    for r in range(2):
        with open(os.path.join(d, f"cli_rank{r}.json")) as f:
            recs.append(json.load(f))
    return d, recs


def test_multihost_lockstep_checkpoint_and_resume(cli_run):
    d, recs = cli_run
    for rec in recs:
        # min(5, 3) = 3 steps an epoch on both ranks, 2 epochs, then 1 more
        assert rec["trained_step"] == 6 and rec["resumed_step"] == 9
        assert rec["latest"] == "checkpoint_00000006.dcp"
        assert rec["steps_listed"] == [2, 4, 6]
        assert rec["restored_bitwise"] and rec["opt_bitwise"]
        assert "dcp" in rec["npz_error"]
    assert os.path.isdir(os.path.join(d, "run", "checkpoint_00000009.dcp"))
    with open(os.path.join(d, "run", "tb", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    # only rank 0 writes: one record a logged step
    steps = [r["step"] for r in logged if "train_loss" in r]
    assert steps == [1, 2, 3, 4, 5, 6, 7, 8, 9]


def test_multihost_eval_equals_one_process(cli_run, capsys):
    from rnnt_tpu_torch.cli import run_rnnt

    d, recs = cli_run
    assert recs[0]["eval"] == recs[1]["eval"]
    one = run_rnnt.main(["--mode", "eval", "--data_dir",
                         os.path.join(d, "data"), "--checkpoint",
                         os.path.join(d, "run"), "--output_dir",
                         os.path.join(d, "run"), "--batch_size", "2",
                         "--no-bf16", "--device", "cpu", "--pad_frames", "64",
                         "--pad_tokens", "8"])
    got = recs[0]["eval"]
    assert got.keys() == one.keys()
    for k in one:
        np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)


def test_bench_scaling_simulate_two(capsys):
    from rnnt_tpu_torch.cli import bench_scaling

    assert bench_scaling.main(["--simulate", "2", "--tiny", "--device", "cpu",
                               "--frames", "16", "--labels", "4",
                               "--per_device_batch", "2", "--steps", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [r["devices"] for r in lines] == [1, 2]
    assert lines[0]["efficiency_vs_1dev"] == 1.0
    for r in lines:
        assert r["efficiency_vs_1dev"] > 0 and np.isfinite(r["loss"])
        assert r["global_batch"] == 2 * r["devices"]
