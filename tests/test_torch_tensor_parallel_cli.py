"""Vocab tensor parallelism of the port on the CPU, at its command-line
surface (the steps are in `tests/test_torch_tensor_parallel.py`):

- `run_rnnt --multihost --model_parallel 2` on 2 ranks (npz) and 4 ranks
  (dcp), gloo processes of `tests/torch_tp_worker.py`: train, eval, test;
  one port process evaluates each checkpoint equal, the npz has a
  one-process run's leaves and shapes, and the JAX package restores it;
  the other way, the ranks restore a JAX package's checkpoint onto their
  shards and evaluate it as one process does.
- `bench_tp --device cpu` at a tiny size.
- The dry run at n=2 and n=4 from the JAX dry run's initial parameters: its
  loss is the JAX step's on that batch (31.1820, as `MULTICHIP_r05.json`
  records for the JAX package's 4x2 mesh).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.train.checkpoint import save_checkpoint as j_save
from rnnt_tpu.train.state import create_train_state as j_create
from rnnt_tpu.train.steps import make_train_step as j_make_step
from rnnt_tpu_torch.config import RNNTConfig as TorchConfig
from rnnt_tpu_torch.data import records as TR
from rnnt_tpu_torch.data.tokenizer import SubwordTokenizer, WORD_MARK
from rnnt_tpu_torch.parallel.mesh import free_port
from rnnt_tpu_torch.train.checkpoint import params_from_numpy

from mh_harness import format_failure, run_workers
from torch_helpers import numpy_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(mode, d, world, model, timeout=240):
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmds = [[sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"),
             mode, str(r), str(world), str(model), str(port), d]
            for r in range(world)]
    res = run_workers(cmds, env=env, cwd=REPO, timeout=timeout,
                      stall_timeout=None)
    assert all(rc == 0 for rc, _ in res), format_failure(mode, res)


# ------------------------------------------------ run_rnnt across ranks


def _tokenizer_pieces(n):
    letters = "abcdefghijklmnopqrstuvwxyz'"
    return ([""] + list(letters) + [WORD_MARK]
            + [WORD_MARK + c for c in letters])[:n]


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
    """run_rnnt --multihost --model_parallel 2 on 2 ranks (npz) and on 4
    (dcp), a 32-piece word-piece vocabulary (sharded 16 a rank): 8 train
    examples, 4 dev and 4 test in 2 shards each."""
    d = str(tmp_path_factory.mktemp("tp_cli"))
    data = os.path.join(d, "data")
    cfg = TorchConfig(**tiny_config(token_type="word-piece",
                                    vocab_size=32).__dict__)
    cfg.save(data)
    SubwordTokenizer(_tokenizer_pieces(32)).save(data)
    rng = np.random.default_rng(0)
    for split, n in (("train", 8), ("dev", 4), ("test", 4)):
        TR.write_shards(_examples(n, rng, cfg),
                        f"{data}/{split}-{{shard:05d}}.rnr", 2)
    jcfg = tiny_config(token_type="word-piece", vocab_size=32)
    j_save(os.path.join(d, "jax_run"), j_create(jax.random.PRNGKey(2), jcfg),
           jcfg)
    recs = {}
    for world in (2, 4):
        _launch("cli", d, world, 2)
        tag = f"{world // 2}x2"
        recs[tag] = []
        for r in range(world):
            with open(os.path.join(d, f"cli_{tag}_rank{r}.json")) as f:
                recs[tag].append(json.load(f))
    return d, recs


def _one_process(d, tag, mode):
    from rnnt_tpu_torch.cli import run_rnnt

    run = os.path.join(d, tag if tag == "jax_run" else f"run_{tag}")
    return run_rnnt.main(["--mode", mode, "--data_dir",
                          os.path.join(d, "data"), "--checkpoint", run,
                          "--output_dir", run, "--batch_size", "2",
                          "--no-bf16", "--device", "cpu", "--pad_frames",
                          "64", "--pad_tokens", "8"])


@pytest.mark.parametrize("tag", ["1x2", "2x2"])
def test_multihost_tp_checkpoint_evaluates_equal_in_one_process(cli_run,
                                                                tag):
    d, recs = cli_run
    rs = recs[tag]
    # 8 examples: 4 batches of 2 on one data row, 2 on each of two
    steps = 4 if tag == "1x2" else 2
    for rec in rs:
        assert rec["trained_step"] == steps
        assert rec["w2_shape"] == [32, 16]  # this rank's columns
        for key in ("eval", "test", "eval_jax_run"):
            assert rec[key] == rs[0][key], key
    for mode, run, key in (("eval", tag, "eval"), ("test", tag, "test"),
                           ("eval", "jax_run", "eval_jax_run")):
        one = _one_process(d, run, mode)
        got = rs[0][key]
        assert got.keys() == one.keys()
        for k in one:
            np.testing.assert_allclose(got[k], one[k], rtol=1e-5, err_msg=k)


def test_tp_npz_has_one_process_layout_and_jax_reads_it(cli_run, tmp_path):
    from rnnt_tpu.train.checkpoint import restore_checkpoint as j_restore
    from rnnt_tpu_torch.train import checkpoint as tckpt
    from rnnt_tpu_torch.train.state import create_train_state

    d, _ = cli_run
    run = os.path.join(d, "run_1x2")
    path = tckpt.latest_checkpoint(run)
    assert path.endswith("checkpoint_00000004")
    cfg = tckpt.load_config(run)
    one = create_train_state(cfg, torch.float32, "cpu")
    tckpt.save_checkpoint(str(tmp_path), one, cfg)
    with np.load(os.path.join(path, "state.npz")) as a, np.load(
            os.path.join(str(tmp_path), "checkpoint_00000000",
                         "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
    from rnnt_tpu.config import RNNTConfig as JConfig

    jcfg = JConfig(**cfg.to_dict())
    js = j_restore(path, jcfg)
    assert int(js.step) == 4
    assert js.params["joint"]["w2"].shape == (cfg.joint_size, 32)
    back = tckpt.restore_checkpoint(path, cfg, torch.float32, "cpu")
    np.testing.assert_array_equal(
        np.asarray(js.params["joint"]["w2"]),
        back.model.joint.w2.detach().numpy())


# ------------------------------------------------- bench_tp and dry run


def test_bench_tp_cpu(capsys):
    from rnnt_tpu_torch.cli import bench_tp

    assert bench_tp.main(["--device", "cpu", "--batch", "2", "--frames",
                          "6", "--tokens", "3", "--reps", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(out[-1])
    assert rec["device"] == "cpu" and (rec["T"], rec["U1"]) == (3, 4)
    for k in ("full_ms", "half_ms", "tp_group_of_one_ms",
              "estimate_2rank_ms"):
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["traffic_bytes"] == {"forward_planes": 4 * 4 * 2 * 3 * 4,
                                    "backward_df_dg_db1": 4 * (
                                        2 * 3 * 640 + 2 * 4 * 640 + 640)}
    assert any("ASSUMED 450 GB/s" in line for line in out)


@pytest.fixture(scope="module")
def dryrun_params(tmp_path_factory):
    """The JAX dry run's initial parameters as an npz by dotted name, and
    its step's loss on its batch (one device)."""
    from rnnt_tpu_torch import dryrun

    cfg = tiny_config(
        vocab_size=32, encoder_layers=2, encoder_size=32, projection_size=16,
        pred_net_size=32, joint_size=16, embedding_size=16, mel_bins=8)
    assert TorchConfig(**cfg.__dict__) == dryrun.tiny_cfg()
    jstate = j_create(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path_factory.mktemp("dryrun") / "params.npz")
    np.savez(path, **{k: v.numpy() for k, v in params_from_numpy(
        numpy_tree(jstate.params)).items()})
    step_fn = j_make_step(cfg, loss_impl="fused", donate=False)
    batch = dryrun.global_batch(dryrun.tiny_cfg(), 4)
    _, m = step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                   jax.random.PRNGKey(1))
    return path, float(m["loss"])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_equals_jax_step(dryrun_params, n):
    from rnnt_tpu_torch import dryrun

    path, jloss = dryrun_params
    np.testing.assert_allclose(jloss, 31.1820, atol=5e-5)  # MULTICHIP_r05
    line = dryrun.dryrun_multichip(n, "cpu", path, timeout_s=240)
    model = dryrun.model_axis(n)
    assert line.startswith(
        f"dryrun_multichip({n}): mesh={{'data': {n // model}, 'model': "
        f"{model}}} processes={n} loss=") and line.endswith(" ok")
    loss = float(line.split("loss=")[1].split()[0])
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-4)


def test_bench_scaling_simulate_model_parallel(capsys):
    """bench_scaling --model_parallel 2 over 4 gloo ranks: the 1x2 and 2x2
    meshes (a size the model axis does not divide is skipped)."""
    from rnnt_tpu_torch.cli import bench_scaling

    assert bench_scaling.main([
        "--simulate", "4", "--model_parallel", "2", "--tiny", "--device",
        "cpu", "--frames", "16", "--labels", "4", "--per_device_batch", "2",
        "--steps", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [(r["devices"], r["mesh"], r["global_batch"]) for r in lines] == [
        (2, "1x2", 2), (4, "2x2", 4)]
    assert lines[0]["efficiency_vs_1dev"] == 1.0
    for r in lines:
        assert r["efficiency_vs_1dev"] > 0 and np.isfinite(r["loss"])


@pytest.mark.parametrize("flags,want", [
    ([], "with --multihost"),
    (["--multihost", "--pad_frames", "8", "--pad_tokens", "4",
      "--quantized", "a.npz"], "without --model_parallel")])
def test_model_parallel_refusals(flags, want, capsys):
    """--model_parallel > 1 runs one process a device (so it needs
    --multihost) and shards fp weights (so it refuses an int8 artifact)."""
    from rnnt_tpu_torch.cli import run_rnnt

    with pytest.raises(SystemExit):
        run_rnnt.parse_args(["--data_dir", "d", "--model_parallel", "2",
                             *flags])
    assert want in capsys.readouterr().err
