"""The port's training CLI (rnnt_tpu_torch.cli.run_rnnt) on the CPU: a tiny
config trains a few steps from shards written by the JAX package's writer,
logs and checkpoints, resumes, and evaluates with --mode test, also on an
int8 artifact (dequantized and int8-executed); the flags it has not ported
yet, or takes only with others, are refused, never ignored."""

import json
import os

import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data import records as JR
from rnnt_tpu_torch.cli import run_rnnt
from rnnt_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)


@pytest.fixture
def data_dir(tmp_path):
    cfg = tiny_config()
    d = tmp_path / "data"
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

    for split, n in (("train", 8), ("dev", 4), ("test", 4)):
        JR.write_shards(examples(n), str(d / f"{split}-{{shard:05d}}.rnr"), 2)
    return str(d)


def _argv(mode, data, **kw):
    argv = ["--mode", mode, "--data_dir", data, "--batch_size", "4",
            "--no-bf16", "--device", "cpu", "--pad_frames", "64",
            "--pad_tokens", "8"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return argv


def test_train_then_resume_then_test(data_dir, tmp_path, capsys):
    out = str(tmp_path / "run")
    run_rnnt.main(_argv("train", data_dir, output_dir=out, n_epochs=2,
                        steps_per_log=1, steps_per_checkpoint=3, eval_size=1,
                        config_override="learning_rate=0.01"))
    assert tckpt.list_checkpoint_steps(out) == [3, 4]
    with open(os.path.join(out, "tb", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert sum("eval_loss" in r for r in recs) == 2
    assert json.load(open(os.path.join(out, "config.json")))[
        "learning_rate"] == 0.01
    # --checkpoint auto resumes in place at step 4
    state = run_rnnt.main(_argv("train", data_dir, output_dir=out,
                                checkpoint="auto", n_epochs=1))
    assert state.step == 6
    capsys.readouterr()
    metrics = run_rnnt.main(_argv("test", data_dir, checkpoint=out,
                                  output_dir=out))
    printed = capsys.readouterr().out
    assert "eval_loss=" in printed and "eval_wer=" in printed
    assert np.isfinite(metrics["eval_loss"])
    beam = run_rnnt.main(_argv("eval", data_dir, checkpoint=out,
                               output_dir=out, decode="beam"))
    assert np.isfinite(beam["eval_loss"]) and 0 <= beam["eval_wer"] <= 1
    # eval never rewrites the training sidecar
    assert json.load(open(os.path.join(out, "config.json")))[
        "learning_rate"] == 0.01


@pytest.mark.parametrize("flags", [
    ["--model_parallel", "2"], ["--multihost"], ["--ckpt_backend", "orbax"]])
def test_unported_flags_are_refused(flags, capsys):
    """--model_parallel > 1 runs one process a device, so without
    --multihost it is refused with a message naming it; --multihost
    without --pad_frames/--pad_tokens is refused, as by the JAX CLI; orbax
    is the JAX package's backend, and the message names the port's dcp."""
    with pytest.raises(SystemExit):
        run_rnnt.parse_args(["--data_dir", "d", *flags])
    want = {"--model_parallel": "with --multihost",
            "--multihost": "--multihost requires --pad_frames/--pad_tokens",
            "--ckpt_backend": "use dcp"}[flags[0]]
    assert want in capsys.readouterr().err


@pytest.fixture
def trained(data_dir, tmp_path):
    """A 2-step run of the tiny config and its int8 artifact."""
    from rnnt_tpu_torch.cli import quantize_model

    out = str(tmp_path / "run")
    run_rnnt.main(_argv("train", data_dir, output_dir=out, n_epochs=1,
                        steps_per_log=1, steps_per_checkpoint=100,
                        eval_size=1))
    art = str(tmp_path / "model_int8.npz")
    assert quantize_model.main(["--checkpoint", out, "-o", art, "--device",
                                "cpu"]) == 0
    return out, art


@pytest.mark.parametrize("case", ["dequantized", "int8_exec",
                                  "int8_exec_beam"])
def test_eval_on_an_int8_artifact(data_dir, trained, case, capsys):
    """--quantized scores the artifact's weights; with --int8_exec the
    prediction net and joint run in int8, greedy or beam (the XLA beam's
    counterpart), and no loss is reported, as the JAX CLI."""
    out, art = trained
    capsys.readouterr()
    kw = dict(checkpoint=out, output_dir=out, quantized=art)
    argv = _argv("eval" if case == "dequantized" else "test", data_dir, **kw)
    if case != "dequantized":
        argv.append("--int8_exec")
    if case == "int8_exec_beam":
        argv += ["--decode", "beam"]
    metrics = run_rnnt.main(argv)
    printed = capsys.readouterr().out
    assert "eval_wer=" in printed
    assert 0 <= metrics["eval_wer"] and 0 <= metrics["eval_cer"]
    assert np.isfinite(metrics["eval_accuracy"])
    if case == "dequantized":
        assert np.isfinite(metrics["eval_loss"])
    else:
        assert np.isnan(metrics["eval_loss"])


def test_int8_exec_train_exits_with_the_jax_message(data_dir, trained,
                                                    tmp_path):
    out, art = trained
    with pytest.raises(SystemExit) as e:
        run_rnnt.main(_argv("train", data_dir, output_dir=str(tmp_path / "t"),
                            quantized=art) + ["--int8_exec"])
    assert "--int8_exec is an inference path" in str(e.value.code)


def test_lone_int8_exec_does_nothing(data_dir, trained, capsys):
    """--int8_exec without --quantized is accepted and changes nothing, as
    in the JAX CLI."""
    out, _ = trained
    base = run_rnnt.main(_argv("test", data_dir, checkpoint=out,
                               output_dir=out))
    lone = run_rnnt.main(_argv("test", data_dir, checkpoint=out,
                               output_dir=out) + ["--int8_exec"])
    assert lone == base
