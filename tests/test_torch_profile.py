"""The port's training surface on the CPU: `run_rnnt --profile_dir` writes
a torch.profiler trace of the mode's work (train and test), training with
SpecAugment runs through the CLI, and the port's MetricsWriter writes the
TensorBoard scalars and HParams plugin event that the JAX writer does."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from rnnt_tpu.config import tiny_config
from rnnt_tpu.data import records as JR
from rnnt_tpu.train import observe as j_observe
from rnnt_tpu_torch.cli import run_rnnt
from rnnt_tpu_torch.config import tiny_config as t_tiny_config
from rnnt_tpu_torch.train import observe

torch.set_num_threads(1)


@pytest.fixture
def data_dir(tmp_path):
    cfg = tiny_config()
    d = tmp_path / "data"
    cfg.save(str(d))
    rng = np.random.default_rng(1)

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


def _argv(mode, data, *extra):
    return ["--mode", mode, "--data_dir", data, "--batch_size", "4",
            "--no-bf16", "--device", "cpu", "--pad_frames", "64",
            "--pad_tokens", "8", *extra]


def _trace(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


def test_profile_dir_traces_train_and_test(data_dir, tmp_path, capsys):
    out, prof = str(tmp_path / "run"), str(tmp_path / "prof")
    run_rnnt.main(_argv("train", data_dir, "--output_dir", out,
                        "--n_epochs", "1", "--steps_per_log", "1",
                        "--eval_size", "1", "--profile_dir", prof))
    path = os.path.join(prof, "run_rnnt_train.pt.trace.json")
    assert f"profile trace written to {path}" in capsys.readouterr().out
    names = _trace(path)
    # the step's forward, backward and update ops
    assert {"aten::mm", "aten::addmm"} & names
    assert any(n.startswith("autograd::engine::evaluate_function") for n in
               names)
    metrics = run_rnnt.main(_argv("test", data_dir, "--checkpoint", out,
                                  "--output_dir", out, "--profile_dir", prof))
    assert np.isfinite(metrics["eval_loss"])
    names = _trace(os.path.join(prof, "run_rnnt_test.pt.trace.json"))
    assert {"aten::mm", "aten::addmm"} & names
    assert not any(n.startswith("autograd::engine") for n in names)


def test_train_with_specaugment_through_the_cli(data_dir, tmp_path):
    out = str(tmp_path / "run")
    state = run_rnnt.main(_argv(
        "train", data_dir, "--output_dir", out, "--n_epochs", "2",
        "--steps_per_log", "1", "--eval_size", "1", "--config_override",
        "specaug_freq_masks=2", "specaug_time_masks=2",
        "specaug_time_width=6", "input_noise_stddev=0.1"))
    assert state.step == 4
    cfg = json.load(open(os.path.join(out, "config.json")))
    assert cfg["specaug_freq_masks"] == 2 and cfg["specaug_time_masks"] == 2
    with open(os.path.join(out, "tb", "metrics.jsonl")) as f:
        losses = [json.loads(line).get("train_loss") for line in f]
    assert np.isfinite([x for x in losses if x is not None]).all()


def _events(d):
    """(step, tag, plugin, value) of each scalar, and (tag, hparams) of each
    HParams plugin event (its start time left out)."""
    from google.protobuf.json_format import MessageToDict
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader
    from tensorboard.plugins.hparams import plugin_data_pb2

    files = glob.glob(os.path.join(d, "events.*"))
    assert len(files) == 1, files
    scalars, hparams = [], []
    for ev in EventFileLoader(files[0]).Load():
        for v in ev.summary.value:
            plugin = v.metadata.plugin_data.plugin_name
            if plugin == "hparams":
                data = plugin_data_pb2.HParamsPluginData.FromString(
                    v.metadata.plugin_data.content)
                hparams.append((v.tag, {
                    k: MessageToDict(val) for k, val in
                    data.session_start_info.hparams.items()}))
            else:
                scalars.append((ev.step, v.tag, plugin,
                                float(np.frombuffer(v.tensor.tensor_content,
                                                    np.float32)[0])
                                if v.tensor.tensor_content else
                                float(v.tensor.float_val[0])))
    return scalars, hparams


def test_tensorboard_writer_matches_jax(tmp_path):
    pytest.importorskip("tensorboard")
    written = {}
    for pkg, mod, cfg in (("jax", j_observe, tiny_config()),
                          ("port", observe, t_tiny_config())):
        w = mod.MetricsWriter(str(tmp_path / pkg), "r")
        w.hparams(cfg)
        w.scalars(1, {"train_loss": 2.5, "lr": 0.01})
        w.scalars(4, {"eval_loss": 1.25, "eval_wer": 0.5})
        w.close()
        written[pkg] = _events(str(tmp_path / pkg / "r"))
        with open(tmp_path / pkg / "r" / "metrics.jsonl") as f:
            recs = [json.loads(line) for line in f]
        assert [(r["step"], r.get("train_loss"), r.get("eval_wer"))
                for r in recs] == [(1, 2.5, None), (4, None, 0.5)]
    assert written["port"] == written["jax"]
    scalars, hparams = written["port"]
    assert [s[:3] for s in scalars] == [
        (1, "train_loss", "scalars"), (1, "lr", "scalars"),
        (4, "eval_loss", "scalars"), (4, "eval_wer", "scalars")]
    assert len(hparams) == 1
    assert hparams[0][1]["encoder_size"] == 64.0
    assert hparams[0][1]["token_type"] == "character"
