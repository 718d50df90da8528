"""The port's Conformer-Transducer (`encoder_type="conformer"`) on the CPU,
held to the benchmark's plain fp32 reference
(`benchmark/reference/conformer_transducer.py`) at a tiny size with seeded
weights (`benchmark/benchlib/conformer_weights.py`): the encoder output,
the fused loss, every parameter's gradient, one Adam step, the BatchNorm
statistics threaded back after a step, and uneven lengths (each utterance
alone through the reference against its rows of the padded batch).  An
LSTM `config.json` still loads into the same model and names; the paths
that need the LSTM encoder refuse the Conformer, naming `encoder_type`.  A
toy encoder put in `models.encoder.ENCODERS` trains through the unchanged
`Transducer` and train step: the encoder contract is the only seam."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from benchlib.conformer_weights import make_weights  # noqa: E402
from reference import conformer_transducer as ref  # noqa: E402
from rnnt_tpu_torch.config import RNNTConfig, tiny_config  # noqa: E402
from rnnt_tpu_torch.models import conformer, encoder  # noqa: E402
from rnnt_tpu_torch.models import lstm as L  # noqa: E402
from rnnt_tpu_torch.ops.matmul import dense  # noqa: E402
from rnnt_tpu_torch.models.transducer import Transducer  # noqa: E402
from rnnt_tpu_torch.train import state as state_mod  # noqa: E402
from rnnt_tpu_torch.train.steps import (batch_loss,  # noqa: E402
                                        make_train_step)

torch.set_num_threads(1)

CFG = tiny_config(encoder_type="conformer", time_reduction_index=-1,
                  encoder_layers=2, conformer_dim=32, conformer_heads=4,
                  conformer_ffn_size=64, conformer_kernel_size=8,
                  optimizer="adam", learning_rate=0.0022)
M = dataclasses.asdict(CFG)
SEED = 2**31 + 2207
LENS = (37, 30, 21)
LABEL_LENS = (5, 3, 4)
# every leaf of the tiny model, by module
GROUPS = ("encoder.subsample.", "ffn1.", "ffn2.", "mhsa.", "conv.", ".ln.",
          "prediction.", "joint.")


def _weights():
    return make_weights(M, SEED, "cpu", torch.float32)


def _model(w=None):
    model = Transducer(CFG)
    model.load_state_dict(w if w is not None else _weights())
    return model.make_trainable_()


def _batch(B=3, T=37, U=5):
    g = torch.Generator().manual_seed(11)
    labels = torch.randint(1, CFG.vocab_size, (B, U), generator=g)
    return {"mel_specs": torch.randn(B, T, CFG.input_feat_size, generator=g),
            "spec_lengths": torch.tensor(LENS[:B]),
            "labels": labels,
            "label_lengths": torch.tensor(LABEL_LENS[:B]),
            "pred_inp": torch.cat([torch.zeros((B, 1), dtype=torch.long),
                                   labels], 1)}


def _close(got, want, rel, what=""):
    scale = float(want.abs().max()) or 1.0
    err = float((got - want).abs().max()) / scale
    assert err <= rel, (what, err)


def test_rel_shift_is_the_distance_index():
    T, W = 7, 13
    x = torch.randn(2, 3, T, W)
    got = conformer.rel_shift(x)
    i = torch.arange(T)[:, None]
    j = torch.arange(T)[None, :]
    np.testing.assert_array_equal(got.numpy(),
                                  x[..., i, T - 1 - i + j].numpy())


def test_relative_table_is_the_reference_table():
    T, D = 9, 32
    got = conformer.relative_table(T, D, "cpu", torch.float32)
    want = ref.distance_table(T, D, "cpu").flip(0)  # row k: distance T-1-k
    _close(got, want, 1e-6)


@pytest.mark.parametrize("lengths", [None, LENS])
def test_encoder_matches_reference(lengths):
    w = _weights()
    model = _model(w)
    b = _batch()
    lens = torch.tensor(lengths) if lengths else torch.full((3,), 37)
    with torch.no_grad():
        got, _ = model.encode(b["mel_specs"], lengths=lens)
    want = ref.forward_encoder(w, b["mel_specs"], lens, M)
    t = conformer.subsampled_length(lens)
    for r in range(3):
        _close(got[r, : t[r]], want[r, : t[r]], 1e-5, r)


@pytest.mark.parametrize("row", range(3))
def test_uneven_lengths_match_each_utterance_alone(row):
    w = _weights()
    model = _model(w)
    b = _batch()
    lens = torch.tensor(LENS)
    with torch.no_grad():
        got, _ = model.encode(b["mel_specs"], lengths=lens)
    n = LENS[row]
    alone = ref.forward_encoder(w, b["mel_specs"][row: row + 1, :n],
                                lens[row: row + 1], M)
    assert alone.shape[1] == int(conformer.subsampled_length(lens)[row])
    _close(got[row, : alone.shape[1]], alone[0], 1e-5)


@pytest.fixture(scope="module")
def grads():
    """(port loss, port grads, port stats, ref loss, ref grads, ref stats)
    of one training forward and backward at uneven lengths."""
    w = _weights()
    model = _model(w)
    b = _batch()
    loss, (_, stats) = batch_loss(model, CFG, b, training=True,
                                  loss_impl="fused")
    loss.backward()
    got = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters() if p.requires_grad}
    r_loss, r_grads, r_stats = ref.loss_and_grads(w, b, M)
    return float(loss), got, stats, r_loss, r_grads, r_stats


def test_fused_loss_matches_reference(grads):
    loss, _, _, r_loss, _, _ = grads
    assert abs(loss - r_loss) <= 1e-4 * abs(r_loss), (loss, r_loss)


@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_reference(grads, group):
    _, got, _, _, want, _ = grads
    names = [n for n in want if group in n]
    assert names
    assert set(want) == set(got)
    # each leaf against its own norm; the key bias and the depthwise bias
    # (before BatchNorm) have a zero gradient but for rounding, which is
    # held to a hundred-thousandth of the median leaf's norm
    moved = ref.moved_leaves(ref.leaf_norms(want))
    median = float(np.median([float(g.norm()) for g in want.values()]))
    for n in names:
        err = float((got[n] - want[n]).norm())
        bound = float(want[n].norm()) * 1e-4 if n in moved else 1e-5 * median
        assert err <= bound, (n, err)


def test_batchnorm_statistics_match_reference(grads):
    _, _, stats, _, _, r_stats = grads
    assert set(stats) == set(r_stats) == {
        f"encoder.blocks.{i}.conv.bn.{s}" for i in range(2)
        for s in ("mean", "var")}
    for n in stats:
        _close(stats[n], r_stats[n], 1e-5, n)


@pytest.fixture(scope="module")
def adam_step():
    """The port after one train step, and the reference after one Adam
    step from the same weights and batch."""
    w = _weights()
    model = _model(w)
    st = state_mod.TrainState(step=0, model=model,
                              opt_state=state_mod.Optimizer(CFG).init(model))
    make_train_step(CFG, loss_impl="fused")(st, _batch())
    want = ref.train_reference(w, [_batch()], M, steps=1)
    return w, dict(model.named_parameters()), want


def test_one_adam_step_matches_reference(adam_step, grads):
    w, got, want = adam_step
    r_grads = grads[4]  # the reference's gradient at the same weights
    moved = ref.moved_leaves(want["grad_norms"])
    lr = CFG.learning_rate
    for n in moved:
        change = got[n].detach() - w[n]
        # a first Adam step moves each element by lr g / (|g| + eps): the
        # elements whose gradient is near rounding may move either way, so
        # the elements compared are those above a thousandth of the leaf's
        # root mean square gradient (the embedding's rows of absent tokens
        # and Wpos's rows of the sinusoids that are near constant over a
        # short T' learn nothing)
        g = r_grads[n]
        big = g.abs() >= 1e-3 * g.square().mean().sqrt()
        assert bool(big.any()), n
        want_change = -lr * g / (g.abs() + ref.ADAM_EPS)
        _close(change[big], want_change[big], 1e-4, n)
        assert abs(float(change.norm()) - want["change_norms"][n]) <= (
            0.01 * want["change_norms"][n]), n


def test_step_threads_every_batchnorm_back(adam_step):
    w, got, want = adam_step
    assert len(want["stats"]) == 4
    for n, t in want["stats"].items():
        assert got[n].dtype == torch.float32 and not got[n].requires_grad
        assert not torch.equal(got[n].detach(), w[n]), n  # moved by the step
        _close(got[n].detach(), t, 1e-5, n)


def test_counter_counts_plain_attention_on_the_cpu():
    before = dict(conformer.attention_launches_by_path)
    with torch.no_grad():
        _model().encode(_batch()["mel_specs"])
    assert conformer.attention_launches_by_path["plain"] == \
        before["plain"] + CFG.encoder_layers
    assert conformer.attention_launches_by_path["sdpa"] == before["sdpa"]


class _ToyEncoder(torch.nn.Module):
    """One Dense [feat, P], no BatchNorm, every frame kept: the encoder
    contract and nothing more."""

    def __init__(self, cfg):
        super().__init__()
        self.w = L.frozen_param((cfg.input_feat_size, cfg.projection_size))

    def reset_(self, rng):
        L.glorot_(self.w, rng)

    def encode(self, mel, lengths=None, state=None):
        return dense(mel.to(self.w.dtype), self.w), None

    def encode_train(self, mel, lengths=None, generator=None, mesh=None):
        return self.encode(mel)[0], {}

    def running_stats(self):
        return {}

    @staticmethod
    def encoded_length(cfg, spec_lengths):
        return spec_lengths


def test_a_new_encoder_trains_through_the_encoder_table(monkeypatch):
    monkeypatch.setitem(encoder.ENCODERS, "lstm", _ToyEncoder)
    cfg = tiny_config()
    st = state_mod.create_train_state(cfg, torch.float32, "cpu", seed=3)
    assert isinstance(st.model.encoder, _ToyEncoder)
    before = st.model.encoder.w.detach().clone()
    metrics = make_train_step(cfg, loss_impl="fused")(st, _batch())
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(st.model.encoder.w.detach(), before)


LSTM_NAMES = (["encoder.bn.bias", "encoder.bn.mean", "encoder.bn.scale",
               "encoder.bn.var"]
              + [f"encoder.layers.{i}.{p}" for i in range(2)
                 for p in ("lstm.wx", "lstm.wh", "lstm.bias", "lstm.wp",
                           "ln.scale", "ln.bias")]
              + ["prediction.embed"]
              + [f"prediction.layers.0.{p}" for p in (
                  "lstm.wx", "lstm.wh", "lstm.bias", "lstm.wp", "ln.scale",
                  "ln.bias")]
              + ["joint.w1", "joint.b1", "joint.w2", "joint.b2"])


def test_lstm_config_json_loads_the_same_model(tmp_path):
    # a config.json written before encoder_type existed
    raw = dataclasses.asdict(tiny_config())
    for k in ("encoder_type", "conformer_dim", "conformer_heads",
              "conformer_ffn_size", "conformer_kernel_size"):
        raw.pop(k)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(raw, f)
    cfg = RNNTConfig.load(str(tmp_path))
    assert cfg == tiny_config() and cfg.encoder_type == "lstm"
    model = Transducer(cfg)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(
        LSTM_NAMES)
    assert tuple(model.joint.w1.shape) == (cfg.projection_size,
                                          cfg.joint_size)
    assert state_mod.trainable_names(model) == sorted(
        (n for n in LSTM_NAMES if n not in ("encoder.bn.mean",
                                            "encoder.bn.var")),
        key=lambda n: tuple(int(p) if p.isdigit() else p
                            for p in n.split(".")))
    # and a Conformer's config.json round-trips
    CFG.save(str(tmp_path / "cf"))
    assert RNNTConfig.load(str(tmp_path / "cf")) == CFG


@pytest.mark.parametrize("bad", [dict(time_reduction_index=1),
                                 dict(conformer_heads=5),
                                 dict(encoder_type="transformer")])
def test_config_refuses_what_it_cannot_build(bad):
    with pytest.raises(ValueError):
        CFG.replace(**bad)


def _refusal(what):
    from rnnt_tpu_torch import export
    from rnnt_tpu_torch.decode import beam, streaming
    from rnnt_tpu_torch.ops import beam_cuda, quantize

    model = _model().eval()
    mel = _batch()["mel_specs"]
    if what == "streaming":
        streaming.StreamingTranscriber(model, tokenizer=None)
    elif what == "encoder_state":
        model.encoder_zero_state(1)
    elif what == "beam":
        beam.beam_search_decode(model, mel)
    elif what == "beam_kernel":
        enc, _ = model.encode(mel)
        beam_cuda.beam_search(model, enc, torch.tensor([10, 8, 6]),
                              beam_width=2, max_output_length=4,
                              expansions_per_frame=2)
    elif what == "int8":
        quantize.apply_quantized_(model, quantize.quantize_params(
            dict(model.named_parameters())))
    elif what == "export_transcribe":
        export.export_transcribe(model, CFG, device="cpu", frames=16)
    elif what == "export_streaming":
        export.export_streaming_step(model, CFG, device="cpu")


@pytest.mark.parametrize("what", ["streaming", "encoder_state", "beam",
                                  "beam_kernel", "int8",
                                  "export_transcribe", "export_streaming"])
def test_paths_that_need_the_lstm_encoder_refuse(what):
    with pytest.raises(NotImplementedError, match="encoder_type"):
        _refusal(what)


def test_greedy_decoding_reads_each_length():
    from rnnt_tpu_torch.decode.greedy import greedy_decode

    model = _model().eval()
    b = _batch()
    with torch.no_grad():
        tokens, lengths = greedy_decode(model, b["mel_specs"],
                                        b["spec_lengths"],
                                        max_output_length=20)
        for r in range(3):
            n = LENS[r]
            t1, l1 = greedy_decode(model, b["mel_specs"][r: r + 1, :n],
                                   b["spec_lengths"][r: r + 1],
                                   max_output_length=20)
            assert int(l1[0]) == int(lengths[r])
            assert torch.equal(t1[0, : int(l1[0])],
                               tokens[r, : int(lengths[r])])


CONFORMER_OVERRIDES = ["encoder_type=conformer", "time_reduction_index=-1",
                       "encoder_layers=2", "conformer_dim=32",
                       "conformer_heads=4", "conformer_ffn_size=64",
                       "conformer_kernel_size=8", "optimizer=adam",
                       "learning_rate=0.0022"]


def test_run_rnnt_trains_evaluates_and_resumes(tmp_path, capsys):
    """The normal path: `cli.run_rnnt --mode train` for two steps, then
    `--mode eval` with greedy WER, then a resume from the checkpoint."""
    from rnnt_tpu_torch.cli import run_rnnt
    from rnnt_tpu_torch.data import records
    from rnnt_tpu_torch.train import checkpoint as ckpt

    cfg = tiny_config()
    data = tmp_path / "data"
    cfg.save(str(data))
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
        records.write_shards(examples(n),
                             str(data / f"{split}-{{shard:05d}}.rnr"), 2)
    out = str(tmp_path / "run")
    common = ["--data_dir", str(data), "--output_dir", out, "--batch_size",
              "4", "--no-bf16", "--device", "cpu", "--pad_frames", "64",
              "--pad_tokens", "8"]
    run_rnnt.main(["--mode", "train", *common, "--n_epochs", "1",
                   "--steps_per_log", "1", "--steps_per_checkpoint", "2",
                   "--eval_size", "1", "--config_override",
                   *CONFORMER_OVERRIDES])
    assert ckpt.list_checkpoint_steps(out) == [2]
    saved = json.load(open(os.path.join(out, "config.json")))
    assert saved["encoder_type"] == "conformer"
    with open(os.path.join(out, "tb", "metrics.jsonl")) as f:
        losses = [json.loads(line)["train_loss"] for line in f
                  if "train_loss" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    capsys.readouterr()
    metrics = run_rnnt.main(["--mode", "eval", *common, "--checkpoint", out])
    assert "eval_wer=" in capsys.readouterr().out
    assert np.isfinite(metrics["eval_loss"])
    assert 0 <= metrics["eval_wer"]
    state = run_rnnt.main(["--mode", "train", *common, "--checkpoint",
                           "auto", "--n_epochs", "1"])
    assert state.step == 4
    assert state.model.cfg.encoder_type == "conformer"
    assert "mu" in state.opt_state
