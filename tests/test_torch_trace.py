"""The train step's phase spans (rnnt_tpu_torch.trace) on the CPU, at
`tiny_config` with the fused loss: with no profiler recording, `span` is one
shared null context and no range is ever entered; under `torch.profiler`
every span is recorded as a host range, the LSTM spans once per LSTM layer
and direction, nested step > forward > LSTM; the step's loss, gradients and
parameters are bit-identical with and without the profiler; the training
loop records its data wait; the exported streaming step holds no profiler
op."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rnnt_tpu_torch import export as ex
from rnnt_tpu_torch import trace
from rnnt_tpu_torch.config import tiny_config
from rnnt_tpu_torch.parallel import mesh as mesh_mod
from rnnt_tpu_torch.train import loop
from rnnt_tpu_torch.train import state as state_mod
from rnnt_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

CFG = tiny_config(learning_rate=0.02, grad_clip_norm=1.0,
                  input_noise_stddev=0.1, specaug_freq_masks=1,
                  specaug_time_masks=1)
LSTM_LAYERS = CFG.encoder_layers + CFG.pred_net_layers
STEP_SPANS = ("rnnt.train.step", "rnnt.train.forward", "rnnt.lstm",
              "rnnt.loss", "rnnt.train.backward", "rnnt.lstm.bwd",
              "rnnt.loss.bwd", "rnnt.train.norms", "rnnt.train.update")


def _batch(B=4, T=12, U=4, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, CFG.vocab_size, (B, U)).astype(np.int32)
    return {"mel_specs": rng.standard_normal(
                (B, T, CFG.input_feat_size)).astype(np.float32),
            "pred_inp": np.concatenate([np.zeros((B, 1), np.int32), labels],
                                       1),
            "labels": labels,
            "spec_lengths": np.array([T, T - 2, T, T // 2], np.int32)[:B],
            "label_lengths": np.array([U, U - 1, U, 2], np.int32)[:B]}


def _state():
    return state_mod.create_train_state(CFG, dtype=torch.float32,
                                        device="cpu", seed=3)


def _one_step(profiled: bool):
    """(state, metrics, profile or None) after one fused step."""
    state = _state()
    step = make_train_step(CFG, loss_impl="fused")
    batch = loop.to_device(_batch(), torch.device("cpu"))
    gen = torch.Generator().manual_seed(7)
    if not profiled:
        return state, step(state, batch, gen), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(state, batch, gen)
    return state, metrics, prof


@pytest.fixture(scope="module")
def profiled():
    return _one_step(True)


def _ranges(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_span_off_is_one_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert trace.span("rnnt.train.step") is trace.span("rnnt.lstm")
    _, metrics, _ = _one_step(False)  # every span of the step, off
    assert torch.isfinite(metrics["loss"])
    mesh_mod.all_reduce_sum_([torch.ones(2)], None)


@pytest.mark.parametrize("name", STEP_SPANS)
def test_step_span_recorded_as_a_host_range(profiled, name):
    _, _, prof = profiled
    spans = _ranges(prof, name)
    want = LSTM_LAYERS if name.startswith("rnnt.lstm") else 1
    assert len(spans) == want, (name, len(spans))
    # a host range, not a user annotation: the profiler gives a user
    # annotation that launches kernels a device record of its own
    assert not any(e.is_user_annotation for e in spans)


@pytest.mark.parametrize("inner,outer", [
    ("rnnt.train.forward", "rnnt.train.step"),
    ("rnnt.lstm", "rnnt.train.forward"),
    ("rnnt.loss", "rnnt.train.forward"),
    ("rnnt.train.backward", "rnnt.train.step"),
    ("rnnt.lstm.bwd", "rnnt.train.backward"),
    ("rnnt.loss.bwd", "rnnt.train.backward"),
    ("rnnt.train.norms", "rnnt.train.step"),
    ("rnnt.train.update", "rnnt.train.step")])
def test_spans_nest(profiled, inner, outer):
    _, _, prof = profiled
    (o,) = _ranges(prof, outer)
    for e in _ranges(prof, inner):
        assert o.time_range.start <= e.time_range.start
        assert e.time_range.end <= o.time_range.end


def test_lstm_span_holds_the_input_projection(profiled):
    _, _, prof = profiled
    for e in _ranges(prof, "rnnt.lstm"):
        inside = [c.name for c in prof.events()
                  if c.thread == e.thread and c.name.startswith("aten::")
                  and e.time_range.start <= c.time_range.start
                  and c.time_range.end <= e.time_range.end]
        assert {"aten::mm", "aten::matmul"} & set(inside), inside


def test_profiler_changes_no_bit_of_the_step(profiled):
    s1, m1, _ = profiled
    s0, m0, _ = _one_step(False)
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    p0, p1 = dict(s0.model.named_parameters()), dict(
        s1.model.named_parameters())
    for n in state_mod.trainable_names(s0.model):
        assert torch.equal(p0[n], p1[n]), n
        # after one SGD step from a zero trace the trace is the gradient
        assert torch.equal(s0.opt_state["trace"][n],
                           s1.opt_state["trace"][n]), n


def test_loop_records_data_wait_and_all_reduce_records(tmp_path):
    state = _state()
    batches = [_batch(seed=s) for s in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.run_training(CFG, state, lambda: iter(batches),
                          output_dir=str(tmp_path), steps_per_log=1)
        mesh_mod.all_reduce_sum_([torch.ones(2)], None)
    assert state.step == 2
    # two batches fetched and the exhausted iterator's last look
    assert len(_ranges(prof, "rnnt.train.data")) == 3
    assert len(_ranges(prof, "rnnt.train.step")) == 2
    assert len(_ranges(prof, "rnnt.parallel.all_reduce")) == 1


def test_exported_streaming_step_holds_no_profiler_op():
    model = _state().model
    program, _ = ex.export_streaming_step(model, CFG, chunk_frames=2,
                                          max_tokens_per_chunk=4,
                                          device="cpu")
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets
    assert not [t for t in targets if "profiler" in t or "record" in t]
