"""The Conformer's spans and counter on the CPU: under a profiler one train
step records `rnnt.conformer.subsample`, `.ffn`, `.mhsa` and `.conv`, each
with its `.bwd`, as host ranges; each backward span lies inside
`rnnt.train.backward`'s time and holds its module's backward operations;
`benchlib.spans.attribute` puts records launched there down to the `.bwd`
span; with no profiler nothing is entered, and the profiler changes no bit
of a bf16 step (an fp32 step's gradients are summed in another order);
the attention counter counts `plain` on the CPU."""

import os
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from benchlib import spans as spans_mod  # noqa: E402
from rnnt_tpu_torch.config import tiny_config  # noqa: E402
from rnnt_tpu_torch.models import conformer  # noqa: E402
from rnnt_tpu_torch.train import state as state_mod  # noqa: E402
from rnnt_tpu_torch.train.steps import make_train_step  # noqa: E402

torch.set_num_threads(1)

CFG = tiny_config(encoder_type="conformer", time_reduction_index=-1,
                  encoder_layers=2, conformer_dim=32, conformer_heads=4,
                  conformer_ffn_size=64, conformer_kernel_size=8,
                  optimizer="adam", learning_rate=0.0022)
MODULES = ("subsample", "ffn", "mhsa", "conv")
CALLS = {"subsample": 1, "ffn": 2 * CFG.encoder_layers,
         "mhsa": CFG.encoder_layers, "conv": CFG.encoder_layers}


def _batch(B=3, T=29, U=4):
    g = torch.Generator().manual_seed(5)
    labels = torch.randint(1, CFG.vocab_size, (B, U), generator=g)
    return {"mel_specs": torch.randn(B, T, CFG.input_feat_size, generator=g),
            "spec_lengths": torch.tensor([T, T - 5, T - 11]),
            "labels": labels, "label_lengths": torch.tensor([U, U - 1, 2]),
            "pred_inp": torch.cat([torch.zeros((B, 1), dtype=torch.long),
                                   labels], 1)}


def _step(profiled: bool, dtype=torch.float32):
    st = state_mod.create_train_state(CFG, dtype=dtype, device="cpu", seed=4)
    step = make_train_step(CFG, loss_impl="fused")
    batch = _batch()
    batch["mel_specs"] = batch["mel_specs"].to(dtype)
    if not profiled:
        return st, step(st, batch), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        metrics = step(st, batch)
    return st, metrics, prof


@pytest.fixture(scope="module")
def profiled():
    return _step(True)


def _ranges(prof, name):
    return [e for e in prof.events() if e.name == name]


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("bwd", [False, True])
def test_module_spans_recorded(profiled, module, bwd):
    _, _, prof = profiled
    name = f"rnnt.conformer.{module}" + (".bwd" if bwd else "")
    got = _ranges(prof, name)
    assert len(got) == CALLS[module], (name, len(got))
    assert not any(e.is_user_annotation for e in got)
    outer = _ranges(prof, "rnnt.train.backward" if bwd
                    else "rnnt.train.forward")
    (o,) = outer
    for e in got:
        assert o.time_range.start <= e.time_range.start
        assert e.time_range.end <= o.time_range.end


@pytest.mark.parametrize("module,op", [("subsample", "convolution_backward"),
                                       ("ffn", "aten::mm"),
                                       ("mhsa", "aten::bmm"),
                                       ("conv", "convolution_backward")])
def test_backward_span_holds_its_backward(profiled, module, op):
    _, _, prof = profiled
    for e in _ranges(prof, f"rnnt.conformer.{module}.bwd"):
        inside = [c.name for c in prof.events()
                  if c.thread == e.thread and c is not e
                  and e.time_range.start <= c.time_range.start
                  and c.time_range.end <= e.time_range.end]
        assert any(op in n for n in inside), (module, inside[:20])


def test_attribute_puts_backward_launches_in_the_bwd_spans(profiled):
    """A record launched during a module's backward (a stand-in launch call
    at each backward product's start, on its thread) is put down to the
    module's `.bwd` span by the benchmark's reader as it stands."""
    _, _, prof = profiled
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in events if e.name.startswith("rnnt.")]
    calls, device, want = [], [], []
    for module in ("ffn", "mhsa", "conv"):
        for e in _ranges(prof, f"rnnt.conformer.{module}.bwd"):
            ops = [c for c in events if c.thread == e.thread
                   and c.name in ("aten::mm", "aten::bmm")
                   and e.time_range.start < c.time_range.start
                   and c.time_range.end < e.time_range.end]
            for c in ops:
                i = len(calls)
                calls.append(SimpleNamespace(
                    id=10**9 + i, name="cudaLaunchKernel", thread=c.thread,
                    time_range=SimpleNamespace(start=c.time_range.start)))
                device.append(SimpleNamespace(id=10**9 + i))
                want.append(f"rnnt.conformer.{module}.bwd")
    assert len(set(want)) == 3
    got = spans_mod.attribute(device, calls, spans)
    assert got == want


def test_spans_change_no_bit_of_a_bf16_step():
    """In bf16, as the card trains, each module's LayerNorm casts its input
    once, so the identity at the module's input leaves every gradient's
    sum as it was.  (In fp32 the cast is the input itself, read by three
    operations whose gradients the identity sums before the residual's:
    the same gradients, summed in another order.)"""
    s1, m1, _ = _step(True, torch.bfloat16)
    s0, m0, _ = _step(False, torch.bfloat16)
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    p0, p1 = dict(s0.model.named_parameters()), dict(
        s1.model.named_parameters())
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n


def test_spans_keep_the_fp32_step(profiled):
    s1, m1, _ = profiled
    s0, m0, _ = _step(False)
    assert torch.equal(m0["loss"], m1["loss"])
    for k in m0:
        a, b = torch.as_tensor(m0[k]), torch.as_tensor(m1[k])
        assert torch.allclose(a, b, rtol=1e-6, atol=0), k


def test_no_range_entered_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a range was entered with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    _, metrics, _ = _step(False)
    assert torch.isfinite(metrics["loss"])


def test_attention_counter_counts_plain_on_the_cpu():
    before = dict(conformer.attention_launches_by_path)
    _step(False)
    after = conformer.attention_launches_by_path
    assert after["plain"] - before["plain"] == CFG.encoder_layers
    assert after["sdpa"] == before["sdpa"]
