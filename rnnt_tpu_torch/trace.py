"""Named host spans of the train step, on the profiler's clock.

`span(name)` opens a range named `name` while a `torch.profiler` session
records on the calling thread, and is one shared null context otherwise:
no flag and no environment variable, so the spans are on exactly in a
profiled slice (`run_rnnt --profile_dir`, a benchmark's traced steps).

The range is a plain function-scope `RecordFunction`
(`torch._C._profiler._RecordFunctionFast`), not a user annotation
(`torch.profiler.record_function`): the profiler turns a user annotation
that launches kernels into a device record of its own, which a reader of
device time would count as work, while a function-scope range stays a
host event.  The autograd engine's threads inherit the profiler's state,
so the backward's spans are recorded on the thread that runs them.

Span names start with `rnnt.`; each sits where its work is launched:
`rnnt.train.step` (`train.steps.make_train_step`'s step),
`rnnt.train.forward`, `rnnt.train.backward`, `rnnt.train.norms`,
`rnnt.train.update`, `rnnt.train.data` (`train.loop.run_training`),
`rnnt.lstm` and `rnnt.lstm.bwd` (`ops.lstm_cuda`'s training LSTM),
`rnnt.loss` and `rnnt.loss.bwd` (the fused and banded losses),
`rnnt.parallel.all_reduce` (`parallel.mesh.all_reduce_sum_`),
`rnnt.conformer.subsample`, `.ffn`, `.mhsa` and `.conv` (the Conformer
encoder's modules, `models.conformer`) and each with `.bwd`.  The
inference and export paths hold none.

A module's backward runs on the autograd engine's thread, outside any
function of the module: `module_span(name, fn, x, *args)` runs fn in
`span(name)` and, while recording, passes fn's first input and its output
through identity functions whose backward opens `span(name + ".bwd")` (at
the output, where the module's backward starts) and closes it (at the
input, where it ends), so the module's backward launches run inside it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the host range `name` while the profiler records
    on this thread, else the shared null context."""
    if torch._C._autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs in `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class _Held:
    """The backward span of one module call, open between its two ends."""

    def __init__(self, name: str):
        self.name, self.open = name, None


class _OpenBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, held, x):
        ctx.held = held
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf = span(ctx.held.name)
        if rf is not _OFF:
            rf.__enter__()
            ctx.held.open = rf
        return None, g


class _CloseBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, held, x):
        ctx.held = held
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        rf, ctx.held.open = ctx.held.open, None
        if rf is not None:
            rf.__exit__(None, None, None)
        return None, g


def module_span(name: str, fn, x: torch.Tensor, *args, **kwargs):
    """fn(x, *args, **kwargs) in span(name), its backward in
    span(name + ".bwd") (module docstring).  `x` is the tensor whose
    gradient the module's backward computes last: its input, or where the
    input needs none, the weight of its first operation (fn then receives
    it in that place)."""
    if not torch._C._autograd._profiler_enabled():
        return fn(x, *args, **kwargs)
    held = _Held(name + ".bwd")
    if x.requires_grad:
        x = _CloseBackward.apply(held, x)
    with span(name):
        y = fn(x, *args, **kwargs)
    if x.requires_grad and y.requires_grad:
        y = _OpenBackward.apply(held, y)
    return y
