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
`rnnt.parallel.all_reduce` (`parallel.mesh.all_reduce_sum_`).  The
inference and export paths hold none.
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
