"""The program's phase spans in a profiled slice: each device record put
down to the innermost `rnnt.` span it was launched in.

The program (`rnnt_tpu_torch.trace`) opens host ranges named `rnnt.*`
while a profiler records.  A device record shares its correlation id with
the runtime or driver call that launched it (`cudaLaunchKernel`, also for
the kernels the program launches through ctypes), which the profiler puts
on the thread of the operation open around it.  The record belongs to the
innermost span open on that call's thread at the call's start; where that
thread has none open, to the innermost span open at that instant on any
thread: the autograd engine's thread launches the backward while the
calling thread sits in `rnnt.train.backward`.

`digest(prof)` returns `profile.digest`'s keys, read the same way, with
three differences: device records that are user annotations (the profiler
gives a `record_function` range that launches kernels one on the device's
timeline) are left out of `device`, `busy_s` and the breakdown; the idle
gaps are named "<innermost span open at the gap's middle> > <innermost host
operation>"; and two keys are added, `device_span` (parallel to `device`:
the span name, or None) and `spans` ([(name, start_us, end_us, thread)]).
With no `rnnt.` span and no annotation record in the session its result is
`profile.digest`'s, value for value.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from benchlib.profile import MARKER, top_ops, union_us

PREFIX = "rnnt."
NO_HOST_OP = "no host operation recorded"
# the per-layer groups: device ms a step of the records in these spans;
# "other" is every record in none of them (no span at all included)
GROUPS = {"lstm": ("rnnt.lstm", "rnnt.lstm.bwd"),
          "loss": ("rnnt.loss", "rnnt.loss.bwd"),
          "optimizer": ("rnnt.train.norms", "rnnt.train.update")}


class _Open:
    """The innermost span open at an instant, by thread or on any thread
    (spans nest on each thread, so the innermost is the latest started of
    those that cover the instant)."""

    def __init__(self, spans: List[tuple]):
        self.all = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.all]
        self.by_thread: Dict[int, List[tuple]] = {}
        for s in self.all:
            self.by_thread.setdefault(s[3], []).append(s)
        self.thread_starts = {t: [s[1] for s in v]
                              for t, v in self.by_thread.items()}

    @staticmethod
    def _innermost(spans, starts, t) -> Optional[str]:
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[j][2] >= t:
                return spans[j][0]
        return None

    def at(self, t: float, thread=None) -> Optional[str]:
        if thread in self.by_thread:
            name = self._innermost(self.by_thread[thread],
                                   self.thread_starts[thread], t)
            if name is not None:
                return name
        return self._innermost(self.all, self.starts, t)


def is_launch_call(name: str) -> bool:
    """A runtime or driver call (cudaLaunchKernel, cuLaunchKernelEx,
    cudaMemcpyAsync, ...), whose correlation id its device record shares;
    the program's operations are named `ns::op` or `rnnt.*`."""
    return name.startswith("cu") and "::" not in name


def attribute(device_events, cpu_events, spans: List[tuple]) -> List:
    """The innermost span each device event was launched in (or None)."""
    if not spans:
        return [None] * len(device_events)
    calls = {e.id: e for e in cpu_events if is_launch_call(e.name)}
    where = _Open(spans)
    out = []
    for d in device_events:
        call = calls.get(d.id)
        out.append(None if call is None
                   else where.at(call.time_range.start, call.thread))
    return out


def idle_gaps(device: List[tuple], host: List[tuple], spans: List[tuple],
              lo: float, hi: float, top: int = 10) -> List[list]:
    """`profile.idle_gaps` with each gap's name led by the innermost span
    open at its middle (on any thread); the host operations are the
    session's host events that are not spans."""
    gaps, cur = [], lo
    for s, e in sorted((s, e) for _, s, e in device):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    where = _Open(spans)
    by_name: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = None
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        span = where.at(mid)
        if span is not None:
            name = span if name is None else f"{span} > {name}"
        name = name or NO_HOST_OP
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def digest(prof) -> Optional[dict]:
    """`profile.digest(prof)` with the program's spans (module docstring),
    or None when the slice lacks an opener or either marker."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    spins = sorted((e for e in device if MARKER in e.name),
                   key=lambda e: e.time_range.start)
    markers = [e for e in spins if e.time_range.end - e.time_range.start < 50]
    if len(spins) == len(markers) or len(markers) != 2:
        return None
    lo, hi = markers[0].time_range.end, markers[1].time_range.start
    kept = [e for e in device if MARKER not in e.name
            and e.time_range.start >= lo and e.time_range.end <= hi]
    inside = [(e.name, e.time_range.start, e.time_range.end) for e in kept]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread)
             for e in cpu if e.name.startswith(PREFIX)]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in cpu
            if not e.name.startswith(PREFIX)
            and e.time_range.end >= lo and e.time_range.start <= hi]
    return {"busy_s": union_us((s, e) for _, s, e in inside) / 1e6,
            "wall_s": (hi - lo) / 1e6, "device": inside,
            "breakdown": {"device_ops": top_ops(inside),
                          "idle_gaps": idle_gaps(inside, host, spans, lo,
                                                 hi)},
            "device_span": attribute(kept, cpu, spans),
            "spans": [s for s in spans if s[2] >= lo and s[1] <= hi]}


def group_ms_per_step(profile: Optional[dict], steps: int
                      ) -> Optional[Dict[str, float]]:
    """Device ms a step of each group of GROUPS and of "other" (they add up
    to every record's), and of "no_span" (records launched in no span, a
    part of "other"); None without `device_span`."""
    if not profile or "device_span" not in profile:
        return None
    owner = {s: g for g, names in GROUPS.items() for s in names}
    out = {g: 0.0 for g in (*GROUPS, "other", "no_span")}
    for (_, s, e), span in zip(profile["device"], profile["device_span"]):
        out[owner.get(span, "other")] += e - s
        if span is None:
            out["no_span"] += e - s
    return {g: us / 1e3 / steps for g, us in out.items()}
