"""A profiled slice of a run: device busy time and wall on one clock.

The spin-marker method of the program's chip smoke test, copied: the
profiler has lost the first records of a session, so each session opens
with OPENERS longer spins (`torch.cuda._sleep`), 10 ms apart; then a short
marker spin goes on the stream, the slice runs, and a second marker
follows it.  The wall is the time from the end of the first marker's
device record to the start of the second's; busy is the union of the
device records between them.  Both come from the profiler's one clock.  A
slice is accepted when an opener and both markers were recorded, and is
repeated otherwise (at most `attempts` times).

The profiler records the kernels of the thread that opened the session,
so the profiled work runs on that thread.

The result also keeps every device record of the slice (name, start and
end in microseconds) and, for the breakdown, the longest idle gaps named
by the innermost host operation running at their middle.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel; no program code runs it
MARKER_CYCLES, OPENER_CYCLES = 1000, 400_000  # ~0.5 us and ~200 us spins
OPENERS = 64


def union_us(spans) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(device: List[tuple], host: List[tuple], lo: float, hi: float,
              top: int = 10) -> List[list]:
    """[[what the host ran, seconds], ...]: idle time between device
    records in [lo, hi], summed by the innermost host operation that spans
    each gap's middle, the `top` largest."""
    spans = sorted((s, e) for _, s, e in device)
    gaps, cur = [], lo
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_name: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "no host operation recorded"
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


def top_ops(device: List[tuple], top: int = 10) -> List[list]:
    by_name: Dict[str, float] = {}
    for n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:top]]


class Session:
    """A profiler session opened by start() and closed by stop(), both
    called on the thread that launches the profiled work (the profiler
    records the launching thread's kernels)."""

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(OPENERS):
            torch.cuda._sleep(OPENER_CYCLES)
            torch.cuda.synchronize()
            time.sleep(0.01)
        torch.cuda._sleep(MARKER_CYCLES)

    def stop(self):
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        time.sleep(0.01)
        self.prof.__exit__(None, None, None)
        return self.prof


def record(run: Callable[[], None]):
    """The profiler session of run() between two markers (not yet read)."""
    session = Session()
    session.start()
    run()
    return session.stop()


def digest(prof) -> Optional[dict]:
    """{"busy_s", "wall_s", "device": [(name, start_us, end_us)],
    "breakdown"} of a recorded session, or None when it lacks an opener
    or either marker."""
    from torch.autograd import DeviceType

    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    spins = sorted((e for e in device if MARKER in e.name),
                   key=lambda e: e.time_range.start)
    markers = [e for e in spins if e.time_range.end - e.time_range.start < 50]
    if len(spins) == len(markers) or len(markers) != 2:
        return None
    lo, hi = markers[0].time_range.end, markers[1].time_range.start
    inside = [(e.name, e.time_range.start, e.time_range.end) for e in device
              if MARKER not in e.name and e.time_range.start >= lo
              and e.time_range.end <= hi]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU
            and e.time_range.end >= lo and e.time_range.start <= hi]
    return {"busy_s": union_us((s, e) for _, s, e in inside) / 1e6,
            "wall_s": (hi - lo) / 1e6, "device": inside,
            "breakdown": {"device_ops": top_ops(inside),
                          "idle_gaps": idle_gaps(inside, host, lo, hi)}}


def profile_slice(run: Callable[[], None], attempts: int = 2
                  ) -> Optional[dict]:
    """Record and read run()'s slice, again while it lacks its markers."""
    for _ in range(attempts):
        out = digest(record(run))
        if out is not None:
            return out
    return None


def kernel_seconds(device: List[tuple], patterns) -> float:
    """Seconds of device records whose name holds any of `patterns`."""
    return sum(e - s for n, s, e in device
               if any(p in n for p in patterns)) / 1e6
