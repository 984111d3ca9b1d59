"""The traced run: a profiler over a steady stretch of whole units (scenes or steps)
inside the window, reduced in memory from the profiler's raw events.

Each device kernel is attributed to the host span (``record_function``) that was open
when the operator that launched it began: the ``fusg.*`` spans of the port's scene
runner and the ``bench.*`` spans the entries put around their calls. The device's
busy time is the union of its kernels' intervals; each idle gap between them is
labelled by the innermost span the host was in when it began, and the breakdown sums
the idle time by label (the PnP loop leaves thousands of gaps of a few microseconds).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

SPAN_PREFIXES = ("fusg.", "bench.")


@dataclasses.dataclass
class Kernel:
    name: str
    start_ns: int
    end_ns: int
    span: Optional[str]  # innermost fusg.* / bench.* span open at the launch
    spans: Tuple[str, ...]  # every such span open at the launch, outermost first


@dataclasses.dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Trace:
    kernels: List[Kernel]
    spans: List[Span]
    units: int  # whole scenes or steps dispatched while the profiler ran
    window_s: float  # first event's start to last event's end
    busy_s: float  # union of device kernel intervals
    idle_gaps: List[Tuple[str, float]]  # (host span at the gap's start, seconds)

    def under(self, *names: str) -> List[Kernel]:
        """Kernels launched inside any span named in ``names``."""
        return [k for k in self.kernels if any(n in k.spans for n in names)]

    def span_ms(self, name: str) -> float:
        """Summed host duration of the spans named ``name``, in ms."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end_ns - k.start_ns) / 1e9
        idle: Dict[str, float] = {}
        for label, s in self.idle_gaps:
            idle[label] = idle.get(label, 0.0) + s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _is_kernel(event) -> bool:
    """A device operation: not the device-side copy of a host span (the profiler
    mirrors each ``record_function`` onto the device's timeline), not a copy or a
    memset."""
    from torch.autograd import DeviceType

    if event.device_type() != DeviceType.CUDA or event.is_user_annotation():
        return False
    return not event.name().startswith(SPAN_PREFIXES + ("Memcpy", "Memset"))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, units: int) -> Trace:
    """A :class:`Trace` from the profiler's raw events (``kineto_results.events()``).
    The traced window runs from the first event's start to the last event's end, on
    the trace's own clock (the profiler's stop follows a device synchronize)."""
    from torch.autograd import DeviceType

    spans, ops, kernels = [], {}, []
    lo, hi = None, None
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        lo = s if lo is None else min(lo, s)
        hi = s + d if hi is None else max(hi, s + d)
        if e.device_type() == DeviceType.CPU:
            name = e.name()
            if name.startswith(SPAN_PREFIXES):
                spans.append(Span(name, e.start_ns(), e.start_ns() + e.duration_ns()))
            ops[e.correlation_id()] = e.start_ns()
        elif _is_kernel(e):
            kernels.append(e)
    spans.sort(key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]

    def open_at(t):
        i = bisect.bisect_right(starts, t)
        return [s for s in spans[:i] if s.end_ns >= t]

    out = []
    for e in kernels:
        launch = ops.get(e.linked_correlation_id())
        names = tuple(s.name for s in open_at(launch)) if launch is not None else ()
        out.append(Kernel(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                          names[-1] if names else None, names))
    busy = _union([(k.start_ns, k.end_ns) for k in out])
    busy_ns = sum(e - s for s, e in busy)
    gaps = []
    lo, hi = lo or 0, hi or 0
    prev = lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            host = open_at(prev)
            gaps.append((host[-1].name if host else "outside spans", (s - prev) / 1e9))
        prev = max(prev, e)
    return Trace(out, spans, units, (hi - lo) / 1e9, busy_ns / 1e9, gaps)


class Tracer:
    """Profiles units [first, first + count) of a window: the entry calls
    :meth:`unit` before each unit it starts and :meth:`close` when the window ends.
    With ``count`` 0 it does nothing."""

    def __init__(self, first: int, count: int):
        self.first, self.count = first, count
        self.prof = None
        self.trace: Optional[Trace] = None

    def unit(self, i: int) -> None:
        if not self.count:
            return
        if i == self.first:
            self._start()
        elif i == self.first + self.count and self.prof is not None:
            self._stop(self.count)

    def close(self, done: int) -> None:
        """End of the window after ``done`` units were started."""
        if self.prof is not None:
            self._stop(done - self.first)

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def _stop(self, units: int) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.trace = reduce(self.prof.profiler.kineto_results.events(), units)
        self.prof = None
