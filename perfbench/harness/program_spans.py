"""The port's own span record (``utils/profiling.spans``), read outside the traced
stretch.

The profiler slows the host while it runs, so a host time read from the profiled
stretch is inflated. The port records every span it opens, profiler or not, on the
clock the profiler stamps its events with; the readers here take the spans of the
whole run that do not overlap the stretch (earliest to latest event of ``run.trace``)
and use the median duration by name, which leaves the cold set-up scene or step out.
A port that keeps no record (before it had one) gives None, and so does every reader.
"""
from __future__ import annotations

from typing import Dict, Optional

from perfbench.harness.stats import percentile


def record() -> Optional[list]:
    """The port's spans, or None where the port keeps no record."""
    from future_urban_scene_generation_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    return spans() if spans is not None else None


def stretch(trace):
    """(first, last) ns of the traced stretch's events, or None without a trace."""
    if trace is None:
        return None
    ends = [(k.start_ns, k.end_ns) for k in trace.kernels] + \
        [(s.start_ns, s.end_ns) for s in trace.spans]
    if not ends:
        return None
    return min(s for s, _ in ends), max(e for _, e in ends)


def medians(run, spans=None) -> Optional[Dict[str, float]]:
    """Median host time in ms by span name over the spans outside the traced stretch;
    None where the port keeps no record. ``spans`` defaults to :func:`record`."""
    spans = record() if spans is None else spans
    if spans is None:
        return None
    window = stretch(run.trace)
    by_name: Dict[str, list] = {}
    for s in spans:
        if window is not None and s.start_ns <= window[1] and s.end_ns >= window[0]:
            continue
        by_name.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e6)
    return {name: percentile(ms, 50) for name, ms in by_name.items()}


def median(run, name: str) -> Optional[float]:
    """Median host time of the spans named ``name`` outside the traced stretch, ms."""
    m = medians(run)
    return None if m is None else m.get(name)
