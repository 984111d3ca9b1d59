"""Observability: the port's spans, a trace capture, a timing harness and the
training metrics log.

Counterpart of the JAX package's utils/profiling.py (``trace`` :19, ``capture_trace``
:26, ``timeit`` :35, ``MetricsLogger`` :52): a ``torch.profiler`` run written to a
directory for ``jax.profiler.start_trace``, and ``torch.cuda.synchronize`` where CUDA
is in use for JAX's block on its outputs. :func:`trace` is the port's one span: it
records into an in-memory ring (:func:`spans`) always, and is a ``record_function``
for the profiler while one runs, as ``jax.profiler.TraceAnnotation`` is for JAX's.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Hashable, List, NamedTuple, Optional

import torch

# The ring holds the newest RING_SPANS spans of the process. Sizing: a whole 51 s
# window of each benchmarked workload, with its set-up: a served scene leaves 14 spans
# (10 stages, its dispatch, its wait and the two VUNet replays), 16 with the reduced-grid
# plane warp's sample and paste spans, and takes ~0.09-0.9 s on an H100: the bf16 cell's
# window holds ~500-600 scenes, ~9,000-10,000 spans; a scene on the int8 tier leaves 143
# (a ``fusg.int8`` span for each of its 129 int8 convs) and takes ~0.78 s at V = 16, ~67
# scenes and ~9,600 spans; an ICN training step on the card leaves 5 (``fusg.datagen``,
# its ``.stream`` child and the maker's three parts) every ~0.18 s, ~290 steps and ~1,450
# spans. 16,384 spans hold the largest with room, a few MB.
RING_SPANS = 16384


class Span(NamedTuple):
    """One closed span. ``start_ns`` / ``end_ns`` are Unix-epoch nanoseconds
    (``time.time_ns``), the clock torch's profiler stamps its CPU events with, so a
    span lines up with the profiler's event of the same name and with the device's
    timeline. ``parent_id`` is the span open around it in its thread (None at the
    top); ``request`` the key of the enclosing :func:`request` (None outside one)."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    request: Optional[Hashable]
    thread: int


_RING: collections.deque = collections.deque(maxlen=RING_SPANS)
_IDS = itertools.count(1)
_profiler_enabled = torch._C._autograd._profiler_enabled


class _ThreadState(threading.local):
    def __init__(self):
        self.open: List[int] = []  # ids of this thread's open spans, innermost last
        self.request: Optional[Hashable] = None


_STATE = _ThreadState()


class _Trace:
    __slots__ = ("name", "start", "span_id", "parent", "request", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _STATE
        self.parent = st.open[-1] if st.open else None
        self.request = st.request
        self.span_id = next(_IDS)
        st.open.append(self.span_id)
        # Entered only under a running profiler, and remembered, so that enter and
        # exit pair up when the profiler starts or stops inside the span.
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _STATE.open.pop()
        _RING.append((self.name, self.start, end, self.span_id, self.parent, self.request,
                      threading.get_ident()))
        return False


def trace(name: str):
    """A span named ``name`` around the ``with`` block: recorded in :func:`spans` when
    it closes, and a ``record_function`` of the same name while a profiler runs."""
    return _Trace(name)


@contextlib.contextmanager
def request(key: Hashable):
    """Spans this thread opens inside the block carry ``key`` as their request: the
    scene, batch or call that caused them."""
    st = _STATE
    outer, st.request = st.request, key
    try:
        yield
    finally:
        st.request = outer


def spans() -> List[Span]:
    """A snapshot of the ring, oldest span first (spans are appended as they close)."""
    return [Span(*r) for r in list(_RING)]


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the block (the CPU, and the card when there is one) and write its
    Chrome trace to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync():
    """Wait for the card's queued work, where this process has started CUDA."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1, **kwargs) -> Dict[str, float]:
    """Median / mean / min wall time of ``fn(*args, **kwargs)`` in ms. Where CUDA is
    in use the clock is read around ``torch.cuda.synchronize``, so each call's device
    work is inside its time, as the JAX harness blocks on its outputs."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return {"p50_ms": times[len(times) // 2] * 1e3, "mean_ms": sum(times) / len(times) * 1e3,
            "min_ms": times[0] * 1e3}


class MetricsLogger:
    """Append-only JSONL metrics log: one ``{"step", "time", **metrics}`` per line."""

    def __init__(self, path):
        self.path = Path(path)

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec
