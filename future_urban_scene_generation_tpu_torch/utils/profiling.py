"""Observability: stage annotations, a trace capture, a timing harness and the
training metrics log.

Counterpart of the JAX package's utils/profiling.py (``trace`` :19, ``capture_trace``
:26, ``timeit`` :35, ``MetricsLogger`` :52): ``torch.profiler.record_function`` for
``jax.profiler.TraceAnnotation``, a ``torch.profiler`` run written to a directory for
``jax.profiler.start_trace``, and ``torch.cuda.synchronize`` where CUDA is in use
for JAX's block on its outputs.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for the profiler (a ``record_function`` span)."""
    with torch.profiler.record_function(name):
        yield


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
