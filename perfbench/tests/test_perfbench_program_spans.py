"""The readers of the port's span record (``harness/program_spans.py`` and the five
metrics on it) against a synthetic record and trace: the traced stretch and the cold
first occurrence left out, a port without a record read as nothing."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench.harness import bench, program_spans
from perfbench.harness.trace import Kernel, Span, Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MS = 1_000_000  # ns
# The traced stretch: its first span starts at 10 s, its last kernel ends at 12 s.
STRETCH = Trace(kernels=[Kernel("k", 11_500 * MS, 12_000 * MS, None, ())],
                spans=[Span("bench.submit", 10_000 * MS, 11_000 * MS)],
                units=2, window_s=1.0, busy_s=0.5, idle_gaps=[])


def reader(name):
    return bench.load_module(METRICS / f"{name}.py")


def _record(durations_by_name):
    """Spans of each name in turn, ``(start ms, duration ms)`` each."""
    out, ids = [], iter(range(1, 10_000))
    for name, spans in durations_by_name.items():
        for start, dur in spans:
            out.append(profiling.Span(name, start * MS, (start + dur) * MS, next(ids), None,
                                      None, 1))
    return out


def _steady(start, dur, n=2, pitch=1_500):
    return [(start + i * pitch, dur) for i in range(n)]


# Each name: a cold first occurrence at 0 ms, its steady copies before and after the
# stretch, and inflated copies inside it (and one straddling its start).
SCENE = {name: [(0, 900)] + _steady(1_000, dur) + _steady(13_000, dur)
         + [(9_900, 500), (10_500, 500), (11_000, 500)]
         for name, dur in (("fusg.stream.wait", 3), ("fusg.stream.dispatch", 1_000),
                           ("fusg.visibility", 5), ("fusg.src_table", 6),
                           ("fusg.plane_warp", 40), ("fusg.composite", 2),
                           ("fusg.datagen", 55))}


@pytest.fixture
def record(monkeypatch):
    spans = _record(SCENE)
    monkeypatch.setattr(program_spans, "record", lambda: spans)
    return spans


def test_medians_leave_out_the_stretch_and_the_cold_first(record):
    run = SimpleNamespace(trace=STRETCH)
    got = program_spans.medians(run)
    assert got["fusg.stream.wait"] == 3 and got["fusg.plane_warp"] == 40
    # Without the stretch dropped the inflated copies move the median.
    assert program_spans.medians(SimpleNamespace(trace=None))["fusg.stream.wait"] > 3


@pytest.mark.parametrize("metric,want", [
    ("stream.wait_ms", 3), ("stream.dispatch_ms", 1_000),
    ("warp_composite.host_ms", 5 + 6 + 40 + 2), ("datagen.host_ms", 55)])
def test_span_readers(record, metric, want):
    assert reader(metric).read(SimpleNamespace(trace=STRETCH)) == pytest.approx(want)


def test_warp_composite_needs_all_four_spans(monkeypatch):
    spans = _record({k: v for k, v in SCENE.items() if k != "fusg.composite"})
    monkeypatch.setattr(program_spans, "record", lambda: spans)
    assert reader("warp_composite.host_ms").read(SimpleNamespace(trace=STRETCH)) is None


@pytest.mark.parametrize("metric", ["stream.wait_ms", "stream.dispatch_ms",
                                    "warp_composite.host_ms", "datagen.host_ms"])
def test_a_port_without_a_record_reads_nothing(monkeypatch, metric):
    monkeypatch.delattr(profiling, "spans")
    assert reader(metric).read(SimpleNamespace(trace=STRETCH)) is None


def test_datagen_idle_sums_only_datagen_gaps_a_step():
    gaps = [("fusg.datagen.views", 0.030), ("fusg.datagen.draws", 0.010),
            ("fusg.datagen", 0.005), ("fusg.datagen.pairs", 0.015),
            ("bench.make_batch", 0.5), ("bench.train_step", 0.02), ("fusg.datagenerator", 1.0),
            ("outside spans", 0.25)]
    trace = Trace([], [], units=5, window_s=2.0, busy_s=1.0, idle_gaps=gaps)
    got = reader("datagen.idle_ms").read(SimpleNamespace(trace=trace))
    assert got == pytest.approx(1e3 * (0.030 + 0.010 + 0.005 + 0.015) / 5)
    # A parent whose data source has no spans of its own: nothing to read.
    trace.idle_gaps = [("bench.make_batch", 0.5), ("bench.train_step", 0.02)]
    assert reader("datagen.idle_ms").read(SimpleNamespace(trace=trace)) is None
