"""The ``vunet.graph_share`` reader against a synthetic span record: replay children
counted through ``parent_id``, the traced stretch and each pass's cold first span left
out, 0 for a port without replay spans, nothing for one without a record."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench.harness import bench, program_spans
from perfbench.harness.trace import Kernel, Span, Trace

MS = 1_000_000  # ns
# The traced stretch: 10 s to 12 s.
STRETCH = Trace(kernels=[Kernel("k", 11_500 * MS, 12_000 * MS, None, ())],
                spans=[Span("bench.submit", 10_000 * MS, 11_000 * MS)],
                units=2, window_s=2.0, busy_s=0.5, idle_gaps=[])
READER = bench.load_module(Path(__file__).resolve().parents[1] / "metrics"
                           / "vunet.graph_share.py")


def _record(scenes):
    """Per scene ``(start ms, replayed encode, replayed decode)``: its two VUNet spans,
    each with a replay child where replayed, and an unrelated child span."""
    out, ids = [], iter(range(1, 10_000))
    for start, *replayed in scenes:
        for k, (name, rep) in enumerate(zip(("fusg.vunet_encode", "fusg.vunet_decode"),
                                            replayed)):
            t = (start + 10 * k) * MS
            sid = next(ids)
            out.append(profiling.Span(name, t, t + 5 * MS, sid, None, start, 1))
            out.append(profiling.Span("fusg.icn", t + MS, t + 2 * MS, next(ids), sid, start, 1))
            if rep:
                out.append(profiling.Span("fusg.vunet.replay", t + MS, t + 4 * MS, next(ids),
                                          sid, start, 1))
    return sorted(out, key=lambda s: s.end_ns)


def _read(monkeypatch, scenes, trace=STRETCH):
    spans = _record(scenes)
    monkeypatch.setattr(program_spans, "record", lambda: spans)
    return READER.read(SimpleNamespace(trace=trace))


# The cold set-up scene (eager), then steady scenes before, inside and after the stretch.
COLD = (0, False, False)
INSIDE = [(10_200, False, False), (11_200, False, False)]


@pytest.mark.parametrize("scenes,want", [
    ([COLD, (1_000, True, True), (2_000, True, True)] + INSIDE + [(13_000, True, True)], 100.0),
    ([COLD, (1_000, True, False), (2_000, True, True)] + INSIDE + [(13_000, False, True)], 400 / 6),
    ([COLD, (1_000, False, False), (2_000, False, False)] + INSIDE, 0.0),
])
def test_share_of_replayed_passes_outside_the_stretch(monkeypatch, scenes, want):
    assert _read(monkeypatch, scenes) == pytest.approx(want)


def test_without_a_trace_every_steady_pass_counts(monkeypatch):
    scenes = [COLD, (1_000, True, True)] + INSIDE
    assert _read(monkeypatch, scenes, trace=None) == pytest.approx(200 / 6)


def test_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, [COLD]) is None  # only the cold scene
    assert _read(monkeypatch, []) is None
    monkeypatch.delattr(profiling, "spans")
    assert READER.read(SimpleNamespace(trace=STRETCH)) is None
