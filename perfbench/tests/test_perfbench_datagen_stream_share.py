"""The ``datagen.stream_share`` reader against a synthetic span record: stream children
counted through ``parent_id``, the traced stretch left out, 0 for a port whose batches
have no stream spans, nothing for one without a record or without batches."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench.harness import bench, program_spans
from perfbench.harness.trace import Kernel, Span, Trace

MS = 1_000_000  # ns
# The traced stretch: 10 s to 12 s.
STRETCH = Trace(kernels=[Kernel("k", 11_500 * MS, 12_000 * MS, None, ())],
                spans=[Span("bench.make_batch", 10_000 * MS, 11_000 * MS)],
                units=2, window_s=2.0, busy_s=0.5, idle_gaps=[])
READER = bench.load_module(Path(__file__).resolve().parents[1] / "metrics"
                           / "datagen.stream_share.py")


def _record(batches):
    """Per batch ``(start ms, on the stream)``: its ``fusg.datagen`` span, a stream child
    where on the stream, and the maker's parts below (under the stream span where there
    is one), as ``cli.train.family_setup`` and ``datagen.icn_batch`` nest them."""
    out, ids = [], iter(range(1, 10_000))
    for i, (start, on_stream) in enumerate(batches):
        t = start * MS
        batch = next(ids)
        out.append(profiling.Span("fusg.datagen", t, t + 50 * MS, batch, None, i, 1))
        parent = batch
        if on_stream:
            parent = next(ids)
            out.append(profiling.Span("fusg.datagen.stream", t + MS, t + 49 * MS, parent,
                                      batch, i, 1))
        for k, part in enumerate(("draws", "views", "pairs")):
            out.append(profiling.Span(f"fusg.datagen.{part}", t + (2 + 10 * k) * MS,
                                      t + (10 + 10 * k) * MS, next(ids), parent, i, 1))
        out.append(profiling.Span("bench.train_step", t + 60 * MS, t + 90 * MS, next(ids),
                                  None, None, 1))
    return sorted(out, key=lambda s: s.end_ns)


def _read(monkeypatch, batches, trace=STRETCH):
    spans = _record(batches)
    monkeypatch.setattr(program_spans, "record", lambda: spans)
    return READER.read(SimpleNamespace(trace=trace))


INSIDE = [(10_200, False), (10_600, False)]  # in the stretch: never counted


@pytest.mark.parametrize("batches,want", [
    ([(0, True), (1_000, True)] + INSIDE + [(13_000, True)], 100.0),
    ([(0, True), (1_000, False)] + INSIDE + [(13_000, True), (14_000, False)], 50.0),
    ([(0, False), (1_000, False)] + INSIDE + [(13_000, False)], 0.0),
])
def test_share_of_batches_on_the_stream_outside_the_stretch(monkeypatch, batches, want):
    assert _read(monkeypatch, batches) == pytest.approx(want)


def test_without_a_trace_every_batch_counts(monkeypatch):
    assert _read(monkeypatch, [(0, True)] + INSIDE, trace=None) == pytest.approx(100 / 3)


def test_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, INSIDE) is None  # only batches inside the stretch
    assert _read(monkeypatch, []) is None
    monkeypatch.delattr(profiling, "spans")
    assert READER.read(SimpleNamespace(trace=STRETCH)) is None
