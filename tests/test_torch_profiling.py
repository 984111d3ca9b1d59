"""The port's span record (``utils/profiling``): what a span keeps, its parent and
request across threads, and its clock against torch's profiler, on the CPU."""
import threading

import torch
from torch.profiler import ProfilerActivity, profile

from future_urban_scene_generation_tpu_torch.utils import profiling
import torch_threads  # noqa: F401


def _new_spans(before):
    return [s for s in profiling.spans() if s.span_id not in before]


def _ids():
    return {s.span_id for s in profiling.spans()}


def test_nested_spans_record_name_times_parent_and_request():
    before = _ids()
    with profiling.request("scene-7"):
        with profiling.trace("fusg.outer"):
            with profiling.trace("fusg.inner"):
                torch.ones(4).sum()
            with profiling.trace("fusg.inner"):
                pass
    with profiling.trace("fusg.after"):
        pass
    got = _new_spans(before)
    assert [s.name for s in got] == ["fusg.inner", "fusg.inner", "fusg.outer", "fusg.after"]
    inner1, inner2, outer, after = got
    assert outer.parent_id is None and after.parent_id is None
    assert inner1.parent_id == inner2.parent_id == outer.span_id
    assert len({s.span_id for s in got}) == 4
    assert [s.request for s in got] == ["scene-7"] * 3 + [None]
    assert outer.start_ns <= inner1.start_ns <= inner1.end_ns <= inner2.start_ns
    assert inner2.end_ns <= outer.end_ns <= after.start_ns <= after.end_ns
    assert {s.thread for s in got} == {threading.get_ident()}


def test_threads_keep_their_own_parents_and_requests():
    before = _ids()
    both_open = threading.Barrier(2, timeout=30)

    def work(key):
        with profiling.request(key), profiling.trace(f"fusg.outer.{key}"):
            both_open.wait()  # each thread's outer span is open while the other's is
            with profiling.trace(f"fusg.inner.{key}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in _new_spans(before)}
    assert set(got) == {"fusg.outer.a", "fusg.inner.a", "fusg.outer.b", "fusg.inner.b"}
    for key in ("a", "b"):
        outer, inner = got[f"fusg.outer.{key}"], got[f"fusg.inner.{key}"]
        assert outer.parent_id is None and inner.parent_id == outer.span_id
        assert outer.request == inner.request == key
        assert outer.thread == inner.thread
    assert got["fusg.outer.a"].thread != got["fusg.outer.b"].thread


def test_spans_share_the_profilers_clock_and_make_no_event_without_it(monkeypatch):
    # The first record_function of a process resolves its operator (~1.4 ms on a CPU),
    # the benchmark's own spans do so long before the profiled stretch.
    with torch.profiler.record_function("warm-up"):
        pass
    before = _ids()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.trace(f"fusg.clock.{i}"):
                torch.ones(256).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("fusg.clock.")}
    spans = {s.name: s for s in _new_spans(before)}
    assert set(events) == set(spans) == {f"fusg.clock.{i}" for i in range(5)}
    for name, s in spans.items():
        e = events[name]
        assert abs(s.start_ns - e.start_ns()) < 500_000, name
        assert abs(s.end_ns - (e.start_ns() + e.duration_ns())) < 500_000, name

    made = []

    class Counting:
        def __init__(self, name):
            made.append(name)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    before = _ids()
    with profiling.trace("fusg.unprofiled"):
        pass
    assert made == [] and [s.name for s in _new_spans(before)] == ["fusg.unprofiled"]
