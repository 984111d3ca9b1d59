"""int8.host_ms: the host time of a scene's ``fusg.int8`` spans (one a conv on the int8
tier: N3 then N2, 129 a scene at V = 16), summed by request (the stream runner's scene
number), as the median over the scenes that have no such span inside the traced
stretch. A port without the span reads nothing."""
from perfbench.harness import program_spans
from perfbench.harness.stats import percentile

SPAN = "fusg.int8"


def read(run):
    spans = program_spans.record()
    if spans is None:
        return None
    window = program_spans.stretch(run.trace)
    by_scene, traced = {}, set()
    for s in spans:
        if s.name != SPAN or s.request is None:
            continue
        if window is not None and s.start_ns <= window[1] and s.end_ns >= window[0]:
            traced.add(s.request)
        by_scene[s.request] = by_scene.get(s.request, 0.0) + (s.end_ns - s.start_ns) / 1e6
    ms = [v for k, v in by_scene.items() if k not in traced]
    return percentile(ms, 50) if ms else None
