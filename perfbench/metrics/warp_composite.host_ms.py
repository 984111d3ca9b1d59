"""warp_composite.host_ms: the "visibility, warp, composite" layer's host time a scene,
outside the traced stretch: the sum of the median ``fusg.visibility``,
``fusg.src_table``, ``fusg.plane_warp`` and ``fusg.composite`` spans."""
from perfbench.harness import program_spans

SPANS = ("fusg.visibility", "fusg.src_table", "fusg.plane_warp", "fusg.composite")


def read(run):
    m = program_spans.medians(run)
    if m is None or any(name not in m for name in SPANS):
        return None
    return sum(m[name] for name in SPANS)
