"""vunet.graph_share: the share of the VUNet's serving passes that replayed a captured
CUDA graph, in %: of the ``fusg.vunet_encode`` and ``fusg.vunet_decode`` spans outside the
traced stretch, those with a ``fusg.vunet.replay`` child (by ``parent_id``). The first
span of each name, the cold set-up scene's, is left out: a key's first pass runs eagerly
by design. A port without the record or without VUNet spans reads nothing; one without
replay spans reads 0."""
from perfbench.harness import program_spans

PASSES = ("fusg.vunet_encode", "fusg.vunet_decode")
REPLAY = "fusg.vunet.replay"


def read(run):
    spans = program_spans.record()
    if spans is None:
        return None
    window = program_spans.stretch(run.trace)
    replayed = {s.parent_id for s in spans if s.name == REPLAY}
    seen, passes = set(), []
    for s in sorted((s for s in spans if s.name in PASSES), key=lambda s: s.start_ns):
        if s.name not in seen:
            seen.add(s.name)
            continue
        if window is not None and s.start_ns <= window[1] and s.end_ns >= window[0]:
            continue
        passes.append(s.span_id in replayed)
    return 100.0 * sum(passes) / len(passes) if passes else None
