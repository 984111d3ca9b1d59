"""stream.dispatch_ms: median host time of one ``fusg.stream.dispatch`` span outside
the traced stretch: the stream runner's whole enqueue of a scene (uploads, the scene's
stages, the event record)."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.median(run, "fusg.stream.dispatch")
