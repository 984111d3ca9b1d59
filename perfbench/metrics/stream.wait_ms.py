"""stream.wait_ms: median host time of one ``fusg.stream.wait`` span outside the traced
stretch: the stream runner blocked on a drained scene's event. Near 0 while the host
paces the scene; it grows to the device's excess once the host runs ahead."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.median(run, "fusg.stream.wait")
