"""generators.device_ms: device time of the kernels launched inside the ICN and VUNet
spans (``fusg.icn``, ``fusg.vunet_encode``, ``fusg.vunet_decode``), a scene."""

SPANS = ("fusg.icn", "fusg.vunet_encode", "fusg.vunet_decode")


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.icn")
    ks = t.under(*SPANS)
    return sum(k.end_ns - k.start_ns for k in ks) / 1e6 / n if n and ks else None
