"""plane_paste.device_ms: device time of the kernels launched inside the
``fusg.plane_warp.paste`` spans (the reduced-grid plane warp's antialiased paste into
the 256^2 crops), a scene. A port without the span, or a cell at the exact 256^2 grid,
reads nothing."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.plane_warp")
    ks = t.under("fusg.plane_warp.paste")
    return sum(k.end_ns - k.start_ns for k in ks) / 1e6 / n if n and ks else None
