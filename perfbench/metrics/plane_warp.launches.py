"""plane_warp.launches: device kernels launched inside the ``fusg.plane_warp`` span, a scene."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.plane_warp")
    return len(t.under("fusg.plane_warp")) / n if n else None
