"""pose.launches: device kernels launched inside the ``fusg.pnp`` span, a scene."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.pnp")
    return len(t.under("fusg.pnp")) / n if n else None
