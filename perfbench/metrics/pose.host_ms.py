"""pose.host_ms: host time of the ``fusg.pnp`` span a scene, in the traced stretch."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.pnp")
    return t.span_ms("fusg.pnp") / n if n else None
