"""perception.device_ms: device time of the kernels launched inside the
``fusg.perceive`` span, a scene."""


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for s in t.spans if s.name == "fusg.perceive")
    ks = t.under("fusg.perceive")
    return sum(k.end_ns - k.start_ns for k in ks) / 1e6 / n if n and ks else None
