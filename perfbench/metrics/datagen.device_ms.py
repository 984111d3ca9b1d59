"""datagen.device_ms: device time of the kernels launched inside the benchmark's
``bench.make_batch`` span (the family's data source), a step."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ks = t.under("bench.make_batch")
    return sum(k.end_ns - k.start_ns for k in ks) / 1e6 / t.units if ks else None
