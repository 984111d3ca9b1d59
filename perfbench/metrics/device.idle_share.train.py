"""device.idle_share.train: the share of the traced stretch in which no kernel ran on
the device, in %."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None and t.window_s else None
