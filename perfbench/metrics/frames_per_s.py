"""frames_per_s: composited frames drained in the window (2 branches x T a scene)
over the window's whole wall time."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if "frames" in w else None
