"""train_samples_per_s: batch x steps completed in the window over the window, which
ends on a device synchronize."""


def read(run):
    w = run.window
    return w["samples"] / w["seconds"] if "samples" in w else None
