"""setup_s: process start to the end of the warm-up (import, CUDA context, kernel
library, weights, the traffic pool or data source, the first scenes or steps)."""


def read(run):
    return run.setup_s
