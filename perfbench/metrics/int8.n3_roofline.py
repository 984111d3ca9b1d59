"""int8.n3_roofline: kernel N3's share of its bytes bound, in %: a scene's quantizations
from the cell's shapes (roofline/int8: x read once, its codes and the weight codes
written once, at the memory rate), times the scenes' worth of N3 launches in the traced
stretch, over the device time of ``quant_int8_kernel``."""
from perfbench.roofline import int8 as ri


def read(run):
    t = run.trace
    if t is None:
        return None
    ks = [k for k in t.kernels if ri.N3_NAME in k.name]
    if not ks:
        return None
    work = ri.cell_work(run)
    bound = len(ks) / len(work.calls) * work.n3_bound_s()
    return 100.0 * bound / (sum(k.end_ns - k.start_ns for k in ks) / 1e9)
