"""int8.n2_roofline: kernel N2's share of its roofline, in %: the bound of a scene's
int8 convs from the cell's shapes (roofline/int8: each call's operations at the int8
peak against its bytes at the memory rate, summed over the scene's calls), times the
scenes' worth of N2 launches in the traced stretch (launches / calls a scene), over the
device time of ``conv_int8_wgmma_kernel``."""
from perfbench.roofline import int8 as ri


def read(run):
    t = run.trace
    if t is None:
        return None
    ks = [k for k in t.kernels if ri.N2_NAME in k.name]
    if not ks:
        return None
    work = ri.cell_work(run)
    bound = len(ks) / len(work.calls) * work.n2_bound_s()
    return 100.0 * bound / (sum(k.end_ns - k.start_ns for k in ks) / 1e9)
