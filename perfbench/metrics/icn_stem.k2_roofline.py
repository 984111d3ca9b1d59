"""icn_stem.k2_roofline: kernel K2's share of its roofline, in %: the bound of each
call from the cell's shapes (roofline/kernels.k2_call: N = V x T, 256^2, 21 -> 64,
7x7, in the generators' dtype) over the device time of the conv kernel behind the
stem loader."""
from perfbench.roofline import kernels as rk


def read(run):
    t = run.trace
    if t is None:
        return None
    ks = [k for k in t.kernels if rk.is_k2(k.name)]
    if not ks:
        return None
    cfg, traffic = run.cell.config, run.cell.cell["traffic"]
    v = traffic["vehicles"]
    dtype = cfg["spec"]["generator_dtype"]
    n_bytes, flop = rk.k2_call(v * cfg["steps"], v, 256, 256,
                               itemsize=2 if dtype == "bfloat16" else 4)
    bound = len(ks) * rk.bound_s(n_bytes, flop, rk.PEAKS[dtype])
    return 100.0 * bound / (sum(k.end_ns - k.start_ns for k in ks) / 1e9)
