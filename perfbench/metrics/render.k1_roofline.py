"""render.k1_roofline: kernel K1's share of its roofline, in %: the bound of each
call from the cell's shapes (roofline/kernels.k1_call: N = V x T renders of the
bank's triangles at 256^2) over the device time of its two kernels."""
from perfbench.roofline import kernels as rk
from perfbench.traffic.cars import make_test_car


def read(run):
    t = run.trace
    if t is None:
        return None
    ks = [k for k in t.kernels if rk.is_k1(k.name)]
    calls = sum(1 for k in ks if rk.is_k1_setup(k.name))
    if not calls:
        return None
    cfg, traffic = run.cell.config, run.cell.cell["traffic"]
    renders = traffic["vehicles"] * cfg["steps"]
    triangles = len(make_test_car(subdiv=cfg["cad_subdiv"])[0].triangles)
    n_bytes, ops = rk.k1_call(renders, triangles, 256, 256)
    bound = calls * rk.bound_s(n_bytes, ops, rk.PEAK_F32)
    return 100.0 * bound / (sum(k.end_ns - k.start_ns for k in ks) / 1e9)
