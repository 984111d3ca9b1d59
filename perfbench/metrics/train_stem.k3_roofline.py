"""train_stem.k3_roofline: kernel K3's share of its roofline in the training step, in
%: the bound of each call from the cell's shapes (the generator's 7x7 stem, 21 -> 64,
on the batch reflect-padded to 262^2, float32) over the device time of the conv
kernel behind the single-tensor loader."""
from perfbench.roofline import kernels as rk


def read(run):
    t = run.trace
    if t is None:
        return None
    ks = [k for k in t.under("bench.train_step") if rk.is_k3(k.name)]
    if not ks:
        return None
    cfg = run.cell.config
    b, s = run.cell.cell["traffic"]["batch"], cfg["image_size"]
    n_bytes, flop = rk.k3_call(b, s + 6, s + 6, cfg["input_nc"], 7, cfg["ngf"])
    bound = len(ks) * rk.bound_s(n_bytes, flop, rk.PEAK_F32)
    return 100.0 * bound / (sum(k.end_ns - k.start_ns for k in ks) / 1e9)
