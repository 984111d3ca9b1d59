"""train.mfu: one training step's model FLOPs, forward and backward
(roofline/flops.icn_train_step_flops, counted from shapes), times the steps in the
traced stretch, over the stretch's length, as a share of the float32 peak, in %."""
from perfbench.roofline import flops, kernels as rk


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    per_step = flops.icn_train_step_flops(run.cell.cell["traffic"]["batch"],
                                          run.cell.config["image_size"])
    return 100.0 * per_step * t.units / t.window_s / rk.PEAK_F32
