"""scene.mfu: the scene's model FLOPs (roofline/flops.scene_flops, counted from
shapes) times the scenes dispatched in the traced stretch, over the stretch's
length, as a share of the peak of the generators' dtype (float32: 67 TFLOP/s), in %."""
from perfbench.roofline import flops, kernels as rk


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    cfg, traffic = run.cell.config, run.cell.cell["traffic"]
    per_scene = flops.scene_flops(cfg["spec"], traffic["vehicles"], cfg["steps"])
    peak = rk.PEAKS[cfg["spec"]["generator_dtype"]]
    return 100.0 * per_scene * t.units / t.window_s / peak
