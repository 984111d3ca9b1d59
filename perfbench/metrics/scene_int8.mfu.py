"""scene_int8.mfu: a scene on the int8 tier at the card's peaks, as a share of the time
the traced stretch took, in %: per scene its int8 operations at the int8 peak (1,979
TOP/s) plus its float FLOPs at the float32 peak (67 TFLOP/s) (roofline/int8), times
the scenes dispatched in the stretch, over the stretch's length. ``scene.mfu`` reads
every FLOP at the float32 peak, which an int8 scene can beat: this cell does not
report it."""
from perfbench.roofline import int8 as ri


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    return 100.0 * ri.cell_work(run).bound_s() * t.units / t.window_s
