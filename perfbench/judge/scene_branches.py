"""The scene comparison with each branch judged on its own: ``judge/scene.py``'s numbers
and, for the ICN and the VUNet branch apart, numbers over the pixels where either
side's frames of that branch differ from the background.

Why (``PERF.md`` §2): with bfloat16 generators the whole frames' percentile cannot tell
the program from a fault confined to the ICN's inputs. The program differs from the
plain reference by a rounding or two of bfloat16 over much of the ICN's output (the ICN
stem on kernel K2 sums in another order than the plain conv, and each later bfloat16
layer carries a flipped rounding on), and by more than 0.05 almost nowhere; a fault in
the ICN's inputs (the plane warp's paste without its antialiasing) moves a few percent
of its values by more than 0.05, and the whole frames' 90th percentile hardly at all.

Numbers beside ``scene.compare``'s (each the worst over the judged scenes), for ``<b>``
in ``icn`` and ``vunet``: ``<b>_q90_abs``, the 90th percentile of the absolute difference
over the branch's painted pixels, and ``<b>_bad05_share``, the share of those values off
by more than 0.05. The VUNet's are readings with no limit: the program's VUNet differs
from the reference's by more than 0.05 in 2-3% of its values on every seed, more than the
TF32 control's on some.
"""
from __future__ import annotations

import torch

from perfbench.judge import scene

BRANCHES = ("icn", "vunet")
BAD = 0.05


def branch_numbers(got, ref, background) -> dict:
    """The numbers of each branch of one scene: ``got`` and ``ref`` are (frames_icn,
    frames_vunet, ...), ``background`` the (H, W, 3) float frame both composited into."""
    out = {}
    for b, f_got, f_ref in zip(BRANCHES, got[:2], ref[:2]):
        f_got, f_ref = f_got.to(torch.float32), f_ref.to(torch.float32)
        painted = ((f_got != background) | (f_ref != background)).any(-1)
        values = (f_got - f_ref).abs()[painted].flatten()
        out[f"{b}_q90_abs"] = scene.q90(values)
        out[f"{b}_bad05_share"] = (float((values > BAD).to(torch.float32).mean())
                                   if values.numel() else 0.0)
    return out


def compare(got, ref, background, windows) -> dict:
    """``scene.compare``'s numbers and each branch's."""
    return {**scene.compare(got, ref, background, windows),
            **branch_numbers(got, ref, background)}


def judge(run, held: dict) -> dict:
    """Readings of the sampled scenes against the reference; {} if none finished."""
    idx = scene.sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    per_scene = [compare(held["kept"][k], r, scene.background(run, held, k), windows)
                 for k, r, windows in scene.reference_scenes(run, held, idx)]
    readings = scene.worst(per_scene)
    readings["judged_scenes"] = float(len(per_scene))
    return readings
