"""Readings for setting the limits of a scene cell on the int8 tier, many seeds in one
process.

    python3 perfbench/calibrate_int8.py --workload scene-720p-int8.v16 \\
        --seeds <n> [<n> ...] [--seconds 3] [--controls 10] [--scene-controls K] \\
        [--out FILE]

``calibrate_bf16.py``'s loop (its options but the default ``--out``) with this module's
controls. For each seed a run of the cell (set-up, a short window at the cell's own
load, the judge against the plain int8 reference) gives the program's readings. For the
first ``--controls`` seeds, the ICN's trunk on the program's stem activation, by the
reference, against the int8 reference's trunk there (``judge/scene_int8.py``'s trunk
numbers):

* ``icn_float``: the trunk with the tier off (a program whose ICN skipped the tier);
* ``icn_bits7``: the trunk with 7-bit codes (scales max|x| / 63, codes clamped to
  +-63), a precision below the configuration's;

and for the first ``--scene-controls`` of those (all of them if not given) three whole
scenes, each a reference in the program's place, read by the judge's scene comparison:

* ``float``: the float reference, the tier off;
* ``bits7``: the int8 reference with 7-bit codes;
* ``control``: the int8 reference with TF32 on (its float convs and matmuls: perception's
  first convs, the ICN stem and head, the up stages' borders, the VUNet).

Each reading is one JSON line in ``--out``; no limit is applied here. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import calibrate_bf16  # noqa: E402

ICN_CONTROLS = {"icn_float": None, "icn_bits7": 63}
SCENE_CONTROLS = {"float": {"qmax": None}, "bits7": {"qmax": 63},
                  "control": {"use_tf32": True}}


def readings(run, held, scenes: bool = True) -> dict:
    """The controls of the module's docstring (the whole scenes' only with ``scenes``),
    each the worst over the judged scenes."""
    from perfbench.judge import scene, scene_branches, scene_int8

    ref = dict(scene_int8.icn_trunks(run, held))
    out = {name: scene.worst([scene_int8.trunk_numbers(got, ref[k]) for k, got in
                              scene_int8.icn_trunks(run, held, qmax)])
           for name, qmax in ICN_CONTROLS.items()}
    if not scenes:
        return out
    idx = scene.sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    ref = {k: (r, w) for k, r, w in scene_int8.reference_scenes(run, held, idx)}
    for name, kwargs in SCENE_CONTROLS.items():
        got = {k: r for k, r, _ in scene_int8.reference_scenes(run, held, idx, **kwargs)}
        out[name] = scene.worst([
            scene_branches.compare(got[k], ref[k][0], scene.background(run, held, k),
                                   ref[k][1])
            for k in idx])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--scene-controls", type=int, default=None)
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "calibrate_int8.jsonl"))
    own, rest = p.parse_known_args(argv)
    count = itertools.count()

    def each(run, held):
        return readings(run, held, own.scene_controls is None
                        or next(count) < own.scene_controls)

    with calibrate_bf16.patched(calibrate_bf16, "readings", lambda real: each):
        return calibrate_bf16.main(rest + ["--out", own.out])


if __name__ == "__main__":
    sys.exit(main())
