"""Readings for setting a cell's limits, many seeds in one process (set-up is long).

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \\
        [--seconds 3] [--controls 3] [--out FILE]

For each seed: a run of the cell as ``run.py`` makes it (set-up, a short window at the
cell's own load, the judge against the plain reference) gives the program's readings;
for the first ``--controls`` seeds the control is read too: the plain reference
computed with TF32 on, in the program's place, against the reference in float32 (the
nearest precision below the configuration's float32 with TF32 off). For a training
cell, two faults are read beside it: the reference fed half of each batch, and each
batch's first target altered where it is made; for a scene
cell, how far the reference's poses move against themselves with the vehicles given
in reverse order (another order of the same operations). Each reading is
one JSON line in ``--out``; no limit is applied here. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import run as bench_run  # noqa: E402
from perfbench.harness import bench  # noqa: E402


def scene_control(run, held) -> dict:
    from perfbench.judge import scene

    idx = scene.sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    ref = {k: (r, w) for k, r, w in scene.reference_scenes(run, held, idx)}
    ctl = {k: r for k, r, _ in scene.reference_scenes(run, held, idx, use_tf32=True)}
    rev = {k: r for k, r, _ in scene.reference_scenes(run, held, idx, reverse=True)}
    bg = {k: scene.background(run, held, k) for k in idx}
    reorder = scene.worst([scene.compare(ref[k][0][:2] + rev[k][2:], ref[k][0], bg[k],
                                         ref[k][1]) for k in idx])
    return {"control": scene.worst([scene.compare(ctl[k], ref[k][0], bg[k], ref[k][1])
                                    for k in idx]),
            "reorder": {k: reorder[k] for k in ("pnp_gap", "cad_mismatch")}}


def train_control(run, held) -> dict:
    from perfbench.judge import train

    steps = len(held["losses"])
    out = {}
    for name, kwargs in (("control", {"use_tf32": True}), ("fault_half_batch", {"half": True}),
                         ("fault_batch_altered", {"alter": True})):
        b, losses, grads, change = train.reference_run(run, steps, **kwargs)
        fake = {"batches": b, "losses": losses, "grad_norms": grads, "change_norms": change}
        out[name] = train.numbers(fake, train.reference_run(run, steps, batches=b))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "calibrate.jsonl")
    args = p.parse_args(argv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    cell = bench.load_cell(ROOT, args.workload)
    control = scene_control if cell.cell["entry"] == "stream" else train_control
    with args.out.open("a") as f:
        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            run, entry, held = bench_run.drive(cell, seed, args.seconds, False, "cuda:0",
                                               t0=t)
            line = {"workload": args.workload, "seed": seed,
                    "program": entry.judge(run, held)}
            if i < args.controls:
                line.update(control(run, held))
            line["seconds"] = time.perf_counter() - t
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            del held
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
