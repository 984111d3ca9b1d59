"""Readings for setting the limits of a scene cell whose generators run in bfloat16,
many seeds in one process.

    python3 perfbench/calibrate_bf16.py --workload scene-1080p-bf16.v4 \\
        --seeds <n> [<n> ...] [--seconds 3] [--controls 10] [--out FILE]

For each seed, as ``calibrate.py`` does: a run of the cell (set-up, a short window at
the cell's own load, the judge against the plain reference) gives the program's
readings. For the first ``--controls`` seeds three more, each the plain reference in the
program's place against the reference, read by ``judge/scene_branches.py``'s comparison:

* ``control``: ``calibrate.py``'s control, the reference with TF32 on (perception and
  geometry stay float32 in this configuration, and so does the plain ICN stem);
* ``mantissa``: the nearest precision below the configuration's bfloat16, every
  generator conv's output (the stem's, each ICN and VUNet conv's and transposed conv's,
  bias included) kept to 3 bits of mantissa: its 4 low bits cleared through an int16
  view;
* ``paste_fault``: a fault planted on the reduced-grid plane warp, the 96^2 grid pasted
  into the 256^2 crop without its antialiasing.

Each reading is one JSON line in ``--out``; no limit is applied here. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
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

LOW_BITS = 4  # of bfloat16's 7 stored mantissa bits


def clear_low_mantissa(y: torch.Tensor) -> torch.Tensor:
    """``y`` with the ``LOW_BITS`` low mantissa bits of each bfloat16 cleared (a value
    of another dtype is handed back as it is)."""
    if y.dtype != torch.bfloat16:
        return y
    return torch.bitwise_and(y.view(torch.int16), -(1 << LOW_BITS)).view(torch.bfloat16)


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _after(fn):
    return lambda real: lambda *a, **k: fn(real(*a, **k))


@contextlib.contextmanager
def reduced_mantissa():
    """The reference's generator convs, each output kept to 3 bits of mantissa. Every
    conv of the reference's networks goes through ``layers.conv_nhwc`` or
    ``layers.conv_transpose_nhwc``, the ICN stem through ``plain_kernels``; perception's
    convs run float32 and are left as they are."""
    from perfbench.reference.models import layers
    from perfbench.reference.ops import plain_kernels

    with patched(layers, "conv_nhwc", _after(clear_low_mantissa)), \
            patched(layers, "conv_transpose_nhwc", _after(clear_low_mantissa)), \
            patched(plain_kernels, "icn_stem_conv_plain", _after(clear_low_mantissa)):
        yield


@contextlib.contextmanager
def paste_without_antialias():
    """The reference's plane-warp paste (its one antialiased resample) with the
    antialiasing off."""
    from perfbench.reference.ops import crop

    def wrap(real):
        return lambda *a, **k: real(*a, **dict(k, antialias=False))

    with patched(crop, "scale_and_translate", wrap):
        yield


def readings(run, held) -> dict:
    """The three readings of the module's docstring, each the worst over the judged
    scenes."""
    from perfbench.judge import scene, scene_branches

    idx = scene.sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    ref = {k: (r, w) for k, r, w in scene.reference_scenes(run, held, idx)}
    out = {}
    for name, fault in (("control", None), ("mantissa", reduced_mantissa),
                        ("paste_fault", paste_without_antialias)):
        with fault() if fault else contextlib.nullcontext():
            got = {k: r for k, r, _ in scene.reference_scenes(run, held, idx,
                                                              use_tf32=fault is None)}
        out[name] = scene.worst([
            scene_branches.compare(got[k], ref[k][0], scene.background(run, held, k),
                                   ref[k][1])
            for k in idx])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=10)
    p.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "calibrate_bf16.jsonl")
    args = p.parse_args(argv)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    cell = bench.load_cell(ROOT, args.workload)
    with args.out.open("a") as f:
        for i, seed in enumerate(args.seeds):
            t = time.perf_counter()
            run, entry, held = bench_run.drive(cell, seed, args.seconds, False, "cuda:0",
                                               t0=t)
            line = {"workload": args.workload, "seed": seed,
                    "program": entry.judge(run, held)}
            if i < args.controls:
                line.update(readings(run, held))
            line["seconds"] = time.perf_counter() - t
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
            del held
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
