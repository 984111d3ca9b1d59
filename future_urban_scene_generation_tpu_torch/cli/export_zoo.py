"""Export training runs of the PyTorch port into the reference's checkpoint tree.

Counterpart of the JAX package's tools/export_zoo.py (:27-95). Each run is a
``cli.train --out`` directory; its ``checkpoint.pt`` holds the trained network
under the reference's state-dict names (``["gen"]`` for the GAN families,
``["module"]`` for the others), so exporting is writing that state dict to the
family's file of ``checkpoint.ZOO_FILES``: ``kpoints/hourglass.pth``,
``icn/256_synth/gnet_00020.pth``, ``vunet/256/vunet.pth``, ``cads/model.pth`` (the
classifier's ``features.*`` and ``classifier.*`` keys as they are) and
``inpainting/{EdgeModel,InpaintingModel}_gen.pth`` (wrapped as ``{"iteration",
"generator"}``, edgeconnect/models.py:20-41). ``checkpoint.load_reference_model_zoo``
serves them back.

The edge generator's spectral-norm triples are written as trained (W, u, v), so
the served, folded weight is torch's eval-mode weight of the trained network. (The
JAX exporter writes its raw kernel with a u, v of sigma 1: fault F8 of ROADMAP.md.)

    python -m future_urban_scene_generation_tpu_torch.cli.export_zoo \\
        --runs edge=<dir> inpaint=<dir> ... --out <checkpoints_dir>
"""
from __future__ import annotations

import argparse
from pathlib import Path

GAN_FAMILIES = ("icn", "edge", "inpaint")
WRAP_GENERATOR = ("edge", "inpaint")


def export_run(model: str, run_dir, checkpoints_dir) -> Path:
    """Write the network of the ``cli.train`` run in ``run_dir`` to the zoo file of
    ``model`` under ``checkpoints_dir``; returns the file's path."""
    import torch

    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint

    saved = torch.load(Path(run_dir) / "checkpoint.pt", map_location="cpu",
                       weights_only=True)
    sd = saved["gen" if model in GAN_FAMILIES else "module"]
    dest = checkpoint.zoo_path(checkpoints_dir, model)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if model in WRAP_GENERATOR:
        torch.save({"iteration": int(saved["iteration"]), "generator": sd}, dest)
    else:
        torch.save(sd, dest)
    return dest


def main(argv=None):
    from future_urban_scene_generation_tpu_torch.cli.train import FAMILIES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", nargs="+", metavar="MODEL=DIR", required=True,
                    help="model=train-run-dir pairs; models: " + ",".join(FAMILIES))
    ap.add_argument("--out", type=Path, required=True,
                    help="checkpoint tree root to write (the reference's layout)")
    args = ap.parse_args(argv)
    for pair in args.runs:
        model, _, run = pair.partition("=")
        if model not in FAMILIES:
            ap.error(f"unknown model {model!r}; choose from {', '.join(FAMILIES)}")
        print(f"exported {model}: {export_run(model, run, args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
