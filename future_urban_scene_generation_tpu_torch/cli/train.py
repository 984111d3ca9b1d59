"""Training CLI of the PyTorch port.

Counterpart of the JAX package's cli/train.py (:25-200, 233-238): trains a model
family on the synthetic on-device pairs of ``pipeline/datagen.py``, logs metrics as
JSONL (``<out>/metrics.jsonl``) and checkpoints the whole train state
(``<out>/checkpoint.pt``).

  python -m future_urban_scene_generation_tpu_torch.cli.train \\
      --model icn --steps 200 --batch 8 --out /tmp/icn_run \\
      [--resume] [--save-interval 100] [--log-interval 10] [--device cuda]

Models: icn | vunet | hourglass | cad (edge and inpaint wait with the inpaint branch
and are refused).

* ``icn``: the full-width Warp&Learn generator (its 7x7 stem conv on kernel K3)
  against the multi-scale PatchGAN, on the JAX CLI's bank and frame (two
  ``make_test_car(subdiv=2)`` CADs at scale 5, a seeded 360x640 frame, f = 450,
  visibility on a 192^2 grid).
* ``vunet``: the VUNet on the same bank and frame (``vunet_256`` iff
  ``--image-size 256``; the pairs are 256^2, so another size is refused).
* ``hourglass``, ``cad``: sketch renders of a bank of 10 distinct car variants, with
  the projected keypoints as Gaussian target heatmaps (sigma 2 on the quarter-size
  map), or the bank index as the label; ``--image-size`` other than 256 resamples
  the renders linearly.

``--resume`` continues from the checkpoint's iteration up to ``--steps`` in every
family (the JAX CLI does so for its GAN families and runs ``--steps`` more for
these three; one rule here). The data stream restarts from ``--seed`` either way, as
in the JAX CLI. ``--device`` defaults to ``cuda``; a missing GPU is an error, never a
silent move to the CPU. TF32 stays off.
"""
from __future__ import annotations

import argparse
from pathlib import Path

FAMILIES = ("icn", "vunet", "edge", "inpaint", "hourglass", "cad")
PORTED = ("icn", "vunet", "hourglass", "cad")
FRAME_HW = (360, 640)
HEATMAP_SIGMA = 2.0


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, choices=FAMILIES)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", type=Path, default=Path("./train_run"))
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-interval", type=int, default=100)  # config.py:61
    p.add_argument("--log-interval", type=int, default=10)  # config.py:65
    p.add_argument("--seed", type=int, default=10)  # config.py:36
    p.add_argument("--image-size", type=int, default=256,
                   help="training crop side (hourglass, cad: the 256x256 renders are "
                        "resampled; icn, vunet: 256 only)")
    p.add_argument("--device", default="cuda")
    return p


def icn_setup(seed: int, device):
    """The ICN and VUNet families' data source, as the JAX CLI builds it: a seeded
    ``torch.Generator`` (then drawn on for the batches), the two-CAD bank, the
    360x640 frame and the f = 450 intrinsic, on ``device``."""
    import numpy as np
    import torch

    from future_urban_scene_generation_tpu_torch.pipeline.runner import build_cad_bank
    from future_urban_scene_generation_tpu_torch.utils.mesh import make_test_car

    generator = torch.Generator().manual_seed(seed)
    mesh, kp3d = make_test_car(subdiv=2)
    cad_bank = build_cad_bank([mesh] * 2, [kp3d] * 2, scale=5.0, device=device)
    intrinsic = torch.as_tensor(
        np.array([[450.0, 0, 320], [0, 450.0, 180], [0, 0, 1]], np.float32), device=device)
    frame = torch.rand(FRAME_HW + (3,), generator=generator).to(device)
    return generator, cad_bank, frame, intrinsic


def _variant_cad_bank(device):
    """10 geometrically distinct test-car variants: the classification and keypoint
    data bank, mirroring the reference's 10-CAD zoo (run_test.py:146-153) with the
    benchmark scene's staggering of the dimensions."""
    from future_urban_scene_generation_tpu_torch.pipeline.runner import build_cad_bank
    from future_urban_scene_generation_tpu_torch.utils.mesh import make_test_car

    meshes_kps = [
        make_test_car(length=1.0 + 0.05 * i, width=0.42 + 0.015 * (i % 3),
                      height=0.30 + 0.01 * (i % 4), subdiv=2)
        for i in range(10)
    ]
    return build_cad_bank([m for m, _ in meshes_kps], [k for _, k in meshes_kps],
                          scale=5.0, device=device)


def family_setup(model: str, *, seed: int, batch: int, lr: float, image_size: int, device):
    """(trainer, fresh train state, make_batch) of one family, where ``make_batch()``
    draws one batch from the family's seeded data source and returns the arguments
    of ``trainer.train_step`` after the state. The one place that says what each
    family trains on."""
    import torch

    from future_urban_scene_generation_tpu_torch.ops.heatmap import heatmaps_from_kpoints
    from future_urban_scene_generation_tpu_torch.ops.resize import resize_linear
    from future_urban_scene_generation_tpu_torch.pipeline import datagen, training

    generator, cad_bank, frame, intrinsic = icn_setup(seed, device)
    s = image_size

    if model == "icn":
        trainer = training.ICNTrainer(lr=lr)

        def make_batch():
            return tuple(datagen.icn_batch(generator, cad_bank, frame, intrinsic,
                                           batch=batch, vis_res=192))
    elif model == "vunet":
        trainer = training.VunetTrainer(vunet_256=s == 256, lr=lr)
        noise = torch.Generator(device=device).manual_seed(seed)

        def make_batch():
            return (noise, *datagen.vunet_batch(generator, cad_bank, frame, intrinsic,
                                                batch=batch))
    else:
        class_bank = _variant_cad_bank(device)
        if model == "hourglass":
            trainer = training.HourglassTrainer(lr=lr)

            def make_batch():
                sample = datagen.hourglass_batch(generator, class_bank, intrinsic, batch=batch)
                return (resize_linear(sample.images, (s, s)),
                        heatmaps_from_kpoints(sample.kp_norm, (s // 4, s // 4), HEATMAP_SIGMA))
        else:
            trainer = training.CadClassifierTrainer(lr=lr)

            def make_batch():
                sample = datagen.cad_batch(generator, class_bank, intrinsic, batch=batch)
                return resize_linear(sample.images, (s, s)), sample.labels

    return trainer, trainer.init(generator, device=device), torch.no_grad()(make_batch)


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model not in PORTED:
        parser.error(f"--model {args.model} is not ported to PyTorch yet (ported: "
                     f"{', '.join(PORTED)}; the EdgeConnect trainers wait in ROADMAP.md "
                     "queue 1, S9b, behind the inpaint branch, S7)")
    if args.image_size != 256 and args.model in ("icn", "vunet"):
        parser.error(f"--image-size: the {args.model} pairs are 256x256 sketch crops")

    import torch

    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint
    from future_urban_scene_generation_tpu_torch.utils.profiling import MetricsLogger

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cli.train: --device cuda but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    args.out.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(args.out / "metrics.jsonl")
    ckpt_path = args.out / "checkpoint.pt"
    trainer, state, make_batch = family_setup(
        args.model, seed=args.seed, batch=args.batch, lr=args.lr,
        image_size=args.image_size, device=device)
    if args.resume and ckpt_path.exists():
        checkpoint.restore(ckpt_path, state)
    for i in range(state.iteration, args.steps):
        state, metrics = trainer.train_step(state, *make_batch())
        if args.log_interval and i % args.log_interval == 0:
            print(logger.log(i, **{k: float(v) for k, v in metrics.items()}))
        if args.save_interval and (i + 1) % args.save_interval == 0:
            checkpoint.save(ckpt_path, state)

    print(f"trained {args.model} for {args.steps} steps; artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
