"""Training CLI of the PyTorch port.

Counterpart of the JAX package's cli/train.py (:25-93, 233-238): trains a model
family on the synthetic on-device pairs of ``pipeline/datagen.py``, logs metrics as
JSONL (``<out>/metrics.jsonl``) and checkpoints the whole train state
(``<out>/checkpoint.pt``).

  python -m future_urban_scene_generation_tpu_torch.cli.train \\
      --model icn --steps 200 --batch 8 --out /tmp/icn_run \\
      [--resume] [--save-interval 100] [--log-interval 10] [--device cuda]

The ICN family is ported: the full-width Warp&Learn generator (its 7x7 stem conv on
kernel K3) against the multi-scale PatchGAN, on the JAX CLI's bank and frame
(two ``make_test_car(subdiv=2)`` CADs at scale 5, a seeded 360x640 frame, f = 450,
visibility on a 192^2 grid). The other families (vunet, edge, inpaint, hourglass,
cad) are still to port and are refused. ``--device`` defaults to ``cuda``; a
missing GPU is an error, never a silent move to the CPU. TF32 stays off.
"""
from __future__ import annotations

import argparse
from pathlib import Path

FAMILIES = ("icn", "vunet", "edge", "inpaint", "hourglass", "cad")
PORTED = ("icn",)
FRAME_HW = (360, 640)


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
                   help="training crop side; the ICN pairs are 256x256 sketch crops")
    p.add_argument("--device", default="cuda")
    return p


def icn_setup(seed: int, device):
    """The ICN family's data source, as the JAX CLI builds it: a seeded
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


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.model not in PORTED:
        parser.error(f"--model {args.model} is not ported to PyTorch yet (ported: "
                     f"{', '.join(PORTED)}; the remaining trainers wait in ROADMAP.md queue 1, "
                     "S9, the EdgeConnect ones with the inpaint branch, S7)")
    if args.image_size != 256:
        parser.error("--image-size: the ICN pairs are 256x256 sketch crops")

    import torch

    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, datagen, training
    from future_urban_scene_generation_tpu_torch.utils.profiling import MetricsLogger

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cli.train: --device cuda but no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    args.out.mkdir(parents=True, exist_ok=True)
    logger = MetricsLogger(args.out / "metrics.jsonl")
    generator, cad_bank, frame, intrinsic = icn_setup(args.seed, device)
    ckpt_path = args.out / "checkpoint.pt"

    trainer = training.ICNTrainer(lr=args.lr)
    state = trainer.init(generator, device=device)
    if args.resume and ckpt_path.exists():
        checkpoint.restore(ckpt_path, state)
    for i in range(state.iteration, args.steps):
        with torch.no_grad():
            sample = datagen.icn_batch(generator, cad_bank, frame, intrinsic,
                                       batch=args.batch, vis_res=192)
        state, metrics = trainer.train_step(state, sample.inputs, sample.targets)
        if args.log_interval and i % args.log_interval == 0:
            print(logger.log(i, **{k: float(v) for k, v in metrics.items()}))
        if args.save_interval and (i + 1) % args.save_interval == 0:
            checkpoint.save(ckpt_path, state)

    print(f"trained {args.model} for {args.steps} steps; artifacts in {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
