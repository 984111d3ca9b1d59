"""Warm a serving process ahead of traffic.

Counterpart of the JAX package's cli/warmup.py (:24-172). A serving process pays for
three things once: compiling the CUDA kernels of ``csrc/`` (``nvcc``, seconds; the
library is then found on disk by every later process), the first CUDA work of the
process (context, cuDNN's choice of algorithms, the allocator's first blocks), and
the first scene at each shape. Run this once per deploy, or in the serving process
before it takes requests:

  python -m future_urban_scene_generation_tpu_torch.cli.warmup \\
      --frame-hw 1080 1920 --vehicles 4 8 --steps 6 \\
      [--generator-dtype bfloat16 --warp-plane-res 128] [--perception] [--device cuda]

For every requested vehicle bucket it runs the scene twice on seeded inputs (a 2-CAD
bank, seeded networks, a seeded frame) and prints the cold and the warm seconds, by
wall clock around ``torch.cuda.synchronize()``. Without ``--perception`` it runs
``synthesize_scene`` on projected keypoints; with it, ``run_scene`` (the hourglass and
the CAD classifier included). The service pads requests to buckets of 4, so warming
``--vehicles 4 8`` covers 1..8 selected vehicles.

``--device`` defaults to ``cuda``; a missing GPU is an error. ``--cache-dir`` parses
and is ignored (there is no compile cache to fill: the kernel library is the only
compiled artifact and has its own place), ``--export-aot`` exits 2 (ahead-of-time
scene programs wait in ROADMAP.md queue 1, S10).
"""
from __future__ import annotations

import argparse
import math
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--frame-hw", type=int, nargs=2, default=[1080, 1920])
    p.add_argument("--vehicles", type=int, nargs="+", default=[4])
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--vis-res", type=int, default=192)
    p.add_argument("--generator-dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--warp-plane-res", type=int, default=128)
    p.add_argument("--cache-dir", default=None, help="accepted and ignored")
    p.add_argument("--perception", action="store_true",
                   help="warm run_scene (hourglass + VGG perception path) instead of "
                        "synthesize_scene on given keypoints")
    p.add_argument("--export-aot", metavar="DIR", default=None,
                   help="ahead-of-time scene programs (not ported)")
    p.add_argument("--device", default="cuda")
    return p


def _bucket_inputs(v, t_steps, k_mat, kp3d0):
    """Boxes, projected keypoints and straight tracks of ``v`` vehicles standing in
    the camera's view (the JAX warmer's placement)."""
    import numpy as np
    import torch

    from future_urban_scene_generation_tpu_torch.geometry.projection import (
        project_points_extrinsic,
    )
    from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot

    kp2ds, bboxes = [], []
    for i in range(v):
        ext = torch.eye(4)
        ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.4 + 0.2 * i))
        ext[:3, 3] = torch.tensor([-6.0 + 3 * (i % 5), 2.0, 25.0 + 3 * i])
        kp2d = project_points_extrinsic(kp3d0, torch.as_tensor(k_mat), ext).numpy()
        kp2ds.append(kp2d)
        x0, y0 = kp2d.min(0)
        x1, y1 = kp2d.max(0)
        bboxes.append([x0 - 5, y0 - 5, x1 + 5, y1 + 5])
    t = np.linspace(0, 6.0, t_steps)
    meters = np.stack([np.stack([t, np.zeros_like(t)], -1)] * v)
    return np.float32(bboxes), np.float32(np.stack(kp2ds)), np.float32(meters)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.export_aot is not None:
        print("--export-aot is not ported to PyTorch yet: ROADMAP.md queue 1, S10 (AOT).",
              file=sys.stderr)
        return 2
    if args.cache_dir is not None:
        print("--cache-dir is ignored: the port has no compile cache (the kernel "
              "library is built once under the package's _build/).", file=sys.stderr)

    import numpy as np
    import torch

    from future_urban_scene_generation_tpu_torch.ops import _kernels
    from future_urban_scene_generation_tpu_torch.ops import crop as cr
    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages
    from future_urban_scene_generation_tpu_torch.pipeline.service import resolve_device
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec
    from future_urban_scene_generation_tpu_torch.utils import mesh as mu

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if device.type == "cuda":
        _kernels.load()
        print(f"BUILD_SECONDS={_kernels.BUILD_SECONDS:.1f} "
              f"({'built' if _kernels.BUILD_SECONDS else 'found on disk'})")

    spec = ModelSpec(generator_dtype=args.generator_dtype,
                     warp_plane_res=args.warp_plane_res)
    h, w = args.frame_hw
    k_mat = np.array([[1400.0, 0, w / 2], [0, 1400.0, h / 2], [0, 0, 1]], np.float32)
    mesh, kp3d = mu.make_test_car(subdiv=3)
    cad_bank = runner.build_cad_bank([mesh] * 2, [kp3d] * 2, scale=5.0, device=device)
    rng = np.random.RandomState(0)
    frame = torch.as_tensor(rng.rand(h, w, 3).astype(np.float32)).to(device)
    background = torch.as_tensor(rng.rand(h, w, 3).astype(np.float32)).to(device)
    intrinsic = torch.as_tensor(k_mat).to(device)
    models = stages.Models.build(spec, torch.Generator().manual_seed(0), device=device)
    kp3d0 = cad_bank.keypoints3d[0].cpu()

    for v in args.vehicles:
        bboxes, kp2ds, meters = (torch.as_tensor(a).to(device)
                                 for a in _bucket_inputs(v, args.steps, k_mat, kp3d0))

        def scene():
            if args.perception:
                return runner.run_scene(models, cad_bank, frame, background, bboxes, meters,
                                        intrinsic, spec=spec, vis_res=args.vis_res)
            with torch.no_grad():
                window = cr.square_window_from_bbox(bboxes)
                perception = stages.Perception(
                    cad_idx=torch.zeros(v, dtype=torch.long, device=device),
                    kp_frame=kp2ds, window=window,
                    crop=cr.crop_resize(frame, window, 256),
                )
            return runner.synthesize_scene(models, cad_bank, frame, background, perception,
                                           meters, intrinsic, spec=spec,
                                           vis_res=args.vis_res)

        seconds = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            out = scene()
            sync()
            seconds.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out.frames_icn.float()).all()):
            print(f"warm-up scene V={v} is not finite", file=sys.stderr)
            return 1
        print(f"warmed V={v} ({h}x{w}, steps={args.steps}, {args.generator_dtype}, "
              f"warp={args.warp_plane_res}, "
              f"{'run_scene' if args.perception else 'synthesize_scene'}) "
              f"cold {seconds[0]:.2f}s warm {seconds[1]:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
