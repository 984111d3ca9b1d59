"""A visual demo of the pipeline on a synthetic scene (no external data).

Counterpart of the JAX package's examples/demo_synthetic.py (:16-89). Renders a test
car into a synthetic frame with the indexed-mesh renderer (``render_normal_sketch``,
kernel K1'), injects oracle keypoints, runs ``synthesize_scene`` and writes a strip
of the composited future frames, one row per generator branch. With random-weight
generators the synthesized texture is noise-like, but the strip shows the geometric
pipeline: pose recovery, trajectory rollout, sketch rendering and masked compositing.

  python -m future_urban_scene_generation_tpu_torch.examples.demo_synthetic \
      [out.png] [--device cuda]

``--device`` defaults to ``cuda``; a missing GPU is an error.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages
from future_urban_scene_generation_tpu_torch.pipeline.service import frames_to_uint8, resolve_device
from future_urban_scene_generation_tpu_torch.render import rasterizer as rz
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import mesh as mu
from future_urban_scene_generation_tpu_torch.utils.native import write_png

FRAME_HW = (360, 640)


def demo_camera(device, hw=FRAME_HW):
    """The demo's intrinsic (3, 3) (f = 450 px at 640 px of width) and the car's
    extrinsic (4, 4), on ``device``."""
    h, w = hw
    f = 450.0 * w / FRAME_HW[1]
    k = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], dtype=torch.float32)
    ext = torch.eye(4)
    ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.5))
    ext[:3, 3] = torch.tensor([0.0, 2.0, 20.0])
    return k.to(device), ext.to(device)


def demo_inputs(device, hw=FRAME_HW, subdiv: int = 2, steps: int = 6):
    """The demo's scene on ``device``: (cad_bank, frame, background, perception,
    meters, intrinsic). The frame is the car rendered by ``render_normal_sketch``
    over a gradient background; the perception carries the oracle keypoints."""
    h, w = hw
    k, ext = demo_camera(device, hw)
    mesh, kp3d = mu.make_test_car(subdiv=subdiv)
    cad_bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device=device)

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    background = torch.as_tensor(np.stack(
        [0.35 + 0.2 * yy / h, 0.4 + 0.15 * yy / h, 0.45 + 0.1 * xx / w], -1
    )).to(device)
    cam = rz.Camera(*(c.reshape(1) for c in rz.Camera.from_intrinsic(k)))
    sketch, bg_mask = rz.render_normal_sketch(
        cad_bank.vertices[:1], cad_bank.triangles[0], cad_bank.normals[:1],
        ext[None], cam, (h, w),
    )
    frame = torch.where(bg_mask[0, ..., None], background, sketch[0])

    kp2d = project_points_extrinsic(cad_bank.keypoints3d[0], k, ext)
    ys, xs = torch.nonzero(~bg_mask[0], as_tuple=True)
    bbox = torch.stack([xs.min(), ys.min(), xs.max(), ys.max()]).to(torch.float32)[None]
    window = cr.square_window_from_bbox(bbox)
    perception = stages.Perception(
        cad_idx=torch.zeros(1, dtype=torch.long, device=device),
        kp_frame=kp2d[None], window=window, crop=cr.crop_resize(frame, window, 256),
    )
    t = np.linspace(0, 5.0, steps)
    meters = torch.as_tensor(np.float32(np.stack([t, 0.15 * t ** 1.5], -1))[None]).to(device)
    return cad_bank, frame, background, perception, meters, k


def main(out_path="demo_strip.png", device="cuda", hw=FRAME_HW, subdiv: int = 2,
         steps: int = 6, spec: ModelSpec = ModelSpec(), seed: int = 0):
    """Run the demo on ``device`` and write the strip to ``out_path``. Returns
    (PnP reprojection error in px^2, the strip (2H, steps * W, 3) uint8)."""
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        cad_bank, frame, background, perception, meters, k = demo_inputs(
            device, hw, subdiv, steps)
        models = stages.Models.build(spec, torch.Generator().manual_seed(seed), device=device)
        result = runner.synthesize_scene(models, cad_bank, frame, background, perception,
                                         meters, k, spec=spec)
        pnp_error = float(result.pnp_error[0])
        print(f"PnP reprojection mse: {pnp_error:.4f}")
        rows = [torch.cat(list(frames_to_uint8(f)), dim=1)
                for f in (result.frames_icn, result.frames_vunet)]
        strip = torch.cat(rows, dim=0).cpu().numpy()
    write_png(out_path, strip)
    print(f"wrote {out_path} ({strip.shape[1]}x{strip.shape[0]})")
    return pnp_error, strip


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_path", nargs="?", default="demo_strip.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_path, args.device)
