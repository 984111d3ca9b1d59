"""The benchmark scene: a synthetic frame with V vehicles, a 10-CAD bank and
random-init networks, all made from a seed.

Mirrors the JAX package's ``bench.py`` ``setup_scene`` (:32-150) with the port's own
seeded init: ten procedural cars at Pascal3D+ density (``make_test_car(subdiv=9)``,
1,944 triangles each), vehicles at staggered poses with bboxes from their projected
keypoints, straight trajectories fanning out by 0.2 rad per vehicle.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
from future_urban_scene_generation_tpu_torch.pipeline import runner
from future_urban_scene_generation_tpu_torch.pipeline.stages import CadBank, Models
from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC, ModelSpec
from future_urban_scene_generation_tpu_torch.utils import mesh as mu


class BenchScene(NamedTuple):
    models: Models
    cad_bank: CadBank
    frame: torch.Tensor  # (H, W, 3)
    background: torch.Tensor  # (H, W, 3)
    bboxes: torch.Tensor  # (V, 4)
    meters: torch.Tensor  # (V, T, 2)
    intrinsic: torch.Tensor  # (3, 3)
    spec: ModelSpec


def make_bench_scene(V: int = 4, hw=(1080, 1920), t_steps: int = 6, *, device,
                     seed: int = 0, spec: ModelSpec = SERVING_SPEC, subdiv: int = 9,
                     with_models: bool = True) -> BenchScene:
    """Build the scene's inputs and random-init models on ``device``
    (``with_models=False``: geometry only, ``models`` is None)."""
    h, w = hw
    k = np.array([[1400.0, 0, w / 2], [0, 1400.0, h / 2], [0, 0, 1]], dtype=np.float32)
    meshes_kps = [
        mu.make_test_car(
            length=1.0 + 0.05 * i, width=0.42 + 0.015 * (i % 3),
            height=0.30 + 0.01 * (i % 4), subdiv=subdiv,
        )
        for i in range(spec.num_cads)
    ]
    cad_bank = runner.build_cad_bank(
        [m for m, _ in meshes_kps], [kp for _, kp in meshes_kps], scale=5.0, device=device
    )

    rng = np.random.RandomState(seed)
    frame = rng.rand(h, w, 3).astype(np.float32)
    background = rng.rand(h, w, 3).astype(np.float32)

    bboxes = []
    kp3d0 = cad_bank.keypoints3d[0].cpu()
    for v in range(V):
        ext = torch.eye(4)
        ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.4 + 0.3 * v))
        ext[:3, 3] = torch.tensor(
            [-6.0 + 4 * (v % 4), 2.0, 25.0 + 3 * (v % 4) + 0.7 * (v // 4)]
        )
        kp2d = project_points_extrinsic(kp3d0, torch.as_tensor(k), ext).numpy()
        x0, y0 = kp2d.min(0)
        x1, y1 = kp2d.max(0)
        bboxes.append([x0 - 5, y0 - 5, x1 + 5, y1 + 5])

    t = np.linspace(0, 6.0, t_steps)
    meters = np.stack(
        [np.stack([t * np.cos(0.2 * v), t * np.sin(0.2 * v)], -1) for v in range(V)]
    )
    models = None
    if with_models:
        models = Models.build(spec, torch.Generator().manual_seed(seed), device=device)

    def dev(a):
        return torch.as_tensor(np.float32(a), device=device)

    return BenchScene(
        models=models, cad_bank=cad_bank, frame=dev(frame),
        background=dev(background), bboxes=dev(bboxes), meters=dev(meters),
        intrinsic=dev(k), spec=spec,
    )


def make_oracle_scene(hw=(240, 320), subdiv: int = 2, with_bad_vehicle: bool = True):
    """A small scene whose perception is known: a test car rendered at a fixed
    pose into a gradient background, its projected keypoints as the oracle, and a
    straight 3-point trajectory; optionally a second vehicle with NaN keypoints, a
    degenerate bbox and a NaN trajectory (the fault barrier must drop it).

    Returns a dict of numpy arrays (frame, background, intrinsic, extrinsic, kp2d
    (V, 12, 2), bboxes (V, 4), meters (V, 3, 2)) plus the mesh and its keypoints,
    so the same inputs can drive any implementation of the pipeline."""
    h, w = hw
    k = np.array([[300.0, 0, w / 2], [0, 300.0, h / 2], [0, 0, 1]], dtype=np.float32)
    mesh, kp3d = mu.make_test_car(subdiv=subdiv)
    bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device="cpu")
    ext = torch.eye(4)
    ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.5))
    ext[:3, 3] = torch.tensor([0.0, 2.0, 18.0])

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    background = np.stack([xx / w, yy / h, 0.5 * np.ones_like(xx)], -1)
    from future_urban_scene_generation_tpu_torch.render import rasterizer as rz

    cam = rz.Camera(*(f.reshape(1) for f in rz.Camera.from_intrinsic(torch.as_tensor(k))))
    sketch, bg = rz.render_normal_sketch_corners(
        bank.corners[:1], bank.corner_normals[:1], ext[None], cam, (h, w)
    )
    frame = np.where(bg[0].numpy()[..., None], background, sketch[0].numpy())
    frame = frame.astype(np.float32)
    kp2d = project_points_extrinsic(bank.keypoints3d[0], torch.as_tensor(k), ext).numpy()
    ys, xs = np.nonzero(~bg[0].numpy())
    bbox = np.float32([xs.min(), ys.min(), xs.max(), ys.max()])
    t = np.linspace(0, 2.4, 3)
    meters = np.stack([t, np.zeros_like(t)], -1)[None].astype(np.float32)
    kp2d, bboxes = kp2d[None].astype(np.float32), bbox[None]
    if with_bad_vehicle:
        kp2d = np.concatenate([kp2d, np.full((1, 12, 2), np.nan, np.float32)])
        bboxes = np.concatenate([bboxes, np.float32([[5.0, 5.0, 5.0, 5.0]])])
        meters = np.concatenate([meters, np.full_like(meters, np.nan)])
    return dict(
        frame=frame, background=background.astype(np.float32), intrinsic=k,
        extrinsic=ext.numpy(), kp2d=kp2d, bboxes=bboxes, meters=meters,
        mesh=mesh, kp3d=kp3d,
    )


def oracle_perception(scene: dict, *, device):
    """The port's Perception for :func:`make_oracle_scene` (CAD 0, oracle
    keypoints; crops of the bboxes' windows, zero for a degenerate bbox)."""
    from future_urban_scene_generation_tpu_torch.ops import crop as cr
    from future_urban_scene_generation_tpu_torch.pipeline.stages import Perception

    frame = torch.as_tensor(scene["frame"], device=device)
    bboxes = torch.as_tensor(scene["bboxes"], device=device)
    window = cr.square_window_from_bbox(bboxes)
    crop = cr.crop_resize(frame, window, 256)
    crop = torch.where((window.w > 1.0)[:, None, None, None], crop, torch.zeros_like(crop))
    v = bboxes.shape[0]
    return Perception(
        cad_idx=torch.zeros(v, dtype=torch.long, device=device),
        kp_frame=torch.as_tensor(scene["kp2d"], device=device),
        window=window,
        crop=crop,
    )
