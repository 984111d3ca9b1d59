"""Synthetic ICN training pairs, made on the device from the pipeline's own geometry.

Counterpart of the JAX package's pipeline/datagen.py ``_random_pose`` (:55),
``_vehicle_views`` (:65) and ``icn_batch`` (:91). The JAX version draws from a key
inside a vmapped function; here the work is split in two:

* :func:`icn_draws` — the random draws from an explicit ``torch.Generator`` (CAD
  index, yaw U(0, 2 pi), tilt U(-1.45, -1.1), distance U(12, 28), heading delta
  U(-0.6, 0.6)), made on the CPU;
* :func:`icn_pairs` — the deterministic pair maker, batched over B: the src and
  dst views of every sample in one kernel-K1 render, visibility, plane polygons,
  the src sketch pasted into the frame as texture, the per-sample source table
  (as ``runner.scene_geometry`` builds it) and the plane warps.

A test can therefore feed the JAX package's own draws to the pair maker.
Samples are float32 NHWC in signed LAB ([-1, 1]):
x = [dst sketch (3) | central prior (3) | 5 warped planes (15)], y = the dst view
of the textured vehicle, masked.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.pipeline.stages import CadBank
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.spec import ModelSpec


class ICNSample(NamedTuple):
    inputs: torch.Tensor  # (B, 256, 256, 21) signed LAB
    targets: torch.Tensor  # (B, 256, 256, 3) signed LAB


class ICNDraws(NamedTuple):
    cad_idx: torch.Tensor  # (B,) int64 CAD-bank index
    extrinsic: torch.Tensor  # (B, 4, 4) camera pose of the src view
    dtheta: torch.Tensor  # (B,) heading change from the src to the dst view


def _random_pose(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B, 4, 4) extrinsics: R = x_rot(tilt) @ z_rot(yaw), t = (0, 1, dist)."""
    yaw = torch.rand(batch, generator=generator) * (2.0 * math.pi)
    tilt = torch.rand(batch, generator=generator) * 0.35 - 1.45
    dist = torch.rand(batch, generator=generator) * 16.0 + 12.0
    ext = torch.eye(4).repeat(batch, 1, 1)
    ext[:, :3, :3] = x_rot(tilt) @ z_rot(yaw)
    ext[:, 1, 3] = 1.0
    ext[:, 2, 3] = dist
    return ext


def icn_draws(generator: torch.Generator, n_cads: int, batch: int) -> ICNDraws:
    """The random part of an ICN batch, on the CPU."""
    cad_idx = torch.randint(0, n_cads, (batch,), generator=generator)
    ext = _random_pose(generator, batch)
    dtheta = torch.rand(batch, generator=generator) * 1.2 - 0.6
    return ICNDraws(cad_idx, ext, dtheta)


def _vehicle_views(cad_bank: CadBank, intrinsic, draws: ICNDraws, vis_res: int):
    """Render the src (heading 0) and dst (heading dtheta) views of every sample in
    one launch. Returns (src, dst), each (sketch, mask, window, visibility (B, 5),
    plane polygons (B, 5, 6, 2))."""
    b = draws.cad_idx.shape[0]
    idx = torch.cat([draws.cad_idx, draws.cad_idx])
    ext = torch.cat([draws.extrinsic, draws.extrinsic])
    theta = torch.cat([torch.zeros_like(draws.dtheta), draws.dtheta])
    sketch, mask, window = stages.render_vehicle(
        cad_bank.vertices[idx], cad_bank.corners[idx], cad_bank.corner_normals[idx],
        ext, intrinsic, theta, torch.zeros(2 * b, 3, device=theta.device),
    )
    kp3d_s = cad_bank.keypoints3d[idx] @ z_rot(theta)
    kp2d_s = project_points_extrinsic(kp3d_s, intrinsic, ext)
    visibility = vis.compute_visibility_local(ext, kp2d_s, kp3d_s, res=vis_res)[:, :5]
    polys = torch.trunc(kp2d_s)[:, torch.as_tensor(vis.TEXTURE_PLANES, device=ext.device)]
    views = (sketch, mask, window, visibility, polys)

    def part(sl):
        return tuple(v.map(lambda f: f[sl]) if isinstance(v, cr.Window) else v[sl]
                     for v in views)

    return part(slice(0, b)), part(slice(b, 2 * b))


def icn_pairs(cad_bank: CadBank, frame, intrinsic, draws: ICNDraws, *,
              vis_res: int = 192) -> ICNSample:
    """Self-supervised ICN pairs for given draws: the src sketch pasted onto
    ``frame`` (H, W, 3) is the vehicle's texture, and the target is the dst view of
    the same textured vehicle. Everything runs on ``frame``'s device. The plane warps
    use the default ``ModelSpec`` (256² sampling), as the JAX datagen reads the
    default ``MODEL_SPEC``."""
    dev = frame.device
    draws = ICNDraws(*(t.to(dev) for t in draws))
    b = draws.cad_idx.shape[0]
    src, dst = _vehicle_views(cad_bank, intrinsic, draws, vis_res)
    s_sk, s_mask, s_win, s_vis, s_polys = src
    d_sk, d_mask, d_win, d_vis, d_polys = dst
    textured = cr.stitch(frame, s_sk, s_win,
                         stages._mask_to_frame(s_mask, s_win, frame.shape[:2]))
    src_table = stages._to_signed_lab(cr.crop_resize(textured, s_win, stages.SRC_TABLE))
    planes = stages.warp_planes_to_crop(ModelSpec(), src_table, s_win, s_polys, d_polys,
                                        s_vis, d_vis, d_win, torch.arange(b, device=dev))
    central = stages._to_signed_lab(stages.central_crop_patch(textured, s_win))
    res = planes.shape[2]
    planes_lab = planes.permute(0, 2, 3, 1, 4).reshape(b, res, res, -1)
    x = torch.cat([stages._to_signed_lab(d_sk), central, planes_lab], dim=-1)
    y = stages._to_signed_lab(d_sk * d_mask[..., None])
    return ICNSample(x, y)


def icn_batch(generator: torch.Generator, cad_bank: CadBank, frame, intrinsic,
              batch: int = 4, *, vis_res: int = 192) -> ICNSample:
    """A batch of ICN pairs: :func:`icn_draws` then :func:`icn_pairs`."""
    draws = icn_draws(generator, cad_bank.vertices.shape[0], batch)
    return icn_pairs(cad_bank, frame, intrinsic, draws, vis_res=vis_res)
