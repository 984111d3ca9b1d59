"""Frozen copy of ``future_urban_scene_generation_tpu_torch/render/visibility.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Texture-plane topology and painter's-algorithm plane visibility, batched.

Counterpart of the JAX package's render/visibility.py (``plane_polygons_2d`` :56,
``compute_visibility_local`` :69, ``compute_visibility`` :98,
``_demote_covisible_pairs`` :127).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.ops.polygon import fill_polygon

# Keypoint indices per plane: left, right, roof, front, back; 4-gons padded to 6.
TEXTURE_PLANES = np.array(
    [
        [0, 1, 3, 2, 9, 8],  # left
        [4, 5, 7, 6, 11, 10],  # right
        [8, 9, 11, 10, 10, 10],  # roof
        [2, 6, 11, 9, 9, 9],  # front
        [0, 4, 10, 8, 8, 8],  # back
    ],
    dtype=np.int64,
)
OCCLUSION_PLANES = np.array(
    [
        [2, 6, 7, 3, 3, 3],  # front_bt
        [0, 4, 5, 1, 1, 1],  # back_bt
    ],
    dtype=np.int64,
)
ALL_PLANES = np.concatenate([TEXTURE_PLANES, OCCLUSION_PLANES], axis=0)  # (7, 6)
SYMMETRY_PAIR = (0, 1)
OPPOSITE_PAIR = (3, 4)
NUM_TEXTURE_PLANES = TEXTURE_PLANES.shape[0]


def plane_polygons_2d(kpoints_2d, planes_idx=ALL_PLANES):
    """(..., P, 6, 2) plane polygons gathered from (..., 12, 2) keypoints (JAX :56)."""
    return kpoints_2d[..., torch.as_tensor(planes_idx, device=kpoints_2d.device), :]


def camera_plane_distances(extrinsic, kpoints_3d):
    """(B, 7) distances from each camera center to the plane keypoint centroids."""
    cam_pos = torch.linalg.inv_ex(extrinsic).inverse[:, :3, 3]
    idx = torch.as_tensor(ALL_PLANES, device=kpoints_3d.device)
    centroids = kpoints_3d[:, idx].mean(dim=2)  # (B, 7, 3)
    return torch.linalg.vector_norm(centroids - cam_pos[:, None], dim=-1)


def compute_visibility(extrinsic, kpoints_2d, kpoints_3d, hw):
    """Visibility of the 7 planes (B, 7) bool; kpoints_2d (B, 12, 2) in pixel
    coordinates of an (h, w) canvas, kpoints_3d (B, 12, 3)."""
    h, w = hw
    idx = torch.as_tensor(ALL_PLANES, device=kpoints_2d.device)
    polys = kpoints_2d[:, idx]  # (B, 7, 6, 2)
    masks = fill_polygon(polys, h, w)  # (B, 7, h, w)
    dists = camera_plane_distances(extrinsic, kpoints_3d)
    closer = dists[:, :, None] > dists[:, None, :]  # [b, p, q]: q closer than p
    occluders = torch.any(masks[:, None] & closer[..., None, None], dim=2)
    remaining = masks & ~occluders
    absolute_area = masks.sum(dim=(-1, -2))
    remaining_area = remaining.sum(dim=(-1, -2))
    return _demote_covisible_pairs(remaining_area > 0.9 * absolute_area, remaining_area)


def compute_visibility_local(extrinsic, kpoints_2d, kpoints_3d, res: int = 192):
    """Visibility rastered on a res^2 grid over each keypoint bbox (area ratios
    are affine-invariant, so this is the frame-resolution computation)."""
    lo = kpoints_2d.amin(dim=1, keepdim=True)
    hi = kpoints_2d.amax(dim=1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-3)
    scale = (res - 2.0) / span
    kp_local = (kpoints_2d - lo) * scale + 1.0
    return compute_visibility(extrinsic, kp_local, kpoints_3d, (res, res))


def _demote_covisible_pairs(vis, remaining_area):
    """At most one of (left, right) and one of (front, back) stays visible: the
    face with more unoccluded area wins when both pass the 0.9 rule."""
    vis = vis.clone()
    for a, b in (SYMMETRY_PAIR, OPPOSITE_PAIR):
        both = vis[:, a] & vis[:, b]
        keep_a = remaining_area[:, a] >= remaining_area[:, b]
        va = vis[:, a] & ~(both & ~keep_a)
        vb = vis[:, b] & ~(both & keep_a)
        vis[:, a] = va
        vis[:, b] = vb
    return vis
