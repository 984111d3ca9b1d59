"""Frozen copy of ``future_urban_scene_generation_tpu_torch/geometry/projection.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Pinhole projection (counterpart of the JAX package's geometry/projection.py)."""
from __future__ import annotations

from perfbench.reference.geometry.rotations import rodrigues_to_matrix


def project_points_extrinsic(points_3d, intrinsic, extrinsic):
    """Project (..., N, 3) world points with K (3, 3) and extrinsic (..., 3|4, 4)
    -> (..., N, 2)."""
    ext = extrinsic[..., :3, :]
    cam = points_3d @ ext[..., :3].transpose(-1, -2) + ext[..., None, :, 3]
    proj = cam @ intrinsic.transpose(-1, -2)
    return proj[..., :2] / proj[..., 2:3]


def project_normalized(points_3d, rvec, tvec, focals, centers):
    """Projection parameterized by (fx, fy) and (cx, cy) — the PnP residual's form
    (reference utils/cpc.py:92-94). points (..., N, 3), rvec/tvec (..., 3)."""
    r_mat = rodrigues_to_matrix(rvec)
    cam = points_3d @ r_mat.transpose(-1, -2) + tvec[..., None, :]
    return focals * cam[..., :2] / cam[..., 2:3] + centers


def project_points_rodrigues(points_3d, rvec, tvec, intrinsic):
    """cv2.projectPoints without distortion (JAX :21): (N, 3) -> (N, 2)."""
    r_mat = rodrigues_to_matrix(rvec.reshape(3))
    cam = points_3d @ r_mat.T + tvec.reshape(3)
    proj = cam @ intrinsic.T
    return proj[..., :2] / proj[..., 2:3]
