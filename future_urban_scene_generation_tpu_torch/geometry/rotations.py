"""Rotation math: axis rotations, Rodrigues axis-angle <-> matrix, extrinsics.

Counterpart of the JAX package's geometry/rotations.py. Every function takes any
leading batch dims; ``rodrigues_to_matrix`` is what the PnP Jacobian differentiates
through (``torch.func.jacfwd``).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _rot(c, s, rows):
    one = torch.ones_like(c)
    zero = torch.zeros_like(c)
    vals = {"c": c, "s": s, "-s": -s, "1": one, "0": zero}
    return torch.stack(
        [torch.stack([vals[k] for k in row], -1) for row in rows], -2
    )


def x_rot(alpha):
    """Counter-clockwise rotation about X, (..., 3, 3)."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    return _rot(c, s, (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))


def y_rot(alpha, clockwise: bool = False):
    """Rotation about Y, counter-clockwise unless ``clockwise`` (JAX :30), (..., 3, 3)."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    s = -s if clockwise else s
    return _rot(c, s, (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))


def z_rot(alpha):
    """Counter-clockwise rotation about Z, (..., 3, 3)."""
    c, s = torch.cos(alpha), torch.sin(alpha)
    return _rot(c, s, (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))


def _skew(v):
    zero = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], zero, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], zero], -1),
        ],
        -2,
    )


def rodrigues_to_matrix(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3):
    R = I cos(t) + (1 - cos(t)) u u^T + [u]_x sin(t), first order below 1e-8."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)
    safe_theta = torch.clamp(theta, min=_EPS)
    u = rvec / safe_theta[..., None]
    cross = _skew(u)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    r_mat = eye * c + (1.0 - c) * (u[..., :, None] * u[..., None, :]) + cross * s
    first_order = eye + _skew(rvec)
    return torch.where((theta < 1e-8)[..., None, None], first_order, r_mat)


def matrix_to_rodrigues(r_mat):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), cv2.Rodrigues conventions."""
    trace = r_mat[..., 0, 0] + r_mat[..., 1, 1] + r_mat[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    axis_unnorm = torch.stack(
        [
            r_mat[..., 2, 1] - r_mat[..., 1, 2],
            r_mat[..., 0, 2] - r_mat[..., 2, 0],
            r_mat[..., 1, 0] - r_mat[..., 0, 1],
        ],
        -1,
    )
    sin_theta = torch.sin(theta)
    generic = axis_unnorm / torch.clamp(2.0 * sin_theta, min=_EPS)[..., None] * theta[..., None]

    diag = torch.diagonal(r_mat, dim1=-2, dim2=-1)
    uu = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    u_abs = torch.sqrt(uu)
    k = torch.argmax(u_abs, dim=-1)
    s01 = torch.sign(r_mat[..., 0, 1] + r_mat[..., 1, 0])
    s02 = torch.sign(r_mat[..., 0, 2] + r_mat[..., 2, 0])
    s12 = torch.sign(r_mat[..., 1, 2] + r_mat[..., 2, 1])
    one = torch.ones_like(s01)
    signs_by_k = torch.stack(
        [
            torch.stack([one, s01, s02], -1),
            torch.stack([s01, one, s12], -1),
            torch.stack([s02, s12, one], -1),
        ],
        -2,
    )  # (..., 3 k, 3)
    signs = torch.gather(
        signs_by_k, -2, k[..., None, None].expand(k.shape + (1, 3))
    )[..., 0, :]
    signs = torch.where(signs == 0.0, torch.ones_like(signs), signs)
    near_pi = u_abs * signs * theta[..., None]

    near_zero = (torch.abs(theta) < 1e-7)[..., None]
    is_near_pi = (torch.abs(theta - math.pi) < 1e-5)[..., None]
    return torch.where(
        near_zero, torch.zeros_like(generic), torch.where(is_near_pi, near_pi, generic)
    )


def extrinsic_from_rodrigues(rvec, tvec):
    """(..., 4, 4) camera extrinsic from Rodrigues r (..., 3) and translation t."""
    r_mat = rodrigues_to_matrix(rvec)
    top = torch.cat([r_mat, tvec[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def delta_t_vec(axis: str, t_value):
    """Translation vector along a named axis (JAX :166; utils/geometry.py:140-144)."""
    out = torch.zeros(3)
    out[{"x": 0, "y": 1, "z": 2}[axis]] = t_value
    return out


def intrinsic_matrix(focal, cx, cy):
    """Square-pixel zero-skew K (JAX :172; utils/geometry.py:116-127), float32."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32)

    f = f32(focal)
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, zero, f32(cx)]), torch.stack([zero, f, f32(cy)]),
                        torch.stack([zero, zero, one])])


def rotmat_to_az_el_radius(camera_coords):
    """Camera position (3,) -> (azimuth deg, elevation deg, radius), the angles wrapped
    to [0, 360) (JAX :186; utils/geometry.py:147-161)."""
    tx, ty, tz = camera_coords[0], camera_coords[1], camera_coords[2]
    azimuth = torch.rad2deg(torch.atan2(tx, tz))
    proj = torch.stack([tx, torch.zeros_like(ty), tz])
    cam_n = camera_coords / torch.linalg.vector_norm(camera_coords)
    proj_n = proj / torch.clamp(torch.linalg.vector_norm(proj), min=1e-12)
    elevation = torch.rad2deg(torch.arccos(torch.clamp(torch.dot(cam_n, proj_n), -1.0, 1.0)))
    return (torch.remainder(azimuth, 360.0), torch.remainder(elevation, 360.0),
            torch.linalg.vector_norm(camera_coords))
