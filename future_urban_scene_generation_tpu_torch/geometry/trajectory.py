"""Future-pose rollout from metric ground-plane trajectories.

Counterpart of the JAX package's geometry/trajectory.py ``rollout_from_meters``
(:28), batched over vehicles: heading from the mean future delta, per-step distance
and relative heading, and the +-20 degree jitter clamp on the translation heading.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from future_urban_scene_generation_tpu_torch.geometry.rotations import z_rot


class Rollout(NamedTuple):
    theta: torch.Tensor  # (V, S) heading change per future step (unclamped)
    translation: torch.Tensor  # (V, S, 3)
    distance: torch.Tensor  # (V, S)
    theta_start: torch.Tensor  # (V,)


def rollout_from_meters(meter_coords: torch.Tensor) -> Rollout:
    """Per-step (theta, translation) from (V, T, 2) metric trajectories."""
    t = meter_coords.shape[1]
    dev = meter_coords.device
    start = meter_coords[:, 0]
    deltas = meter_coords[:, 1:] - start[:, None]
    theta_start = torch.atan2(deltas[..., 1].mean(-1), deltas[..., 0].mean(-1))

    distance = torch.linalg.vector_norm(deltas, dim=-1)
    theta = torch.atan2(deltas[..., 1], deltas[..., 0]) - theta_start[:, None]

    seg = meter_coords[:, 1:] - meter_coords[:, :-1]
    seg_theta = torch.rad2deg(torch.atan2(seg[..., 1], seg[..., 0]))
    nxt_theta = torch.cat([seg_theta[:, 1:], seg_theta[:, -1:]], dim=1)
    theta_diff = seg_theta - nxt_theta

    n_idx = torch.arange(1, t, device=dev)
    interior = (n_idx > 1) & (n_idx < (t - 1) - 1)
    smooth_interior = (theta_diff > -20.0) & (theta_diff < 20.0)
    deg_theta = torch.rad2deg(theta)
    smooth_boundary = (deg_theta > -20.0) & (deg_theta < 20.0)
    use_theta = torch.where(interior, smooth_interior, smooth_boundary)
    theta_tr = torch.where(use_theta, theta, torch.zeros_like(theta))

    rots = z_rot(theta_tr)  # (V, S, 3, 3)
    zero = torch.zeros_like(distance)
    delta_t = torch.stack([zero, -distance, zero], dim=-1)
    translation = torch.einsum("vsi,vsij->vsj", delta_t, rots)
    return Rollout(theta, translation, distance, theta_start)


def transform_points(points: torch.Tensor, theta: torch.Tensor, translation: torch.Tensor):
    """The reference's per-step rigid motion p @ z_rot(theta) + tr (JAX :70;
    trajectory_inference.py:362-363); broadcasts over a leading step axis."""
    return points @ z_rot(theta) + translation
