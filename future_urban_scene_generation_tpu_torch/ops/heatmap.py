"""Keypoint heatmap utilities (training-time counterparts of the decode path).

Counterpart of the JAX package's ops/heatmap.py. Parity targets:
utils/keypoint_utils.py:45-63 (the Gaussian target heatmaps the hourglass is trained
on), :95-100 (blend grids), :103-127 (colormap visualization, on the host). The
inference-side argmax decode is ``models/hourglass.decode_heatmaps``. The two target
makers work on tensors of any leading batch shape, on the keypoints' device.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS32 = float(torch.finfo(torch.float32).eps)


def kpoint_to_heatmap(kpoint: torch.Tensor, shape, sigma: float) -> torch.Tensor:
    """Unnormalized Gaussian heatmaps for [0, 1]^2 keypoints (..., 2) -> (..., H, W);
    zeros where the keypoint is missing (any coordinate <= 0),
    utils/keypoint_utils.py:45-56."""
    map_h, map_w = shape
    kpoint = kpoint.to(torch.float32)
    x = (kpoint[..., 0] * map_w)[..., None, None]
    y = (kpoint[..., 1] * map_h)[..., None, None]
    xs = torch.arange(map_w, dtype=torch.float32, device=kpoint.device)[None, :]
    ys = torch.arange(map_h, dtype=torch.float32, device=kpoint.device)[:, None]
    d2 = (xs - x) ** 2 + (ys - y) ** 2
    heat = torch.exp(-d2 / sigma ** 2)
    heat = heat / (torch.amax(heat, dim=(-2, -1), keepdim=True) + _EPS32)
    valid = torch.all(kpoint > 0, dim=-1)[..., None, None]
    return torch.where(valid, heat, torch.zeros_like(heat))


def heatmaps_from_kpoints(kpoints: torch.Tensor, shape, sigma: float) -> torch.Tensor:
    """(..., K, 2) normalized keypoints -> (..., H, W, K) target heatmaps
    (utils/keypoint_utils.py:59-63)."""
    return torch.movedim(kpoint_to_heatmap(kpoints, shape, sigma), -3, -1)


def random_blend_grid(true_blends, pred_blends):
    """Interleave true/pred visualization rows (utils/keypoint_utils.py:95-100)."""
    grid = []
    for t, p in zip(true_blends, pred_blends):
        grid.append(np.concatenate(t, axis=1))
        grid.append(np.concatenate(p, axis=1))
    return grid


def to_colormap(heatmaps: np.ndarray, cmap: str = "jet"):
    """Summed-channel colormap visualization (on the host; matplotlib optional),
    utils/keypoint_utils.py:103-127. heatmaps (B, H, W, K) -> list of (H, W, 3)."""
    from matplotlib import cm

    mapper = cm.ScalarMappable(cmap=cmap)
    summed = np.asarray(heatmaps).sum(-1)
    return [mapper.to_rgba(s)[..., :3].astype(np.float32) for s in summed]
