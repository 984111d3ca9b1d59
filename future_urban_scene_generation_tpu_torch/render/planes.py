"""Texture-plane extraction and source -> destination homography warping, one
vehicle at a time: the reference-parity counterpart of the JAX package's
render/planes.py (``get_planes`` :31, ``warp_unwarp_planes`` :48; the reference's
warp_learn/planes_utils.py:11-82). The scene itself warps planes straight into the
destination crop, batched (``stages.warp_planes_to_crop``).

* ``get_planes``: each plane's polygon mask times the frame, (5, H, W, C), and the
  (5, 6, 2) int-truncated plane keypoints (the reference converts to np.int32 before
  fillPoly / findHomography, planes_utils.py:27).
* ``warp_unwarp_planes``: per-plane homography src -> dst and back
  (``find_homography(refine=True)``, the JAX default), the left/right symmetry
  substitution when the destination side is invisible (planes_utils.py:46-68), and
  planes whose homography is degenerate skipped (cv2 returns None there). The
  reference's sequential writes are masked updates in static plane order.
"""
from __future__ import annotations

from typing import Tuple

import torch

from future_urban_scene_generation_tpu_torch.geometry.homography import find_homography
from future_urban_scene_generation_tpu_torch.ops.polygon import fill_polygon
from future_urban_scene_generation_tpu_torch.ops.warp import warp_perspective
from future_urban_scene_generation_tpu_torch.render.visibility import (
    NUM_TEXTURE_PLANES,
    SYMMETRY_PAIR,
    TEXTURE_PLANES,
    plane_polygons_2d,
)


def get_planes(frame: torch.Tensor, kpoints_2d_px: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked plane textures of frame (H, W, C) at pixel keypoints (12, 2): returns
    (planes (5, H, W, C), plane keypoints (5, 6, 2) float32 of truncated pixels)."""
    h, w = frame.shape[0], frame.shape[1]
    polys = plane_polygons_2d(torch.trunc(kpoints_2d_px).to(torch.float32), TEXTURE_PLANES)
    masks = fill_polygon(polys, h, w)  # (5, h, w)
    return masks[..., None].to(frame.dtype) * frame[None], polys


def warp_unwarp_planes(src_planes: torch.Tensor, src_plane_kpoints: torch.Tensor,
                       dst_plane_kpoints: torch.Tensor, src_visibilities: torch.Tensor,
                       dst_visibilities: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each visible source plane warped onto its destination polygon, and back.

    src_planes (5, H, W, C); plane keypoints (5, 6, 2); visibilities (5,) bool.
    Returns (planes_warped, planes_unwarped), (5, H, W, C) each, zeros where skipped."""
    h, w = src_planes.shape[1], src_planes.shape[2]
    left, right = SYMMETRY_PAIR
    warped_all = torch.zeros_like(src_planes)
    unwarped_all = torch.zeros_like(src_planes)
    slots = torch.arange(NUM_TEXTURE_PLANES, device=src_planes.device)
    for i in range(NUM_TEXTURE_PLANES):
        skip = ~src_visibilities[i]
        if i in (left, right):
            other = right if i == left else left
            skip = skip | ~(dst_visibilities[left] | dst_visibilities[right])
            j = torch.where(dst_visibilities[i], i, other)
        else:
            skip = skip | ~dst_visibilities[i]
            j = torch.tensor(i, device=src_planes.device)
        dst_kp = dst_plane_kpoints[j]
        h12, valid12 = find_homography(src_plane_kpoints[i][None], dst_kp[None], refine=True)
        h21, valid21 = find_homography(dst_kp[None], src_plane_kpoints[i][None], refine=True)
        ok = valid12[0] & valid21[0] & ~skip
        warped = warp_perspective(src_planes[i], h12[0], (h, w))
        unwarped = warp_perspective(warped, h21[0], (h, w))
        write_j = ((slots == j) & ok).to(src_planes.dtype)[:, None, None, None]
        warped_all = warped_all * (1.0 - write_j) + warped[None] * write_j
        unwarped_all[i] = torch.where(ok, unwarped, unwarped_all[i])
    return warped_all, unwarped_all
