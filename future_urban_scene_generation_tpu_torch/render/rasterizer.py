"""Normal-coloured sketch rendering, batched over renders.

Counterpart of the JAX package's render/rasterizer.py (``Camera``,
``project_vertices``, ``rasterize`` :57, ``rasterize_auto`` :183,
``project_corners`` :228, ``render_normal_sketch_corners`` :248,
``render_normal_sketch`` :274). The raster itself is a CUDA kernel
(ops/cuda_raster.py): the corner-expanded entry K1 takes every render of a scene
in one launch, the indexed-mesh entry K1' serves ``render_normal_sketch``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from future_urban_scene_generation_tpu_torch.ops import cuda_raster


class Camera(NamedTuple):
    """Pinhole camera (batched fields): full-frame K plus an optional crop window."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def from_intrinsic(k_mat):
        return Camera(k_mat[..., 0, 0], k_mat[..., 1, 1], k_mat[..., 0, 2], k_mat[..., 1, 2])

    def crop(self, x0, y0, scale):
        """Camera for a crop window: frame pixel p maps to (p - origin) * scale."""
        return Camera(
            self.fx * scale, self.fy * scale, (self.cx - x0) * scale, (self.cy - y0) * scale
        )


def project_vertices(vertices, extrinsic, camera: Camera):
    """World (R, Nv, 3) -> screen (R, Nv, 3) of (x_px, y_px, z_cam)."""
    ext = extrinsic[:, :3, :]
    cam = vertices @ ext[:, :, :3].transpose(-1, -2) + ext[:, None, :, 3]
    z = cam[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    x = camera.fx[:, None] * cam[..., 0] / safe_z + camera.cx[:, None]
    y = camera.fy[:, None] * cam[..., 1] / safe_z + camera.cy[:, None]
    return torch.stack([x, y, z], dim=-1)


def project_corners(corners_xyz, extrinsic, camera: Camera):
    """Corner projection (R, 3 corners, 3 xyz, T) world -> (R, 3, 3, T) screen
    (x_px, y_px, z_cam), as component-explicit FMAs."""
    e = extrinsic[:, :3, :, None, None]  # (R, 3, 4, 1, 1) broadcasts over (3, T)
    x, y, z = corners_xyz[:, :, 0], corners_xyz[:, :, 1], corners_xyz[:, :, 2]
    cx_ = e[:, 0, 0] * x + e[:, 0, 1] * y + e[:, 0, 2] * z + e[:, 0, 3]
    cy_ = e[:, 1, 0] * x + e[:, 1, 1] * y + e[:, 1, 2] * z + e[:, 1, 3]
    cz_ = e[:, 2, 0] * x + e[:, 2, 1] * y + e[:, 2, 2] * z + e[:, 2, 3]
    safe_z = torch.where(torch.abs(cz_) < 1e-9, torch.full_like(cz_, 1e-9), cz_)
    sx = camera.fx[:, None, None] * cx_ / safe_z + camera.cx[:, None, None]
    sy = camera.fy[:, None, None] * cy_ / safe_z + camera.cy[:, None, None]
    return torch.stack([sx, sy, cz_], dim=2)


def render_normal_sketch_corners(corners_xyz, corner_normals_xyz, extrinsic,
                                 camera: Camera, out_hw, cull=None):
    """Normal sketches (colours (n + 1) / 2, black background) of R renders from
    corner-expanded geometry (R, 3, 3, T). ``cull`` (R,) bool enables exact
    backface culling per render. Returns (sketch (R, H, W, 3) in [0, 1],
    background mask (R, H, W) bool)."""
    colors = (corner_normals_xyz + 1.0) / 2.0
    screen = project_corners(corners_xyz, extrinsic, camera)
    img, bg = cuda_raster.rasterize_corners(screen, colors, out_hw, cull=cull)
    return torch.clamp(img, 0.0, 1.0), bg


def rasterize(verts_screen, triangles, vert_colors, out_hw):
    """The plain chunked raster of R indexed meshes, on whatever device the
    tensors lie: verts_screen / vert_colors (R, Nv, 3), triangles (T, 3) or
    (R, T, 3) -> (image (R, H, W, 3), background mask (R, H, W))."""
    return cuda_raster.rasterize_indexed_plain(verts_screen, triangles, vert_colors, out_hw)


def rasterize_auto(verts_screen, triangles, vert_colors, out_hw):
    """The rasterizer of indexed meshes by device: kernel K1' on CUDA tensors, the
    plain raster on CPU tensors. The JAX function's other gates (output sizes that
    tile by its 8x128 blocks, a triangle cap for on-chip memory, a switch for
    sharded programs) do not carry over: the CUDA kernel takes any H, W and T."""
    return cuda_raster.rasterize_indexed(verts_screen, triangles, vert_colors, out_hw)


def render_normal_sketch(vertices, triangles, vertex_normals, extrinsic, camera: Camera,
                         out_hw):
    """Normal sketches of R indexed meshes: colours (n + 1) / 2 per vertex, black
    background. vertices / vertex_normals (R, Nv, 3), triangles (T, 3) or
    (R, T, 3), extrinsic (R, 4, 4), camera fields (R,). Returns (sketch
    (R, H, W, 3) in [0, 1], background mask (R, H, W) bool)."""
    colors = (vertex_normals + 1.0) / 2.0
    verts_screen = project_vertices(vertices, extrinsic, camera)
    img, bg = rasterize_auto(verts_screen, triangles, colors, out_hw)
    # Barycentric interpolation can overshoot by float eps.
    return torch.clamp(img, 0.0, 1.0), bg
