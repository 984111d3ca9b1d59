"""Frozen copy of ``future_urban_scene_generation_tpu_torch/ops/polygon.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Polygon rasterization on a pixel grid (even-odd crossings + half-pixel boundary).

Counterpart of the JAX package's ops/polygon.py ``fill_polygon`` (:33), batched:
polygons are fixed-shape (K, 2) vertex arrays padded by repeating the last vertex
(``pad_polygon``, JAX :19). ``polygon_area_pixels`` / ``polygon_area_shoelace`` (:70,
:75) are the reference's plane areas, by pixels and by the shoelace formula.
"""
from __future__ import annotations

import numpy as np
import torch


def pad_polygon(vertices, k: int) -> np.ndarray:
    """Pad an (n, 2) vertex array to (k, 2) float32 by repeating the final vertex."""
    vertices = np.asarray(vertices, dtype=np.float32)
    n = vertices.shape[0]
    if n > k:
        raise ValueError(f"polygon has {n} vertices > max {k}")
    return np.concatenate([vertices, np.repeat(vertices[-1:], k - n, axis=0)], axis=0)


def fill_polygon(vertices: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Rasterize polygons (..., K, 2) to (..., h, w) bool masks at integer pixel
    coordinates, boundary pixels within half a pixel of an edge included."""
    k = vertices.shape[-2]
    dev = vertices.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    lead = vertices.shape[:-2]
    inside = torch.zeros(lead + (h, w), dtype=torch.bool, device=dev)
    boundary = torch.zeros(lead + (h, w), dtype=torch.bool, device=dev)
    for i in range(k):
        x1 = vertices[..., i, 0][..., None, None]
        y1 = vertices[..., i, 1][..., None, None]
        x2 = vertices[..., (i + 1) % k, 0][..., None, None]
        y2 = vertices[..., (i + 1) % k, 1][..., None, None]
        straddles = (y1 > ys) != (y2 > ys)
        denom = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
        x_cross = x1 + (ys - y1) * (x2 - x1) / denom
        inside = inside ^ (straddles & (xs < x_cross))
        ex, ey = x2 - x1, y2 - y1
        len2 = torch.clamp(ex * ex + ey * ey, min=1e-12)
        t = torch.clamp(((xs - x1) * ex + (ys - y1) * ey) / len2, 0.0, 1.0)
        dx = xs - (x1 + t * ex)
        dy = ys - (y1 + t * ey)
        boundary = boundary | (dx * dx + dy * dy <= 0.25)
    return inside | boundary


def polygon_area_pixels(vertices: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Grid pixels each polygon (..., K, 2) covers (the reference's get_plane_area)."""
    return fill_polygon(vertices, h, w).sum(dim=(-2, -1))


def polygon_area_shoelace(vertices: torch.Tensor) -> torch.Tensor:
    """Continuous area of polygons (..., K, 2) by the shoelace formula; repeated
    padding vertices add nothing."""
    x, y = vertices[..., 0], vertices[..., 1]
    x_next, y_next = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * y_next - x_next * y, dim=-1))
