"""Polygon rasterization on a pixel grid (even-odd crossings + half-pixel boundary).

Counterpart of the JAX package's ops/polygon.py ``fill_polygon`` (:33), batched:
polygons are fixed-shape (K, 2) vertex arrays padded by repeating the last vertex.
"""
from __future__ import annotations

import torch


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
