"""Host-side bounding-box math (numpy).

Copy of the JAX package's utils/bbox.py (:17-139), which is host numpy there too:
``(..., 4)`` xyxy array helpers, and ``BoundingBox``, which mirrors the reference's
single-box class (utils/bounding_box.py:13-125) including the order of its int
truncations: coordinates truncated, then rescaled about the centre, then clipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


def xywh_to_xyxy(b):
    """(x, y, w, h) → (x_min, y_min, x_max, y_max). Works on (..., 4) arrays."""
    b = np.asarray(b, dtype=np.float64)
    out = np.empty_like(b)
    out[..., 0] = b[..., 0]
    out[..., 1] = b[..., 1]
    out[..., 2] = b[..., 0] + b[..., 2]
    out[..., 3] = b[..., 1] + b[..., 3]
    return out


def xyxy_to_xywh(b):
    b = np.asarray(b, dtype=np.float64)
    out = np.empty_like(b)
    out[..., 0] = b[..., 0]
    out[..., 1] = b[..., 1]
    out[..., 2] = b[..., 2] - b[..., 0]
    out[..., 3] = b[..., 3] - b[..., 1]
    return out


def scale_about_center(xyxy, scale: float):
    """Grow/shrink a box about its center by ``scale``.

    Matches the int-delta semantics of the reference (utils/bounding_box.py:71-85):
    the applied delta is ``int(w * scale - w)`` split as ``delta // 2`` on the min side
    and ``delta - delta // 2``... — the reference actually adds ``delta // 2`` to BOTH
    sides, so a box scaled by 1.3 grows by ``2 * (int(0.3 w) // 2)``. We reproduce that
    exactly so downstream crops align with reference outputs.
    """
    xyxy = np.asarray(xyxy, dtype=np.float64)
    x_min, y_min, x_max, y_max = (xyxy[..., i] for i in range(4))
    w = x_max - x_min
    h = y_max - y_min
    dw = np.trunc(w * scale - w).astype(np.int64) // 2
    dh = np.trunc(h * scale - h).astype(np.int64) // 2
    return np.stack([x_min - dw, y_min - dh, x_max + dw, y_max + dh], axis=-1)


def clip_to_bounds(xyxy, bounds: Tuple[float, float, float, float]):
    """Clip to (x_min_b, x_max_b, y_min_b, y_max_b) (utils/bounding_box.py:43-51)."""
    x_min_b, x_max_b, y_min_b, y_max_b = bounds
    xyxy = np.asarray(xyxy, dtype=np.float64)
    return np.stack(
        [
            np.clip(xyxy[..., 0], x_min_b, None),
            np.clip(xyxy[..., 1], y_min_b, None),
            np.clip(xyxy[..., 2], None, x_max_b),
            np.clip(xyxy[..., 3], None, y_max_b),
        ],
        axis=-1,
    )


def mid_bottom(xyxy):
    """Ground-contact point: (x_min + w // 2, y_max) (utils/bounding_box.py:101-106)."""
    xyxy = np.asarray(xyxy)
    w = xyxy[..., 2] - xyxy[..., 0]
    return np.stack([xyxy[..., 0] + w // 2, xyxy[..., 3]], axis=-1)


@dataclass
class BoundingBox:
    """Host-side convenience box with reference-compatible int semantics.

    Construction mirrors utils/bounding_box.py:17-41: coords are truncated to int,
    then optionally rescaled about the center and clipped to bounds — in that order.
    """

    x_min: int
    y_min: int
    x_max: int
    y_max: int

    def __init__(self, x_min, y_min, w, h, scale: float = None, bounds=None):
        self.x_min = int(x_min)
        self.y_min = int(y_min)
        self.x_max = self.x_min + int(w)
        self.y_max = self.y_min + int(h)
        if scale is not None:
            self.rescale(scale)
        if bounds is not None:
            self.clip_to_bounds(bounds)

    def rescale(self, scale: float):
        if not scale > 0.0:
            raise ValueError(f"BoundingBox.rescale: scale must be positive, got {scale}")
        delta_w = int(self.width * scale - self.width)
        self.x_min -= delta_w // 2
        self.x_max += delta_w // 2
        delta_h = int(self.height * scale - self.height)
        self.y_min -= delta_h // 2
        self.y_max += delta_h // 2

    def clip_to_bounds(self, bounds):
        x_min_b, x_max_b, y_min_b, y_max_b = bounds
        self.x_min = max(x_min_b, self.x_min)
        self.x_max = min(x_max_b, self.x_max)
        self.y_min = max(y_min_b, self.y_min)
        self.y_max = min(y_max_b, self.y_max)

    def contains(self, point) -> bool:
        px, py = point
        return self.x_min <= px <= self.x_max and self.y_min <= py <= self.y_max

    @property
    def width(self):
        return self.x_max - self.x_min

    @property
    def height(self):
        return self.y_max - self.y_min

    @property
    def mid_bottom(self):
        return self.x_min + self.width // 2, self.y_max

    @property
    def xyxy(self):
        return self.x_min, self.y_min, self.x_max, self.y_max

    @property
    def xywh(self):
        return self.x_min, self.y_min, self.width, self.height
