"""Frozen copy of ``future_urban_scene_generation_tpu_torch/ops/resize.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Nearest resampling with torch ``F.interpolate``'s default index convention, cv2's
bilinear resize, and the antialiased linear resize of a batch.

Counterpart of the JAX package's ops/resize.py ``resize_nearest`` (:54), which
``models.icn.gan_loss`` uses to bring its mask to each discriminator scale,
``resize_bilinear`` (:32), with which the Mask R-CNN detectors bring a frame to the
network's input size, and of ``jax.image.resize(..., "linear")``, with which the
training CLI brings the 256^2 renders to ``--image-size``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from perfbench.reference.ops.crop import scale_and_translate


def _linear_coords(out_size: int, in_size: int, device):
    x = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * (
        in_size / out_size) - 0.5
    x0 = torch.floor(x)
    frac = x - x0
    i0 = torch.clamp(x0.long(), 0, in_size - 1)
    i1 = torch.clamp(x0.long() + 1, 0, in_size - 1)
    return i0, i1, frac


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_LINEAR) on (..., H, W, C): half-pixel centres, edge
    replication, no antialiasing, rows first (JAX resize.py:32)."""
    out_h, out_w = out_hw
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (out_h, out_w):
        return img
    iy0, iy1, fy = _linear_coords(out_h, h, img.device)
    ix0, ix1, fx = _linear_coords(out_w, w, img.device)
    if not img.is_floating_point():
        img = img.to(torch.float32)
    fy = fy.to(img.dtype).reshape(out_h, 1, 1)
    fx = fx.to(img.dtype).reshape(out_w, 1)
    rows = img.index_select(-3, iy0) * (1.0 - fy) + img.index_select(-3, iy1) * fy
    return rows.index_select(-2, ix0) * (1.0 - fx) + rows.index_select(-2, ix1) * fx


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') on (..., H, W, C): src = floor(dst * in / out)."""
    out_h, out_w = out_hw
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (out_h, out_w):
        return img
    iy = torch.clamp(torch.arange(out_h, device=img.device) * h // out_h, 0, h - 1)
    ix = torch.clamp(torch.arange(out_w, device=img.device) * w // out_w, 0, w - 1)
    return img.index_select(-3, iy).index_select(-2, ix)


def resize_linear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, (B, out_h, out_w, C), "linear")`` on (B, H, W, C):
    half-pixel centres, and a triangle kernel widened by the scale when shrinking
    (antialiased)."""
    out_h, out_w = out_hw
    b, h, w = img.shape[0], img.shape[1], img.shape[2]
    if (h, w) == (out_h, out_w):
        return img
    scale = torch.tensor([out_h / h, out_w / w], dtype=torch.float32, device=img.device)
    return scale_and_translate(img, (out_h, out_w), scale.expand(b, 2),
                               torch.zeros(b, 2, device=img.device), antialias=True)
