"""Nearest resampling with torch ``F.interpolate``'s default index convention, and
the antialiased linear resize of a batch.

Counterpart of the JAX package's ops/resize.py ``resize_nearest`` (:54), which
``models.icn.gan_loss`` uses to bring its mask to each discriminator scale, and of
``jax.image.resize(..., "linear")``, with which the training CLI brings the 256^2
renders to ``--image-size``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from future_urban_scene_generation_tpu_torch.ops.crop import scale_and_translate


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
