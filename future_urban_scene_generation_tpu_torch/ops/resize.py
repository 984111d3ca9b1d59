"""Nearest resampling with torch ``F.interpolate``'s default index convention.

Counterpart of the JAX package's ops/resize.py ``resize_nearest`` (:54), which
``models.icn.gan_loss`` uses to bring its mask to each discriminator scale.
"""
from __future__ import annotations

from typing import Tuple

import torch


def resize_nearest(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') on (..., H, W, C): src = floor(dst * in / out)."""
    out_h, out_w = out_hw
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == (out_h, out_w):
        return img
    iy = torch.clamp(torch.arange(out_h, device=img.device) * h // out_h, 0, h - 1)
    ix = torch.clamp(torch.arange(out_w, device=img.device) * w // out_w, 0, w - 1)
    return img.index_select(-3, iy).index_select(-2, ix)
