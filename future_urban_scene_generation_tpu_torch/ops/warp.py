"""Bilinear sampling with a zero border (the gather behind the plane warps).

Counterpart of the JAX package's ops/warp.py ``_bilinear_sample`` (:17) and
``bilinear_sample_packed`` (:60). The JAX serving path packs each 2x2 neighbourhood
into 12 channels (``pack_bilinear_table``) because TPU gathers cost per index; that
trick is not ported: this is plain 4-tap bilinear with the same math, which is what
the packed gather computes.
"""
from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    img_index: torch.Tensor) -> torch.Tensor:
    """Sample images at float pixel coordinates, zero outside, in float32.

    img (M, H, W, C) (any float dtype; taps are upcast to float32 before the
    blend); xs/ys (B, ...); ``img_index`` (B,) selects the image each batch row
    samples. Returns (B, ..., C) float32.
    """
    m, h, w, c = img.shape
    b = xs.shape[0]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    x0i = torch.nan_to_num(x0, nan=-2.0, posinf=-2.0, neginf=-2.0).long()
    y0i = torch.nan_to_num(y0, nan=-2.0, posinf=-2.0, neginf=-2.0).long()
    flat = img.reshape(m * h * w, c)
    base = (img_index.long() * (h * w)).view((b,) + (1,) * (xs.dim() - 1))

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = flat[idx].to(torch.float32)
        return torch.where(inb[..., None], vals, torch.zeros_like(vals))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy
