"""Bilinear sampling with a zero border (the gather behind the plane warps).

Counterpart of the JAX package's ops/warp.py ``_bilinear_sample`` (:17) and
``bilinear_sample_packed`` (:60). The JAX serving path packs each 2x2 neighbourhood
into 12 channels (``pack_bilinear_table``) because TPU gathers cost per index; that
trick is not ported: this is plain 4-tap bilinear with the same math, which is what
the packed gather computes. ``warp_perspective`` and ``warp_affine_resample`` (JAX
:156, :177) are the reference-parity surface: cv2.warpPerspective and the fused
square crop + resize.
"""
from __future__ import annotations

from typing import Tuple

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


def bilinear_sample_image(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """One (H, W, C) image sampled at coordinates of any shape (JAX ``_bilinear_sample``)."""
    zero = torch.zeros(1, dtype=torch.long, device=img.device)
    return bilinear_sample(img[None], xs[None], ys[None], zero)[0]


def warp_perspective(img: torch.Tensor, h_mat: torch.Tensor, out_hw: Tuple[int, int]
                     ) -> torch.Tensor:
    """cv2.warpPerspective: each (out_h, out_w) pixel samples img (H, W, C) at
    H^-1 (x, y, 1); ``h_mat`` maps src -> dst as cv2's (JAX :156)."""
    out_h, out_w = out_hw
    h_inv = torch.linalg.inv(h_mat)
    dev = img.device
    xs = torch.broadcast_to(torch.arange(out_w, dtype=torch.float32, device=dev)[None, :],
                            (out_h, out_w))
    ys = torch.broadcast_to(torch.arange(out_h, dtype=torch.float32, device=dev)[:, None],
                            (out_h, out_w))
    denom = h_inv[2, 0] * xs + h_inv[2, 1] * ys + h_inv[2, 2] * torch.ones_like(xs)
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    src_x = (h_inv[0, 0] * xs + h_inv[0, 1] * ys + h_inv[0, 2]) / denom
    src_y = (h_inv[1, 0] * xs + h_inv[1, 1] * ys + h_inv[1, 2]) / denom
    return bilinear_sample_image(img, src_x, src_y)


def warp_affine_resample(img: torch.Tensor, src_center: torch.Tensor, src_side,
                         out_size: int) -> torch.Tensor:
    """The square window (center (2,), side) of img (H, W, C) resampled to out_size^2
    with cv2.resize's half-pixel convention, clamped to the window's interior, zero
    outside the image (JAX :177; utils/crop_utils.py:4-52 + cv2.resize)."""
    src_side = torch.as_tensor(src_side, dtype=torch.float32, device=img.device)
    x_min = src_center[0] - src_side / 2.0
    y_min = src_center[1] - src_side / 2.0
    coords = (torch.arange(out_size, dtype=torch.float32, device=img.device) + 0.5) * (
        src_side / out_size) - 0.5
    coords = torch.minimum(torch.clamp(coords, min=0.0), src_side - 1.0)
    xs = torch.broadcast_to(x_min + coords[None, :], (out_size, out_size))
    ys = torch.broadcast_to(y_min + coords[:, None], (out_size, out_size))
    return bilinear_sample_image(img, xs, ys)
