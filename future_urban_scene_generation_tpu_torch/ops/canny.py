"""Canny edge detection in torch, following scikit-image's algorithm.

Counterpart of the JAX package's ops/canny.py (:39-184). The EdgeConnect input
preparation runs skimage.feature.canny with sigma = config.SIGMA (default 2) restricted
to an image mask (utils/inpaint_utils.py:51, edgeconnect/config.py:48):

1. Gaussian smoothing (truncate 4.0), zero-padded, with bleed-over normalization:
   the image is smoothed masked-to-zero and divided by the smoothed mask;
2. UNNORMALIZED Sobel gradients ([-1, 0, 1] x [1, 2, 1], edge-duplicating padding);
3. the detection mask: without a mask everything but the 1-pixel border; with one,
   one 8-connected erosion of it (outside counts as False); always magnitude > 0;
4. non-maximum suppression by bilinear interpolation of the magnitude one
   Chebyshev step along +/- the gradient (keep when both are <= the centre);
5. hysteresis: strong (>= high) edges flood through 8-connected weak (>= low)
   pixels to a fixed point, at most 256 growth steps, as the JAX ``while_loop``.

Images are batched, (..., H, W) float in [0, 1]. The hysteresis checks for its fixed
point once every 16 steps, which costs one host read each time on a CUDA tensor
(and not one a step); steps past the fixed point change nothing and 256 is a
multiple of 16, so it stops where the JAX loop stops.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

MAX_HYSTERESIS_STEPS = 256
FIXPOINT_CHECK_EVERY = 16


def gaussian_kernel_1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv_sep_zero(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable zero-padded convolution of (B, H, W) images, rows first."""
    r = len(k1d) // 2
    k = torch.as_tensor(k1d, device=img.device).to(img.dtype)
    x = F.conv2d(img[:, None], k.view(1, 1, -1, 1), padding=(r, 0))
    return F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))[:, 0]


def _sobel_unnormalized(img: torch.Tensor):
    """scipy.ndimage.sobel gradients along rows (gi) and columns (gj), no /4,
    edge-duplicating padding, in the JAX function's order of operations."""
    p = F.pad(img[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    smooth_j = p[:, 1:-1, :-2] + 2.0 * p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
    smooth_i = p[:, :-2, 1:-1] + 2.0 * p[:, 1:-1, 1:-1] + p[:, 2:, 1:-1]
    ps_j = F.pad(smooth_j[:, None], (0, 0, 1, 1), mode="replicate")[:, 0]
    gi = ps_j[:, 2:, :] - ps_j[:, :-2, :]
    ps_i = F.pad(smooth_i[:, None], (1, 1, 0, 0), mode="replicate")[:, 0]
    gj = ps_i[:, :, 2:] - ps_i[:, :, :-2]
    return gi, gj


def _local_maxima(mag, gi, gj, cand):
    """skimage's octant-wise NMS: bilinear interpolation of the full magnitude field
    one step along +/- the gradient; a candidate survives when both interpolants
    are <= its own magnitude."""
    b, h, w = mag.shape
    eps = 1e-20
    ai, aj = gi.abs(), gj.abs()
    flat = F.pad(mag, (1, 1, 1, 1)).reshape(b, -1)
    rows = torch.arange(h, device=mag.device)[:, None] + 1
    cols = torch.arange(w, device=mag.device)[None, :] + 1

    def gather(off_i, off_j):
        idx = (rows + off_i) * (w + 2) + (cols + off_j)
        return flat.gather(1, idx.reshape(b, -1)).reshape(b, h, w)

    si = torch.sign(gi).to(torch.int64)
    sj = torch.sign(gj).to(torch.int64)
    zero = torch.zeros_like(si)
    i_dom = ai >= aj
    wgt = torch.where(i_dom, aj / torch.clamp(ai, min=eps), ai / torch.clamp(aj, min=eps))
    axis_p = gather(torch.where(i_dom, si, zero), torch.where(i_dom, zero, sj))
    diag_p = gather(si, sj)
    plus = axis_p * (1 - wgt) + diag_p * wgt
    axis_m = gather(torch.where(i_dom, -si, zero), torch.where(i_dom, zero, -sj))
    diag_m = gather(-si, -sj)
    minus = axis_m * (1 - wgt) + diag_m * wgt
    return cand & (plus <= mag) & (minus <= mag)


def _erode8(mask: torch.Tensor) -> torch.Tensor:
    """One 8-connected erosion, the outside counted as False."""
    m = F.pad(mask[:, None].to(torch.float32), (1, 1, 1, 1))
    return (-F.max_pool2d(-m, 3, stride=1))[:, 0] > 0.5


def _grow(m: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """One 8-connected dilation of ``m`` (float 0/1, (B, 1, H, W)) kept inside weak."""
    return F.max_pool2d(m, 3, stride=1, padding=1) * weak


def hysteresis(weak: torch.Tensor, strong: torch.Tensor,
               max_steps: int = MAX_HYSTERESIS_STEPS) -> torch.Tensor:
    """Flood strong edges through 8-connected weak pixels: growth steps until a
    step changes nothing or ``max_steps`` were taken, for every image of the batch
    together (a converged image is not changed by further steps)."""
    weak_f = weak[:, None].to(torch.float32)
    m = (strong & weak)[:, None].to(torch.float32)
    steps = 0
    while steps < max_steps:
        before = m
        for _ in range(min(FIXPOINT_CHECK_EVERY, max_steps - steps)):
            m = _grow(m, weak_f)
            steps += 1
        if torch.equal(m, before):
            break
    return m[:, 0] > 0.5


def canny(image: torch.Tensor, sigma: float = 2.0, low_threshold: float = 0.1,
          high_threshold: float = 0.2, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Canny edges of (..., H, W) float images in [0, 1]; returns (..., H, W) bool.
    ``mask`` (bool, the image's shape) restricts detection (True = consider), as
    skimage's canny(mask=...)."""
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    image = image.reshape(-1, h, w)
    k1d = gaussian_kernel_1d(sigma)
    if mask is None:
        mask_f = torch.ones_like(image)
        masked_image = image
        eroded = torch.zeros(image.shape, dtype=torch.bool, device=image.device)
        eroded[:, 1:-1, 1:-1] = True
    else:
        mask = mask.reshape(-1, h, w).to(torch.bool)
        mask_f = mask.to(image.dtype)
        masked_image = torch.where(mask, image, torch.zeros_like(image))
        eroded = _erode8(mask)

    bleed_over = _conv_sep_zero(mask_f, k1d) + float(np.finfo(np.float32).eps)
    smoothed = _conv_sep_zero(masked_image, k1d) / bleed_over

    gi, gj = _sobel_unnormalized(smoothed)
    mag = torch.hypot(gi, gj)

    cand = eroded & (mag > 0.0)
    maxima = _local_maxima(mag, gi, gj, cand)
    weak = maxima & (mag >= low_threshold)
    strong = weak & (mag >= high_threshold)
    return hysteresis(weak, strong).reshape(*lead, h, w)
