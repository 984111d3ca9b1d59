"""Binary morphology with OpenCV's structuring elements and anchors (replaces
cv2.dilate / cv2.erode).

Counterpart of the JAX package's ops/morphology.py (:15-65). The inpainting input
preparation dilates the segmentation mask with an 8x8 elliptical structuring element
(utils/inpaint_utils.py:42-43). Here a dilation is one convolution of the 0/1 mask
with the footprint, zero-padded about cv2's anchor (k // 2, k // 2): the counts are
small integers, exact in float32, and a pixel is set where its count is positive.
Masks are bool, (..., H, W), any leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def elliptical_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)) footprint, as the OpenCV
    source computes it: r = c = k // 2, dy = i - r (asymmetric for even k),
    dx = cvRound(c * sqrt((r^2 - dy^2) / r^2)), columns [c - dx, c + dx]."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    k = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        if abs(dy) > r:
            continue
        dx = int(np.rint(c * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
        k[i, max(c - dx, 0): min(c + dx + 1, ksize)] = True
    return k


def dilate(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Binary dilation of an (..., H, W) bool mask by a boolean footprint, as cv2:
    output pixel p is set when an input pixel q is set with q - p + anchor inside
    the footprint (anchor (kh // 2, kw // 2)); outside the image counts as unset."""
    kh, kw = kernel.shape
    lead, (h, w) = mask.shape[:-2], mask.shape[-2:]
    m = mask.reshape(-1, 1, h, w).to(torch.float32)
    m = F.pad(m, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2))
    weight = torch.as_tensor(kernel, dtype=torch.float32, device=mask.device)[None, None]
    return (F.conv2d(m, weight) > 0.5).reshape(*lead, h, w)


def erode(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Binary erosion, the dual of :func:`dilate` (JAX morphology.py:64)."""
    return ~dilate(~mask, kernel[::-1, ::-1].copy())
