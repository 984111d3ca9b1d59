"""Image quality metrics: PSNR and edge precision / recall (the reference's) and SSIM.

Counterpart of the JAX package's ops/metrics.py (:15-98). PSNR and the edge accuracy
follow edgeconnect/metrics.py:5-46; SSIM is Wang et al.'s with the 11x11 Gaussian
window (sigma 1.5) over the valid region, as skimage's
``structural_similarity(gaussian_weights=True, use_sample_covariance=False)`` on
float images. Every result is a 0-d tensor (or a map) on the inputs' device;
computation is float32 (float64 for float64 inputs).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _float(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


def psnr(a, b, max_val: float = 255.0):
    """edgeconnect/metrics.py:30-46: 20 log10(max) - 10 log10(MSE), and 0 for
    identical images, as the reference returns."""
    mse = torch.mean((_float(a) - _float(b)) ** 2)
    val = 20.0 * np.log10(max_val) - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))
    return torch.where(mse == 0, torch.zeros_like(val), val)


def edge_accuracy(inputs, outputs, threshold: float = 0.5):
    """(precision, recall) of a predicted edge map against the label map
    (edgeconnect/metrics.py:5-27); both 1 when neither map has an edge."""
    labels, preds = inputs > threshold, outputs > threshold
    relevant = labels.sum().to(torch.float32)
    selected = preds.sum().to(torch.float32)
    tp = ((preds == labels) & labels).sum().to(torch.float32)
    recall, precision = tp / (relevant + 1e-8), tp / (selected + 1e-8)
    one = torch.ones_like(recall)
    both_empty = (relevant == 0) & (selected == 0)
    return torch.where(both_empty, one, precision), torch.where(both_empty, one, recall)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _filter_valid(img, k1d: np.ndarray):
    """Separable valid-mode filtering of (C, H, W) planes, columns then rows."""
    k = torch.as_tensor(k1d, device=img.device).to(img.dtype)
    x = F.conv2d(img[:, None], k.view(1, 1, -1, 1))
    return F.conv2d(x, k.view(1, 1, 1, -1))[:, 0]


def _ssim_planes(a, b, max_val: float):
    """Per-pixel SSIM of (C, H, W) planes over the valid window region."""
    k1d = _gaussian_window()
    c1, c2 = (0.01 * max_val) ** 2, (0.03 * max_val) ** 2
    mu_a, mu_b = _filter_valid(a, k1d), _filter_valid(b, k1d)
    var_a = _filter_valid(a * a, k1d) - mu_a ** 2
    var_b = _filter_valid(b * b, k1d) - mu_b ** 2
    cov = _filter_valid(a * b, k1d) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return num / den


def _planes(x):
    """(H, W) or (H, W, C) -> (C, H, W) in float32 / float64."""
    x = _float(x)
    return x[None] if x.dim() == 2 else x.permute(2, 0, 1)


def ssim_map(a, b, max_val: float = 1.0):
    """The SSIM map over the valid region ((H - 10, W - 10)) of an (H, W) or
    (H, W, C) pair, channels averaged; its mean is :func:`ssim`."""
    return _ssim_planes(_planes(a), _planes(b), max_val).mean(dim=0)


def ssim(a, b, max_val: float = 1.0):
    """Mean SSIM of an (H, W) or (H, W, C) pair (the mean of each channel's, averaged)."""
    return _ssim_planes(_planes(a), _planes(b), max_val).mean(dim=(1, 2)).mean()
