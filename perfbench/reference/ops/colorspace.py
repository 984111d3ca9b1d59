"""Frozen copy of ``future_urban_scene_generation_tpu_torch/ops/colorspace.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Colour conversions as elementwise torch math: RGB <-> LAB in OpenCV's uint8
convention (/255), their BGR forms, OpenCV's gray and BT.601 YCbCr.

Counterpart of the JAX package's ops/colorspace.py (:59 rgb_to_lab, :82 lab_to_rgb,
:97-130 the BGR, gray and YCbCr forms): the sRGB gamma expansion, the D65 XYZ
matrix applied as explicit per-channel FMAs, CIE f(t) with the 0.008856 threshold, L
scaled to [0, 255] and a/b offset by 128. Channels-last, any leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch

_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float64,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)

_XN = 0.950456
_ZN = 1.088754
_LAB_T0 = 0.008856
_LAB_K = 903.3


def _mix3(m, c0, c1, c2):
    return (
        m[0][0] * c0 + m[0][1] * c1 + m[0][2] * c2,
        m[1][0] * c0 + m[1][1] * c1 + m[1][2] * c2,
        m[2][0] * c0 + m[2][1] * c1 + m[2][2] * c2,
    )


def srgb_gamma_expand(x):
    return torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def srgb_gamma_compress(x):
    x = torch.clamp(x, min=0.0)
    return torch.where(x > 0.0031308, 1.055 * x ** (1.0 / 2.4) - 0.055, 12.92 * x)


def _cbrt(t):
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def rgb_to_lab(rgb):
    """RGB float [0,1] (channels-last) -> LAB as (L*255/100, a+128, b+128) / 255."""
    lin = srgb_gamma_expand(rgb)
    x, y, z = _mix3(_RGB2XYZ, lin[..., 0], lin[..., 1], lin[..., 2])
    x = x / _XN
    z = z / _ZN

    def f(t):
        return torch.where(t > _LAB_T0, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fy = f(y)
    l_val = torch.where(y > _LAB_T0, 116.0 * _cbrt(y) - 16.0, _LAB_K * y)
    a_val = 500.0 * (f(x) - fy) + 128.0
    b_val = 200.0 * (fy - f(z)) + 128.0
    lab = torch.stack([l_val * (255.0 / 100.0), a_val, b_val], dim=-1)
    return lab / 255.0


def lab_to_rgb(lab):
    """Inverse of :func:`rgb_to_lab`, clipped to [0, 1]."""
    lab = lab * 255.0
    l_val = lab[..., 0] * (100.0 / 255.0)
    a_val = lab[..., 1] - 128.0
    b_val = lab[..., 2] - 128.0

    fy = (l_val + 16.0) / 116.0
    fx = fy + a_val / 500.0
    fz = fy - b_val / 200.0

    def finv(ft):
        return torch.where(ft ** 3 > _LAB_T0, ft ** 3, (ft - 16.0 / 116.0) / 7.787)

    y = torch.where(l_val > _LAB_K * _LAB_T0, fy ** 3, l_val / _LAB_K)
    x = finv(fx) * _XN
    z = finv(fz) * _ZN

    r, g, b = _mix3(_XYZ2RGB, x, y, z)
    lin = torch.stack([r, g, b], dim=-1)
    return torch.clamp(srgb_gamma_compress(lin), 0.0, 1.0)


def bgr_to_lab(bgr):
    return rgb_to_lab(bgr.flip(-1))


def lab_to_bgr(lab):
    return lab_to_rgb(lab).flip(-1)


def rgb_to_gray(rgb):
    """Luma per OpenCV COLOR_RGB2GRAY: 0.299 R + 0.587 G + 0.114 B, keeping a last
    dim of 1 (JAX colorspace.py:105)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype, device=rgb.device)
    return torch.sum(rgb * w, dim=-1, keepdim=True)


def bgr_to_gray(bgr):
    return rgb_to_gray(bgr.flip(-1))


def rgb_to_ycbcr(rgb):
    """BT.601 YCbCr in the [16..235]/[16..240] range convention of the reference's
    RGB2YCbCr layer (vunet/layers.py:224-243)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + 65.481 * r + 128.553 * g + 24.966 * b
    cb = 128.0 - 37.797 * r - 74.203 * g + 112.0 * b
    cr = 128.0 + 112.0 * r - 93.786 * g - 18.214 * b
    return torch.stack([y, cb, cr], dim=-1)
