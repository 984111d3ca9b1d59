"""Square-crop windows and the separable resampler behind every crop and paste.

Counterpart of the JAX package's ops/crop.py. A crop is a :class:`Window` (x_start,
y_start, w, h in frame coordinates, integer-valued floats computed with the
reference's int truncation) and pixels move through :func:`scale_and_translate`,
a faithful copy of ``jax.image.scale_and_translate`` with the linear (triangle)
kernel: dense per-sample weight matrices applied as two batched contractions.
``torch.nn.functional.interpolate`` and ``grid_sample`` use other pixel conventions
and do not stand in for it. The gather-based oracles ``crop_resize_gather`` and
``stitch_gather`` (JAX :87, :260), the coordinate maps and the host keypoint remap
``image_ref_to_crop_ref`` (:286) are the reference-parity surface beside them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS32 = float(torch.finfo(torch.float32).eps)


class Window(NamedTuple):
    """A crop window in frame coordinates (integer-valued float tensors; any
    common batch shape)."""

    x_start: torch.Tensor
    y_start: torch.Tensor
    w: torch.Tensor
    h: torch.Tensor

    def map(self, fn) -> "Window":
        return Window(*(fn(f) for f in self))


def square_window_from_bbox(bbox_xyxy: torch.Tensor) -> Window:
    """Reference square crop window: side = 1.1 * max(w, h) about the bbox center,
    int-truncated as utils/crop_utils.py:20-47. ``bbox_xyxy`` (..., 4)."""
    x_min, y_min, x_max, y_max = bbox_xyxy.unbind(-1)
    side_x = x_max - x_min
    side_y = y_max - y_min
    major = 1.1 * torch.maximum(side_x, side_y)
    cx = x_min + side_x / 2.0
    cy = y_min + side_y / 2.0
    x0 = torch.trunc(cx - major / 2.0)
    y0 = torch.trunc(cy - major / 2.0)
    x1 = torch.trunc(cx + major / 2.0)
    y1 = torch.trunc(cy + major / 2.0)
    return Window(x0, y0, x1 - x0, y1 - y0)


def _weight_mat(in_size: int, out_size: int, scale, translation, antialias: bool,
                dtype) -> torch.Tensor:
    """(B, in_size, out_size) linear-kernel resampling weights for per-sample
    ``scale``/``translation`` of shape (B,) — jax.image's compute_weight_mat."""
    scale = scale.to(torch.float32)
    translation = translation.to(torch.float32)
    dev = scale.device
    inv_scale = 1.0 / scale
    if antialias:
        kernel_scale = torch.clamp(inv_scale, min=1.0)
    else:
        kernel_scale = torch.ones_like(inv_scale)
    out_c = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    sample_f = (
        out_c[None, :] * inv_scale[:, None]
        - (translation * inv_scale)[:, None]
        - 0.5
    )  # (B, out)
    in_c = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = torch.abs(sample_f[:, None, :] - in_c[None, :, None]) / kernel_scale[:, None, None]
    weights = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(weights, dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = torch.where(inside[:, None, :], weights, torch.zeros_like(weights))
    return weights.to(dtype)


def scale_and_translate(img: torch.Tensor, out_hw, scale: torch.Tensor,
                        translation: torch.Tensor, antialias: bool = True) -> torch.Tensor:
    """``jax.image.scale_and_translate(img, out, (H, W axes), scale, translation,
    method="linear", antialias)`` for a batch.

    img (B, H, W, C) or (H, W, C) shared by every sample; scale/translation (B, 2)
    as (y, x). Output pixel o samples input coordinate (o + 0.5 - t) / s - 0.5.
    Returns (B, out_h, out_w, C) in img's dtype.
    """
    out_h, out_w = out_hw
    in_h, in_w = img.shape[-3], img.shape[-2]
    wy = _weight_mat(in_h, out_h, scale[:, 0], translation[:, 0], antialias, img.dtype)
    wx = _weight_mat(in_w, out_w, scale[:, 1], translation[:, 1], antialias, img.dtype)
    if img.dim() == 3:
        tmp = torch.einsum("hwc,bhy->bywc", img, wy)
    else:
        tmp = torch.einsum("bhwc,bhy->bywc", img, wy)
    return torch.einsum("bywc,bwx->byxc", tmp, wx)


def crop_resize(frame: torch.Tensor, window: Window, out_size: int) -> torch.Tensor:
    """Resample each window of ``frame`` to (out_size, out_size, C), zero outside
    the frame (cv2.resize on a zero-padded crop, antialias off).

    frame (H, W, C) with window fields (B,), or (B, H, W, C) with window fields
    (B,) or scalars. Returns (B, out, out, C)."""
    batch = frame.shape[0] if frame.dim() == 4 else window.x_start.shape[0]
    win = window.map(lambda f: torch.broadcast_to(f, (batch,)))
    sx = out_size / win.w
    sy = out_size / win.h
    padded = F.pad(frame, (0, 0, 1, 1, 1, 1))
    return scale_and_translate(
        padded,
        (out_size, out_size),
        torch.stack([sy, sx], dim=-1),
        torch.stack([-(win.y_start + 1.0) * sy, -(win.x_start + 1.0) * sx], dim=-1),
        antialias=False,
    )


def crop_to_frame_coords(kp_norm: torch.Tensor, window: Window) -> torch.Tensor:
    """[0,1]-normalized crop keypoints (B, K, 2) -> frame pixels, per window (B,)."""
    x = kp_norm[..., 0] * window.w[..., None] + window.x_start[..., None]
    y = kp_norm[..., 1] * window.h[..., None] + window.y_start[..., None]
    return torch.stack([x, y], dim=-1)


def crop_resize_gather(frame: torch.Tensor, window: Window, out_size: int) -> torch.Tensor:
    """Gather-based reference of :func:`crop_resize` for one (H, W, C) frame and a
    window of 0-d fields: cv2's clamping to the window's edge pixels (JAX :87)."""
    from future_urban_scene_generation_tpu_torch.ops.warp import bilinear_sample_image

    dev = frame.device
    ar = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
    cols = torch.minimum(torch.clamp(ar * (window.w / out_size) - 0.5, min=0.0),
                         window.w - 1.0) + window.x_start
    rows = torch.minimum(torch.clamp(ar * (window.h / out_size) - 0.5, min=0.0),
                         window.h - 1.0) + window.y_start
    xs = torch.broadcast_to(cols[None, :], (out_size, out_size))
    ys = torch.broadcast_to(rows[:, None], (out_size, out_size))
    return bilinear_sample_image(frame, xs, ys)


def frame_to_crop_coords(kp_frame: torch.Tensor, window: Window, out_size: int) -> torch.Tensor:
    """Frame-pixel keypoints (..., 2) -> out_size^2 crop pixel coordinates (JAX :109)."""
    x = (kp_frame[..., 0] - window.x_start) * (out_size / window.w)
    y = (kp_frame[..., 1] - window.y_start) * (out_size / window.h)
    return torch.stack([x, y], dim=-1)


def image_ref_to_crop_ref(kpoints, crop_tl, crop_pad, crop_shape, normalize: bool):
    """Host keypoint remap image -> crop with out-of-crop invalidation (JAX :286;
    utils/crop_utils.py:55-88). kpoints (K, 2), -1 marks a missing point; float64."""
    x_min, y_min = crop_tl
    x_pad, y_pad = crop_pad
    crop_h, crop_w = crop_shape[0], crop_shape[1]
    out = np.array(kpoints, dtype=np.float64, copy=True)
    for i in range(len(out)):
        if np.all(out[i] != -1):
            kx = out[i, 0] - x_min + x_pad
            ky = out[i, 1] - y_min + y_pad
            if kx < 0 or ky < 0 or kx >= crop_w or ky >= crop_h:
                out[i] = (-1.0, -1.0)
            elif normalize:
                out[i] = (kx / crop_w, ky / crop_h)
            else:
                out[i] = (kx, ky)
    return out


def window_from_mask_bbox(mask: torch.Tensor, window: Window, out_size: int) -> Window:
    """The reference's square window around the bbox of an (S, S) crop-resolution mask,
    in frame coordinates (JAX :310; warp_learn/models.py:330-335), as a fixed-shape
    reduction; ``window`` has 0-d fields."""
    s = mask.shape[0]
    idx = torch.arange(s, device=mask.device)
    cols = mask.any(dim=0)
    rows = mask.any(dim=1)
    x_min = torch.where(cols, idx, s).amin()
    x_max = torch.where(cols, idx, -1).amax()
    y_min = torch.where(rows, idx, s).amin()
    y_max = torch.where(rows, idx, -1).amax()

    def fx(c):
        return window.x_start + (c + 0.5) * window.w / s - 0.5

    def fy(c):
        return window.y_start + (c + 0.5) * window.h / s - 0.5

    return square_window_from_bbox(torch.stack([fx(x_min), fy(y_min), fx(x_max), fy(y_max)]))


def inside_window(window: Window, h: int, w: int, device) -> torch.Tensor:
    """(B, h, w) bool: frame pixels inside each window (fields (B,))."""
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[None, :, None]
    x0 = window.x_start[:, None, None]
    y0 = window.y_start[:, None, None]
    return (
        (xs >= x0) & (xs < x0 + window.w[:, None, None])
        & (ys >= y0) & (ys < y0 + window.h[:, None, None])
    )


def stitch(frame: torch.Tensor, crop_img: torch.Tensor, window: Window,
           mask_frame: torch.Tensor) -> torch.Tensor:
    """Paste crops back onto frames through their windows where the frame-resolution
    mask is set (JAX crop.stitch :116, batched). frame (B, H, W, C) or (H, W, C)
    shared by the batch; crop_img (B, S, S, C); window fields (B,); mask_frame
    (B, H, W) bool. Returns (B, H, W, C)."""
    h, w = frame.shape[-3], frame.shape[-2]
    out_size = crop_img.shape[1]
    canvas = scale_and_translate(
        crop_img,
        (h, w),
        torch.stack([window.h / out_size, window.w / out_size], dim=-1),
        torch.stack([window.y_start, window.x_start], dim=-1),
        antialias=False,
    )
    write = (inside_window(window, h, w, frame.device) & mask_frame)[..., None]
    return torch.where(write, canvas, frame)


def stitch_packed(frame: torch.Tensor, crop_img: torch.Tensor, window: Window,
                  mask_crop: torch.Tensor, resample_dtype=None) -> torch.Tensor:
    """Paste crops back onto frames through their windows, the crop-resolution
    mask resampled in the same pass as a 4th channel (JAX crop.stitch_packed).

    frame (B, H, W, 3); crop_img (B, S, S, 3); window fields (B,); mask_crop
    (B, S, S) bool. ``resample_dtype`` (e.g. bfloat16) is the dtype of the
    full-frame canvas; the merged output stays in frame's dtype.
    """
    b, h, w = frame.shape[0], frame.shape[1], frame.shape[2]
    out_size = crop_img.shape[1]
    rgbm = torch.cat([crop_img, mask_crop.to(crop_img.dtype)[..., None]], dim=-1)
    if resample_dtype is not None:
        rgbm = rgbm.to(resample_dtype)
    canvas = scale_and_translate(
        rgbm,
        (h, w),
        torch.stack([window.h / out_size, window.w / out_size], dim=-1),
        torch.stack([window.y_start, window.x_start], dim=-1),
        antialias=False,
    ).to(torch.float32)
    inside = inside_window(window, h, w, frame.device)
    write = (inside & (canvas[..., 3] > 0.5))[..., None]
    return torch.where(write, canvas[..., :3], frame)


def stitch_gather(frame: torch.Tensor, crop_img: torch.Tensor, window: Window,
                  mask_frame: torch.Tensor) -> torch.Tensor:
    """Gather-based reference of :func:`stitch` for one (H, W, C) frame, an (S, S, C)
    crop, a window of 0-d fields and an (H, W) bool mask (JAX :260)."""
    from future_urban_scene_generation_tpu_torch.ops.warp import bilinear_sample_image

    h, w = frame.shape[0], frame.shape[1]
    out_size = crop_img.shape[0]
    xs_f = torch.arange(w, dtype=torch.float32, device=frame.device)[None, :]
    ys_f = torch.arange(h, dtype=torch.float32, device=frame.device)[:, None]
    cx = torch.broadcast_to((xs_f - window.x_start + 0.5) * (out_size / window.w) - 0.5, (h, w))
    cy = torch.broadcast_to((ys_f - window.y_start + 0.5) * (out_size / window.h) - 0.5, (h, w))
    sampled = bilinear_sample_image(crop_img, cx, cy)
    inside = ((xs_f >= window.x_start) & (xs_f < window.x_start + window.w)
              & (ys_f >= window.y_start) & (ys_f < window.y_start + window.h))
    return torch.where((inside & mask_frame)[..., None], sampled, frame)
