"""Plain versions of the port's CUDA kernels K1 and K2, frozen copies of
``future_urban_scene_generation_tpu_torch/ops/cuda_raster.py``
(``rasterize_corners_plain``) and ``ops/cuda_conv.py`` (``icn_stem_conv_plain``) at
commit a2138eb: the chunked argmin raster and the stem conv as ``F.conv2d`` on the
concatenated, reflect-padded 21-channel input. The reference calls these wherever the
port launches a kernel (K3, the trainer's stem, is ``F.conv2d`` in
``models/layers.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIG = 1e30
_PLAIN_CHUNK = 128  # triangles per step of the plain raster


def rasterize_corners_plain(screen_xyz: torch.Tensor, color_rgb: torch.Tensor,
                            out_hw, cull: torch.Tensor = None):
    """Plain version of K1: the chunked argmin raster (edge functions at every
    pixel per triangle chunk, first nearest triangle per chunk, strictly-closer
    merge across chunks), one render at a time.

    screen_xyz / color_rgb (R, 3, 3, T); cull (R,) bool or None. Returns (image
    (R, H, W, 3) float32, background mask (R, H, W) bool)."""
    h, w = out_hw
    dev = screen_xyz.device
    r_n, t_total = screen_xyz.shape[0], screen_xyz.shape[-1]
    chunk = _PLAIN_CHUNK
    pad = (-t_total) % chunk
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    images, masks = [], []
    for r in range(r_n):
        sc = torch.nn.functional.pad(screen_xyz[r].to(torch.float32), (0, pad))
        co = torch.nn.functional.pad(color_rgb[r].to(torch.float32), (0, pad))
        zbuf = torch.full((h, w), _BIG, dtype=torch.float32, device=dev)
        img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        for s in range(0, t_total + pad, chunk):
            vc = sc[..., s:s + chunk].permute(2, 0, 1)  # (C, 3 corners, 3)
            cc = co[..., s:s + chunk].permute(2, 0, 1)
            tri_valid = (torch.arange(s, s + chunk, device=dev) < t_total)
            v0, v1, v2 = vc[:, 0], vc[:, 1], vc[:, 2]
            c0, c1, c2 = cc[:, 0], cc[:, 1], cc[:, 2]
            front = (v0[:, 2] > 1e-6) & (v1[:, 2] > 1e-6) & (v2[:, 2] > 1e-6) & tri_valid

            def edge(a, b):
                return (b[:, 0, None, None] - a[:, 0, None, None]) * (
                    ys - a[:, 1, None, None]
                ) - (b[:, 1, None, None] - a[:, 1, None, None]) * (xs - a[:, 0, None, None])

            e01 = edge(v0, v1)
            e12 = edge(v1, v2)
            e20 = edge(v2, v0)
            area = (
                (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])
            )[:, None, None]
            pos = (e01 >= 0) & (e12 >= 0) & (e20 >= 0)
            neg = (e01 <= 0) & (e12 <= 0) & (e20 <= 0)
            covered = torch.where(area > 0, pos, neg) & (torch.abs(area) > 1e-12)
            covered = covered & front[:, None, None]
            if cull is not None:
                covered = covered & (~cull[r] | (area < 0.0))
            safe_area = torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
            w0 = e12 / safe_area
            w1 = e20 / safe_area
            w2 = e01 / safe_area
            z = w0 * v0[:, 2, None, None] + w1 * v1[:, 2, None, None] + w2 * v2[:, 2, None, None]
            z = torch.where(covered, z, torch.full_like(z, _BIG))
            best = torch.argmin(z, dim=0)
            best_z = torch.gather(z, 0, best[None])[0]
            bw0 = torch.gather(w0, 0, best[None])[0]
            bw1 = torch.gather(w1, 0, best[None])[0]
            bw2 = torch.gather(w2, 0, best[None])[0]
            color = bw0[..., None] * c0[best] + bw1[..., None] * c1[best] + bw2[..., None] * c2[best]
            closer = best_z < zbuf
            zbuf = torch.where(closer, best_z, zbuf)
            img = torch.where(closer[..., None], color, img)
        mask_bg = zbuf >= _BIG
        images.append(torch.where(mask_bg[..., None], torch.zeros_like(img), img))
        masks.append(mask_bg)
    return torch.stack(images), torch.stack(masks)


def icn_stem_conv_plain(sketch, central, planes, kernel, pad: int = 3,
                        s_repeat: int = 1) -> torch.Tensor:
    """Plain version of K2. sketch (N, H, W, 3), central (N // s_repeat, H, W, 3),
    planes (N, P, H, W, 3), kernel (k, k, 3 * (2 + P), O) HWIO. Computes in float32
    (float64 for float64 inputs) and returns (N, H', W', O) in sketch's dtype."""
    n, h, w, _ = sketch.shape
    n_planes = planes.shape[1]
    acc = torch.promote_types(sketch.dtype, torch.float32)
    central_rep = central.repeat_interleave(s_repeat, dim=0)
    planes_cat = planes.permute(0, 2, 3, 1, 4).reshape(n, h, w, 3 * n_planes)
    inp = torch.cat([sketch, central_rep, planes_cat], dim=-1).to(acc)
    x = F.pad(inp.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(x, kernel.to(acc).permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).to(sketch.dtype)
