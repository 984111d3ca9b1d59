"""The scene pipeline's stages as batched tensor functions.

Counterpart of the JAX package's pipeline/stages.py. Every ``jax.vmap`` there is a
written-out batch dimension here: vehicles (V), and vehicle-steps flattened
vehicle-major into N = V * S. Each stage takes the :class:`ModelSpec` explicitly.
All images are float32 RGB in [0, 1], NHWC.

  perceive    crop -> CAD classify + keypoints                 (batch V)
  solve_poses LM-PnP with 4 restarts                           (batch 4V)
  rollout     trajectory -> per-step rigid motions             (batch V)
  render      posed sketches, one kernel-K1 launch             (batch N)
  warp        plane textures in dst-crop coordinates           (batch N)
  generate    ICN (stem = kernel K2) and VUNet                 (batch N)
  composite   masked stitch into the background, vehicle order (batch 2S)
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.geometry import pnp
from future_urban_scene_generation_tpu_torch.geometry.homography import (
    find_homography,
    find_homography_quad,
)
from future_urban_scene_generation_tpu_torch.geometry.rotations import z_rot
from future_urban_scene_generation_tpu_torch.geometry.trajectory import rollout_from_meters
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet, decode_heatmaps
from future_urban_scene_generation_tpu_torch.models.icn import GResnet
from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.models.layers import instance_norm, seeded_init_
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet
from future_urban_scene_generation_tpu_torch.ops import colorspace as cs
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.ops import cuda_conv
from future_urban_scene_generation_tpu_torch.ops.warp import bilinear_sample
from future_urban_scene_generation_tpu_torch.render import rasterizer as rz
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CROP = 256
SKETCH_RES = 256
# Resolution of the per-vehicle source-texture table the plane warp samples.
SRC_TABLE = 512
# Signed-LAB value of RGB black: L = 0, a = b = 128/255.
LAB_BLACK_SIGNED = (-1.0, 2.0 * 128.0 / 255.0 - 1.0, 2.0 * 128.0 / 255.0 - 1.0)


class CadBank(NamedTuple):
    """CAD meshes padded to common sizes (vertices x5-scaled like run_test.py).
    corners / corner_normals are the triangle-index expansion (C, 3 corners,
    3 xyz, Tmax); cullable marks meshes verified closed and outward-oriented."""

    vertices: torch.Tensor  # (C, Vmax, 3)
    triangles: torch.Tensor  # (C, Tmax, 3) int64
    normals: torch.Tensor  # (C, Vmax, 3)
    keypoints3d: torch.Tensor  # (C, 12, 3)
    corners: torch.Tensor  # (C, 3, 3, Tmax)
    corner_normals: torch.Tensor  # (C, 3, 3, Tmax)
    cullable: torch.Tensor  # (C,) bool

    def to(self, device) -> "CadBank":
        return CadBank(*(t.to(device) for t in self))


class Models(NamedTuple):
    cad: VGG19Classifier
    hourglass: HourglassNet
    icn: GResnet
    vunet: Vunet

    @staticmethod
    def build(spec: ModelSpec, generator: torch.Generator = None, *, device) -> "Models":
        """The four networks for ``spec``, in eval mode on ``device``. With a
        ``generator`` their parameters are drawn from it on the host
        (layers.seeded_init_) and then moved; without one they are left
        uninitialized for a weight load to fill."""
        models = Models(
            VGG19Classifier(num_classes=spec.num_cads),
            HourglassNet(spec.num_stacks, spec.num_blocks, spec.num_keypoints),
            GResnet(input_nc=spec.icn_input_nc),
            Vunet(vunet_256=spec.vunet_256),
        )
        for m in models:
            m.eval().requires_grad_(False)
            if generator is not None:
                seeded_init_(m, generator)
        return models.to(device)

    def to(self, device) -> "Models":
        return Models(*(m.to(device) for m in self))


class Perception(NamedTuple):
    cad_idx: torch.Tensor  # (V,)
    kp_frame: torch.Tensor  # (V, 12, 2)
    window: cr.Window  # fields (V,)
    crop: torch.Tensor  # (V, 256, 256, 3)


def _maybe_flip_rgb(spec: ModelSpec, img):
    return img.flip(-1) if spec.reference_channel_order else img


def _to_signed_lab(rgb01):
    return cs.rgb_to_lab(rgb01) * 2.0 - 1.0


def _lab_black(device):
    return torch.tensor(LAB_BLACK_SIGNED, dtype=torch.float32, device=device)


def perceive(models: Models, spec: ModelSpec, frame, bboxes) -> Perception:
    """Square crops, CAD classification and keypoints mapped to frame pixels
    (trajectory_inference.py:56-96). frame (H, W, 3), bboxes (V, 4) xyxy."""
    window = cr.square_window_from_bbox(bboxes)
    crop = cr.crop_resize(frame, window, CROP)
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device)
    std = torch.tensor(IMAGENET_STD, device=frame.device)
    norm = (_maybe_flip_rgb(spec, crop) - mean) / std
    with layers.quantized_convs(spec.quantized_convs):
        logits = models.cad(norm)
        heat = models.hourglass(norm)[-1]
    kp_frame = cr.crop_to_frame_coords(decode_heatmaps(heat), window)
    return Perception(torch.argmax(logits, dim=-1), kp_frame, window, crop)


def solve_poses(perception: Perception, cad_bank: CadBank, intrinsic):
    """Batched CPC PnP: returns (mse (V,), rvec (V, 3), tvec (V, 3))."""
    focals = torch.stack([intrinsic[0, 0], intrinsic[1, 1]])
    centers = torch.stack([intrinsic[0, 2], intrinsic[1, 2]])
    kp3d = cad_bank.keypoints3d[perception.cad_idx]
    return pnp.solve_pnp_4restarts(kp3d, perception.kp_frame, focals, centers)


def pose_rollout(meter_coords):
    """Per-step rigid motions including the identity step 0: (theta (V, T),
    translation (V, T, 3)) for (V, T, 2) trajectories."""
    r = rollout_from_meters(meter_coords)
    v = meter_coords.shape[0]
    theta = torch.cat([torch.zeros(v, 1, device=r.theta.device), r.theta], dim=1)
    tr = torch.cat([torch.zeros(v, 1, 3, device=r.theta.device), r.translation], dim=1)
    return theta, tr


def _sketch_window(verts_screen) -> cr.Window:
    """Square window from each render's projected-vertex bbox (R, Nv, 3)."""
    bbox = torch.stack(
        [
            verts_screen[..., 0].amin(-1), verts_screen[..., 1].amin(-1),
            verts_screen[..., 0].amax(-1), verts_screen[..., 1].amax(-1),
        ],
        dim=-1,
    )
    return cr.square_window_from_bbox(bbox)


def _rotate_lane_major(xyz, rot):
    """(R, 3 corners, 3 xyz, T) row vectors times rot (R, 3, 3), component FMAs."""
    x, y, z = xyz[:, :, 0], xyz[:, :, 1], xyz[:, :, 2]
    r = rot[:, None, :, :, None]  # (R, 1, 3, 3, 1)
    return torch.stack(
        [
            x * r[:, :, 0, 0] + y * r[:, :, 1, 0] + z * r[:, :, 2, 0],
            x * r[:, :, 0, 1] + y * r[:, :, 1, 1] + z * r[:, :, 2, 1],
            x * r[:, :, 0, 2] + y * r[:, :, 1, 2] + z * r[:, :, 2, 2],
        ],
        dim=2,
    )


def posed_corners(vertices, corners, corner_normals, extrinsic, intrinsic, theta,
                  translation):
    """World-space corners/normals of R posed vehicles and their crop cameras:
    returns (corners_w, normals_w, crop camera, window fields (R,))."""
    rot = z_rot(theta)
    verts_w = vertices @ rot + translation[:, None]
    cam_full = rz.Camera.from_intrinsic(intrinsic)
    cam_full = rz.Camera(*(torch.broadcast_to(f, theta.shape) for f in cam_full))
    screen = rz.project_vertices(verts_w, extrinsic, cam_full)
    window = _sketch_window(screen)
    scale = SKETCH_RES / window.w
    cam_crop = cam_full.crop(window.x_start, window.y_start, scale)
    corners_w = _rotate_lane_major(corners, rot) + translation[:, None, :, None]
    normals_w = _rotate_lane_major(corner_normals, rot)
    return corners_w, normals_w, cam_crop, window


def render_vehicle(vertices, corners, corner_normals, extrinsic, intrinsic, theta,
                   translation, cull=None):
    """Render R posed vehicles' normal sketches at their own crop windows, in one
    kernel-K1 launch. vertices (R, Nv, 3) define the windows; corners /
    corner_normals (R, 3, 3, T); extrinsic (R, 4, 4); theta (R,); translation
    (R, 3); cull (R,) bool. Returns (sketch (R, S, S, 3), vehicle mask (R, S, S),
    window fields (R,))."""
    corners_w, normals_w, cam_crop, window = posed_corners(
        vertices, corners, corner_normals, extrinsic, intrinsic, theta, translation
    )
    sketch, bg = rz.render_normal_sketch_corners(
        corners_w, normals_w, extrinsic, cam_crop, (SKETCH_RES, SKETCH_RES), cull=cull
    )
    return sketch, ~bg, window


def _inside_poly(pts_x, pts_y, poly):
    """Even-odd point-in-polygon of points (N, a, b) against polygons (N, K, 2)."""
    inside = torch.zeros(pts_x.shape, dtype=torch.bool, device=pts_x.device)
    k = poly.shape[1]
    for e in range(k):
        x1 = poly[:, e, 0, None, None]
        y1 = poly[:, e, 1, None, None]
        x2 = poly[:, (e + 1) % k, 0, None, None]
        y2 = poly[:, (e + 1) % k, 1, None, None]
        straddle = (y1 > pts_y) != (y2 > pts_y)
        denom = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
        x_cross = x1 + (pts_y - y1) * (x2 - x1) / denom
        inside = inside ^ (straddle & (pts_x < x_cross))
    return inside


def warp_planes_to_crop(spec: ModelSpec, src_table, src_window: cr.Window, src_polys,
                        dst_polys, src_vis, dst_vis, dst_window: cr.Window,
                        table_index) -> torch.Tensor:
    """Warped texture planes in dst-crop coordinates, N vehicle-steps at once.

    src_table (V, T, T, 3) signed-LAB source window of each vehicle (any float
    dtype; sampled in float32); src_window fields (V,); src_polys / dst_polys
    (N, 5, 6, 2) plane polygons (TEXTURE_PLANES topology: roof/front/back are
    4-point quads padded to 6); src_vis / dst_vis (N, 5) bool; dst_window
    fields (N,); table_index (N,) the vehicle of each row. For crop pixel q:
    frame point p = window(q), source point s = H^-1(p), value = table(s) if s
    lies in the source polygon. Skip/symmetry rules as warp_unwarp_planes
    (warp_learn/planes_utils.py:46-68). Returns (N, 5, S, S, 3) signed LAB.
    """
    s_res = SKETCH_RES
    dev = dst_polys.device
    n = dst_polys.shape[0]
    ar = torch.arange(n, device=dev)
    black = _lab_black(dev)
    table = src_table.shape[1]
    left, right = vis.SYMMETRY_PAIR
    front, back = vis.OPPOSITE_PAIR
    r = int(spec.warp_plane_res)
    sx0 = src_window.x_start[table_index][:, None, None]
    sy0 = src_window.y_start[table_index][:, None, None]
    sw = src_window.w[table_index][:, None, None]
    sh = src_window.h[table_index][:, None, None]

    dx0 = dst_window.x_start[:, None, None]
    dy0 = dst_window.y_start[:, None, None]
    qs = (torch.arange(s_res, dtype=torch.float32, device=dev) + 0.5) / s_res
    px = torch.broadcast_to(dx0 + qs[None, None, :] * dst_window.w[:, None, None] - 0.5,
                            (n, s_res, s_res))
    py = torch.broadcast_to(dy0 + qs[None, :, None] * dst_window.h[:, None, None] - 0.5,
                            (n, s_res, s_res))

    def warp_one(src_idx, dst_idx, extra_skip, quad=False):
        sp = src_polys[ar, src_idx]
        dp = dst_polys[ar, dst_idx]
        if quad and spec.quad_homography:
            h12, valid = find_homography_quad(sp[:, :4], dp[:, :4])
        else:
            h12, valid = find_homography(sp, dp)
        h_inv = torch.linalg.inv_ex(h12).inverse
        hi = h_inv[:, :, :, None, None]  # (N, 3, 3, 1, 1)

        def sample(gx, gy):
            denom = hi[:, 2, 0] * gx + hi[:, 2, 1] * gy + hi[:, 2, 2]
            denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
            sx = (hi[:, 0, 0] * gx + hi[:, 0, 1] * gy + hi[:, 0, 2]) / denom
            sy = (hi[:, 1, 0] * gx + hi[:, 1, 1] * gy + hi[:, 1, 2]) / denom
            tx = (sx - sx0 + 0.5) * (table / sw) - 0.5
            ty = (sy - sy0 + 0.5) * (table / sh) - 0.5
            tex = bilinear_sample(src_table, tx, ty, table_index)
            mask = _inside_poly(sx, sy, sp)
            return torch.where(mask[..., None], tex, black)

        if r == s_res:
            tex = sample(px, py)
        else:
            pad = 1.0
            bx0 = dp[..., 0].amin(-1) - pad
            bx1 = dp[..., 0].amax(-1) + pad
            by0 = dp[..., 1].amin(-1) - pad
            by1 = dp[..., 1].amax(-1) + pad
            bw = torch.clamp(bx1 - bx0, min=1e-3)
            bh = torch.clamp(by1 - by0, min=1e-3)
            qs_r = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
            gx = torch.broadcast_to(bx0[:, None, None] + qs_r[None, None, :] * bw[:, None, None],
                                    (n, r, r))
            gy = torch.broadcast_to(by0[:, None, None] + qs_r[None, :, None] * bh[:, None, None],
                                    (n, r, r))
            rel = sample(gx, gy) - black
            ax = s_res / dst_window.w
            ay = s_res / dst_window.h
            b_x = -ax * dst_window.x_start + 0.5 * ax - 0.5
            b_y = -ay * dst_window.y_start + 0.5 * ay - 0.5
            scale = torch.stack([ay * bh / r, ax * bw / r], dim=-1)
            translation = torch.stack([ay * by0 + b_y, ax * bx0 + b_x], dim=-1)
            pasted = cr.scale_and_translate(rel, (s_res, s_res), scale, translation,
                                            antialias=True)
            tex = pasted + black

        ok = valid & ~extra_skip
        write = F.one_hot(dst_idx, vis.NUM_TEXTURE_PLANES).to(torch.float32)
        write = (write * ok.to(torch.float32)[:, None])[:, :, None, None, None]
        return tex, write

    out = torch.broadcast_to(black, (n, vis.NUM_TEXTURE_PLANES, s_res, s_res, 3))

    def idx(flag, a, b):
        return torch.where(flag, torch.full_like(ar, a), torch.full_like(ar, b))

    # Left/right are opposite faces: one warp, source = the src-visible side,
    # slot = the dst-visible side.
    side_skip = ~((src_vis[:, left] | src_vis[:, right]) & (dst_vis[:, left] | dst_vis[:, right]))
    tex, write = warp_one(idx(src_vis[:, left], left, right),
                          idx(dst_vis[:, left], left, right), side_skip)
    out = out * (1.0 - write) + tex[:, None] * write

    # Front/back share one warp too (front->front or back->back, never both).
    fb_front = src_vis[:, front] & dst_vis[:, front]
    fb_back = src_vis[:, back] & dst_vis[:, back]
    fb_idx = idx(fb_front, front, back)
    tex, write = warp_one(fb_idx, fb_idx, ~(fb_front | fb_back), quad=True)
    out = out * (1.0 - write) + tex[:, None] * write

    for i in range(vis.NUM_TEXTURE_PLANES):
        if i in (left, right, front, back):
            continue
        skip = ~src_vis[:, i] | ~dst_vis[:, i]
        tex, write = warp_one(torch.full_like(ar, i), torch.full_like(ar, i), skip, quad=True)
        out = out * (1.0 - write) + tex[:, None] * write
    return out


def central_crop_patch(frame, bbox_window: cr.Window):
    """The 20%-side central patch of each bbox crop, resized to 256^2 — the ICN
    appearance prior (warp_learn/vehicle_utils.py:35-53). Returns (V, 256, 256, 3)."""
    crop = cr.crop_resize(frame, bbox_window, CROP)
    offset = int(CROP * 0.1)
    dev = frame.device
    patch_win = cr.Window(
        torch.tensor(float(CROP // 2 - offset), device=dev),
        torch.tensor(float(CROP // 2 - offset), device=dev),
        torch.tensor(float(2 * offset), device=dev),
        torch.tensor(float(2 * offset), device=dev),
    )
    return cr.crop_resize(crop, patch_win, CROP)


def icn_synthesize_batch(models: Models, spec: ModelSpec, dst_sketches, central_lab,
                         planes_lab, s_repeat: int = 1):
    """One batch-N ICN forward with the stem computed by kernel K2.

    dst_sketches (N, 256, 256, 3) RGB; central_lab (N // s_repeat, 256, 256, 3)
    signed LAB, read at n // s_repeat inside the kernel; planes_lab
    (N, 5, 256, 256, 3) signed LAB. Returns RGB [0, 1] (N, 256, 256, 3) float32.
    """
    dtype = spec.gen_dtype
    stem = models.icn.stem
    kernel = stem.conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()  # HWIO
    x = cuda_conv.icn_stem_conv(
        _to_signed_lab(dst_sketches).to(dtype).contiguous(),
        central_lab.to(dtype).contiguous(),
        planes_lab.to(dtype).contiguous(),
        kernel,
        pad=stem.padding,
        s_repeat=s_repeat,
    )
    x = x + stem.conv.bias.to(x.dtype)
    x = F.relu(instance_norm(x))
    with layers.quantized_convs(spec.quantized_convs):
        out = models.icn(x, from_stem=True).to(torch.float32)
    return cs.lab_to_rgb((out + 1.0) / 2.0)


def icn_synthesize(models: Models, spec: ModelSpec, dst_sketch, central_patch_lab,
                   planes_warped_lab):
    """One vehicle-step's ICN (JAX :534): dst_sketch (256, 256, 3) RGB, the central
    patch (256, 256, 3) and planes (5, 256, 256, 3) in signed LAB -> RGB (256, 256, 3)."""
    return icn_synthesize_batch(models, spec, dst_sketch[None], central_patch_lab[None],
                                planes_warped_lab[None])[0]


def vunet_encode_appearance(models: Models, spec: ModelSpec, frame, src_sketch, src_mask,
                            src_window: cr.Window) -> List[torch.Tensor]:
    """One vehicle's appearance means (JAX :631), leading batch 1; the window's
    fields are 0-d."""
    return vunet_encode_appearance_batch(models, spec, frame, src_sketch[None], src_mask[None],
                                         src_window.map(lambda f: f.reshape(1)))


def vunet_synthesize(models: Models, spec: ModelSpec, dst_sketch, mu_app):
    """One step's VUNet decode (JAX :661) from means with leading batch 1."""
    return vunet_decode_batch(models, spec, dst_sketch[None], mu_app)[0]


def vunet_encode_appearance_batch(models: Models, spec: ModelSpec, frame, src_sketches,
                                  src_masks, src_windows: cr.Window) -> List[torch.Tensor]:
    """Appearance means for V vehicles: x = [masked vehicle RGB on white, source
    sketch], both in [-1, 1] (trajectory_inference.py:205-231)."""
    veh = _maybe_flip_rgb(spec, cr.crop_resize(frame, src_windows, CROP))
    masked = torch.where(src_masks[..., None], veh, torch.ones_like(veh))
    sketches = _maybe_flip_rgb(spec, src_sketches)
    x = torch.cat([masked * 2.0 - 1.0, sketches * 2.0 - 1.0], dim=-1).to(spec.gen_dtype)
    # The int8 tier leaves VUNet float (layers.suppress_quantization), as JAX :653-657.
    with layers.suppress_quantization():
        return models.vunet.encode_appearance(x)


def vunet_decode_batch(models: Models, spec: ModelSpec, dst_sketches, mu_app):
    """One batch-N VUNet shape decode; each ``mu_app`` entry has leading N."""
    dtype = spec.gen_dtype
    y_tilde = (_maybe_flip_rgb(spec, dst_sketches) * 2.0 - 1.0).to(dtype)
    with layers.suppress_quantization():  # JAX :674-678
        out = models.vunet.decode_shape(y_tilde, [m.to(dtype) for m in mu_app])
    return torch.clamp((out.to(torch.float32) + 1.0) / 2.0, 0.0, 1.0)


def composite_frames(spec: ModelSpec, backgrounds, crops, windows: cr.Window, masks):
    """Composite F frames of V vehicles each, in vehicle order (sequential
    overwrite, trajectory_inference.py:197-198). backgrounds (F, H, W, 3); crops
    (F, V, 256, 256, 3); window fields (F, V); masks (F, V, 256, 256) bool. Under
    the bf16 serving config the full-frame resample canvases are bfloat16."""
    resample_dtype = torch.bfloat16 if spec.generator_dtype == "bfloat16" else None
    out = backgrounds
    for v in range(crops.shape[1]):
        out = cr.stitch_packed(
            out, crops[:, v], windows.map(lambda f: f[:, v]), masks[:, v],
            resample_dtype=resample_dtype,
        )
    return out


def _mask_to_frame(mask_crop, window: cr.Window, hw) -> torch.Tensor:
    """Crop-resolution masks (B, S, S) sampled at frame pixels inside their windows
    (fields (B,)): a linear resample of the float mask, thresholded at 0.5 (JAX
    stages._mask_to_frame :771, batched). Returns (B, H, W) bool."""
    h, w = hw
    s = mask_crop.shape[1]
    canvas = cr.scale_and_translate(
        mask_crop.to(torch.float32)[..., None],
        (h, w),
        torch.stack([window.h / s, window.w / s], dim=-1),
        torch.stack([window.y_start, window.x_start], dim=-1),
        antialias=False,
    )[..., 0]
    return (canvas > 0.5) & cr.inside_window(window, h, w, mask_crop.device)


def composite_step(spec: ModelSpec, background, crops, windows: cr.Window, masks):
    """One frame: background (H, W, 3), crops (V, ...), window fields (V,)."""
    return composite_frames(
        spec, background[None], crops[None], windows.map(lambda f: f[None]), masks[None]
    )[0]
