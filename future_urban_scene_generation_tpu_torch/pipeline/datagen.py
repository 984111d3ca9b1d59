"""Synthetic training pairs, made on the device from the pipeline's own geometry.

Counterpart of the JAX package's pipeline/datagen.py ``_random_pose`` (:55),
``_vehicle_views`` (:65), ``icn_batch`` (:91), ``vunet_batch`` (:137), ``cad_batch``
(:171), ``hourglass_batch`` (:200) and ``edgeconnect_batch`` (:232). The JAX
version draws from a key inside a vmapped function; here every family is split in
two:

* the random draws from an explicit ``torch.Generator``, made on the CPU:
  :func:`icn_draws` (CAD index, yaw U(0, 2 pi), tilt U(-1.45, -1.1), distance
  U(12, 28), heading delta U(-0.6, 0.6); the VUNet pairs take the same draws) and
  :func:`pose_draws` (CAD index and pose, for the classifier and the hourglass),
  :func:`edgeconnect_draws` (each box mask's corner);
* a deterministic pair maker, batched over B, with every render of a batch in one
  kernel-K1 launch: :func:`icn_pairs` (src and dst views, visibility, plane
  polygons, the src sketch pasted into the frame as texture, the per-sample source
  table as ``runner.scene_geometry`` builds it, the plane warps),
  :func:`vunet_pairs`, :func:`cad_pairs`, :func:`hourglass_pairs`, and
  :func:`edgeconnect_pairs` (gray image, Canny edges and box masks of a batch of
  images, for the EdgeConnect trainers).

A test can therefore feed the JAX package's own draws to the pair makers.
:func:`on_own_stream` runs a family's maker on a CUDA stream of its own (the trainers'
``make_batch``), so that its stream syncs wait for its own kernels and not for the train
step's queue.
Samples are float32 NHWC. ICN, signed LAB ([-1, 1]): x = [dst sketch (3) | central
prior (3) | 5 warped planes (15)], y = the dst view of the textured vehicle, masked.
VUNet, [-1, 1]: y_tilde = dst sketch, x_app = [masked vehicle crop | src sketch],
target = the masked dst view. Classifier: [0, 1] sketch renders and their bank index.
Hourglass: [0, 1] sketch renders and the 12 keypoints in crop coordinates, [0, 1].
EdgeConnect: [0, 1] gray image, {0, 1} edges and masks (1 = hole), one channel each.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils._pytree import tree_flatten

from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
from future_urban_scene_generation_tpu_torch.ops import canny as cn
from future_urban_scene_generation_tpu_torch.ops import colorspace as cs
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import graphs, stages
from future_urban_scene_generation_tpu_torch.pipeline.stages import CadBank
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import profiling


STREAM_BATCHES = 0  # batches made on a maker's own CUDA stream (:func:`on_own_stream`)
# A stream priority past any device's highest: torch maps it to the highest there is.
_HIGHEST_PRIORITY = -(1 << 16)


class ICNSample(NamedTuple):
    inputs: torch.Tensor  # (B, 256, 256, 21) signed LAB
    targets: torch.Tensor  # (B, 256, 256, 3) signed LAB


class ICNDraws(NamedTuple):
    cad_idx: torch.Tensor  # (B,) int64 CAD-bank index
    extrinsic: torch.Tensor  # (B, 4, 4) camera pose of the src view
    dtheta: torch.Tensor  # (B,) heading change from the src to the dst view


class VunetSample(NamedTuple):
    y_tilde: torch.Tensor  # (B, 256, 256, 3) [-1, 1]
    x_app: torch.Tensor  # (B, 256, 256, 6) [-1, 1]
    target: torch.Tensor  # (B, 256, 256, 3) [-1, 1]


class CadSample(NamedTuple):
    images: torch.Tensor  # (B, 256, 256, 3) [0, 1] sketch renders
    labels: torch.Tensor  # (B,) int64 CAD-bank index


class HourglassSample(NamedTuple):
    images: torch.Tensor  # (B, 256, 256, 3) [0, 1] sketch renders
    kp_norm: torch.Tensor  # (B, 12, 2) keypoints in crop coordinates, [0, 1]


class PoseDraws(NamedTuple):
    cad_idx: torch.Tensor  # (B,) int64 CAD-bank index
    extrinsic: torch.Tensor  # (B, 4, 4) camera pose


def _random_pose(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(B, 4, 4) extrinsics: R = x_rot(tilt) @ z_rot(yaw), t = (0, 1, dist)."""
    yaw = torch.rand(batch, generator=generator) * (2.0 * math.pi)
    tilt = torch.rand(batch, generator=generator) * 0.35 - 1.45
    dist = torch.rand(batch, generator=generator) * 16.0 + 12.0
    ext = torch.eye(4).repeat(batch, 1, 1)
    ext[:, :3, :3] = x_rot(tilt) @ z_rot(yaw)
    ext[:, 1, 3] = 1.0
    ext[:, 2, 3] = dist
    return ext


def icn_draws(generator: torch.Generator, n_cads: int, batch: int) -> ICNDraws:
    """The random part of an ICN batch, on the CPU."""
    cad_idx = torch.randint(0, n_cads, (batch,), generator=generator)
    ext = _random_pose(generator, batch)
    dtheta = torch.rand(batch, generator=generator) * 1.2 - 0.6
    return ICNDraws(cad_idx, ext, dtheta)


def pose_draws(generator: torch.Generator, n_cads: int, batch: int) -> PoseDraws:
    """The random part of a classifier or hourglass batch, on the CPU."""
    cad_idx = torch.randint(0, n_cads, (batch,), generator=generator)
    return PoseDraws(cad_idx, _random_pose(generator, batch))


def _vehicle_views(cad_bank: CadBank, intrinsic, draws: ICNDraws, vis_res: int = 192,
                   planes: bool = True):
    """Render the src (heading 0) and dst (heading dtheta) views of every sample in
    one launch. Returns (src, dst), each (sketch, mask, window, visibility (B, 5),
    plane polygons (B, 5, 6, 2)); without ``planes`` each is (sketch, mask, window)."""
    b = draws.cad_idx.shape[0]
    idx = torch.cat([draws.cad_idx, draws.cad_idx])
    ext = torch.cat([draws.extrinsic, draws.extrinsic])
    theta = torch.cat([torch.zeros_like(draws.dtheta), draws.dtheta])
    sketch, mask, window = stages.render_vehicle(
        cad_bank.vertices[idx], cad_bank.corners[idx], cad_bank.corner_normals[idx],
        ext, intrinsic, theta, torch.zeros(2 * b, 3, device=theta.device),
    )
    views = (sketch, mask, window)
    if planes:
        kp3d_s = cad_bank.keypoints3d[idx] @ z_rot(theta)
        kp2d_s = project_points_extrinsic(kp3d_s, intrinsic, ext)
        visibility = vis.compute_visibility_local(ext, kp2d_s, kp3d_s, res=vis_res)[:, :5]
        polys = torch.trunc(kp2d_s)[:, torch.as_tensor(vis.TEXTURE_PLANES, device=ext.device)]
        views += (visibility, polys)

    def part(sl):
        return tuple(v.map(lambda f: f[sl]) if isinstance(v, cr.Window) else v[sl]
                     for v in views)

    return part(slice(0, b)), part(slice(b, 2 * b))


def icn_pairs(cad_bank: CadBank, frame, intrinsic, draws: ICNDraws, *,
              vis_res: int = 192) -> ICNSample:
    """Self-supervised ICN pairs for given draws: the src sketch pasted onto
    ``frame`` (H, W, 3) is the vehicle's texture, and the target is the dst view of
    the same textured vehicle. Everything runs on ``frame``'s device. The plane warps
    use the default ``ModelSpec`` (256² sampling), as the JAX datagen reads the
    default ``MODEL_SPEC``."""
    dev = frame.device
    draws = ICNDraws(*(t.to(dev) for t in draws))
    b = draws.cad_idx.shape[0]
    with profiling.trace("fusg.datagen.views"):
        src, dst = _vehicle_views(cad_bank, intrinsic, draws, vis_res)
    with profiling.trace("fusg.datagen.pairs"):
        s_sk, s_mask, s_win, s_vis, s_polys = src
        d_sk, d_mask, d_win, d_vis, d_polys = dst
        textured = cr.stitch(frame, s_sk, s_win,
                             stages._mask_to_frame(s_mask, s_win, frame.shape[:2]))
        src_table = stages._to_signed_lab(cr.crop_resize(textured, s_win, stages.SRC_TABLE))
        planes = stages.warp_planes_to_crop(ModelSpec(), src_table, s_win, s_polys, d_polys,
                                            s_vis, d_vis, d_win, torch.arange(b, device=dev))
        central = stages._to_signed_lab(stages.central_crop_patch(textured, s_win))
        res = planes.shape[2]
        planes_lab = planes.permute(0, 2, 3, 1, 4).reshape(b, res, res, -1)
        x = torch.cat([stages._to_signed_lab(d_sk), central, planes_lab], dim=-1)
        y = stages._to_signed_lab(d_sk * d_mask[..., None])
    return ICNSample(x, y)


def icn_batch(generator: torch.Generator, cad_bank: CadBank, frame, intrinsic,
              batch: int = 4, *, vis_res: int = 192) -> ICNSample:
    """A batch of ICN pairs: :func:`icn_draws` then :func:`icn_pairs`."""
    with profiling.trace("fusg.datagen.draws"):
        draws = icn_draws(generator, cad_bank.vertices.shape[0], batch)
        draws = ICNDraws(*(t.to(frame.device) for t in draws))
    return icn_pairs(cad_bank, frame, intrinsic, draws, vis_res=vis_res)


def vunet_pairs(cad_bank: CadBank, frame, intrinsic, draws: ICNDraws) -> VunetSample:
    """VUNet pairs for given draws: the appearance input is the frame's crop at the
    src window, white outside the src vehicle, beside the src sketch; the shape
    input is the dst sketch and the target its masked rendering."""
    draws = ICNDraws(*(t.to(frame.device) for t in draws))
    src, dst = _vehicle_views(cad_bank, intrinsic, draws, planes=False)
    s_sk, s_mask, s_win = src
    d_sk, d_mask, _ = dst
    veh = cr.crop_resize(frame, s_win, stages.CROP)
    masked = torch.where(s_mask[..., None], veh, torch.ones_like(veh))
    x_app = torch.cat([masked * 2 - 1, s_sk * 2 - 1], dim=-1)
    return VunetSample(d_sk * 2.0 - 1.0, x_app, (d_sk * d_mask[..., None]) * 2.0 - 1.0)


def vunet_batch(generator: torch.Generator, cad_bank: CadBank, frame, intrinsic,
                batch: int = 4) -> VunetSample:
    """A batch of VUNet pairs: :func:`icn_draws` then :func:`vunet_pairs`."""
    draws = icn_draws(generator, cad_bank.vertices.shape[0], batch)
    return vunet_pairs(cad_bank, frame, intrinsic, draws)


def _render_at_pose(cad_bank: CadBank, intrinsic, draws: PoseDraws):
    """(sketch, window, draws on the bank's device) of each sample at heading 0."""
    dev = cad_bank.vertices.device
    draws = PoseDraws(*(t.to(dev) for t in draws))
    idx, b = draws.cad_idx, draws.cad_idx.shape[0]
    sketch, _mask, window = stages.render_vehicle(
        cad_bank.vertices[idx], cad_bank.corners[idx], cad_bank.corner_normals[idx],
        draws.extrinsic, intrinsic, torch.zeros(b, device=dev), torch.zeros(b, 3, device=dev),
    )
    return sketch, window, draws


def cad_pairs(cad_bank: CadBank, intrinsic, draws: PoseDraws) -> CadSample:
    """Classification pairs for given draws: a bank entry rendered at a pose,
    labeled by its bank index (shape-dependent sketches: a real discrimination
    task)."""
    sketch, _window, draws = _render_at_pose(cad_bank, intrinsic, draws)
    return CadSample(sketch, draws.cad_idx.to(torch.int64))


def cad_batch(generator: torch.Generator, cad_bank: CadBank, intrinsic,
              batch: int = 8) -> CadSample:
    """A batch of classifier pairs: :func:`pose_draws` then :func:`cad_pairs`."""
    return cad_pairs(cad_bank, intrinsic,
                     pose_draws(generator, cad_bank.vertices.shape[0], batch))


def hourglass_pairs(cad_bank: CadBank, intrinsic, draws: PoseDraws) -> HourglassSample:
    """Keypoint pairs for given draws: sketch renders and the 12 CAD keypoints
    projected into the crop window, normalized to [0, 1] (the frame
    ``decode_heatmaps`` decodes to, utils/keypoint_utils.py:66-92)."""
    sketch, win, draws = _render_at_pose(cad_bank, intrinsic, draws)
    kp2d = project_points_extrinsic(cad_bank.keypoints3d[draws.cad_idx], intrinsic,
                                    draws.extrinsic)
    origin = torch.stack([win.x_start, win.y_start], dim=-1)[:, None, :]
    kp_norm = (kp2d - origin) / win.w[:, None, None]
    return HourglassSample(sketch, torch.clamp(kp_norm, 0.0, 1.0))


def hourglass_batch(generator: torch.Generator, cad_bank: CadBank, intrinsic,
                    batch: int = 4) -> HourglassSample:
    """A batch of keypoint pairs: :func:`pose_draws` then :func:`hourglass_pairs`."""
    return hourglass_pairs(cad_bank, intrinsic,
                           pose_draws(generator, cad_bank.vertices.shape[0], batch))


class EdgeConnectSample(NamedTuple):
    gray: torch.Tensor  # (B, H, W, 1) [0, 1]
    edges: torch.Tensor  # (B, H, W, 1) {0, 1} Canny edges of gray
    masks: torch.Tensor  # (B, H, W, 1) {0, 1}, an (H // 3) x (W // 3) box of 1 (hole)


def edgeconnect_draws(generator: torch.Generator, batch: int, hw):
    """Each mask's top-left corner: (y0, x0), (B,) int64, y0 ~ U{0, H/2 - 1},
    x0 ~ U{0, W/2 - 1} (JAX datagen.py:243-246)."""
    h, w = hw
    y0 = torch.randint(0, h // 2, (batch,), generator=generator)
    x0 = torch.randint(0, w // 2, (batch,), generator=generator)
    return y0, x0


def edgeconnect_pairs(images, y0, x0, sigma: float = 2.0) -> EdgeConnectSample:
    """The EdgeConnect trainers' inputs from (B, H, W, 3) RGB images in [0, 1] and
    the mask corners: the gray image (``colorspace.rgb_to_gray``), its Canny edges
    (the batched ``ops/canny``, ``sigma``) and the (H // 3) x (W // 3) box masks."""
    b, h, w, _ = images.shape
    gray = cs.rgb_to_gray(images)
    edges = cn.canny(gray[..., 0], sigma=sigma).to(images.dtype)[..., None]
    dev = images.device
    y0, x0 = y0.to(dev)[:, None, None], x0.to(dev)[:, None, None]
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    box = (ys >= y0) & (ys < y0 + h // 3) & (xs >= x0) & (xs < x0 + w // 3)
    return EdgeConnectSample(gray, edges, box.to(images.dtype)[..., None])


def edgeconnect_batch(generator: torch.Generator, images, sigma: float = 2.0
                      ) -> EdgeConnectSample:
    """:func:`edgeconnect_draws` then :func:`edgeconnect_pairs`."""
    return edgeconnect_pairs(images, *edgeconnect_draws(generator, images.shape[0],
                                                        images.shape[1:3]), sigma=sigma)


class _OwnStream:
    """``make`` on a stream of its own; see :func:`on_own_stream`."""

    def __init__(self, make, device: torch.device):
        self.make, self.device = make, device
        self.stream = self.done = None

    def __call__(self):
        global STREAM_BATCHES
        if not graphs.untraced():
            return self.make()
        caller = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device, priority=_HIGHEST_PRIORITY)
            self.stream.wait_stream(caller)  # the data source's uploads; never again
            self.done = torch.cuda.Event()
        with profiling.trace("fusg.datagen.stream"), torch.cuda.stream(self.stream):
            out = self.make()
            self.done.record(self.stream)
        caller.wait_event(self.done)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(caller)
        STREAM_BATCHES += 1
        return out


def on_own_stream(make, device):
    """``make`` (a family's batch maker: no arguments, a tuple of tensors and other
    values) run on a CUDA stream of its own, so that its stream syncs (the pageable upload
    of the draws, the visibility tables, the homographies' ``eigh`` check) wait for its own
    kernels only, and the host makes the next batch while the card still runs the step.
    A device-wide sync still waits for every stream: MAGMA's batched ``cholesky_solve`` in
    the homographies' polish frees device memory (``cudaFree``) at each call.

    The stream is made at the first call, at the highest priority the device offers (a
    sync there waits behind a few small kernels, not the step's convs), and waits once,
    then, on the caller's current stream: the data source's uploads. The caller's stream
    then waits on the card for each batch's end (an event), and each CUDA tensor of the
    batch is marked as used there (``record_stream``), so that the allocator hands its
    memory back to the maker only after the caller's work on it. Each batch is counted
    in :data:`STREAM_BATCHES`, inside a ``fusg.datagen.stream`` span. The draws and the
    kernels are the maker's own, so the batches are the inline ones, bit for bit. On the
    CPU, and under stream capture, fake tensors, ``torch.export`` or compilation, ``make``
    runs inline."""
    device = torch.device(device)
    return _OwnStream(make, device) if device.type == "cuda" else make
