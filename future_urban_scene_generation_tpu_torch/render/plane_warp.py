"""The scene's plane warp: each vehicle-step's texture planes in its destination crop.

Counterpart of the JAX package's pipeline/stages.py ``warp_planes_to_crop`` (the skip
and symmetry rules of warp_learn/planes_utils.py:46-68). :func:`warp_planes_plain` is
the warp as batched torch: per row three homographies (the side pair, front/back, the
remaining plane), each warp's sample through its inverse, the even-odd polygon test
and, on a grid below the crop's, the antialiased paste into the crop, composited into
the 5 slots. On the card it is some 1,300-1,700 eager operations a call.

The scene calls the operator ``fusg::plane_warp`` (:func:`warp_planes`): on CPU tensors
it is :func:`warp_planes_plain`; on CUDA tensors the homographies come from the plain
warp's own calls, batched (:func:`_warp_plan`), and kernel W1
(``csrc/plane_warp.cu``) does the rest: the slot rules, the sample, the polygon test, the
paste and the composite, in one launch at a 256^2 grid and two below it (the grid, then
the paste and composite). The call counts in ``LAUNCHES``. W1 repeats the plain warp's
elementwise arithmetic on the card rounding for rounding; the paste's sums are its own.
The homographies stay the plain warp's because a plane a few pixels wide has a near
singular homography, whose inverse a rounding moves by percents: the scene judge holds
the warp to the plain one's bits there. Their ``eigh`` still makes the host wait for the
card once a call. At a reduced grid the plain warp's two spans stay:
``fusg.plane_warp.sample`` around the homographies and the grid,
``fusg.plane_warp.paste`` around the paste; the 256^2 warp opens none. An exported
scene holds the warp as one node.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.geometry.homography import (
    find_homography,
    find_homography_quad,
)
from future_urban_scene_generation_tpu_torch.ops import _kernels
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.ops.warp import bilinear_sample
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.utils import profiling

# Signed-LAB value of RGB black: L = 0, a = b = 128/255.
LAB_BLACK_SIGNED = (-1.0, 2.0 * 128.0 / 255.0 - 1.0, 2.0 * 128.0 / 255.0 - 1.0)
MAX_RES = 256  # the largest sampling grid W1 takes
PHASE_GRID, PHASE_COMPOSE = 1, 2  # bits of the library's ``phases`` argument

LAUNCHES = 0  # W1: plane warps on CUDA tensors (one device kernel each, two at res < 256)
_COUNT_LOCK = threading.Lock()

if vis.NUM_TEXTURE_PLANES != 5:
    raise ImportError("W1 composes 5 texture planes from 3 warps")


def _lab_black(device):
    return torch.tensor(LAB_BLACK_SIGNED, dtype=torch.float32, device=device)


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


def _warps(src_vis, dst_vis, ar):
    """The three warps of each row, in the order they are composited: (source plane,
    destination plane, skip, a 4-gon) each, as (N,) tensors and a flag. Left/right are
    opposite faces: one warp, source the src-visible side, slot the dst-visible side;
    front/back share one too (front->front or back->back, never both); then the remaining
    plane."""
    left, right = vis.SYMMETRY_PAIR
    front, back = vis.OPPOSITE_PAIR

    def idx(flag, a, b):
        return torch.where(flag, torch.full_like(ar, a), torch.full_like(ar, b))

    side_skip = ~((src_vis[:, left] | src_vis[:, right]) & (dst_vis[:, left] | dst_vis[:, right]))
    warps = [(idx(src_vis[:, left], left, right), idx(dst_vis[:, left], left, right),
              side_skip, False)]
    fb_front = src_vis[:, front] & dst_vis[:, front]
    fb_back = src_vis[:, back] & dst_vis[:, back]
    fb_idx = idx(fb_front, front, back)
    warps.append((fb_idx, fb_idx, ~(fb_front | fb_back), True))
    for i in range(vis.NUM_TEXTURE_PLANES):
        if i not in (left, right, front, back):
            full = torch.full_like(ar, i)
            warps.append((full, full, ~src_vis[:, i] | ~dst_vis[:, i], True))
    return warps


def warp_planes_plain(src_table, src_window: cr.Window, src_polys, dst_polys, src_vis,
                      dst_vis, dst_window: cr.Window, table_index, *, res: int,
                      out_res: int, quad: bool) -> torch.Tensor:
    """Warped texture planes in dst-crop coordinates, N vehicle-steps at once.

    src_table (V, T, T, 3) signed-LAB source window of each vehicle (any float
    dtype; sampled in float32); src_window fields (V,); src_polys / dst_polys
    (N, 5, 6, 2) plane polygons (TEXTURE_PLANES topology: roof/front/back are
    4-point quads padded to 6); src_vis / dst_vis (N, 5) bool; dst_window
    fields (N,); table_index (N,) the vehicle of each row. For crop pixel q:
    frame point p = window(q), source point s = H^-1(p), value = table(s) if s
    lies in the source polygon. ``res`` is the sampling grid (``out_res``: the crop
    itself; below it an r^2 grid over each plane's dst bbox, pasted into the crop);
    ``quad``: the closed-form homography for the 4-gons. Skip/symmetry rules as
    warp_unwarp_planes (warp_learn/planes_utils.py:46-68). Returns (N, 5, S, S, 3)
    signed LAB, S = ``out_res``.
    """
    s_res = out_res
    dev = dst_polys.device
    n = dst_polys.shape[0]
    ar = torch.arange(n, device=dev)
    black = _lab_black(dev)
    table = src_table.shape[1]
    r = int(res)
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

    # The reduced grid's two steps are spans of their own, children of the runner's
    # ``fusg.plane_warp``: the homography and the r^2 sample, then the paste into the
    # crop. The exact 256^2 warp opens none.
    reduced = r != s_res

    def sample(hi, sp, gx, gy):
        denom = hi[:, 2, 0] * gx + hi[:, 2, 1] * gy + hi[:, 2, 2]
        denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
        sx = (hi[:, 0, 0] * gx + hi[:, 0, 1] * gy + hi[:, 0, 2]) / denom
        sy = (hi[:, 1, 0] * gx + hi[:, 1, 1] * gy + hi[:, 1, 2]) / denom
        tx = (sx - sx0 + 0.5) * (table / sw) - 0.5
        ty = (sy - sy0 + 0.5) * (table / sh) - 0.5
        tex = bilinear_sample(src_table, tx, ty, table_index)
        mask = _inside_poly(sx, sy, sp)
        return torch.where(mask[..., None], tex, black)

    def warp_one(src_idx, dst_idx, extra_skip, is_quad=False):
        sp = src_polys[ar, src_idx]
        dp = dst_polys[ar, dst_idx]
        with profiling.trace("fusg.plane_warp.sample") if reduced else contextlib.nullcontext():
            if is_quad and quad:
                h12, valid = find_homography_quad(sp[:, :4], dp[:, :4])
            else:
                h12, valid = find_homography(sp, dp)
            hi = torch.linalg.inv_ex(h12).inverse[:, :, :, None, None]  # (N, 3, 3, 1, 1)
            if not reduced:
                tex = sample(hi, sp, px, py)
            else:
                pad = 1.0
                bx0 = dp[..., 0].amin(-1) - pad
                bx1 = dp[..., 0].amax(-1) + pad
                by0 = dp[..., 1].amin(-1) - pad
                by1 = dp[..., 1].amax(-1) + pad
                bw = torch.clamp(bx1 - bx0, min=1e-3)
                bh = torch.clamp(by1 - by0, min=1e-3)
                qs_r = (torch.arange(r, dtype=torch.float32, device=dev) + 0.5) / r
                gx = torch.broadcast_to(
                    bx0[:, None, None] + qs_r[None, None, :] * bw[:, None, None], (n, r, r))
                gy = torch.broadcast_to(
                    by0[:, None, None] + qs_r[None, :, None] * bh[:, None, None], (n, r, r))
                rel = sample(hi, sp, gx, gy) - black
        if reduced:
            with profiling.trace("fusg.plane_warp.paste"):
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
    for src_idx, dst_idx, extra_skip, is_quad in _warps(src_vis, dst_vis, ar):
        tex, write = warp_one(src_idx, dst_idx, extra_skip, is_quad)
        out = out * (1.0 - write) + tex[:, None] * write
    return out


@torch.library.custom_op("fusg::plane_warp", mutates_args=(), device_types="cpu")
def _plane_warp_op(src_table: torch.Tensor, src_x0: torch.Tensor, src_y0: torch.Tensor,
                   src_w: torch.Tensor, src_h: torch.Tensor, src_polys: torch.Tensor,
                   dst_polys: torch.Tensor, src_vis: torch.Tensor, dst_vis: torch.Tensor,
                   dst_x0: torch.Tensor, dst_y0: torch.Tensor, dst_w: torch.Tensor,
                   dst_h: torch.Tensor, table_index: torch.Tensor, res: int, out_res: int,
                   quad: bool) -> torch.Tensor:
    """The plane warp as the operator ``fusg::plane_warp`` (window fields flat): the
    plain version on CPU tensors, kernel W1 on CUDA tensors."""
    return warp_planes_plain(src_table, cr.Window(src_x0, src_y0, src_w, src_h), src_polys,
                             dst_polys, src_vis, dst_vis, cr.Window(dst_x0, dst_y0, dst_w, dst_h),
                             table_index, res=res, out_res=out_res, quad=quad)


class _Args(ctypes.Structure):
    """``FusgPlaneWarpArgs`` of csrc/fusg_kernels.h."""

    _p = ctypes.c_void_p
    _fields_ = [
        ("table", _p), ("src_win", _p), ("dst_win", _p), ("src_polys", _p), ("dst_polys", _p),
        ("table_index", _p), ("hi_t", _p), ("src_plane", _p), ("slot", _p), ("ok", _p),
        ("out", _p), ("scratch", _p), ("table_bf16", ctypes.c_int), ("n_tables", ctypes.c_int),
        ("table_res", ctypes.c_int), ("n", ctypes.c_int), ("res", ctypes.c_int),
        ("black", ctypes.c_float * 3),
    ]


def _warp_plan(src_polys, dst_polys, src_vis, dst_vis, quad: bool):
    """Each warp's inverse homography (3N, 3, 3), warp-major, by the plain warp's own
    calls (its eigh, Cholesky and LU: a near-singular H of a plane a few pixels wide turns
    a rounding into percents of its inverse; the two 4-gon warps solve as one batch), with
    its source plane, slot and whether it writes, (3, N) each."""
    ar = torch.arange(dst_polys.shape[0], device=dst_polys.device)
    warps = _warps(src_vis, dst_vis, ar)
    (s0, d0, _, _), (s1, d1, _, _), (s2, d2, _, _) = warps
    h_side, v_side = find_homography(src_polys[ar, s0], dst_polys[ar, d0])
    sp = torch.cat([src_polys[ar, s1], src_polys[ar, s2]])
    dp = torch.cat([dst_polys[ar, d1], dst_polys[ar, d2]])
    h_quad, v_quad = (find_homography_quad(sp[:, :4], dp[:, :4]) if quad
                      else find_homography(sp, dp))
    hi = torch.linalg.inv_ex(torch.cat([h_side, h_quad])).inverse
    src_plane, slot, skip = (torch.stack([w[i] for w in warps]) for i in range(3))
    ok = torch.cat([v_side, v_quad]).view(3, -1) & ~skip
    return hi, src_plane, slot, ok


@torch.library.custom_op("fusg::plane_warp_launch", mutates_args=("out", "scratch"),
                         device_types="cuda")
def _w1_launch(table: torch.Tensor, src_win: torch.Tensor, dst_win: torch.Tensor,
               src_polys: torch.Tensor, dst_polys: torch.Tensor, table_index: torch.Tensor,
               hi_t: torch.Tensor, src_plane: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor,
               out: torch.Tensor, scratch: torch.Tensor, res: int, phases: int) -> None:
    """W1's kernels ``phases`` on the contiguous tensors :func:`_plane_warp_cuda` laid
    out. An operator of its own: a profiler links a kernel to the operator that launched
    it, and the trace files it under the spans open where that operator began, so
    without it both kernels fall under ``fusg::plane_warp``'s start, outside
    ``fusg.plane_warp.sample`` and ``.paste`` (as seen on the card: ``plane_paste.device_ms``
    then reads nothing)."""
    args = _Args(
        table=table.data_ptr(), src_win=src_win.data_ptr(), dst_win=dst_win.data_ptr(),
        src_polys=src_polys.data_ptr(), dst_polys=dst_polys.data_ptr(),
        table_index=table_index.data_ptr(), hi_t=hi_t.data_ptr(),
        src_plane=src_plane.data_ptr(), slot=slot.data_ptr(), ok=ok.data_ptr(),
        out=out.data_ptr(), scratch=scratch.data_ptr(),
        table_bf16=int(table.dtype == torch.bfloat16), n_tables=table.shape[0],
        table_res=table.shape[1], n=out.shape[0], res=res,
        black=(ctypes.c_float * 3)(*LAB_BLACK_SIGNED),
    )
    rc = _kernels.load().fusg_plane_warp(ctypes.byref(args), phases,
                                         torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fusg_plane_warp launch failed: CUDA error {rc}")


@_plane_warp_op.register_kernel("cuda")
def _plane_warp_cuda(src_table, src_x0, src_y0, src_w, src_h, src_polys, dst_polys, src_vis,
                     dst_vis, dst_x0, dst_y0, dst_w, dst_h, table_index, res, out_res, quad):
    global LAUNCHES
    n = dst_polys.shape[0]
    v = src_table.shape[0]
    planes = (n, vis.NUM_TEXTURE_PLANES, 6, 2)
    if (src_table.dim() != 4 or src_table.shape[2] != src_table.shape[1]
            or src_table.shape[3] != 3 or tuple(src_polys.shape) != planes
            or tuple(dst_polys.shape) != planes
            or tuple(src_vis.shape) != planes[:2] or tuple(dst_vis.shape) != planes[:2]
            or tuple(table_index.shape) != (n,)
            or any(tuple(f.shape) != (v,) for f in (src_x0, src_y0, src_w, src_h))
            or any(tuple(f.shape) != (n,) for f in (dst_x0, dst_y0, dst_w, dst_h))):
        raise ValueError(
            f"plane_warp: table {tuple(src_table.shape)}, polygons {tuple(src_polys.shape)} / "
            f"{tuple(dst_polys.shape)}, visibility {tuple(src_vis.shape)} / "
            f"{tuple(dst_vis.shape)}, index {tuple(table_index.shape)} are not (V, T, T, 3), "
            f"(N, 5, 6, 2), (N, 5), (N,) with window fields (V,) and (N,)")
    if out_res != 256 or not 1 <= res <= MAX_RES:
        raise ValueError(f"plane_warp: W1 takes a 256^2 crop and a grid of 1..{MAX_RES}, "
                         f"got {out_res} and {res}")
    if src_table.dtype not in (torch.float32, torch.bfloat16) or table_index.dtype != torch.int64:
        raise ValueError(f"plane_warp: W1 takes a float32 or bfloat16 table and an int64 "
                         f"index, got {src_table.dtype} and {table_index.dtype}")
    dev = src_table.device
    tensors = (src_x0, src_y0, src_w, src_h, src_polys, dst_polys, src_vis, dst_vis, dst_x0,
               dst_y0, dst_w, dst_h, table_index)
    if any(t.device != dev for t in tensors):
        raise ValueError("plane_warp: the inputs lie on different devices")
    out = torch.empty((n, vis.NUM_TEXTURE_PLANES, out_res, out_res, 3), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    reduced = res != out_res
    with profiling.trace("fusg.plane_warp.sample") if reduced else contextlib.nullcontext():
        src_polys = src_polys.to(torch.float32).contiguous()
        dst_polys = dst_polys.to(torch.float32).contiguous()
        hi, src_plane, slot, ok = _warp_plan(src_polys, dst_polys, src_vis, dst_vis, quad)
        # Each inverse transposed: LAPACK's column-major layout, which torch's batched
        # inverse leaves, so no copy.
        hi_t = hi.mT.contiguous()
        table = src_table.contiguous()
        table_index = table_index.contiguous()
        # (4, V) and (4, N): x_start, y_start, w, h (the source fields are strided views)
        src_win = torch.stack([f.to(torch.float32) for f in (src_x0, src_y0, src_w, src_h)])
        dst_win = torch.stack([f.to(torch.float32) for f in (dst_x0, dst_y0, dst_w, dst_h)])
        flags = -(-3 * n // 4) * 4
        scratch = torch.empty(flags + 3 * n * res * res * 3 if reduced else 0,
                              dtype=torch.float32, device=dev)
        kernel_args = (table, src_win, dst_win, src_polys, dst_polys, table_index, hi_t,
                       src_plane, slot, ok, out, scratch, res)
        if reduced:
            _w1_launch(*kernel_args, PHASE_GRID)
    with profiling.trace("fusg.plane_warp.paste") if reduced else contextlib.nullcontext():
        _w1_launch(*kernel_args, PHASE_COMPOSE)
    with _COUNT_LOCK:  # scenes of several streams warp from worker threads
        LAUNCHES += 1
    return out


@_plane_warp_op.register_fake
def _plane_warp_fake(src_table, src_x0, src_y0, src_w, src_h, src_polys, dst_polys, src_vis,
                     dst_vis, dst_x0, dst_y0, dst_w, dst_h, table_index, res, out_res, quad):
    return src_table.new_empty((dst_polys.shape[0], vis.NUM_TEXTURE_PLANES, out_res, out_res, 3),
                               dtype=torch.float32)


def warp_planes(src_table, src_window: cr.Window, src_polys, dst_polys, src_vis, dst_vis,
                dst_window: cr.Window, table_index, *, res: int, out_res: int,
                quad: bool) -> torch.Tensor:
    """:func:`warp_planes_plain`'s warp through ``fusg::plane_warp``: CPU tensors take
    the plain version; CUDA tensors launch kernel W1 (grids up to 256^2 into a 256^2
    crop). Arguments as :func:`warp_planes_plain`'s."""
    if src_table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plane_warp: unsupported device {src_table.device}")
    return _plane_warp_op(src_table, *src_window, src_polys, dst_polys, src_vis, dst_vis,
                          *dst_window, table_index, int(res), int(out_res), bool(quad))
