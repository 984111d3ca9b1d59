"""Detection primitives without torchvision: pairwise IoU, greedy NMS with a fixed
output count, and RoIAlign.

Counterpart of the JAX package's ops/detection.py (:30-148):

* ``batched_iou``: pairwise IoU of xyxy boxes;
* ``nms_static``: greedy NMS returning the first ``max_outputs`` kept boxes'
  indices in score order, -1 padded, and their valid flags. Boxes are ordered by a
  stable descending sort (``jnp.argsort`` is stable; ties keep the lower index
  first). A CPU tensor runs :func:`nms_plain`, the JAX ``lax.scan`` as a host loop;
  a CUDA tensor launches kernel N1 (``csrc/nms.cu``: the pairwise overlap bitmask,
  then one warp scanning it in score order), which gives the plain version's
  indices exactly (the same IoU arithmetic, no contracted multiply-add);
  ``NMS_LAUNCHES`` counts its launches;
* ``roi_align``: torchvision's ROIAlign with aligned=True (half-pixel offset,
  ``sampling_ratio``^2 bilinear samples a bin, averaged) on (H, W, C) features, and
  ``roi_align_levels``, the same for boxes that each pool from their own pyramid
  level, in one gather over the flattened levels.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.ops import _kernels

NMS_LAUNCHES = 0
NMS_MAX_BOXES = 4096  # the scan's shared memory (csrc/nms.cu)
_COUNT_LOCK = threading.Lock()


def batched_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> (N, M)."""
    ax0, ay0, ax1, ay1 = (boxes_a[:, i, None] for i in range(4))
    bx0, by0, bx1, by1 = (boxes_b[None, :, i] for i in range(4))
    ix0 = torch.maximum(ax0, bx0)
    iy0 = torch.maximum(ay0, by0)
    ix1 = torch.minimum(ax1, bx1)
    iy1 = torch.minimum(ay1, by1)
    inter = torch.clamp(ix1 - ix0, min=0) * torch.clamp(iy1 - iy0, min=0)
    area_a = torch.clamp(ax1 - ax0, min=0) * torch.clamp(ay1 - ay0, min=0)
    area_b = torch.clamp(bx1 - bx0, min=0) * torch.clamp(by1 - by0, min=0)
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=1e-9)


def sort_desc(scores: torch.Tensor):
    """(sorted scores, order): a stable descending sort, ties lower index first
    (``lax.top_k`` and ``jnp.argsort(-x)``'s order; the default ``torch.sort`` and
    ``torch.topk`` promise none)."""
    return torch.sort(scores, descending=True, stable=True)


def topk_stable(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest values and their indices, ties lower index first."""
    vals, idx = sort_desc(scores)
    return vals[:k], idx[:k]


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
              score_threshold: float = 0.0, max_outputs: int = 100) -> torch.Tensor:
    """Plain version of N1: the JAX scan (detection.py:65-74) as a host loop over the
    score-sorted boxes. Returns (max_outputs,) int64 original indices, -1 padded."""
    _, order = sort_desc(scores)
    boxes_s, scores_s = boxes[order], scores[order]
    over = (batched_iou(boxes_s, boxes_s) > iou_threshold).cpu().numpy()
    valid_score = (scores_s > score_threshold).cpu().numpy()
    order_np = order.cpu().numpy()
    n = len(order_np)
    suppressed = np.zeros(n, bool)
    out = np.full(max_outputs, -1, np.int64)
    kept = 0
    for i in range(n):
        if suppressed[i] or not valid_score[i]:
            continue
        if kept < max_outputs:
            out[kept] = order_np[i]
        kept += 1
        suppressed[i + 1:] |= over[i, i + 1:]
    return torch.as_tensor(out, device=boxes.device)


def _nms_launch(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                score_threshold: float, max_outputs: int) -> torch.Tensor:
    n = boxes.shape[0]
    if n > NMS_MAX_BOXES:
        raise ValueError(f"nms_static: {n} boxes exceed kernel N1's limit {NMS_MAX_BOXES}")
    out = torch.empty(max_outputs, dtype=torch.int64, device=boxes.device)
    if n == 0:
        return out.fill_(-1)
    scores_s, order = sort_desc(scores.to(torch.float32))
    boxes_s = boxes.to(torch.float32)[order].contiguous()
    scores_s, order = scores_s.contiguous(), order.contiguous()
    col_blocks = -(-n // 64)
    mask = torch.empty((n, col_blocks), dtype=torch.int64, device=boxes.device)
    rc = _kernels.load().fusg_nms(
        ctypes.c_void_p(boxes_s.data_ptr()), ctypes.c_void_p(scores_s.data_ptr()),
        ctypes.c_void_p(order.data_ptr()), n, float(iou_threshold), float(score_threshold),
        max_outputs, ctypes.c_void_p(mask.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(boxes.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fusg_nms launch failed: CUDA error {rc}")
    return out


def nms_static(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
               score_threshold: float = 0.0, max_outputs: int = 100
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output shape: boxes (N, 4) xyxy, scores (N,) ->
    (indices (max_outputs,) int64 padded with -1, valid (max_outputs,) bool). A box
    is kept when its score exceeds ``score_threshold`` and no kept box before it in
    score order overlaps it by IoU > ``iou_threshold``. CPU tensors take
    :func:`nms_plain`; CUDA tensors launch kernel N1."""
    global NMS_LAUNCHES
    if boxes.device.type == "cpu":
        idx = nms_plain(boxes, scores, iou_threshold, score_threshold, max_outputs)
    elif boxes.device.type == "cuda":
        idx = _nms_launch(boxes, scores, iou_threshold, score_threshold, max_outputs)
        with _COUNT_LOCK:
            NMS_LAUNCHES += 1
    else:
        raise ValueError(f"nms_static: unsupported device {boxes.device}")
    return idx, idx >= 0


def _roi_align_flat(flat: torch.Tensor, heights, widths, offsets, x0, y0, x1, y1,
                    output_size: int, sampling_ratio: int) -> torch.Tensor:
    """ROIAlign of N boxes given in continuous feature coordinates (x0 .. y1, (N,)),
    each on its own (heights[n], widths[n]) map stored from row ``offsets[n]`` of
    ``flat`` (L, C). Returns (N, out, out, C)."""
    n, s = x0.shape[0], sampling_ratio
    dev = flat.device
    bin_w = (x1 - x0) / output_size
    bin_h = (y1 - y0) / output_size
    grid = (torch.arange(output_size, device=dev)[:, None]
            + (torch.arange(s, device=dev)[None, :] + 0.5) / s).reshape(-1).to(torch.float32)
    xs = x0[:, None] + grid[None, :] * bin_w[:, None]  # (N, out * s)
    ys = y0[:, None] + grid[None, :] * bin_h[:, None]
    w_max, h_max = (widths - 1)[:, None], (heights - 1)[:, None]
    x0i = torch.minimum(torch.clamp(torch.floor(xs).long(), min=0), w_max)
    y0i = torch.minimum(torch.clamp(torch.floor(ys).long(), min=0), h_max)
    x1i = torch.minimum(x0i + 1, w_max)
    y1i = torch.minimum(y0i + 1, h_max)
    fx = torch.clamp(xs - torch.floor(xs), 0.0, 1.0)[:, None, :, None]
    fy = torch.clamp(ys - torch.floor(ys), 0.0, 1.0)[:, :, None, None]
    base = offsets[:, None, None]
    row_w = widths[:, None, None]

    def gather(yi, xi):
        idx = base + yi[:, :, None] * row_w + xi[:, None, :]  # (N, oy, ox)
        return flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, flat.shape[-1])

    vals = (
        gather(y0i, x0i) * (1 - fx) * (1 - fy)
        + gather(y0i, x1i) * fx * (1 - fy)
        + gather(y1i, x0i) * (1 - fx) * fy
        + gather(y1i, x1i) * fx * fy
    )
    vals = vals.reshape(n, output_size, s, output_size, s, -1)
    return vals.mean(dim=(2, 4))


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """torchvision ROIAlign (aligned=True) on (H, W, C) features; rois (N, 4) xyxy in
    input-image coordinates. Returns (N, out, out, C)."""
    h, w, c = features.shape
    n = rois.shape[0]
    r = rois * spatial_scale - 0.5
    full = lambda v: torch.full((n,), v, dtype=torch.long, device=features.device)  # noqa: E731
    return _roi_align_flat(features.reshape(h * w, c), full(h), full(w), full(0),
                           r[:, 0], r[:, 1], r[:, 2], r[:, 3], output_size, sampling_ratio)


def roi_align_levels(feats: Sequence[torch.Tensor], strides: Sequence[int],
                     rois: torch.Tensor, levels: torch.Tensor, output_size: int,
                     sampling_ratio: int = 2) -> torch.Tensor:
    """ROIAlign of each box on its own level: ``feats`` (H_l, W_l, C) maps with
    ``strides``, ``levels`` (N,) indices into them. Torchvision's detection heads pool
    with aligned=False, which is aligned=True on boxes shifted by half a stride (the
    JAX ``multilevel_roi_align``, maskrcnn.py:368-394, which pools every box at every
    level and selects; the values are the same)."""
    c = feats[0].shape[-1]
    flat = torch.cat([f.reshape(-1, c) for f in feats])
    # Per-box level constants by selection (no host-to-device copy, which would wait
    # for the work queued before it).
    heights, widths, offsets = (torch.zeros_like(levels) for _ in range(3))
    scale = torch.zeros(levels.shape, dtype=torch.float32, device=rois.device)
    half = torch.zeros_like(scale)
    start = 0
    for lvl, (f, stride) in enumerate(zip(feats, strides)):
        on = levels == lvl
        heights = torch.where(on, f.shape[0], heights)
        widths = torch.where(on, f.shape[1], widths)
        offsets = torch.where(on, start, offsets)
        scale = torch.where(on, 1.0 / stride, scale)
        half = torch.where(on, 0.5 * stride, half)
        start += f.shape[0] * f.shape[1]
    r = (rois + half[:, None]) * scale[:, None] - 0.5
    return _roi_align_flat(flat, heights, widths, offsets, r[:, 0], r[:, 1], r[:, 2],
                           r[:, 3], output_size, sampling_ratio)
