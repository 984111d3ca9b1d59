"""Detection primitives without torchvision: pairwise IoU, greedy NMS with a fixed
output count, and RoIAlign.

Counterpart of the JAX package's ops/detection.py (:30-148):

* ``batched_iou``: pairwise IoU of xyxy boxes;
* ``nms_static``: greedy NMS returning the first ``max_outputs`` kept boxes'
  indices in score order, -1 padded, and their valid flags. Boxes are ordered by a
  stable descending sort (``jnp.argsort`` is stable; ties keep the lower index
  first). ``nms_sorted_segments`` is the greedy pass itself over boxes the caller has
  already put in score order, for several independent segments at once (Mask R-CNN's
  five RPN levels), with no sort. A CPU tensor runs the plain versions
  (:func:`nms_sorted_plain`, the JAX ``lax.scan`` as a host loop); a CUDA tensor
  launches kernel N1 (``csrc/nms.cu``: one thread-block cluster a segment computing
  the pairwise overlap bitmask into shared memory, then one warp scanning it), which
  gives the plain version's indices exactly (the same IoU arithmetic, no contracted
  multiply-add); ``NMS_LAUNCHES`` counts its launches, one a call;
* ``roi_align``: torchvision's ROIAlign with aligned=True (half-pixel offset,
  ``sampling_ratio``^2 bilinear samples a bin, averaged) on (H, W, C) features, and
  ``roi_align_levels``, the same for boxes that each pool from their own pyramid
  level, in one gather over the flattened levels.
"""
from __future__ import annotations

import ctypes
import itertools
import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.ops import _kernels

NMS_LAUNCHES = 0
NMS_MAX_BOXES = 4096  # boxes a segment (csrc/nms.cu: the scan's 64 removed words)
# Segments up to this many boxes keep their overlap mask (n * ceil(n / 64) words, at most
# 128 KB) in the shared memory of their cluster's first block; a longer one writes it to
# a global scratch the wrapper allocates (4,096 boxes: 2 MB, more than a block holds).
NMS_SMEM_BOXES = 1024
NMS_MAX_SEGMENTS = 16  # segments a launch (the kernel's by-value table)
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


def nms_sorted_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
                     score_threshold: float = 0.0, max_outputs: int = 100) -> torch.Tensor:
    """Plain version of N1: the JAX scan (detection.py:65-74) as a host loop over the
    boxes in the order given. Returns (max_outputs,) int64 indices into ``boxes``,
    -1 padded."""
    over = (batched_iou(boxes, boxes) > iou_threshold).cpu().numpy()
    valid_score = (scores > score_threshold).cpu().numpy()
    n = len(valid_score)
    suppressed = np.zeros(n, bool)
    out = np.full(max_outputs, -1, np.int64)
    kept = 0
    for i in range(n):
        if suppressed[i] or not valid_score[i]:
            continue
        if kept < max_outputs:
            out[kept] = i
        kept += 1
        suppressed[i + 1:] |= over[i, i + 1:]
    return torch.as_tensor(out, device=boxes.device)


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
              score_threshold: float = 0.0, max_outputs: int = 100) -> torch.Tensor:
    """:func:`nms_static`'s indices by the plain version: a stable descending sort, then
    :func:`nms_sorted_plain`, mapped back to the original indices."""
    _, order = sort_desc(scores)
    idx = nms_sorted_plain(boxes[order], scores[order], iou_threshold, score_threshold,
                           max_outputs)
    return torch.where(idx >= 0, order[idx.clamp(min=0)], idx)


def _nms_args(boxes: torch.Tensor, scores: torch.Tensor, lens: Sequence[int],
              max_outs: Sequence[int], iou_threshold: float, score_threshold: float):
    """The output and the argument tuple of one N1 launch (``fusg_nms_segments``) over
    the segments; the tensors the launch reads are kept alive in the tuple's owner."""
    if not 1 <= len(lens) <= NMS_MAX_SEGMENTS:
        raise ValueError(f"N1: {len(lens)} segments, the kernel takes 1 to {NMS_MAX_SEGMENTS}")
    if max(lens) > NMS_MAX_BOXES:
        raise ValueError(f"N1: a segment of {max(lens)} boxes exceeds {NMS_MAX_BOXES}")
    if boxes.dtype != torch.float32 or not boxes.is_contiguous() or boxes.data_ptr() % 16:
        boxes = boxes.to(torch.float32).contiguous().clone()  # read as float4
    if scores.dtype != torch.float32 or not scores.is_contiguous():
        scores = scores.to(torch.float32).contiguous()
    n_seg = len(lens)
    scratch_at, words = [], 0
    for n in lens:
        if n > NMS_SMEM_BOXES:
            scratch_at.append(words)
            words += n * -(-n // 64)
        else:
            scratch_at.append(-1)
    out = torch.empty(sum(max_outs), dtype=torch.int64, device=boxes.device)
    scratch = torch.empty(words, dtype=torch.int64, device=boxes.device) if words else None
    ints = ctypes.c_int * n_seg
    args = (
        ctypes.c_void_p(boxes.data_ptr()), ctypes.c_void_p(scores.data_ptr()), n_seg,
        ints(*itertools.accumulate(lens[:-1], initial=0)), ints(*lens),
        ints(*itertools.accumulate(max_outs[:-1], initial=0)), ints(*max_outs),
        (ctypes.c_longlong * n_seg)(*scratch_at), float(iou_threshold), float(score_threshold),
        ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(boxes.device).cuda_stream),
    )
    return out, args, (boxes, scores, scratch)


def _nms_launch(boxes: torch.Tensor, scores: torch.Tensor, lens: Sequence[int],
                max_outs: Sequence[int], iou_threshold: float, score_threshold: float
                ) -> torch.Tensor:
    """One N1 launch over the segments; returns the outputs concatenated."""
    global NMS_LAUNCHES
    out, args, _keep = _nms_args(boxes, scores, lens, max_outs, iou_threshold,
                                 score_threshold)
    rc = _kernels.load().fusg_nms_segments(*args)
    if rc != 0:
        raise RuntimeError(f"fusg_nms_segments launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        NMS_LAUNCHES += 1
    return out


def nms_sorted_segments(boxes: torch.Tensor, scores: torch.Tensor, seg_lens: Sequence[int],
                        iou_threshold: float, score_threshold: float,
                        max_outputs: Sequence[int]) -> List[torch.Tensor]:
    """Greedy NMS of independent segments of boxes already in score order, in one
    call. ``boxes`` (N, 4) xyxy and ``scores`` (N,) hold the segments one after the
    other, ``seg_lens[s]`` rows each (sum N). Each segment is visited in the order
    given, as :func:`nms_static` visits its sorted boxes; a box whose score is not
    above ``score_threshold`` is never kept and suppresses nothing, so such boxes (the
    RPN's -1 scores) may stand anywhere. Returns one (max_outputs[s],) int64 tensor a
    segment: the first kept boxes' indices within the segment, -1 padded. CPU tensors
    take :func:`nms_sorted_plain` a segment; CUDA tensors launch kernel N1 once for all
    segments, or raise."""
    lens, max_outs = [int(v) for v in seg_lens], [int(v) for v in max_outputs]
    if len(lens) != len(max_outs) or sum(lens) != boxes.shape[0]:
        raise ValueError(f"nms_sorted_segments: segments {lens} / outputs {max_outs} do not "
                         f"fit {boxes.shape[0]} boxes")
    if boxes.device.type == "cpu":
        return [nms_sorted_plain(b, s, iou_threshold, score_threshold, m)
                for b, s, m in zip(boxes.split(lens), scores.split(lens), max_outs)]
    if boxes.device.type != "cuda":
        raise ValueError(f"nms_sorted_segments: unsupported device {boxes.device}")
    out = _nms_launch(boxes, scores, lens, max_outs, iou_threshold, score_threshold)
    return [out] if len(lens) == 1 else list(out.split(max_outs))


def nms_static(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
               score_threshold: float = 0.0, max_outputs: int = 100
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a static output shape: boxes (N, 4) xyxy, scores (N,) ->
    (indices (max_outputs,) int64 padded with -1, valid (max_outputs,) bool). A box
    is kept when its score exceeds ``score_threshold`` and no kept box before it in
    score order overlaps it by IoU > ``iou_threshold``: the stable descending sort,
    then :func:`nms_sorted_segments` on one segment (kernel N1 on CUDA tensors), its
    positions mapped back to the original indices."""
    _, order = sort_desc(scores)
    (pos,) = nms_sorted_segments(boxes[order], scores[order], [boxes.shape[0]],
                                 iou_threshold, score_threshold, [max_outputs])
    idx = torch.where(pos >= 0, order[pos.clamp(min=0)], pos)
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
