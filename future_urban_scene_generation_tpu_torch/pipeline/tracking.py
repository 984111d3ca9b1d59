"""Streaming detect -> track front-end.

Counterpart of the JAX package's pipeline/tracking.py (:35-150, :205-346). The
reference never detects or tracks: it consumes precomputed multi-target tracking
files (utils/video_info_utils.py:7-21) and a GUI click to select vehicles. For
streaming (detect -> track -> keypoint -> NVS -> composite) the package provides the
missing front-end:

* ``BackgroundDiffDetector``: a frame-level detector for static cameras, the pixel
  work on the device and connected components on the host;
* ``MaskRCNNDetector``: the native Mask R-CNN (models/maskrcnn.py) on the frame,
  vehicle classes kept;
* ``IouTracker``: greedy IoU association with constant-velocity box prediction,
  the SORT-style baseline (O(tracks x detections) control logic over <= 16 boxes:
  host numpy by design, the device does the pixel work);
* ``predict_future_meters``: ground-plane constant-velocity rollout replacing the
  reference's precomputed future rows (GUI/app_interface.py:225-234): track
  history -> pixel -> GPS -> meters (geometry/gps.py) -> linear extrapolation.

``TrackingStreamRunner`` (pipeline/streaming.py) composes these with the scene
runner into the full streaming loop with no caller-supplied boxes.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.geometry.gps import trajectory_to_meters

# ---------------------------------------------------------------------------
# Detectors: frame -> (boxes (N, 4) xyxy, scores (N,))
# ---------------------------------------------------------------------------


@dataclass
class PendingGrid:
    """A detection in flight: the host copy of its cell grid, valid once ``event``
    has fired."""

    host: torch.Tensor
    event: object


class _PinnedSlots:
    """Two alternating pinned host buffers for detections in flight: a result is
    copied to the host right behind the work that makes it, and an event recorded
    behind the copy, so that the later read waits for that detection alone (not for
    whatever was enqueued after it). A handle must be finalized before the second
    staging after it; pinned memory is allocated once, not per frame."""

    def __init__(self):
        self._host = [None, None]
        self._slot = 0

    def stage(self, t: torch.Tensor) -> "PendingGrid":
        slot = self._slot
        self._slot = 1 - slot
        host = self._host[slot]
        if host is None or host.shape != t.shape or host.dtype != t.dtype:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            self._host[slot] = host
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingGrid(host, event)


def _read(handle) -> np.ndarray:
    """The host array of a :meth:`dispatch` handle: a :class:`PendingGrid` after its
    own event, or a CPU tensor as it is."""
    if isinstance(handle, PendingGrid):
        handle.event.synchronize()
        return handle.host.numpy()
    return handle.cpu().numpy()


class BackgroundDiffDetector:
    """Static-camera vehicle detector: device-side |frame - background| mask,
    host-side connected components on a downsampled grid.

    The pixel work (channel-sum abs diff, 3x3 box-blur denoise, threshold, 1/scale
    downsample) runs on the background's device; only the (H/s, W/s) bool grid
    crosses to the host, where a linear-time two-pass union-find labels components
    and emits boxes.
    """

    def __init__(self, background: torch.Tensor, threshold: float = 0.10, scale: int = 8,
                 min_area_px: float = 24 * 24, max_boxes: int = 16):
        self.scale = int(scale)
        self.threshold = float(threshold)
        self.min_cells = max(1, int(min_area_px / (scale * scale)))
        self.max_boxes = int(max_boxes)
        self.background = background
        self._slots = _PinnedSlots()

    @torch.no_grad()
    def dispatch(self, frame: torch.Tensor):
        """Enqueue the device mask pass; returns a handle for :meth:`finalize`.

        Splitting dispatch from the host readback lets the streaming runner
        enqueue frame t's detection, then read frame t-1's: reading right after
        dispatching would wait behind everything ahead of it on the stream (the
        previous scene). On a CUDA frame the handle is a :class:`PendingGrid`: the
        bool grid is copied into pinned host memory right behind the mask pass and
        an event is recorded behind the copy, so that the later read waits for this
        detection alone and not for whatever was enqueued after it. On a CPU frame
        the handle is the grid itself."""
        diff = (frame - self.background).abs().sum(dim=-1)
        # 3x3 box blur (zero border) knocks out single-pixel noise before thresholding.
        k = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=diff.dtype, device=diff.device)
        diff = F.conv2d(diff[None, None], k, padding=1)[0, 0]
        hit = (diff > self.threshold).to(torch.float32)
        h, w = hit.shape
        s = self.scale
        grid = hit[: h - h % s, : w - w % s].reshape(h // s, s, w // s, s)
        # A cell counts when >= 25% of its pixels moved.
        grid = grid.mean(dim=(1, 3)) >= 0.25
        return self._stage(grid) if grid.is_cuda else grid

    def _stage(self, grid: torch.Tensor) -> "PendingGrid":
        return self._slots.stage(grid)

    def finalize(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for one :meth:`dispatch` (its own event, nothing else on the stream),
        read its grid on the host and extract boxes (host union-find)."""
        grid = _read(handle)
        boxes = _connected_component_boxes(grid, self.min_cells)
        s = float(self.scale)
        out = np.asarray(
            [[x0 * s, y0 * s, (x1 + 1) * s, (y1 + 1) * s] for x0, y0, x1, y1, _ in boxes],
            np.float32,
        ).reshape(-1, 4)
        scores = np.asarray([a for *_, a in boxes], np.float32)
        order = np.argsort(-scores)[: self.max_boxes]
        return out[order], scores[order]

    def __call__(self, frame) -> Tuple[np.ndarray, np.ndarray]:
        return self.finalize(self.dispatch(frame))


class MaskRCNNDetector:
    """Frame-level vehicle detection with the native Mask R-CNN (models/maskrcnn.py):
    the frame resized to ``input_hw``, one inference, the vehicle classes kept (COCO
    3 = car, 6 = bus, 8 = truck; the reference keeps car and truck, run_test.py:41-43)
    at ``score_threshold``. Counterpart of the JAX detector (tracking.py:153-202),
    with ``BackgroundDiffDetector``'s split: ``dispatch`` enqueues the inference and,
    on the card, one copy of its (D, 7) result (box, score, label, valid) to pinned
    memory behind an event; ``finalize`` waits on that event only."""

    def __init__(self, model, classes=(3, 6, 8), score_threshold: float = 0.5,
                 input_hw=(512, 1024), *, device):
        self.model = model.to(device).eval()
        self.classes = tuple(classes)
        self.score_threshold = float(score_threshold)
        self.input_hw = tuple(input_hw)
        self._slots = _PinnedSlots()

    @torch.no_grad()
    def dispatch(self, frame: torch.Tensor):
        from future_urban_scene_generation_tpu_torch.models.detector import scale_boxes
        from future_urban_scene_generation_tpu_torch.models.maskrcnn import maskrcnn_infer
        from future_urban_scene_generation_tpu_torch.ops.resize import resize_bilinear

        h, w = frame.shape[0], frame.shape[1]
        ih, iw = self.input_hw
        det = maskrcnn_infer(self.model, resize_bilinear(frame, (ih, iw)))
        packed = torch.cat([scale_boxes(det.boxes, w / iw, h / ih), det.scores[:, None],
                            det.labels[:, None].to(torch.float32),
                            det.valid[:, None].to(torch.float32)], dim=-1)
        return self._slots.stage(packed) if packed.is_cuda else packed

    def finalize(self, handle) -> Tuple[np.ndarray, np.ndarray]:
        packed = _read(handle)
        boxes, scores = packed[:, :4].astype(np.float32), packed[:, 4].astype(np.float32)
        labels = packed[:, 5].astype(np.int64)
        keep = ((packed[:, 6] > 0.5) & (scores >= self.score_threshold)
                & np.isin(labels, self.classes))
        return boxes[keep], scores[keep]

    def __call__(self, frame) -> Tuple[np.ndarray, np.ndarray]:
        return self.finalize(self.dispatch(frame))


def _connected_component_boxes(grid: np.ndarray, min_cells: int):
    """8-connected components of a small bool grid -> [(x0, y0, x1, y1, area)].

    Two-pass row-run union-find: O(cells). The grid is ~(H/8, W/8) so this is
    microseconds of host work per frame.
    """
    h, w = grid.shape
    parent: list = []

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    labels = np.full((h, w), -1, np.int32)
    prev_runs: List[Tuple[int, int, int]] = []  # (x_start, x_end_excl, label)
    for y in range(h):
        runs = []
        x = 0
        row = grid[y]
        while x < w:
            if not row[x]:
                x += 1
                continue
            x0 = x
            while x < w and row[x]:
                x += 1
            lab = len(parent)
            parent.append(lab)
            # 8-connectivity: overlap with previous row's runs extended by 1.
            for px0, px1, plab in prev_runs:
                if px0 - 1 < x and x0 < px1 + 1:
                    union(plab, lab)
            labels[y, x0:x] = lab
            runs.append((x0, x, lab))
        prev_runs = runs

    boxes = {}
    ys, xs = np.nonzero(labels >= 0)
    for y, x in zip(ys, xs):
        r = find(labels[y, x])
        if r in boxes:
            b = boxes[r]
            boxes[r] = (min(b[0], x), min(b[1], y), max(b[2], x), max(b[3], y), b[4] + 1)
        else:
            boxes[r] = (x, y, x, y, 1)
    return [
        (x0, y0, x1, y1, a) for (x0, y0, x1, y1, a) in boxes.values() if a >= min_cells
    ]


# ---------------------------------------------------------------------------
# Tracker
# ---------------------------------------------------------------------------


def iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU."""
    a = a[:, None]
    b = b[None, :]
    ix0 = np.maximum(a[..., 0], b[..., 0])
    iy0 = np.maximum(a[..., 1], b[..., 1])
    ix1 = np.minimum(a[..., 2], b[..., 2])
    iy1 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


@dataclass
class Track:
    track_id: int
    bbox: np.ndarray  # (4,) xyxy, current (smoothed)
    velocity: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    hits: int = 1
    misses: int = 0
    history: List[np.ndarray] = field(default_factory=list)  # mid-bottom px per frame

    @property
    def mid_bottom(self) -> np.ndarray:
        """Ground-contact point (BoundingBox.mid_bottom, utils/bounding_box.py:101-106)."""
        return np.asarray(
            [(self.bbox[0] + self.bbox[2]) / 2.0, self.bbox[3]], np.float32
        )

    def predicted_bbox(self) -> np.ndarray:
        shift = np.concatenate([self.velocity, self.velocity])
        return self.bbox + shift


class IouTracker:
    """Greedy IoU association with constant-velocity prediction (SORT-minus-Kalman).

    update(boxes) matches detections to velocity-predicted track boxes greedily by
    descending IoU above ``min_iou``; matched tracks EMA-smooth their box and
    velocity, unmatched detections open tentative tracks, unmatched tracks coast on
    their velocity for ``max_misses`` frames before deletion. A track is 'confirmed'
    after ``min_hits`` consecutive hits.
    """

    def __init__(self, min_iou: float = 0.2, max_misses: int = 5, min_hits: int = 3,
                 ema: float = 0.7):
        self.min_iou = float(min_iou)
        self.max_misses = int(max_misses)
        self.min_hits = int(min_hits)
        self.ema = float(ema)
        self.tracks: List[Track] = []
        self._ids = itertools.count()

    def update(self, boxes: np.ndarray) -> List[Track]:
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        matched_t, matched_d = set(), set()
        if self.tracks and len(boxes):
            pred = np.stack([t.predicted_bbox() for t in self.tracks])
            iou = iou_xyxy(pred, boxes)
            pairs = sorted(
                ((iou[i, j], i, j) for i in range(iou.shape[0])
                 for j in range(iou.shape[1])),
                reverse=True,
            )
            for v, i, j in pairs:
                if v < self.min_iou or i in matched_t or j in matched_d:
                    continue
                matched_t.add(i)
                matched_d.add(j)
                t = self.tracks[i]
                new_center = (boxes[j, :2] + boxes[j, 2:]) / 2.0
                old_center = (t.bbox[:2] + t.bbox[2:]) / 2.0
                t.velocity = (
                    self.ema * (new_center - old_center) + (1 - self.ema) * t.velocity
                )
                t.bbox = self.ema * boxes[j] + (1 - self.ema) * t.bbox
                t.hits += 1
                t.misses = 0
                t.history.append(t.mid_bottom)

        for i, t in enumerate(self.tracks):
            if i not in matched_t:
                t.misses += 1
                t.bbox = t.predicted_bbox()  # coast
                t.history.append(t.mid_bottom)

        for j in range(len(boxes)):
            if j not in matched_d:
                t = Track(next(self._ids), boxes[j].copy())
                t.history.append(t.mid_bottom)
                self.tracks.append(t)

        self.tracks = [t for t in self.tracks if t.misses <= self.max_misses]
        return self.confirmed()

    def confirmed(self) -> List[Track]:
        return [t for t in self.tracks if t.hits >= self.min_hits]


# ---------------------------------------------------------------------------
# Future trajectory prediction (replaces the precomputed future tracking rows)
# ---------------------------------------------------------------------------


def predict_future_meters(
    history_px: Sequence[np.ndarray],
    inv_homography: Optional[np.ndarray],
    n_points: int,
    stride: int = 2,
    history_window: int = 19,
) -> Optional[np.ndarray]:
    """Constant-velocity ground-plane rollout from a track's pixel history.

    history_px: the track's mid-bottom points, one per PROCESSED frame (oldest
    first). The points are mapped to metric ground coordinates (pixel -> GPS ->
    meters, geometry/gps.py, host float64 like the reference), the mean velocity over
    the last ``history_window`` deltas is taken (the reference derives its heading
    from the mean of the first 19 deltas, trajectory_inference.py:259-262), and
    ``n_points`` positions are emitted at ``stride``-frame spacing starting at the
    current position — the same (t, t+2, ..., t+2(n-1)) cadence as the GUI's
    ``range(0, 11, 2)`` subsample (GUI/app_interface.py:230-233).

    Returns (n_points, 2) float32 meters, or None with <2 history points.
    With inv_homography=None the pixel plane is treated as the ground plane
    (synthetic tests / unknown calibration).
    """
    if len(history_px) < 2:
        return None
    pts = np.asarray(history_px, np.float64)
    if inv_homography is not None:
        meters = trajectory_to_meters(pts, np.asarray(inv_homography, np.float64))
    else:
        meters = pts
    deltas = np.diff(meters[-(history_window + 1):], axis=0)
    vel = deltas.mean(axis=0)  # meters per processed frame
    start = meters[-1]
    steps = np.arange(n_points, dtype=np.float64)[:, None] * float(stride)
    out = start[None, :] + steps * vel[None, :]
    return np.asarray(out, np.float32)
