"""Vehicle segmenters for the inpaint branch: (frame, bbox) -> (H, W) bool mask.

Counterpart of the JAX package's models/detector.py (:31-152). The reference runs
torchvision's Mask R-CNN on each vehicle's crop and keeps the best car/truck mask
(run_test.py:41-43, trajectory_inference.py:115-119). Four implementations:

* ``MeshSilhouetteSegmenter``: the posed mesh's silhouette, dilated;
* ``BackgroundDiffSegmenter``: |frame - background| thresholded inside the bbox
  (static cameras; the service's default);
* ``HostDetectorSegmenter``: any host callback (numpy in, numpy out);
* ``MaskRCNNSegmenter``: the port's Mask R-CNN (models/maskrcnn.py) on the frame,
  the best-scoring vehicle-class detection that overlaps the bbox.

Each takes the device its tensors live on as a required keyword. Besides the
one-bbox call, ``BackgroundDiffSegmenter.masks`` and
``MaskRCNNSegmenter.masks_for_bboxes`` give every vehicle's mask of a frame at once.
"""
from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.ops.morphology import dilate, elliptical_kernel


class Segmenter(Protocol):
    def __call__(self, frame: torch.Tensor, bbox_xyxy: torch.Tensor, **context) -> torch.Tensor:
        """Return an (H, W) bool vehicle mask for the given frame and bbox."""
        ...


class MeshSilhouetteSegmenter:
    """Mask = the posed mesh's silhouette at frame scale, optionally dilated."""

    def __init__(self, dilate_ksize: int = 8, *, device):
        self.device = torch.device(device)
        self.kernel = elliptical_kernel(dilate_ksize) if dilate_ksize else None

    def __call__(self, frame, bbox_xyxy, *, silhouette_frame=None, **_):
        if silhouette_frame is None:
            raise ValueError("MeshSilhouetteSegmenter needs silhouette_frame context")
        mask = silhouette_frame.to(self.device)
        if self.kernel is not None:
            mask = dilate(mask, self.kernel)
        return mask


class BackgroundDiffSegmenter:
    """Threshold |frame - background| (summed over channels) inside the bbox, then
    dilate: static-camera scenes only."""

    def __init__(self, background, threshold: float = 0.12, dilate_ksize: int = 8, *,
                 device):
        self.background = torch.as_tensor(background, dtype=torch.float32).to(device)
        self.threshold = threshold
        self.kernel = elliptical_kernel(dilate_ksize) if dilate_ksize else None

    def masks(self, frames: torch.Tensor, bboxes: torch.Tensor) -> torch.Tensor:
        """Every (frame, bbox) mask at once: frames (S, H, W, 3), bboxes (V, 4) ->
        (S, V, H, W) bool."""
        h, w = frames.shape[-3], frames.shape[-2]
        diff = torch.sum(torch.abs(frames - self.background), dim=-1) > self.threshold
        xs = torch.arange(w, device=frames.device)[None, None, :]
        ys = torch.arange(h, device=frames.device)[None, :, None]
        b = bboxes.to(torch.float32)[:, :, None, None]
        inside = ((xs >= b[:, 0]) & (xs <= b[:, 2]) & (ys >= b[:, 1]) & (ys <= b[:, 3]))
        mask = diff[:, None] & inside[None]
        if self.kernel is not None:
            mask = dilate(mask, self.kernel)
        return mask

    def __call__(self, frame, bbox_xyxy, **_):
        return self.masks(frame[None], bbox_xyxy[None])[0, 0]


class HostDetectorSegmenter:
    """Adapter for a host-side detector callback (numpy in, numpy out)."""

    def __init__(self, detect_fn: Callable[[np.ndarray, np.ndarray], np.ndarray], *, device):
        self.detect_fn = detect_fn
        self.device = torch.device(device)

    def __call__(self, frame, bbox_xyxy, **_):
        mask = self.detect_fn(np.asarray(frame.cpu()), np.asarray(bbox_xyxy.cpu()))
        return torch.as_tensor(np.asarray(mask).astype(bool)).to(self.device)


class MaskRCNNSegmenter:
    """The reference's detector (models/maskrcnn.py).

    Runs single-image Mask R-CNN on the frame resized to ``input_hw``, picks per
    query bbox the highest-scoring detection of an allowed class (COCO 3 = car,
    6 = bus, 8 = truck) whose box IoU with the bbox is at least ``min_iou``, and
    pastes its 28x28 mask into frame coordinates; an all-false mask when nothing
    qualifies."""

    def __init__(self, model, classes=(3, 6, 8), min_iou: float = 0.3,
                 input_hw=(512, 1024), mask_threshold: float = 0.5, *, device):
        self.model = model.to(device).eval()
        self.device = torch.device(device)
        self.classes = tuple(classes)
        self.min_iou = min_iou
        self.input_hw = tuple(input_hw)
        self.mask_threshold = mask_threshold

    def __call__(self, frame, bbox_xyxy, **_):
        return self.masks_for_bboxes(frame, bbox_xyxy[None])[0]

    def detect(self, frame: torch.Tensor):
        """Detections of one (H, W, 3) frame, boxes in frame coordinates."""
        from future_urban_scene_generation_tpu_torch.models.maskrcnn import maskrcnn_infer
        from future_urban_scene_generation_tpu_torch.ops.resize import resize_bilinear

        h, w = frame.shape[0], frame.shape[1]
        ih, iw = self.input_hw
        det = maskrcnn_infer(self.model, resize_bilinear(frame, (ih, iw)))
        return det._replace(boxes=scale_boxes(det.boxes, w / iw, h / ih))

    @torch.no_grad()
    def masks_for_bboxes(self, frame: torch.Tensor, bboxes_xyxy: torch.Tensor) -> torch.Tensor:
        """All vehicle masks of one frame from one detector pass: (H, W, 3),
        (V, 4) -> (V, H, W) bool (the reference re-runs the detector per vehicle on
        a context crop; the JAX package detects once per frame and selects per bbox,
        trajectory_inference.py:115-119, 319-324)."""
        from future_urban_scene_generation_tpu_torch.models.maskrcnn import paste_masks
        from future_urban_scene_generation_tpu_torch.ops.detection import batched_iou

        h, w = frame.shape[0], frame.shape[1]
        det = self.detect(frame)
        cls_ok = torch.zeros_like(det.valid)
        for c in self.classes:
            cls_ok = cls_ok | (det.labels == c)
        iou = batched_iou(det.boxes, bboxes_xyxy.to(torch.float32))  # (D, V)
        score = torch.where(det.valid[:, None] & cls_ok[:, None] & (iou >= self.min_iou),
                            det.scores[:, None], torch.full_like(iou, -1.0))
        best = first_argmax(score, dim=0)  # (V,)
        pasted = paste_masks(det.masks[best], det.boxes[best], h, w)
        hit = score.gather(0, best[None])[0] > 0
        return (pasted >= self.mask_threshold) & hit[:, None, None]


def scale_boxes(boxes: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """xyxy boxes scaled by (sx, sy), with no host-to-device copy."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0 * sx, y0 * sy, x1 * sx, y1 * sy], dim=-1)


def first_argmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The index of the first maximum along ``dim`` (``jnp.argmax``'s tie rule;
    ``torch.argmax`` does not promise one)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape).expand_as(x)
    is_max = x == x.amax(dim=dim, keepdim=True)
    return torch.where(is_max, idx, torch.full_like(idx, n)).amin(dim=dim)
