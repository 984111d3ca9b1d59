"""Vehicle erasure: segmentation mask -> EdgeConnect's two-stage inpainting.

Counterpart of the JAX package's pipeline/inpaint.py (:33-108; the reference's
inpaint branch, trajectory_inference.py:107-145 and utils/inpaint_utils.py:22-58).
For one vehicle: a 1.3x context box around its bbox, the mask dilated with the 8x8
elliptical element, the masked pixels painted white, the window resampled to 256^2,
Canny edges outside the mask (sigma = config.SIGMA), the edge generator, the inpaint
generator, and the merged crop pasted back through the window.

The erase is batched over frames that share the vehicle's bbox (the service's six
future frames): one edge- and one inpaint-generator call of batch S a vehicle.
Vehicles are erased in turn, each seeing the frames the previous erase left, as the
reference accumulates into its inpainted frame. A vehicle whose context window is
empty (the service's padding rows, bbox (0, 0, 0, 0)) writes no pixel in the JAX
erase either, so it is skipped.

The generators take the int8 serving tier from the caller's scope
(``models.layers.quantized_convs``): the service erases inside its spec's, where the
JAX package's process-wide ``MODEL_SPEC`` reaches its erase.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.models.edgeconnect import (
    edge_model_forward,
    inpaint_model_forward,
)
from future_urban_scene_generation_tpu_torch.ops import colorspace as cs
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.ops.canny import canny
from future_urban_scene_generation_tpu_torch.ops.morphology import dilate, elliptical_kernel

DILATE_SE = elliptical_kernel(8)  # utils/inpaint_utils.py:42
RES = 256


def context_window(bbox_xyxy: torch.Tensor, frame_hw, scale: float = 1.3) -> cr.Window:
    """The reference's 1.3x context box of a (4,) xyxy bbox: int-truncated rescale
    about the centre, clipped to the frame (utils/inpaint_utils.py:23 and
    utils/bounding_box.py:29-51). Computed in float64, as the reference's Python
    floats: in float32, ``bw * 1.3 - bw`` lands within rounding of an integer
    whenever 0.3 * bw is one, and the truncation then depends on whether the product
    is rounded before the subtraction (the JAX package's jitted erase contracts the
    two into one FMA there and truncates one pixel lower). Fields are 0-d float32
    tensors on the bbox's device."""
    dev = bbox_xyxy.device
    bbox_xyxy = bbox_xyxy.to(torch.float64)
    h, w = frame_hw
    x_min = torch.trunc(bbox_xyxy[0])
    y_min = torch.trunc(bbox_xyxy[1])
    x_max = x_min + torch.trunc(bbox_xyxy[2] - bbox_xyxy[0])
    y_max = y_min + torch.trunc(bbox_xyxy[3] - bbox_xyxy[1])
    bw = x_max - x_min
    bh = y_max - y_min
    dw = torch.floor(torch.trunc(bw * scale - bw) / 2.0)
    dh = torch.floor(torch.trunc(bh * scale - bh) / 2.0)
    x0 = torch.clamp(x_min - dw, min=0.0)
    y0 = torch.clamp(y_min - dh, min=0.0)
    x1 = torch.clamp(x_max + dw, max=w - 1.0)
    y1 = torch.clamp(y_max + dh, max=h - 1.0)
    return cr.Window(x0, y0, x1 - x0, y1 - y0).map(lambda f: f.to(torch.float32).to(dev))


def _mask_crop_nearest(mask: torch.Tensor, window: cr.Window, out: int) -> torch.Tensor:
    """Nearest-sample (B, H, W) bool masks into the window at out^2."""
    h, w = mask.shape[-2:]
    coords = (torch.arange(out, dtype=torch.float32, device=mask.device) + 0.5) / out
    xs = torch.clamp(window.x_start + coords * window.w - 0.5, 0, w - 1)
    ys = torch.clamp(window.y_start + coords * window.h - 0.5, 0, h - 1)
    xi = torch.round(xs).long()
    yi = torch.round(ys).long()
    return mask[:, yi[:, None], xi[None, :]]


class EraseInputs(NamedTuple):
    """What the generators see for one vehicle on S frames."""

    window: cr.Window     # fields 0-d: the context window in frame coordinates
    img: torch.Tensor     # (S, 256, 256, 3) the window, the dilated mask painted white
    mask: torch.Tensor    # (S, 256, 256) bool, the dilated mask in the window
    gray: torch.Tensor    # (S, 256, 256, 1)
    edge: torch.Tensor    # (S, 256, 256) bool, Canny outside the mask


def erase_inputs(frames: torch.Tensor, bbox_xyxy: torch.Tensor, mask_frames: torch.Tensor,
                 sigma: float = 2.0) -> EraseInputs:
    """The generators' inputs for one vehicle: frames (S, H, W, 3), its (4,) bbox,
    masks (S, H, W) bool (JAX inpaint.py:68-84)."""
    h, w = frames.shape[1:3]
    window = context_window(bbox_xyxy, (h, w)).map(lambda f: f.to(frames.device))
    mask_d = dilate(mask_frames, DILATE_SE)
    frame_white = torch.where(mask_d[..., None], torch.ones_like(frames), frames)
    img = cr.crop_resize(frame_white, window.map(lambda f: f.reshape(1)), RES)
    mask_c = _mask_crop_nearest(mask_d, window, RES)
    gray = cs.rgb_to_gray(img)
    edge = canny(gray[..., 0], sigma=sigma, mask=~mask_c)
    return EraseInputs(window, img, mask_c, gray, edge)


@torch.no_grad()
def erase_from_inputs(edge_gen, inpaint_gen, frames: torch.Tensor,
                      inputs: EraseInputs) -> torch.Tensor:
    """The two generators on ``inputs`` and the merged crops pasted back through the
    window onto frames (S, H, W, 3) (JAX inpaint.py:86-96)."""
    s, h, w = frames.shape[:3]
    mask_f = inputs.mask.to(frames.dtype)[..., None]
    edge = inputs.edge.to(frames.dtype)[..., None]
    edge_out = edge_model_forward(edge_gen, inputs.gray, edge, mask_f)
    inpainted = inpaint_model_forward(inpaint_gen, inputs.img, edge_out, mask_f)
    merged = inpainted * mask_f + inputs.img * (1.0 - mask_f)
    all_inside = torch.ones((s, h, w), dtype=torch.bool, device=frames.device)
    return cr.stitch(frames, merged, inputs.window.map(lambda f: f.reshape(1).expand(s)),
                     all_inside)


@torch.no_grad()
def erase_vehicle(edge_gen, inpaint_gen, frames: torch.Tensor, bbox_xyxy: torch.Tensor,
                  mask_frames: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Remove one vehicle from frames (S, H, W, 3) (or one (H, W, 3) frame) that
    share its (4,) bbox; ``mask_frames`` (S, H, W) (or (H, W)) bool segmentation."""
    if frames.dim() == 3:
        return erase_vehicle(edge_gen, inpaint_gen, frames[None], bbox_xyxy,
                             mask_frames[None], sigma)[0]
    inputs = erase_inputs(frames, bbox_xyxy, mask_frames, sigma)
    return erase_from_inputs(edge_gen, inpaint_gen, frames, inputs)


def window_is_empty(bbox_xyxy, frame_hw) -> bool:
    """Whether the vehicle's context window covers no pixel (its erase is a no-op)."""
    win = context_window(torch.as_tensor(np.asarray(bbox_xyxy, np.float32)), frame_hw)
    return not (float(win.w) > 0 and float(win.h) > 0)


def erase_vehicles(edge_gen, inpaint_gen, frames: torch.Tensor, bboxes, masks: torch.Tensor,
                   sigma: float = 2.0) -> torch.Tensor:
    """Erase V vehicles in turn (each erase sees the previous result, as the
    reference accumulates into inpainted_frame, trajectory_inference.py:134-145).

    frames (S, H, W, 3) with masks (S, V, H, W), or one frame (H, W, 3) with masks
    (V, H, W); bboxes (V, 4) xyxy on the host (numpy or a CPU tensor)."""
    single = frames.dim() == 3
    if single:
        frames, masks = frames[None], masks[None]
    bboxes = np.asarray(bboxes, np.float32)
    hw = tuple(frames.shape[1:3])
    for v in range(len(bboxes)):
        if window_is_empty(bboxes[v], hw):
            continue
        frames = erase_vehicle(edge_gen, inpaint_gen, frames, torch.as_tensor(bboxes[v]),
                               masks[:, v], sigma=sigma)
    return frames[0] if single else frames
