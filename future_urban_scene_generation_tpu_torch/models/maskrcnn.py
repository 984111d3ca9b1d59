"""Mask R-CNN (ResNet-50-FPN), the reference's vehicle detector, in NHWC torch with
fixed output counts.

Counterpart of the JAX package's models/maskrcnn.py (:48-576; the reference calls
torchvision's ``maskrcnn_resnet50_fpn``, maskrcnn/inference.py:19-24, 41-64). The
modules keep torchvision's state-dict names (``backbone.body.layer1.0.conv1.weight``,
``rpn.head.cls_logits.weight``, ``roi_heads.box_head.fc6.weight``, ...), so
``convert_maskrcnn`` only normalizes the newer torchvision key forms and the state
dict loads ``strict=True``. Batch norms are torchvision's FrozenBatchNorm2d.

Geometry follows torchvision's detection defaults, as the JAX package does:

* anchors (32, 64, 128, 256, 512) x aspect (0.5, 1, 2) on strides (4 .. 64);
* RPN: the top ``pre_nms_top_n`` a level, IoU 0.7 NMS, the top ``post_nms_top_n``
  proposals over all levels;
* box decoding weights (1, 1, 1, 1) for the RPN and (10, 10, 5, 5) for the box head,
  dw/dh clamped to log(1000/16);
* RoIAlign (torchvision's aligned=False) 7x7 for boxes, 14x14 for masks, each box
  on level floor(4 + log2(sqrt(area) / 224)) clamped to [2, 5]: pooled from that
  level only (``ops.detection.roi_align_levels``), where the JAX ``maskrcnn_infer``
  pools every level and selects;
* score > 0.05, per-class IoU-0.5 NMS over the top 1,000 class scores (classes kept
  apart by offsetting their boxes), the top ``detections_per_img``.

Invalid entries carry score -1 into every cut, so ties straddle them: every top-k
and sort is a stable descending sort (``ops.detection.sort_desc``), as
``lax.top_k`` and ``jnp.argsort`` are. Both NMS passes take boxes already in that
order (``ops.detection.nms_sorted_segments``: no second sort): the five RPN levels in
one call, their -1 scores where they fall, since a box under the score threshold is
never kept and suppresses nothing and ``sigmoid`` keeps the logits' order; the class
NMS on its top-1,000 candidates. On the card each call is one launch of kernel N1, two
a frame.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    seeded_init_,
)
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.ops.detection import (
    nms_sorted_segments,
    roi_align_levels,
    topk_stable,
)

ANCHOR_SIZES = (32.0, 64.0, 128.0, 256.0, 512.0)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
STRIDES = (4, 8, 16, 32, 64)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm2d(nn.Module):
    """torchvision FrozenBatchNorm2d on NHWC: fixed statistics and affine, held as
    buffers (no ``num_batches_tracked``), eps 1e-5."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)


class Bottleneck(nn.Module):
    """torchvision's resnet Bottleneck: 1x1, 3x3 (stride), 1x1 (x4), frozen BN."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * 4)
        self.downsample = nn.Sequential(
            Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
            FrozenBatchNorm2d(planes * 4)) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idn = self.downsample(x) if self.downsample is not None else x
        return torch.relu(out + idn)


class ResNetBody(nn.Module):
    """The ResNet trunk, returning the four stage outputs (c2, c3, c4, c5)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        self.conv1 = Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        cin = width
        for stage, blocks in enumerate(layers):
            planes = width * 2 ** stage
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                seq.append(Bottleneck(cin, planes, stride if b == 0 else 1, downsample=b == 0))
                cin = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.n_stages = len(layers)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        # torch MaxPool2d(3, 2, padding=1) (pads with -inf).
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs = []
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Feature pyramid: inner 1x1 convs, nearest top-down sums, 3x3 layer convs, and
    P6 as a stride-2 subsample of P5 (LastLevelMaxPool)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(Conv2d(c, out_channels, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, padding=1) for _ in in_channels)

    def forward(self, feats):
        inners = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        merged = [inners[-1]]
        for inner in inners[-2::-1]:
            up = merged[0].repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            merged.insert(0, inner + up[:, : inner.shape[1], : inner.shape[2]])
        outs = [blk(m) for blk, m in zip(self.layer_blocks, merged)]
        return outs + [outs[-1][:, ::2, ::2]]


class Backbone(nn.Module):
    def __init__(self, layers, width, out_channels):
        super().__init__()
        self.body = ResNetBody(layers, width)
        self.fpn = FPN([width * 2 ** s * 4 for s in range(len(layers))], out_channels)

    def forward(self, x):
        return self.fpn(self.body(x))


class RPNHead(nn.Module):
    def __init__(self, c: int, num_anchors: int = 3):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)
        self.cls_logits = Conv2d(c, num_anchors, 1)
        self.bbox_pred = Conv2d(c, num_anchors * 4, 1)

    def forward(self, feats):
        logits, deltas = [], []
        for f in feats:
            t = torch.relu(self.conv(f))
            logits.append(self.cls_logits(t))
            deltas.append(self.bbox_pred(t))
        return logits, deltas


class RPN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.head = RPNHead(c)


class BoxHead(nn.Module):
    """TwoMLPHead: flatten in torch's (C, 7, 7) order, fc6, fc7."""

    def __init__(self, c: int, representation_size: int):
        super().__init__()
        self.fc6 = nn.Linear(c * 49, representation_size)
        self.fc7 = nn.Linear(representation_size, representation_size)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return torch.relu(self.fc7(torch.relu(self.fc6(x))))


class BoxPredictor(nn.Module):
    def __init__(self, representation_size: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(representation_size, num_classes)
        self.bbox_pred = nn.Linear(representation_size, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"mask_fcn{i}", Conv2d(c, c, 3, padding=1))

    def forward(self, x):
        for i in range(1, 5):
            x = torch.relu(getattr(self, f"mask_fcn{i}")(x))
        return x


class MaskPredictor(nn.Module):
    def __init__(self, c: int, num_classes: int):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(c, c, 2, 2, 0)
        self.mask_fcn_logits = Conv2d(c, num_classes, 1)

    def forward(self, x):
        return self.mask_fcn_logits(torch.relu(self.conv5_mask(x)))


class RoiHeads(nn.Module):
    def __init__(self, c: int, representation_size: int, num_classes: int):
        super().__init__()
        self.box_head = BoxHead(c, representation_size)
        self.box_predictor = BoxPredictor(representation_size, num_classes)
        self.mask_head = MaskHead(c)
        self.mask_predictor = MaskPredictor(c, num_classes)


class MaskRCNN(nn.Module):
    """The networks under torchvision's module paths; ``maskrcnn_infer`` drives them."""

    def __init__(self, num_classes: int = 91, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 width: int = 64, out_channels: int = 256, representation_size: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = Backbone(tuple(layers), width, out_channels)
        self.rpn = RPN(out_channels)
        self.roi_heads = RoiHeads(out_channels, representation_size, num_classes)
        # Constants of ``maskrcnn_infer``, moved with the model, so that inference makes
        # no host-to-device copy (one would wait for the work queued before it).
        self.register_buffer("image_mean", torch.tensor(IMAGE_MEAN), persistent=False)
        self.register_buffer("image_std", torch.tensor(IMAGE_STD), persistent=False)
        self.register_buffer("cell_anchors", torch.stack([cell_anchors(s) for s in ANCHOR_SIZES]),
                             persistent=False)

    @staticmethod
    def build(generator: torch.Generator = None, *, device, **config) -> "MaskRCNN":
        """The network for ``config`` (the constructor's arguments) in eval mode on
        ``device``, drawn from ``generator`` on the host (``layers.seeded_init_``)
        when one is given, else left for a weight load to fill."""
        model = MaskRCNN(**config).eval().requires_grad_(False)
        if generator is not None:
            seeded_init_(model, generator)
        return model.to(device)

    def features(self, images):
        return self.backbone(images)

    def rpn_head(self, feats):
        return self.rpn.head(feats)

    def box_heads(self, pooled):
        return self.roi_heads.box_predictor(self.roi_heads.box_head(pooled))

    def mask_heads(self, pooled):
        return self.roi_heads.mask_predictor(self.roi_heads.mask_head(pooled))


# ---------------------------------------------------------------------------
# Anchors and box coding (torchvision AnchorGenerator / BoxCoder)
# ---------------------------------------------------------------------------

def cell_anchors(size: float, ratios: Sequence[float] = ASPECT_RATIOS, device="cpu"):
    """Zero-centred anchors of one level, (A, 4) xyxy, rounded as torchvision's."""
    ratios = torch.tensor(ratios, dtype=torch.float32, device=device)
    h_ratios = torch.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = w_ratios * size
    hs = h_ratios * size
    return torch.round(torch.stack([-ws, -hs, ws, hs], dim=1) / 2.0)


def grid_anchors(feat_h: int, feat_w: int, stride: int, size: float, device="cpu",
                 base=None):
    """All anchors of one level, (H * W * A, 4) in image coordinates, in torchvision's
    (row, column, anchor) order; ``base`` is the level's ``cell_anchors`` when the
    caller has them on the device."""
    if base is None:
        base = cell_anchors(size, device=device)
    shifts_x = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    shifts_y = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode_boxes(deltas, anchors, weights=(1.0, 1.0, 1.0, 1.0)):
    """torchvision BoxCoder.decode of (..., 4) deltas against (..., 4) xyxy anchors."""
    wx, wy, ww, wh = weights
    widths = anchors[..., 2] - anchors[..., 0]
    heights = anchors[..., 3] - anchors[..., 1]
    ctr_x = anchors[..., 0] + 0.5 * widths
    ctr_y = anchors[..., 1] + 0.5 * heights
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = torch.clamp(dw / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(dh / wh, max=BBOX_XFORM_CLIP)
    pred_ctr_x = dx / wx * widths + ctr_x
    pred_ctr_y = dy / wy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=-1)


def clip_boxes(boxes, h: int, w: int):
    x0 = torch.clamp(boxes[..., 0], 0, w)
    y0 = torch.clamp(boxes[..., 1], 0, h)
    x1 = torch.clamp(boxes[..., 2], 0, w)
    y1 = torch.clamp(boxes[..., 3], 0, h)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def fpn_level(boxes, canonical_scale: float = 224.0, canonical_level: int = 4):
    """torchvision LevelMapper: floor(k0 + log2(sqrt(area) / s0 + 1e-6)) clamped to
    [2, 5], as an index 0..3 into (p2, p3, p4, p5)."""
    scales = torch.sqrt(torch.clamp(boxes[:, 2] - boxes[:, 0], min=0)
                        * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0))
    lvl = torch.floor(canonical_level + torch.log2(scales / canonical_scale + 1e-6))
    return torch.clamp(lvl, 2, 5).long() - 2


def multilevel_roi_align(feats, boxes, output_size: int):
    """RoIAlign over (p2 .. p5) of a one-image pyramid (NHWC, batch 1), each box on
    its level (``fpn_level``)."""
    return roi_align_levels([f[0] for f in feats[:4]], STRIDES[:4], boxes,
                            fpn_level(boxes), output_size)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

class Detections(NamedTuple):
    boxes: torch.Tensor   # (D, 4) xyxy, image coordinates
    scores: torch.Tensor  # (D,)
    labels: torch.Tensor  # (D,) int64
    masks: torch.Tensor   # (D, 28, 28) probabilities in the box's frame
    valid: torch.Tensor   # (D,) bool


def _rpn_proposals(model, logits, deltas, h, w, pre_nms_top_n, post_nms_top_n):
    """Per level: top-k objectness, decode, clip, tiny boxes to score -1; one NMS call
    over the levels' segments; then the top ``post_nms_top_n`` over all levels."""
    level_boxes, level_scores = [], []
    for i, (lg, dl) in enumerate(zip(logits, deltas)):
        fh, fw = lg.shape[1:3]
        anchors = grid_anchors(fh, fw, STRIDES[i], ANCHOR_SIZES[i], device=lg.device,
                               base=model.cell_anchors[i])
        scores = lg[0].reshape(-1).to(torch.float32)
        dl_hw = dl[0].reshape(-1, 4).to(torch.float32)
        k = min(pre_nms_top_n, scores.shape[0])
        top_scores, top_idx = topk_stable(scores, k)
        boxes = clip_boxes(decode_boxes(dl_hw[top_idx], anchors[top_idx]), h, w)
        keep_size = ((boxes[:, 2] - boxes[:, 0]) >= 1e-3) & ((boxes[:, 3] - boxes[:, 1]) >= 1e-3)
        level_boxes.append(boxes)
        level_scores.append(torch.where(keep_size, torch.sigmoid(top_scores),
                                        torch.full_like(top_scores, -1.0)))
    lens = [b.shape[0] for b in level_boxes]
    kept = nms_sorted_segments(torch.cat(level_boxes), torch.cat(level_scores), lens,
                               iou_threshold=0.7, score_threshold=-0.5,
                               max_outputs=[min(post_nms_top_n, k) for k in lens])
    all_boxes, all_scores = [], []
    for boxes, scores_lvl, idx in zip(level_boxes, level_scores, kept):
        sel = torch.clamp(idx, min=0)
        all_boxes.append(boxes[sel])
        all_scores.append(torch.where(idx >= 0, scores_lvl[sel],
                                      torch.full_like(sel, -1.0, dtype=torch.float32)))
    proposals = torch.cat(all_boxes)
    prop_scores = torch.cat(all_scores)
    _, keep = topk_stable(prop_scores, min(post_nms_top_n, prop_scores.shape[0]))
    return proposals[keep]


@torch.no_grad()
def maskrcnn_infer(model: MaskRCNN, image: torch.Tensor, pre_nms_top_n: int = 1000,
                   post_nms_top_n: int = 1000, score_thresh: float = 0.05,
                   detections_per_img: int = 100) -> Detections:
    """Single-image inference: ``image`` (H, W, 3) RGB in [0, 1], H and W multiples of
    64 (the caller resizes: GeneralizedRCNNTransform's min/max-size resize is the
    JAX package's documented preprocessing delta, PARITY.md)."""
    h, w, _ = image.shape
    dev = image.device
    feats = model.features(((image - model.image_mean) / model.image_std)[None])
    logits, deltas = model.rpn_head(feats)
    proposals = _rpn_proposals(model, logits, deltas, h, w, pre_nms_top_n, post_nms_top_n)

    # Box head and per-class decode (background 0 skipped), flattened (C - 1) x N.
    class_logits, box_deltas = model.box_heads(multilevel_roi_align(feats, proposals, 7))
    probs = torch.softmax(class_logits.to(torch.float32), dim=-1)
    n, num_classes = probs.shape
    box_deltas = box_deltas.to(torch.float32).reshape(n, num_classes, 4)
    cls_ids = torch.arange(1, num_classes, device=dev)
    boxes_pc = clip_boxes(decode_boxes(box_deltas[:, 1:].permute(1, 0, 2), proposals[None],
                                       weights=(10.0, 10.0, 5.0, 5.0)), h, w)
    scores_pc = probs[:, 1:].T
    ws = boxes_pc[..., 2] - boxes_pc[..., 0]
    hs = boxes_pc[..., 3] - boxes_pc[..., 1]
    scores_pc = torch.where((scores_pc > score_thresh) & (ws >= 1e-2) & (hs >= 1e-2),
                            scores_pc, torch.full_like(scores_pc, -1.0))

    # Per-class NMS as one call: boxes offset by class so classes never overlap, over
    # the top 1,000 class scores (the JAX candidate cut).
    flat_boxes = boxes_pc.reshape(-1, 4)
    flat_scores = scores_pc.reshape(-1)
    flat_labels = cls_ids.repeat_interleave(n)
    cand_scores, cand_idx = topk_stable(flat_scores, min(1000, flat_scores.shape[0]))
    cand_boxes = flat_boxes[cand_idx]
    cand_labels = flat_labels[cand_idx]
    offset = cand_labels.to(torch.float32)[:, None] * (max(h, w) + 2.0)
    (idx,) = nms_sorted_segments(cand_boxes + offset, cand_scores, [cand_scores.shape[0]],
                                 iou_threshold=0.5, score_threshold=-0.5,
                                 max_outputs=[detections_per_img])
    valid = idx >= 0
    sel = torch.clamp(idx, min=0)
    det_boxes = cand_boxes[sel]
    det_scores = torch.where(valid, cand_scores[sel], torch.zeros_like(cand_scores[sel]))
    det_labels = torch.where(valid, cand_labels[sel], torch.zeros_like(cand_labels[sel]))

    # Mask head on the final detections; each keeps its own class's mask.
    mask_logits = model.mask_heads(multilevel_roi_align(feats, det_boxes, 14))
    mask_probs = torch.sigmoid(mask_logits.to(torch.float32))  # (D, 28, 28, C)
    det_masks = mask_probs.gather(
        -1, det_labels[:, None, None, None].expand(-1, *mask_probs.shape[1:3], 1))[..., 0]
    return Detections(det_boxes, det_scores, det_labels, det_masks, valid)


def paste_masks(masks28: torch.Tensor, boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Paste (V, 28, 28) box-frame masks into (V, h, w) frames by resampling each onto
    its box (the JAX ``paste_mask``, maskrcnn.py:528: torchvision's 1-pixel padding is
    skipped, a sub-pixel difference at vehicle scales)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    win = cr.Window(x0, y0, torch.clamp(x1 - x0, min=1.0), torch.clamp(y1 - y0, min=1.0))
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[None, :, None]
    inside = ((xs >= x0[:, None, None]) & (xs < x1[:, None, None])
              & (ys >= y0[:, None, None]) & (ys < y1[:, None, None]))
    canvas = torch.zeros((boxes.shape[0], h, w, 1), dtype=masks28.dtype, device=boxes.device)
    return cr.stitch(canvas, masks28[..., None], win, inside)[..., 0]


def paste_mask(mask28: torch.Tensor, box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One (28, 28) mask into an (h, w) frame (JAX ``paste_mask``)."""
    return paste_masks(mask28[None], box[None], h, w)[0]


def convert_maskrcnn(state_dict) -> dict:
    """A torchvision ``maskrcnn_resnet50_fpn`` state dict under the names this module
    uses: newer torchvision wraps the FPN and RPN-head convs in Conv2dNormActivation
    (``inner_blocks.0.0.weight``, ``rpn.head.conv.0.0.weight``) and the mask head's
    convs in a Sequential (``mask_head.0.0.weight``); those become the flat names
    (``inner_blocks.0.weight``, ``rpn.head.conv.weight``,
    ``mask_head.mask_fcn1.weight``). Values pass through unchanged."""
    sd = {}
    for key, v in state_dict.items():
        k = key
        for pat in ("inner_blocks.", "layer_blocks."):
            if pat in k:
                head, tail = k.split(pat, 1)
                parts = tail.split(".")
                if len(parts) >= 3 and parts[0].isdigit() and parts[1] == "0":
                    k = head + pat + parts[0] + "." + ".".join(parts[2:])
        if ".head.conv.0.0." in k:
            k = k.replace(".head.conv.0.0.", ".head.conv.")
        if ".mask_head." in k:
            head, tail = k.split(".mask_head.", 1)
            parts = tail.split(".")
            if len(parts) == 3 and parts[0].isdigit() and parts[1] == "0":
                k = f"{head}.mask_head.mask_fcn{int(parts[0]) + 1}.{parts[2]}"
        sd[k] = v
    return sd
