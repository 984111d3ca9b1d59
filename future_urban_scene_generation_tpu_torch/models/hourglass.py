"""Stacked hourglass keypoint network and the heatmap decode.

Counterpart of the JAX package's models/hourglass.py (``HourglassNet``,
``decode_heatmaps`` :130). Module names follow the reference
(stacked_hourglass/models.py:5-167), so ``hourglass.pth`` loads unchanged. NHWC.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import (
    Conv2d,
    max_pool2,
    upsample2x_nearest,
)


class BatchNorm2d(nn.BatchNorm2d):
    """Inference batch norm (running statistics) on NHWC."""

    def forward(self, x):
        y = F.batch_norm(
            x.permute(0, 3, 1, 2), self.running_mean, self.running_var, self.weight,
            self.bias, False, 0.0, self.eps,
        )
        return y.permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck, expansion 2."""

    def __init__(self, cin: int, planes: int, downsample: bool = False):
        super().__init__()
        self.bn1, self.conv1 = BatchNorm2d(cin), Conv2d(cin, planes, 1)
        self.bn2, self.conv2 = BatchNorm2d(planes), Conv2d(planes, planes, 3, padding=1)
        self.bn3, self.conv3 = BatchNorm2d(planes), Conv2d(planes, planes * 2, 1)
        self.downsample = nn.Sequential(Conv2d(cin, planes * 2, 1)) if downsample else None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + r


class Hourglass(nn.Module):
    def __init__(self, planes: int = 128, depth: int = 4, num_blocks: int = 1):
        super().__init__()
        self.depth = depth
        self.hg = nn.ModuleList(
            nn.ModuleList(
                nn.Sequential(*[Bottleneck(planes * 2, planes) for _ in range(num_blocks)])
                for _ in range(4 if i == 0 else 3)
            )
            for i in range(depth)
        )

    def _fwd(self, n, x):
        up1 = self.hg[n - 1][0](x)
        low1 = self.hg[n - 1][1](max_pool2(x))
        if n > 1:
            low2 = self._fwd(n - 1, low1)
        else:
            low2 = self.hg[n - 1][3](low1)
        low3 = self.hg[n - 1][2](low2)
        return up1 + upsample2x_nearest(low3)

    def forward(self, x):
        return self._fwd(self.depth, x)


class HourglassNet(nn.Module):
    def __init__(self, num_stacks: int = 2, num_blocks: int = 1, num_classes: int = 12,
                 num_feats: int = 128):
        super().__init__()
        self.num_stacks = num_stacks
        ch = num_feats * 2
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = BatchNorm2d(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, downsample=True))
        self.layer2 = nn.Sequential(Bottleneck(128, 128, downsample=True))
        self.layer3 = nn.Sequential(Bottleneck(256, num_feats))
        self.hg = nn.ModuleList(
            [Hourglass(num_feats, 4, num_blocks) for _ in range(num_stacks)]
        )
        self.res = nn.ModuleList(
            nn.Sequential(*[Bottleneck(ch, num_feats) for _ in range(num_blocks)])
            for _ in range(num_stacks)
        )
        self.fc = nn.ModuleList(
            nn.Sequential(Conv2d(ch, ch, 1), BatchNorm2d(ch), nn.ReLU())
            for _ in range(num_stacks)
        )
        self.score = nn.ModuleList(Conv2d(ch, num_classes, 1) for _ in range(num_stacks))
        self.fc_ = nn.ModuleList(Conv2d(ch, ch, 1) for _ in range(num_stacks - 1))
        self.score_ = nn.ModuleList(
            Conv2d(num_classes, ch, 1) for _ in range(num_stacks - 1)
        )

    def forward(self, x):
        """x (B, 256, 256, 3) NHWC -> list of per-stack (B, 64, 64, K) heatmaps."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer1(x)
        x = max_pool2(x)
        x = self.layer2(x)
        x = self.layer3(x)
        heatmaps = []
        for i in range(self.num_stacks):
            y = self.hg[i](x)
            y = self.fc[i](self.res[i](y))
            score = self.score[i](y)
            heatmaps.append(score)
            if i < self.num_stacks - 1:
                x = x + self.fc_[i](y) + self.score_[i](score)
        return heatmaps


def decode_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """Per-keypoint argmax (first maximum) -> normalized (x, y) in [0, 1]:
    (..., H, W, K) -> (..., K, 2), cell c mapped to pixel 4c of the 256 crop."""
    h, w, k = heatmaps.shape[-3], heatmaps.shape[-2], heatmaps.shape[-1]
    up = 256 // h
    flat = heatmaps.reshape(heatmaps.shape[:-3] + (h * w, k))
    idx = torch.argmax(flat, dim=-2)
    ys = torch.div(idx, w, rounding_mode="floor")
    xs = idx % w
    x_norm = (xs * up).to(torch.float32) / (w * up)
    y_norm = (ys * up).to(torch.float32) / (h * up)
    return torch.stack([x_norm, y_norm], dim=-1)
