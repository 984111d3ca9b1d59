"""VGG19 with a ``num_classes``-way head: the CAD-shape classifier.

Counterpart of the JAX package's models/vgg.py ``VGG19Classifier``. Module names are
torchvision's (``features.N``, ``classifier.N``), so the reference's ``cads/model.pth``
loads unchanged. NHWC input, ImageNet-normalized.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import Conv2d, max_pool2

_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


class VGG19Classifier(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        feats, cin = [], 3
        for v in _CFG:
            if v == "M":
                feats.append(nn.MaxPool2d(2, 2))
            else:
                feats += [Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        """x (B, H, W, 3) NHWC -> logits (B, num_classes)."""
        for m in self.features:
            if isinstance(m, nn.MaxPool2d):
                x = max_pool2(x)
            elif isinstance(m, Conv2d):
                x = m(x)
            else:
                x = F.relu(x)
        pooled = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (7, 7))
        flat = torch.flatten(pooled, 1)  # torch's (C, H, W) flatten order
        fc0, fc3, fc6 = self.classifier[0], self.classifier[3], self.classifier[6]
        h = F.relu(fc0(flat))
        h = F.relu(fc3(h))
        return fc6(h)
