"""VGG19: the conv trunk with its named relu taps (EdgeConnect's loss features) and
the trunk with a ``num_classes``-way head (the CAD-shape classifier).

Counterpart of the JAX package's models/vgg.py ``VGG19Features`` (:55-70) and
``VGG19Classifier``. Module names are torchvision's (``features.N``,
``classifier.N``), so the reference's ``cads/model.pth`` and a torchvision vgg19
state dict load unchanged. NHWC input; the classifier's is ImageNet-normalized, the
loss trunk's is the [0, 1] image itself (the JAX trainer feeds it so,
training.py:439-443).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import Conv2d, max_pool2

_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def _features() -> nn.Sequential:
    """torchvision's vgg19 ``features`` Sequential (conv, ReLU, ..., MaxPool)."""
    feats, cin = [], 3
    for v in _CFG:
        if v == "M":
            feats.append(nn.MaxPool2d(2, 2))
        else:
            feats += [Conv2d(cin, v, 3, padding=1), nn.ReLU()]
            cin = v
    return nn.Sequential(*feats)


def _tap_names():
    """The relu tap after each conv, relu{block}_{index} (edgeconnect/loss.py:127-173)."""
    names, block, i = [], 1, 0
    for v in _CFG:
        if v == "M":
            block, i = block + 1, 0
        else:
            i += 1
            names.append(f"relu{block}_{i}")
    return tuple(names)


TAPS = _tap_names()


def _trunk(features: nn.Sequential, x, taps=None):
    """Run the trunk on NHWC ``x``; each ReLU's output goes into ``taps`` in order."""
    names = iter(TAPS)
    for m in features:
        if isinstance(m, nn.MaxPool2d):
            x = max_pool2(x)
        elif isinstance(m, Conv2d):
            x = m(x)
        else:
            x = F.relu(x)
            if taps is not None:
                taps[next(names)] = x
    return x


class VGG19Features(nn.Module):
    """The conv trunk returning its 16 relu taps by name (``relu1_1`` ...
    ``relu5_4``) and ``final`` (after the last max pool)."""

    def __init__(self):
        super().__init__()
        self.features = _features()

    def forward(self, x) -> Dict[str, torch.Tensor]:
        taps: Dict[str, torch.Tensor] = {}
        taps["final"] = _trunk(self.features, x, taps)
        return taps


def load_vgg19_features(path, *, device) -> VGG19Features:
    """A frozen ``VGG19Features`` (eval mode, ``requires_grad`` off) on ``device``
    with the ``features.*`` entries of a local ``.pth``: a torchvision vgg19 state
    dict, the CAD classifier's ``cads/model.pth`` (same trunk) or a bare trunk, a
    ``{"state_dict": ...}`` wrapper unwrapped and a ``module.`` / ``vgg.`` prefix
    stripped (JAX cli/train.py:209-213, ``convert_vgg19_features``). Other entries are
    ignored."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    feats = {}
    for k, v in sd.items():
        for pre in ("module.", "vgg.", ""):
            if k.startswith(pre + "features."):
                feats[k[len(pre):]] = v
                break
    if not feats:
        raise ValueError(f"{path}: no 'features.N.*' entries, not a VGG19 trunk")
    net = VGG19Features()
    net.load_state_dict(feats, strict=True)
    return net.eval().requires_grad_(False).to(device)


class VGG19Classifier(nn.Module):
    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.features = _features()
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, num_classes),
        )

    def forward(self, x):
        """x (B, H, W, 3) NHWC -> logits (B, num_classes)."""
        x = _trunk(self.features, x)
        pooled = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (7, 7))
        flat = torch.flatten(pooled, 1)  # torch's (C, H, W) flatten order
        fc0, fc3, fc6 = self.classifier[0], self.classifier[3], self.classifier[6]
        h = F.relu(fc0(flat))
        h = F.relu(fc3(h))
        return fc6(h)
