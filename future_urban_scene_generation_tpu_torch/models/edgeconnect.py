"""EdgeConnect's networks and losses, NHWC, under the reference's state-dict names.

Counterpart of the JAX package's models/edgeconnect.py (:41-221; the reference's
edgeconnect/networks.py:37-203, models.py:130-135, 236-240 and loss.py:6-99):

* ``EdgeGenerator``: (masked gray, masked edges, mask) -> 1-channel edge map,
  8 dilation-2 residual blocks without bias, sigmoid. The reference trains it with
  spectral norm on every conv but the last (``spectral=True``: the
  ``layers.SNConv2d`` triples, the 70 keys of its ``EdgeModel_gen.pth``); served, its
  checkpoint is folded to plain weights at load (``convert.fold_spectral_norm``), as
  torch's eval-mode weight. The JAX package's spectral generator also normalizes
  the last conv (``decoder_7``), which the reference does not;
* ``InpaintGenerator``: (masked RGB, edges) -> RGB, blocks with bias, (tanh + 1) / 2;
* ``edge_model_forward`` / ``inpaint_model_forward``: the input masking of the two
  models (mask 1 = hole);
* ``ECDiscriminator``: the spectral-normed PatchGAN of both trainers with its five
  feature taps; ``adversarial_loss`` (nsgan, lsgan, hinge), ``gram_matrix``,
  ``style_loss`` and ``perceptual_loss`` over the VGG19 taps of ``models/vgg.py``.

Modules keep torch's parameter layouts and the reference's keys (``encoder.1.weight``,
``middle.0.conv_block.1.weight``, ``decoder.0.weight``, ...), so the reference's
``EdgeModel_gen.pth`` / ``InpaintingModel_gen.pth`` load with ``strict=True``.
Instance norm is the port's two-pass ``layers.instance_norm``. No conv of these
networks passes ``layers.small_cin_gate`` (the first conv has k * C_in = 21 or 28, the
last C_in = 64), nor does a discriminator conv (stride 2, or C_in >= 128 at
stride 1), as none reaches a Pallas kernel in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    SNConv2d,
    SNConvTranspose2d,
    instance_norm,
    reflect_pad,
    seeded_init_,
)

RESIDUAL_BLOCKS = 8


def _relu_in(x):
    return torch.relu(instance_norm(x))


class ECResnetBlock(nn.Module):
    """Dilated residual block (edgeconnect/networks.py:184-203): reflect pad 2,
    3x3 dilation-2 conv, IN, ReLU, reflect pad 1, 3x3 conv, IN, plus the input."""

    def __init__(self, dim: int = 256, dilation: int = 2, bias: bool = True,
                 spectral: bool = False):
        super().__init__()
        self.dilation = dilation
        conv = SNConv2d if spectral else Conv2d
        self.conv_block = nn.ModuleDict({
            "1": conv(dim, dim, 3, dilation=dilation, bias=bias),
            "5": conv(dim, dim, 3, bias=bias),
        })

    def forward(self, x):
        out = _relu_in(self.conv_block["1"](reflect_pad(x, self.dilation)))
        out = instance_norm(self.conv_block["5"](reflect_pad(out, 1)))
        return x + out


class _Generator(nn.Module):
    """The shared encoder / residual middle / decoder trunk (networks.py:37-135).
    ``spectral``: spectral norm on every conv but the last, as the reference's edge
    generator (networks.py:213-217)."""

    def __init__(self, cin: int, cout: int, residual_blocks: int, block_bias: bool,
                 spectral: bool = False):
        super().__init__()
        conv = SNConv2d if spectral else Conv2d
        convt = SNConvTranspose2d if spectral else ConvTranspose2d
        self.encoder = nn.ModuleDict({
            "1": conv(cin, 64, 7),
            "4": conv(64, 128, 4, stride=2, padding=1),
            "7": conv(128, 256, 4, stride=2, padding=1),
        })
        self.middle = nn.ModuleList(
            ECResnetBlock(256, 2, bias=block_bias, spectral=spectral)
            for _ in range(residual_blocks))
        self.decoder = nn.ModuleDict({
            "0": convt(256, 128, 4, 2, 1),
            "3": convt(128, 64, 4, 2, 1),
            "7": Conv2d(64, cout, 7),
        })

    def trunk(self, x):
        x = _relu_in(self.encoder["1"](reflect_pad(x, 3)))
        x = _relu_in(self.encoder["4"](x))
        x = _relu_in(self.encoder["7"](x))
        for block in self.middle:
            x = block(x)
        x = _relu_in(self.decoder["0"](x))
        x = _relu_in(self.decoder["3"](x))
        return self.decoder["7"](reflect_pad(x, 3))


class EdgeGenerator(_Generator):
    """edgeconnect/networks.py:88-135: 3 channels in, the edge probability out.
    ``spectral=True`` is the trained network (``layers.SNConv2d`` state)."""

    def __init__(self, residual_blocks: int = RESIDUAL_BLOCKS, spectral: bool = False):
        super().__init__(3, 1, residual_blocks, block_bias=False, spectral=spectral)

    def forward(self, x):
        return torch.sigmoid(self.trunk(x))


class InpaintGenerator(_Generator):
    """edgeconnect/networks.py:37-85: 4 channels in, RGB in [0, 1] out."""

    def __init__(self, residual_blocks: int = RESIDUAL_BLOCKS):
        super().__init__(4, 3, residual_blocks, block_bias=True)

    def forward(self, x):
        return (torch.tanh(self.trunk(x)) + 1.0) / 2.0


def build_generators(generator: torch.Generator = None, *, device,
                     residual_blocks: int = RESIDUAL_BLOCKS):
    """(EdgeGenerator, InpaintGenerator) in eval mode on ``device``, drawn from
    ``generator`` on the host (``layers.seeded_init_``) when one is given, else left
    for a weight load to fill."""
    nets = (EdgeGenerator(residual_blocks), InpaintGenerator(residual_blocks))
    for net in nets:
        net.eval().requires_grad_(False)
        if generator is not None:
            seeded_init_(net, generator)
    return tuple(net.to(device) for net in nets)


def edge_model_forward(generator: EdgeGenerator, images_gray, edges, masks):
    """EdgeModel.forward (edgeconnect/models.py:130-135), NHWC in [0, 1], mask 1 =
    hole: the inputs masked (the gray image painted white in the hole), then the
    generator."""
    edges_masked = edges * (1.0 - masks)
    images_masked = images_gray * (1.0 - masks) + masks
    return generator(torch.cat([images_masked, edges_masked, masks], dim=-1))


def inpaint_model_forward(generator: InpaintGenerator, images, edges, masks):
    """InpaintingModel.forward (edgeconnect/models.py:236-240)."""
    images_masked = images * (1.0 - masks) + masks
    return generator(torch.cat([images_masked, edges], dim=-1))


class ECDiscriminator(nn.Module):
    """The PatchGAN with feature taps (edgeconnect/networks.py:138-181): four 4x4
    convs (stride 2, 2, 2, 1) with leaky ReLU 0.2, a 4x4 conv to one channel, an
    optional sigmoid. Returns (output, [the five taps]). Keys ``conv{1..5}.0.*``;
    with ``spectral`` the convs are ``layers.SNConv2d`` without bias, as the
    reference's (bias = not use_spectral_norm)."""

    def __init__(self, in_channels: int, use_sigmoid: bool = True, spectral: bool = True):
        super().__init__()
        self.use_sigmoid = use_sigmoid
        conv = SNConv2d if spectral else Conv2d
        chans = ((in_channels, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 1), (512, 1, 1))
        for i, (cin, cout, stride) in enumerate(chans, 1):
            self.add_module(f"conv{i}", nn.ModuleList(
                [conv(cin, cout, 4, stride=stride, padding=1, bias=not spectral)]))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        feats = []
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")[0](x)
            if i < 5:
                x = F.leaky_relu(x, 0.2)
            feats.append(x)
        return (torch.sigmoid(x) if self.use_sigmoid else x), feats


# ---------------------------------------------------------------------------
# Losses (edgeconnect/loss.py; JAX edgeconnect.py:180-221)
# ---------------------------------------------------------------------------


def adversarial_loss(outputs, is_real: bool, is_disc: bool = False, kind: str = "nsgan"):
    """edgeconnect/loss.py:6-42: nsgan = BCE on sigmoid outputs (clipped to
    [1e-12, 1 - 1e-12]), lsgan = MSE to the label, hinge = ReLU margins for the
    discriminator and -mean for the generator."""
    if kind == "hinge":
        if is_disc:
            return torch.mean(torch.relu(1.0 + (-outputs if is_real else outputs)))
        return torch.mean(-outputs)
    label = 1.0 if is_real else 0.0
    if kind == "nsgan":
        o = torch.clamp(outputs, 1e-12, 1.0 - 1e-12)
        return -torch.mean(label * torch.log(o) + (1.0 - label) * torch.log(1.0 - o))
    if kind == "lsgan":
        return torch.mean((outputs - label) ** 2)
    raise ValueError(kind)


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """Gram of NHWC features: (B, C, C) / (H * W * C) (edgeconnect/loss.py:55-61)."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    return f.transpose(1, 2) @ f / (h * w * c)


STYLE_TAPS = ("relu2_2", "relu3_4", "relu4_4", "relu5_2")
PERCEPTUAL_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")


def style_loss(feats_x: Dict[str, torch.Tensor], feats_y: Dict[str, torch.Tensor]):
    """L1 between Gram matrices over the reference's four taps (loss.py:63-74)."""
    return sum(torch.mean(torch.abs(gram_matrix(feats_x[t]) - gram_matrix(feats_y[t])))
               for t in STYLE_TAPS)


def perceptual_loss(feats_x, feats_y, weights=(1.0, 1.0, 1.0, 1.0, 1.0)):
    """L1 over the five relu*_1 taps (loss.py:88-99)."""
    return sum(w * torch.mean(torch.abs(feats_x[t] - feats_y[t]))
               for w, t in zip(weights, PERCEPTUAL_TAPS))
