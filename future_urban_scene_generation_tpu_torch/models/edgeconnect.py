"""EdgeConnect's two generators (inference), NHWC, under the reference's state-dict
names.

Counterpart of the JAX package's models/edgeconnect.py (:41-177; the reference's
edgeconnect/networks.py:37-203 and models.py:130-135, 236-240):

* ``EdgeGenerator``: (masked gray, masked edges, mask) -> 1-channel edge map,
  8 dilation-2 residual blocks without bias, sigmoid. The reference trains it with
  spectral norm on every conv; its checkpoint is folded to plain weights at load
  (``convert.fold_spectral_norm``), as torch's eval-mode weight;
* ``InpaintGenerator``: (masked RGB, edges) -> RGB, blocks with bias, (tanh + 1) / 2;
* ``edge_model_forward`` / ``inpaint_model_forward``: the input masking of the two
  models (mask 1 = hole).

Modules keep torch's parameter layouts and the reference's keys (``encoder.1.weight``,
``middle.0.conv_block.1.weight``, ``decoder.0.weight``, ...), so the reference's
``EdgeModel_gen.pth`` / ``InpaintingModel_gen.pth`` load with ``strict=True``.
Instance norm is the port's two-pass ``layers.instance_norm``. No conv of these
networks passes ``layers.small_cin_gate`` (the first conv has k * C_in = 21 or 28, the
last C_in = 64), as none reaches a Pallas kernel in the JAX package. The
discriminator and the losses belong to the EdgeConnect trainers (not ported).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from future_urban_scene_generation_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
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

    def __init__(self, dim: int = 256, dilation: int = 2, bias: bool = True):
        super().__init__()
        self.dilation = dilation
        self.conv_block = nn.ModuleDict({
            "1": Conv2d(dim, dim, 3, dilation=dilation, bias=bias),
            "5": Conv2d(dim, dim, 3, bias=bias),
        })

    def forward(self, x):
        out = _relu_in(self.conv_block["1"](reflect_pad(x, self.dilation)))
        out = instance_norm(self.conv_block["5"](reflect_pad(out, 1)))
        return x + out


class _Generator(nn.Module):
    """The shared encoder / residual middle / decoder trunk (networks.py:37-135)."""

    def __init__(self, cin: int, cout: int, residual_blocks: int, block_bias: bool):
        super().__init__()
        self.encoder = nn.ModuleDict({
            "1": Conv2d(cin, 64, 7),
            "4": Conv2d(64, 128, 4, stride=2, padding=1),
            "7": Conv2d(128, 256, 4, stride=2, padding=1),
        })
        self.middle = nn.ModuleList(
            ECResnetBlock(256, 2, bias=block_bias) for _ in range(residual_blocks))
        self.decoder = nn.ModuleDict({
            "0": ConvTranspose2d(256, 128, 4, 2, 1),
            "3": ConvTranspose2d(128, 64, 4, 2, 1),
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
    """edgeconnect/networks.py:88-135: 3 channels in, the edge probability out."""

    def __init__(self, residual_blocks: int = RESIDUAL_BLOCKS):
        super().__init__(3, 1, residual_blocks, block_bias=False)

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
