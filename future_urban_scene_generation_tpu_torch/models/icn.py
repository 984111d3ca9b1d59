"""ICN — the Warp&Learn image completion network (``G_Resnet``), NHWC.

Counterpart of the JAX package's models/icn.py ``GResnet`` (:191) with its
``from_stem`` entry (:201): the scene computes the stem (enc_content.model.0:
reflect-pad 3, 7x7 conv, instance norm, ReLU) with kernel K2 and enters the network
after it. Module names are the reference's (warp_learn/models.py:38-208), so
``gnet_*.pth`` loads unchanged; the decoder's up stages are the plain nearest-2x
upsample + reflect-pad + 5x5 conv of the reference.
"""
from __future__ import annotations

import torch.nn as nn

from future_urban_scene_generation_tpu_torch.models.layers import (
    Conv2d,
    WarpLearnLayerNorm,
    activation,
    instance_norm,
    reflect_pad,
    upsample2x_nearest,
)


class Conv2dBlock(nn.Module):
    """reflect-pad -> conv(bias) -> norm -> activation (warp_learn/models.py:38-90;
    G_Resnet builds every block with reflect padding)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, norm="none", activ="relu"):
        super().__init__()
        self.padding = padding
        self.norm_type = norm
        self.act = activation(activ)
        self.conv = Conv2d(cin, cout, k, stride)
        if norm == "ln":
            self.norm = WarpLearnLayerNorm(cout)
        elif norm not in ("inst", "none"):
            raise ValueError(f"unsupported norm {norm}")

    def forward(self, x):
        x = self.conv(reflect_pad(x, self.padding))
        if self.norm_type == "inst":
            x = instance_norm(x)
        elif self.norm_type == "ln":
            x = self.norm(x)
        return self.act(x)


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.model = nn.ModuleList([
            Conv2dBlock(dim, dim, 3, 1, 1, "inst", "relu"),
            Conv2dBlock(dim, dim, 3, 1, 1, "inst", "none"),
        ])

    def forward(self, x):
        return self.model[1](self.model[0](x)) + x


class ResBlocks(nn.Module):
    def __init__(self, num_blocks, dim):
        super().__init__()
        self.model = nn.ModuleList(ResBlock(dim) for _ in range(num_blocks))

    def forward(self, x):
        for block in self.model:
            x = block(x)
        return x


class Upsample2x(nn.Module):
    """The parameter-free nn.Upsample slot of the reference's decoder Sequential."""

    def forward(self, x):
        return upsample2x_nearest(x)


class ContentEncoder(nn.Module):
    def __init__(self, input_nc, n_downsample=2, n_res=3, dim=64):
        super().__init__()
        layers = [Conv2dBlock(input_nc, dim, 7, 1, 3, "inst", "relu")]
        for _ in range(n_downsample):
            layers.append(Conv2dBlock(dim, 2 * dim, 4, 2, 1, "inst", "relu"))
            dim *= 2
        layers.append(ResBlocks(n_res, dim))
        self.model = nn.ModuleList(layers)

    def forward(self, x, from_stem: bool = False):
        for layer in self.model[1:] if from_stem else self.model:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, n_upsample=2, n_res=3, dim=256, output_dim=3):
        super().__init__()
        layers = [ResBlocks(n_res, dim)]
        for _ in range(n_upsample):
            layers.append(Upsample2x())
            layers.append(Conv2dBlock(dim, dim // 2, 5, 1, 2, "ln", "relu"))
            dim //= 2
        layers.append(Conv2dBlock(dim, output_dim, 7, 1, 3, "none", "tanh"))
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return x


class GResnet(nn.Module):
    """G_Resnet: 21-channel LAB input in [-1, 1] -> 3-channel tanh output."""

    def __init__(self, input_nc=21, output_nc=3, num_downs=2, n_res=3, ngf=64):
        super().__init__()
        self.enc_content = ContentEncoder(input_nc, num_downs, n_res, ngf)
        self.dec = Decoder(num_downs, n_res, ngf * 2 ** num_downs, output_nc)

    @property
    def stem(self) -> Conv2dBlock:
        """enc_content.model.0 — the block kernel K2 computes on the scene path."""
        return self.enc_content.model[0]

    def forward(self, x, from_stem: bool = False):
        """``from_stem=True``: x is the stem's activation (after its conv, instance
        norm and ReLU); the network continues from enc_content.model.1."""
        return self.dec(self.enc_content(x, from_stem=from_stem))
