"""Frozen copy of ``future_urban_scene_generation_tpu_torch/models/icn.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

ICN — the Warp&Learn image completion network (``G_Resnet``), NHWC, and its
training discriminator.

Counterpart of the JAX package's models/icn.py ``GResnet`` (:191) with its
``from_stem`` entry (:201), ``DNLayersMulti`` (:218) and ``gan_loss`` (:261): the
scene computes the stem (enc_content.model.0: reflect-pad 3, 7x7 conv, instance
norm, ReLU) itself (in the port: kernel K2) and enters the network after it; the
trainer runs the full forward. Module names are the reference's
(warp_learn/models.py:38-208), so ``gnet_*.pth`` loads unchanged; the decoder's up
stages are the plain nearest-2x upsample + reflect-pad + 5x5 conv of the reference in
float.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from perfbench.reference.models.layers import (
    Conv2d,
    WarpLearnLayerNorm,
    activation,
    avg_pool_torch,
    instance_norm,
    reflect_pad,
    upconv2x_nearest_reflect,
    upsample2x_nearest,
)
from perfbench.reference.ops.resize import resize_nearest


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
        return self._post(self.conv(reflect_pad(x, self.padding)))

    def _post(self, x):
        if self.norm_type == "inst":
            x = instance_norm(x)
        elif self.norm_type == "ln":
            x = self.norm(x)
        return self.act(x)


class UpConv2dBlock(Conv2dBlock):
    """An up stage on its SOURCE x: nearest-2x upsample -> reflect-pad(2) -> 5x5 conv
    -> layer norm -> ReLU (the decoder's ``Upsample2x`` slot and this block), the conv
    by ``layers.upconv2x_nearest_reflect``, the plain float composition."""

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 5, 1, 2, "ln", "relu")

    def forward(self, x):
        return self._post(upconv2x_nearest_reflect(x, self.conv.weight, self.conv.bias))


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
    """The parameter-free nn.Upsample slot of the reference's decoder Sequential. The
    decoder skips it: the ``UpConv2dBlock`` after it takes the source and upsamples
    itself."""

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
            layers.append(UpConv2dBlock(dim, dim // 2))
            dim //= 2
        layers.append(Conv2dBlock(dim, output_dim, 7, 1, 3, "none", "tanh"))
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.model:
            if not isinstance(layer, Upsample2x):  # the next block upsamples its source
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


class InstanceNorm(nn.Module):
    """The affine-free instance norm slot of the discriminator's Sequential."""

    def forward(self, x):
        return instance_norm(x)


class Activation(nn.Module):
    """A parameter-free activation slot of the discriminator's Sequential."""

    def __init__(self, name: str):
        super().__init__()
        self.fn = activation(name)

    def forward(self, x):
        return self.fn(x)


class DNLayersMulti(nn.Module):
    """Multi-scale PatchGAN discriminator (warp_learn/models.py:211-259): ``num_d``
    towers, each on the input average-pooled once more than the last. Each tower is
    the reference's Sequential, so its convs sit at ``model_{i}.{0,2,5,8}`` (for
    ``n_layers`` 2) — the keys ``convert`` maps from the JAX names ``model_{i}_{seq}``.
    Returns the towers' patch logits, finest first."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 2, num_d: int = 2):
        super().__init__()
        self.num_d = num_d
        for i in range(num_d):
            self.add_module(f"model_{i}", self._tower(input_nc, int(round(ndf / 2 ** i)),
                                                      n_layers))

    @staticmethod
    def _tower(input_nc, ndf, n_layers):
        layers = [Conv2d(input_nc, ndf, 4, 2, 1), Activation("lrelu")]
        nf = ndf
        for n in range(1, n_layers):
            nf_next = ndf * min(2 ** n, 8)
            layers += [Conv2d(nf, nf_next, 4, 2, 1), InstanceNorm(), Activation("lrelu")]
            nf = nf_next
        nf_next = ndf * min(2 ** n_layers, 8)
        layers += [Conv2d(nf, nf_next, 4, 1, 1), InstanceNorm(), Activation("lrelu"),
                   Conv2d(nf_next, 1, 4, 1, 1)]
        return nn.Sequential(*layers)

    def forward(self, x):
        results = []
        for i in range(self.num_d):
            results.append(getattr(self, f"model_{i}")(x))
            if i != self.num_d - 1:
                x = avg_pool_torch(x, 3, 2, 1)
        return results


def gan_loss(predictions, target_is_real: bool, smooth_noise=None, mask=None):
    """LSGAN MSE summed over the scales' predictions (warp_learn/models.py:262-320).
    ``smooth_noise`` is a label-smoothing offset added to the target; ``mask``
    (N, H, W, 1) is brought to each scale by nearest resampling."""
    total = 0.0
    for pred in predictions:
        target = torch.full_like(pred, 1.0 if target_is_real else 0.0)
        if smooth_noise is not None:
            target = target + smooth_noise
        if mask is not None:
            mask_down = resize_nearest(mask, (pred.shape[1], pred.shape[2]))
            pred = pred * mask_down
            target = target * mask_down
        total = total + torch.mean((pred - target) ** 2)
    return total
