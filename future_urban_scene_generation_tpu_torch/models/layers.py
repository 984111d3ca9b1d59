"""Torch-convention building blocks that run on NHWC tensors.

Counterpart of the subset of the JAX package's models/layers.py the four scene
networks use: the plain conv (``TorchConv`` :612), the weight-normalized conv
(``WNConv`` :831), ``instance_norm`` (:865) with float32 statistics, the ICN's
``WarpLearnLayerNorm`` (:879), TF-ordered ``depth_to_space`` (:968) and the nearest
2x upsample the ICN decoder composes with a reflect-padded 5x5 conv, as the plain
``upconv2x_nearest_reflect_reference`` (:1009) does.

Parameters keep torch's layouts and the reference's state-dict names; activations
stay NHWC. Around ``F.conv2d`` an NHWC tensor is viewed as NCHW by a permute, which
is PyTorch's channels_last memory format, so no copy is made. The bfloat16 rule of
the JAX package holds: parameters float32, conv inputs/outputs in the activation
dtype (bias added after the conv in that dtype), normalization statistics float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv_nhwc(x, weight, bias, stride: int = 1, padding: int = 0):
    """torch Conv2d (zero padding, cross-correlation) on NHWC ``x`` with an OIHW
    ``weight``; the weight is cast to x's dtype, the bias added afterwards."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), None, stride, padding)
    return y.permute(0, 2, 3, 1) + bias.to(y.dtype)


def reflect_pad(x, pad: int):
    """torch ReflectionPad2d(pad) on NHWC, as an index gather (layout kept)."""
    if pad == 0:
        return x

    def idx(n):
        i = torch.arange(-pad, n + pad, device=x.device).abs()
        return torch.where(i >= n, 2 * (n - 1) - i, i)

    return x[:, idx(x.shape[1])][:, :, idx(x.shape[2])]


def activation(name):
    return {"none": lambda x: x, "relu": F.relu, "tanh": torch.tanh}[name]


class Conv2d(nn.Module):
    """torch nn.Conv2d parameters (``weight`` OIHW, ``bias``) with an NHWC forward."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv_nhwc(x, self.weight, self.bias, self.stride, self.padding)


class WNConv2d(nn.Module):
    """Weight-normalized conv (torch ``weight_norm(conv, dim=0)``): w = g v / ||v||
    with the norm per output channel, computed in float32 (``weight_g`` (O,1,1,1),
    ``weight_v`` OIHW, ``bias``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def effective_weight(self):
        v = self.weight_v
        norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True) + 1e-24)
        return v / norm * self.weight_g

    def forward(self, x):
        return conv_nhwc(x, self.effective_weight(), self.bias, self.stride, self.padding)


def instance_norm(x, eps: float = 1e-5):
    """torch InstanceNorm2d defaults on NHWC: per-sample, per-channel, biased
    variance, no affine. Statistics in float32, normalization in x's dtype."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    m2 = (x32 * x32).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(m2 - mean * mean, min=0.0)
    scale = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


class WarpLearnLayerNorm(nn.Module):
    """The ICN's LayerNorm (warp_learn/models.py:15-35): per-sample statistics over
    all of (H, W, C), unbiased std, divides by (std + eps), per-channel affine."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(num_features).uniform_())
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        n = x[0].numel()
        x32 = x.to(torch.float32)
        mean = x32.mean(dim=(1, 2, 3), keepdim=True)
        m2 = (x32 * x32).mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(m2 - mean * mean, min=0.0) * (n / max(n - 1, 1))
        scale = 1.0 / (torch.sqrt(var) + self.eps)
        xn = (x - mean.to(x.dtype)) * scale.to(x.dtype)
        return xn * self.gamma.to(x.dtype) + self.beta.to(x.dtype)


def depth_to_space(x, block: int = 2):
    """VUNet's DepthToSpace on NHWC: TF channel groups (r1, r2, c)."""
    b, h, w, c = x.shape
    c_out = c // (block * block)
    x = x.reshape(b, h, w, block, block, c_out).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * block, w * block, c_out)


def space_to_depth(x, block: int = 2):
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def upsample2x_nearest(x):
    """torch nn.Upsample(scale_factor=2) (nearest) on NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def max_pool2(x):
    """torch MaxPool2d(2, 2) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Deterministic random init from an explicit generator, in the JAX package's
    scheme: conv/linear weights ~ N(0, 1/fan_in) (lecun normal), biases 0,
    weight-norm g = 1, ICN LayerNorm gamma ~ U(0, 1), batch norms at identity
    statistics. Parameters are drawn on the CPU, in ``named_parameters`` order."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("weight", "weight_v") and p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
        elif leaf == "gamma":
            p.copy_(torch.rand(p.shape, generator=generator))
        elif leaf in ("weight", "weight_g"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in module.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()
    return module
