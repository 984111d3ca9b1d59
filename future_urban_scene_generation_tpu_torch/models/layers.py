"""Torch-convention building blocks that run on NHWC tensors.

Counterpart of the subset of the JAX package's models/layers.py the scene networks
and the ICN trainer use: the plain conv (``TorchConv`` :612) and the
weight-normalized conv (``WNConv`` :831), both dispatching gated convs to kernel K3
as ``_dispatch_conv`` (:588) does, ``instance_norm`` (:865) with float32
statistics, ``avg_pool_torch`` (:943), the ICN's
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

from future_urban_scene_generation_tpu_torch.ops import cuda_conv


def small_cin_gate(cin: int, k: int, stride: int, dtype=torch.float32) -> bool:
    """Whether a conv goes to kernel K3: the JAX gate (layers.py:274-290, stride 1,
    no dilation, 1 < k <= 9, C_in <= 32, k * C_in >= 128) without its TPU-only
    clauses — bf16-only was the TPU's 16 MB scoped-VMEM budget, and the backend and
    Pallas switches name the TPU — so float32 and bfloat16, the dtypes K3 is built
    for, both reach K3; float64 (reference checks only) stays on ``F.conv2d``."""
    return (dtype in (torch.float32, torch.bfloat16) and stride == 1 and 1 < k <= 9
            and cin <= 32 and k * cin >= 128)


class _SmallCinConv(torch.autograd.Function):
    """A gated conv: forward by kernel K3 (``cuda_conv.conv_small_cin_v2``) on the
    zero-padded NHWC input, backward the plain conv's gradients for x and w, as
    the JAX package's ``_dispatch_conv`` custom VJP (layers.py:588-609) does."""

    @staticmethod
    def forward(ctx, x, weight, padding: int):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        if padding:
            x = F.pad(x, (0, 0, padding, padding, padding, padding))
        return cuda_conv.conv_small_cin_v2(x, weight.permute(2, 3, 1, 0))

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        p = ctx.padding
        grad_x, grad_w, _ = torch.ops.aten.convolution_backward(
            grad.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [1, 1],
            [p, p], [1, 1], False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        return (grad_x.permute(0, 2, 3, 1) if grad_x is not None else None), grad_w, None


def conv_nhwc(x, weight, bias, stride: int = 1, padding: int = 0):
    """torch Conv2d (zero padding, cross-correlation) on NHWC ``x`` with an OIHW
    ``weight``; the weight is cast to x's dtype, the bias added afterwards. A conv
    that passes :func:`small_cin_gate` runs through kernel K3."""
    weight = weight.to(x.dtype)
    if small_cin_gate(x.shape[-1], weight.shape[-1], stride, x.dtype):
        y = _SmallCinConv.apply(x, weight, padding)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding).permute(0, 2, 3, 1)
    return y + bias.to(y.dtype)


def reflect_pad(x, pad: int):
    """torch ReflectionPad2d(pad) on NHWC, as an index gather (layout kept)."""
    if pad == 0:
        return x

    def idx(n):
        i = torch.arange(-pad, n + pad, device=x.device).abs()
        return torch.where(i >= n, 2 * (n - 1) - i, i)

    return x[:, idx(x.shape[1])][:, :, idx(x.shape[2])]


def activation(name):
    return {
        "none": lambda x: x,
        "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.2),
        "tanh": torch.tanh,
    }[name]


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
    variance, no affine. Statistics in float32 (float64 for float64 inputs),
    normalization in x's dtype.

    The variance is two-pass, E[(x - mean)^2]. The JAX package's single-pass
    E[x^2] - mean^2 (layers.py:868-874, one fused reduce on the TPU) cancels when a
    channel's mean is large against its spread, and its backward carries that
    cancellation into the gradients: float32 ICN generator gradients then stray
    from float64 by up to ~1% of max|g| (tests/test_torch_training.py)."""
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x32 - mean).mean(dim=(1, 2), keepdim=True)
    scale = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


class WarpLearnLayerNorm(nn.Module):
    """The ICN's LayerNorm (warp_learn/models.py:15-35): per-sample statistics over
    all of (H, W, C), unbiased std, divides by (std + eps), per-channel affine.
    Statistics in float32 (float64 for float64 inputs)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(num_features).uniform_())
        self.beta = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        n = x[0].numel()
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
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


def avg_pool_torch(x, window: int = 3, stride: int = 2, padding: int = 1):
    """torch AvgPool2d(window, stride, padding, count_include_pad=False) on NHWC
    (the multi-scale discriminator's downsampler).

    The pool runs on an NCHW-contiguous copy: on a channels_last input (the NHWC
    view), the CUDA backward of ``F.avg_pool2d`` returns a wrong input gradient —
    84-110% of max|g| off a float64 reference on an H100 with torch 2.11, for any
    channel count and upstream-gradient layout — while NCHW inputs are exact to
    float32 rounding. chip_smoke.py's train phase checks this backward."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), window, stride, padding,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


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
