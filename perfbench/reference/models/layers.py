"""Frozen copy of ``future_urban_scene_generation_tpu_torch/models/layers.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).
Departures from the source: every conv is ``F.conv2d`` / ``F.conv_transpose2d`` (no
kernel K3, no int8 tier and none of its scopes).

Torch-convention building blocks that run on NHWC tensors.

Counterpart of the subset of the JAX package's models/layers.py the scene networks
and the trainers use: the plain conv (``TorchConv`` :612) and the
weight-normalized conv (``WNConv`` :831), the training-mode spectral-norm conv and
transposed conv (``SNConv`` :714, ``SNConvTranspose`` :771), ``instance_norm`` (:865) with float32
statistics, ``avg_pool_torch`` (:943), the ICN's
``WarpLearnLayerNorm`` (:879), TF-ordered ``depth_to_space`` (:968) and the ICN's
up-stage conv (:func:`upconv2x_nearest_reflect`: the plain nearest-2x upsample +
reflect-padded 5x5 conv of ``upconv2x_nearest_reflect_reference`` (:1009) in float).

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


def conv_nhwc(x, weight, bias, stride: int = 1, padding: int = 0, dilation: int = 1):
    """torch Conv2d (zero padding, cross-correlation) on NHWC ``x`` with an OIHW
    ``weight``; the weight is cast to x's dtype, the bias (None: none) added
    afterwards."""
    weight = weight.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding,
                 dilation).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv_transpose_nhwc(x, weight, bias, stride: int = 2, padding: int = 1):
    """torch ConvTranspose2d on NHWC ``x`` with an (in, out, kh, kw) ``weight``."""
    weight = weight.to(x.dtype)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, None, stride,
                           padding).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def _reflect_index(n: int, pad: int, device):
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def reflect_pad(x, pad: int):
    """torch ReflectionPad2d(pad) on NHWC, as an index gather (layout kept)."""
    if pad == 0:
        return x
    return x[:, _reflect_index(x.shape[1], pad, x.device)][
        :, :, _reflect_index(x.shape[2], pad, x.device)]


def reflect_pad_axis(x, dim: int, pad: int):
    """ReflectionPad by ``pad`` along one axis of ``x`` (an index gather)."""
    return x[(slice(None),) * dim + (_reflect_index(x.shape[dim], pad, x.device),)]


def activation(name):
    return {
        "none": lambda x: x,
        "relu": F.relu,
        "lrelu": lambda x: F.leaky_relu(x, 0.2),
        "tanh": torch.tanh,
    }[name]


class Conv2d(nn.Module):
    """torch nn.Conv2d parameters (``weight`` OIHW, ``bias`` unless ``bias=False``)
    with an NHWC forward."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return conv_nhwc(x, self.weight, self.bias, self.stride, self.padding, self.dilation)


class ConvTranspose2d(nn.Module):
    """torch nn.ConvTranspose2d parameters (``weight`` (in, out, kh, kw), ``bias``)
    with an NHWC forward."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv_transpose_nhwc(x, self.weight, self.bias, self.stride, self.padding)


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


def l2_normalize(v, eps: float = 1e-12):
    """v / (||v|| + eps), the JAX package's ``_l2_normalize`` (layers.py:827); not
    ``F.normalize``, which divides by max(||v||, eps)."""
    return v / (torch.linalg.vector_norm(v) + eps)


class _SpectralNorm(nn.Module):
    """torch's ``spectral_norm`` state under its names (parameters ``weight_orig``
    and ``bias``, buffers ``weight_u`` and ``weight_v``), with the JAX package's
    schedule: the power iteration advances once per training step, when the trainer
    calls :meth:`advance_`, and not at every forward as torch's does.

    In training mode a forward takes one power iteration from the stored u without
    writing it back, v = n(W^T u), u' = n(W v), and uses W / sigma with sigma =
    u' . (W v), the gradient flowing through W only (SNConv, layers.py:714-769). In
    eval mode it uses the stored u and v, which is torch's eval-mode weight and what
    ``convert.fold_spectral_norm`` computes from the state dict. ``dim`` is the
    normalized axis of ``weight_orig``: 0 for a conv, 1 for a transposed conv.
    ``layers.seeded_init_`` draws W, u and v."""

    dim: int

    def _init_sn(self, shape, bias: bool):
        self.bias = nn.Parameter(torch.zeros(shape[self.dim])) if bias else None
        self.weight_orig = nn.Parameter(torch.empty(shape))
        rows = shape[self.dim]
        self.register_buffer("weight_u", torch.zeros(rows))
        self.register_buffer("weight_v", torch.zeros(math.prod(shape) // rows))

    def _w_mat(self, w):
        return w.movedim(self.dim, 0).reshape(w.shape[self.dim], -1)

    def _power_iteration(self):
        with torch.no_grad():
            w_mat = self._w_mat(self.weight_orig)
            v = l2_normalize(w_mat.T @ self.weight_u)
            return l2_normalize(w_mat @ v), v

    def effective_weight(self):
        if self.training:
            u, v = self._power_iteration()
        else:
            u, v = self.weight_u, self.weight_v
        sigma = torch.dot(u, self._w_mat(self.weight_orig) @ v)
        return self.weight_orig / sigma

    @torch.no_grad()
    def advance_(self) -> None:
        """One power iteration from the stored u with the current W, written back."""
        u, v = self._power_iteration()
        self.weight_u.copy_(u)
        self.weight_v.copy_(v)


class SNConv2d(_SpectralNorm):
    """Spectral-normalized torch Conv2d (OIHW ``weight_orig``) with an NHWC forward."""

    dim = 0

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 dilation: int = 1, bias: bool = True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self._init_sn((cout, cin, k, k), bias)

    def forward(self, x):
        return conv_nhwc(x, self.effective_weight(), self.bias, self.stride,
                         self.padding, self.dilation)


class SNConvTranspose2d(_SpectralNorm):
    """Spectral-normalized torch ConvTranspose2d (``weight_orig`` (in, out, kh, kw),
    normalized along dim 1 as torch's spectral_norm does) with an NHWC forward."""

    dim = 1

    def __init__(self, cin: int, cout: int, k: int, stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self._init_sn((cin, cout, k, k), True)

    def forward(self, x):
        return conv_transpose_nhwc(x, self.effective_weight(), self.bias, self.stride,
                                   self.padding)


def advance_spectral_norm_(module: nn.Module) -> None:
    """Advance every spectral-norm layer of ``module`` by one power iteration."""
    for m in module.modules():
        if isinstance(m, _SpectralNorm):
            m.advance_()


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
        return self.affine(self.normalize(x), self.gamma, self.beta)

    def normalize(self, x):
        n = x[0].numel()
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x32.mean(dim=(1, 2, 3), keepdim=True)
        m2 = (x32 * x32).mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(m2 - mean * mean, min=0.0) * (n / max(n - 1, 1))
        scale = 1.0 / (torch.sqrt(var) + self.eps)
        return (x - mean.to(x.dtype)) * scale.to(x.dtype)

    @staticmethod
    def affine(xn, gamma, beta):
        return xn * gamma.to(xn.dtype) + beta.to(xn.dtype)


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


def upconv2x_nearest_reflect(x, weight, bias):
    """An ICN up stage's conv on its source ``x`` (N, h, w, C): nearest-2x upsample ->
    reflect-pad(2) -> 5x5 conv (OIHW ``weight``) + ``bias``, the plain composition."""
    return conv_nhwc(reflect_pad(upsample2x_nearest(x), 2), weight, bias)


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
    statistics, spectral-norm u and v random unit vectors (torch's init). Parameters
    are drawn on the CPU, in ``named_parameters`` order, then the buffers."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("weight", "weight_v", "weight_orig") and p.dim() >= 2:
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
        elif name.endswith(("weight_u", "weight_v")):
            b.copy_(l2_normalize(torch.randn(b.shape, generator=generator)))
    return module
