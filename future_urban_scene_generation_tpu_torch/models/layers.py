"""Torch-convention building blocks that run on NHWC tensors.

Counterpart of the subset of the JAX package's models/layers.py the scene networks
and the trainers use: the plain conv (``TorchConv`` :612) and the
weight-normalized conv (``WNConv`` :831), both dispatching gated convs to kernel K3
as ``_dispatch_conv`` (:588) does, the training-mode spectral-norm conv and
transposed conv (``SNConv`` :714, ``SNConvTranspose`` :771), ``instance_norm`` (:865) with float32
statistics, ``avg_pool_torch`` (:943), the ICN's
``WarpLearnLayerNorm`` (:879), TF-ordered ``depth_to_space`` (:968) and the nearest
2x upsample the ICN decoder composes with a reflect-padded 5x5 conv, as the plain
``upconv2x_nearest_reflect_reference`` (:1009) does.

The int8 serving tier (``ModelSpec.quantized_convs``, JAX layers.py:140-303): inside
an enabled :func:`quantized_convs` scope (:func:`suppress_quantization` is the disabled
one), a conv that is :func:`int8_eligible` (float32 or bfloat16, C_in >= 32, C_out >= 32) and
not taken by K3's gate first quantizes its input and weight (:func:`quantize_int8`, op
for op the JAX ``_int8_conv``) and runs on kernel N2; the transposed conv likewise.
Where each conv of the port goes with the tier on, beside its JAX counterpart:

* ``vgg.VGG19Classifier`` / ``VGG19Features`` (JAX vgg.py:67 ``TorchConv``): int8 but
  the first conv (C_in 3).
* ``hourglass`` (JAX hourglass.py:39-125): int8 for the bottlenecks' convs, the
  downsample and ``fc`` / ``fc_``; float for the 7x7 stem (C_in 3), ``score`` (C_out
  12) and ``score_`` (C_in 12).
* ``icn.GResnet`` (JAX icn.py:45, layers.py:1063): the stem stays kernel K2 in the
  scene (K3 in the trainer's full forward; the JAX stem, C_in 21, stays float); the
  down convs and the 12 residual convs int8; each up stage int8 on its 5x5 conv at
  every pixel of the upsampled, reflect-padded input, where the JAX package quantizes
  the phase-packed 3x3 rewrite (4 O output channels with their own scales, borders in
  float) that the port does not carry: there the two tiers differ in rounding, not
  in function (held at a PSNR). An up stage takes the tier by the JAX gate on that
  packed kernel (:func:`upconv5_int8_eligible`: C_in >= 32, 4 C_out >= 32, source at
  least 4x4), else stays float; the 64 -> 3 head float. ``DNLayersMulti`` (JAX
  icn.py:235-247): int8 but the first (C_in 3) and the last (C_out 1) conv.
* ``vunet`` (``WNConv2d``; JAX ``WNConv`` :857): int8-eligible, but the stages run both
  VUNet forwards under :func:`suppress_quantization` (JAX stages.py:653-657,
  674-678): float.
* ``edgeconnect`` served generators (``Conv2d`` / ``ConvTranspose2d``; JAX
  edgeconnect.py:53, 80, 143): int8 for ``encoder.4``, ``encoder.7``, the residual
  blocks and the transposed ``decoder.0`` / ``decoder.3``; float for ``encoder.1``
  (C_in 3 or 4) and ``decoder.7`` (C_out 1 or 3). ``SNConv2d`` / ``SNConvTranspose2d``
  (the trained networks and ``ECDiscriminator``; JAX ``SNConv`` :756,
  ``SNConvTranspose`` :814, which call the float conv): float, under
  :func:`suppress_quantization`.
* ``maskrcnn`` (JAX maskrcnn.py:57-211): int8 for the ResNet-50 bottlenecks and
  downsamples, the FPN's inner and layer blocks, the RPN's 3x3 conv, the mask head's
  convs, its transposed ``conv5_mask`` and ``mask_fcn_logits``; float for the 7x7 stem
  (C_in 3) and the RPN's ``cls_logits`` / ``bbox_pred`` (C_out 3, 12).
* The JAX width-folded convs (``_conv_on_folded``) are a TPU layout the port does not
  carry. K3's gate comes first, as the JAX Pallas gate: a conv with C_in = 32 and
  k >= 4 takes K3 here where the JAX package on the CPU quantizes it; no stock
  network has one.

Parameters keep torch's layouts and the reference's state-dict names; activations
stay NHWC. Around ``F.conv2d`` an NHWC tensor is viewed as NCHW by a permute, which
is PyTorch's channels_last memory format, so no copy is made. The bfloat16 rule of
the JAX package holds: parameters float32, conv inputs/outputs in the activation
dtype (bias added after the conv in that dtype), normalization statistics float32.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

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


# The int8 tier's scope state. Thread-local, as the JAX package's _TRACE_SCOPES
# (layers.py:140-145): two MultiStreamRunner workers serving specs that differ must
# not see each other's tier or suppression.
_SCOPES = threading.local()


@contextmanager
def quantized_convs(enabled: bool = True):
    """Run the convs of this thread's forwards inside the block on the int8 tier when
    ``enabled`` (``ModelSpec.quantized_convs``): the stages open this scope around
    each forward they run with their spec. Nested scopes restore the outer one."""
    outer = getattr(_SCOPES, "quantize", False)
    _SCOPES.quantize = bool(enabled)
    try:
        yield
    finally:
        _SCOPES.quantize = outer


def suppress_quantization():
    """Keep this thread's convs on the float path inside the block whatever the tier
    (JAX layers.py:149-166): in the port's scopes that is ``quantized_convs(False)``.
    VUNet's weight-normed stack has no renormalization after its convs, so per-conv
    int8 rounding compounds (the JAX package measured 20.1 dB against float32); the
    stages wrap both VUNet forwards in this scope. The spectral-norm layers take it
    too: the JAX ``SNConv`` / ``SNConvTranspose`` call the float conv directly."""
    return quantized_convs(False)


def quantization_active() -> bool:
    """Whether this thread is inside an enabled int8 scope."""
    return getattr(_SCOPES, "quantize", False)


def int8_eligible(x, cout: int) -> bool:
    """The JAX ``_int8_eligible`` (layers.py:245-253): the tier is on and not
    suppressed, a float32 or bfloat16 input, C_in >= 32 and C_out >= 32."""
    return (quantization_active() and x.dtype in (torch.float32, torch.bfloat16)
            and x.shape[-1] >= 32 and cout >= 32)


def upconv5_int8_eligible(u, cout: int) -> bool:
    """The int8 gate of an ICN up stage's 5x5 conv, ``u`` the nearest-2x upsampled
    field (2h, 2w): the JAX package quantizes the stage's phase-packed (3, 3, C_in,
    4 C_out) kernel at source resolution (layers.py:1048-1063), so its
    ``_int8_eligible`` reads C_in >= 32 and 4 C_out >= 32, K3's gate is never asked,
    and a source under 4x4 takes the float reference composition."""
    return (quantization_active() and u.dtype in (torch.float32, torch.bfloat16)
            and u.shape[-1] >= 32 and 4 * cout >= 32 and u.shape[1] >= 8
            and u.shape[2] >= 8)


def quantize_int8(x, w_hwio):
    """The JAX ``_int8_conv``'s quantization (layers.py:195-205), op for op: a
    per-input-channel activation scale sx = max(max|x| over N, H, W, 1e-12) / 127,
    folded into the weight (w_eff = w * sx), a per-output-channel weight scale sw from
    w_eff the same way, and codes round(x / sx), round(w_eff / sw) (half to even,
    divisions, not reciprocals) clamped to +-127. ``w_hwio`` is already in x's dtype;
    both go to float32 first. Returns (x codes, w codes, sw)."""
    sx = torch.clamp(x.abs().amax(dim=(0, 1, 2)).to(torch.float32), min=1e-12) * (1.0 / 127.0)
    w_eff = w_hwio.to(torch.float32) * sx[None, None, :, None]
    sw = torch.clamp(w_eff.abs().amax(dim=(0, 1, 2)), min=1e-12) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w_eff / sw), -127, 127).to(torch.int8)
    return xq, wq, sw


class _Int8Conv(torch.autograd.Function):
    """A conv on the int8 tier: forward by kernel N2 (``cuda_conv.conv_int8``) on the
    codes of :func:`quantize_int8`, output ``float32(acc) * sw`` in x's dtype;
    backward the float conv's gradients, as the JAX ``_dispatch_conv`` custom VJP
    (layers.py:603-607). ``transposed``: ``weight`` is a ConvTranspose2d's (in, out,
    kh, kw), run as the JAX ``_int8_conv_transpose`` (:218-242) does: the kernel
    flipped, the input dilated by the stride, padding k-1-p on both sides."""

    @staticmethod
    def forward(ctx, x, weight, stride: int, padding: int, dilation: int, transposed: bool):
        ctx.save_for_backward(x, weight)
        ctx.geom = (stride, padding, dilation, transposed)
        k = weight.shape[-1]
        if transposed:
            xq, wq, sw = quantize_int8(x, weight.permute(2, 3, 0, 1).flip(0, 1))
            lo = k - 1 - padding
            return cuda_conv.conv_int8(xq, wq, sw, x.dtype, pad_lo=lo, pad_hi=lo,
                                       in_dilation=stride)
        xq, wq, sw = quantize_int8(x, weight.permute(2, 3, 1, 0))
        return cuda_conv.conv_int8(xq, wq, sw, x.dtype, stride=stride, pad_lo=padding,
                                   pad_hi=padding, dilation=dilation)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        stride, p, dil, transposed = ctx.geom
        grad_x, grad_w, _ = torch.ops.aten.convolution_backward(
            grad.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None, [stride] * 2,
            [p, p], [dil, dil], transposed, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        grad_x = grad_x.permute(0, 2, 3, 1) if grad_x is not None else None
        return grad_x, grad_w, None, None, None, None


def conv_nhwc(x, weight, bias, stride: int = 1, padding: int = 0, dilation: int = 1):
    """torch Conv2d (zero padding, cross-correlation) on NHWC ``x`` with an OIHW
    ``weight``; the weight is cast to x's dtype, the bias (None: none) added
    afterwards. The dispatch of the JAX ``_dispatch_conv_impl`` (layers.py:257-303):
    a conv that passes :func:`small_cin_gate` runs through kernel K3, else one that
    is :func:`int8_eligible` through the int8 tier (kernel N2), else ``F.conv2d``."""
    weight = weight.to(x.dtype)
    if dilation == 1 and small_cin_gate(x.shape[-1], weight.shape[-1], stride, x.dtype):
        y = _SmallCinConv.apply(x, weight, padding)
    elif int8_eligible(x, weight.shape[0]):
        return conv_nhwc_int8(x, weight, bias, stride, padding, dilation)
    else:
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding,
                     dilation).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


def conv_nhwc_int8(x, weight, bias, stride: int = 1, padding: int = 0, dilation: int = 1):
    """:func:`conv_nhwc` on the int8 tier whatever the gates: the route of a conv the
    caller has found eligible."""
    y = _Int8Conv.apply(x, weight.to(x.dtype), stride, padding, dilation, False)
    return y if bias is None else y + bias.to(y.dtype)


def conv_transpose_nhwc(x, weight, bias, stride: int = 2, padding: int = 1):
    """torch ConvTranspose2d on NHWC ``x`` with an (in, out, kh, kw) ``weight``; on the
    int8 tier where :func:`int8_eligible`, as the JAX ``TorchConvTranspose``
    (layers.py:697-698)."""
    weight = weight.to(x.dtype)
    if int8_eligible(x, weight.shape[1]):
        y = _Int8Conv.apply(x, weight, stride, padding, 1, True)
    else:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, None, stride,
                               padding).permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


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
        with suppress_quantization():  # the JAX SNConv calls the float conv (:756)
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
        with suppress_quantization():  # the JAX SNConvTranspose calls the float conv (:814)
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
