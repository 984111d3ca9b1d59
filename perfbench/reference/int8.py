"""The int8 serving tier written plainly, for the benchmark's int8 cell: what
``ModelSpec.quantized_convs`` asks of a scene's networks, applied to the frozen
reference's networks (``apply``). It imports neither JAX nor the JAX package nor the
port; it is written from the tier's definition, the JAX package's ``_int8_conv``,
``_int8_eligible`` and ``upconv2x_nearest_reflect`` (models/layers.py:195-253,
:1029-1095), and the routing the port's models/layers.py states.

A conv on the tier, x (N, H, W, C) with the HWIO weight w:

* sx = max(max |x| over N, H, W in float32, 1e-12) * (1 / 127), one scale an input
  channel, taken over the whole batch; w_eff = float32(w) * sx (folded into the
  weight); sw = max(max |w_eff| over the taps and C, 1e-12) * (1 / 127), one an
  output channel;
* codes round(x / sx) and round(w_eff / sw), half to even, by division, clamped to
  +-127;
* acc = the conv of the codes, exact (here in float64: |acc| <= 127^2 k^2 C < 2^53);
* the output float32(acc) * sw in x's dtype, the bias added after it.

Routing, in the order the port asks: K3's gate first (stride 1, no dilation,
1 < k <= 9, C_in <= 32, k C_in >= 128: float); then C_in >= 32 and C_out >= 32 on a
float32 or bfloat16 input: int8; else float. An ICN up stage (nearest-2x upsample,
reflect-pad 2, 5x5 conv) collapses its kernel into four phase kernels packed
(3, 3, C_in, 4 C_out) (rows summed first, then columns, in float32) and runs them as
one conv on the source reflect-padded by 1, int8 where C_in >= 32, 4 C_out >= 32 and
the source is at least 4x4; the output is that conv depth-to-space in (a, b, o)
order, its 2-pixel borders recomputed in float from the strips of the padded
upsampled field they read. ``apply`` gives this routing to the CAD classifier, the
hourglass and the ICN; the VUNet stays float, as the stages keep it.

``qmax`` 63 is the calibration's control: the same tier with 7-bit codes.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from perfbench.reference.models import icn as ricn
from perfbench.reference.models import layers

QMAX = 127  # int8 codes
BLOCK_ELEMENTS = 1 << 28  # float64 elements of one block of rows (input and output): 2 GiB


class Call(NamedTuple):
    """One conv on the tier: x (n, h, w, c) as handed to the quantizer, a k x k kernel
    to o channels at ``stride``, zero padding ``padding``, ``dilation``; ``net`` is the
    network it ran in."""
    net: str
    n: int
    h: int
    w: int
    c: int
    k: int
    o: int
    stride: int
    padding: int
    dilation: int

    @property
    def out_hw(self):
        def side(s):
            return (s + 2 * self.padding - self.dilation * (self.k - 1) - 1) // self.stride + 1
        return side(self.h), side(self.w)


class Tier:
    """The tier's settings for one set of networks, and the calls it made."""

    def __init__(self, qmax: int = QMAX):
        self.qmax = qmax
        self.calls: List[Call] = []


def quantize(x, w_hwio, qmax: int = QMAX):
    """(x codes, weight codes, sw): the codes as float64 integers in [-qmax, qmax]."""
    inv = 1.0 / qmax
    sx = torch.clamp(x.abs().amax(dim=(0, 1, 2)).to(torch.float32), min=1e-12) * inv
    w_eff = w_hwio.to(torch.float32) * sx[None, None, :, None]
    sw = torch.clamp(w_eff.abs().amax(dim=(0, 1, 2)), min=1e-12) * inv
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -qmax, qmax)
    wq = torch.clamp(torch.round(w_eff / sw), -qmax, qmax)
    return xq.to(torch.float64), wq.to(torch.float64), sw


def conv_codes(xq, wq, stride: int, padding: int, dilation: int):
    """The exact conv of float64 codes xq (N, H, W, C) with wq (k, k, C, O): (N, Ho, Wo,
    O) float64, in blocks of batch rows that keep each block's input and output under
    ``BLOCK_ELEMENTS``."""
    n, h, w, c = xq.shape
    k, o = wq.shape[0], wq.shape[3]
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    rows = max(1, BLOCK_ELEMENTS // ((h + 2 * padding) * (w + 2 * padding) * c + ho * wo * o))
    kernel = wq.permute(3, 2, 0, 1)
    out = []
    for i in range(0, n, rows):
        out.append(F.conv2d(xq[i:i + rows].permute(0, 3, 1, 2), kernel, None, stride,
                            padding, dilation).permute(0, 2, 3, 1))
    return out[0] if len(out) == 1 else torch.cat(out)


def int8_conv(x, w_hwio, stride: int, padding: int, dilation: int, tier: Tier, net: str):
    """One conv on the tier, no bias: float32(acc) * sw in x's dtype, a contiguous
    (N, Ho, Wo, O) tensor, the layout N2 writes (a later float conv's algorithm, and so
    its rounding, depends on its input's layout)."""
    n, h, w, c = x.shape
    tier.calls.append(Call(net, n, h, w, c, w_hwio.shape[0], w_hwio.shape[3], stride,
                           padding, dilation))
    xq, wq, sw = quantize(x, w_hwio, tier.qmax)
    acc = conv_codes(xq, wq, stride, padding, dilation)
    return (acc.to(torch.float32) * sw).to(x.dtype).contiguous()


def small_cin_gate(cin: int, k: int, stride: int, dilation: int, dtype) -> bool:
    """K3's gate: such a conv is K3's, and float, whatever the tier."""
    return (dtype in (torch.float32, torch.bfloat16) and stride == 1 and dilation == 1
            and 1 < k <= 9 and cin <= 32 and k * cin >= 128)


def eligible(x, cout: int) -> bool:
    return x.dtype in (torch.float32, torch.bfloat16) and x.shape[-1] >= 32 and cout >= 32


def conv_nhwc(x, weight, bias, stride, padding, dilation, tier: Tier, net: str):
    """``layers.conv_nhwc`` routed by the tier's gates (OIHW ``weight``)."""
    weight = weight.to(x.dtype)
    k, cout = weight.shape[-1], weight.shape[0]
    if small_cin_gate(x.shape[-1], k, stride, dilation, x.dtype) or not eligible(x, cout):
        return layers.conv_nhwc(x, weight, bias, stride, padding, dilation)
    y = int8_conv(x, weight.permute(2, 3, 1, 0), stride, padding, dilation, tier, net)
    return y if bias is None else y + bias.to(y.dtype)


def _collapse(w, dim: int):
    """The 5 taps along ``dim`` onto the 3 source taps of each phase, phase 0 then
    phase 1: (K0+K1, K2+K3, K4) and (K0, K1+K2, K3+K4)."""
    t = w.movedim(dim, 0)
    phase0 = torch.stack([t[0] + t[1], t[2] + t[3], t[4]])
    phase1 = torch.stack([t[0], t[1] + t[2], t[3] + t[4]])
    return torch.cat([phase0, phase1]).movedim(0, dim)


def phase_kernel(w_hwio):
    """A 5x5 HWIO kernel (C, O) -> the (3, 3, C, 4 O) phase kernels, groups (a, b, o):
    rows collapsed first, then columns, in the kernel's dtype."""
    c, o = w_hwio.shape[2], w_hwio.shape[3]
    k6 = _collapse(_collapse(w_hwio, 0), 1)  # (a r, b s, C, O)
    return k6.reshape(2, 3, 2, 3, c, o).permute(1, 3, 4, 0, 2, 5).reshape(3, 3, c, 4 * o)


def _strip(x, dim: int, idx):
    """The rows (dim 1) or columns (dim 2) ``idx`` of x, upsampled 2x across the other
    axis and reflect-padded by 2 along it: the padded upsampled field's 6 rows or
    columns that two output rows or columns read."""
    s = x.index_select(dim, torch.tensor(idx, device=x.device))
    other = 3 - dim
    return layers.reflect_pad_axis(s.repeat_interleave(2, dim=other), other, 2)


def upconv(x, weight, bias, tier: Tier, net: str):
    """An ICN up stage's conv on its source ``x`` (N, h, w, C), OIHW ``weight``."""
    n, h, w, c = x.shape
    o = weight.shape[0]
    if not (eligible(x, 4 * o) and h >= 4 and w >= 4):
        return layers.upconv2x_nearest_reflect(x, weight, bias)
    kp = phase_kernel(weight.to(torch.float32).permute(2, 3, 1, 0)).to(x.dtype)
    y4 = int8_conv(layers.reflect_pad(x, 1), kp, 1, 0, 1, tier, net)
    y = layers.depth_to_space(y4, 2)
    kc = weight.to(x.dtype)
    top, bottom = [1, 0, 0, 0, 1, 1], [h - 2, h - 2, h - 1, h - 1, h - 1, h - 2]
    right = [w - 2, w - 2, w - 1, w - 1, w - 1, w - 2]
    # Both row strips in one float conv, then both column strips (the column strips
    # span the whole height, so the corners are theirs).
    rows = layers.conv_nhwc(torch.cat([_strip(x, 1, top), _strip(x, 1, bottom)]), kc, None)
    cols = layers.conv_nhwc(torch.cat([_strip(x, 2, top), _strip(x, 2, right)]), kc, None)
    y[:, :2], y[:, -2:] = rows[:n], rows[n:]
    y[:, :, :2], y[:, :, -2:] = cols[:n], cols[n:]
    return y if bias is None else y + bias.to(y.dtype)


def _conv_forward(m: layers.Conv2d, tier: Tier, net: str, x):
    return conv_nhwc(x, m.weight, m.bias, m.stride, m.padding, m.dilation, tier, net)


def _upconv_forward(m: ricn.UpConv2dBlock, tier: Tier, net: str, x):
    return m._post(upconv(x, m.conv.weight, m.conv.bias, tier, net))


def apply(models, qmax=QMAX) -> Tier:
    """Put the reference ``models``' CAD classifier, hourglass and ICN on the tier with
    codes in [-qmax, qmax] (their instances' forwards; the VUNet is left float), or with
    ``qmax`` None take them off it again. Returns the tier, which records each int8
    call."""
    tier = Tier(qmax)
    for net in ("cad", "hourglass", "icn"):
        put(getattr(models, net), tier, net)
    return tier


def put(module, tier: Tier, net: str) -> None:
    """``apply`` for one network ``module`` (named ``net`` in the tier's calls): on
    ``tier``, or off it where ``tier.qmax`` is None."""
    for m in module.modules():
        if isinstance(m, (ricn.UpConv2dBlock, layers.Conv2d)):
            m.__dict__.pop("forward", None)
        if tier.qmax is None:
            continue
        if isinstance(m, ricn.UpConv2dBlock):
            m.forward = functools.partial(_upconv_forward, m, tier, net)
        elif isinstance(m, layers.Conv2d):
            m.forward = functools.partial(_conv_forward, m, tier, net)
