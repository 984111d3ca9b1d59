"""Kernel K2: the ICN stem convolution over a channel concat assembled in-kernel.

Counterpart of the JAX package's ops/pallas_conv.py ``icn_stem_conv_fused`` (:190,
kernel ``_conv_kernel_v2_fused`` :148): reflect-pad by ``pad``, then a k x k
stride-1 convolution over [sketch (3) | central (3), read at n // s_repeat |
planes (3 * P)], float32 accumulation, no bias. The CUDA kernel lives in
``csrc/stem_conv.cu``.

:func:`icn_stem_conv` is the wrapper the scene calls: a CPU tensor takes the plain
version :func:`icn_stem_conv_plain` (reflect-pad, concat, repeat and ``F.conv2d``
in float32); a CUDA tensor launches the kernel, or raises if the kernel cannot take
the shapes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.ops import _kernels

LAUNCHES = 0
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_COUTS = (8, 16, 64)  # output widths the kernel is instantiated for
_TILE = 16


def icn_stem_conv_plain(sketch, central, planes, kernel, pad: int = 3,
                        s_repeat: int = 1) -> torch.Tensor:
    """Plain version of K2. sketch (N, H, W, 3), central (N // s_repeat, H, W, 3),
    planes (N, P, H, W, 3), kernel (k, k, 3 * (2 + P), O) HWIO. Computes in float32
    (float64 for float64 inputs) and returns (N, H', W', O) in sketch's dtype."""
    n, h, w, _ = sketch.shape
    n_planes = planes.shape[1]
    acc = torch.promote_types(sketch.dtype, torch.float32)
    central_rep = central.repeat_interleave(s_repeat, dim=0)
    planes_cat = planes.permute(0, 2, 3, 1, 4).reshape(n, h, w, 3 * n_planes)
    inp = torch.cat([sketch, central_rep, planes_cat], dim=-1).to(acc)
    x = F.pad(inp.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(x, kernel.to(acc).permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).to(sketch.dtype)


def _check(sketch, central, planes, kernel, pad, s_repeat):
    n, h, w, c = sketch.shape
    if sketch.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"icn_stem_conv: unsupported dtype {sketch.dtype}")
    for name, t in (("central", central), ("planes", planes), ("kernel", kernel)):
        if t.dtype != sketch.dtype or t.device != sketch.device:
            raise TypeError(f"icn_stem_conv: {name} must match sketch's dtype/device")
    n_planes = planes.shape[1]
    k, cout = kernel.shape[0], kernel.shape[-1]
    cin = 3 * (2 + n_planes)
    if c != 3 or planes.shape[-1] != 3 or central.shape[-1] != 3:
        raise ValueError("icn_stem_conv: every piece must have 3 channels")
    if tuple(kernel.shape) != (k, k, cin, cout):
        raise ValueError(f"icn_stem_conv: kernel {tuple(kernel.shape)} != ({k}, {k}, {cin}, O)")
    if n % s_repeat or central.shape[0] != n // s_repeat:
        raise ValueError("icn_stem_conv: central must carry N // s_repeat samples")
    if planes.shape[0] != n or planes.shape[2:4] != (h, w) or central.shape[1:3] != (h, w):
        raise ValueError("icn_stem_conv: piece shapes disagree")
    if not (0 <= pad < min(h, w)):
        raise ValueError(f"icn_stem_conv: reflect pad {pad} needs pad < H, W")
    if cout not in _COUTS:
        raise ValueError(f"icn_stem_conv: the kernel takes O in {_COUTS}, got {cout}")
    pw = _TILE + k - 1
    smem = (((pw * pw * cin) + 3) // 4 * 4 + k * cin * cout) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"icn_stem_conv: {smem} B of shared memory exceeds the limit")


def icn_stem_conv(sketch, central, planes, kernel, pad: int = 3,
                  s_repeat: int = 1) -> torch.Tensor:
    """The ICN stem over the three pieces (see :func:`icn_stem_conv_plain` for the
    shapes). CPU tensors take the plain version; CUDA tensors launch kernel K2."""
    global LAUNCHES
    if sketch.device.type == "cpu":
        return icn_stem_conv_plain(sketch, central, planes, kernel, pad, s_repeat)
    if sketch.device.type != "cuda":
        raise ValueError(f"icn_stem_conv: unsupported device {sketch.device}")
    _check(sketch, central, planes, kernel, pad, s_repeat)
    n, h, w, _ = sketch.shape
    k, cout = kernel.shape[0], kernel.shape[-1]
    h_out, w_out = h + 2 * pad - k + 1, w + 2 * pad - k + 1
    sketch, central, planes, kernel = (
        t.contiguous() for t in (sketch, central, planes, kernel)
    )
    out = torch.empty((n, h_out, w_out, cout), dtype=sketch.dtype, device=sketch.device)
    lib = _kernels.load()
    rc = lib.fusg_stem_conv(
        ctypes.c_void_p(sketch.data_ptr()), ctypes.c_void_p(central.data_ptr()),
        ctypes.c_void_p(planes.data_ptr()), ctypes.c_void_p(kernel.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), 0 if sketch.dtype == torch.float32 else 1,
        n, h, w, planes.shape[1], k, pad, cout, s_repeat,
        ctypes.c_void_p(torch.cuda.current_stream(sketch.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fusg_stem_conv launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
