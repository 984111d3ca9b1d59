"""The port's small-input-channel convolution kernels.

Kernel K2, the ICN stem convolution over a channel concat assembled in-kernel:
counterpart of the JAX package's ops/pallas_conv.py ``icn_stem_conv_fused`` (:190,
kernel ``_conv_kernel_v2_fused`` :148): reflect-pad by ``pad``, then a k x k
stride-1 convolution over [sketch (3) | central (3), read at n // s_repeat |
planes (3 * P)], float32 accumulation, no bias. The CUDA kernel lives in
``csrc/stem_conv.cu``. :func:`icn_stem_conv` is the wrapper the scene calls.

Both kernels are loaders around one core, ``csrc/conv_core.cuh``: bfloat16 runs as an
implicit GEMM on the tensor cores (wgmma, or mma.sync for the shapes wgmma's layout
does not take) over a sliding view of the staged input patch
(:func:`conv_sliding_plain` repeats that decomposition in torch, for the CPU tests),
float32 as a register-tiled FMA loop on the CUDA cores. :func:`conv_plan` says which
main loop a shape takes and how much shared memory the launch asks for.

Kernel K3, the stride-1 VALID convolution of a pre-padded NHWC input with an HWIO
kernel (JAX ``conv_small_cin_v2`` :102, kernel ``_conv_kernel_v2`` :64), with K4's
entry on the same kernel (JAX ``conv_small_cin`` :276, kernel ``_conv_kernel`` :35,
an older TPU layout of the same function). The CUDA kernel lives in
``csrc/conv_small_cin.cu``; ``models.layers`` dispatches gated convs to
:func:`conv_small_cin_v2`.

Kernel N2, :func:`conv_int8`, is the int8 serving tier's convolution on int8 codes
(``csrc/conv_int8.cu``: an implicit GEMM on ``mma.sync`` s8 tensor cores, exact
int32 accumulation, ``float32(acc) * sw[o]`` in the epilogue), for the plain conv and,
with an input dilation, the transposed conv. It ports no TPU kernel: the JAX package
runs an int8 XLA convolution (models/layers.py:206, :233). ``models.layers`` quantizes
and dispatches to it (``quantized_convs``); :func:`conv_int8_plain` is the same
function in float64, exact for these sums, so kernel and plain version agree bit for
bit.

Every wrapper takes its plain version for a CPU tensor; a CUDA tensor launches the
kernel, or raises if the kernel cannot take the shapes. Each wrapper counts its
launches: ``LAUNCHES`` (K2), ``SMALL_CIN_V2_LAUNCHES`` (K3), ``SMALL_CIN_LAUNCHES``
(K4) and ``INT8_LAUNCHES`` (N2).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.ops import _kernels

LAUNCHES = 0
SMALL_CIN_V2_LAUNCHES = 0
SMALL_CIN_LAUNCHES = 0
INT8_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_TILE = 16
_WGMMA_K = 7  # the kernel size the wgmma kernel is instantiated for (the stems)
_FMA_STAGES = 4  # (ky, kx) weight taps in the float32 kernel's cp.async ring


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ConvPlan(NamedTuple):
    """How K2 / K3 run a shape (``csrc/conv_core.cuh`` ``mma_plan`` / ``fma_plan``)."""

    route: str  # bf16 tensor cores: "wgmma" or "mma" (mma.sync); "fma": float32 CUDA cores
    otile: int  # output channels a block covers (weight slots past O are zero)
    smem: int  # bytes of dynamic shared memory the launch asks for
    resident: bool  # bf16: the whole packed weight matrix stays in shared memory
    cp: int  # bf16: channels padded to a multiple of 8 (fma: 0)
    kr: int  # bf16: one ky run, k * cp rounded up to a multiple of 16 (fma: 0)


def conv_plan(dtype, cin: int, k: int, cout: int) -> ConvPlan:
    """The one dispatch between the hand-written main loops, and their shared-memory
    sizes. bfloat16 with a 7 x 7 kernel and more than 16 output channels, where the
    packed weights (2,048 B per 16-deep step) fit beside two patch buffers in 232,448 B
    -> ``conv_wgmma_kernel`` (the ICN stem); other bfloat16 shapes -> ``conv_mma_kernel``
    (mma.sync: the weight matrix ``[ky][kr][otile + 8]`` resident where that fits, else
    one ky row at a time: other kernel sizes, narrow outputs); float32 ->
    ``conv_fma_kernel`` (one patch with an odd pixel pitch and a ring of four (ky, kx)
    weight taps)."""
    otile = 64 if cout > 16 else 16
    pw = _TILE + k - 1
    if dtype == torch.bfloat16:
        cp = _round_up(cin, 8)
        kr = _round_up(k * cp, 16)
        patch = pw * pw * cp * 2 + 16
        wgmma_full = k * (kr // 16) * 2048 + 2 * patch
        if otile == 64 and k == _WGMMA_K and wgmma_full <= _SMEM_LIMIT:
            return ConvPlan("wgmma", otile, wgmma_full, True, cp, kr)
        wrow = kr * (otile + 8) * 2
        full = k * wrow + 2 * patch
        resident = full <= _SMEM_LIMIT
        return ConvPlan("mma", otile, full if resident else wrow + 2 * patch, resident, cp, kr)
    if dtype == torch.float32:
        patch = _round_up(pw * pw * (cin | 1), 4)
        return ConvPlan("fma", otile, (patch + _FMA_STAGES * cin * otile) * 4, False, 0, 0)
    raise TypeError(f"conv_plan: unsupported dtype {dtype}")


def conv_sliding_plain(x, kernel) -> torch.Tensor:
    """K3's function computed by the tensor-core kernel's decomposition, in torch:
    per 16x16 output tile the input patch is staged NHWC with the channels
    zero-padded to ``cp``, flattened, and followed by an 8-element zero tail; for each
    ky the K-run of output pixel (y, x) is the contiguous span of ``kr`` elements from
    patch pixel (y + ky, x) on — it overruns ``k * cp`` by 0 or 8 elements into the
    next pixel, the next patch row or the tail, where the packed weights
    ``[ky][kr][O]`` hold zero rows. Positions past a ragged tile edge are clamped.
    Same shapes and dtypes as :func:`conv_small_cin_plain`."""
    n, hp, wp, c = x.shape
    k, o = kernel.shape[0], kernel.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    plan = conv_plan(torch.bfloat16, c, k, o)
    cp, kr, pw = plan.cp, plan.kr, _TILE + k - 1
    h_out, w_out = hp - k + 1, wp - k + 1
    wpk = torch.zeros((k, kr, o), dtype=acc)
    wpk[:, :k * cp].view(k, k, cp, o)[:, :, :c] = kernel.to(acc)
    out = torch.empty((n, h_out, w_out, o), dtype=acc)
    for oy0 in range(0, h_out, _TILE):
        for ox0 in range(0, w_out, _TILE):
            iy = torch.arange(oy0, oy0 + pw).clamp(max=hp - 1)
            ix = torch.arange(ox0, ox0 + pw).clamp(max=wp - 1)
            patch = torch.zeros((n, pw, pw, cp), dtype=acc)
            patch[..., :c] = x[:, iy][:, :, ix].to(acc)
            flat = torch.cat([patch.reshape(n, -1), torch.zeros((n, 8), dtype=acc)], dim=1)
            runs = flat.as_strided((n, _TILE, _TILE, k, kr),
                                   (flat.stride(0), pw * cp, cp, pw * cp, 1))
            tile = torch.einsum("nyxkj,kjo->nyxo", runs, wpk)
            out[:, oy0:oy0 + _TILE, ox0:ox0 + _TILE] = tile[:, :h_out - oy0, :w_out - ox0]
    return out.to(x.dtype)


def stem_gather_plain(sketch, central, planes, pad: int, s_repeat: int) -> torch.Tensor:
    """The padded 21-channel input of K2 as the kernel's loader addresses it
    (``StemLoader`` in ``csrc/conv_core.cuh``): reflect index ``|i|``, then
    ``2n - 2 - i`` past the end; channel c < 3 from ``sketch``, c < 6 from ``central``
    at sample ``n // s_repeat``, else plane ``(c - 6) // 3``, component
    ``(c - 6) % 3``. -> (N, H + 2 pad, W + 2 pad, 3 * (2 + P))."""
    n, h, w, _ = sketch.shape

    def reflect(size):
        i = torch.arange(-pad, size + pad).abs()
        return torch.where(i >= size, 2 * size - 2 - i, i)

    iy, ix = reflect(h)[:, None], reflect(w)[None, :]
    pieces = []
    for c in range(3 * (2 + planes.shape[1])):
        if c < 3:
            pieces.append(sketch[:, iy, ix, c])
        elif c < 6:
            pieces.append(central[torch.arange(n) // s_repeat][:, iy, ix, c - 3])
        else:
            pieces.append(planes[:, (c - 6) // 3][:, iy, ix, (c - 6) % 3])
    return torch.stack(pieces, dim=-1)


def icn_stem_sliding_plain(sketch, central, planes, kernel, pad: int = 3,
                           s_repeat: int = 1) -> torch.Tensor:
    """K2's function by the kernel's own decomposition: the loader's gather
    (:func:`stem_gather_plain`), then the sliding-view product
    (:func:`conv_sliding_plain`). Same shapes as :func:`icn_stem_conv_plain`."""
    return conv_sliding_plain(stem_gather_plain(sketch, central, planes, pad, s_repeat), kernel)


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
    _check_launch("icn_stem_conv", sketch.dtype, n, cin, k, cout)


def _check_launch(name, dtype, n, cin, k, cout):
    """Grid and shared-memory limits of a launch of the shared core."""
    plan = conv_plan(dtype, cin, k, cout)
    if plan.smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: {plan.smem} B of shared memory exceeds the limit")
    # float32 puts N x output-channel tiles on grid z, bfloat16 the tiles on grid y.
    if (n if plan.route == "fma" else 1) * -(-cout // plan.otile) > 65535:
        raise ValueError(f"{name}: N x output-channel tiles exceeds the grid limit")


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
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        LAUNCHES += 1
    return out


def conv_small_cin_plain(x, kernel) -> torch.Tensor:
    """Plain version of K3 and K4: x (N, Hp, Wp, C) pre-padded, kernel (k, k, C, O)
    HWIO -> (N, Hp - k + 1, Wp - k + 1, O) in x's dtype, computed by ``F.conv2d`` in
    float32 (float64 for float64 inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    out = F.conv2d(x.to(acc).permute(0, 3, 1, 2), kernel.to(acc).permute(3, 2, 0, 1))
    return out.permute(0, 2, 3, 1).to(x.dtype)


def _check_small_cin(x, kernel):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_small_cin: unsupported dtype {x.dtype}")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError("conv_small_cin: kernel must match x's dtype/device")
    if x.dim() != 4 or kernel.dim() != 4:
        raise ValueError("conv_small_cin: x must be (N, Hp, Wp, C), kernel (k, k, C, O)")
    n, hp, wp, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[-1]
    if tuple(kernel.shape[:3]) != (k, k, cin) or cout < 1:
        raise ValueError(f"conv_small_cin: kernel {tuple(kernel.shape)} != ({k}, {k}, {cin}, O)")
    if hp < k or wp < k:
        raise ValueError(f"conv_small_cin: input {hp}x{wp} is smaller than the {k}x{k} kernel")
    _check_launch("conv_small_cin", x.dtype, n, cin, k, cout)


def _launch_small_cin(x, kernel) -> torch.Tensor:
    _check_small_cin(x, kernel)
    n, hp, wp, cin = x.shape
    k, cout = kernel.shape[0], kernel.shape[-1]
    x, kernel = x.contiguous(), kernel.contiguous()
    out = torch.empty((n, hp - k + 1, wp - k + 1, cout), dtype=x.dtype, device=x.device)
    rc = _kernels.load().fusg_conv_small_cin(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(kernel.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), 0 if x.dtype == torch.float32 else 1,
        n, hp, wp, cin, k, cout,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fusg_conv_small_cin launch failed: CUDA error {rc}")
    return out


def conv_small_cin_v2(x, kernel) -> torch.Tensor:
    """K3: stride-1 VALID conv of a pre-padded NHWC ``x`` with an HWIO ``kernel``
    (see :func:`conv_small_cin_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    global SMALL_CIN_V2_LAUNCHES
    if x.device.type == "cpu":
        return conv_small_cin_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_small_cin_v2: unsupported device {x.device}")
    out = _launch_small_cin(x, kernel)
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        SMALL_CIN_V2_LAUNCHES += 1
    return out


def conv_small_cin(x, kernel) -> torch.Tensor:
    """K4's entry: the same function as :func:`conv_small_cin_v2` on the same kernel
    (the JAX package's older TPU layout of it), counted on its own."""
    global SMALL_CIN_LAUNCHES
    if x.device.type == "cpu":
        return conv_small_cin_plain(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"conv_small_cin: unsupported device {x.device}")
    out = _launch_small_cin(x, kernel)
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        SMALL_CIN_LAUNCHES += 1
    return out


# The largest K = kh * kw * C whose int32 sums of code products stay exact (127^2 K < 2^31).
_INT8_MAX_K = (2**31 - 1) // (127 * 127)


def int8_out_hw(h: int, w: int, k: int, stride: int, pad_lo: int, pad_hi: int,
                dilation: int, in_dilation: int):
    """Output size of :func:`conv_int8`: the input dilated by ``in_dilation`` (holes of
    zeros between pixels), padded ``pad_lo`` / ``pad_hi`` on both axes, convolved with a
    k x k kernel dilated by ``dilation`` at ``stride`` (lax.conv_general_dilated's
    geometry)."""
    def side(n):
        return ((n - 1) * in_dilation + 1 + pad_lo + pad_hi - dilation * (k - 1) - 1) // stride + 1
    return side(h), side(w)


def conv_int8_plain(xq, wq, sw, out_dtype, *, stride: int = 1, pad_lo: int = 0,
                    pad_hi: int = 0, dilation: int = 1, in_dilation: int = 1) -> torch.Tensor:
    """Plain version of N2: int8 codes xq (N, H, W, C) and wq (k, k, C, O) HWIO, scales
    sw (O,) float32 -> (N, Ho, Wo, O) ``float32(acc) * sw`` in ``out_dtype``. The sums
    run in float64 on the codes, exact while |acc| <= 127^2 K < 2^53, so the result is
    the int32 accumulator's."""
    x = xq.to(torch.float64).permute(0, 3, 1, 2)
    if in_dilation > 1:
        n, c, h, w = x.shape
        xd = x.new_zeros(n, c, (h - 1) * in_dilation + 1, (w - 1) * in_dilation + 1)
        xd[:, :, ::in_dilation, ::in_dilation] = x
        x = xd
    x = F.pad(x, (pad_lo, pad_hi, pad_lo, pad_hi))
    acc = F.conv2d(x, wq.to(torch.float64).permute(3, 2, 0, 1), stride=stride,
                   dilation=dilation)
    return (acc.permute(0, 2, 3, 1).to(torch.float32) * sw).to(out_dtype)


def pack_int8_weights(wq):
    """The kernel's weight operand: HWIO codes (k, k, C, O) -> (O, Kp) int8, k ordered
    (ky, kx, c) with C padded to a multiple of 16 and K to one of 32 by zero codes.
    Returns (packed, padded C, Kp)."""
    kh, kw, c, o = wq.shape
    cp = _round_up(c, 16)
    if cp != c:
        wq = F.pad(wq, (0, 0, 0, cp - c))
    k = kh * kw * cp
    kp = _round_up(k, 32)
    return F.pad(wq.permute(3, 0, 1, 2).reshape(o, k), (0, kp - k)).contiguous(), cp, kp


def _check_int8(xq, wq, sw, out_dtype, stride, pad_lo, pad_hi, dilation, in_dilation):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or sw.dtype != torch.float32:
        raise TypeError("conv_int8: codes must be int8 and the scales float32")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_int8: unsupported output dtype {out_dtype}")
    if wq.device != xq.device or sw.device != xq.device:
        raise TypeError("conv_int8: codes and scales must be on one device")
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[0] != wq.shape[1]:
        raise ValueError("conv_int8: x must be (N, H, W, C), w (k, k, C, O)")
    if wq.shape[2] != xq.shape[-1] or tuple(sw.shape) != (wq.shape[3],):
        raise ValueError(f"conv_int8: w {tuple(wq.shape)} / sw {tuple(sw.shape)} do not fit "
                         f"x {tuple(xq.shape)}")
    if in_dilation > 1 and (stride != 1 or dilation != 1):
        raise ValueError("conv_int8: an input dilation takes stride 1 and no kernel dilation")
    if pad_lo < 0 or min(stride, dilation, in_dilation) < 1:
        raise ValueError("conv_int8: negative padding or a step below 1")
    k = wq.shape[0]
    if k * k * _round_up(xq.shape[-1], 16) > _INT8_MAX_K:
        raise ValueError("conv_int8: K too large for an exact int32 accumulator")
    ho, wo = int8_out_hw(xq.shape[1], xq.shape[2], k, stride, pad_lo, pad_hi, dilation,
                         in_dilation)
    if ho < 1 or wo < 1:
        raise ValueError("conv_int8: empty output")
    return ho, wo


def conv_int8(xq, wq, sw, out_dtype, *, stride: int = 1, pad_lo: int = 0, pad_hi: int = 0,
              dilation: int = 1, in_dilation: int = 1) -> torch.Tensor:
    """N2: see :func:`conv_int8_plain` for the function. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``fusg_conv_int8``, or with an input
    dilation ``fusg_conv_transpose_int8``) or raise."""
    global INT8_LAUNCHES
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, wq, sw, out_dtype, stride=stride, pad_lo=pad_lo,
                               pad_hi=pad_hi, dilation=dilation, in_dilation=in_dilation)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_int8: unsupported device {xq.device}")
    ho, wo = _check_int8(xq, wq, sw, out_dtype, stride, pad_lo, pad_hi, dilation,
                         in_dilation)
    n, h, w, c = xq.shape
    k, o = wq.shape[0], wq.shape[3]
    wpk, cp, kp = pack_int8_weights(wq)
    xq = (F.pad(xq, (0, cp - c)) if cp != c else xq).contiguous()
    sw = sw.contiguous()
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=xq.device)
    lib = _kernels.load()
    args = (ctypes.c_void_p(xq.data_ptr()), ctypes.c_void_p(wpk.data_ptr()),
            ctypes.c_void_p(sw.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            0 if out_dtype == torch.float32 else 1, n, h, w, cp, k, k, o, ho, wo)
    stream = ctypes.c_void_p(torch.cuda.current_stream(xq.device).cuda_stream)
    if in_dilation == 1:
        rc = lib.fusg_conv_int8(*args, stride, pad_lo, pad_lo, dilation, kp, stream)
    else:
        rc = lib.fusg_conv_transpose_int8(*args, in_dilation, pad_lo, pad_lo, kp, stream)
    if rc != 0:
        raise RuntimeError(f"fusg_conv_int8 launch failed: CUDA error {rc}")
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        INT8_LAUNCHES += 1
    return out
