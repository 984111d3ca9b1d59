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

The int8 serving tier runs on two kernels that port no TPU kernel (the JAX package
runs an int8 XLA convolution, models/layers.py:206, :233, with its quantization ops
fused around it); ``models.layers`` dispatches to :func:`conv_int8_quantized`, N3 then
N2 (``quantized_convs``):

* N3, :func:`quantize_int8_packed` (``csrc/quant_int8.cu``): the per-channel scales
  and the codes of the activation and of the weight in one cooperative launch (grid
  barriers between the max pass and the codes), the weight codes written as N2's
  shared-memory image (:func:`pack_int8_image`); its plain version is
  :func:`quantize_int8_plain` + packing.
* N2, on the codes (``csrc/conv_int8.cu``): an implicit GEMM on ``wgmma`` s8 tensor
  cores, exact int32 accumulation, ``float32(acc) * sw[o]`` in the epilogue, for the
  plain conv and, as s^2 phase convs that skip the holes, the transposed conv.
  :func:`int8_plan` mirrors its plan; :func:`conv_int8_plain` is its function in
  float64, exact for these sums, so kernel and plain version agree bit for bit, and
  :func:`conv_int8_image_plain` repeats its decomposition. :func:`conv_int8` takes HWIO
  codes (packed in torch on the card): the entry the checks use.

Every wrapper takes its plain version for a CPU tensor; a CUDA tensor launches the
kernel, or raises if the kernel cannot take the shapes. Each wrapper counts its
launches: ``LAUNCHES`` (K2), ``SMALL_CIN_V2_LAUNCHES`` (K3), ``SMALL_CIN_LAUNCHES``
(K4), ``INT8_LAUNCHES`` (N2) and ``QUANT_LAUNCHES`` (N3).

The two routes of the scene are ``torch.library`` operators with fake implementations,
so that ``torch.export`` (pipeline/aot.py) can trace a scene through them:
``fusg::icn_stem_conv`` (K2) and ``fusg::conv_int8_quantized`` (N3 then N2). Their CPU
implementations are the plain versions, their CUDA ones launch and count, and
:func:`icn_stem_conv` and :func:`conv_int8_quantized` call the operators.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.ops import _kernels
from future_urban_scene_generation_tpu_torch.utils import profiling

LAUNCHES = 0
SMALL_CIN_V2_LAUNCHES = 0
SMALL_CIN_LAUNCHES = 0
INT8_LAUNCHES = 0
QUANT_LAUNCHES = 0
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


@torch.library.custom_op("fusg::icn_stem_conv", mutates_args=(), device_types="cpu")
def _icn_stem_conv_op(sketch: torch.Tensor, central: torch.Tensor, planes: torch.Tensor,
                      kernel: torch.Tensor, pad: int, s_repeat: int) -> torch.Tensor:
    """K2 as the operator ``fusg::icn_stem_conv`` (a node of an exported scene,
    pipeline/aot.py): the plain version on CPU tensors, the kernel on CUDA tensors."""
    return icn_stem_conv_plain(sketch, central, planes, kernel, pad, s_repeat).contiguous()


@_icn_stem_conv_op.register_kernel("cuda")
def _icn_stem_conv_cuda(sketch, central, planes, kernel, pad, s_repeat):
    global LAUNCHES
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


@_icn_stem_conv_op.register_fake
def _icn_stem_conv_fake(sketch, central, planes, kernel, pad, s_repeat):
    n, h, w, _ = sketch.shape
    k, cout = kernel.shape[0], kernel.shape[-1]
    return sketch.new_empty((n, h + 2 * pad - k + 1, w + 2 * pad - k + 1, cout))


def icn_stem_conv(sketch, central, planes, kernel, pad: int = 3,
                  s_repeat: int = 1) -> torch.Tensor:
    """The ICN stem over the three pieces (see :func:`icn_stem_conv_plain` for the
    shapes), through ``fusg::icn_stem_conv``: CPU tensors take the plain version;
    CUDA tensors launch kernel K2."""
    if sketch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"icn_stem_conv: unsupported device {sketch.device}")
    return _icn_stem_conv_op(sketch, central, planes, kernel, int(pad), int(s_repeat))


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
_INT8_BK = 128  # codes a K-block: one swizzled 128-byte row (csrc/int8_plan.cuh kBK)
_INT8_BM, _INT8_STAGES, _INT8_ALIGN = 128, 4, 1024
_INT8_MAX_PHASES = 16


class Int8Plan(NamedTuple):
    """How N2 runs a conv and how N3 lays out its weight operand (``csrc/int8_plan.cuh``
    ``int8_plan``, checked against it on the card by ``fusg_int8_plan``)."""

    bn: int  # output channels a tile: 64, 128 above 64 outputs, 256 above 128
    bk: int  # codes a K-block (128)
    stages: int  # K-blocks in the shared-memory ring
    smem: int  # bytes of dynamic shared memory N2 asks for
    phases: int  # s * s for a transposed conv of stride s, else 1
    taps: int  # taps an axis the kernel walks: k, or ceil(k / s) a phase
    cp: int  # channels padded to a multiple of 16
    k_img: int  # taps^2 * cp rounded up to bk
    o_tiles: int  # output-channel tiles


def int8_plan(c: int, k: int, cout: int, in_dilation: int = 1) -> Int8Plan:
    """N2's one route (wgmma, 128-pixel tiles) and its sizes for a conv of C input and
    ``cout`` output channels with a k x k kernel; ``in_dilation`` s > 1: the transposed
    conv, run as s^2 phase convs of ceil(k / s)^2 taps each."""
    bn = 256 if cout > 128 else 128 if cout > 64 else 64
    taps = -(-k // in_dilation)
    cp = _round_up(c, 16)
    smem = _INT8_STAGES * (_INT8_BM + bn) * _INT8_BK + _INT8_ALIGN + 2 * _INT8_STAGES * 8
    return Int8Plan(bn, _INT8_BK, _INT8_STAGES, smem, in_dilation ** 2, taps, cp,
                    _round_up(taps * taps * cp, _INT8_BK), -(-cout // bn))


def phase_tap0(lo: int, q: int, s: int) -> int:
    """The first tap of output phase q of a stride-s transposed conv (flipped kernel,
    low padding lo): its taps are ky = phase_tap0 + s t."""
    return (lo - q) % s


def phase_pad(lo: int, q: int, s: int) -> int:
    """Phase q's low padding on the undilated input: its output row a reads input rows
    a + t - phase_pad."""
    return -((q + phase_tap0(lo, q, s) - lo) // s)


def _swizzle(bn: int) -> torch.Tensor:
    """Byte offsets of (row r, code k) in one (bn, 128) tile of the 128-byte swizzle:
    8-row atoms of 1,024 bytes, chunk k // 16 of row r at chunk (k // 16) ^ (r % 8)."""
    r = torch.arange(bn)[:, None]
    k = torch.arange(_INT8_BK)[None, :]
    return (r // 8) * 1024 + (r % 8) * 128 + (((k // 16) ^ (r % 8)) * 16) + k % 16


def _phase_matrices(wq, plan: Int8Plan, in_dilation: int, pad_lo: int) -> torch.Tensor:
    """HWIO codes (k, k, C, O) -> (phases, O, k_img): row o of phase q is the phase's
    taps ordered (ty, tx, c), C padded to cp, K padded to k_img, by zero codes."""
    k, _, c, o = wq.shape
    taps, cp, s = plan.taps, plan.cp, in_dilation
    wpad = F.pad(wq, (0, 0, 0, cp - c))
    mats = []
    for q in range(plan.phases):
        if s == 1:
            sub = wpad
        else:
            ky = [phase_tap0(pad_lo, q // s, s) + s * t for t in range(taps)]
            kx = [phase_tap0(pad_lo, q % s, s) + s * t for t in range(taps)]
            sub = wpad.new_zeros((taps, taps, cp, o))
            for ty, yy in enumerate(ky):
                for tx, xx in enumerate(kx):
                    if yy < k and xx < k:
                        sub[ty, tx] = wpad[yy, xx]
        mats.append(F.pad(sub.permute(3, 0, 1, 2).reshape(o, -1),
                          (0, plan.k_img - taps * taps * cp)))
    return torch.stack(mats)


def pack_int8_image(wq, in_dilation: int = 1, pad_lo: int = 0) -> torch.Tensor:
    """N2's weight operand as N3 writes it: HWIO codes (k, k, C, O) (a transposed
    conv's flipped kernel, ``in_dilation`` its stride, ``pad_lo`` k - 1 - p) -> the
    flat int8 image of every (phase, output tile, K-block) (bn, 128) tile in the
    128-byte swizzle, rows past O zero (``csrc/int8_plan.cuh``)."""
    k, _, c, o = wq.shape
    plan = int8_plan(c, k, o, in_dilation)
    n_kb = plan.k_img // _INT8_BK
    mats = F.pad(_phase_matrices(wq, plan, in_dilation, pad_lo),
                 (0, 0, 0, plan.o_tiles * plan.bn - o))
    tiles = mats.reshape(plan.phases, plan.o_tiles, plan.bn, n_kb, _INT8_BK)
    tiles = tiles.permute(0, 1, 3, 2, 4).reshape(plan.phases, plan.o_tiles, n_kb, -1)
    img = torch.zeros_like(tiles)
    img[..., _swizzle(plan.bn).reshape(-1).to(tiles.device)] = tiles
    return img.reshape(-1)


def unpack_int8_image(img, plan: Int8Plan, cout: int) -> torch.Tensor:
    """The inverse of :func:`pack_int8_image`: -> (phases, O, k_img) code matrices."""
    n_kb = plan.k_img // _INT8_BK
    tiles = img.reshape(plan.phases, plan.o_tiles, n_kb, -1)
    tiles = tiles[..., _swizzle(plan.bn).reshape(-1).to(img.device)]
    mats = tiles.reshape(plan.phases, plan.o_tiles, n_kb, plan.bn, _INT8_BK)
    return mats.permute(0, 1, 3, 2, 4).reshape(plan.phases, plan.o_tiles * plan.bn,
                                               plan.k_img)[:, :cout]


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


def conv_int8_image_plain(xq, img, sw, out_dtype, k: int, *, stride: int = 1,
                          pad_lo: int = 0, pad_hi: int = 0, dilation: int = 1,
                          in_dilation: int = 1) -> torch.Tensor:
    """N2's function by the kernel's own decomposition, from its operands: codes xq
    (N, H, W, C or Cp), the weight image of :func:`pack_int8_image` (k x k taps) and
    sw. A transposed conv (``in_dilation`` s) is s^2 stride-1 convs of the undilated
    input, phase (qy, qx) with its sub-kernel's taps and low padding
    :func:`phase_pad` (negative: a crop), written at output pixels (qy + s a, qx + s b).
    Exact as :func:`conv_int8_plain`."""
    o = sw.shape[0]
    n, h, w, c = xq.shape
    plan = int8_plan(c, k, o, in_dilation)
    taps, cp = plan.taps, plan.cp
    mats = unpack_int8_image(img, plan, o)[:, :, :taps * taps * cp]
    xq = F.pad(xq, (0, cp - c))
    subs = mats.reshape(plan.phases, o, taps, taps, cp).permute(0, 2, 3, 4, 1)
    if in_dilation == 1:
        return conv_int8_plain(xq, subs[0], sw, out_dtype, stride=stride, pad_lo=pad_lo,
                               pad_hi=pad_hi, dilation=dilation)
    s = in_dilation
    ho, wo = int8_out_hw(h, w, k, 1, pad_lo, pad_hi, 1, s)
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=xq.device)
    x = xq.to(torch.float64).permute(0, 3, 1, 2)
    for q in range(plan.phases):
        qy, qx = divmod(q, s)
        hq, wq = -(-(ho - qy) // s), -(-(wo - qx) // s)
        if hq <= 0 or wq <= 0:
            continue
        py, px = phase_pad(pad_lo, qy, s), phase_pad(pad_lo, qx, s)
        xp = F.pad(x, (px, wq + taps - 1 - px - w, py, hq + taps - 1 - py - h))
        acc = F.conv2d(xp, subs[q].to(torch.float64).permute(3, 2, 0, 1))
        out[:, qy::s, qx::s] = (acc.permute(0, 2, 3, 1).to(torch.float32) * sw).to(out_dtype)
    return out


def pack_int8_weights(wq):
    """The first N2's weight operand, kept as the reference layout of a conv's codes:
    HWIO codes (k, k, C, O) -> (O, Kp) int8, k ordered (ky, kx, c) with C padded to a
    multiple of 16 and K to one of 32 by zero codes. Returns (packed, padded C, Kp)."""
    kh, kw, c, o = wq.shape
    cp = _round_up(c, 16)
    if cp != c:
        wq = F.pad(wq, (0, 0, 0, cp - c))
    k = kh * kw * cp
    kp = _round_up(k, 32)
    return F.pad(wq.permute(3, 0, 1, 2).reshape(o, k), (0, kp - k)).contiguous(), cp, kp


def quantize_int8_plain(x, w_hwio):
    """Plain version of N3's quantization: the JAX ``_int8_conv``'s (layers.py:195-205),
    op for op: a per-input-channel activation scale sx = max(max|x| over N, H, W,
    1e-12) / 127, folded into the weight (w_eff = w * sx), a per-output-channel weight
    scale sw from w_eff the same way, and codes round(x / sx), round(w_eff / sw) (half
    to even, divisions, not reciprocals) clamped to +-127. ``w_hwio`` is already in x's
    dtype; both go to float32 first. Returns (x codes, w codes, sw)."""
    sx = torch.clamp(x.abs().amax(dim=(0, 1, 2)).to(torch.float32), min=1e-12) * (1.0 / 127.0)
    w_eff = w_hwio.to(torch.float32) * sx[None, None, :, None]
    sw = torch.clamp(w_eff.abs().amax(dim=(0, 1, 2)), min=1e-12) * (1.0 / 127.0)
    xq = torch.clamp(torch.round(x.to(torch.float32) / sx), -127, 127).to(torch.int8)
    wq = torch.clamp(torch.round(w_eff / sw), -127, 127).to(torch.int8)
    return xq, wq, sw


def quantize_int8_packed_plain(x, w_hwio, *, in_dilation: int = 1, pad_lo: int = 0):
    """Plain version of N3: :func:`quantize_int8_plain`, the x codes' channels padded
    to a multiple of 16, the weight codes as :func:`pack_int8_image`. Returns (x codes
    (N, H, W, Cp), weight image, sw)."""
    xq, wq, sw = quantize_int8_plain(x, w_hwio)
    cp = _round_up(xq.shape[-1], 16)
    return F.pad(xq, (0, cp - xq.shape[-1])), pack_int8_image(wq, in_dilation, pad_lo), sw


def _check_int8(x, w, sw, out_dtype, stride, pad_lo, pad_hi, dilation, in_dilation):
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_int8: unsupported output dtype {out_dtype}")
    if w.device != x.device or (sw is not None and sw.device != x.device):
        raise TypeError("conv_int8: operands must be on one device")
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != w.shape[1]:
        raise ValueError("conv_int8: x must be (N, H, W, C), w (k, k, C, O)")
    if w.shape[2] != x.shape[-1] or (sw is not None and tuple(sw.shape) != (w.shape[3],)):
        raise ValueError(f"conv_int8: w {tuple(w.shape)} does not fit x {tuple(x.shape)}")
    if in_dilation > 1 and (stride != 1 or dilation != 1):
        raise ValueError("conv_int8: an input dilation takes stride 1 and no kernel dilation")
    if in_dilation ** 2 > _INT8_MAX_PHASES:
        raise ValueError(f"conv_int8: a transposed conv of stride {in_dilation} has too many "
                         "phases")
    if pad_lo < 0 or min(stride, dilation, in_dilation) < 1:
        raise ValueError("conv_int8: negative padding or a step below 1")
    k = w.shape[0]
    if k * k * _round_up(x.shape[-1], 16) > _INT8_MAX_K:
        raise ValueError("conv_int8: K too large for an exact int32 accumulator")
    ho, wo = int8_out_hw(x.shape[1], x.shape[2], k, stride, pad_lo, pad_hi, dilation,
                         in_dilation)
    if ho < 1 or wo < 1:
        raise ValueError("conv_int8: empty output")
    return ho, wo


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _launch_conv_int8(xq, img, sw, out_dtype, c, k, ho, wo, stride, pad_lo, dilation,
                      in_dilation) -> torch.Tensor:
    """N2 on its operands: codes (N, H, W, Cp), N3's weight image, sw."""
    global INT8_LAUNCHES
    n, h, w, _ = xq.shape
    o = sw.shape[0]
    out = torch.empty((n, ho, wo, o), dtype=out_dtype, device=xq.device)
    lib = _kernels.load()
    args = (ctypes.c_void_p(xq.data_ptr()), ctypes.c_void_p(img.data_ptr()),
            ctypes.c_void_p(sw.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            0 if out_dtype == torch.float32 else 1, n, h, w, c, k, o, ho, wo)
    if in_dilation == 1:
        rc = lib.fusg_conv_int8(*args, stride, pad_lo, pad_lo, dilation, _stream(xq))
    else:
        rc = lib.fusg_conv_transpose_int8(*args, in_dilation, pad_lo, pad_lo, _stream(xq))
    if rc != 0:
        raise RuntimeError(f"fusg_conv_int8 launch failed: CUDA error {rc}")
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        INT8_LAUNCHES += 1
    return out


def conv_int8(xq, wq, sw, out_dtype, *, stride: int = 1, pad_lo: int = 0, pad_hi: int = 0,
              dilation: int = 1, in_dilation: int = 1) -> torch.Tensor:
    """N2 on HWIO codes: see :func:`conv_int8_plain` for the function. CPU tensors take
    the plain version; CUDA tensors are packed as N3 packs them (the channel pad, and
    :func:`pack_int8_image` in torch) and launch the kernel (``fusg_conv_int8``, or with
    an input dilation ``fusg_conv_transpose_int8``: the phase convs) or raise."""
    geom = dict(stride=stride, pad_lo=pad_lo, pad_hi=pad_hi, dilation=dilation,
                in_dilation=in_dilation)
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, wq, sw, out_dtype, **geom)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_int8: unsupported device {xq.device}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or sw.dtype != torch.float32:
        raise TypeError("conv_int8: codes must be int8 and the scales float32")
    ho, wo = _check_int8(xq, wq, sw, out_dtype, **geom)
    c, k = xq.shape[-1], wq.shape[0]
    xq = F.pad(xq, (0, _round_up(c, 16) - c)).contiguous()
    img = pack_int8_image(wq, in_dilation, pad_lo)
    return _launch_conv_int8(xq, img, sw.contiguous(), out_dtype, c, k, ho, wo, stride,
                             pad_lo, dilation, in_dilation)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def quantize_int8_packed(x, w_hwio, *, flip: bool = False, in_dilation: int = 1,
                         pad_lo: int = 0):
    """N3: the tier's quantization of one conv (``csrc/quant_int8.cu``), one launch.
    ``x`` (N, H, W, C) float32 or bfloat16, ``w_hwio`` (k, k, C, O) in x's dtype (any
    strides: a view of the layer's weight, not copied), ``flip``: the kernel is
    ``w_hwio`` flipped on both tap axes (a transposed conv's, read through negative
    strides). Returns what :func:`quantize_int8_packed_plain` returns, which CPU
    tensors take; CUDA tensors launch the kernel or raise."""
    global QUANT_LAUNCHES
    if x.device.type == "cpu":
        return quantize_int8_packed_plain(x, w_hwio.flip(0, 1) if flip else w_hwio,
                                          in_dilation=in_dilation, pad_lo=pad_lo)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_packed: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w_hwio.dtype != x.dtype:
        raise TypeError("quantize_int8_packed: x float32 or bfloat16, the weight in x's dtype")
    if w_hwio.device != x.device or x.dim() != 4 or w_hwio.dim() != 4 or \
            w_hwio.shape[0] != w_hwio.shape[1] or w_hwio.shape[2] != x.shape[-1]:
        raise ValueError(f"quantize_int8_packed: w {tuple(w_hwio.shape)} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    x = x.contiguous()
    n, h, w, c = x.shape
    k, o = w_hwio.shape[0], w_hwio.shape[3]
    plan = int8_plan(c, k, o, in_dilation)
    s_ky, s_kx, s_c, s_o = w_hwio.stride()
    ptr = w_hwio.data_ptr()
    if flip:
        ptr += (k - 1) * (s_ky + s_kx) * w_hwio.element_size()
        s_ky, s_kx = -s_ky, -s_kx
    lib = _kernels.load()
    slices = _sm_count(x.device) * lib.fusg_quant_int8_slices()
    # One allocation carved into the weight image, the x codes, sw and the kernel's
    # scratch (the maxima, their per-block partials, the weight's maxima over its taps),
    # in that order: each part's size keeps the next one aligned.
    sizes = (plan.phases * plan.o_tiles * plan.k_img * plan.bn, n * h * w * plan.cp, 4 * o,
             4 * c, 4 * c * slices, 4 * o * c)
    img, xq, sw, amax, part, wmax = torch.empty(sum(sizes), dtype=torch.int8,
                                                device=x.device).split(sizes)
    xq = xq.view(n, h, w, plan.cp)
    sw = sw.view(torch.float32)
    rc = lib.fusg_quant_int8(
        ctypes.c_void_p(x.data_ptr()), 0 if x.dtype == torch.float32 else 1, n, h, w, c,
        ctypes.c_void_p(ptr), s_ky, s_kx, s_c, s_o, k, o, in_dilation, pad_lo,
        ctypes.c_void_p(part.data_ptr()), slices, ctypes.c_void_p(wmax.data_ptr()),
        ctypes.c_void_p(amax.data_ptr()), ctypes.c_void_p(xq.data_ptr()),
        ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(sw.data_ptr()), _stream(x))
    if rc != 0:
        raise RuntimeError(f"fusg_quant_int8 launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        QUANT_LAUNCHES += 1
    return xq, img, sw


@torch.library.custom_op("fusg::conv_int8_quantized", mutates_args=(), device_types="cpu")
def _conv_int8_quantized_op(x: torch.Tensor, w_hwio: torch.Tensor, out_dtype: torch.dtype,
                            flip: bool, stride: int, pad_lo: int, pad_hi: int,
                            dilation: int, in_dilation: int) -> torch.Tensor:
    """N3 then N2 as one operator, ``fusg::conv_int8_quantized`` (a node of an exported
    scene, pipeline/aot.py). One operator and not two: N3's three outputs are views of
    one allocation, which an operator may not return. CPU tensors take the torch
    composition, CUDA tensors the kernels."""
    xq, wq, sw = quantize_int8_plain(x, w_hwio.flip(0, 1) if flip else w_hwio)
    return conv_int8(xq, wq, sw, out_dtype, stride=stride, pad_lo=pad_lo, pad_hi=pad_hi,
                     dilation=dilation, in_dilation=in_dilation).contiguous()


@_conv_int8_quantized_op.register_kernel("cuda")
def _conv_int8_quantized_cuda(x, w_hwio, out_dtype, flip, stride, pad_lo, pad_hi, dilation,
                              in_dilation):
    ho, wo = _check_int8(x, w_hwio, None, out_dtype, stride, pad_lo, pad_hi, dilation,
                         in_dilation)
    xq, img, sw = quantize_int8_packed(x, w_hwio, flip=flip, in_dilation=in_dilation,
                                       pad_lo=pad_lo)
    return _launch_conv_int8(xq, img, sw, out_dtype, x.shape[-1], w_hwio.shape[0], ho, wo,
                             stride, pad_lo, dilation, in_dilation)


@_conv_int8_quantized_op.register_fake
def _conv_int8_quantized_fake(x, w_hwio, out_dtype, flip, stride, pad_lo, pad_hi, dilation,
                              in_dilation):
    ho, wo = int8_out_hw(x.shape[1], x.shape[2], w_hwio.shape[0], stride, pad_lo, pad_hi,
                         dilation, in_dilation)
    return x.new_empty((x.shape[0], ho, wo, w_hwio.shape[3]), dtype=out_dtype)


def conv_int8_quantized(x, w_hwio, out_dtype, *, flip: bool = False, stride: int = 1,
                        pad_lo: int = 0, pad_hi: int = 0, dilation: int = 1,
                        in_dilation: int = 1) -> torch.Tensor:
    """One conv on the int8 tier: x (N, H, W, C) and the HWIO weight in x's dtype
    (``flip``: flipped on its tap axes, a transposed conv's kernel) -> (N, Ho, Wo, O)
    in ``out_dtype``, through ``fusg::conv_int8_quantized``, inside a ``fusg.int8`` span
    (the tier's host cost a call). CPU tensors take the torch composition
    (:func:`quantize_int8_plain`, then :func:`conv_int8`'s plain version); CUDA tensors
    launch N3 then N2, or raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_int8_quantized: unsupported device {x.device}")
    with profiling.trace("fusg.int8"):
        return _conv_int8_quantized_op(x, w_hwio, out_dtype, bool(flip), int(stride),
                                       int(pad_lo), int(pad_hi), int(dilation),
                                       int(in_dilation))
