"""Peaks of one H100 SXM and the port's kernels' operations and bytes from shapes.

The arithmetic is copied from ``chip_smoke.py`` at commit a2138eb (``bound_ms`` and
the K1, K2 and K3 reckonings of its k1, k2 and k3 phases). A kernel's bound is the
larger of its operations over the peak of its precision and its bytes over the
memory rate; each input byte counts once and each output byte once.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates, at the full 700 W power limit.
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_F32 = 67e12  # float32 FLOP/s outside the tensor cores
PEAK_BF16 = 989e12
PEAKS = {"float32": PEAK_F32, "bfloat16": PEAK_BF16}

# Device kernel names (as the profiler reports them, demangled) of each kernel.
K1_NAMES = ("raster_setup_kernel", "raster_tiles_kernel")
CONV_NAMES = ("conv_fma_kernel", "conv_mma_kernel", "conv_wgmma_kernel")
STEM_LOADER = "StemLoader"


def is_k1(name: str) -> bool:
    return any(n in name for n in K1_NAMES)


def is_k1_setup(name: str) -> bool:
    return K1_NAMES[0] in name


def is_conv_core(name: str) -> bool:
    return any(n in name for n in CONV_NAMES)


def is_k2(name: str) -> bool:
    """The ICN stem kernel: a conv_core main loop behind the three-tensor loader."""
    return is_conv_core(name) and STEM_LOADER in name


def is_k3(name: str) -> bool:
    """The small-C_in conv: a conv_core main loop behind the single-tensor loader."""
    return is_conv_core(name) and STEM_LOADER not in name


def bound_s(n_bytes: float, n_ops: float, peak_ops: float) -> float:
    """The least seconds the card could take: bytes over the memory rate against
    operations over ``peak_ops``."""
    return max(n_bytes / PEAK_BYTES, n_ops / peak_ops)


def k1_call(renders: int, triangles: int, h: int, w: int, cull: bool = True):
    """(bytes, operations) of one K1 call: the corner-expanded screen positions and
    colours (R, 3, 3, T) float32 and the cull flags (R,) bool read, the image
    (R, H, W, 3) float32 and the background mask (R, H, W) bool written. Operations
    depend on where the triangles fall (chip_smoke.py counts their bounding boxes'
    tile overlaps x 256 px x 12 flop); at the scene's 256^2 crops of 1,944-triangle
    cars that count's bound is a third of the bytes' (0.00237 against 0.00711 ms
    for 24 renders), so the bytes bound it and the operations are not counted."""
    n_bytes = 2 * renders * 9 * triangles * 4 + (renders if cull else 0) + renders * h * w * 13
    return n_bytes, 0.0


def k2_call(n: int, vehicles: int, h: int, w: int, cin: int = 21, k: int = 7,
            cout: int = 64, itemsize: int = 4):
    """(bytes, FLOP) of one K2 call: the sketches (N, H, W, 3), the central priors
    (V, H, W, 3) and the planes (N, 5, H, W, 3) read, the HWIO kernel read, the
    (N, H, W, O) output written; 2 FLOP a multiply-add over k * k * C_in taps."""
    n_bytes = itemsize * (n * h * w * 3 + vehicles * h * w * 3 + n * (cin - 6) * h * w
                          + k * k * cin * cout + n * h * w * cout)
    return n_bytes, 2.0 * n * h * w * cout * k * k * cin


def k3_call(n: int, hp: int, wp: int, cin: int, k: int, cout: int, itemsize: int = 4):
    """(bytes, FLOP) of one K3 call on a pre-padded (N, Hp, Wp, C_in) input."""
    ho, wo = hp - k + 1, wp - k + 1
    n_bytes = itemsize * (n * hp * wp * cin + k * k * cin * cout + n * ho * wo * cout)
    return n_bytes, 2.0 * n * ho * wo * cout * k * k * cin
