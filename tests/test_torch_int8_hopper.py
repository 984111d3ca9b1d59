"""The layouts and decompositions of the int8 tier's Hopper kernels, on the CPU.

Kernel N3 (``csrc/quant_int8.cu``) writes the weight codes as N2's shared-memory
image (``cuda_conv.pack_int8_image``: the 128-byte swizzle of every (phase, output
tile, K-block) tile); kernel N2 (``csrc/conv_int8.cu``) reads it and runs a
transposed conv as stride^2 phase convs of the undilated input. The kernels run only
on the card (``chip_smoke.py --phases int8`` holds them bit-equal to these plain
versions there); here the plain versions are held against the definitions they
replace: the image unpacks to ``pack_int8_weights``' (O, Kp) codes, the phase
decomposition equals the input-dilated conv bit for bit, N3's plain version is the
tier's quantization plus packing, and ``int8_plan`` sizes the scene's convs.
"""
import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.ops import cuda_conv
import torch_threads  # noqa: F401

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper


def _codes(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)


@pytest.mark.parametrize("k,pad", [(4, 1), (2, 0), (3, 1), (5, 2)],
                         ids=["4x4_s2_p1", "2x2_s2_p0", "3x3_s2_p1", "5x5_s2_p2"])
def test_phase_decomposition_is_the_dilated_transposed_conv(k, pad):
    """(c) EdgeConnect's 4x4 s2 p1 and Mask R-CNN's 2x2 s2 p0 transposed convs (and two
    kernels that do not divide by the stride, whose phases walk zero taps): the plain
    form of N2's phase convs equals the input-dilated conv bit for bit, the sums being
    the same integers."""
    gen = torch.Generator().manual_seed(k * 10 + pad)
    xq, wq = _codes(gen, 2, 7, 6, 40), _codes(gen, k, k, 40, 48)
    sw = torch.rand(48, generator=gen) * 1e-3
    lo = k - 1 - pad
    for dt in (torch.float32, torch.bfloat16):
        want = cuda_conv.conv_int8_plain(xq, wq, sw, dt, pad_lo=lo, pad_hi=lo, in_dilation=2)
        img = cuda_conv.pack_int8_image(wq, 2, lo)
        got = cuda_conv.conv_int8_image_plain(xq, img, sw, dt, k, pad_lo=lo, pad_hi=lo,
                                              in_dilation=2)
        assert got.dtype == dt and torch.equal(got, want)
    plan = cuda_conv.int8_plan(40, k, 48, 2)
    assert plan.phases == 4 and plan.taps == -(-k // 2)
    # Every tap of the kernel lands in exactly one phase, once.
    mats = cuda_conv.unpack_int8_image(img, plan, 48)[:, :, :plan.taps ** 2 * plan.cp]
    assert int((mats != 0).sum()) == int((wq != 0).sum())


@pytest.mark.parametrize("geom", [dict(pad_lo=1, pad_hi=1), dict(stride=2, pad_lo=1, pad_hi=1),
                                  dict(dilation=2, pad_lo=2, pad_hi=2)],
                         ids=["same", "stride2", "dilation2"])
def test_image_conv_is_the_plain_conv(geom):
    """N2's decomposition of a conv from its operands (codes with channels padded to
    16, the weight image) equals the plain version."""
    gen = torch.Generator().manual_seed(3)
    xq, wq = _codes(gen, 2, 9, 11, 40), _codes(gen, 3, 3, 40, 130)
    sw = torch.rand(130, generator=gen)
    want = cuda_conv.conv_int8_plain(xq, wq, sw, torch.float32, **geom)
    got = cuda_conv.conv_int8_image_plain(xq, cuda_conv.pack_int8_image(wq), sw,
                                          torch.float32, 3, **geom)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,c,o", [(3, 256, 256), (3, 40, 48), (1, 64, 130), (4, 64, 300)])
def test_weight_image_unpacks_to_the_packed_codes(k, c, o):
    """(d) The plain unpacking of N3's B layout gives ``pack_int8_weights``' (O, Kp) back,
    zero codes past Kp; the image is O-tiles x K-blocks of (bn, 128) swizzled tiles."""
    gen = torch.Generator().manual_seed(k + c + o)
    wq = _codes(gen, k, k, c, o)
    plan = cuda_conv.int8_plan(c, k, o)
    img = cuda_conv.pack_int8_image(wq)
    assert img.dtype == torch.int8
    assert img.numel() == plan.phases * plan.o_tiles * plan.k_img * plan.bn
    mats = cuda_conv.unpack_int8_image(img, plan, o)
    packed, cp, kp = cuda_conv.pack_int8_weights(wq)
    assert cp == plan.cp and mats.shape == (1, o, plan.k_img)
    assert torch.equal(mats[0, :, :kp], packed)
    assert not mats[0, :, kp:].any()
    # Rows past O are zero codes.
    assert int((img != 0).sum()) == int((packed != 0).sum())


def test_swizzle_is_the_128_byte_pattern():
    """The tile layout both kernels agree on: 8-row atoms of 1,024 bytes, 16-byte chunk j
    of row r at chunk j ^ (r % 8) of the row's 128 bytes, a permutation of the tile."""
    for bn in (64, 128, 256):
        off = cuda_conv._swizzle(bn)
        assert sorted(off.reshape(-1).tolist()) == list(range(bn * 128))
        r = torch.arange(bn)[:, None]
        assert torch.equal(off // 128, r.expand(bn, 128))
        assert torch.equal((off % 128) // 16, (torch.arange(128)[None] // 16) ^ (r % 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transpose"])
def test_n3_plain_version_is_the_tier_quantization(dtype, transposed):
    """N3's wrapper on CPU tensors: the x codes of ``quantize_int8`` with the channels
    padded by zero codes, its sw, and its weight codes as the image; a transposed
    conv's weight is read flipped (``flip``) and split into its phases."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy((rng.randn(2, 6, 5, 40) * 3).astype(np.float32)).to(dtype)
    shape = (40, 48, 4, 4) if transposed else (48, 40, 4, 4)  # (in, out, ..) / OIHW
    w = torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32)).to(dtype)
    w_hwio = w.permute(2, 3, 0, 1) if transposed else w.permute(2, 3, 1, 0)
    s, lo = (2, 2) if transposed else (1, 0)
    xq, img, sw = cuda_conv.quantize_int8_packed(x, w_hwio, flip=transposed, in_dilation=s,
                                                 pad_lo=lo)
    kernel = w_hwio.flip(0, 1) if transposed else w_hwio
    xq0, wq0, sw0 = layers.quantize_int8(x, kernel)
    assert xq.shape == (2, 6, 5, 48) and torch.equal(xq[..., :40], xq0)
    assert not xq[..., 40:].any()
    assert torch.equal(sw, sw0)
    assert torch.equal(img, cuda_conv.pack_int8_image(wq0, s, lo))
    # The tier's conv from these operands is the CPU composition.
    geom = dict(pad_lo=lo, pad_hi=lo, in_dilation=s) if transposed else dict(pad_lo=1, pad_hi=1)
    via_image = cuda_conv.conv_int8_image_plain(xq, img, sw, dtype, 4, **geom)
    assert torch.equal(via_image, cuda_conv.conv_int8_quantized(x, w_hwio, dtype, flip=transposed,
                                                                **geom))


SCENE_PLANS = {  # (C_in, k, C_out, stride of a transposed conv): (bn, taps, k_img, o_tiles)
    "icn_trunk": ((256, 3, 256, 1), (256, 3, 2304, 1)),
    "icn_up1_packed": ((256, 3, 512, 1), (256, 3, 2304, 2)),
    "icn_up2_packed": ((128, 3, 256, 1), (256, 3, 1152, 1)),
    "icn_down": ((64, 4, 128, 1), (128, 4, 1024, 1)),
    "hourglass_1x1": ((64, 1, 128, 1), (128, 1, 128, 1)),
    "vgg_64": ((64, 3, 64, 1), (64, 3, 640, 1)),
    "edgeconnect_decoder": ((256, 4, 128, 2), (128, 2, 1024, 1)),
    "maskrcnn_conv5_mask": ((256, 2, 256, 2), (256, 1, 256, 1)),
}


@pytest.mark.parametrize("name", list(SCENE_PLANS))
def test_int8_plan_on_the_scene_shapes(name):
    """(e) ``int8_plan`` at the quantized scene's and erase's conv shapes: one route
    (wgmma, 128-pixel tiles), 128 output channels a tile above 64 outputs and 256 above
    128, K-blocks of
    128 codes, a transposed conv as stride^2 phases of ceil(k / stride)^2 taps, and a
    ring that fits one block's shared memory."""
    (c, k, o, s), (bn, taps, k_img, o_tiles) = SCENE_PLANS[name]
    plan = cuda_conv.int8_plan(c, k, o, s)
    assert (plan.bn, plan.taps, plan.k_img, plan.o_tiles) == (bn, taps, k_img, o_tiles)
    assert plan.phases == s * s and plan.bk == 128 and plan.cp == c
    assert plan.smem == plan.stages * (128 + bn) * 128 + 1024 + 16 * plan.stages
    assert plan.smem <= SMEM_LIMIT


def test_tier_wrappers_refuse_other_devices():
    """No device but the CPU (plain versions) and CUDA (kernels) is taken."""
    x = torch.zeros(1, 4, 4, 32, device="meta")
    w = torch.zeros(3, 3, 32, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv.conv_int8_quantized(x, w, torch.float32, pad_lo=1, pad_hi=1)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv.conv_int8(x.to(torch.int8), w.to(torch.int8),
                            torch.ones(32, device="meta"), torch.float32)
