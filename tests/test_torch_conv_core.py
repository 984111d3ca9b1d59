"""The index arithmetic of the shared conv core of the PyTorch port (csrc/conv_core.cuh,
kernels K2, K3 and K4's entry), held on the CPU through its torch mirror.

``cuda_conv.conv_sliding_plain`` computes the conv exactly by the tensor-core kernel's
decomposition — channels padded to a multiple of 8, per-ky runs rounded up to a
multiple of 16 with zero weight rows, the overrun read from the next pixel, the next
patch row or the tail — and ``cuda_conv.stem_gather_plain`` addresses K2's three
tensors as the kernel's loader does (reflect index, ``n // s_repeat``, channel ->
piece). Both are held against the plain versions and against the JAX package's Pallas
kernels in interpret mode, on the same numpy-seeded inputs. Tolerance: float32 atol
3e-5, as tests/test_layers.py:294 holds the Pallas kernels (sums of up to 1,029
terms); against the float64 plain version 1e-12.

``cuda_conv.conv_plan`` is the one dispatch between the hand-written main loops
(bf16 -> tensor cores by wgmma or mma.sync, float32 -> CUDA cores) and the
shared-memory size each launch asks for; it is walked over every shape the conv gate
admits.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import pallas_conv
from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.ops import cuda_conv

SHAPES = {  # (n, hp, wp, c, k, o, rows of the Pallas kernel)
    "stem7": (2, 22, 26, 21, 7, 16, 8),  # tests/test_layers.py:222-224
    "k3c3": (1, 19, 20, 3, 3, 8, 8),
    "k5o12": (2, 38, 34, 6, 5, 12, 16),
    "ragged": (1, 41, 30, 21, 7, 64, 5),  # 35 x 24 outputs: 3 x 2 tiles, both edges ragged
    "gate_max": (1, 25, 27, 32, 9, 64, None),  # the largest k and C the gate admits
    "odd_o": (2, 20, 23, 8, 2, 5, None),  # k * cp = 16: a run without overrun
}


def _inputs(shape, seed=5):
    n, h, w, c, k, o, _ = shape
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, c).astype(np.float32),
            (rng.rand(k, k, c, o) - 0.5).astype(np.float32))


@pytest.mark.parametrize("name", list(SHAPES))
def test_sliding_matches_plain(name):
    """Exact in float64: the decomposition adds only products with zero."""
    x, kern = (torch.as_tensor(a).double() for a in _inputs(SHAPES[name]))
    got = cuda_conv.conv_sliding_plain(x, kern)
    ref = cuda_conv.conv_small_cin_plain(x, kern)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("entry", ["conv_small_cin_v2", "conv_small_cin"])
@pytest.mark.parametrize("name", ["stem7", "k3c3", "k5o12", "ragged"])
def test_sliding_matches_pallas(entry, name):
    shape = SHAPES[name]
    x, kern = _inputs(shape)
    ref = getattr(pallas_conv, entry)(jnp.asarray(x), jnp.asarray(kern), rows=shape[6],
                                      interpret=True)
    got = cuda_conv.conv_sliding_plain(torch.as_tensor(x), torch.as_tensor(kern))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_sliding_bf16_rounds_once():
    """bf16 inputs: float32 products and sums, one rounding on output, as the kernel."""
    x, kern = (torch.as_tensor(a).bfloat16() for a in _inputs(SHAPES["stem7"], seed=3))
    out = cuda_conv.conv_sliding_plain(x, kern)
    assert out.dtype == torch.bfloat16
    ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
    bound = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()  # chip_smoke.py's bf16 bound
    assert bool(((out.double() - ref).abs() <= bound).all())


def test_overrun_meets_zero_weight_rows():
    """The run's overrun reads real neighbouring data: only the zero rows of the packed
    weights keep it out of the sum. With a constant input every run is full of ones, so
    the output is the kernel's plain sum — any weight in a pad row would add to it."""
    n, h, w, c, k, o, _ = SHAPES["stem7"]
    kern = torch.as_tensor(_inputs(SHAPES["stem7"])[1]).double()
    plan = cuda_conv.conv_plan(torch.bfloat16, c, k, o)
    assert (plan.cp, plan.kr) == (24, 176) and plan.kr > k * plan.cp  # 8 overrun elements
    out = cuda_conv.conv_sliding_plain(torch.ones(n, h, w, c, dtype=torch.float64), kern)
    torch.testing.assert_close(out, kern.sum((0, 1, 2)).expand_as(out), rtol=0, atol=1e-12)


STEM_CASES = [  # (v, s, h, w, p, k, o, pad) of tests/test_torch_stem_conv.py, + ragged tiles
    (2, 2, 24, 26, 5, 7, 16, 3),
    (1, 3, 18, 20, 5, 7, 8, 3),
    (3, 1, 21, 19, 2, 5, 8, 2),
    (1, 2, 33, 37, 5, 7, 64, 3),
]


def _stem_inputs(case):
    v, s, h, w, p, k, o, pad = case
    rng = np.random.RandomState(11)
    n, c = v * s, 3 * (2 + p)
    return (rng.rand(n, h, w, 3).astype(np.float32), rng.rand(v, h, w, 3).astype(np.float32),
            rng.rand(n, p, h, w, 3).astype(np.float32),
            (rng.rand(k, k, c, o) - 0.5).astype(np.float32))


@pytest.mark.parametrize("case", STEM_CASES, ids=["s2", "s3", "s1k5", "ragged"])
def test_stem_sliding_matches_plain_and_pallas(case):
    s, pad = case[1], case[-1]
    arrays = _stem_inputs(case)
    got64 = cuda_conv.icn_stem_sliding_plain(*(torch.as_tensor(a).double() for a in arrays),
                                             pad=pad, s_repeat=s)
    ref64 = cuda_conv.icn_stem_conv_plain(*(torch.as_tensor(a).double() for a in arrays),
                                          pad=pad, s_repeat=s)
    torch.testing.assert_close(got64, ref64, rtol=0, atol=1e-12)
    ref = pallas_conv.icn_stem_conv_fused(*(jnp.asarray(a) for a in arrays), pad=pad,
                                          s_repeat=s, interpret=True)
    got = cuda_conv.icn_stem_sliding_plain(*(torch.as_tensor(a) for a in arrays), pad=pad,
                                           s_repeat=s)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_stem_gather_is_the_padded_concat():
    """The loader's addressing against reflect-pad of the concat, bit for bit."""
    sk, ce, pl, _ = (torch.as_tensor(a) for a in _stem_inputs(STEM_CASES[0]))
    n, h, w, _ = sk.shape
    cat = torch.cat([sk, ce.repeat_interleave(2, 0),
                     pl.permute(0, 2, 3, 1, 4).reshape(n, h, w, 15)], dim=-1)
    ref = torch.nn.functional.pad(cat.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
    assert torch.equal(cuda_conv.stem_gather_plain(sk, ce, pl, 3, 2), ref.permute(0, 2, 3, 1))


def _gate_shapes():
    return [(c, k) for k in range(2, 10) for c in range(1, 33)
            if layers.small_cin_gate(c, k, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_covers_the_gate(dtype):
    """Every shape the gate admits, at any O, is routed to one of the two main loops
    and fits the 232,448 bytes of shared memory a block may use."""
    shapes = _gate_shapes()
    assert (21, 7) in shapes and (32, 9) in shapes and len(shapes) == 68
    for c, k in shapes:
        for o in (1, 5, 12, 16, 17, 64, 100, 512):
            plan = cuda_conv.conv_plan(dtype, c, k, o)
            if dtype == torch.float32:
                assert plan.route == "fma"
            else:  # wgmma takes the 7 x 7 kernels with wide tiles that fit (C <= 24)
                fits = o > 16 and k == 7 and plan.cp <= 24
                assert plan.route == ("wgmma" if fits else "mma")
                assert plan.resident or (o > 16 and k >= 7)  # only these stage ky rows
            assert plan.otile == (64 if o > 16 else 16)
            assert 0 < plan.smem <= cuda_conv._SMEM_LIMIT, (c, k, o, plan)
            cuda_conv._check_launch("gate", dtype, 8, c, k, o)


def test_plan_of_the_main_path_and_the_ring():
    stem = cuda_conv.conv_plan(torch.bfloat16, 21, 7, 64)
    # 77 steps x 2,048 B of weights resident beside two 22 x 22 x 24 patches and tails.
    assert stem == cuda_conv.ConvPlan("wgmma", 64, 157_696 + 2 * 23_248, True, 24, 176)
    narrow = cuda_conv.conv_plan(torch.bfloat16, 21, 7, 16)
    assert narrow == cuda_conv.ConvPlan("mma", 16, 7 * 176 * 24 * 2 + 2 * 23_248, True, 24, 176)
    big = cuda_conv.conv_plan(torch.bfloat16, 32, 9, 64)
    assert big.route == "mma" and not big.resident and big.kr == 288
    assert big.smem == 288 * 72 * 2 + 2 * (24 * 24 * 32 * 2 + 16)
    f32 = cuda_conv.conv_plan(torch.float32, 21, 7, 64)
    assert (f32.route, f32.smem) == ("fma", (22 * 22 * 21 + 4 * 21 * 64) * 4)
    # Two float32 blocks share an SM (228 KB, 1 KB reserved a block).
    assert 2 * (f32.smem + 1024) <= 228 * 1024
    with pytest.raises(TypeError):
        cuda_conv.conv_plan(torch.float64, 21, 7, 64)
