"""Kernel K2 of the PyTorch port (ops/cuda_conv.py) against the JAX package's fused
ICN stem (ops/pallas_conv.icn_stem_conv_fused) in interpret mode.

On the CPU the port's wrapper runs its plain version (reflect-pad, concat, repeat,
F.conv2d in float32); the CUDA kernel is held against that plain version on the
GPU by chip_smoke.py. Tolerance: atol 3e-5, as tests/test_layers.py:294 holds the
Pallas kernel against the concat conv (float32 sums of up to 1,029 terms).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops.pallas_conv import icn_stem_conv_fused
from future_urban_scene_generation_tpu_torch.ops import cuda_conv


@pytest.mark.parametrize("v,s,h,w,p,k,o,pad", [
    (2, 2, 24, 26, 5, 7, 16, 3),
    (1, 3, 18, 20, 5, 7, 8, 3),
    (3, 1, 21, 19, 2, 5, 8, 2),
])
def test_plain_stem_matches_pallas_fused(v, s, h, w, p, k, o, pad):
    rng = np.random.RandomState(11)
    n = v * s
    c = 3 * (2 + p)
    sketch = rng.rand(n, h, w, 3).astype(np.float32)
    central = rng.rand(v, h, w, 3).astype(np.float32)
    planes = rng.rand(n, p, h, w, 3).astype(np.float32)
    kern = (rng.rand(k, k, c, o) - 0.5).astype(np.float32)
    ref = icn_stem_conv_fused(
        jnp.asarray(sketch), jnp.asarray(central), jnp.asarray(planes), jnp.asarray(kern),
        pad=pad, s_repeat=s, interpret=True,
    )
    got = cuda_conv.icn_stem_conv(
        torch.as_tensor(sketch), torch.as_tensor(central), torch.as_tensor(planes),
        torch.as_tensor(kern), pad=pad, s_repeat=s,
    )
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_plain_stem_bf16_returns_input_dtype():
    """bf16 pieces compute in float32 and round once on output, as the kernel."""
    rng = np.random.RandomState(3)
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    sk, ce, pl = t(rng.rand(4, 12, 12, 3)), t(rng.rand(2, 12, 12, 3)), t(rng.rand(4, 5, 12, 12, 3))
    kern = t(rng.rand(7, 7, 21, 64) - 0.5)
    out16 = cuda_conv.icn_stem_conv(*(x.bfloat16() for x in (sk, ce, pl, kern)), s_repeat=2)
    out32 = cuda_conv.icn_stem_conv(*(x.bfloat16().float() for x in (sk, ce, pl, kern)),
                                    s_repeat=2)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, out32.bfloat16())


def test_kernel_shape_checks():
    """What the CUDA kernel cannot take is refused before launch."""
    z = torch.zeros
    good = (z(2, 8, 8, 3), z(1, 8, 8, 3), z(2, 5, 8, 8, 3), z(7, 7, 21, 64))
    cuda_conv._check(*good, pad=3, s_repeat=2)
    cuda_conv._check(*good[:3], z(7, 7, 21, 32), pad=3, s_repeat=2)  # any O since the shared core
    cuda_conv._check(*(t.bfloat16() for t in good), pad=3, s_repeat=2)
    wide = (z(2, 40, 40, 3), z(1, 40, 40, 3), z(2, 19, 40, 40, 3), z(15, 15, 63, 64))
    with pytest.raises(ValueError):  # 15 x 15 x 63: the float32 patch exceeds 232,448 B
        cuda_conv._check(*wide, pad=7, s_repeat=2)
    with pytest.raises(ValueError):  # ... and so do the bf16 patches beside one weight row
        cuda_conv._check(*(t.bfloat16() for t in wide), pad=7, s_repeat=2)
    with pytest.raises(ValueError):
        cuda_conv._check(*good, pad=3, s_repeat=1)  # central batch mismatch
    with pytest.raises(ValueError):
        cuda_conv._check(z(2, 3, 3, 3), z(1, 3, 3, 3), z(2, 5, 3, 3, 3), z(7, 7, 21, 64),
                         pad=3, s_repeat=2)  # reflect pad >= size
    with pytest.raises(ValueError):
        cuda_conv.icn_stem_conv(*(x.to("meta") for x in good), s_repeat=2)
