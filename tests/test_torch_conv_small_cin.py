"""Kernel K3 and K4's entry of the PyTorch port (ops/cuda_conv.py) against the JAX
package's Pallas small-C_in convolutions (ops/pallas_conv.conv_small_cin_v2 and
conv_small_cin) in interpret mode, and the conv gate that routes to K3.

On the CPU the port's wrappers run their plain version (``F.conv2d`` in float32);
the CUDA kernel is held against that plain version on the GPU by chip_smoke.py.
Tolerance: atol 3e-5, as tests/test_layers.py:232,255 hold the Pallas kernels
against the XLA conv (float32 sums of up to 1,029 terms). The shapes are that
test's three cases, O = 12 among them.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import pallas_conv
from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet
from future_urban_scene_generation_tpu_torch.models.icn import DNLayersMulti, GResnet
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet
from future_urban_scene_generation_tpu_torch.ops import cuda_conv
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
import torch_threads  # noqa: F401

SHAPES = [  # (n, hp, wp, c, k, o, rows) of tests/test_layers.py:222-224
    (2, 22, 26, 21, 7, 16, 8),
    (1, 19, 20, 3, 3, 8, 8),
    (2, 38, 34, 6, 5, 12, 16),
]
ENTRIES = [  # (port wrapper, JAX Pallas original)
    ("conv_small_cin_v2", "conv_small_cin_v2"),  # K3
    ("conv_small_cin", "conv_small_cin"),  # K4
]


@pytest.mark.parametrize("entry", ENTRIES, ids=[e[0] for e in ENTRIES])
@pytest.mark.parametrize("shape", SHAPES, ids=["stem7", "k3c3", "k5o12"])
def test_plain_matches_pallas(entry, shape):
    n, h, w, c, k, o, rows = shape
    rng = np.random.RandomState(5)
    x = rng.rand(n, h, w, c).astype(np.float32)
    kern = (rng.rand(k, k, c, o) - 0.5).astype(np.float32)
    ref = getattr(pallas_conv, entry[1])(jnp.asarray(x), jnp.asarray(kern), rows=rows,
                                         interpret=True)
    got = getattr(cuda_conv, entry[0])(torch.as_tensor(x), torch.as_tensor(kern))
    assert got.shape == ref.shape == (n, h - k + 1, w - k + 1, o)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_plain_bf16_returns_input_dtype():
    """bf16 inputs compute in float32 and round once on output, as the kernel."""
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.rand(2, 14, 15, 21).astype(np.float32)).bfloat16()
    kern = torch.as_tensor((rng.rand(7, 7, 21, 64) - 0.5).astype(np.float32)).bfloat16()
    out16 = cuda_conv.conv_small_cin_v2(x, kern)
    assert out16.dtype == torch.bfloat16
    assert torch.equal(out16, cuda_conv.conv_small_cin_v2(x.float(), kern.float()).bfloat16())


def test_autograd_function_gradcheck():
    """The gated conv's Function: K3 forward (the plain version here), the plain
    conv's gradients for x and w, against finite differences in float64."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 7, 20, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(3, 20, 7, 7, dtype=torch.float64, generator=gen, requires_grad=True)
    # fast_mode: finite differences along random directions, not element by element
    # (thousands of tiny convs, minutes on a loaded CPU).
    assert torch.autograd.gradcheck(lambda a, b: layers._SmallCinConv.apply(a, b, 2), (x, w),
                                    fast_mode=True)
    # ... and through a gated float32 Conv2d, equal to F.conv2d's autograd (float32
    # sums in different orders: torch's default float32 tolerances).
    assert layers.small_cin_gate(20, 7, 1, torch.float32)
    assert not layers.small_cin_gate(20, 7, 1, torch.float64)  # K3 takes f32 / bf16
    x = x.detach().float().requires_grad_()
    conv = layers.Conv2d(20, 3, 7, padding=2)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.normal_(generator=gen)
    y = conv(x)
    gx, gw, gb = torch.autograd.grad(y.square().sum(), (x, conv.weight, conv.bias))
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=2)
    rx, rw, rb = torch.autograd.grad(ref.square().sum(), (x, conv.weight, conv.bias))
    torch.testing.assert_close(y, ref.permute(0, 2, 3, 1))
    for a, b in ((gx, rx), (gw, rw), (gb, rb)):
        torch.testing.assert_close(a, b)


def _admitted(net):
    """Names of the Conv2d / WNConv2d modules of ``net`` that pass the K3 gate."""
    out, seen = set(), set()
    for name, m in net.named_modules():
        if isinstance(m, (layers.Conv2d, layers.WNConv2d)):
            seen.add(type(m))
            w = m.weight if isinstance(m, layers.Conv2d) else m.weight_v
            if layers.small_cin_gate(w.shape[1], w.shape[-1], m.stride):
                out.add(name)
    return out, seen


def test_gate_admits_the_icn_stem_and_nothing_else():
    """At real channel widths, in the four scene networks and the discriminator,
    the ICN stem (7x7, C_in 21) is the one conv that goes to K3."""
    nets = {
        "vgg": VGG19Classifier(10), "hourglass": HourglassNet(), "icn": GResnet(21),
        "vunet": Vunet(vunet_256=True), "dis": DNLayersMulti(3, ndf=64),
    }
    kinds = set()
    for name, net in nets.items():
        admitted, seen = _admitted(net)
        kinds |= seen
        assert admitted == ({"enc_content.model.0.conv"} if name == "icn" else set()), name
    assert kinds == {layers.Conv2d, layers.WNConv2d}


def test_scene_path_stays_on_k2(monkeypatch):
    """A full GResnet forward sends its stem to K3 once; the scene's ICN
    (stem on K2, then ``from_stem``) and the discriminator never reach K3."""
    calls = []
    real = cuda_conv.conv_small_cin_v2
    monkeypatch.setattr(cuda_conv, "conv_small_cin_v2",
                        lambda x, k: calls.append(tuple(x.shape)) or real(x, k))
    gen = torch.Generator().manual_seed(1)
    models = stages.Models.build(ModelSpec(), gen, device="cpu")
    x = torch.rand(2, 32, 32, 21, generator=gen) * 2 - 1
    with torch.no_grad():
        models.icn(x)
        assert calls == [(2, 38, 38, 21)]
        calls.clear()
        stages.icn_synthesize_batch(models, ModelSpec(), torch.rand(2, 32, 32, 3, generator=gen),
                                    x[:1, ..., :3], torch.rand(2, 5, 32, 32, 3, generator=gen),
                                    s_repeat=2)
        layers.seeded_init_(DNLayersMulti(3, ndf=64), gen)(x[..., :3])
    assert calls == []


def test_kernel_shape_checks():
    """What the CUDA kernel cannot take is refused before launch."""
    z = torch.zeros
    cuda_conv._check_small_cin(z(2, 10, 10, 21), z(7, 7, 21, 12))
    cuda_conv._check_small_cin(z(1, 20, 20, 32), z(9, 9, 32, 100))  # the largest gated shape
    with pytest.raises(TypeError):
        cuda_conv._check_small_cin(z(1, 9, 9, 3).double(), z(3, 3, 3, 8).double())
    with pytest.raises(TypeError):
        cuda_conv._check_small_cin(z(1, 9, 9, 3), z(3, 3, 3, 8).bfloat16())
    with pytest.raises(ValueError):
        cuda_conv._check_small_cin(z(1, 9, 9, 3), z(3, 3, 4, 8))  # C mismatch
    with pytest.raises(ValueError):
        cuda_conv._check_small_cin(z(1, 5, 9, 3), z(7, 7, 3, 8))  # input < kernel
    big = (z(1, 20, 20, 32).bfloat16(), z(9, 9, 32, 100).bfloat16())
    cuda_conv._check_small_cin(*big)  # bf16: its weights staged a kernel row at a time
    with pytest.raises(ValueError):
        cuda_conv._check_small_cin(z(1, 40, 40, 64), z(15, 15, 64, 64))  # shared memory, f32
    with pytest.raises(ValueError):
        cuda_conv._check_small_cin(z(1, 40, 40, 64).bfloat16(),
                                   z(15, 15, 64, 64).bfloat16())  # shared memory, bf16
    with pytest.raises(ValueError):
        cuda_conv._check_small_cin(z(70000, 9, 9, 3), z(3, 3, 3, 8))  # float32 grid z
    for fn in (cuda_conv.conv_small_cin_v2, cuda_conv.conv_small_cin):
        with pytest.raises(ValueError):
            fn(z(1, 9, 9, 3, device="meta"), z(3, 3, 3, 8, device="meta"))
