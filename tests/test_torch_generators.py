"""The PyTorch port's generator stages against the JAX package, in float32:
``icn_synthesize_batch`` (stem via kernel K2's plain version, then the network from
the stem) and the VUNet appearance encode + shape decode.

Tolerance atol 2e-3 on the [0, 1] RGB outputs: the bar tests/test_icn.py holds the
JAX networks to against their torch mirrors (deep float32 conv stacks summed in
different orders).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
import torch_threads  # noqa: F401

ATOL = 2e-3


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(1)
    _, _, icnm, vunm = jstages.Models.modules()
    icn_p = icnm.init(key, jnp.zeros((1, 64, 64, 21)))
    vun_p = vunm.init({"params": key}, jnp.zeros((1, 128, 128, 3)),
                      jnp.zeros((1, 128, 128, 6)), cov=0.0)
    jmodels = jstages.Models(None, None, icn_p, vun_p)
    ours = stages.Models.build(ModelSpec(), device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    convert.load_jax_params(ours.icn, np_tree(icn_p))
    convert.load_jax_params(ours.vunet, np_tree(vun_p))
    return jmodels, ours


@pytest.mark.parametrize("v,s,res", [(1, 2, 128), (2, 1, 96)])
@torch.no_grad()
def test_icn_synthesize_batch_matches_jax(models, v, s, res):
    jmodels, ours = models
    rng = np.random.RandomState(13)
    n = v * s
    sketches = rng.rand(n, res, res, 3).astype(np.float32)
    central = (rng.rand(v, res, res, 3) * 2 - 1).astype(np.float32)
    planes = (rng.rand(n, 5, res, res, 3) * 2 - 1).astype(np.float32)
    ref = jstages.icn_synthesize_batch(jmodels, jnp.asarray(sketches), jnp.asarray(central),
                                       jnp.asarray(planes), s_repeat=s)
    got = stages.icn_synthesize_batch(ours, ModelSpec(), torch.as_tensor(sketches),
                                      torch.as_tensor(central), torch.as_tensor(planes),
                                      s_repeat=s)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@torch.no_grad()
def test_vunet_encode_decode_batch_matches_jax(models):
    jmodels, ours = models
    rng = np.random.RandomState(5)
    frame = rng.rand(300, 400, 3).astype(np.float32)
    v, s = 1, 2
    src_sketch = rng.rand(v, 256, 256, 3).astype(np.float32)
    src_mask = rng.rand(v, 256, 256) > 0.5
    win = (np.float32([60.0]), np.float32([20.0]), np.float32([220.0]), np.float32([220.0]))
    dst = rng.rand(v * s, 256, 256, 3).astype(np.float32)

    mu_j = jstages.vunet_encode_appearance_batch(
        jmodels, jnp.asarray(frame), jnp.asarray(src_sketch), jnp.asarray(src_mask),
        jcr.Window(*(jnp.asarray(f) for f in win)),
    )
    out_j = jstages.vunet_decode_batch(
        jmodels, jnp.asarray(dst), jax.tree_util.tree_map(lambda a: jnp.repeat(a, s, 0), mu_j)
    )
    spec = ModelSpec()
    mu_t = stages.vunet_encode_appearance_batch(
        ours, spec, torch.as_tensor(frame), torch.as_tensor(src_sketch),
        torch.as_tensor(src_mask), cr.Window(*(torch.as_tensor(f) for f in win)),
    )
    for a, b in zip(mu_t, mu_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    out_t = stages.vunet_decode_batch(ours, spec, torch.as_tensor(dst),
                                      [m.repeat_interleave(s, 0) for m in mu_t])
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)


@torch.no_grad()
def test_icn_fused_stem_equals_full_forward(models):
    """The scene's ICN path (stem via K2, then ``from_stem``) equals the network's
    own full forward on the concatenated 21-channel input."""
    _, ours = models
    rng = np.random.RandomState(2)
    sk = torch.as_tensor(rng.rand(2, 64, 64, 3).astype(np.float32))
    ce = torch.as_tensor((rng.rand(1, 64, 64, 3) * 2 - 1).astype(np.float32))
    pl = torch.as_tensor((rng.rand(2, 5, 64, 64, 3) * 2 - 1).astype(np.float32))
    got = stages.icn_synthesize_batch(ours, ModelSpec(), sk, ce, pl, s_repeat=2)
    inp = torch.cat([stages._to_signed_lab(sk), ce.repeat_interleave(2, 0),
                     pl.permute(0, 2, 3, 1, 4).reshape(2, 64, 64, 15)], dim=-1)
    full = ours.icn(inp)
    ref = stages.cs.lab_to_rgb((full + 1.0) / 2.0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@torch.no_grad()
def test_icn_bf16_follows_the_mixed_precision_rule(models):
    """bf16 generator spec: conv I/O in bf16, parameters and norm statistics in
    float32, float32 RGB out; quality against float32 at the 35 dB bar of
    tests/test_bf16_inference.py."""
    _, ours = models
    rng = np.random.RandomState(4)
    sk = torch.as_tensor(rng.rand(2, 64, 64, 3).astype(np.float32))
    ce = torch.as_tensor((rng.rand(1, 64, 64, 3) * 2 - 1).astype(np.float32))
    pl = torch.as_tensor((rng.rand(2, 5, 64, 64, 3) * 2 - 1).astype(np.float32))
    f32 = stages.icn_synthesize_batch(ours, ModelSpec(), sk, ce, pl, s_repeat=2)
    bf16 = stages.icn_synthesize_batch(ours, ModelSpec(generator_dtype="bfloat16"),
                                       sk, ce, pl, s_repeat=2)
    assert bf16.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in ours.icn.parameters())
    mse = torch.mean((f32 - bf16) ** 2).item()
    assert 10.0 * np.log10(1.0 / max(mse, 1e-12)) > 35.0
