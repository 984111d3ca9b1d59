"""The inpaint branch's image ops in the PyTorch port (colour conversions, binary
morphology, Canny) against the JAX package's, on the inputs of the JAX package's
own tests (tests/test_colorspace.py, tests/test_crop_canny_morph.py).

Colour and morphology are exact (the colour forms to float32 rounding: the same
arithmetic in another framework). Canny's thresholds flip where float32 sums are
taken in another order, so it is held to the JAX test's budget: under 0.2% of the
pixels may disagree, against JAX, the scipy transcription of skimage
(``canny_oracle``) and the frozen golden file.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from canny_oracle import canny_oracle
from future_urban_scene_generation_tpu.ops import canny as jcn
from future_urban_scene_generation_tpu.ops import colorspace as jcs
from future_urban_scene_generation_tpu.ops import morphology as jmo
from future_urban_scene_generation_tpu_torch.ops import canny as cn
from future_urban_scene_generation_tpu_torch.ops import colorspace as cs
from future_urban_scene_generation_tpu_torch.ops import morphology as mo
import torch_threads  # noqa: F401

CANNY_BUDGET = 0.002  # tests/test_crop_canny_morph.py:166


def _photo(h=96, w=128, seed=3):
    """tests/test_crop_canny_morph.py:149: ramp + disk + rectangle + mild noise."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 0.3 + 0.3 * xx / w + 0.1 * np.sin(yy / 9.0)
    img[(yy - h * 0.4) ** 2 + (xx - w * 0.3) ** 2 < 14 ** 2] = 0.85
    img[int(h * 0.55):int(h * 0.8), int(w * 0.55):int(w * 0.85)] = 0.1
    img += r.randn(h, w).astype(np.float32) * 0.01
    return np.clip(img, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("name", ["rgb_to_gray", "bgr_to_gray", "rgb_to_ycbcr",
                                  "bgr_to_lab", "lab_to_bgr"])
def test_colour_forms_match_jax(name):
    x = np.random.RandomState(0).rand(2, 33, 47, 3).astype(np.float32)
    got = getattr(cs, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 if "ycbcr" in name else 2e-6)


def test_elliptical_kernel_and_dilate_match_jax():
    rng = np.random.RandomState(16)
    for k in (3, 5, 8, 11):
        np.testing.assert_array_equal(mo.elliptical_kernel(k), jmo.elliptical_kernel(k))
    mask = rng.rand(3, 64, 72) > 0.92  # batched over a leading dim
    for k in (3, 8):
        se = mo.elliptical_kernel(k)
        got = mo.dilate(torch.from_numpy(mask), se).numpy()
        want = np.stack([np.asarray(jmo.dilate(jnp.asarray(m), se)) for m in mask])
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)
        got_e = mo.erode(torch.from_numpy(got), se).numpy()
        want_e = np.asarray(jmo.erode(jnp.asarray(want[0]), se))
        np.testing.assert_array_equal(got_e[0], want_e)
    # An asymmetric footprint pins the anchor and the reflection.
    se = np.zeros((4, 4), bool)
    se[0, 1] = se[3, 3] = se[2, 0] = True
    np.testing.assert_array_equal(mo.dilate(torch.from_numpy(mask[0]), se).numpy(),
                                  np.asarray(jmo.dilate(jnp.asarray(mask[0]), se)))


@pytest.mark.parametrize("sigma,masked", [(1.0, False), (2.0, False), (2.0, True)])
def test_canny_matches_jax_and_oracle(sigma, masked):
    img = _photo(seed=5 if masked else 3)
    mask = None
    if masked:
        mask = np.ones(img.shape, bool)
        mask[20:60, 40:90] = False  # the inpaint hole
    got = cn.canny(torch.from_numpy(img), sigma=sigma,
                   mask=None if mask is None else torch.from_numpy(mask)).numpy()
    want = np.asarray(jcn.canny(jnp.asarray(img), sigma=sigma,
                                mask=None if mask is None else jnp.asarray(mask)))
    ref = canny_oracle(img, sigma=sigma, mask=mask)
    assert got.dtype == bool and got.any()
    assert (got != want).mean() < CANNY_BUDGET, ((got != want).sum(), got.sum())
    assert (got != ref).mean() < CANNY_BUDGET
    if masked:
        assert not got[22:58, 42:88].any()


def test_canny_batched_equals_one_by_one_and_golden():
    data = np.load(Path(__file__).parent / "fixtures" / "canny_golden.npz")
    img, mask, sigma = data["image"], data["mask"], float(data["sigma"])
    one = cn.canny(torch.from_numpy(img), sigma=sigma, mask=torch.from_numpy(mask)).numpy()
    assert (one != data["edges"]).mean() < CANNY_BUDGET
    batch = np.stack([img, img[::-1].copy()])
    masks = np.stack([mask, mask[::-1].copy()])
    got = cn.canny(torch.from_numpy(batch), sigma=sigma, mask=torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(got[0], one)
    np.testing.assert_array_equal(
        got[1], cn.canny(torch.from_numpy(batch[1]), sigma=sigma,
                         mask=torch.from_numpy(masks[1])).numpy())


def test_hysteresis_long_chain_and_step_cap():
    """A weak chain of 100 pixels hanging off one strong pixel floods to its end (past
    several 16-step checks) exactly as the JAX ``while_loop``; with fewer steps allowed
    the flood stops at the cap, as the JAX loop's ``max_iters``."""
    weak = np.zeros((1, 8, 120), bool)
    weak[0, 3, 5:105] = True
    strong = np.zeros_like(weak)
    strong[0, 3, 5] = True
    got = cn.hysteresis(torch.from_numpy(weak), torch.from_numpy(strong)).numpy()
    want = np.asarray(jcn._hysteresis(jnp.asarray(weak[0]), jnp.asarray(strong[0])))
    np.testing.assert_array_equal(got[0], want)
    assert got.sum() == 100
    capped = cn.hysteresis(torch.from_numpy(weak), torch.from_numpy(strong), max_steps=40)
    capped_j = np.asarray(jcn._hysteresis(jnp.asarray(weak[0]), jnp.asarray(strong[0]),
                                          max_iters=40))
    np.testing.assert_array_equal(capped.numpy()[0], capped_j)
    assert capped.sum() == 41
