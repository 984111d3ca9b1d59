"""The image metrics of the PyTorch port (``ops/metrics.py``) against the JAX
package's (``ops/metrics.py``) on the CPU, rtol 1e-5, and the properties of
tests/test_metrics_native.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu.ops import metrics as jm
from future_urban_scene_generation_tpu_torch.ops import metrics as M
import torch_threads  # noqa: F401

rng = np.random.RandomState(40)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def test_psnr_matches_jax():
    a = (rng.rand(32, 40, 3) * 255).astype(np.float32)
    b = np.clip(a + rng.randn(32, 40, 3).astype(np.float32) * 7.0, 0, 255)
    for x, y, max_val in ((a, b, 255.0), (a / 255, b / 255, 1.0), (a, a + 10.0, 255.0)):
        np.testing.assert_allclose(float(M.psnr(_t(x), _t(y), max_val)),
                                   float(jm.psnr(jnp.asarray(x), jnp.asarray(y), max_val)),
                                   rtol=1e-5)
    expected = 20 * np.log10(255) - 10 * np.log10(100)  # MSE 100
    assert abs(float(M.psnr(_t(a), _t(a + 10.0))) - expected) < 1e-3
    assert float(M.psnr(_t(a), _t(a))) == 0.0  # the reference's identical-image case


def test_edge_accuracy_matches_jax():
    labels = (rng.rand(24, 24) > 0.8).astype(np.float32)
    preds = np.clip(labels * 0.7 + rng.rand(24, 24) * 0.5, 0, 1).astype(np.float32)
    empty = np.zeros((8, 8), np.float32)
    for x, y in ((labels, preds), (labels, labels), (empty, empty), (empty, preds[:8, :8])):
        got = M.edge_accuracy(_t(x), _t(y))
        want = jm.edge_accuracy(jnp.asarray(x), jnp.asarray(y))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    p0, r0 = M.edge_accuracy(_t(empty), _t(empty))
    assert float(p0) == 1.0 and float(r0) == 1.0


@pytest.mark.parametrize("shape", [(40, 48), (40, 48, 3)])
def test_ssim_and_ssim_map_match_jax(shape):
    img = rng.rand(*shape).astype(np.float32)
    noisy = np.clip(img + rng.randn(*shape).astype(np.float32) * 0.1, 0, 1)
    got_map = M.ssim_map(_t(img), _t(noisy)).numpy()
    want_map = np.asarray(jm.ssim_map(jnp.asarray(img), jnp.asarray(noisy)))
    assert got_map.shape == want_map.shape == (shape[0] - 10, shape[1] - 10)
    np.testing.assert_allclose(got_map, want_map, rtol=1e-5, atol=1e-6)
    got = float(M.ssim(_t(img), _t(noisy)))
    np.testing.assert_allclose(got, float(jm.ssim(jnp.asarray(img), jnp.asarray(noisy))),
                               rtol=1e-5)
    np.testing.assert_allclose(got, got_map.mean(), rtol=1e-5)
    assert float(M.ssim(_t(img), _t(img))) > 0.9999
    slight = np.clip(img + rng.randn(*shape).astype(np.float32) * 0.01, 0, 1)
    assert float(M.ssim(_t(img), _t(slight))) > got
