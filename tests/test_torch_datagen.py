"""The PyTorch port's ICN pair maker against the JAX package's ``icn_batch``.

The JAX key's own draws (CAD index, pose, heading delta) are re-derived here through
``jax.random.split`` and ``datagen._random_pose``, exactly as ``icn_batch`` makes
them, and fed to the port's deterministic pair maker. Inputs and targets agree
within 5e-3 on >= 99.5% of values (the bar of tests/test_torch_pipeline.py):
sketch-edge, polygon-edge and mask pixels may flip on last-bit differences.
Bank and sizes as tests/test_datagen.py: a subdiv-1 bank, vis_res 128.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.pipeline import datagen as jdatagen
from future_urban_scene_generation_tpu.pipeline import runner as jrunner
from future_urban_scene_generation_tpu.utils import mesh as jmu
from future_urban_scene_generation_tpu_torch.pipeline import datagen, runner
from future_urban_scene_generation_tpu_torch.utils import mesh as mu
from future_urban_scene_generation_tpu_torch.utils import profiling
import torch_threads  # noqa: F401

K = np.float32([[600.0, 0, 320], [0, 600.0, 180], [0, 0, 1]])
FRAME_HW = (360, 640)


def _jax_draws(key, n_cads, batch):
    """icn_batch's per-sample draws (datagen.py:55-74, 132)."""
    cad, ext, dth = [], [], []
    for k in jax.random.split(key, batch):
        kc, kp_, kd = jax.random.split(k, 3)
        cad.append(int(jax.random.randint(kc, (), 0, n_cads)))
        ext.append(np.asarray(jdatagen._random_pose(kp_, jnp.asarray(K))))
        dth.append(float(jax.random.uniform(kd, (), minval=-0.6, maxval=0.6)))
    return datagen.ICNDraws(torch.as_tensor(cad), torch.as_tensor(np.stack(ext)),
                            torch.as_tensor(np.float32(dth)))


def test_icn_pairs_match_jax_icn_batch():
    frame = np.random.RandomState(0).rand(*FRAME_HW, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jmesh, jkp = jmu.make_test_car(subdiv=1)
    ref = jdatagen.icn_batch(key, jrunner.build_cad_bank([jmesh] * 2, [jkp] * 2, scale=5.0),
                             jnp.asarray(frame), jnp.asarray(K), batch=1,
                             frame_hw=FRAME_HW, vis_res=128)
    mesh, kp = mu.make_test_car(subdiv=1)
    bank = runner.build_cad_bank([mesh] * 2, [kp] * 2, scale=5.0, device="cpu")
    with torch.no_grad():
        got = datagen.icn_pairs(bank, torch.as_tensor(frame), torch.as_tensor(K),
                                _jax_draws(key, 2, 1), vis_res=128)
    for name, a, b in (("inputs", got.inputs, ref.inputs), ("targets", got.targets, ref.targets)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all()
        close = (np.abs(a - b) <= 5e-3).mean()
        assert close >= 0.995, (name, close)
    # The sample carries a vehicle and textured planes, not a blank crop.
    assert (got.targets.numpy()[..., 0] > -0.99).mean() > 0.05
    assert (np.abs(got.inputs.numpy()[..., 6:] - got.inputs.numpy()[..., 6:7]) > 0).any()


def test_icn_batch_draws_shapes_and_ranges():
    """The port's own draws: seeded, in the JAX ranges, and distinct per seed."""
    mesh, kp = mu.make_test_car(subdiv=1)
    bank = runner.build_cad_bank([mesh] * 2, [kp] * 2, scale=5.0, device="cpu")
    d = datagen.icn_draws(torch.Generator().manual_seed(0), 2, 64)
    assert d.cad_idx.min() >= 0 and d.cad_idx.max() <= 1
    assert (d.dtheta.abs() <= 0.6).all()
    dist = d.extrinsic[:, 2, 3]
    assert ((dist >= 12) & (dist <= 28)).all()
    assert torch.allclose(d.extrinsic[:, :3, :3] @ d.extrinsic[:, :3, :3].transpose(1, 2),
                          torch.eye(3).expand(64, 3, 3), atol=1e-5)
    frame = torch.rand(*FRAME_HW, 3, generator=torch.Generator().manual_seed(1))
    before = {s.span_id for s in profiling.spans()}
    with torch.no_grad():
        s1 = datagen.icn_batch(torch.Generator().manual_seed(0), bank, frame,
                               torch.as_tensor(K), batch=2, vis_res=128)
        s2 = datagen.icn_batch(torch.Generator().manual_seed(1), bank, frame,
                               torch.as_tensor(K), batch=2, vis_res=128)
    parts = [s.name for s in profiling.spans() if s.span_id not in before]
    assert parts == ["fusg.datagen.draws", "fusg.datagen.views", "fusg.datagen.pairs"] * 2
    assert s1.inputs.shape == (2, 256, 256, 21) and s1.targets.shape == (2, 256, 256, 3)
    assert torch.isfinite(s1.inputs).all() and s1.inputs.abs().max() <= 1.0 + 1e-4
    assert not torch.allclose(s1.inputs, s2.inputs)


def _jax_pose_draws(key, n_cads, batch):
    """cad_batch's / hourglass_batch's per-sample draws (datagen.py:184-187, 212-215)."""
    cad, ext = [], []
    for k in jax.random.split(key, batch):
        kc, kp_ = jax.random.split(k)
        cad.append(int(jax.random.randint(kc, (), 0, n_cads)))
        ext.append(np.asarray(jdatagen._random_pose(kp_, jnp.asarray(K))))
    return datagen.PoseDraws(torch.as_tensor(cad), torch.as_tensor(np.stack(ext)))


def _banks(n=3):
    """A bank of ``n`` distinct subdiv-1 cars in both packages."""
    dims = [dict(length=1.0 + 0.1 * i, width=0.42 + 0.03 * i, height=0.30 + 0.02 * i, subdiv=1)
            for i in range(n)]
    jm = [jmu.make_test_car(**d) for d in dims]
    tm = [mu.make_test_car(**d) for d in dims]
    return (jrunner.build_cad_bank([m for m, _ in jm], [k for _, k in jm], scale=5.0),
            runner.build_cad_bank([m for m, _ in tm], [k for _, k in tm], scale=5.0,
                                  device="cpu"))


def _close_share(a, b, atol=5e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return (np.abs(a - b) <= atol).mean()


def test_vunet_pairs_match_jax_vunet_batch():
    """The port's VUNet pair maker on the JAX key's own draws: >= 99.5% of values
    within 5e-3 (sketch-edge and mask pixels may flip on last-bit differences)."""
    frame = np.random.RandomState(0).rand(*FRAME_HW, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jbank, bank = _banks(2)
    ref = jdatagen.vunet_batch(key, jbank, jnp.asarray(frame), jnp.asarray(K), batch=2,
                               frame_hw=FRAME_HW, vis_res=128)
    with torch.no_grad():
        got = datagen.vunet_pairs(bank, torch.as_tensor(frame), torch.as_tensor(K),
                                  _jax_draws(key, 2, 2))
    for name in ("y_tilde", "x_app", "target"):
        assert _close_share(getattr(got, name), getattr(ref, name)) >= 0.995, name
    assert got.x_app.shape == (2, 256, 256, 6) and float(got.x_app.abs().max()) <= 1.0 + 1e-5
    assert (got.target[..., 0] > -0.99).float().mean() > 0.05  # a vehicle, not a blank crop
    # outside the src vehicle the appearance crop is white
    assert float((got.x_app[..., :3] == 1.0).float().mean()) > 0.3


def test_cad_and_hourglass_pairs_match_jax():
    """The classifier's and the hourglass's pair makers on the JAX key's own draws:
    labels equal, sketches as above, keypoints within 1e-4 of a crop side."""
    key = jax.random.PRNGKey(6)
    jbank, bank = _banks(3)
    draws = _jax_pose_draws(key, 3, 3)
    ref_c = jdatagen.cad_batch(key, jbank, jnp.asarray(K), batch=3)
    ref_h = jdatagen.hourglass_batch(key, jbank, jnp.asarray(K), batch=3)
    with torch.no_grad():
        got_c = datagen.cad_pairs(bank, torch.as_tensor(K), draws)
        got_h = datagen.hourglass_pairs(bank, torch.as_tensor(K), draws)
    assert got_c.labels.dtype == torch.int64
    np.testing.assert_array_equal(got_c.labels.numpy(), np.asarray(ref_c.labels))
    assert _close_share(got_c.images, ref_c.images) >= 0.995
    assert _close_share(got_h.images, ref_h.images) >= 0.995
    np.testing.assert_allclose(got_h.kp_norm.numpy(), np.asarray(ref_h.kp_norm), atol=1e-4)
    assert got_h.kp_norm.shape == (3, 12, 2)
    assert float(got_h.kp_norm.min()) >= 0.0 and float(got_h.kp_norm.max()) <= 1.0
    # tests/test_datagen.py:71: the keypoints lie on the rendered vehicle
    on = 0
    for b in range(3):
        px = (got_h.kp_norm[b] * 255).long().clamp(0, 255)
        on += int((got_h.images[b, px[:, 1], px[:, 0]].sum(-1) > 0).sum())
    assert on >= 3 * 6


def test_new_batches_draw_seeded_and_in_range():
    """The port's own draws for the three families: seeded, distinct per seed, one
    K1 render a batch (on the CPU: its plain version), shapes as the JAX samples."""
    _, bank = _banks(3)
    k = torch.as_tensor(K)
    frame = torch.rand(*FRAME_HW, 3, generator=torch.Generator().manual_seed(1))
    d = datagen.pose_draws(torch.Generator().manual_seed(0), 3, 64)
    assert set(d.cad_idx.tolist()) == {0, 1, 2}
    assert ((d.extrinsic[:, 2, 3] >= 12) & (d.extrinsic[:, 2, 3] <= 28)).all()
    with torch.no_grad():
        c1 = datagen.cad_batch(torch.Generator().manual_seed(0), bank, k, batch=2)
        c2 = datagen.cad_batch(torch.Generator().manual_seed(0), bank, k, batch=2)
        h = datagen.hourglass_batch(torch.Generator().manual_seed(1), bank, k, batch=2)
        v = datagen.vunet_batch(torch.Generator().manual_seed(2), bank, frame, k, batch=2)
    assert torch.equal(c1.images, c2.images) and torch.equal(c1.labels, c2.labels)
    assert c1.images.shape == h.images.shape == (2, 256, 256, 3)
    assert not torch.equal(c1.images, h.images)
    assert v.y_tilde.shape == v.target.shape == (2, 256, 256, 3)
    assert all(bool(torch.isfinite(t).all()) for t in (*c1[:1], *h, *v))
