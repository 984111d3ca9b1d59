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
    bank = runner.build_cad_bank([mesh] * 2, [kp] * 2, scale=5.0)
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
    bank = runner.build_cad_bank([mesh] * 2, [kp] * 2, scale=5.0)
    d = datagen.icn_draws(torch.Generator().manual_seed(0), 2, 64)
    assert d.cad_idx.min() >= 0 and d.cad_idx.max() <= 1
    assert (d.dtheta.abs() <= 0.6).all()
    dist = d.extrinsic[:, 2, 3]
    assert ((dist >= 12) & (dist <= 28)).all()
    assert torch.allclose(d.extrinsic[:, :3, :3] @ d.extrinsic[:, :3, :3].transpose(1, 2),
                          torch.eye(3).expand(64, 3, 3), atol=1e-5)
    frame = torch.rand(*FRAME_HW, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        s1 = datagen.icn_batch(torch.Generator().manual_seed(0), bank, frame,
                               torch.as_tensor(K), batch=2, vis_res=128)
        s2 = datagen.icn_batch(torch.Generator().manual_seed(1), bank, frame,
                               torch.as_tensor(K), batch=2, vis_res=128)
    assert s1.inputs.shape == (2, 256, 256, 21) and s1.targets.shape == (2, 256, 256, 3)
    assert torch.isfinite(s1.inputs).all() and s1.inputs.abs().max() <= 1.0 + 1e-4
    assert not torch.allclose(s1.inputs, s2.inputs)
