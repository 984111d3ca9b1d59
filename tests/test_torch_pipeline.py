"""The PyTorch port's scene path end to end against the JAX package.

``synthesize_scene`` on the oracle scene of tests/test_pipeline.py (240x320, a
2-CAD bank at subdiv=2, T=3, V=2 of which one vehicle has NaN keypoints) with the
same JAX-initialized generator weights: frames within 5e-3 on >= 99.5% of pixels
(sketch-edge, polygon-edge and mask-threshold pixels may flip with last-bit
differences), pnp_error at rtol 1e-3, cad_idx equal. Whole-scene ``run_scene``
frames are not compared across frameworks: random-weight keypoints make PnP
chaotic. Instead ``perceive`` is held to JAX in test_torch_models.py, and port
``run_scene`` must equal port ``synthesize_scene(perceive(...))``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.pipeline import runner as jrunner
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "future_urban_scene_generation_tpu_torch"


@pytest.fixture(scope="module")
def oracle():
    sc = synthetic.make_oracle_scene()
    key = jax.random.PRNGKey(0)
    _, _, icnm, vunm = jstages.Models.modules()
    icn_p = icnm.init(key, jnp.zeros((1, 64, 64, 21)))
    vun_p = vunm.init({"params": key}, jnp.zeros((1, 128, 128, 3)),
                      jnp.zeros((1, 128, 128, 6)), cov=0.0)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ours = stages.Models.build(ModelSpec(), torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(ours.icn, np_tree(icn_p))
    convert.load_jax_params(ours.vunet, np_tree(vun_p))
    return sc, jstages.Models(None, None, icn_p, vun_p), ours


def _port_scene(sc, models, spec=ModelSpec()):
    bank = runner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0,
                                 device="cpu")
    t = lambda k: torch.as_tensor(sc[k])  # noqa: E731
    return runner.synthesize_scene(models, bank, t("frame"), t("background"),
                                   synthetic.oracle_perception(sc, device="cpu"),
                                   t("meters"),
                                   t("intrinsic"), spec=spec)


def test_synthesize_scene_matches_jax(oracle):
    sc, jmodels, ours = oracle
    bank_j = jrunner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0)
    bboxes = jnp.asarray(sc["bboxes"])
    window = jax.vmap(jcr.square_window_from_bbox)(bboxes)
    per_j = jstages.Perception(
        cad_idx=jnp.zeros(2, jnp.int32), kp_frame=jnp.asarray(sc["kp2d"]), window=window,
        crop=jnp.zeros((2, 256, 256, 3)),
    )
    ref = jrunner.synthesize_scene(jmodels, bank_j, jnp.asarray(sc["frame"]),
                                   jnp.asarray(sc["background"]), per_j,
                                   jnp.asarray(sc["meters"]), jnp.asarray(sc["intrinsic"]))
    with torch.no_grad():
        got = _port_scene(sc, ours)
    for name in ("frames_icn", "frames_vunet"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape == (3, 240, 320, 3)
        assert np.isfinite(a).all()
        close = (np.abs(a - b).max(-1) <= 5e-3).mean()
        assert close >= 0.995, (name, close)
        assert (np.abs(a - sc["background"]).max(-1) > 0.05).mean() > 0.002  # car drawn
    err_t, err_j = got.pnp_error.numpy(), np.asarray(ref.pnp_error)
    assert np.isnan(err_t[1]) and np.isnan(err_j[1])
    # rtol 1e-3; atol 1e-6 px^2 for the float32 floor of an exact oracle fit.
    np.testing.assert_allclose(err_t[0], err_j[0], rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(got.cad_idx.numpy(), np.asarray(ref.cad_idx))


@torch.no_grad()
def test_fault_barrier_drops_bad_vehicle(oracle):
    """The NaN vehicle contributes nothing: the V=2 scene equals the V=1 scene of
    the good vehicle alone (atol 5e-3, as tests/test_pipeline.py)."""
    sc, _, ours = oracle
    good = dict(sc, **{k: sc[k][:1] for k in ("kp2d", "bboxes", "meters")})
    both = _port_scene(sc, ours)
    alone = _port_scene(good, ours)
    assert torch.isfinite(both.frames_icn).all() and torch.isfinite(both.frames_vunet).all()
    np.testing.assert_allclose(both.frames_icn.numpy(), alone.frames_icn.numpy(), atol=5e-3)
    np.testing.assert_allclose(both.frames_vunet.numpy(), alone.frames_vunet.numpy(),
                               atol=5e-3)


@torch.no_grad()
def test_run_scene_equals_synthesize_of_perceive():
    spec = ModelSpec(warp_plane_res=96)
    sc = synthetic.make_bench_scene(V=1, hw=(200, 280), t_steps=2, subdiv=2, spec=spec, seed=3,
                                    device="cpu")
    args = (sc.models, sc.cad_bank, sc.frame, sc.background)
    res = runner.run_scene(*args, sc.bboxes, sc.meters, sc.intrinsic, spec=spec)
    per = stages.perceive(sc.models, spec, sc.frame, sc.bboxes)
    ref = runner.synthesize_scene(*args, per, sc.meters, sc.intrinsic, spec=spec)
    for a, b in zip(res, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert res.frames_icn.shape == (2, 200, 280, 3)


def test_package_never_imports_jax():
    """No module of the port names jax."""
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.strip().split()
            assert not (words[:1] == ["import"] and any(w.startswith("jax") for w in words[1:2])), path
            assert not (words[:1] == ["from"] and words[1:2] and words[1].startswith("jax")), path


def test_port_runs_with_jax_unimportable():
    """In a fresh interpreter where ``import jax`` fails, the port imports and runs
    a small synthesize_scene on the CPU."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic\n"
        "from future_urban_scene_generation_tpu_torch.spec import ModelSpec\n"
        "sc = synthetic.make_oracle_scene(hw=(96, 128), with_bad_vehicle=False)\n"
        "sc['meters'] = sc['meters'][:, :2]\n"
        "bank = runner.build_cad_bank([sc['mesh']], [sc['kp3d']], device='cpu')\n"
        "models = stages.Models.build(ModelSpec(), torch.Generator().manual_seed(0),\n"
        "    device='cpu')\n"
        "t = lambda k: torch.as_tensor(sc[k])\n"
        "res = runner.synthesize_scene(models, bank, t('frame'), t('background'),\n"
        "    synthetic.oracle_perception(sc, device='cpu'), t('meters'), t('intrinsic'),\n"
        "    spec=ModelSpec(warp_plane_res=96))\n"
        "assert res.frames_icn.shape == (2, 96, 128, 3), res.frames_icn.shape\n"
        "assert bool(torch.isfinite(res.frames_vunet).all())\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU, and in a
    directory holding nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                             cwd=str(cwd), timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
