"""The PyTorch port's geometry, resampling and per-stage functions against the JAX
package on the same numpy inputs: colour space, crops and pastes
(scale_and_translate), rotations, rollout, PnP, homographies, visibility,
render_vehicle, the plane warp and the composite.
"""
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.geometry import homography as jh
from future_urban_scene_generation_tpu.geometry import rotations as jrot
from future_urban_scene_generation_tpu.geometry.trajectory import rollout_from_meters as j_rollout
from future_urban_scene_generation_tpu.ops import colorspace as jcs
from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.ops.warp import pack_bilinear_table
from future_urban_scene_generation_tpu.pipeline import runner as jrunner
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu.render import visibility as jvis
from future_urban_scene_generation_tpu_torch.geometry import homography as th
from future_urban_scene_generation_tpu_torch.geometry import rotations as trot
from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.trajectory import rollout_from_meters
from future_urban_scene_generation_tpu_torch.ops import colorspace as tcs
from future_urban_scene_generation_tpu_torch.ops import crop as tcr
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.render import visibility as tvis
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
import torch_threads  # noqa: F401


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The oracle scene (one well-posed car) and a 3-step rollout of it."""
    sc = synthetic.make_oracle_scene(with_bad_vehicle=False)
    bank_t = runner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0,
                                    device="cpu")
    bank_j = jrunner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0)
    theta, tr = stages.pose_rollout(_t(sc["meters"]))
    return sc, bank_t, bank_j, theta[0], tr[0]


@pytest.fixture
def jax_spec():
    saved = dict(jstages.MODEL_SPEC)
    yield jstages.configure_models
    jstages.MODEL_SPEC.clear()
    jstages.MODEL_SPEC.update(saved)


def test_colorspace_matches_jax():
    rgb = np.random.RandomState(0).rand(4, 33, 3).astype(np.float32)
    lab_j = jcs.rgb_to_lab(jnp.asarray(rgb))
    lab_t = tcs.rgb_to_lab(_t(rgb))
    np.testing.assert_allclose(lab_t.numpy(), np.asarray(lab_j), atol=1e-5)
    np.testing.assert_allclose(tcs.lab_to_rgb(lab_t).numpy(),
                               np.asarray(jcs.lab_to_rgb(lab_j)), atol=1e-5)


@pytest.mark.parametrize("antialias", [False, True])
def test_scale_and_translate_matches_jax(antialias):
    rng = np.random.RandomState(1)
    img = rng.rand(3, 37, 41, 4).astype(np.float32)
    scale = np.float32([[0.37, 2.3], [1.7, 0.61], [1.0, 1.0]])
    trans = np.float32([[3.5, -20.25], [-7.0, 4.0], [0.3, -0.6]])
    got = tcr.scale_and_translate(_t(img), (29, 53), _t(scale), _t(trans), antialias=antialias)
    for b in range(3):
        ref = jax.image.scale_and_translate(
            jnp.asarray(img[b]), (29, 53, 4), (0, 1), jnp.asarray(scale[b]),
            jnp.asarray(trans[b]), method="linear", antialias=antialias,
        )
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), atol=1e-5)


def test_crop_resize_and_stitch_match_jax():
    rng = np.random.RandomState(2)
    frame = rng.rand(120, 160, 3).astype(np.float32)
    bboxes = np.float32([[10.2, 5.5, 60.7, 70.1], [-20.0, 90.0, 40.0, 150.0]])
    win_t = tcr.square_window_from_bbox(_t(bboxes))
    crops = tcr.crop_resize(_t(frame), win_t, 64)
    crop_img = rng.rand(2, 64, 64, 3).astype(np.float32)
    mask = rng.rand(2, 64, 64) > 0.4
    pasted = tcr.stitch_packed(_t(np.stack([frame, frame])), _t(crop_img), win_t, _t(mask))
    for v in range(2):
        win_j = jcr.square_window_from_bbox(jnp.asarray(bboxes[v]))
        for a, b in zip(win_t, win_j):
            assert float(a[v]) == float(b)
        np.testing.assert_allclose(crops[v].numpy(),
                                   np.asarray(jcr.crop_resize(jnp.asarray(frame), win_j, 64)),
                                   atol=1e-5)
        ref = jcr.stitch_packed(jnp.asarray(frame), jnp.asarray(crop_img[v]), win_j,
                                jnp.asarray(mask[v]))
        np.testing.assert_allclose(pasted[v].numpy(), np.asarray(ref), atol=1e-5)


def test_rotations_match_jax():
    rng = np.random.RandomState(3)
    rvecs = np.float32(np.concatenate([rng.randn(6, 3), [[0, 0, 1e-9], [math.pi - 1e-7, 0, 0]]]))
    r_t = trot.rodrigues_to_matrix(_t(rvecs))
    for i, rv in enumerate(rvecs):
        r_j = jrot.rodrigues_to_matrix(jnp.asarray(rv))
        np.testing.assert_allclose(r_t[i].numpy(), np.asarray(r_j), atol=1e-6)
        np.testing.assert_allclose(trot.matrix_to_rodrigues(r_t[i][None])[0].numpy(),
                                   np.asarray(jrot.matrix_to_rodrigues(r_j)), atol=1e-4)
    ext_t = trot.extrinsic_from_rodrigues(_t(rvecs[:2]), _t(rvecs[2:4]))
    np.testing.assert_allclose(
        ext_t[1].numpy(),
        np.asarray(jrot.extrinsic_from_rodrigues(jnp.asarray(rvecs[1]), jnp.asarray(rvecs[3]))),
        atol=1e-6,
    )


def test_rollout_matches_jax():
    t = np.linspace(0, 6.0, 6)
    meters = np.float32(np.stack([
        np.stack([t * np.cos(0.2 * v), t * np.sin(0.2 * v) + 0.3 * np.sin(t * v)], -1)
        for v in range(3)
    ]))
    got = rollout_from_meters(_t(meters))
    for v in range(3):
        ref = j_rollout(jnp.asarray(meters[v]))
        np.testing.assert_allclose(got.theta[v].numpy(), np.asarray(ref.theta), atol=1e-6)
        np.testing.assert_allclose(got.translation[v].numpy(), np.asarray(ref.translation),
                                   atol=1e-5)


@pytest.mark.parametrize("noise", [0.0, 2.0])
def test_solve_poses_matches_jax(scene, noise):
    """LM-PnP with 4 restarts on oracle keypoints (noise 0: the pose is exact and
    the residual sits at the float32 floor; noise 2 px: a non-trivial minimum)."""
    sc, bank_t, bank_j, _, _ = scene
    kp = sc["kp2d"] + np.random.RandomState(4).randn(*sc["kp2d"].shape).astype(np.float32) * noise
    per_j = jstages.Perception(jnp.zeros(1, jnp.int32), jnp.asarray(kp), None, None)
    err_j, rvec_j, tvec_j = jstages.solve_poses(per_j, bank_j, jnp.asarray(sc["intrinsic"]))
    per_t = stages.Perception(torch.zeros(1, dtype=torch.long), _t(kp), None, None)
    err_t, rvec_t, tvec_t = stages.solve_poses(per_t, bank_t, _t(sc["intrinsic"]))
    np.testing.assert_allclose(rvec_t.numpy(), np.asarray(rvec_j), atol=1e-3)
    np.testing.assert_allclose(tvec_t.numpy(), np.asarray(tvec_j), atol=1e-2)
    # rtol 1e-3 on the mean squared reprojection error; atol 1e-6 px^2 covers the
    # float32 floor an exact fit lands on (~1e-11, whose digits are rounding noise).
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-3, atol=1e-6)
    if noise == 0.0:
        np.testing.assert_allclose(tvec_t[0].numpy(), sc["extrinsic"][:3, 3], atol=1e-2)


def _planes(n, seed):
    """n random 6-point planes (projected quads/hexagons) in pixel coordinates."""
    rng = np.random.RandomState(seed)
    base = np.float32([[0, 0], [1, 0], [1.5, 0.5], [1, 1], [0, 1], [-0.3, 0.5]])
    out = []
    for _ in range(n):
        h = np.eye(3) + rng.randn(3, 3) * [[0.3, 0.3, 0], [0.3, 0.3, 0], [0.05, 0.05, 0]]
        p = np.c_[base, np.ones(6)] @ h.T
        out.append(p[:, :2] / p[:, 2:] * 80 + rng.rand(2) * 100)
    return np.float32(out)


def test_homographies_match_jax():
    src, dst = _planes(6, 5), _planes(6, 6)
    dst[5] = dst[5, :1].repeat(6, 0)  # degenerate: all points coincide
    h_t, ok_t = th.find_homography(_t(src), _t(dst))
    q_t, qok_t = th.find_homography_quad(_t(src[:, :4]), _t(dst[:, :4]))
    for i in range(6):
        h_j, ok_j = jh.find_homography(jnp.asarray(src[i]), jnp.asarray(dst[i]), refine=False)
        q_j, qok_j = jh.find_homography_quad(jnp.asarray(src[i, :4]), jnp.asarray(dst[i, :4]))
        assert bool(ok_t[i]) == bool(ok_j) and bool(qok_t[i]) == bool(qok_j)
        if bool(ok_j):
            np.testing.assert_allclose(h_t[i].numpy(), np.asarray(h_j), rtol=1e-3, atol=1e-4)
        if bool(qok_j):
            np.testing.assert_allclose(q_t[i].numpy(), np.asarray(q_j), rtol=1e-4, atol=1e-5)
    assert not bool(ok_t[5]) and not bool(qok_t[5])


def _posed(scene):
    """Per-step extrinsic-posed keypoints of the oracle car (3 steps)."""
    sc, bank_t, _, theta, tr = scene
    ext = _t(sc["extrinsic"]).expand(3, 4, 4)
    kp3d = bank_t.keypoints3d[0].expand(3, 12, 3)
    kp3d_s = kp3d @ trot.z_rot(theta) + tr[:, None]
    kp2d_s = project_points_extrinsic(kp3d_s, _t(sc["intrinsic"]), ext)
    return ext, kp3d_s, kp2d_s


def test_visibility_local_matches_jax(scene):
    ext, kp3d_s, kp2d_s = _posed(scene)
    got = tvis.compute_visibility_local(ext, kp2d_s, kp3d_s, res=192)
    for s in range(3):
        ref = jvis.compute_visibility_local(jnp.asarray(ext[s].numpy()),
                                            jnp.asarray(kp2d_s[s].numpy()),
                                            jnp.asarray(kp3d_s[s].numpy()), res=192)
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(ref))


def test_render_vehicle_matches_jax(scene):
    """Sketches under the K1 budget (background equal, < 0.5% of pixels more than
    1e-4 apart), windows exact."""
    sc, bank_t, bank_j, theta, tr = scene
    ext = _t(sc["extrinsic"]).expand(3, 4, 4)
    sk_t, m_t, win_t = stages.render_vehicle(
        bank_t.vertices[0].expand(3, -1, -1), bank_t.corners[0].expand(3, -1, -1, -1),
        bank_t.corner_normals[0].expand(3, -1, -1, -1), ext, _t(sc["intrinsic"]),
        theta, tr, cull=bank_t.cullable[0].expand(3),
    )
    for s in range(3):
        sk_j, m_j, win_j = jstages.render_vehicle(
            bank_j.vertices[0], bank_j.corners[0], bank_j.corner_normals[0],
            jnp.asarray(sc["extrinsic"]), jnp.asarray(sc["intrinsic"]),
            jnp.asarray(theta[s].numpy()), jnp.asarray(tr[s].numpy()), cull=bank_j.cullable[0],
        )
        for a, b in zip(win_t, win_j):
            assert float(a[s]) == float(b)
        assert np.array_equal(m_t[s].numpy(), np.asarray(m_j))
        d = np.abs(sk_t[s].numpy() - np.asarray(sk_j)).max(-1)
        assert (d > 1e-4).mean() < 0.005
        assert m_t[s].float().mean() > 0.05


@pytest.mark.parametrize("res", [96, 256])
def test_warp_planes_to_crop_matches_jax(scene, jax_spec, res):
    """Step-0 source planes warped to each of 3 steps. Budget: 99.5% of values
    within 1e-3 — bilinear taps are the same math; pixels on a polygon edge may
    flip with last-bit differences of the homography."""
    sc, bank_t, _, theta, tr = scene
    ext, kp3d_s, kp2d_s = _posed(scene)
    vis_t = tvis.compute_visibility_local(ext, kp2d_s, kp3d_s, res=192)[:, :5]
    polys = torch.trunc(kp2d_s)[:, torch.as_tensor(tvis.TEXTURE_PLANES)]
    _, _, win = stages.render_vehicle(
        bank_t.vertices[0].expand(3, -1, -1), bank_t.corners[0].expand(3, -1, -1, -1),
        bank_t.corner_normals[0].expand(3, -1, -1, -1), ext, _t(sc["intrinsic"]), theta, tr,
    )
    frame = _t(sc["frame"])
    src_win = win.map(lambda f: f[:1])
    table = stages._to_signed_lab(tcr.crop_resize(frame, src_win, stages.SRC_TABLE))
    spec = ModelSpec(warp_plane_res=res)
    got = stages.warp_planes_to_crop(
        spec, table, src_win, polys[[0, 0, 0]], polys, vis_t[[0, 0, 0]], vis_t, win,
        torch.zeros(3, dtype=torch.long),
    )
    jax_spec(warp_plane_res=res)
    packed = pack_bilinear_table(jnp.asarray(table[0].numpy()))
    j_src_win = jcr.Window(*(jnp.asarray(f[0].numpy()) for f in src_win))
    for s in range(3):
        ref = jstages.warp_planes_to_crop(
            packed, j_src_win, jnp.asarray(polys[0].numpy()), jnp.asarray(polys[s].numpy()),
            jnp.asarray(vis_t[0].numpy()), jnp.asarray(vis_t[s].numpy()),
            jcr.Window(*(jnp.asarray(f[s].numpy()) for f in win)),
        )
        d = np.abs(got[s].numpy() - np.asarray(ref))
        assert (d <= 1e-3).mean() >= 0.995, (d <= 1e-3).mean()
    # Something was warped: some slot differs from the black fill.
    assert (got[0] != got[0, :, :1, :1]).any()


def test_composite_frames_matches_jax():
    rng = np.random.RandomState(9)
    f, v, h, w = 2, 2, 90, 120
    bgs = rng.rand(f, h, w, 3).astype(np.float32)
    crops = rng.rand(f, v, 64, 64, 3).astype(np.float32)
    masks = rng.rand(f, v, 64, 64) > 0.3
    fields = [np.float32([[10, 50], [12, 48]]), np.float32([[5, 20], [6, 22]]),
              np.float32([[40, 60], [41, 61]]), np.float32([[40, 60], [41, 61]])]
    got = stages.composite_frames(ModelSpec(), _t(bgs), _t(crops),
                                  tcr.Window(*(_t(x) for x in fields)), _t(masks))
    ref = jstages.composite_frames(jnp.asarray(bgs), jnp.asarray(crops),
                                   tuple(jnp.asarray(x) for x in fields), jnp.asarray(masks))
    # A resampled binary mask lands exactly on the 0.5 write threshold wherever a
    # frame pixel samples midway between a set and an unset crop pixel; there the
    # last bit of the interpolation decides, so < 0.5% of pixels may flip.
    d = np.abs(got.numpy() - np.asarray(ref)).max(-1)
    assert (d > 1e-5).mean() < 0.005, (d > 1e-5).mean()
    assert (d > 1e-5).mean() < (np.abs(np.asarray(ref) - bgs).max(-1) > 0).mean() / 10
    # One frame through composite_step: the same as frame 1 of composite_frames.
    step = stages.composite_step(ModelSpec(), _t(bgs[1]), _t(crops[1]),
                                 tcr.Window(*(_t(x[1]) for x in fields)), _t(masks[1]))
    np.testing.assert_array_equal(step.numpy(), got[1].numpy())
    ref_step = jstages.composite_step(jnp.asarray(bgs[1]), jnp.asarray(crops[1]),
                                      jcr.Window(*(jnp.asarray(x[1]) for x in fields)),
                                      jnp.asarray(masks[1]))
    d = np.abs(step.numpy() - np.asarray(ref_step)).max(-1)
    assert (d > 1e-5).mean() < 0.005, (d > 1e-5).mean()
