"""The reference-parity surface (S6b) of the PyTorch port against the JAX package,
on the CPU: one test per item, each at the tolerance of the JAX test that holds the
JAX function (named beside each bar).

ops/crop, ops/warp, ops/polygon, geometry/rotations, projection, trajectory,
homography._sampson_refine, render/planes (with visibility.plane_polygons_2d), the
per-vehicle generator stages, runner.synthesize_scene_staged and utils/profiling.
"""
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.geometry import homography as jhom
from future_urban_scene_generation_tpu.geometry import projection as jproj
from future_urban_scene_generation_tpu.geometry import rotations as jrot
from future_urban_scene_generation_tpu.geometry import trajectory as jtraj
from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.ops import polygon as jpg
from future_urban_scene_generation_tpu.ops import warp as jwp
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu.render import planes as jpl
from future_urban_scene_generation_tpu.render import visibility as jvis
from future_urban_scene_generation_tpu.utils import profiling as jprof
from future_urban_scene_generation_tpu_torch.geometry import homography, projection
from future_urban_scene_generation_tpu_torch.geometry import rotations as rot
from future_urban_scene_generation_tpu_torch.geometry import trajectory
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.ops import polygon as pg
from future_urban_scene_generation_tpu_torch.ops import warp as wp
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.render import planes, visibility
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import profiling

K = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]], dtype=np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jwin(*fields):
    return jcr.Window(*(jnp.float32(f) for f in fields))


def _twin(*fields):
    return cr.Window(*(torch.tensor(float(f)) for f in fields))


# --- ops/crop (tests/test_crop_canny_morph.py) ---

@pytest.mark.parametrize("bbox", [[30, 40, 90, 100], [-2, -3, 50, 52]])
def test_crop_resize_gather_matches_jax(bbox):
    """Bar: the JAX test's crop error, mean < 5e-3."""
    frame = np.random.RandomState(1).rand(120, 160, 3).astype(np.float32)
    jw = jcr.square_window_from_bbox(jnp.asarray(np.float32(bbox)))
    want = np.asarray(jcr.crop_resize_gather(jnp.asarray(frame), jw, 64))
    got = cr.crop_resize_gather(_t(frame), cr.square_window_from_bbox(_t(np.float32(bbox))), 64)
    assert got.shape == want.shape and np.abs(got.numpy() - want).mean() < 5e-3


def test_frame_to_crop_coords_and_image_ref_to_crop_ref_match_jax():
    """Bars: the keypoint round trip's 1e-4; the host remap (test_reference_crossval)
    is exact."""
    kp = np.random.RandomState(2).rand(12, 2).astype(np.float32) * 50 + 35
    jw, tw = _jwin(25, 35, 66, 66), _twin(25, 35, 66, 66)
    want = np.asarray(jcr.frame_to_crop_coords(jnp.asarray(kp), jw, 256))
    assert np.abs(cr.frame_to_crop_coords(_t(kp), tw, 256).numpy() - want).max() < 1e-4
    kps = np.float64(kp) * 2
    kps[3] = -1
    for normalize in (False, True):
        np.testing.assert_array_equal(
            cr.image_ref_to_crop_ref(kps, (40, 30), (5, 8), (100, 120, 3), normalize),
            jcr.image_ref_to_crop_ref(kps, (40, 30), (5, 8), (100, 120, 3), normalize))


def test_stitch_gather_matches_jax():
    """Bar: the stitch round trip's 0.02 inside the window; outside untouched."""
    rng = np.random.RandomState(3)
    frame = rng.rand(60, 80, 3).astype(np.float32)
    crop = rng.rand(32, 32, 3).astype(np.float32)
    mask = rng.rand(60, 80) > 0.3
    want = np.asarray(jcr.stitch_gather(jnp.asarray(frame), jnp.asarray(crop),
                                        _jwin(10, 5, 40, 40), jnp.asarray(mask)))
    got = cr.stitch_gather(_t(frame), _t(crop), _twin(10, 5, 40, 40), _t(mask)).numpy()
    assert np.abs(got - want).max() < 0.02
    np.testing.assert_array_equal(got[50:], frame[50:])


def test_window_from_mask_bbox_matches_jax():
    """Bar: the window is integer-valued (reference truncation): equal."""
    mask = np.zeros((256, 256), bool)
    mask[64:192, 96:160] = True
    want = jcr.window_from_mask_bbox(jnp.asarray(mask), _jwin(50, 30, 100, 100), 256)
    got = cr.window_from_mask_bbox(_t(mask), _twin(50, 30, 100, 100), 256)
    assert [float(f) for f in got] == [float(f) for f in want]


# --- ops/warp (tests/test_homography.py) ---

def test_warp_perspective_matches_jax():
    """Bar: the JAX test's 99.5th percentile < 1e-3 and mean < 1e-4."""
    img = np.random.RandomState(4).rand(60, 80, 3).astype(np.float32)
    h_mat = np.float32([[1.05, 0.1, 3.0], [-0.05, 0.95, 2.0], [1e-4, 2e-4, 1.0]])
    want = np.asarray(jwp.warp_perspective(jnp.asarray(img), jnp.asarray(h_mat), (50, 70)))
    d = np.abs(wp.warp_perspective(_t(img), _t(h_mat), (50, 70)).numpy() - want)
    assert np.percentile(d, 99.5) < 1e-3 and d.mean() < 1e-4


def test_warp_affine_resample_matches_jax():
    """Bar: the JAX test's 1e-4."""
    img = np.random.RandomState(5).rand(80, 100, 3).astype(np.float32)
    want = np.asarray(jwp.warp_affine_resample(jnp.asarray(img), jnp.float32([50.0, 40.0]),
                                               jnp.float32(61.0), 32))
    got = wp.warp_affine_resample(_t(img), torch.tensor([50.0, 40.0]), 61.0, 32)
    assert np.abs(got.numpy() - want).max() < 1e-4


# --- ops/polygon (tests/test_polygon.py) ---

def test_polygon_padding_and_areas_match_jax():
    """Bars: padding and pixel areas equal; the shoelace area exact (12.0 in the JAX
    test), 1e-4 relative on a random polygon."""
    verts = np.float32([[10, 10], [60, 12], [55, 50], [30, 58], [8, 40]])
    padded = pg.pad_polygon(verts, 7)
    np.testing.assert_array_equal(padded, jpg.pad_polygon(verts, 7))
    assert int(pg.polygon_area_pixels(_t(padded), 64, 64)) == int(
        jpg.polygon_area_pixels(jnp.asarray(padded), 64, 64))
    rect = pg.pad_polygon(np.float32([[0, 0], [4, 0], [4, 3], [0, 3]]), 6)
    assert float(pg.polygon_area_shoelace(_t(rect))) == 12.0
    got = float(pg.polygon_area_shoelace(_t(padded)))
    assert abs(got - float(jpg.polygon_area_shoelace(jnp.asarray(padded)))) <= 1e-4 * got


# --- geometry (tests/test_rotations.py, test_projection.py, test_gps_trajectory.py) ---

def test_rotation_helpers_match_jax():
    """Bars: the axis rotations' 1e-6; delta_t_vec and the intrinsic matrix exact;
    azimuth / elevation / radius at 1e-4 (degrees, metres)."""
    for a in (0.3, -1.2):
        for cw in (False, True):
            np.testing.assert_allclose(rot.y_rot(torch.tensor(a), clockwise=cw).numpy(),
                                       np.asarray(jrot.y_rot(jnp.float32(a), clockwise=cw)),
                                       atol=1e-6)
    np.testing.assert_array_equal(rot.delta_t_vec("y", -3.0).numpy(),
                                  np.asarray(jrot.delta_t_vec("y", -3.0)))
    np.testing.assert_array_equal(rot.intrinsic_matrix(800.0, 320.0, 240.0).numpy(),
                                  np.asarray(jrot.intrinsic_matrix(800.0, 320.0, 240.0)))
    for cam in ([3.0, -2.0, 5.0], [-1.0, 4.0, -2.0]):
        got = rot.rotmat_to_az_el_radius(torch.tensor(cam))
        want = jrot.rotmat_to_az_el_radius(jnp.float32(cam))
        np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], atol=1e-4)


def test_project_points_rodrigues_and_transform_points_match_jax():
    """Bars: projection 1e-2 px (tests/test_projection.py, against cv2); the rigid
    motion 1e-5 (tests/test_gps_trajectory.py)."""
    rng = np.random.RandomState(6)
    pts = (rng.rand(12, 3).astype(np.float32) - 0.5) * 4
    rvec, tvec = np.float32([0.2, -0.4, 0.1]), np.float32([0.3, -0.2, 12.0])
    want = np.asarray(jproj.project_points_rodrigues(jnp.asarray(pts), jnp.asarray(rvec),
                                                     jnp.asarray(tvec), jnp.asarray(K)))
    got = projection.project_points_rodrigues(_t(pts), _t(rvec), _t(tvec), _t(K))
    assert np.abs(got.numpy() - want).max() < 1e-2
    theta, tr = np.float32(0.7), np.float32([1.0, -2.0, 0.5])
    want = np.asarray(jtraj.transform_points(jnp.asarray(pts), jnp.float32(theta),
                                             jnp.asarray(tr)))
    got = trajectory.transform_points(_t(pts), torch.tensor(theta), _t(tr))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_sampson_refine_matches_jax():
    """From a perturbed H on 6 noisy points: both refinements' transfer errors within
    the JAX test's 0.5 px of each other, and the refined matrices within 1e-3."""
    rng = np.random.RandomState(7)
    src = rng.rand(6, 2).astype(np.float32) * 100
    h_true = np.float32([[1.1, 0.05, 5.0], [-0.03, 0.9, 3.0], [1e-4, -2e-4, 1.0]])
    src_h = np.concatenate([src, np.ones((6, 1), np.float32)], 1) @ h_true.T
    dst = (src_h[:, :2] / src_h[:, 2:] + rng.randn(6, 2) * 0.3).astype(np.float32)
    h0 = h_true * np.float32([[1.01, 1, 1], [1, 0.99, 1], [1, 1, 1]])
    want = np.asarray(jhom._sampson_refine(jnp.asarray(h0), jnp.asarray(src), jnp.asarray(dst)))
    got = homography._sampson_refine(_t(h0), _t(src), _t(dst)).numpy()

    def transfer(h):
        p = np.concatenate([src, np.ones((6, 1), np.float32)], 1) @ (h / h[2, 2]).T
        return np.abs(p[:, :2] / p[:, 2:] - dst).max()

    assert abs(transfer(got) - transfer(want)) < 0.5
    np.testing.assert_allclose(got / got[2, 2], want / want[2, 2], atol=1e-3)


# --- render/planes and visibility (tests/test_visibility_planes.py) ---

def _car_keypoints(yaw):
    """The test car's 12 keypoints projected at ``yaw`` (tests/test_visibility_planes.py's
    pose), scaled into a 96^2 frame: planes with well-posed homographies."""
    from future_urban_scene_generation_tpu_torch.utils import mesh

    _, kp3d = mesh.make_test_car()
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = (rot.x_rot(torch.tensor(-np.pi / 2.5)) @ rot.z_rot(torch.tensor(yaw))).numpy()
    ext[:3, 3] = [0, 0.5, 14.0]
    kp = projection.project_points_extrinsic(_t(np.float32(kp3d * 5.0)), _t(K), _t(ext)).numpy()
    return np.float32((kp - [320, 240]) * 0.3 + 48)


@pytest.mark.parametrize("dst_yaw,dst_vis", [(0.6, [True] * 5),
                                             (-0.6, [False, True, True, True, True])],
                         ids=["identity", "symmetry"])
def test_planes_match_jax(dst_yaw, dst_vis):
    """get_planes equal; warp_unwarp_planes writes the same slots and agrees within
    the JAX identity test's 0.02 mean; plane_polygons_2d equal."""
    frame = np.random.RandomState(8).rand(96, 96, 3).astype(np.float32)
    src_kp, dst_kp = _car_keypoints(0.6), _car_keypoints(dst_yaw)
    np.testing.assert_array_equal(visibility.plane_polygons_2d(_t(src_kp)).numpy(),
                                  np.asarray(jvis.plane_polygons_2d(jnp.asarray(src_kp))))
    jplanes, jpolys = jpl.get_planes(jnp.asarray(frame), jnp.asarray(src_kp))
    tplanes, tpolys = planes.get_planes(_t(frame), _t(src_kp))
    np.testing.assert_array_equal(tplanes.numpy(), np.asarray(jplanes))
    np.testing.assert_array_equal(tpolys.numpy(), np.asarray(jpolys))
    _, jdst = jpl.get_planes(jnp.asarray(frame), jnp.asarray(dst_kp))
    _, tdst = planes.get_planes(_t(frame), _t(dst_kp))
    src_vis = np.array([True, False, True, True, True])
    dst_vis = np.array(dst_vis)
    jw, ju = jpl.warp_unwarp_planes(jplanes, jpolys, jdst, jnp.asarray(src_vis),
                                    jnp.asarray(dst_vis))
    tw, tu = planes.warp_unwarp_planes(tplanes, tpolys, tdst, _t(src_vis), _t(dst_vis))
    for got, want in ((tw, jw), (tu, ju)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got.sum(axis=(1, 2, 3)) > 0, want.sum(axis=(1, 2, 3)) > 0)
        assert np.abs(got - want).mean() < 0.02


# --- pipeline: per-vehicle stages, the staged runner (tests/test_pipeline.py) ---

@pytest.fixture(scope="module")
def generators():
    key = jax.random.PRNGKey(1)
    _, _, icnm, vunm = jstages.Models.modules()
    icn_p = jax.jit(icnm.init)(key, jnp.zeros((1, 64, 64, 21)))
    vun_p = jax.jit(lambda k: vunm.init({"params": k}, jnp.zeros((1, 128, 128, 3)),
                                        jnp.zeros((1, 128, 128, 6)), cov=0.0))(key)
    ours = stages.Models.build(ModelSpec(), device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    convert.load_jax_params(ours.icn, np_tree(icn_p))
    convert.load_jax_params(ours.vunet, np_tree(vun_p))
    return jstages.Models(None, None, icn_p, vun_p), ours


@torch.no_grad()
def test_per_vehicle_stages_match_jax(generators):
    """icn_synthesize, vunet_encode_appearance, vunet_synthesize at the generator
    stages' 2e-3 (tests/test_torch_generators.py, after tests/test_icn.py)."""
    jm, ours = generators
    rng = np.random.RandomState(9)
    spec = ModelSpec()
    sketch = rng.rand(64, 64, 3).astype(np.float32)
    central = (rng.rand(64, 64, 3) * 2 - 1).astype(np.float32)
    pls = (rng.rand(5, 64, 64, 3) * 2 - 1).astype(np.float32)
    want = jstages.icn_synthesize(jm, jnp.asarray(sketch), jnp.asarray(central), jnp.asarray(pls))
    got = stages.icn_synthesize(ours, spec, _t(sketch), _t(central), _t(pls))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)

    frame = rng.rand(300, 400, 3).astype(np.float32)
    src = rng.rand(256, 256, 3).astype(np.float32)
    mask = rng.rand(256, 256) > 0.5
    mu_j = jstages.vunet_encode_appearance(jm, jnp.asarray(frame), jnp.asarray(src),
                                           jnp.asarray(mask), _jwin(60, 20, 256, 256))
    mu_t = stages.vunet_encode_appearance(ours, spec, _t(frame), _t(src), _t(mask),
                                          _twin(60, 20, 256, 256))
    for a, b in zip(mu_t, mu_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3)
    want = jstages.vunet_synthesize(jm, jnp.asarray(src), mu_j)
    got = stages.vunet_synthesize(ours, spec, _t(src), mu_t)
    assert got.shape == (256, 256, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@torch.no_grad()
def test_synthesize_scene_staged_equals_the_fused_scene():
    """JAX test_staged_runner_matches_monolith holds the two within 1e-3; in eager
    PyTorch they are one computation, so equal. (The fused scene is held against the
    JAX package in tests/test_torch_pipeline.py.)"""
    sc = synthetic.make_oracle_scene(hw=(96, 128), with_bad_vehicle=False)
    models = stages.Models.build(ModelSpec(), torch.Generator().manual_seed(0), device="cpu")
    bank = runner.build_cad_bank([sc["mesh"]], [sc["kp3d"]], scale=5.0, device="cpu")
    args = (models, bank, _t(sc["frame"]), _t(sc["background"]),
            synthetic.oracle_perception(sc, device="cpu"), _t(sc["meters"]), _t(sc["intrinsic"]))
    fused = runner.synthesize_scene(*args, spec=ModelSpec())
    staged = runner.synthesize_scene_staged(*args, spec=ModelSpec())
    for a, b in zip(staged, fused):
        assert torch.equal(a, b) or (torch.isnan(a).any() and torch.equal(a.isnan(), b.isnan()))


# --- utils/profiling ---

def test_profiling_trace_capture_and_timeit(tmp_path):
    """``trace`` is a profiler span, ``capture_trace`` writes a Chrome trace holding
    it, ``timeit`` returns the JAX harness's keys."""
    log_dir = str(tmp_path / "trace")
    with profiling.capture_trace(log_dir):
        with profiling.trace("fusg.test_span"):
            torch.ones(8).sum()
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "fusg.test_span" in names
    got = profiling.timeit(lambda a: a * 2, torch.ones(4), iters=3)
    want = jprof.timeit(lambda a: a * 2, jnp.ones(4), iters=3)
    assert got.keys() == want.keys() and all(v >= 0 for v in got.values())


@pytest.mark.parametrize("cuda_in_use", [False, True], ids=["cpu_only", "cuda"])
def test_profiling_timeit_waits_for_the_card(monkeypatch, cuda_in_use):
    """Where CUDA is in use, ``timeit`` synchronizes after the warm-up and after every
    timed call, so that each time holds the call's device work (the JAX harness blocks
    on its outputs); without CUDA it touches no device."""
    syncs, calls = [], []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_in_use)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(len(calls)))
    got = profiling.timeit(lambda: calls.append(1), iters=3, warmup=2)
    want = jprof.timeit(lambda: jnp.ones(2), iters=3, warmup=2)
    assert got.keys() == want.keys() and len(calls) == 5
    assert syncs == ([2, 3, 4, 5] if cuda_in_use else [])
