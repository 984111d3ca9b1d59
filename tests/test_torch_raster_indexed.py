"""Kernel K1' of the PyTorch port (``ops/cuda_raster.rasterize_indexed``) and the
indexed-mesh ``render_normal_sketch`` against the JAX package.

On the CPU the wrapper runs its plain version (the corner gather in front of the
plain raster); the CUDA kernel is held against that plain version on the GPU by
chip_smoke.py. Budgets are those of tests/test_pallas_raster.py:20-31,118-128:
background masks equal and < 0.5% of pixels more than 1e-4 apart against the Pallas
kernel in interpret mode and against the chunked XLA raster (affine-plane vs
edge-sign coverage flips a few edge pixels); the indexed entry equals the corners
entry on the expanded mesh exactly.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import pallas_raster as pr
from future_urban_scene_generation_tpu.render import rasterizer as jrz
from future_urban_scene_generation_tpu.utils import mesh as jmu
from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr
from future_urban_scene_generation_tpu_torch.render import rasterizer as rz


def _random_scene(n_verts, n_tris, seed=31):
    r = np.random.RandomState(seed)
    verts = (r.rand(n_verts, 3) * [250, 250, 3] + [0, 0, 4]).astype(np.float32)
    tris = r.randint(0, n_verts, (n_tris, 3))
    colors = r.rand(n_verts, 3).astype(np.float32)
    return verts, tris, colors


def _port(verts, tris, colors, hw):
    img, bg = cr.rasterize_indexed(torch.as_tensor(verts)[None], torch.as_tensor(tris),
                                   torch.as_tensor(colors)[None], hw)
    return img[0].numpy(), bg[0].numpy()


def _budget(img_a, bg_a, img_b, bg_b, tol=1e-4, frac=0.005):
    assert np.array_equal(bg_a, bg_b)
    d = np.abs(img_a - img_b).max(-1)
    assert (d > tol).mean() < frac, (d > tol).mean()


@pytest.mark.parametrize("n_tris,hw", [(60, (256, 256)), (128 + 97, (64, 128)),
                                       (300, (90, 160))])
def test_indexed_matches_pallas_and_xla(n_tris, hw):
    verts, tris, colors = _random_scene(80, n_tris)
    img, bg = _port(verts, tris, colors, hw)
    jv, jt, jc = jnp.asarray(verts), jnp.asarray(tris, jnp.int32), jnp.asarray(colors)
    if hw[0] % pr.TILE_H == 0 and hw[1] % pr.TILE_W == 0:  # the Pallas kernel's tiling
        img_p, bg_p = pr.rasterize_pallas(jv, jt, jc, hw, interpret=True)
        _budget(img, bg, np.asarray(img_p), np.asarray(bg_p))
    img_x, bg_x = jrz.rasterize(jv, jt, jc, hw)
    _budget(img, bg, np.asarray(img_x), np.asarray(bg_x))


def test_indexed_equals_corners_entry_exactly():
    """The same values minus the gather: bit-identical images and masks, for
    shared (T, 3) and per-render (R, T, 3) triangle lists and int32 indices."""
    scenes = [_random_scene(50, 128 + 33, seed=s) for s in (1, 2)]
    verts = torch.as_tensor(np.stack([s[0] for s in scenes]))
    colors = torch.as_tensor(np.stack([s[2] for s in scenes]))
    tris = torch.as_tensor(np.stack([s[1] for s in scenes]))
    screen = np.stack([np.stack([s[0][s[1][:, k]].T for k in range(3)]) for s in scenes])
    rgb = np.stack([np.stack([s[2][s[1][:, k]].T for k in range(3)]) for s in scenes])
    img_c, bg_c = cr.rasterize_corners(torch.as_tensor(screen), torch.as_tensor(rgb), (64, 128))
    img_i, bg_i = cr.rasterize_indexed(verts, tris, colors, (64, 128))
    assert torch.equal(img_i, img_c) and torch.equal(bg_i, bg_c)
    # One shared triangle list for both renders, as int32.
    img_s, bg_s = cr.rasterize_indexed(verts, tris[0].to(torch.int32), colors, (64, 128))
    img_r, bg_r = cr.rasterize_indexed(verts, tris[:1].expand(2, -1, -1), colors, (64, 128))
    assert torch.equal(img_s, img_r) and torch.equal(bg_s, bg_r)
    assert torch.equal(img_s[0], img_c[0])
    assert torch.equal(cr.gather_corners(verts, tris), torch.as_tensor(screen))


def test_behind_camera_and_degenerate_dropped():
    verts = np.float32([[10, 10, -5], [200, 10, -5], [10, 200, -5],  # behind the camera
                        [50, 50, 5], [50, 50, 5], [50, 50, 5]])  # degenerate
    _, bg = _port(verts, np.array([[0, 1, 2], [3, 4, 5]]), np.ones((6, 3), np.float32),
                  (40, 72))
    assert bg.all()


def test_wrapper_refuses_bad_input():
    v = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        cr.rasterize_indexed(v, torch.zeros(2, 3), v, (8, 8))  # float indices
    with pytest.raises(ValueError):
        cr.rasterize_indexed(v, torch.zeros(3, 2, 3, dtype=torch.long), v, (8, 8))  # R mismatch
    with pytest.raises(ValueError):
        cr.rasterize_indexed(v.to("meta"), torch.zeros(2, 3, dtype=torch.long, device="meta"),
                             v.to("meta"), (8, 8))  # neither CPU nor CUDA: no plain fallback


def _sketch_inputs(hw, subdiv=2):
    h, w = hw
    mesh, _ = jmu.make_test_car(subdiv=subdiv)
    normals = jmu.compute_vertex_normals(mesh).astype(np.float32)
    verts = np.float32(mesh.vertices * 5.0)
    f = 450.0 * w / 640
    k = np.float32([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    ext = torch.eye(4)
    ext[:3, :3] = x_rot(torch.tensor(-np.pi / 2.4)) @ z_rot(torch.tensor(0.5))
    ext[:3, 3] = torch.tensor([0.0, 2.0, 20.0])
    return verts, np.asarray(mesh.triangles), normals, ext.numpy(), k


@pytest.mark.parametrize("hw", [(64, 128), (90, 160)])
def test_render_normal_sketch_matches_jax(hw):
    """The demo's render (a subdiv-2 car at the demo's pose, the 360x640 camera
    scaled down) at a size that tiles for the TPU kernel and one that does not."""
    verts, tris, normals, ext, k = _sketch_inputs(hw)
    ref, ref_bg = jrz.render_normal_sketch(
        jnp.asarray(verts), jnp.asarray(tris, jnp.int32), jnp.asarray(normals),
        jnp.asarray(ext), jrz.Camera.from_intrinsic(jnp.asarray(k)), hw)
    cam = rz.Camera(*(c.reshape(1) for c in rz.Camera.from_intrinsic(torch.as_tensor(k))))
    got, got_bg = rz.render_normal_sketch(
        torch.as_tensor(verts)[None], torch.as_tensor(tris), torch.as_tensor(normals)[None],
        torch.as_tensor(ext)[None], cam, hw)
    assert got.shape == (1, *hw, 3) and got_bg.shape == (1, *hw)
    assert (~got_bg).mean(dtype=torch.float32) > 0.02  # the car is drawn
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0
    _budget(got[0].numpy(), got_bg[0].numpy(), np.asarray(ref), np.asarray(ref_bg))
    # rasterize (plain) and rasterize_auto (by device) agree exactly on the CPU.
    vs = rz.project_vertices(torch.as_tensor(verts)[None], torch.as_tensor(ext)[None], cam)
    col = (torch.as_tensor(normals)[None] + 1.0) / 2.0
    a = rz.rasterize(vs, torch.as_tensor(tris), col, hw)
    b = rz.rasterize_auto(vs, torch.as_tensor(tris), col, hw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
