"""Kernel K1 of the PyTorch port (ops/cuda_raster.py) against the JAX package's
rasterizers: the Pallas kernel in interpret mode and the chunked XLA raster.

On the CPU the port's wrapper runs its plain version; the CUDA kernel is held
against that plain version on the GPU by chip_smoke.py. Budgets are those of
tests/test_pallas_raster.py: background masks equal and < 0.5% of pixels more
than 1e-4 apart (affine-plane vs edge-sign coverage flips a few edge pixels);
dense meshes < 0.5% background flips and < 1% of pixels more than 1e-3 apart.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import pallas_raster as pr
from future_urban_scene_generation_tpu.render import rasterizer as jrz
from future_urban_scene_generation_tpu.utils import mesh as jmu
from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr


def _random_scene(n_verts=40, n_tris=60, seed=31):
    r = np.random.RandomState(seed)
    verts = (r.rand(n_verts, 3) * [250, 250, 3] + [0, 0, 4]).astype(np.float32)
    tris = r.randint(0, n_verts, (n_tris, 3))
    colors = r.rand(n_verts, 3).astype(np.float32)
    return _corners(verts, tris, colors)


def _corners(verts, tris, colors):
    screen = np.stack([verts[tris[:, k]].T for k in range(3)]).astype(np.float32)
    rgb = np.stack([colors[tris[:, k]].T for k in range(3)]).astype(np.float32)
    return screen, rgb


def _car(subdiv, oriented=True):
    mesh, _ = jmu.make_test_car(subdiv=subdiv)
    n = jmu.compute_vertex_normals(mesh)
    if oriented:
        mesh, cullable = jmu.orient_for_backface_cull(mesh)
        assert cullable
    verts = np.float32(mesh.vertices * 40 + [64, 32, 8])
    return _corners(verts, mesh.triangles, np.float32((n + 1) / 2))


def _port(screen, rgb, hw, cull=None):
    c = None if cull is None else torch.tensor([cull])
    img, bg = cr.rasterize_corners(torch.as_tensor(screen)[None], torch.as_tensor(rgb)[None],
                                   hw, cull=c)
    return img[0].numpy(), bg[0].numpy()


def _pallas(screen, rgb, hw, cull=False):
    img, bg = pr.rasterize_pallas_corners(
        jnp.asarray(screen), jnp.asarray(rgb), hw, interpret=True, cull=jnp.asarray(cull)
    )
    return np.asarray(img), np.asarray(bg)


def _budget(img_a, bg_a, img_b, bg_b, tol=1e-4, frac=0.005):
    assert np.array_equal(bg_a, bg_b)
    d = np.abs(img_a - img_b).max(-1)
    assert (d > tol).mean() < frac, (d > tol).mean()


@pytest.mark.parametrize("n_tris,hw", [(60, (256, 256)), (128 + 97, (64, 128)),
                                       (400, (48, 80))])
def test_plain_matches_pallas_random_scene(n_tris, hw):
    screen, rgb = _random_scene(n_verts=80, n_tris=n_tris)
    img, bg = _port(screen, rgb, hw)
    if hw[0] % pr.TILE_H == 0 and hw[1] % pr.TILE_W == 0:
        _budget(img, bg, *_pallas(screen, rgb, hw))
    ref_img, ref_bg = jrz.rasterize_corners(jnp.asarray(screen), jnp.asarray(rgb), hw)
    # Same algorithm as the JAX chunked raster; float reassociation can still flip
    # a depth tie at a shared edge, so the same pixel budget applies.
    _budget(img, bg, np.asarray(ref_img), np.asarray(ref_bg))


@pytest.mark.parametrize("cull", [False, True])
def test_plain_matches_pallas_culled_car(cull):
    screen, rgb = _car(subdiv=6)
    img, bg = _port(screen, rgb, (64, 128), cull=cull)
    _budget(img, bg, *_pallas(screen, rgb, (64, 128), cull=cull))
    ref_img, ref_bg = jrz.rasterize_corners(jnp.asarray(screen), jnp.asarray(rgb), (64, 128),
                                            cull=jnp.asarray(cull))
    _budget(img, bg, np.asarray(ref_img), np.asarray(ref_bg))


def test_backface_cull_exact_on_closed_mesh():
    screen, rgb = _car(subdiv=6)
    img0, bg0 = _port(screen, rgb, (64, 128), cull=False)
    img1, bg1 = _port(screen, rgb, (64, 128), cull=True)
    assert np.array_equal(bg0, bg1)
    assert np.abs(img0 - img1).max() < 1e-5
    table_all = cr.triangle_planes_corners(torch.as_tensor(screen)[None],
                                           torch.as_tensor(rgb)[None])
    table_cull = cr.triangle_planes_corners(torch.as_tensor(screen)[None],
                                            torch.as_tensor(rgb)[None], torch.tensor([True]))
    live = lambda tb: int((tb[0, :, cr._BBOX_COL] < 1e29).sum())  # noqa: E731
    assert live(table_cull) < live(table_all)


def test_dense_mesh_6144_tris():
    screen, rgb = _car(subdiv=16, oriented=False)
    assert screen.shape[-1] >= 6144
    img, bg = _port(screen, rgb, (64, 128))
    img_pl, bg_pl = _pallas(screen, rgb, (64, 128))
    assert (bg != bg_pl).mean() < 0.005
    assert (np.abs(img - img_pl).max(-1) > 1e-3).mean() < 0.01


def test_prep_table_matches_jax():
    """The port's plane table (the kernel's input) equals the JAX prep's."""
    screen, rgb = _random_scene(n_verts=50, n_tris=133)
    for cull in (False, True):
        table, _ = pr.triangle_planes_corners(jnp.asarray(screen), jnp.asarray(rgb),
                                              jnp.asarray(cull))
        ours = cr.triangle_planes_corners(torch.as_tensor(screen)[None],
                                          torch.as_tensor(rgb)[None], torch.tensor([cull]))
        t = ours.shape[1]
        assert t == 136  # padded to a GROUP multiple
        np.testing.assert_allclose(ours[0].numpy()[:, :25], np.asarray(table)[:t, :25],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_i,n_j", [(2, 2), (3, 5)])
def test_binning_matches_bruteforce(n_i, n_j):
    screen, rgb = _random_scene(n_verts=60, n_tris=2 * 128 + 11)
    screen[:, :2] *= 80.0 / 250.0  # spread over an 80-pixel canvas
    tables = cr.triangle_planes_corners(torch.as_tensor(np.stack([screen, screen[:, :, ::-1]])),
                                        torch.as_tensor(np.stack([rgb, rgb])))
    bins, counts = cr.bin_groups_for_tiles(tables, n_i, n_j, tile=16)
    for r in range(2):
        gb = tables[r, ::cr.GROUP, cr._BBOX_COL:cr._BBOX_COL + 4].numpy()
        for t in range(n_i * n_j):
            x0, y0 = (t % n_j) * 16, (t // n_j) * 16
            ov = ((gb[:, 1] >= x0) & (gb[:, 0] <= x0 + 15)
                  & (gb[:, 3] >= y0) & (gb[:, 2] <= y0 + 15))
            expect = np.nonzero(ov)[0] * cr.GROUP
            assert int(counts[r, t]) == len(expect)
            assert np.array_equal(bins[r, t, :len(expect)].numpy(), expect)


def test_batched_renders_match_single():
    scenes = [_random_scene(20, 12, seed=s) for s in range(3)]
    screen = torch.as_tensor(np.stack([s for s, _ in scenes]))
    rgb = torch.as_tensor(np.stack([c for _, c in scenes]))
    imgs, bgs = cr.rasterize_corners(screen, rgb, (64, 128), cull=torch.tensor([False] * 3))
    for k in range(3):
        img, bg = _port(scenes[k][0], scenes[k][1], (64, 128), cull=False)
        assert np.array_equal(bgs[k].numpy(), bg)
        np.testing.assert_array_equal(imgs[k].numpy(), img)


def test_depth_tie_first_wins():
    """Coincident triangles of different colours: the first in buffer order wins
    (strictly-closer test), in the plain version as in the CUDA kernel."""
    verts = np.float32([[10, 10, 5], [100, 10, 5], [10, 100, 5]])
    tris = np.array([[0, 1, 2], [0, 1, 2]])
    screen, _ = _corners(verts, tris, np.zeros((3, 3), np.float32))
    rgb = np.zeros((3, 3, 2), np.float32)
    rgb[:, 0, 0] = 1.0  # first triangle red
    rgb[:, 1, 1] = 1.0  # second green
    img, _ = _port(screen, rgb, (64, 128))
    assert img[30, 30, 0] == 1.0 and img[30, 30, 1] == 0.0


def test_behind_camera_and_degenerate_dropped():
    verts = np.float32([[10, 10, -5], [200, 10, -5], [10, 200, -5],
                        [50, 50, 5], [50, 50, 5], [50, 50, 5]])
    screen, rgb = _corners(verts, np.array([[0, 1, 2], [3, 4, 5]]), np.ones((6, 3), np.float32))
    _, bg = _port(screen, rgb, (256, 128))
    assert bg.all()
    table = cr.triangle_planes_corners(torch.as_tensor(screen)[None], torch.as_tensor(rgb)[None])
    assert torch.all(table[0, :, 2] == -1.0)  # never-covered w0 plane
    bins, counts = cr.bin_groups_for_tiles(table, 16, 8)
    assert int(counts.sum()) == 0


def test_kernel_shape_checks():
    """What the CUDA kernel cannot take is refused before launch."""
    z = torch.zeros
    good = (z(2, 3, 3, 40), z(2, 3, 3, 40))
    cr._check(*good, (16, 16), torch.tensor([True, False]))
    cr._check(*good, (16, 16), None)
    with pytest.raises(ValueError):
        cr._check(z(2, 3, 40), z(2, 3, 40), (16, 16), None)  # not (R, 3, 3, T)
    with pytest.raises(ValueError):
        cr._check(good[0], z(2, 3, 3, 41), (16, 16), None)  # colours disagree
    with pytest.raises(ValueError):
        cr._check(*good, (16, 16), torch.tensor([True]))  # one cull flag per render
    with pytest.raises(ValueError):
        cr._check(*good, (0, 16), None)


def test_wrapper_raises_off_cpu_without_kernel():
    """A non-CPU tensor never takes the plain version."""
    screen, rgb = _random_scene(10, 4)
    with pytest.raises(ValueError):
        cr.rasterize_corners(torch.as_tensor(screen)[None].to("meta"),
                             torch.as_tensor(rgb)[None].to("meta"), (16, 16))
