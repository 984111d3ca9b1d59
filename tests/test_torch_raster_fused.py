"""The plain versions that stand beside the two CUDA kernels of K1 / K1'
(``csrc/raster.cu``: triangle setup, tiles that bin for themselves) in
``ops/cuda_raster.py``, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds the setup kernel's
table bit for bit against ``triangle_planes_corners``, the tile kernel's per-tile
counts against ``bin_scan_plain`` and the images against the plain raster). Here:
the pass-by-pass compaction keeps every tile's list ascending and complete;
rejecting triangles by their own bbox changes no pixel of the plain raster; the
indexed loader's addressing equals the corner gather; the table still equals the
JAX prep's (rtol / atol 1e-6, float reassociation) and carries the right bboxes;
the launch plan.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.ops import pallas_raster as pr
from future_urban_scene_generation_tpu.utils import mesh as jmu
from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr
import torch_threads  # noqa: F401

BIG = np.float32(1e30)


def _corners(verts, tris, colors):
    screen = np.stack([verts[tris[:, k]].T for k in range(3)]).astype(np.float32)
    rgb = np.stack([colors[tris[:, k]].T for k in range(3)]).astype(np.float32)
    return screen, rgb


def _random_scene(n_verts=80, n_tris=60, seed=31):
    """The random scenes of tests/test_torch_raster.py: large triangles over 250 px."""
    r = np.random.RandomState(seed)
    verts = (r.rand(n_verts, 3) * [250, 250, 3] + [0, 0, 4]).astype(np.float32)
    tris = r.randint(0, n_verts, (n_tris, 3))
    return _corners(verts, tris, r.rand(n_verts, 3).astype(np.float32))


def _small_triangles(n_tris, hw, seed):
    """Triangles a few pixels wide spread over (and a little past) the canvas, so
    that tiles draw different, short lists; every eleventh lies behind the camera."""
    r = np.random.RandomState(seed)
    h, w = hw
    centre = r.rand(n_tris, 1, 2) * [w + 20, h + 20] - 10
    xy = centre + r.randn(n_tris, 3, 2) * 5.0
    z = r.rand(n_tris, 3, 1) * 3 + 4
    z[::11] = -1.0
    corners = np.concatenate([xy, z], -1).astype(np.float32)  # (T, corner, comp)
    return np.ascontiguousarray(corners.transpose(1, 2, 0)), r.rand(3, 3, n_tris).astype(
        np.float32)


def _car(subdiv=6):
    mesh, _ = jmu.make_test_car(subdiv=subdiv)
    n = jmu.compute_vertex_normals(mesh)
    mesh, cullable = jmu.orient_for_backface_cull(mesh)
    assert cullable
    verts = np.float32(mesh.vertices * 40 + [64, 32, 8])
    return _corners(verts, mesh.triangles, np.float32((n + 1) / 2))


def _table(screen, rgb, cull=None):
    c = None if cull is None else torch.tensor(np.atleast_1d(cull))
    s, c_ = torch.as_tensor(screen), torch.as_tensor(rgb)
    if s.dim() == 3:
        s, c_ = s[None], c_[None]
    return cr.triangle_planes_corners(s, c_, c)


def _hits(bbox, x0, y0):
    return ((bbox[..., 1] >= x0) & (bbox[..., 0] <= x0 + 15)
            & (bbox[..., 3] >= y0) & (bbox[..., 2] <= y0 + 15))


# G < 256 (one pass, partly filled), G = 256 (one full pass), G > 256 (three passes,
# the last ragged), ragged H and W, and T = 1.
@pytest.mark.parametrize("n_tris,hw", [(61, (64, 128)), (2048, (64, 64)), (4500, (90, 160)),
                                       (300, (40, 24)), (1, (32, 32))])
def test_bin_scan_matches_bin_groups(n_tris, hw):
    """Group lists equal ``bin_groups_for_tiles`` exactly; triangle lists are those
    lists filtered by each triangle's own bbox, order kept. The second render is
    empty (every triangle behind the camera)."""
    screen, rgb = _small_triangles(n_tris, hw, seed=n_tris)
    behind = screen.copy()
    behind[:, 2] = -1.0
    table = _table(np.stack([screen, behind]), np.stack([rgb, rgb]))
    n_i, n_j = -(-hw[0] // 16), -(-hw[1] // 16)
    scan = cr.bin_scan_plain(table, n_i, n_j)
    bins, counts = cr.bin_groups_for_tiles(table, n_i, n_j)
    assert torch.equal(scan.group_counts, counts)
    assert torch.equal(scan.groups, bins)
    assert int(scan.group_counts[1].sum()) == 0 and int(scan.tri_counts[1].sum()) == 0
    assert not scan.tris[1].any()
    assert cr.raster_plan(2, n_tris, *hw).passes == -(-table.shape[1] // (8 * 256))

    tb = table[0].numpy()
    tri_box, group_box = tb[:, cr._TRI_BBOX_COL:], tb[::8, cr._BBOX_COL:cr._BBOX_COL + 4]
    seen = 0
    for t in range(n_i * n_j):
        x0, y0 = (t % n_j) * 16, (t // n_j) * 16
        rows = np.nonzero(np.repeat(_hits(group_box, x0, y0), 8) & _hits(tri_box, x0, y0))[0]
        assert int(scan.tri_counts[0, t]) == len(rows)
        assert np.array_equal(scan.tris[0, t, :len(rows)].numpy(), rows)
        assert not scan.tris[0, t, len(rows):].any()
        seen += len(rows)
    if n_tris > 1:
        assert 0 < seen < int(scan.group_counts[0].sum()) * 8  # the rejection bites


def _raster_kept_triangles(screen, rgb, hw, cull):
    """The plain raster, every tile fed only the triangles ``bin_scan_plain`` keeps
    for it, in its order."""
    h, w = hw
    n_i, n_j = -(-h // 16), -(-w // 16)
    scan = cr.bin_scan_plain(_table(screen, rgb, cull), n_i, n_j)
    img = np.zeros((h, w, 3), np.float32)
    bg = np.ones((h, w), bool)
    flag = None if cull is None else torch.tensor([cull])
    for t in range(n_i * n_j):
        rows = scan.tris[0, t, :int(scan.tri_counts[0, t])].numpy()
        if len(rows) == 0:
            continue
        assert rows.max() < screen.shape[-1] and np.all(np.diff(rows) > 0)
        y0, x0 = (t // n_j) * 16, (t % n_j) * 16
        y1, x1 = min(y0 + 16, h), min(x0 + 16, w)
        # The plain raster's pixel grid starts at (0, 0): render up to the tile's end.
        ti, tb = cr.rasterize_corners_plain(torch.as_tensor(screen[..., rows])[None],
                                            torch.as_tensor(rgb[..., rows])[None], (y1, x1),
                                            cull=flag)
        img[y0:y1, x0:x1] = ti[0, y0:, x0:].numpy()
        bg[y0:y1, x0:x1] = tb[0, y0:, x0:].numpy()
    return img, bg


@pytest.mark.parametrize("scene,hw,cull", [
    ("random 60", (256, 256), None), ("random 225", (64, 128), None),
    ("random 400", (48, 80), None), ("car", (64, 128), False), ("car", (64, 128), True),
    ("small 700", (90, 160), None),
])
def test_rejection_changes_no_pixel(scene, hw, cull):
    kind, _, n = scene.partition(" ")
    if kind == "car":
        screen, rgb = _car()
    elif kind == "random":
        screen, rgb = _random_scene(n_tris=int(n))
    else:
        screen, rgb = _small_triangles(int(n), hw, seed=5)
    flag = None if cull is None else torch.tensor([cull])
    want_img, want_bg = cr.rasterize_corners_plain(torch.as_tensor(screen)[None],
                                                   torch.as_tensor(rgb)[None], hw, cull=flag)
    img, bg = _raster_kept_triangles(screen, rgb, hw, cull)
    assert (~want_bg).float().mean() > 0.02
    assert np.array_equal(bg, want_bg[0].numpy())
    assert np.array_equal(img, want_img[0].numpy())


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_indexed_loader_matches_gather(batched, dtype):
    """The indexed loader's addressing (flat buffers, clamped indices) equals
    ``gather_corners``, and so does the table built from it: T = 133 leaves three
    tail rows, which are invalid."""
    r = np.random.RandomState(3)
    n_verts, n_tris = 50, 133
    verts = torch.as_tensor((r.rand(2, n_verts, 3) * [120, 60, 3] + [0, 0, 4]).astype(np.float32))
    colors = torch.as_tensor(r.rand(2, n_verts, 3).astype(np.float32))
    tris = torch.as_tensor(r.randint(0, n_verts, (2, n_tris, 3))).to(dtype)
    if not batched:
        tris = tris[0]
    screen = cr.indexed_loader_plain(verts, tris)
    rgb = cr.indexed_loader_plain(colors, tris)
    assert screen.shape == (2, 3, 3, n_tris)
    assert torch.equal(screen, cr.gather_corners(verts, tris))
    assert torch.equal(rgb, cr.gather_corners(colors, tris))
    table = cr.triangle_planes_corners(screen, rgb)
    assert torch.equal(table, cr.triangle_planes_corners(cr.gather_corners(verts, tris),
                                                         cr.gather_corners(colors, tris)))
    assert table.shape == (2, 136, cr.TABLE_COLS)
    tail = table[:, n_tris:]
    assert torch.all(tail[..., 2] == -1.0) and torch.all(tail[..., :2] == 0.0)
    assert torch.all(tail[..., 3:cr._BBOX_COL] == 0.0)
    assert torch.all(tail[..., cr._TRI_BBOX_COL::2] >= 1e29)
    assert torch.all(tail[..., cr._TRI_BBOX_COL + 1::2] <= -1e29)
    # An index outside [0, Nv) is clamped, as the JAX package's gather clamps it.
    wild = tris.clone()
    wild[..., 0, 0], wild[..., 1, 1] = n_verts + 7, -3
    assert torch.equal(cr.indexed_loader_plain(verts, wild),
                       cr.gather_corners(verts, wild.clamp(0, n_verts - 1)))


@pytest.mark.parametrize("cull", [False, True])
def test_table_matches_jax_with_bboxes(cull):
    """Planes against the JAX prep; the triangle's bbox against numpy min / max of
    its corners, the group's against the min / max over its valid triangles."""
    screen, rgb = _random_scene(n_verts=50, n_tris=133)
    screen[:, 2, 7] = -2.0  # one triangle behind the camera
    ref, _ = pr.triangle_planes_corners(jnp.asarray(screen), jnp.asarray(rgb), jnp.asarray(cull))
    table = _table(screen, rgb, cull)[0].numpy()
    assert table.shape == (136, cr.TABLE_COLS)
    np.testing.assert_allclose(table[:, :25], np.asarray(ref)[:136, :25], rtol=1e-6, atol=1e-6)
    assert not table[:, 25:cr._TRI_BBOX_COL].any()

    x, y, z = screen[:, 0], screen[:, 1], screen[:, 2]  # (corner, T)
    area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0])
    valid = (z > 1e-6).all(0) & (np.abs(area) > 1e-12)
    if cull:
        valid &= area < 0
    assert 0 < valid.sum() < 133
    want = np.tile(np.float32([BIG, -BIG, BIG, -BIG]), (136, 1))
    want[:133][valid] = np.stack([x.min(0), x.max(0), y.min(0), y.max(0)], -1)[valid]
    assert np.array_equal(table[:, cr._TRI_BBOX_COL:], want)
    groups = want.reshape(17, 8, 4)
    group_box = np.stack([groups[..., 0].min(1), groups[..., 1].max(1),
                          groups[..., 2].min(1), groups[..., 3].max(1)], -1)
    assert np.array_equal(table[:, cr._BBOX_COL:cr._BBOX_COL + 4], np.repeat(group_box, 8, 0))


SMEM = 4 * (128 * 32 + 256 + 128 + 8)  # staged rows, group list, triangle list, warp counts


@pytest.mark.parametrize("args,want", [
    # the scene's 24 renders of 1,944 triangles at 256^2
    ((24, 1944, 256, 256), dict(t_pad=1944, n_groups=243, setup_grid=(8, 24),
                                tile_grid=(256, 24), passes=1,
                                scratch_floats=24 * (1944 * 32 + 243 * 4))),
    # the demo's one subdiv-2 car at 360x640, indexed: 22.5 tile rows
    ((1, 96, 360, 640, True), dict(t_pad=96, n_groups=12, setup_grid=(1, 1),
                                   tile_grid=(23 * 40, 1), passes=1,
                                   setup_kernel="raster_setup_kernel<IndexedLoader>")),
    # a dense mesh: ten binning passes
    ((1, 20184, 256, 256), dict(t_pad=20184, n_groups=2523, setup_grid=(79, 1), passes=10)),
    ((3, 1, 90, 160), dict(t_pad=8, n_groups=1, setup_grid=(1, 3), tile_grid=(60, 3),
                           passes=1, scratch_floats=3 * (8 * 32 + 4),
                           setup_kernel="raster_setup_kernel<CornerLoader>")),
])
def test_raster_plan(args, want):
    plan = cr.raster_plan(*args)
    assert plan.block == 256 and plan.smem == SMEM == 17952
    for key, value in want.items():
        assert getattr(plan, key) == value, key


def test_launchers_refuse_cpu_tensors():
    """The launchers are the CUDA path alone: a CPU tensor is the wrappers' business."""
    screen, rgb = _random_scene(10, 4)
    with pytest.raises(ValueError):
        cr.launch_corners(torch.as_tensor(screen)[None], torch.as_tensor(rgb)[None], (16, 16))
    v = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        cr.launch_indexed(v, torch.zeros(2, 3, dtype=torch.long), v, (16, 16))
    with pytest.raises(ValueError):
        cr.launch_indexed(v, torch.zeros(2, 3, dtype=torch.long), torch.zeros(1, 5, 3), (8, 8))
