"""Kernels K1 and K1': z-buffer rasterization of triangles, batched over renders.

Counterpart of the JAX package's ops/pallas_raster.py: ``rasterize_pallas_corners``
:363 (K1, corner-expanded triangles) and ``rasterize_pallas`` :342 (K1', an indexed
mesh whose corners are gathered in front of the same kernel ``_kernel`` :279). The
prep (:func:`triangle_planes_corners`, affine barycentric/depth/RGB planes per
triangle) and the tile binning
(:func:`bin_groups_for_tiles`) stay plain torch on the device, batched over R
renders, as the JAX package runs them in XLA outside its kernel. The CUDA kernel
(``csrc/raster.cu``) walks each 16x16 tile's bin list.

:func:`rasterize_corners` is the wrapper the scene calls: a CPU tensor takes the
plain version :func:`rasterize_corners_plain` (the chunked argmin raster of the JAX
package's render/rasterizer.py:87-180); a CUDA tensor launches the kernel, or
raises. Depth ties resolve first-in-buffer-order in both (strictly-closer test),
where the Pallas kernel averaged ties across its 8 partial buffers.
:func:`rasterize_indexed` is the second entry on the same CUDA kernel, with its own
launch counter and its plain version :func:`rasterize_indexed_plain`. The kernel
takes any H, W (ceil tiles, masked edges) and any T.
"""
from __future__ import annotations

import ctypes

import torch

from future_urban_scene_generation_tpu_torch.ops import _kernels

_BIG = 1e30
TILE = 16  # CUDA tile: 16x16 pixels, one thread per pixel
GROUP = 8  # triangles per binned group
TABLE_COLS = 32  # 7 planes x (A, B, C) at col 3p+k, then the group bbox, then pad
_N_PLANES = 7
_BBOX_COL = _N_PLANES * 3

_PLAIN_CHUNK = 128  # triangles per step of the plain version

LAUNCHES = 0  # K1: rasterize_corners
INDEXED_LAUNCHES = 0  # K1': rasterize_indexed


def triangle_planes_corners(screen_xyz: torch.Tensor, color_rgb: torch.Tensor,
                            cull: torch.Tensor = None) -> torch.Tensor:
    """Per-triangle plane table for R renders.

    screen_xyz / color_rgb (R, 3 corners, 3 comps, T): per-corner (x_px, y_px,
    z_cam) and RGB. ``cull`` (R,) bool drops back-facing triangles (screen area
    >= 0) where set. Returns (R, T_pad, TABLE_COLS) float32 with T padded to a
    GROUP multiple: columns 3p..3p+2 hold plane p = (w0, w1, w2, z, r, g, b) as
    A x + B y + C, then the group screen bbox (x0, x1, y0, y1) replicated over
    the group's rows. Invalid triangles (behind the camera, degenerate, culled,
    padding) get a constant -1 w0 plane and empty bboxes.
    """
    (v0x, v0y, v0z), (v1x, v1y, v1z), (v2x, v2y, v2z) = (
        corner.unbind(1) for corner in screen_xyz.unbind(1)
    )
    c0, c1, c2 = color_rgb.unbind(1)  # each (R, 3, T)

    area = (v1x - v0x) * (v2y - v0y) - (v1y - v0y) * (v2x - v0x)
    front = (v0z > 1e-6) & (v1z > 1e-6) & (v2z > 1e-6)
    valid = front & (torch.abs(area) > 1e-12)
    if cull is not None:
        valid = valid & (~cull[:, None] | (area < 0.0))
    safe_area = torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
    inv_area = torch.where(valid, 1.0 / safe_area, torch.zeros_like(area))

    def edge_plane(ax, ay, bx, by):
        return -(by - ay), bx - ax, (by - ay) * ax - (bx - ax) * ay

    planes = []
    for (a, b, c) in (edge_plane(v1x, v1y, v2x, v2y),
                      edge_plane(v2x, v2y, v0x, v0y),
                      edge_plane(v0x, v0y, v1x, v1y)):
        planes += [a * inv_area, b * inv_area, c * inv_area]
    w0a, w0b, w0c, w1a, w1b, w1c, w2a, w2b, w2c = planes

    def interp_plane(q0, q1, q2):
        return (
            w0a * q0 + w1a * q1 + w2a * q2,
            w0b * q0 + w1b * q1 + w2b * q2,
            w0c * q0 + w1c * q1 + w2c * q2,
        )

    z_pl = interp_plane(v0z, v1z, v2z)
    r_pl = interp_plane(c0[:, 0], c1[:, 0], c2[:, 0])
    g_pl = interp_plane(c0[:, 1], c1[:, 1], c2[:, 1])
    b_pl = interp_plane(c0[:, 2], c1[:, 2], c2[:, 2])

    zero = torch.zeros_like(w0c)
    w0a = torch.where(valid, w0a, zero)
    w0b = torch.where(valid, w0b, zero)
    w0c = torch.where(valid, w0c, torch.full_like(w0c, -1.0))
    big = torch.full_like(v0x, _BIG)
    bx0 = torch.where(valid, torch.minimum(torch.minimum(v0x, v1x), v2x), big)
    bx1 = torch.where(valid, torch.maximum(torch.maximum(v0x, v1x), v2x), -big)
    by0 = torch.where(valid, torch.minimum(torch.minimum(v0y, v1y), v2y), big)
    by1 = torch.where(valid, torch.maximum(torch.maximum(v0y, v1y), v2y), -big)

    r_n, t_total = w0c.shape
    pad = (-t_total) % GROUP
    t_pad = t_total + pad

    def padv(x, fill=0.0):
        return torch.nn.functional.pad(x.to(torch.float32), (0, pad), value=fill)

    rows = [padv(w0a), padv(w0b), padv(w0c, -1.0),
            padv(w1a), padv(w1b), padv(w1c),
            padv(w2a), padv(w2b), padv(w2c)]
    for pl in (z_pl, r_pl, g_pl, b_pl):
        rows += [padv(x) for x in pl]
    for i, bv in enumerate((padv(bx0, _BIG), padv(bx1, -_BIG),
                            padv(by0, _BIG), padv(by1, -_BIG))):
        g = bv.reshape(r_n, t_pad // GROUP, GROUP)
        g = g.amin(-1) if i in (0, 2) else g.amax(-1)
        rows.append(g.repeat_interleave(GROUP, dim=-1))
    rows += [torch.zeros_like(rows[0])] * (TABLE_COLS - len(rows))
    return torch.stack(rows, dim=-1).contiguous()


def bin_groups_for_tiles(table: torch.Tensor, n_i: int, n_j: int, tile: int = TILE):
    """Per-tile compacted lists of overlapping group bases, for R renders.

    Intersects every GROUP-triangle group's screen bbox with the (n_i, n_j) grid
    of ``tile``-pixel tiles and compacts the matching group bases (row index of
    the group's first triangle) to the front of each tile's row, ascending.
    Returns (bins (R, n_tiles, n_groups) int32, counts (R, n_tiles) int32);
    entries past counts are zero and never read.
    """
    r_n = table.shape[0]
    gb = table[:, ::GROUP, _BBOX_COL:_BBOX_COL + 4]  # (R, G, 4) x0 x1 y0 y1
    n_groups = gb.shape[1]
    n_tiles = n_i * n_j
    t = torch.arange(n_tiles, device=table.device)
    x0 = ((t % n_j) * tile).to(torch.float32)[None, :, None]
    y0 = ((t // n_j) * tile).to(torch.float32)[None, :, None]
    ov = (
        (gb[:, None, :, 1] >= x0) & (gb[:, None, :, 0] <= x0 + (tile - 1))
        & (gb[:, None, :, 3] >= y0) & (gb[:, None, :, 2] <= y0 + (tile - 1))
    )  # (R, n_tiles, G)
    counts = ov.sum(dim=-1).to(torch.int32)
    pos = torch.cumsum(ov.to(torch.int32), dim=-1) - 1
    pos = torch.where(ov, pos, torch.full_like(pos, n_groups)).long()
    bases = (torch.arange(n_groups, device=table.device, dtype=torch.int32) * GROUP)
    bases = bases.expand(r_n, n_tiles, n_groups)
    bins = torch.zeros(r_n, n_tiles, n_groups + 1, dtype=torch.int32, device=table.device)
    bins.scatter_(-1, pos, bases)
    return bins[..., :n_groups].contiguous(), counts.contiguous()


def rasterize_corners_plain(screen_xyz: torch.Tensor, color_rgb: torch.Tensor,
                            out_hw, cull: torch.Tensor = None):
    """Plain version of K1: the chunked argmin raster (edge functions at every
    pixel per triangle chunk, first nearest triangle per chunk, strictly-closer
    merge across chunks), one render at a time.

    screen_xyz / color_rgb (R, 3, 3, T); cull (R,) bool or None. Returns (image
    (R, H, W, 3) float32, background mask (R, H, W) bool)."""
    h, w = out_hw
    dev = screen_xyz.device
    r_n, t_total = screen_xyz.shape[0], screen_xyz.shape[-1]
    chunk = _PLAIN_CHUNK
    pad = (-t_total) % chunk
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    images, masks = [], []
    for r in range(r_n):
        sc = torch.nn.functional.pad(screen_xyz[r].to(torch.float32), (0, pad))
        co = torch.nn.functional.pad(color_rgb[r].to(torch.float32), (0, pad))
        zbuf = torch.full((h, w), _BIG, dtype=torch.float32, device=dev)
        img = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        for s in range(0, t_total + pad, chunk):
            vc = sc[..., s:s + chunk].permute(2, 0, 1)  # (C, 3 corners, 3)
            cc = co[..., s:s + chunk].permute(2, 0, 1)
            tri_valid = (torch.arange(s, s + chunk, device=dev) < t_total)
            v0, v1, v2 = vc[:, 0], vc[:, 1], vc[:, 2]
            c0, c1, c2 = cc[:, 0], cc[:, 1], cc[:, 2]
            front = (v0[:, 2] > 1e-6) & (v1[:, 2] > 1e-6) & (v2[:, 2] > 1e-6) & tri_valid

            def edge(a, b):
                return (b[:, 0, None, None] - a[:, 0, None, None]) * (
                    ys - a[:, 1, None, None]
                ) - (b[:, 1, None, None] - a[:, 1, None, None]) * (xs - a[:, 0, None, None])

            e01 = edge(v0, v1)
            e12 = edge(v1, v2)
            e20 = edge(v2, v0)
            area = (
                (v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0])
            )[:, None, None]
            pos = (e01 >= 0) & (e12 >= 0) & (e20 >= 0)
            neg = (e01 <= 0) & (e12 <= 0) & (e20 <= 0)
            covered = torch.where(area > 0, pos, neg) & (torch.abs(area) > 1e-12)
            covered = covered & front[:, None, None]
            if cull is not None:
                covered = covered & (~cull[r] | (area < 0.0))
            safe_area = torch.where(torch.abs(area) < 1e-12, torch.ones_like(area), area)
            w0 = e12 / safe_area
            w1 = e20 / safe_area
            w2 = e01 / safe_area
            z = w0 * v0[:, 2, None, None] + w1 * v1[:, 2, None, None] + w2 * v2[:, 2, None, None]
            z = torch.where(covered, z, torch.full_like(z, _BIG))
            best = torch.argmin(z, dim=0)
            best_z = torch.gather(z, 0, best[None])[0]
            bw0 = torch.gather(w0, 0, best[None])[0]
            bw1 = torch.gather(w1, 0, best[None])[0]
            bw2 = torch.gather(w2, 0, best[None])[0]
            color = bw0[..., None] * c0[best] + bw1[..., None] * c1[best] + bw2[..., None] * c2[best]
            closer = best_z < zbuf
            zbuf = torch.where(closer, best_z, zbuf)
            img = torch.where(closer[..., None], color, img)
        mask_bg = zbuf >= _BIG
        images.append(torch.where(mask_bg[..., None], torch.zeros_like(img), img))
        masks.append(mask_bg)
    return torch.stack(images), torch.stack(masks)


def _check(screen_xyz, color_rgb, out_hw, cull):
    if screen_xyz.dim() != 4 or tuple(screen_xyz.shape[1:3]) != (3, 3):
        raise ValueError(f"rasterize_corners: screen_xyz {tuple(screen_xyz.shape)} is not "
                         "(R, 3, 3, T)")
    if color_rgb.shape != screen_xyz.shape or color_rgb.device != screen_xyz.device:
        raise ValueError("rasterize_corners: color_rgb must match screen_xyz's shape/device")
    if cull is not None and (tuple(cull.shape) != (screen_xyz.shape[0],)
                             or cull.device != screen_xyz.device):
        raise ValueError("rasterize_corners: cull must be (R,) on screen_xyz's device")
    h, w = out_hw
    if not (0 < h and 0 < w):
        raise ValueError(f"rasterize_corners: empty output {out_hw}")


def raster_prep(screen_xyz, color_rgb, out_hw, cull=None):
    """The torch half of K1 on the device: the plane table and the per-tile bin
    lists for ceil(H / TILE) x ceil(W / TILE) tiles (any H, W). Returns (table,
    bins, counts), the inputs of :func:`launch_raster`."""
    _check(screen_xyz, color_rgb, out_hw, cull)
    h, w = out_hw
    table = triangle_planes_corners(screen_xyz.to(torch.float32),
                                    color_rgb.to(torch.float32), cull)
    bins, counts = bin_groups_for_tiles(table, -(-h // TILE), -(-w // TILE))
    return table, bins, counts


def launch_raster(table, bins, counts, out_hw):
    """Launch the CUDA kernel on a prepared table and bin lists (CUDA tensors of
    :func:`raster_prep`). Counts no launch: each entry point counts its own."""
    h, w = out_hw
    if table.device.type != "cuda":
        raise ValueError(f"launch_raster: the kernel needs CUDA tensors, got {table.device}")
    r_n, t_pad = table.shape[0], table.shape[1]
    n_i, n_j = -(-h // TILE), -(-w // TILE)
    img = torch.empty((r_n, h, w, 3), dtype=torch.float32, device=table.device)
    bg = torch.empty((r_n, h, w), dtype=torch.bool, device=table.device)
    lib = _kernels.load()
    rc = lib.fusg_raster(
        ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(bins.data_ptr()),
        ctypes.c_void_p(counts.data_ptr()), ctypes.c_void_p(img.data_ptr()),
        ctypes.c_void_p(bg.data_ptr()), r_n, t_pad, t_pad // GROUP, h, w, n_i, n_j,
        ctypes.c_void_p(torch.cuda.current_stream(table.device).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"fusg_raster launch failed: CUDA error {rc}")
    return img, bg


def rasterize_corners(screen_xyz: torch.Tensor, color_rgb: torch.Tensor, out_hw,
                      cull: torch.Tensor = None):
    """Rasterize R renders of corner-expanded triangles (R, 3, 3, T) ->
    (image (R, H, W, 3), background mask (R, H, W)). CPU tensors take the plain
    version; CUDA tensors launch kernel K1."""
    global LAUNCHES
    if screen_xyz.device.type == "cpu":
        return rasterize_corners_plain(screen_xyz, color_rgb, out_hw, cull)
    if screen_xyz.device.type != "cuda":
        raise ValueError(f"rasterize_corners: unsupported device {screen_xyz.device}")
    out = launch_raster(*raster_prep(screen_xyz, color_rgb, out_hw, cull), out_hw)
    LAUNCHES += 1
    return out


def gather_corners(verts: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Per-vertex rows (R, Nv, 3) gathered through triangle indices (T, 3) or
    (R, T, 3) into the corner layout (R, 3 corners, 3 comps, T)."""
    if verts.dim() != 3 or verts.shape[-1] != 3:
        raise ValueError(f"rasterize_indexed: vertices {tuple(verts.shape)} are not (R, Nv, 3)")
    if triangles.dtype not in (torch.int32, torch.int64) or triangles.shape[-1] != 3 \
            or triangles.dim() not in (2, 3) or triangles.device != verts.device:
        raise ValueError("rasterize_indexed: triangles must be integer (T, 3) or (R, T, 3) "
                         "on the vertices' device")
    r_n = verts.shape[0]
    tri = triangles.long()
    if tri.dim() == 2:
        tri = tri.expand(r_n, *tri.shape)
    elif tri.shape[0] != r_n:
        raise ValueError("rasterize_indexed: triangles' batch must match the vertices'")
    t = tri.shape[1]
    # (R, T*3, 3) rows in (triangle, corner) order -> (R, corner, comp, T)
    rows = torch.gather(verts, 1, tri.reshape(r_n, t * 3, 1).expand(r_n, t * 3, 3))
    return rows.reshape(r_n, t, 3, 3).permute(0, 2, 3, 1).contiguous()


def rasterize_indexed_plain(verts_screen, triangles, vert_colors, out_hw):
    """Plain version of K1': the corner gather in front of
    :func:`rasterize_corners_plain`."""
    return rasterize_corners_plain(gather_corners(verts_screen, triangles),
                                   gather_corners(vert_colors, triangles), out_hw)


def rasterize_indexed(verts_screen: torch.Tensor, triangles: torch.Tensor,
                      vert_colors: torch.Tensor, out_hw):
    """Kernel K1': rasterize R indexed meshes. verts_screen (R, Nv, 3) of (x_px,
    y_px, z_cam), triangles (T, 3) or (R, T, 3) integer, vert_colors (R, Nv, 3)
    -> (image (R, H, W, 3), background mask (R, H, W)). The corners are gathered
    with torch indexing, as the JAX package gathers them outside its kernel body;
    CPU tensors then take the plain version, CUDA tensors launch the CUDA kernel
    of K1 (counted in ``INDEXED_LAUNCHES``)."""
    global INDEXED_LAUNCHES
    if verts_screen.device.type == "cpu":
        return rasterize_indexed_plain(verts_screen, triangles, vert_colors, out_hw)
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize_indexed: unsupported device {verts_screen.device}")
    screen = gather_corners(verts_screen, triangles)
    colors = gather_corners(vert_colors, triangles)
    out = launch_raster(*raster_prep(screen, colors, out_hw), out_hw)
    INDEXED_LAUNCHES += 1
    return out
