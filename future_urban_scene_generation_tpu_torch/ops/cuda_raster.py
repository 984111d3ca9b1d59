"""Kernels K1 and K1': z-buffer rasterization of triangles, batched over renders.

Counterpart of the JAX package's ops/pallas_raster.py: ``rasterize_pallas_corners``
:363 (K1, corner-expanded triangles) and ``rasterize_pallas`` :342 (K1', an indexed
mesh). There the prep (:119), the tile binning (:235) and the corner gather run in
XLA around the Pallas kernel (:279). Here the whole function is CUDA C++
(``csrc/raster.cu``), two launches a call: a setup kernel, one thread per triangle,
writes the plane table (K1' reads its corners through the vertex indices in the same
kernel), and a tile kernel, one block per render and 16x16 tile, bins the
8-triangle groups for itself, rejects triangles by their own bbox and rasterizes.

:func:`rasterize_corners` and :func:`rasterize_indexed` are the wrappers: a CPU
tensor takes the plain version (:func:`rasterize_corners_plain`, the chunked argmin
raster of the JAX package's render/rasterizer.py:87-180, behind
:func:`gather_corners` for an indexed mesh); a CUDA tensor launches the two kernels,
or raises. On the CUDA path the wrapper checks its arguments, allocates the scratch
and the outputs with ``torch.empty`` and makes one call into the library: no torch
operator computes anything. Depth ties resolve first-in-buffer-order in both
(strictly-closer test), where the Pallas kernel averaged ties across its 8 partial
buffers. Each wrapper counts its launches (``LAUNCHES``, ``INDEXED_LAUNCHES``). The
kernels take any H, W (ceil tiles, masked edges) and any T.

K1, the scene's raster, is the ``torch.library`` operator ``fusg::rasterize_corners``
with a fake implementation, so that ``torch.export`` (pipeline/aot.py) can trace a
scene through it: its CPU implementation is the plain version, its CUDA one launches
the kernels and counts the launch, and :func:`rasterize_corners` calls the operator.

Beside the kernels stand their plain versions, used by the tests and by nothing on
a CUDA path: :func:`triangle_planes_corners` (the setup kernel's table, equal bit
for bit), :func:`indexed_loader_plain` (the indexed loader's addressing),
:func:`bin_groups_for_tiles` (which groups a tile draws) and :func:`bin_scan_plain`
(the tile kernel's pass-by-pass compaction and triangle-level rejection).
:func:`raster_plan` is the launch geometry the library uses.
"""
from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Tuple

import torch

from future_urban_scene_generation_tpu_torch.ops import _kernels

_BIG = 1e30
TILE = 16  # CUDA tile: 16x16 pixels, one thread per pixel
GROUP = 8  # triangles per binned group
# A table row: 7 planes x (A, B, C) at col 3p+k, the group's bbox at 21..24, zeros,
# and the triangle's own bbox in the last four columns (one aligned 16-byte vector).
TABLE_COLS = 32
_N_PLANES = 7
_BBOX_COL = _N_PLANES * 3
_TRI_BBOX_COL = 28
BLOCK = TILE * TILE  # threads of a block, in both kernels
PASS_GROUPS = BLOCK  # groups the tile kernel tests per binning pass
STAGE_GROUPS = 16  # hit groups it consumes per stage (128 candidate triangles)
PHASE_SETUP, PHASE_TILES = 1, 2  # bits of the library's ``phases`` argument

_PLAIN_CHUNK = 128  # triangles per step of the plain version

LAUNCHES = 0  # K1: rasterize_corners
INDEXED_LAUNCHES = 0  # K1': rasterize_indexed
_COUNT_LOCK = threading.Lock()


def triangle_planes_corners(screen_xyz: torch.Tensor, color_rgb: torch.Tensor,
                            cull: torch.Tensor = None) -> torch.Tensor:
    """Per-triangle plane table for R renders.

    screen_xyz / color_rgb (R, 3 corners, 3 comps, T): per-corner (x_px, y_px,
    z_cam) and RGB. ``cull`` (R,) bool drops back-facing triangles (screen area
    >= 0) where set. Returns (R, T_pad, TABLE_COLS) float32 with T padded to a
    GROUP multiple: columns 3p..3p+2 hold plane p = (w0, w1, w2, z, r, g, b) as
    A x + B y + C, then the group screen bbox (x0, x1, y0, y1) replicated over
    the group's rows, zeros, and the triangle's own bbox in the last four columns.
    Invalid triangles (behind the camera, degenerate, culled, padding) get a
    constant -1 w0 plane and empty bboxes. The plain version of the setup kernel
    of ``csrc/raster.cu``, which repeats these operations in this order.
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
    tri_bbox = [padv(bx0, _BIG), padv(bx1, -_BIG), padv(by0, _BIG), padv(by1, -_BIG)]
    for i, bv in enumerate(tri_bbox):
        g = bv.reshape(r_n, t_pad // GROUP, GROUP)
        g = g.amin(-1) if i in (0, 2) else g.amax(-1)
        rows.append(g.repeat_interleave(GROUP, dim=-1))
    rows += [torch.zeros_like(rows[0])] * (_TRI_BBOX_COL - len(rows))
    rows += tri_bbox
    return torch.stack(rows, dim=-1).contiguous()


def _tile_origins(n_i: int, n_j: int, tile: int, device):
    """First pixel (x0, y0) of every tile, each (1, n_tiles, 1) float32."""
    t = torch.arange(n_i * n_j, device=device)
    return (((t % n_j) * tile).to(torch.float32)[None, :, None],
            ((t // n_j) * tile).to(torch.float32)[None, :, None])


def _box_hits_tile(bbox, x0, y0, tile: int):
    """The binning test: bboxes (..., 4) of (x0, x1, y0, y1) against the pixel
    centres of the tiles at (x0, y0)."""
    return ((bbox[..., 1] >= x0) & (bbox[..., 0] <= x0 + (tile - 1))
            & (bbox[..., 3] >= y0) & (bbox[..., 2] <= y0 + (tile - 1)))


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
    x0, y0 = _tile_origins(n_i, n_j, tile, table.device)
    ov = _box_hits_tile(gb[:, None], x0, y0, tile)  # (R, n_tiles, G)
    counts = ov.sum(dim=-1).to(torch.int32)
    pos = torch.cumsum(ov.to(torch.int32), dim=-1) - 1
    pos = torch.where(ov, pos, torch.full_like(pos, n_groups)).long()
    bases = (torch.arange(n_groups, device=table.device, dtype=torch.int32) * GROUP)
    bases = bases.expand(r_n, n_tiles, n_groups)
    bins = torch.zeros(r_n, n_tiles, n_groups + 1, dtype=torch.int32, device=table.device)
    bins.scatter_(-1, pos, bases)
    return bins[..., :n_groups].contiguous(), counts.contiguous()


def _ballot_slots(hit: torch.Tensor):
    """The tile kernel's ordered compaction over the threads of a block (last axis,
    a multiple of 32): a thread's slot is the popcount of its warp's ballot below
    its lane plus the popcounts of the warps below its own. Returns (slot per
    thread, number of hits)."""
    warps = hit.reshape(*hit.shape[:-1], -1, 32).to(torch.int64)
    below_lane = torch.cumsum(warps, dim=-1) - warps
    counts = warps.sum(dim=-1)
    below_warp = torch.cumsum(counts, dim=-1) - counts
    return (below_warp[..., None] + below_lane).reshape(hit.shape), counts.sum(dim=-1)


def _store_hits(dst, at, values, hit, slot):
    """dst[..., at + slot] = values where hit; ``dst`` keeps one spare last slot
    that takes the misses."""
    spare = dst.shape[-1] - 1
    index = torch.where(hit, at[..., None] + slot, torch.full_like(slot, spare))
    dst.scatter_(-1, index, values.expand_as(index).to(dst.dtype))


class BinScan(NamedTuple):
    """What every tile of every render draws, in the order it draws it."""

    groups: torch.Tensor  # (R, n_tiles, n_groups) int32 group bases, compacted
    group_counts: torch.Tensor  # (R, n_tiles) int32
    tris: torch.Tensor  # (R, n_tiles, t_pad) int32 table rows, compacted
    tri_counts: torch.Tensor  # (R, n_tiles) int32


def bin_scan_plain(table: torch.Tensor, n_i: int, n_j: int, tile: int = TILE) -> BinScan:
    """The tile kernel's binning (``raster_tiles_kernel`` in ``csrc/raster.cu``),
    repeated step by step for every (render, tile) block at once. In passes of
    ``PASS_GROUPS`` groups, thread g tests group bbox g against the tile and the
    hits are compacted in thread order (:func:`_ballot_slots`); the pass's hits are
    consumed ``STAGE_GROUPS`` groups at a time, thread i testing the bbox of
    triangle i % 8 of the stage's group i // 8, compacted the same way. Entries
    past the counts are zero."""
    r_n, t_pad = table.shape[:2]
    n_groups, n_tiles, dev = t_pad // GROUP, n_i * n_j, table.device
    x0, y0 = _tile_origins(n_i, n_j, tile, dev)
    group_bbox = table[:, ::GROUP, _BBOX_COL:_BBOX_COL + 4]  # the kernel's compact array
    tri_bbox = table[:, None, :, _TRI_BBOX_COL:].expand(r_n, n_tiles, t_pad, 4)
    groups = torch.zeros((r_n, n_tiles, n_groups + 1), dtype=torch.int32, device=dev)
    tris = torch.zeros((r_n, n_tiles, t_pad + 1), dtype=torch.int32, device=dev)
    group_counts = torch.zeros((r_n, n_tiles), dtype=torch.int64, device=dev)
    tri_counts = torch.zeros_like(group_counts)
    thread = torch.arange(PASS_GROUPS, device=dev)
    cand_thread = thread[:STAGE_GROUPS * GROUP]
    for base in range(0, n_groups, PASS_GROUPS):
        g = base + thread
        bbox = group_bbox[:, None, g.clamp(max=n_groups - 1)]  # (R, 1, threads, 4)
        hit = (g < n_groups) & _box_hits_tile(bbox, x0, y0, tile)
        slot, n_hit = _ballot_slots(hit)
        s_groups = torch.zeros((r_n, n_tiles, PASS_GROUPS + 1), dtype=torch.int64, device=dev)
        _store_hits(s_groups, torch.zeros_like(n_hit), g, hit, slot)
        _store_hits(groups, group_counts, g * GROUP, hit, slot)
        group_counts += n_hit
        for start in range(0, int(n_hit.max()), STAGE_GROUPS):
            n_cand = (n_hit - start).clamp(0, STAGE_GROUPS) * GROUP
            cand = cand_thread < n_cand[..., None]
            row = s_groups[..., start + cand_thread // GROUP] * GROUP + cand_thread % GROUP
            row = torch.where(cand, row, torch.zeros_like(row))
            bbox = torch.gather(tri_bbox, 2, row[..., None].expand(*row.shape, 4))
            tri_hit = cand & _box_hits_tile(bbox, x0, y0, tile)
            tri_slot, n_t = _ballot_slots(tri_hit)
            _store_hits(tris, tri_counts, row, tri_hit, tri_slot)
            tri_counts += n_t
    return BinScan(groups[..., :n_groups].contiguous(), group_counts.to(torch.int32),
                   tris[..., :t_pad].contiguous(), tri_counts.to(torch.int32))


class RasterPlan(NamedTuple):
    """The launch geometry of one raster call (``geometry`` / ``launch`` in
    ``csrc/raster.cu``; ``fusg_raster_plan`` is the library's own account)."""

    t_pad: int  # triangles rounded up to a GROUP multiple: rows of the table
    n_groups: int
    setup_grid: tuple  # blocks of the setup kernel: (triangle blocks, renders)
    tile_grid: tuple  # blocks of the tile kernel: (tiles, renders)
    block: int  # threads a block, both kernels
    passes: int  # binning passes of a tile block
    smem: int  # bytes of shared memory of the tile kernel
    scratch_floats: int  # table (R, t_pad, 32), then group bboxes (R, n_groups, 4)
    setup_kernel: str  # which loader the setup kernel runs with


def raster_plan(r_n: int, n_tris: int, h: int, w: int, indexed: bool = False) -> RasterPlan:
    """How a call on R renders of T triangles at (h, w) is launched."""
    n_groups = -(-n_tris // GROUP)
    t_pad = n_groups * GROUP
    n_tiles = -(-h // TILE) * -(-w // TILE)
    stage_tris = STAGE_GROUPS * GROUP
    # staged rows, the pass's group list, the stage's triangle list, per-warp counts
    smem = 4 * (stage_tris * TABLE_COLS + PASS_GROUPS + stage_tris + BLOCK // 32)
    return RasterPlan(
        t_pad, n_groups, (-(-t_pad // BLOCK), r_n), (n_tiles, r_n), BLOCK,
        -(-n_groups // PASS_GROUPS), smem, r_n * (t_pad * TABLE_COLS + n_groups * 4),
        "raster_setup_kernel<IndexedLoader>" if indexed else "raster_setup_kernel<CornerLoader>",
    )


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


class RasterOut(NamedTuple):
    image: torch.Tensor  # (R, H, W, 3) float32
    background: torch.Tensor  # (R, H, W) bool
    scratch: torch.Tensor  # flat float32: see :func:`scratch_views`
    tile_counts: torch.Tensor  # (R, n_tiles, 2) int32 (groups, triangles) or None


def scratch_views(scratch: torch.Tensor, r_n: int, n_tris: int):
    """(table (R, t_pad, TABLE_COLS), group bboxes (R, n_groups, 4)) of a launch's
    scratch."""
    plan = raster_plan(r_n, n_tris, 1, 1)
    n_table = r_n * plan.t_pad * TABLE_COLS
    return (scratch[:n_table].view(r_n, plan.t_pad, TABLE_COLS),
            scratch[n_table:].view(r_n, plan.n_groups, 4))


def _launch(entry: str, inputs: tuple, r_n: int, n_tris: int, out_hw, device, phases,
            scratch, tile_counts) -> RasterOut:
    """Allocate the scratch and the outputs and make the one library call that
    launches the setup and tile kernels on the current stream."""
    h, w = out_hw
    plan = raster_plan(r_n, n_tris, h, w)
    if scratch is None:
        scratch = torch.empty(plan.scratch_floats, dtype=torch.float32, device=device)
    img = torch.empty((r_n, h, w, 3), dtype=torch.float32, device=device)
    bg = torch.empty((r_n, h, w), dtype=torch.bool, device=device)
    counts = None
    if tile_counts:
        counts = torch.empty((r_n, plan.tile_grid[0], 2), dtype=torch.int32, device=device)
    table_ptr = scratch.data_ptr()
    rc = getattr(_kernels.load(), entry)(
        *inputs, table_ptr, table_ptr + 4 * r_n * plan.t_pad * TABLE_COLS, img.data_ptr(),
        bg.data_ptr(), None if counts is None else counts.data_ptr(), r_n, n_tris, h, w,
        phases, torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return RasterOut(img, bg, scratch, counts)


def launch_corners(screen_xyz, color_rgb, out_hw, cull=None, *,
                   phases: int = PHASE_SETUP | PHASE_TILES, scratch=None,
                   tile_counts: bool = False) -> RasterOut:
    """Launch K1's kernels on CUDA tensors. ``phases`` picks the setup kernel, the
    tile kernel or both; the tile kernel alone reads a ``scratch`` an earlier
    launch at the same shapes wrote. ``tile_counts`` asks for the tile kernel's
    per-tile (groups, triangles) counts. Counts no launch: each entry point counts
    its own."""
    _check(screen_xyz, color_rgb, out_hw, cull)
    if screen_xyz.device.type != "cuda":
        raise ValueError(f"launch_corners: the kernels need CUDA tensors, got "
                         f"{screen_xyz.device}")
    screen = screen_xyz.to(torch.float32).contiguous()
    colors = color_rgb.to(torch.float32).contiguous()
    flags = None if cull is None else cull.to(torch.bool).contiguous()
    inputs = (screen.data_ptr(), colors.data_ptr(),
              None if flags is None else flags.data_ptr())
    return _launch("fusg_raster_corners", inputs, screen.shape[0], screen.shape[-1], out_hw,
                   screen.device, phases, scratch, tile_counts)


@torch.library.custom_op("fusg::rasterize_corners", mutates_args=(), device_types="cpu")
def _rasterize_corners_op(screen_xyz: torch.Tensor, color_rgb: torch.Tensor,
                          out_hw: List[int], cull: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as the operator ``fusg::rasterize_corners``, so that a program exported with
    ``torch.export`` (pipeline/aot.py) holds the raster as one node: the plain version
    on CPU tensors, the kernels on CUDA tensors."""
    return rasterize_corners_plain(screen_xyz, color_rgb, tuple(out_hw), cull)


@_rasterize_corners_op.register_kernel("cuda")
def _rasterize_corners_cuda(screen_xyz, color_rgb, out_hw, cull):
    global LAUNCHES
    out = launch_corners(screen_xyz, color_rgb, tuple(out_hw), cull)
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        LAUNCHES += 1
    return out.image, out.background


@_rasterize_corners_op.register_fake
def _rasterize_corners_fake(screen_xyz, color_rgb, out_hw, cull):
    h, w = out_hw
    r_n = screen_xyz.shape[0]
    return (screen_xyz.new_empty((r_n, h, w, 3), dtype=torch.float32),
            screen_xyz.new_empty((r_n, h, w), dtype=torch.bool))


def rasterize_corners(screen_xyz: torch.Tensor, color_rgb: torch.Tensor, out_hw,
                      cull: torch.Tensor = None):
    """Rasterize R renders of corner-expanded triangles (R, 3, 3, T) ->
    (image (R, H, W, 3), background mask (R, H, W)), through ``fusg::rasterize_corners``:
    CPU tensors take the plain version; CUDA tensors launch kernel K1."""
    if screen_xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rasterize_corners: unsupported device {screen_xyz.device}")
    return _rasterize_corners_op(screen_xyz, color_rgb, [int(n) for n in out_hw], cull)


def _check_indexed(verts: torch.Tensor, triangles: torch.Tensor):
    if verts.dim() != 3 or verts.shape[-1] != 3:
        raise ValueError(f"rasterize_indexed: vertices {tuple(verts.shape)} are not (R, Nv, 3)")
    if triangles.dtype not in (torch.int32, torch.int64) or triangles.shape[-1] != 3 \
            or triangles.dim() not in (2, 3) or triangles.device != verts.device:
        raise ValueError("rasterize_indexed: triangles must be integer (T, 3) or (R, T, 3) "
                         "on the vertices' device")
    if triangles.dim() == 3 and triangles.shape[0] != verts.shape[0]:
        raise ValueError("rasterize_indexed: triangles' batch must match the vertices'")


def gather_corners(verts: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """Per-vertex rows (R, Nv, 3) gathered through triangle indices (T, 3) or
    (R, T, 3) into the corner layout (R, 3 corners, 3 comps, T)."""
    _check_indexed(verts, triangles)
    r_n = verts.shape[0]
    tri = triangles.long()
    if tri.dim() == 2:
        tri = tri.expand(r_n, *tri.shape)
    t = tri.shape[1]
    # (R, T*3, 3) rows in (triangle, corner) order -> (R, corner, comp, T)
    rows = torch.gather(verts, 1, tri.reshape(r_n, t * 3, 1).expand(r_n, t * 3, 3))
    return rows.reshape(r_n, t, 3, 3).permute(0, 2, 3, 1).contiguous()


def indexed_loader_plain(verts: torch.Tensor, triangles: torch.Tensor) -> torch.Tensor:
    """The corners as the indexed setup kernel's loader addresses them
    (``IndexedLoader`` in ``csrc/raster.cu``): corner k of triangle t of render r is
    the three floats at ``(r * Nv + i) * 3`` of the flat vertex buffer, with
    ``i = tris[((r if batched else 0) * T + t) * 3 + k]`` clamped to [0, Nv).
    -> (R, 3 corners, 3 comps, T), the layout of :func:`gather_corners`."""
    _check_indexed(verts, triangles)
    r_n, n_verts = verts.shape[:2]
    batched = triangles.dim() == 3
    n_tris = triangles.shape[-2]
    flat_tris, flat_verts = triangles.reshape(-1), verts.reshape(-1)
    r = torch.arange(r_n, device=verts.device)[:, None, None, None]
    k = torch.arange(3, device=verts.device)[None, :, None, None]
    m = torch.arange(3, device=verts.device)[None, None, :, None]
    t = torch.arange(n_tris, device=verts.device)[None, None, None, :]
    i = flat_tris[((r if batched else 0) * n_tris + t) * 3 + k].long().clamp(0, n_verts - 1)
    return flat_verts[(r * n_verts + i) * 3 + m]


def rasterize_indexed_plain(verts_screen, triangles, vert_colors, out_hw):
    """Plain version of K1': the corner gather in front of
    :func:`rasterize_corners_plain`."""
    return rasterize_corners_plain(gather_corners(verts_screen, triangles),
                                   gather_corners(vert_colors, triangles), out_hw)


def launch_indexed(verts_screen, triangles, vert_colors, out_hw, *,
                   phases: int = PHASE_SETUP | PHASE_TILES, scratch=None,
                   tile_counts: bool = False) -> RasterOut:
    """Launch K1''s kernels on CUDA tensors: the setup kernel reads each triangle's
    corners through its vertex indices. Arguments as :func:`launch_corners`."""
    _check_indexed(verts_screen, triangles)
    if vert_colors.shape != verts_screen.shape or vert_colors.device != verts_screen.device:
        raise ValueError("rasterize_indexed: vert_colors must match verts_screen's "
                         "shape/device")
    if verts_screen.device.type != "cuda":
        raise ValueError(f"launch_indexed: the kernels need CUDA tensors, got "
                         f"{verts_screen.device}")
    if not (0 < out_hw[0] and 0 < out_hw[1]):
        raise ValueError(f"rasterize_indexed: empty output {out_hw}")
    verts = verts_screen.to(torch.float32).contiguous()
    colors = vert_colors.to(torch.float32).contiguous()
    tris = triangles.contiguous()
    inputs = (verts.data_ptr(), colors.data_ptr(), tris.data_ptr(),
              int(tris.dtype == torch.int64), int(tris.dim() == 3), verts.shape[1])
    return _launch("fusg_raster_indexed", inputs, verts.shape[0], tris.shape[-2], out_hw,
                   verts.device, phases, scratch, tile_counts)


def rasterize_indexed(verts_screen: torch.Tensor, triangles: torch.Tensor,
                      vert_colors: torch.Tensor, out_hw):
    """Kernel K1': rasterize R indexed meshes. verts_screen (R, Nv, 3) of (x_px,
    y_px, z_cam), triangles (T, 3) or (R, T, 3) integer, vert_colors (R, Nv, 3)
    -> (image (R, H, W, 3), background mask (R, H, W)). CPU tensors take the plain
    version (the corners gathered with torch indexing); CUDA tensors launch the
    CUDA kernels with the indexed loader (counted in ``INDEXED_LAUNCHES``)."""
    global INDEXED_LAUNCHES
    if verts_screen.device.type == "cpu":
        return rasterize_indexed_plain(verts_screen, triangles, vert_colors, out_hw)
    if verts_screen.device.type != "cuda":
        raise ValueError(f"rasterize_indexed: unsupported device {verts_screen.device}")
    out = launch_indexed(verts_screen, triangles, vert_colors, out_hw)
    with _COUNT_LOCK:  # scenes of several streams launch from worker threads
        INDEXED_LAUNCHES += 1
    return out.image, out.background
