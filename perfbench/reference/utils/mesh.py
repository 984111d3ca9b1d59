"""Frozen copy of ``future_urban_scene_generation_tpu_torch/utils/mesh.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

Triangle-mesh geometry utilities (host-side, numpy): vertex normals matching Open3D's
ComputeVertexNormals, the backface-cull orientation check and the spatial sort of
triangles that ``pipeline/runner.build_cad_bank`` applies. Departure from the source:
the PLY I/O, the procedural car and ``TriangleMesh`` are left out (the car and its
mesh type are the benchmark's input, ``perfbench/traffic/cars.py``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from perfbench.traffic.cars import TriangleMesh


def compute_vertex_normals(mesh: TriangleMesh) -> np.ndarray:
    """Open3D-style vertex normals: average of unit face normals, renormalized."""
    v = mesh.vertices
    t = mesh.triangles
    fn = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    norms = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norms, 1e-12)
    vn = np.zeros_like(v)
    for c in range(3):
        np.add.at(vn, t[:, c], fn)
    vn_norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(vn_norm, 1e-12)


def orient_for_backface_cull(mesh: TriangleMesh) -> Tuple[TriangleMesh, bool]:
    """Rewind triangles consistently outward if the mesh is a closed surface.

    Backface culling — dropping triangles that face away from the camera — is
    EXACT for a z-buffer render of a union of closed surfaces: along any view
    ray the nearest hit of a closed component is always front-facing, so culled
    triangles can never win the depth test (and the silhouette/background mask
    is the front-facing coverage). The Pallas rasterizer exploits this to skip
    ~half of every CAD mesh per render (ops/pallas_raster.py), which is only
    sound when each triangle's screen-area sign actually encodes facing — i.e.
    when the winding is globally consistent and outward.

    This establishes that property on the host at CadBank build:
      1. weld coincident vertices (CAD assets and the procedural test car both
         duplicate corner vertices per face patch);
      2. flood-fill a consistent winding across shared edges per connected
         component (flip a neighbor when it traverses the shared edge in the
         same direction);
      3. reject meshes that are not closed 2-manifolds (an edge with != 2
         incident faces) or not orientable (flood-fill conflict);
      4. point each component outward by the sign of its signed volume.

    Returns (mesh with possibly re-wound triangles, cullable flag). Winding
    flips do not change the rendered image (coverage and barycentrics are
    winding-agnostic), so the rewind is safe even where the flag ends up
    unused; vertex normals should still be computed from the ORIGINAL winding
    to match the reference's as-loaded Open3D behavior.
    """
    v = np.asarray(mesh.vertices, np.float64)
    t = np.asarray(mesh.triangles, np.int64).copy()
    if len(t) == 0:
        return mesh, False

    # 1. Weld by quantized position (tolerance relative to the bbox diagonal).
    span = float(np.linalg.norm(v.max(0) - v.min(0))) or 1.0
    q = np.round(v / (span * 1e-9)).astype(np.int64)
    _, weld = np.unique(q, axis=0, return_inverse=True)
    wt = weld[t]  # (T, 3) welded triangle indices
    if np.any((wt[:, 0] == wt[:, 1]) | (wt[:, 1] == wt[:, 2]) | (wt[:, 0] == wt[:, 2])):
        return mesh, False  # degenerate faces — don't risk it

    # Directed edge list: triangle k contributes (a,b), (b,c), (c,a).
    edges = np.stack(
        [wt[:, [0, 1]], wt[:, [1, 2]], wt[:, [2, 0]]], axis=1
    ).reshape(-1, 2)  # (3T, 2)
    undirected = np.sort(edges, axis=1)
    ukey = undirected[:, 0] << np.int64(32) | undirected[:, 1]
    order = np.argsort(ukey, kind="stable")
    sk = ukey[order]
    # 3. Closed 2-manifold: every undirected edge appears exactly twice.
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
    counts = np.diff(np.r_[starts, len(sk)])
    if np.any(counts != 2):
        return mesh, False
    # Edge pairing: rows of `order` at starts and starts+1 are the two half-edges.
    he_a, he_b = order[starts], order[starts + 1]
    tri_a, tri_b = he_a // 3, he_b // 3
    # Same direction (a->b twice) means one of the pair must flip.
    same_dir = (edges[he_a] == edges[he_b]).all(axis=1)

    # 2. Flood-fill winding consistency over the triangle adjacency graph.
    n_tri = len(wt)
    adj_head = [[] for _ in range(n_tri)]  # tri -> list of (other_tri, same_dir)
    for ta, tb, sd in zip(tri_a, tri_b, same_dir):
        adj_head[ta].append((tb, sd))
        adj_head[tb].append((ta, sd))
    flip = np.full(n_tri, -1, np.int8)  # -1 unvisited, else 0/1
    comp = np.full(n_tri, -1, np.int64)
    n_comp = 0
    for seed in range(n_tri):
        if flip[seed] >= 0:
            continue
        flip[seed] = 0
        comp[seed] = n_comp
        stack = [seed]
        while stack:
            cur = stack.pop()
            for nb, sd in adj_head[cur]:
                want = flip[cur] ^ (1 if sd else 0)
                if flip[nb] < 0:
                    flip[nb] = want
                    comp[nb] = n_comp
                    stack.append(nb)
                elif flip[nb] != want:
                    return mesh, False  # non-orientable
        n_comp += 1

    oriented = t.copy()
    flipped = flip.astype(bool)
    oriented[flipped] = oriented[flipped][:, ::-1]

    # 4. Outward by signed volume, per component.
    v0, v1, v2 = v[oriented[:, 0]], v[oriented[:, 1]], v[oriented[:, 2]]
    tri_vol = np.einsum("ij,ij->i", v0, np.cross(v1, v2)) / 6.0
    for c in range(n_comp):
        sel = comp == c
        if tri_vol[sel].sum() < 0.0:
            oriented[sel] = oriented[sel][:, ::-1]
    return TriangleMesh(mesh.vertices, oriented.astype(np.int32)), True


def spatial_sort_triangles(mesh: TriangleMesh) -> TriangleMesh:
    """Reorder triangles along a Morton (Z-order) curve of their centroids.

    Rigid projection preserves neighborhoods, so model-space locality gives
    screen-space locality for any pose: consecutive triangles land in nearby
    screen tiles, which makes the Pallas rasterizer's per-chunk screen bboxes
    tight and lets whole 128-triangle chunks skip tiles they don't touch
    (ops/pallas_raster.py). Identity on the rendered image up to depth-tie
    order between distinct coincident triangles.
    """
    v = np.asarray(mesh.vertices, np.float64)
    t = np.asarray(mesh.triangles, np.int64)
    if len(t) == 0:
        return mesh
    cent = (v[t[:, 0]] + v[t[:, 1]] + v[t[:, 2]]) / 3.0
    lo = cent.min(0)
    span = np.maximum(cent.max(0) - lo, 1e-12)
    q = np.minimum((cent - lo) / span * 1024.0, 1023.0).astype(np.uint64)

    def _spread(x):  # interleave bits with two zero gaps (10 -> 30 bits)
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = _spread(q[:, 0]) | (_spread(q[:, 1]) << np.uint64(1)) | (
        _spread(q[:, 2]) << np.uint64(2)
    )
    order = np.argsort(code, kind="stable")
    return TriangleMesh(mesh.vertices, np.asarray(mesh.triangles)[order])
