"""Triangle-mesh I/O and geometry utilities (host-side, numpy).

Replaces the reference's Open3D dependency for CAD assets: a self-contained PLY reader
(ascii + binary little-endian) standing in for o3d.io.read_triangle_mesh
(utils/cad_utils.py:21), vertex-normal computation matching Open3D's
ComputeVertexNormals (normalize the per-face cross products, average per vertex,
normalize), and a procedural car-like box mesh for tests and demos (the real Pascal3D+
CAD .ply assets are external downloads in the reference too, README.md:56-60).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple

import numpy as np

from future_urban_scene_generation_tpu_torch.utils import keypoints as kp


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3) float64
    triangles: np.ndarray  # (T, 3) int32

    def with_vertices(self, vertices: np.ndarray) -> "TriangleMesh":
        return TriangleMesh(np.asarray(vertices, np.float64), self.triangles)


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


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path) -> TriangleMesh:
    """Minimal PLY triangle-mesh reader (ascii / binary_little_endian)."""
    data = Path(path).read_bytes()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")
    fmt = None
    elements = []  # list of (name, count, properties); properties: (name, type) or ('list', count_t, item_t, name)
    for line in header[1:]:
        tok = line.strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))  # (name, type)
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    vertices = None
    faces = []
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        cursor = 0
        for name, count, props in elements:
            rows = lines[cursor: cursor + count]
            cursor += count
            if name == "vertex":
                vals = np.array([r.split()[: len(props)] for r in rows], dtype=np.float64)
                names = [p[0] for p in props]
                vertices = vals[:, [names.index("x"), names.index("y"), names.index("z")]]
            elif name == "face":
                for r in rows:
                    nums = r.split()
                    n = int(nums[0])
                    idx = list(map(int, nums[1 : 1 + n]))
                    for k3 in range(1, n - 1):  # fan-triangulate
                        faces.append((idx[0], idx[k3], idx[k3 + 1]))
    else:
        offset = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype(
                    [(p[0], "<" + _PLY_TYPES[p[1]][0]) for p in props]
                )
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                vertices = np.stack(
                    [arr[ax].astype(np.float64) for ax in ("x", "y", "z")], axis=1
                )
            elif name == "face":
                (prop,) = props  # single list property expected
                _, count_t, item_t, _ = prop
                cfmt, csz = _PLY_TYPES[count_t]
                ifmt, isz = _PLY_TYPES[item_t]
                for _ in range(count):
                    (n,) = struct.unpack_from("<" + cfmt, body, offset)
                    offset += csz
                    idx = struct.unpack_from("<" + str(n) + ifmt, body, offset)
                    offset += isz * n
                    for k3 in range(1, n - 1):
                        faces.append((idx[0], idx[k3], idx[k3 + 1]))
            else:
                # Skip unknown fixed-size elements.
                fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                offset += struct.calcsize(fmt_str) * count

    if vertices is None:
        raise ValueError(f"{path}: no vertex element")
    return TriangleMesh(vertices, np.asarray(faces, np.int32))


def save_ply_ascii(path, mesh: TriangleMesh):
    """Write an ascii PLY (for tests and asset generation)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(mesh.vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(mesh.triangles)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in mesh.vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in mesh.triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def load_cad_with_keypoints(cad_root, cad_idx: int, pascal_class: str = "car"):
    """Load pascal_{class}_cad_{idx:03d}.ply + its .yaml 3D keypoints
    (utils/cad_utils.py:8-26). Returns (TriangleMesh, (12, 3) keypoint array). The
    yaml is read by ``utils.yamlite`` (the port does not depend on PyYAML)."""
    from future_urban_scene_generation_tpu_torch.utils import yamlite

    cad_root = Path(cad_root)
    ply_path = cad_root / f"pascal_{pascal_class}_cad_{cad_idx:03d}.ply"
    mesh = load_ply(ply_path)
    kp3d_dict = yamlite.load(ply_path.with_suffix(".yaml"))["kpoints_3d"]
    return mesh, kp.dict_to_array(kp3d_dict, dim=3)


def make_test_car(
    length: float = 1.0, width: float = 0.42, height: float = 0.3, subdiv: int = 3
) -> Tuple[TriangleMesh, np.ndarray]:
    """Procedural car-like mesh (box body + cabin wedge) with plausible 12 keypoints
    in the canonical order, in a Pascal3D-like vehicle frame (x: rear->front along
    -y in the reference's convention... here: +x forward, +y left, +z up, centered).

    Used by tests and the synthetic-scene demo in place of the downloadable CAD set.
    Scale by 5 like run_test.py:148-151 to get a ~5 m vehicle.
    """
    hl, hw_, hh = length / 2, width / 2, height / 2
    cab_h = height * 0.55
    boxes = [
        # (x0, x1, y0, y1, z0, z1)
        (-hl, hl, -hw_, hw_, -hh, hh * 0.2),  # body
        (-hl * 0.55, hl * 0.35, -hw_ * 0.92, hw_ * 0.92, hh * 0.2, hh * 0.2 + cab_h),  # cabin
    ]
    verts = []
    tris = []
    for (x0, x1, y0, y1, z0, z1) in boxes:
        base = len(verts)
        n = subdiv + 1
        # 6 faces, each an n x n grid for some geometric detail.
        for axis, sign in ((0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)):
            face_base = len(verts)
            us = np.linspace(0, 1, n)
            for ui in us:
                for vi in us:
                    if axis == 0:
                        x = x0 if sign < 0 else x1
                        p = (x, y0 + ui * (y1 - y0), z0 + vi * (z1 - z0))
                    elif axis == 1:
                        y = y0 if sign < 0 else y1
                        p = (x0 + ui * (x1 - x0), y, z0 + vi * (z1 - z0))
                    else:
                        z = z0 if sign < 0 else z1
                        p = (x0 + ui * (x1 - x0), y0 + vi * (y1 - y0), z)
                    verts.append(p)
            for i in range(subdiv):
                for j in range(subdiv):
                    a = face_base + i * n + j
                    b = a + 1
                    c = a + n
                    d = c + 1
                    if sign > 0:
                        tris += [(a, c, b), (b, c, d)]
                    else:
                        tris += [(a, b, c), (b, d, c)]
        del base
    mesh = TriangleMesh(np.asarray(verts, np.float64), np.asarray(tris, np.int32))

    z_wheel = -hh
    z_light = 0.0
    z_top = hh * 0.2 + cab_h
    keypoints = np.array(
        [
            [-hl, hw_, z_light],  # left_back_trunk
            [-hl * 0.8, hw_, z_wheel],  # left_back_wheel
            [hl, hw_ * 0.9, z_light],  # left_front_light
            [hl * 0.8, hw_, z_wheel],  # left_front_wheel
            [-hl, -hw_, z_light],  # right_back_trunk
            [-hl * 0.8, -hw_, z_wheel],  # right_back_wheel
            [hl, -hw_ * 0.9, z_light],  # right_front_light
            [hl * 0.8, -hw_, z_wheel],  # right_front_wheel
            [-hl * 0.55, hw_ * 0.92, z_top],  # upper_left_rearwindow
            [hl * 0.35, hw_ * 0.92, z_top],  # upper_left_windshield
            [-hl * 0.55, -hw_ * 0.92, z_top],  # upper_right_rearwindow
            [hl * 0.35, -hw_ * 0.92, z_top],  # upper_right_windshield
        ]
    )
    return mesh, keypoints
