"""The procedural test car the benchmark's CAD banks are made of: a frozen copy of
``make_test_car`` and ``TriangleMesh`` from
``future_urban_scene_generation_tpu_torch/utils/mesh.py`` at commit a2138eb.

A box body and a cabin wedge, each face an (subdiv + 1)^2 grid, with 12 keypoints in
the canonical Pascal3D+ order; ``subdiv=9`` gives 1,944 triangles, the density of the
reference's Pascal3D+ CADs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class TriangleMesh:
    vertices: np.ndarray  # (V, 3) float64
    triangles: np.ndarray  # (T, 3) int32

    def with_vertices(self, vertices: np.ndarray) -> "TriangleMesh":
        return TriangleMesh(np.asarray(vertices, np.float64), self.triangles)


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
