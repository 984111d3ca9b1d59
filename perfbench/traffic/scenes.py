"""The camera stream's inputs, made from the seed: one generator for every stream
cell, driven by the parameters in ``cells/<cell>.json``'s ``traffic`` object.

A pool of ``pool`` scenes is made once and cycled through the window. Each scene is
a uint8 frame and background of the configuration's size, V vehicles and their
trajectories. The layout is the JAX package's benchmark scene
(``future_urban_scene_generation_tpu_torch/pipeline/synthetic.make_bench_scene`` at
commit a2138eb): the camera tilted by pi / 2.4, vehicle v at yaw 0.4 + 0.3 v, lateral
offset -6 + 4 (v % 4) m, 2 m below the camera, 25 + 3 (v % 4) + 0.7 (v // 4) m ahead;
here each pose is jittered from the seed (``yaw_jitter``, ``offset_jitter_m``), the
vehicle's CAD is drawn from the bank, and its box is its CAD's keypoints projected,
padded by ``box_pad_px``. Trajectories run at a constant speed drawn from
``speed_mps``, ``dt_s`` apart, heading 0.2 v plus a jitter. Every seed gives the same
shapes, so the work of a scene does not depend on the seed.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np

from perfbench.traffic.cars import make_test_car


class Scene(NamedTuple):
    frame: np.ndarray  # (H, W, 3) uint8
    background: np.ndarray  # (H, W, 3) uint8
    bboxes: np.ndarray  # (V, 4) float32 xyxy
    meters: np.ndarray  # (V, T, 2) float32, metric trajectory from the origin
    cad_idx: np.ndarray  # (V,) the CAD each vehicle's box was projected from


def cad_meshes(n: int, subdiv: int):
    """The bank's ``n`` procedural cars, staggered in size as the benchmark scene's."""
    return [make_test_car(length=1.0 + 0.05 * i, width=0.42 + 0.015 * (i % 3),
                          height=0.30 + 0.01 * (i % 4), subdiv=subdiv) for i in range(n)]


def intrinsic(focal_px: float, hw) -> np.ndarray:
    h, w = hw
    return np.array([[focal_px, 0, w / 2], [0, focal_px, h / 2], [0, 0, 1]], np.float32)


def _x_rot(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _z_rot(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def _project(points, k, rot, t):
    """Pinhole projection of row-vector world points: camera = points @ rot.T + t."""
    cam = points @ rot.T + t
    uv = cam @ k.T
    return uv[:, :2] / uv[:, 2:3]


def make_pool(traffic: dict, config: dict, keypoints: List[np.ndarray], rng) -> List[Scene]:
    """``traffic['pool']`` scenes of ``traffic['vehicles']`` vehicles on frames of
    ``config['frame_hw']``; ``keypoints`` are the bank's (12, 3) keypoints in CAD
    units (scaled by ``config['cad_scale']`` here), ``rng`` a numpy Generator."""
    h, w = config["frame_hw"]
    steps = config["steps"]
    v_n = traffic["vehicles"]
    k = intrinsic(traffic["focal_px"], (h, w))
    scale = config["cad_scale"]
    tilt = _x_rot(-math.pi / 2.4)
    pool = []
    for _ in range(traffic["pool"]):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        background = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cad = rng.integers(0, len(keypoints), v_n)
        yaw = rng.uniform(-1, 1, v_n) * traffic["yaw_jitter"]
        off = rng.uniform(-1, 1, (v_n, 2)) * traffic["offset_jitter_m"]
        speed = rng.uniform(*traffic["speed_mps"], v_n)
        heading = rng.uniform(-1, 1, v_n) * traffic["heading_jitter"]
        boxes, meters = [], []
        for v in range(v_n):
            rot = tilt @ _z_rot(0.4 + 0.3 * v + yaw[v])
            t = np.array([-6.0 + 4 * (v % 4) + off[v, 0], 2.0,
                          25.0 + 3 * (v % 4) + 0.7 * (v // 4) + off[v, 1]])
            uv = _project(np.asarray(keypoints[cad[v]], np.float64) * scale, k, rot, t)
            (x0, y0), (x1, y1) = uv.min(0), uv.max(0)
            pad = traffic["box_pad_px"]
            boxes.append([x0 - pad, y0 - pad, x1 + pad, y1 + pad])
            dist = speed[v] * traffic["dt_s"] * np.arange(steps)
            ang = 0.2 * v + heading[v]
            meters.append(np.stack([dist * math.cos(ang), dist * math.sin(ang)], -1))
        pool.append(Scene(frame, background, np.float32(boxes), np.float32(meters),
                          cad.astype(np.int64)))
    return pool
