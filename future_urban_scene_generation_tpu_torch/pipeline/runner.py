"""Scene runner: (frame, bboxes, trajectories) -> the composited future frames of
both generator branches.

Counterpart of the JAX package's pipeline/runner.py (``run_scene`` :43,
``synthesize_scene`` :71, ``build_cad_bank`` :445). Vehicles and steps are batch
dimensions: all V*S renders go to one kernel-K1 launch and all N = V*S ICN stems to
one kernel-K2 launch. The fault barrier is branchless; nothing in the scene reads
a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from future_urban_scene_generation_tpu_torch.geometry.projection import project_points_extrinsic
from future_urban_scene_generation_tpu_torch.geometry.rotations import (
    extrinsic_from_rodrigues,
    z_rot,
)
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.pipeline.stages import CadBank, Models, Perception
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

# Default side of the local grid the plane visibility is rastered on (area ratios are
# affine-invariant, so any grid over the keypoint bbox gives the frame's answer).
VIS_RES = 192


class SceneResult(NamedTuple):
    frames_icn: torch.Tensor  # (S, H, W, 3)
    frames_vunet: torch.Tensor  # (S, H, W, 3)
    pnp_error: torch.Tensor  # (V,)
    cad_idx: torch.Tensor  # (V,)


@torch.no_grad()
def run_scene(models: Models, cad_bank: CadBank, frame, background, bboxes, meter_coords,
              intrinsic, *, spec: ModelSpec, vis_res: int = VIS_RES) -> SceneResult:
    """The full scene: perception, then :func:`synthesize_scene`.

    frame / background (H, W, 3) float RGB in [0, 1]; bboxes (V, 4) xyxy;
    meter_coords (V, T, 2) metric trajectories (T - 1 future steps); intrinsic
    (3, 3). Returns T frames per branch."""
    with record_function("fusg.perceive"):
        perception = stages.perceive(models, spec, frame, bboxes)
    return synthesize_scene(models, cad_bank, frame, background, perception,
                            meter_coords, intrinsic, spec=spec, vis_res=vis_res)


class SceneGeometry(NamedTuple):
    """Everything the generators consume, per vehicle-step n = v * S + s."""

    sketches: torch.Tensor  # (N, 256, 256, 3) dst sketches
    veh_masks: torch.Tensor  # (N, 256, 256) bool
    windows: cr.Window  # fields (N,) sketch crop windows
    planes: torch.Tensor  # (N, 5, 256, 256, 3) warped planes, signed LAB
    central_lab: torch.Tensor  # (V, 256, 256, 3) signed LAB appearance prior
    src_window: cr.Window  # fields (V,) the step-0 windows
    pnp_error: torch.Tensor  # (V,)


@torch.no_grad()
def synthesize_scene(models: Models, cad_bank: CadBank, frame, background,
                     perception: Perception, meter_coords, intrinsic, *,
                     spec: ModelSpec, vis_res: int = VIS_RES) -> SceneResult:
    """Everything after perception (which may be oracle-injected). ``background``
    is (H, W, 3), or (S, H, W, 3) per step."""
    cad_idx, geom, icn, vun = _generate_vehicles(models, cad_bank, frame, perception,
                                                 meter_coords, intrinsic, spec, vis_res)
    return composite(background, geom, icn, vun, cad_idx, spec=spec)


def _generate_vehicles(models, cad_bank, frame, perception, meter_coords, intrinsic, spec,
                       vis_res):
    """The scene's per-vehicle stages: the clamped ``cad_idx``, the geometry and both
    generators' crops, for the vehicles of ``perception``."""
    # A classifier head wider than the bank (the 10-way head over the service's
    # single procedural CAD) may name a CAD the bank lacks: take the last one, as
    # the JAX package's clamping gather does.
    perception = perception._replace(
        cad_idx=perception.cad_idx.clamp(max=cad_bank.vertices.shape[0] - 1))
    geom = scene_geometry(cad_bank, frame, perception, meter_coords, intrinsic, spec=spec,
                          vis_res=vis_res)
    icn, vun = generate(models, frame, geom, spec=spec)
    return perception.cad_idx, geom, icn, vun


def synthesize_scene_staged(models: Models, cad_bank: CadBank, frame, background,
                            perception: Perception, meter_coords, intrinsic, *,
                            spec: ModelSpec, vis_res: int = VIS_RES) -> SceneResult:
    """The JAX ``synthesize_scene_staged`` (:335): the scene split into geometry and
    generators, two jits there so that each half compiles alone. Eager PyTorch
    compiles nothing and :func:`synthesize_scene` already runs as those halves
    (:func:`scene_geometry`, then :func:`generate` and :func:`composite`), so this is
    that function under the JAX name."""
    return synthesize_scene(models, cad_bank, frame, background, perception, meter_coords,
                            intrinsic, spec=spec, vis_res=vis_res)


@torch.no_grad()
def scene_geometry(cad_bank: CadBank, frame, perception: Perception, meter_coords,
                   intrinsic, *, spec: ModelSpec, vis_res: int = VIS_RES) -> SceneGeometry:
    """PnP, rollout, the renders (one K1 launch), visibility, plane polygons, the
    per-vehicle source tables and the plane warps."""
    v, s = meter_coords.shape[0], meter_coords.shape[1]
    n = v * s
    dev = frame.device
    cad_idx = perception.cad_idx

    with record_function("fusg.pnp"):
        err, rvec, tvec = stages.solve_poses(perception, cad_bank, intrinsic)
        extrinsics = extrinsic_from_rodrigues(rvec, tvec)
        theta, translation = stages.pose_rollout(meter_coords)

    def per_step(t):  # (V, ...) -> (N, ...), vehicle-major
        return t.repeat_interleave(s, dim=0)

    theta_n = theta.reshape(n)
    tr_n = translation.reshape(n, 3)
    ext_n = per_step(extrinsics)
    with record_function("fusg.render"):
        sketches, veh_masks, windows = stages.render_vehicle(
            per_step(cad_bank.vertices[cad_idx]),
            per_step(cad_bank.corners[cad_idx]),
            per_step(cad_bank.corner_normals[cad_idx]),
            ext_n, intrinsic, theta_n, tr_n,
            cull=per_step(cad_bank.cullable[cad_idx]),
        )

    with record_function("fusg.visibility"):
        kp3d_s = per_step(cad_bank.keypoints3d[cad_idx]) @ z_rot(theta_n) + tr_n[:, None]
        kp2d_s = project_points_extrinsic(kp3d_s, intrinsic, ext_n)
        visibility = vis.compute_visibility_local(ext_n, kp2d_s, kp3d_s, res=vis_res)[:, :5]
        polys = vis.plane_polygons_2d(torch.trunc(kp2d_s), vis.TEXTURE_PLANES)

    # Per-vehicle source tables: the frame in each vehicle's step-0 sketch window.
    with record_function("fusg.src_table"):
        src_window = windows.map(lambda f: f.reshape(v, s)[:, 0])
        central_lab = stages._to_signed_lab(
            stages._maybe_flip_rgb(spec, stages.central_crop_patch(frame, perception.window))
        )
        src_table = stages._to_signed_lab(
            cr.crop_resize(frame, src_window, stages.SRC_TABLE)
        ).to(spec.gen_dtype)
    with record_function("fusg.plane_warp"):
        step0 = torch.arange(v, device=dev).repeat_interleave(s) * s
        planes = stages.warp_planes_to_crop(
            spec, src_table, src_window, polys[step0], polys, visibility[step0], visibility,
            windows, torch.arange(n, device=dev) // s,
        )
    return SceneGeometry(sketches, veh_masks, windows, planes, central_lab, src_window, err)


@torch.no_grad()
def generate(models: Models, frame, geom: SceneGeometry, *, spec: ModelSpec):
    """Both generators over the N vehicle-steps (one K2 launch for the ICN stems).
    Returns (icn, vunet) crops (N, 256, 256, 3) in [0, 1]."""
    v = geom.central_lab.shape[0]
    s = geom.sketches.shape[0] // v
    step0 = torch.arange(v, device=frame.device) * s
    with record_function("fusg.vunet_encode"):
        mu_app = stages.vunet_encode_appearance_batch(
            models, spec, frame, geom.sketches[step0], geom.veh_masks[step0], geom.src_window
        )
    with record_function("fusg.icn"):
        icn = stages.icn_synthesize_batch(models, spec, geom.sketches, geom.central_lab,
                                          geom.planes, s_repeat=s)
    with record_function("fusg.vunet_decode"):
        vun = stages.vunet_decode_batch(models, spec, geom.sketches,
                                        [m.repeat_interleave(s, dim=0) for m in mu_app])
    return icn, vun


@torch.no_grad()
def composite(background, geom: SceneGeometry, icn, vun, cad_idx, *,
              spec: ModelSpec) -> SceneResult:
    """The fault barrier, then both branches composited into the background. Of
    ``geom`` it reads ``veh_masks``, ``windows`` and ``pnp_error`` only."""
    v = geom.pnp_error.shape[0]
    s = geom.veh_masks.shape[0] // v
    icn = icn.reshape(v, s, *icn.shape[1:])
    vun = vun.reshape(v, s, *vun.shape[1:])
    # Fault barrier: a vehicle-step with non-finite output, a degenerate window or
    # a failed pose contributes nothing (the reference's per-vehicle try/except).
    win_vs = geom.windows.map(lambda f: f.reshape(v, s))
    finite_ok = torch.isfinite(icn.sum(dim=(2, 3)).sum(-1)) & torch.isfinite(
        vun.sum(dim=(2, 3)).sum(-1)
    )
    window_ok = (win_vs.w > 1.0) & (win_vs.h > 1.0)
    pose_ok = torch.isfinite(geom.pnp_error)[:, None]
    ok = finite_ok & window_ok & pose_ok
    masks = geom.veh_masks.reshape(v, s, *geom.veh_masks.shape[1:]) & ok[:, :, None, None]

    if background.dim() == 3:
        background = background.expand(s, *background.shape)
    step_win = win_vs.map(lambda f: f.transpose(0, 1))
    with record_function("fusg.composite"):
        frames = stages.composite_frames(
            spec,
            torch.cat([background, background], dim=0),
            torch.cat([icn.transpose(0, 1), vun.transpose(0, 1)], dim=0),
            step_win.map(lambda f: torch.cat([f, f], dim=0)),
            torch.cat([masks.transpose(0, 1), masks.transpose(0, 1)], dim=0),
        )
    return SceneResult(frames[:s], frames[s:], geom.pnp_error, cad_idx)


@torch.no_grad()
def synthesize_scene_sharded(models: Models, cad_bank: CadBank, frame, background,
                             perception: Perception, meter_coords, intrinsic, mesh, *,
                             spec: ModelSpec, vis_res: int = VIS_RES) -> SceneResult:
    """:func:`synthesize_scene` with the vehicle axis sharded over ``mesh``'s 'data'
    axis (JAX runner.py:352), SPMD: every rank of the mesh calls it with the whole
    scene. Each rank takes its contiguous V / data vehicles of ``perception`` and
    ``meter_coords`` (a rank on another 'model' coordinate takes the same ones), runs
    :func:`scene_geometry` and :func:`generate` on them with the port's kernels, then
    all-gathers over 'data', in rank order, what :func:`composite` needs (the
    generators' crops, the vehicle masks, the windows, ``pnp_error``, ``cad_idx``)
    and composites all V, so every rank returns the replicated result
    :func:`synthesize_scene` gives. Frame, background, weights and the CAD bank are
    replicated (each rank holds them). V must divide the 'data' axis size."""
    rows = _vehicle_rows(meter_coords.shape[0], mesh)
    local = Perception(perception.cad_idx[rows], perception.kp_frame[rows],
                       perception.window.map(lambda f: f[rows]), perception.crop[rows])
    return _synthesize_shard(models, cad_bank, frame, background, local, meter_coords[rows],
                             intrinsic, mesh, spec, vis_res)


@torch.no_grad()
def run_scene_sharded(models: Models, cad_bank: CadBank, frame, background, bboxes,
                      meter_coords, intrinsic, mesh, *, spec: ModelSpec,
                      vis_res: int = VIS_RES) -> SceneResult:
    """:func:`run_scene` with the vehicle axis sharded over ``mesh``'s 'data' axis
    (JAX runner.py:401): each rank perceives its own V / data vehicles of ``bboxes``
    and goes on as :func:`synthesize_scene_sharded`. Streams x devices: give each
    camera stream its own mesh (``streaming.MultiStreamRunner(meshes=)``); no
    collective crosses streams."""
    rows = _vehicle_rows(bboxes.shape[0], mesh)
    with record_function("fusg.perceive"):
        perception = stages.perceive(models, spec, frame, bboxes[rows])
    return _synthesize_shard(models, cad_bank, frame, background, perception,
                             meter_coords[rows], intrinsic, mesh, spec, vis_res)


def _vehicle_rows(v: int, mesh) -> slice:
    if not torch.distributed.is_initialized():
        raise RuntimeError("a sharded scene needs an initialized process group "
                           "(parallel.mesh.init_distributed) and a mesh of it")
    try:
        return pmesh.axis_rows(v, mesh, "data")
    except ValueError as e:
        raise ValueError(f"{v} vehicles: {e}") from None


def _synthesize_shard(models, cad_bank, frame, background, perception, meter_coords,
                      intrinsic, mesh, spec, vis_res) -> SceneResult:
    cad_idx, geom, icn, vun = _generate_vehicles(models, cad_bank, frame, perception,
                                                 meter_coords, intrinsic, spec, vis_res)
    with record_function("fusg.gather"):
        def gather(t):
            return pmesh.gather_axis(t, mesh, "data")

        # composite reads these three of the geometry, now for all V
        whole = geom._replace(veh_masks=gather(geom.veh_masks),
                              windows=geom.windows.map(gather),
                              pnp_error=gather(geom.pnp_error))
        icn, vun, cad_idx = gather(icn), gather(vun), gather(cad_idx)
    return composite(background, whole, icn, vun, cad_idx, spec=spec)


def build_cad_bank(meshes, keypoints, scale: float = 5.0, *, device) -> CadBank:
    """Pad (TriangleMesh, (12, 3) keypoints) pairs into a CadBank: vertices x
    ``scale``, backface-cull orientation checked, Morton-sorted triangles, and
    the static corner expansion the rasterizer consumes, on ``device``."""
    from future_urban_scene_generation_tpu_torch.utils.mesh import (
        compute_vertex_normals,
        orient_for_backface_cull,
        spatial_sort_triangles,
    )

    v_max = max(len(m.vertices) for m in meshes)
    t_max = max(len(m.triangles) for m in meshes)
    verts, tris, normals, kps, corners, corner_normals, cullable = ([] for _ in range(7))
    for mesh, kp in zip(meshes, keypoints):
        nrm = compute_vertex_normals(mesh)
        oriented, can_cull = orient_for_backface_cull(mesh)
        cullable.append(can_cull)
        mesh = spatial_sort_triangles(oriented)
        vtx = np.asarray(mesh.vertices, np.float32) * scale
        tri = np.asarray(mesh.triangles, np.int64)
        vtx = np.pad(vtx, ((0, v_max - len(vtx)), (0, 0)), mode="edge")
        nrm = np.pad(np.asarray(nrm, np.float32), ((0, v_max - len(nrm)), (0, 0)), mode="edge")
        tri = np.pad(tri, ((0, t_max - len(tri)), (0, 0)))
        verts.append(vtx)
        tris.append(tri)
        normals.append(nrm)
        kps.append(np.asarray(kp, np.float32) * scale)
        corners.append(np.stack([vtx[tri[:, 0]].T, vtx[tri[:, 1]].T, vtx[tri[:, 2]].T]))
        corner_normals.append(np.stack([nrm[tri[:, 0]].T, nrm[tri[:, 1]].T, nrm[tri[:, 2]].T]))

    def t(a):
        return torch.as_tensor(np.stack(a), device=device)

    return CadBank(t(verts), t(tris), t(normals), t(kps), t(corners), t(corner_normals),
                   torch.as_tensor(np.asarray(cullable, bool), device=device))
