"""The scene cells' comparison: a sample of the pool scenes the window finished,
drawn from the seed, run again by the plain reference on the same inputs and the
same weights; per scene the pose error and both branches' frames are compared, and
the worst scene's numbers go against the cell's limits. Perception is judged through
them: the keypoints set the poses, the CAD choice the renders.

Numbers (each the worst over the judged scenes):

* ``frames_q90_abs``: the 90th percentile of the absolute difference of the composited
  frames' values (both branches, all steps) over the pixels where either side's frame
  differs from the background. The kernel and the plain raster may cover a silhouette
  pixel differently, which moves a few pixels a vehicle by up to 1; a precision lost in
  a network, a pose that moved or a vehicle or region painted wrong moves a tenth of
  them or more.

Readings with no limit: ``vehicle_q90_abs``, ``vehicle_mean_abs`` and
``vehicle_bad_share``, each vehicle's percentile, mean and share of values off by more
than 0.02 over the painted pixels in its crop windows, worst vehicle (a fault confined to
one vehicle of many stays under the whole frame's percentile, but a sound vehicle can
read a tenth of what the control does: a silhouette pixel that K1 and the plain raster
cover differently moves the random-weight generators' whole output for it);
``pnp_gap``, the largest relative gap of a vehicle's PnP
reprojection error ``|e - e_ref| / max(|e_ref|, 1e-6)`` (two non-finite errors count as
equal; the control left it at 0 on some seeds, so it has no upper reading);
``frames_mean_abs`` and ``frames_bad_share`` (values off by more than 0.02), whose
program and control readings lie within 10x; ``cad_mismatch``, vehicles whose
classified CAD differs (neither the control nor a planted fault moved it).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import weights
from perfbench.judge import tf32
from perfbench.reference.ops import crop as cr
from perfbench.traffic import scenes


def sample(seed: int, kept: dict, n: int) -> list:
    """``n`` of the kept pool indices, drawn from the seed."""
    rng = np.random.default_rng(weights.sub_seed(seed, "judge"))
    keys = sorted(kept)
    return sorted(rng.choice(keys, size=min(n, len(keys)), replace=False).tolist())


def reference_scenes(run, held: dict, indices, use_tf32: bool = False,
                     reverse: bool = False):
    """Yield (pool index, (frames_icn, frames_vunet, pnp_error, cad_idx), windows) of
    the plain reference on the pool scenes ``indices``, with TF32 as asked (the
    control); ``windows`` are the vehicles' crop windows, fields (V, S). With
    ``reverse`` the vehicles go in in reverse order (pnp_error, cad_idx and the windows
    are handed back in the pool's order; the frames, composited in the other order, are
    not comparable)."""
    from perfbench.reference.pipeline import runner, stages
    from perfbench.reference.pipeline.stages import Models
    from perfbench.reference.spec import ModelSpec

    cfg = run.cell.config
    dev = run.device
    spec = ModelSpec(**cfg["spec"])
    models = Models.build(spec, None, device=dev)
    for name, net in zip(Models._fields, models):
        net.load_state_dict(weights.seeded_state(net, run.seed, name, dev))
    meshes = scenes.cad_meshes(cfg["cads"], cfg["cad_subdiv"])
    bank = runner.build_cad_bank([m for m, _ in meshes], [k for _, k in meshes],
                                 scale=cfg["cad_scale"], device=dev)
    k_mat = torch.as_tensor(held["intrinsic"], device=dev)

    def img(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev).to(torch.float32) / 255.0

    with tf32(use_tf32), torch.no_grad():
        for k in indices:
            sc = held["pool"][k]
            order = slice(None, None, -1 if reverse else 1)
            frame = img(sc.frame)
            meters = torch.as_tensor(sc.meters[order].copy(), device=dev)
            perception = stages.perceive(models, spec, frame,
                                         torch.as_tensor(sc.bboxes[order].copy(), device=dev))
            cad_idx, geom, icn, vun = runner._generate_vehicles(
                models, bank, frame, perception, meters, k_mat, spec, runner.VIS_RES)
            res = runner.composite(img(sc.background), geom, icn, vun, cad_idx, spec=spec)
            back = (lambda x: x.flip(0)) if reverse else (lambda x: x)
            v, s = meters.shape[:2]
            windows = geom.windows.map(lambda f: back(f.reshape(v, s)))
            yield k, (res.frames_icn, res.frames_vunet, back(res.pnp_error),
                      back(res.cad_idx)), windows


def q90(values: torch.Tensor) -> float:
    """The 90th percentile (the ceil(0.9 n)-th smallest) of a flat tensor; 0 if empty."""
    n = values.numel()
    return float(torch.kthvalue(values, -(-9 * n // 10)).values) if n else 0.0


def background(run, held: dict, k: int) -> torch.Tensor:
    """Pool scene ``k``'s background as both sides composite into it."""
    bg = torch.from_numpy(np.ascontiguousarray(held["pool"][k].background))
    return bg.to(run.device).to(torch.float32) / 255.0


def vehicle_numbers(diff, painted, windows) -> dict:
    """Each vehicle apart, over the ``painted`` pixels (2S, H, W) inside its windows
    (fields (V, S)), of ``diff`` (2S, H, W, 3: both branches): the worst vehicle's 90th
    percentile, mean and share of values off by more than 0.02."""
    h, w = painted.shape[1:]
    out = {"vehicle_q90_abs": 0.0, "vehicle_mean_abs": 0.0, "vehicle_bad_share": 0.0}
    for v in range(windows.x_start.shape[0]):
        inside = cr.inside_window(windows.map(lambda f: f[v]), h, w, painted.device)
        sel = painted & torch.cat([inside, inside])
        values = diff[sel].flatten()
        if values.numel() == 0:
            continue
        out["vehicle_q90_abs"] = max(out["vehicle_q90_abs"], q90(values))
        out["vehicle_mean_abs"] = max(out["vehicle_mean_abs"], float(values.mean()))
        out["vehicle_bad_share"] = max(out["vehicle_bad_share"],
                                       float((values > 0.02).to(torch.float32).mean()))
    return out


def compare(got, ref, background, windows) -> dict:
    """The numbers of one scene: ``got`` and ``ref`` are (frames_icn, frames_vunet,
    pnp_error, cad_idx), ``background`` the (H, W, 3) float frame both composited into,
    ``windows`` the reference's crop windows, fields (V, S)."""
    f_got = torch.cat([got[0], got[1]]).to(torch.float32)
    f_ref = torch.cat([ref[0], ref[1]]).to(torch.float32)
    diff = (f_got - f_ref).abs()
    painted = ((f_got != background) | (f_ref != background)).any(-1)
    e_got, e_ref = got[2].to(torch.float64), ref[2].to(torch.float64)
    both_bad = ~torch.isfinite(e_got) & ~torch.isfinite(e_ref)
    gap = (e_got - e_ref).abs() / e_ref.abs().clamp(min=1e-6)
    gap = torch.where(both_bad, torch.zeros_like(gap), gap)
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return {
        "frames_q90_abs": q90(diff[painted].flatten()),
        "pnp_gap": float(gap.max()),
        "frames_mean_abs": float(diff.mean()),
        "frames_bad_share": float((diff > 0.02).to(torch.float32).mean()),
        "cad_mismatch": float((got[3] != ref[3]).sum()),
        **vehicle_numbers(diff, painted, windows),
    }


def worst(per_scene: list) -> dict:
    """The largest reading of each number over the judged scenes (NaN counts as inf)."""
    out = {}
    for readings in per_scene:
        for name, v in readings.items():
            v = float("inf") if v != v else v
            out[name] = max(out.get(name, -1.0), v)
    return out


def judge(run, held: dict) -> dict:
    """Readings of the sampled scenes against the reference; {} if none finished."""
    idx = sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    per_scene = [compare(held["kept"][k], ref, background(run, held, k), windows)
                 for k, ref, windows in reference_scenes(run, held, idx)]
    readings = worst(per_scene)
    readings["judged_scenes"] = float(len(per_scene))
    return readings
