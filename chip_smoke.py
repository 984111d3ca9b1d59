"""Quickest proof that the PyTorch port runs on the GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, holds the port on
the GPU against the port on the CPU, then drives ``runner.run_scene`` on the
benchmark scene (1080p, 4 vehicles, 6 steps, 10 CADs of 1,944 triangles) in the
bf16 serving config.

    python3 chip_smoke.py                 # every phase, one GPU
    python3 chip_smoke.py --phases k1,k2  # a subset (device and build always run)
    python3 chip_smoke.py --profile       # also write a torch.profiler table of one scene

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels' record.
Longer output (compiler report, profile) goes to ``chiprun_out/``.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
ALL_PHASES = ("k1", "k2", "gpu_vs_cpu", "main")
# Budgets of the JAX package's kernel tests (tests/test_pallas_raster.py:20-30, 130-151).
RASTER_PIX_TOL, RASTER_PIX_FRAC = 1e-4, 0.005
DENSE_BG_FRAC, DENSE_PIX_TOL, DENSE_PIX_FRAC = 0.005, 1e-3, 0.01
# bf16 vs f32 generator PSNR bars. ICN: tests/test_bf16_inference.py's 35 dB.
# VUNet: random-weight VUNets saturate ~95% of output pixels and lose ~30 dB in
# bf16 in both frameworks (the JAX package measures 30.48 dB on this input recipe
# on the CPU, its own test bar being 30); 29 dB guards against regressions.
ICN_PSNR_BAR, VUNET_PSNR_BAR = 35.0, 29.0


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)  # nvidia-smi's own "name, power.limit" line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from future_urban_scene_generation_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _kernels.load()
    log(f"build: kernels built in {_kernels.BUILD_SECONDS:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> {_kernels.build().name}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(_kernels.BUILD_LOG)
    for line in _kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())


def _raster_compare(name, screen, colors, cull, dense=False):
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    img_k, bg_k = cuda_raster.rasterize_corners(screen, colors, (256, 256), cull=cull)
    img_p, bg_p = cuda_raster.rasterize_corners_plain(screen, colors, (256, 256), cull=cull)
    torch.cuda.synchronize()
    d = (img_k - img_p).abs().amax(-1)
    bg_flip = (bg_k != bg_p).float().mean().item()
    max_err = d.max().item()
    if dense:
        frac = (d > DENSE_PIX_TOL).float().mean().item()
        ok = bg_flip < DENSE_BG_FRAC and frac < DENSE_PIX_FRAC
        budget = f"bg flips < {DENSE_BG_FRAC}, pixels > {DENSE_PIX_TOL} < {DENSE_PIX_FRAC}"
    else:
        frac = (d > RASTER_PIX_TOL).float().mean().item()
        ok = bg_flip == 0.0 and frac < RASTER_PIX_FRAC
        budget = f"bg equal, pixels > {RASTER_PIX_TOL} < {RASTER_PIX_FRAC}"
    log(f"k1[{name}]: renders {screen.shape[0]}, triangles {screen.shape[-1]}, "
        f"covered {(~bg_p).float().mean().item():.4f}, bg flips {bg_flip:.6f}, "
        f"pixel frac {frac:.6f}, max abs err {max_err:.3e} ({budget}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel K1 disagrees with its plain version on {name}")
    return max_err


def _main_path_renders(device):
    """The 24 render inputs of the benchmark scene at its true poses (the
    staggered bench extrinsics and rollouts), as the main path builds them."""
    from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
    from future_urban_scene_generation_tpu_torch.pipeline import stages, synthetic
    from future_urban_scene_generation_tpu_torch.render import rasterizer as rz

    sc = synthetic.make_bench_scene(V=4, device=device, with_models=False)
    v, s = sc.meters.shape[0], sc.meters.shape[1]
    exts = []
    for i in range(v):
        ext = torch.eye(4)
        ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.4 + 0.3 * i))
        ext[:3, 3] = torch.tensor([-6.0 + 4 * i, 2.0, 25.0 + 3 * i])
        exts.append(ext)
    ext_n = torch.stack(exts).to(device).repeat_interleave(s, 0)
    theta, tr = stages.pose_rollout(sc.meters)
    cad = torch.arange(v, device=device)
    rep = lambda t: t[cad].repeat_interleave(s, 0)  # noqa: E731
    corners_w, normals_w, cam, _ = stages.posed_corners(
        rep(sc.cad_bank.vertices), rep(sc.cad_bank.corners), rep(sc.cad_bank.corner_normals),
        ext_n, sc.intrinsic, theta.reshape(-1), tr.reshape(-1, 3),
    )
    screen = rz.project_corners(corners_w, ext_n, cam)
    colors = (normals_w + 1.0) / 2.0
    return screen, colors, rep(sc.cad_bank.cullable)


def _single_mesh(subdiv, device):
    from future_urban_scene_generation_tpu_torch.utils import mesh as mu

    mesh, _ = mu.make_test_car(subdiv=subdiv)
    n = mu.compute_vertex_normals(mesh)
    # Viewed along +z with every vertex in front (z >= 70): the nearest faces hide
    # the coplanar body-top / cabin-bottom pair, whose exact depth ties either
    # raster may resolve either way (tests/test_pallas_raster.py:130 uses the same
    # geometry at 40x scale).
    v = np.float32(mesh.vertices * 200 + [128, 128, 100])
    t = mesh.triangles
    screen = np.stack([v[t[:, 0]].T, v[t[:, 1]].T, v[t[:, 2]].T])[None]
    c = np.float32((n + 1) / 2)
    colors = np.stack([c[t[:, 0]].T, c[t[:, 1]].T, c[t[:, 2]].T])[None]
    return torch.as_tensor(screen, device=device), torch.as_tensor(colors, device=device)


def phase_k1(device):
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    screen, colors, cull = _main_path_renders(device)
    max_err = _raster_compare("main path: 24 culled cars", screen, colors, cull)
    for subdiv in (16, 29):  # 6,144 and 20,184 triangles
        s1, c1 = _single_mesh(subdiv, device)
        _raster_compare(f"dense mesh subdiv={subdiv}", s1, c1, None, dense=True)
    rng = np.random.RandomState(31)
    verts = rng.rand(400, 3) * [250, 250, 3] + [0, 0, 4]
    tris = rng.randint(0, 400, (2000, 3))
    cols = rng.rand(400, 3)
    rs = np.stack([verts[tris[:, k]].T for k in range(3)])[None].astype(np.float32)
    rc = np.stack([cols[tris[:, k]].T for k in range(3)])[None].astype(np.float32)
    _raster_compare("random soup, no cull", torch.as_tensor(rs, device=device),
                    torch.as_tensor(rc, device=device), None)

    ms = cuda_ms(lambda: cuda_raster.rasterize_corners(screen, colors, (256, 256), cull=cull),
                 iters=20, warmup=2)
    plain_ms = cuda_ms(
        lambda: cuda_raster.rasterize_corners_plain(screen, colors, (256, 256), cull=cull),
        iters=3, warmup=1,
    )
    log(f"k1 time at the main-path shape (24 x 1,944 triangles, 256^2, prep + binning + "
        f"kernel): {ms:.3f} ms; plain version {plain_ms:.3f} ms")
    return dict(name="raster", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/raster.cu",
                replaces="future_urban_scene_generation_tpu/ops/pallas_raster.py:279",
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms)


def _stem_inputs(device, dtype, seed=11):
    rng = np.random.RandomState(seed)
    n, s, h = 24, 6, 256

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    return (t(rng.rand(n, h, h, 3)), t(rng.rand(n // s, h, h, 3)),
            t(rng.rand(n, 5, h, h, 3)), t(rng.rand(7, 7, 21, 64) - 0.5)), s


def phase_k2(device):
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    # The plain version runs in float64 on the same inputs, so the error measured is
    # the kernel's own float32 accumulation (K = 1,029 terms per output).
    (sk, ce, pl, kern), s = _stem_inputs(device, torch.float32)
    got = cuda_conv.icn_stem_conv(sk, ce, pl, kern, pad=3, s_repeat=s)
    ref = cuda_conv.icn_stem_conv_plain(sk.double(), ce.double(), pl.double(), kern.double(),
                                        pad=3, s_repeat=s)
    torch.cuda.synchronize()
    err32 = (got.double() - ref).abs().max().item()
    mag = ref.abs().max().item()
    # The JAX test's atol 3e-5 (tests/test_layers.py:294) for outputs of magnitude
    # ~10, scaled to this output's magnitude.
    tol32 = 3e-5 * max(1.0, mag / 10.0)
    log(f"k2[f32]: max abs err {err32:.3e} vs float64 plain (tol {tol32:.3e}, "
        f"|ref| max {mag:.2f})")
    if not err32 <= tol32:
        raise AssertionError("kernel K2 (f32) disagrees with its plain version")

    (sk, ce, pl, kern), s = _stem_inputs(device, torch.bfloat16)
    got = cuda_conv.icn_stem_conv(sk, ce, pl, kern, pad=3, s_repeat=s)
    ref = cuda_conv.icn_stem_conv_plain(sk.double(), ce.double(), pl.double(), kern.double(),
                                        pad=3, s_repeat=s)
    torch.cuda.synchronize()
    diff = (got.double() - ref).abs()
    # bf16 output rounding: within one bf16 ulp (2^-7 relative) of the exact result on
    # the same bf16-rounded inputs, plus float32 summation noise.
    bound = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
    err16 = diff.max().item()
    log(f"k2[bf16]: max abs err {err16:.3e} vs float64 plain on the same bf16 inputs "
        f"(bound 2^-7 |ref| + 1e-4 max|ref|, worst ratio {(diff / bound).max().item():.3f})")
    if not bool((diff <= bound).all()):
        raise AssertionError("kernel K2 (bf16) disagrees with its plain version")

    ms = cuda_ms(lambda: cuda_conv.icn_stem_conv(sk, ce, pl, kern, pad=3, s_repeat=s),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(
        lambda: cuda_conv.icn_stem_conv_plain(sk, ce, pl, kern, pad=3, s_repeat=s),
        iters=10, warmup=2,
    )
    log(f"k2 time at the main-path shape (N=24, 256^2, 21->64, bf16): {ms:.3f} ms; "
        f"plain version (f32 F.conv2d on the concat) {plain_ms:.3f} ms")
    return dict(name="icn_stem_conv", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/stem_conv.cu",
                replaces="future_urban_scene_generation_tpu/ops/pallas_conv.py:148",
                max_abs_err=err16, ms=ms, plain_ms=plain_ms)


def phase_gpu_vs_cpu(device):
    """Port on the GPU against port on the CPU, float32, on the oracle scene of
    the CPU slice test (tests/test_torch_pipeline.py)."""
    from future_urban_scene_generation_tpu_torch.pipeline import runner, synthetic
    from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec

    spec = ModelSpec()
    scene = synthetic.make_oracle_scene()
    bank = runner.build_cad_bank([scene["mesh"]] * 2, [scene["kp3d"]] * 2, scale=5.0)
    models = Models.build(spec, torch.Generator().manual_seed(0))
    outs = {}
    for dev in ("cpu", device):
        t = lambda k: torch.as_tensor(scene[k], device=dev)  # noqa: E731
        res = runner.synthesize_scene(
            models.to(dev), bank.to(dev), t("frame"), t("background"),
            synthetic.oracle_perception(scene, dev), t("meters"), t("intrinsic"), spec=spec,
        )
        outs[dev] = [x.cpu() for x in res]
    (ci, cv, ce, cc), (gi, gv, ge, gc) = outs["cpu"], outs[device]
    for name, a, b in (("icn", ci, gi), ("vunet", cv, gv)):
        d = (a - b).abs().amax(-1)
        frac = (d <= 5e-3).float().mean().item()
        log(f"gpu_vs_cpu[{name}]: frames {tuple(b.shape)}, pixels within 5e-3: {frac:.6f}, "
            f"max abs diff {d.max().item():.3e}")
        if not (torch.isfinite(b).all() and frac >= 0.995):
            raise AssertionError(f"port on GPU disagrees with port on CPU ({name})")
    log(f"gpu_vs_cpu: pnp_error cpu {ce.tolist()} gpu {ge.tolist()}; cad_idx "
        f"{cc.tolist()} / {gc.tolist()}")
    good = torch.isfinite(ce)
    if not (torch.equal(cc, gc) and torch.equal(good, torch.isfinite(ge))
            and torch.allclose(ge[good], ce[good], rtol=1e-3, atol=1e-4)):
        raise AssertionError("port on GPU disagrees with port on CPU (pose)")


def _psnr(a, b):
    mse = torch.mean((a - b) ** 2).item()
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def phase_main(device, profile: bool, card: str):
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    t0 = time.perf_counter()
    sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device,
                                    spec=SERVING_SPEC)
    torch.cuda.synchronize()
    log(f"main: bench scene built in {time.perf_counter() - t0:.1f} s (V=4, 1080p, T=6, "
        f"{sc.cad_bank.corners.shape[0]} CADs x {sc.cad_bank.corners.shape[-1]} triangles)")

    def run():
        return runner.run_scene(sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes,
                                sc.meters, sc.intrinsic, spec=sc.spec)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    log(f"main: first scene (cold) {time.perf_counter() - t0:.2f} s")

    cuda_raster.LAUNCHES = 0
    cuda_conv.LAUNCHES = 0
    times, res = [], None
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
    log(f"main: launches during the 3 scenes: {launches}")
    for name, frames in (("icn", res.frames_icn), ("vunet", res.frames_vunet)):
        if tuple(frames.shape) != (6, 1080, 1920, 3) or not bool(torch.isfinite(frames).all()):
            raise AssertionError(f"main path output {name} malformed: {tuple(frames.shape)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    changed = (res.frames_icn - sc.background).abs().amax(-1) > 1e-3
    log(f"main: frames (6, 1080, 1920, 3) x2 finite; composited pixel share per step "
        f"{[round(x, 5) for x in changed.float().mean((1, 2)).tolist()]}; pnp_error "
        f"{res.pnp_error.tolist()}; cad_idx {res.cad_idx.tolist()}")
    med = statistics.median(times)
    # bench.py's metric: both generator branches composite T = 6 frames per scene.
    log(f"main: scene times {[round(t, 2) for t in times]} ms; median {med:.2f} ms = "
        f"{12 * 1000.0 / med:.2f} composited 1080p frames/s ({card})")

    # bf16 vs f32 generators on the same inputs (tests/test_bf16_inference.py bars).
    rng = np.random.RandomState(11)
    f = lambda a: torch.as_tensor(np.float32(a), device=device)  # noqa: E731
    sk, ce, pl = f(rng.rand(24, 256, 256, 3)), f(rng.rand(4, 256, 256, 3) * 2 - 1), \
        f(rng.rand(24, 5, 256, 256, 3) * 2 - 1)
    masks = torch.as_tensor(rng.rand(4, 256, 256) > 0.5, device=device)
    win = stages.cr.Window(*(torch.full((4,), float(x), device=device)
                             for x in (100.0, 50.0, 256.0, 256.0)))
    f32 = SERVING_SPEC.replace(generator_dtype="float32")
    out = {}
    for spec in (f32, SERVING_SPEC):
        icn = stages.icn_synthesize_batch(sc.models, spec, sk, ce, pl, s_repeat=6)
        mu = stages.vunet_encode_appearance_batch(sc.models, spec, sc.frame, sk[::6], masks, win)
        vun = stages.vunet_decode_batch(sc.models, spec, sk, [m.repeat_interleave(6, 0) for m in mu])
        out[spec.generator_dtype] = (icn, vun)
    p_icn = _psnr(out["float32"][0], out["bfloat16"][0])
    p_vun = _psnr(out["float32"][1], out["bfloat16"][1])
    log(f"main: bf16 vs f32 generator PSNR: ICN {p_icn:.2f} dB (bar {ICN_PSNR_BAR}), "
        f"VUNet {p_vun:.2f} dB (bar {VUNET_PSNR_BAR})")
    if not (p_icn >= ICN_PSNR_BAR and p_vun >= VUNET_PSNR_BAR):
        raise AssertionError("bf16 generators fall below the quality bar")
    if profile:
        _profile_scene(sc, run, med)
    return launches


def _profile_scene(sc, run, scene_ms):
    """Per-stage device time (CUDA events between the runner's four parts) over
    three scenes, then a torch.profiler table of one scene and its device busy
    time against the unprofiled median scene time ``scene_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages

    parts = ("perceive", "scene_geometry", "generate", "composite")
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        ev[0].record()
        per = stages.perceive(sc.models, sc.spec, sc.frame, sc.bboxes)
        ev[1].record()
        geom = runner.scene_geometry(sc.cad_bank, sc.frame, per, sc.meters, sc.intrinsic,
                                     spec=sc.spec)
        ev[2].record()
        icn, vun = runner.generate(sc.models, sc.frame, geom, spec=sc.spec)
        ev[3].record()
        runner.composite(sc.background, geom, icn, vun, per.cad_idx, spec=sc.spec)
        ev[4].record()
        torch.cuda.synchronize()
        log("profile: stages (ms) " + ", ".join(
            f"{p} {ev[i].elapsed_time(ev[i + 1]):.2f}" for i, p in enumerate(parts)))
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as fh:
        fh.write(rows.table(sort_by="device_time_total", row_limit=80))
    # Device rows are the kernels, copies and the device-side twins of the runner's
    # record_function spans; the spans overlap the kernels, so they are left out
    # (an operator's host-side row repeats its kernels' time and is not counted).
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type == DeviceType.CUDA and not e.key.startswith("fusg.")) / 1e3
    scopes = sorted((e for e in rows if e.key.startswith("fusg.") and e.cpu_time_total > 0),
                    key=lambda e: -e.cpu_time_total)
    log(f"profile: device busy {busy:.2f} ms in one scene, idle share "
        f"{1.0 - busy / scene_ms:.3f} of the {scene_ms:.2f} ms median scene; "
        "per scope host ms / kernel ms: "
        + ", ".join(f"{e.key} {e.cpu_time_total / 1e3:.2f}/{e.device_time_total / 1e3:.2f}"
                    for e in scopes))
    log("profile: table written to chiprun_out/profile.txt")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    device = "cuda"
    kernels, launches = [], {}
    if "k1" in phases:
        kernels.append(phase_k1(device))
    if "k2" in phases:
        kernels.append(phase_k2(device))
    if "gpu_vs_cpu" in phases:
        phase_gpu_vs_cpu(device)
    if "main" in phases:
        launches = phase_main(device, args.profile, smi)
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
