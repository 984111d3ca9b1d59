"""Quickest proof that the PyTorch port runs on the GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, holds the port on
the GPU against the port on the CPU, drives ``runner.run_scene`` on the benchmark
scene (1080p, 4 vehicles, 6 steps, 10 CADs of 1,944 triangles) in the bf16 serving
config, trains the full-width ICN through ``cli.train --model icn`` and the trainer
API (float32 and bfloat16 inputs), then drives the serving entry points: the
synthetic demo (360x640), ``cli.run_test`` on a CityFlow-shaped directory it writes
(720x1280, 4 vehicles) and the stream runners on the same frames.

    python3 chip_smoke.py                    # every phase, one GPU
    python3 chip_smoke.py --phases k3,train  # a subset (device and build always run)
    python3 chip_smoke.py --profile          # also write a torch.profiler table of one scene

Kernel launches in the ``kernels`` line, each counted over its own path with the
counters set to 0 just before: K1 and K2 from the main phase's scenes, K3 from the
train phase's CLI run, K1' from the demo; K4's entry has no caller on any path.
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the card's
peak for the kernel's type (the H100 SXM's published 67 TFLOP/s float32, 989 TFLOP/s
bf16), from this run's inputs; ``library_ms`` is one PyTorch call computing the same
function, timed here and used nowhere in the port.

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels' record.
Longer output (compiler report, profile) goes to ``chiprun_out/``.
"""
import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
ALL_PHASES = ("k1", "k2", "k3", "gpu_vs_cpu", "main", "train", "demo", "serve", "stream")
# Published peaks of one H100 SXM: device memory bytes/s, float32 FLOP/s outside the
# tensor cores, dense bf16 FLOP/s.
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# Budgets of the JAX package's kernel tests (tests/test_pallas_raster.py:20-30, 130-151).
RASTER_PIX_TOL, RASTER_PIX_FRAC = 1e-4, 0.005
DENSE_BG_FRAC, DENSE_PIX_TOL, DENSE_PIX_FRAC = 0.005, 1e-3, 0.01
# bf16 vs f32 generator PSNR bars. ICN: tests/test_bf16_inference.py's 35 dB.
# VUNet: random-weight VUNets saturate ~95% of output pixels and lose ~30 dB in
# bf16 in both frameworks (the JAX package measures 30.48 dB on this input recipe
# on the CPU, its own test bar being 30); 29 dB guards against regressions.
ICN_PSNR_BAR, VUNET_PSNR_BAR = 35.0, 29.0
MAIN_SCENES = 2  # timed scenes of the main phase, after one cold scene


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


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    """(the least ms the card could take, what bounds it): bytes moved once over the
    memory rate against operations over ``peak_ops``."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


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
    return _raster_budget(name, (img_k, bg_k), (img_p, bg_p), screen.shape[0],
                          screen.shape[-1], dense)


def _raster_budget(name, kernel_out, plain_out, n_renders, n_tris, dense=False):
    (img_k, bg_k), (img_p, bg_p) = kernel_out, plain_out
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
    log(f"k1[{name}]: renders {n_renders}, triangles {n_tris}, "
        f"covered {(~bg_p).float().mean().item():.4f}, bg flips {bg_flip:.6f}, "
        f"pixel frac {frac:.6f}, max abs err {max_err:.3e} ({budget}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"kernel K1 disagrees with its plain version on {name}")
    return max_err


def _main_path_renders(device):
    """The 24 render inputs of the benchmark scene at its true poses (the
    staggered bench extrinsics and rollouts), as the main path builds them:
    corner-expanded (screen, colors, cull) for K1, and the same renders as indexed
    meshes (verts_screen, triangles, vert_colors) for K1'."""
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
    theta, tr = theta.reshape(-1), tr.reshape(-1, 3)
    cad = torch.arange(v, device=device)
    rep = lambda t: t[cad].repeat_interleave(s, 0)  # noqa: E731
    corners_w, normals_w, cam, _ = stages.posed_corners(
        rep(sc.cad_bank.vertices), rep(sc.cad_bank.corners), rep(sc.cad_bank.corner_normals),
        ext_n, sc.intrinsic, theta, tr,
    )
    screen = rz.project_corners(corners_w, ext_n, cam)
    colors = (normals_w + 1.0) / 2.0
    rot = z_rot(theta)
    verts_screen = rz.project_vertices(rep(sc.cad_bank.vertices) @ rot + tr[:, None], ext_n, cam)
    vert_colors = (rep(sc.cad_bank.normals) @ rot + 1.0) / 2.0
    indexed = (verts_screen, rep(sc.cad_bank.triangles), vert_colors)
    return (screen, colors, rep(sc.cad_bank.cullable)), indexed


def _demo_render(device):
    """The demo's one render as an indexed mesh: the subdiv-2 car at the demo's pose
    and camera, 360x640."""
    from future_urban_scene_generation_tpu_torch.examples import demo_synthetic as demo
    from future_urban_scene_generation_tpu_torch.pipeline import runner
    from future_urban_scene_generation_tpu_torch.render import rasterizer as rz
    from future_urban_scene_generation_tpu_torch.utils import mesh as mu

    k, ext = demo.demo_camera(device)
    mesh, kp3d = mu.make_test_car(subdiv=2)
    bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device=device)
    cam = rz.Camera(*(f.reshape(1) for f in rz.Camera.from_intrinsic(k)))
    verts_screen = rz.project_vertices(bank.vertices[:1], ext[None], cam)
    return verts_screen, bank.triangles[0], (bank.normals[:1] + 1.0) / 2.0


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


def _raster_ops(counts) -> float:
    """Operations this run's data needs of the raster kernel: every pixel of a tile
    evaluates the three barycentric planes (2 multiplies and 2 adds each) of every
    triangle binned to the tile."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    pairs = int(counts.sum().item()) * cuda_raster.GROUP * cuda_raster.TILE ** 2
    return 12.0 * pairs


def _indexed_case(name, verts_screen, triangles, vert_colors, hw):
    """K1' at one shape: against the corners entry on the gathered mesh (exact: the
    same values minus the gather), against its plain version, and timed. An indexed
    mesh carries no cull flag, so back faces are rastered too, and where a back and
    a front edge meet on the silhouette the kernel's affine planes and the plain
    raster's edge functions may cover a pixel differently: the plain comparison
    takes the dense-mesh budget of the corners case (tests/test_pallas_raster.py
    :130-151), not its equal-masks one."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    args = (verts_screen, triangles, vert_colors, hw)
    got = cuda_raster.rasterize_indexed(*args)
    plain = cuda_raster.rasterize_indexed_plain(*args)
    screen = cuda_raster.gather_corners(verts_screen, triangles)
    colors = cuda_raster.gather_corners(vert_colors, triangles)
    corners = cuda_raster.rasterize_corners(screen, colors, hw)
    torch.cuda.synchronize()
    max_err = _raster_budget(f"indexed, {name}", got, plain, screen.shape[0], screen.shape[-1],
                             dense=True)
    if not (torch.equal(got[0], corners[0]) and torch.equal(got[1], corners[1])):
        raise AssertionError(f"K1' differs from the corners entry on the gathered mesh ({name})")
    ms = cuda_ms(lambda: cuda_raster.rasterize_indexed(*args), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: cuda_raster.rasterize_indexed_plain(*args), iters=3, warmup=1)
    gather_ms = cuda_ms(lambda: (cuda_raster.gather_corners(verts_screen, triangles),
                                 cuda_raster.gather_corners(vert_colors, triangles)),
                        iters=20, warmup=2)
    table, bins, counts = cuda_raster.raster_prep(screen, colors, hw)
    kernel_ms = cuda_ms(lambda: cuda_raster.launch_raster(table, bins, counts, hw),
                        iters=50, warmup=3)
    out_bytes = screen.shape[0] * hw[0] * hw[1] * 13  # float32 RGB + the bool mask
    bound, by = bound_ms(nbytes(verts_screen, triangles, vert_colors) + out_bytes,
                         _raster_ops(counts), PEAK_F32)
    log(f"k1[indexed, {name}]: equal to the corners entry; K1' {ms:.3f} ms (gathers "
        f"{gather_ms:.3f} ms, CUDA launch alone {kernel_ms:.3f} ms); plain version "
        f"{plain_ms:.3f} ms; bound {bound:.5f} ms by {by}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def phase_k1(device):
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    (screen, colors, cull), indexed = _main_path_renders(device)
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

    hw = (256, 256)
    ms = cuda_ms(lambda: cuda_raster.rasterize_corners(screen, colors, hw, cull=cull),
                 iters=20, warmup=2)
    plain_ms = cuda_ms(
        lambda: cuda_raster.rasterize_corners_plain(screen, colors, hw, cull=cull),
        iters=3, warmup=1,
    )
    prep_ms = cuda_ms(lambda: cuda_raster.raster_prep(screen, colors, hw, cull),
                      iters=20, warmup=2)
    table, bins, counts = cuda_raster.raster_prep(screen, colors, hw, cull)
    kernel_ms = cuda_ms(lambda: cuda_raster.launch_raster(table, bins, counts, hw),
                        iters=50, warmup=3)
    bound, by = bound_ms(nbytes(screen, colors, cull) + screen.shape[0] * hw[0] * hw[1] * 13,
                         _raster_ops(counts), PEAK_F32)
    log(f"k1 time at the main-path shape (24 x 1,944 triangles, 256^2): wrapper {ms:.3f} ms; "
        f"timed apart: torch prep + binning {prep_ms:.3f} ms (paced by the host's launches), "
        f"the CUDA launch alone {kernel_ms:.3f} ms; plain version {plain_ms:.3f} ms; bound "
        f"{bound:.5f} ms by {by} ({int(counts.sum().item())} binned groups)")
    src = "future_urban_scene_generation_tpu_torch/csrc/raster.cu"
    k1 = dict(name="raster", route="cuda", source=src,
              replaces="future_urban_scene_generation_tpu/ops/pallas_raster.py:279",
              max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
              library_ms=None)

    main_case = _indexed_case("main path: 24 cars, 256^2", *indexed, hw)
    from future_urban_scene_generation_tpu_torch.examples.demo_synthetic import FRAME_HW
    demo_case = _indexed_case("the demo's car, 360x640", *_demo_render(device), FRAME_HW)
    # The kernels line carries K1' at the shape its own path (the demo) gives it.
    k1i = dict(name="rasterize_indexed", route="cuda", source=src,
               replaces="future_urban_scene_generation_tpu/ops/pallas_raster.py:342",
               library_ms=None, **demo_case)
    return [k1, k1i]


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

    import torch.nn.functional as F

    def materialized(dtype):
        """The library call's input: the 21-channel concat, reflect-padded, NCHW
        values in channels_last memory, and the OIHW weight, both in ``dtype``."""
        (a, b, c, w), rep = _stem_inputs(device, dtype)
        n, h = a.shape[0], a.shape[1]
        x = torch.cat([a, b.repeat_interleave(rep, 0),
                       c.permute(0, 2, 3, 1, 4).reshape(n, h, h, 15)], dim=-1)
        x = F.pad(x.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
        return (x.contiguous(memory_format=torch.channels_last),
                w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last))

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        (a, b, c, w), rep = _stem_inputs(device, dtype)
        x_lib, w_lib = materialized(dtype)
        lib_out = F.conv2d(x_lib, w_lib).permute(0, 2, 3, 1)
        ker_out = cuda_conv.icn_stem_conv(a, b, c, w, pad=3, s_repeat=rep)
        torch.cuda.synchronize()
        lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
        times[dtype] = (
            cuda_ms(lambda: cuda_conv.icn_stem_conv(a, b, c, w, pad=3, s_repeat=rep),
                    iters=10, warmup=2),
            cuda_ms(lambda: cuda_conv.icn_stem_conv_plain(a, b, c, w, pad=3, s_repeat=rep),
                    iters=10, warmup=2),
            cuda_ms(lambda: F.conv2d(x_lib, w_lib), iters=20, warmup=3),
        )
        n_out = ker_out.numel()
        bound, by = bound_ms(nbytes(a, b, c, w, ker_out), 2.0 * n_out * w[..., 0].numel(),
                             PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
        times[dtype] += (bound, by)
        log(f"k2 time at the main-path shape (N=24, 256^2, 21->64, {dtype}): K2 "
            f"{times[dtype][0]:.3f} ms; plain version (f32 F.conv2d on the concat it builds) "
            f"{times[dtype][1]:.3f} ms; library call (F.conv2d in {dtype} on the materialized "
            f"concat) {times[dtype][2]:.3f} ms, max abs diff to K2 {lib_err:.3e}; bound "
            f"{bound:.4f} ms by {by}")
    ms, plain_ms, library_ms, bound, by = times[torch.bfloat16]  # the scene serves in bf16
    return dict(name="icn_stem_conv", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/stem_conv.cu",
                replaces="future_urban_scene_generation_tpu/ops/pallas_conv.py:148",
                max_abs_err=err16, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


# The ICN trainer's stem conv (batch 8, 256^2 reflect-padded by 3, 21 -> 64) and
# the three cases of tests/test_layers.py:222-224 (O = 12 among them).
K3_STEM = (8, 262, 262, 21, 7, 64)
K3_CASES = ((2, 22, 26, 21, 7, 16), (1, 19, 20, 3, 3, 8), (2, 38, 34, 6, 5, 12))


def _small_cin_inputs(shape, device, dtype, seed):
    n, h, w, c, k, o = shape
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.rand(n, h, w, c).astype(np.float32), device=device).to(dtype)
    kern = torch.as_tensor((rng.rand(k, k, c, o) - 0.5).astype(np.float32), device=device)
    return x, kern.to(dtype)


def phase_k3(device):
    """K3 and K4's entry against the plain version in float64 on the same inputs,
    the gated conv's gradients against F.conv2d's autograd, and K3's time."""
    from future_urban_scene_generation_tpu_torch.models import layers
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    worst = {}
    for entry in ("conv_small_cin_v2", "conv_small_cin"):
        fn = getattr(cuda_conv, entry)
        for i, shape in enumerate((K3_STEM,) + K3_CASES):
            x, kern = _small_cin_inputs(shape, device, torch.float32, seed=20 + i)
            got = fn(x, kern)
            ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
            torch.cuda.synchronize()
            err32 = (got.double() - ref).abs().max().item()
            mag = ref.abs().max().item()
            tol32 = 3e-5 * max(1.0, mag / 10.0)  # as phase_k2
            x, kern = x.bfloat16(), kern.bfloat16()
            got = fn(x, kern)
            ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
            torch.cuda.synchronize()
            diff = (got.double() - ref).abs()
            bound = 2.0 ** -7 * ref.abs() + 1e-4 * ref.abs().max()
            ok = err32 <= tol32 and bool((diff <= bound).all()) and got.dtype == torch.bfloat16
            log(f"k3[{entry} {shape}]: f32 max abs err {err32:.3e} (tol {tol32:.3e}); bf16 max "
                f"abs err {diff.max().item():.3e}, worst ratio to its bound "
                f"{(diff / bound).max().item():.3f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{entry} disagrees with its plain version at {shape}")
            worst[entry] = max(worst.get(entry, 0.0), err32)

    # The gated conv's Function on the card: K3 forward, F.conv2d's gradients.
    x, kern = _small_cin_inputs(K3_STEM, device, torch.float32, seed=30)
    w = kern.permute(3, 2, 0, 1).contiguous().requires_grad_()
    x = x.requires_grad_()
    y = layers._SmallCinConv.apply(x, w, 0)
    g = torch.as_tensor(np.random.RandomState(31).randn(*y.shape).astype(np.float32),
                        device=device)
    gx, gw = torch.autograd.grad(y, (x, w), g)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    rx, rw = torch.autograd.grad(ref, (x, w), g)
    for name, a, b in (("x", gx, rx), ("w", gw, rw)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"k3[grad {name}]: Function vs F.conv2d autograd, max abs diff / max |g| "
            f"{rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"the gated conv's gradient for {name} disagrees")

    import torch.nn.functional as F

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, kern = _small_cin_inputs(K3_STEM, device, dtype, seed=40)
        x_lib = x.permute(0, 3, 1, 2)  # NCHW values in channels_last memory
        w_lib = kern.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        times[dtype] = [cuda_ms(lambda f=f: f(x, kern), iters=10, warmup=2) for f in (
            cuda_conv.conv_small_cin_v2, cuda_conv.conv_small_cin,
            cuda_conv.conv_small_cin_plain)]
        times[dtype].append(cuda_ms(lambda: F.conv2d(x_lib, w_lib), iters=20, warmup=3))
        out = cuda_conv.conv_small_cin_v2(x, kern)
        times[dtype] += bound_ms(nbytes(x, kern, out), 2.0 * out.numel() * kern[..., 0].numel(),
                                 PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
        t = times[dtype]
        log(f"k3 time at the training stem {K3_STEM} ({dtype}): K3 {t[0]:.3f} ms, "
            f"K4 entry {t[1]:.3f} ms; plain version (F.conv2d in f32) {t[2]:.3f} ms; library "
            f"call (F.conv2d in {dtype}) {t[3]:.3f} ms; bound {t[4]:.4f} ms by {t[5]}")
    # The kernels line carries the float32 case: the trainer's CLI trains in float32.
    ms3, ms4, plain_ms, library_ms, bound, by = times[torch.float32]
    src = "future_urban_scene_generation_tpu_torch/csrc/conv_small_cin.cu"
    common = dict(route="cuda", source=src, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=library_ms)
    return [
        dict(name="conv_small_cin_v2", ms=ms3, max_abs_err=worst["conv_small_cin_v2"],
             replaces="future_urban_scene_generation_tpu/ops/pallas_conv.py:64", **common),
        dict(name="conv_small_cin", ms=ms4, max_abs_err=worst["conv_small_cin"],
             replaces="future_urban_scene_generation_tpu/ops/pallas_conv.py:35", **common),
    ]


def phase_gpu_vs_cpu(device):
    """Port on the GPU against port on the CPU, float32, on the oracle scene of
    the CPU slice test (tests/test_torch_pipeline.py)."""
    from future_urban_scene_generation_tpu_torch.pipeline import runner, synthetic
    from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec

    spec = ModelSpec()
    scene = synthetic.make_oracle_scene()
    bank = runner.build_cad_bank([scene["mesh"]] * 2, [scene["kp3d"]] * 2, scale=5.0,
                                 device="cpu")
    models = Models.build(spec, torch.Generator().manual_seed(0), device="cpu")
    outs = {}
    for dev in ("cpu", device):
        t = lambda k: torch.as_tensor(scene[k], device=dev)  # noqa: E731
        res = runner.synthesize_scene(
            models.to(dev), bank.to(dev), t("frame"), t("background"),
            synthetic.oracle_perception(scene, device=dev), t("meters"), t("intrinsic"),
            spec=spec,
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


def _train_loop(device, card, sample, dtype, steps=5):
    """A fixed-batch ICN training loop through the trainer API at lr 1e-3: one
    warm-up step, then ``steps`` steps timed one by one with CUDA events."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv
    from future_urban_scene_generation_tpu_torch.pipeline import training

    trainer = training.ICNTrainer(lr=1e-3)
    state = trainer.init(torch.Generator().manual_seed(0), device=device)
    x, y = sample.inputs.to(dtype), sample.targets.to(dtype)
    trainer.train_step(state, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_conv.SMALL_CIN_V2_LAUNCHES = 0
    events, l1 = [], []
    for _ in range(steps):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, metrics = trainer.train_step(state, x, y)
        ev[1].record()
        events.append(ev)
        l1.append(metrics["l_l1"])
    torch.cuda.synchronize()
    launches = cuda_conv.SMALL_CIN_V2_LAUNCHES
    times = [a.elapsed_time(b) for a, b in events]
    l1 = [float(v) for v in l1]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    b = x.shape[0]
    log(f"train[{dtype}]: batch {b} at 256^2, step times {[round(t, 2) for t in times]} ms; "
        f"median {med:.2f} ms = {b * 1000.0 / med:.2f} samples/s; peak memory {peak:.3f} GiB; "
        f"K3 launches {launches}; l_l1 {l1[0]:.5f} -> {l1[-1]:.5f} over {steps} steps ({card})")
    if not (all(math.isfinite(v) for v in l1) and l1[-1] < l1[0]):
        raise AssertionError(f"train[{dtype}]: l_l1 does not fall on a fixed batch: {l1}")
    if launches <= 0:
        raise AssertionError(f"train[{dtype}]: the ICN stem never reached kernel K3")
    return med


def _grad_distances(got, ref, zero, net):
    """Per gradient tensor (dicts name -> tensor): (max|diff| / max|ref|, relative
    L2). The biases in ``zero`` (instance-norm-fed: zero in exact arithmetic) get
    max|g| of either side over their conv's max|weight gradient| instead, twice."""
    out = {}
    for name, r in ref.items():
        g = got[name]
        if f"{net}.{name}" in zero:
            scale = ref[name.replace(".bias", ".weight")].abs().max()
            v = (max(g.abs().max(), r.abs().max()) / scale).item()
            out[name] = (v, v)
        else:
            out[name] = (((g - r).abs().max() / r.abs().max()).item(),
                         ((g - r).norm() / r.norm()).item())
    return out


def _step_on_both(trainer, sample, dtype, device):
    """One ``train_step`` from the same seeded weights on the same two pairs, on the
    CPU and on the card, in ``dtype``. Returns {device: (losses, {net: grads})}."""
    from future_urban_scene_generation_tpu_torch.pipeline import training

    out = {}
    for dev in ("cpu", device):
        state = trainer.init(torch.Generator().manual_seed(5), device=dev)
        state.gen.to(dtype)
        state.dis.to(dtype)
        state.gen_opt, state.dis_opt = training.make_optimizers(state.gen, state.dis,
                                                                trainer.lr)
        _, metrics = trainer.train_step(state, sample.inputs[:2].to(dev, dtype),
                                        sample.targets[:2].to(dev, dtype))
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {net: {n: p.grad.double().cpu() for n, p in
                           getattr(state, net).named_parameters()} for net in ("dis", "gen")})
    return out, training.instance_norm_fed_biases(state)


def _train_gpu_vs_cpu(device, sample):
    """One ICN step from the same weights on the same batch (2 datagen pairs at
    256^2, full width: ngf 64, ndf 64), on the card and on the CPU.

    float32, the training dtype: the losses agree to rtol 1e-3. Its gradients are
    held only to a relative L2 distance of 5e-2 per tensor, which catches a wrong
    backward (the channels_last avg-pool fault moved them by ~90% of max|g|): a
    float32 step puts some ReLU inputs within rounding of 0 (on a 32^2 input
    already, one lies within 1.7e-8 of max|x| of it), and each such input that
    rounds to the other side of the kink on one device moves the generator's
    gradients by up to ~1% of max|g| (PERF.md §6).

    float64, the same step: no input lies within float64 rounding of a kink, and
    every gradient tensor agrees to atol 1e-6 * max|g|, the losses to rtol 1e-6;
    the instance-norm-fed biases, zero in exact arithmetic, are held to within 1e-6
    of their conv's max|weight gradient|. float64 runs every op of the step on the
    card as float32 does, except the K3 stem (built for float32 and bfloat16 only),
    which stays on ``F.conv2d``; the k3 phase holds K3 and its gradients."""
    from future_urban_scene_generation_tpu_torch.pipeline import training

    trainer = training.ICNTrainer()
    bad = []
    for dtype, loss_tol, tol, metric in ((torch.float32, 1e-3, 5e-2, 1),
                                         (torch.float64, 1e-6, 1e-6, 0)):
        res, zero = _step_on_both(trainer, sample, dtype, device)
        (lc, gc), (lg, gg) = res["cpu"], res[device]
        bad += [f"{dtype} {k}" for k in lc if not abs(lg[k] - lc[k]) <= loss_tol * abs(lc[k])]
        worst = {}
        for net in ("dis", "gen"):
            dist = _grad_distances(gg[net], gc[net], zero, net)
            bad += [f"{dtype} {net}.{n}" for n, d in dist.items() if not d[metric] <= tol]
            worst[net] = tuple(max(d[i] for n, d in dist.items() if f"{net}.{n}" not in zero)
                               for i in (0, 1))
        log(f"train[gpu_vs_cpu {dtype}]: losses cpu {lc} gpu {lg} (rtol {loss_tol:g}); "
            "gradients, worst max|diff| / max|g| and relative L2: " + ", ".join(
                f"{net} {w[0]:.3e} / {w[1]:.3e}" for net, w in worst.items())
            + f" (tol {tol:g} on {('max|diff| / max|g|', 'relative L2')[metric]}; "
            "instance-norm-fed biases held near zero)")
    if bad:
        raise AssertionError(f"ICN step on the GPU disagrees with the CPU: {bad[:8]}")


def _pool_backward_check(device):
    """The discriminator's downsampler (layers.avg_pool_torch) differentiated on the
    card against float64 on the CPU: the CUDA backward of F.avg_pool2d is wrong on
    channels_last inputs, which the layer avoids."""
    from future_urban_scene_generation_tpu_torch.models.layers import avg_pool_torch

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 256, 256, 3, generator=gen, dtype=torch.float64)
    gy = torch.randn(8, 128, 128, 3, generator=gen, dtype=torch.float64)
    grads = []
    for dev, dtype in (("cpu", torch.float64), (device, torch.float32)):
        xx = x.to(dev, dtype).requires_grad_()
        grads.append(torch.autograd.grad(avg_pool_torch(xx), xx, gy.to(dev, dtype))[0].cpu())
    rel = ((grads[1].double() - grads[0]).abs().max() / grads[0].abs().max()).item()
    log(f"train[avg_pool backward]: card f32 vs CPU f64, max|diff| / max|g| {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("the discriminator's avg-pool backward is wrong on the card")


def phase_train(device, card):
    """The ICN trainer at full width (ngf 64, ndf 64, 256^2, batch 8): the CLI with
    a resume, fixed-batch loops in float32 and on bfloat16 inputs, and one step on
    the card against one on the CPU. Returns the launches of K3 and of K4's entry
    in the CLI run (K4 has no caller on the path: 0)."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import datagen

    out = os.path.join(OUT_DIR, "train_icn")
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--model", "icn", "--batch", "8", "--device", "cuda", "--out", out,
            "--log-interval", "1", "--save-interval", "3"]
    cuda_conv.SMALL_CIN_V2_LAUNCHES = cuda_conv.SMALL_CIN_LAUNCHES = 0
    cuda_raster.LAUNCHES = 0
    t0 = time.perf_counter()
    cli_train.main(argv + ["--steps", "3"])
    torch.cuda.synchronize()
    launches = {"conv_small_cin_v2": cuda_conv.SMALL_CIN_V2_LAUNCHES,
                "conv_small_cin": cuda_conv.SMALL_CIN_LAUNCHES}
    log(f"train[cli]: 3 steps in {time.perf_counter() - t0:.2f} s (cold); launches: "
        f"{launches}, raster (datagen) {cuda_raster.LAUNCHES}")
    metrics = os.path.join(out, "metrics.jsonl")

    def logged():
        with open(metrics) as f:
            return [json.loads(line) for line in f]

    if not (os.path.exists(os.path.join(out, "checkpoint.pt"))
            and [r["step"] for r in logged()] == [0, 1, 2]):
        raise AssertionError("train[cli]: metrics.jsonl or the checkpoint is missing")
    cli_train.main(argv + ["--steps", "4", "--resume"])
    recs = logged()
    if [r["step"] for r in recs] != [0, 1, 2, 3]:
        raise AssertionError(f"train[cli]: --resume did not pick up at iteration 3: {recs}")
    if not all(math.isfinite(r[k]) for r in recs for k in ("l_d", "l_g", "l_l1")):
        raise AssertionError("train[cli]: non-finite losses")
    losses = [(r["l_d"], r["l_g"], r["l_l1"]) for r in recs]
    log(f"train[cli]: resumed at iteration 3; losses {losses}")
    if launches["conv_small_cin_v2"] <= 0:
        raise AssertionError("train[cli]: the ICN stem never reached kernel K3")
    shutil.copy(metrics, os.path.join(OUT_DIR, "train_metrics.jsonl"))
    shutil.rmtree(out)  # the ~116 MB checkpoint stays on the machine

    generator, bank, frame, intrinsic = cli_train.icn_setup(0, device)
    with torch.no_grad():
        sample = datagen.icn_batch(generator, bank, frame, intrinsic, batch=8)
        dg_ms = cuda_ms(lambda: datagen.icn_batch(generator, bank, frame, intrinsic, batch=8),
                        iters=3, warmup=1)
    log(f"train[datagen]: {dg_ms:.2f} ms per batch of 8 pairs ({card})")
    for dtype in (torch.float32, torch.bfloat16):
        _train_loop(device, card, sample, dtype)
    _pool_backward_check(device)
    _train_gpu_vs_cpu(device, sample)
    return launches


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
    for _ in range(MAIN_SCENES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
    log(f"main: launches during the {MAIN_SCENES} scenes: {launches}")
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


def phase_demo(device, card):
    """The port's synthetic demo at full size (360x640, subdiv-2 car, 6 steps, both
    branches): the path of kernel K1'. Returns the launches counted over the demo."""
    from future_urban_scene_generation_tpu_torch.examples import demo_synthetic as demo
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.utils.native import read_png

    out = os.path.join(OUT_DIR, "demo_strip.png")
    cuda_raster.LAUNCHES = cuda_raster.INDEXED_LAUNCHES = cuda_conv.LAUNCHES = 0
    t0 = time.perf_counter()
    err, strip = demo.main(out, device)
    secs = time.perf_counter() - t0
    launches = {"rasterize_indexed": cuda_raster.INDEXED_LAUNCHES,
                "raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
    h, w = demo.FRAME_HW
    log(f"demo: {h}x{w}, 6 steps, both branches in {secs:.2f} s; PnP reprojection error "
        f"{err:.3e} px^2 (bar 1.0); strip {strip.shape}; launches {launches} ({card})")
    if not (0.0 <= err < 1.0):
        raise AssertionError(f"demo: PnP reprojection error {err} px^2 is not under 1.0")
    if strip.shape != (2 * h, 6 * w, 3) or not np.array_equal(read_png(out), strip):
        raise AssertionError("demo: the strip does not decode to what was written")
    if launches["rasterize_indexed"] != 1:
        raise AssertionError(f"demo: K1' launched {launches['rasterize_indexed']} times, not once")
    if min(launches.values()) <= 0:
        raise AssertionError(f"demo: a kernel of the demo's path never launched: {launches}")
    # Both branches draw the moving car: each step differs from step 0.
    for row in (strip[:h], strip[h:]):
        moved = np.abs(row[:, 5 * w:].astype(int) - row[:, :w].astype(int)).max(-1) > 8
        if not moved.mean() > 0.002:
            raise AssertionError("demo: the last step shows no motion against step 0")
    return launches


SERVE_HW = (720, 1280)
SERVE_IDS = (3, 7, 11, 15)
SERVE_FRAMES = 12
SERVE_WARM_REQUESTS = 3
STREAM_FRAMES = 8
STREAM_DEPTHS = (1, 2, 2, 1)  # each depth twice, in turns


def _serving_setup(device, ctx):
    """Write the CityFlow-shaped directory the serve and stream phases read, once:
    <root>/train/S01/c001/{frames/*.png, background_frame.png, calibration.txt,
    mtsc/mtsc_tc_ssd512.txt} and <root>/intrinsic.npy, at 720x1280. The frames are
    made by the port itself: four subdiv-3 cars rendered by ``render_normal_sketch``
    (kernel K1') over a seeded background, each moving ~6 px a frame; the tracks are
    the renders' own boxes. Frames and background go through the port's PNG writer."""
    if ctx:
        return ctx
    from future_urban_scene_generation_tpu_torch.geometry.rotations import x_rot, z_rot
    from future_urban_scene_generation_tpu_torch.pipeline import runner
    from future_urban_scene_generation_tpu_torch.pipeline.service import frames_to_uint8
    from future_urban_scene_generation_tpu_torch.render import rasterizer as rz
    from future_urban_scene_generation_tpu_torch.utils import mesh as mu
    from future_urban_scene_generation_tpu_torch.utils.native import AsyncPngWriter

    t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "serve_data")
    shutil.rmtree(root, ignore_errors=True)
    video_dir = os.path.join(root, "train", "S01", "c001")
    os.makedirs(os.path.join(video_dir, "frames"))
    os.makedirs(os.path.join(video_dir, "mtsc"))
    h, w = SERVE_HW
    f = 1000.0 * w / 1280
    k = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], device=device)
    np.save(os.path.join(root, "intrinsic.npy"), k.cpu().numpy())
    # The file holds the GPS -> pixel matrix; its inverse puts a pixel at 4.5e-7
    # degrees (about 0.05 m) around (45 N, 11 E).
    to_gps = np.array([[4.5e-7, 0, 45.0], [0, 4.5e-7, 11.0], [0, 0, 1.0]])
    rows = ";".join(" ".join(repr(float(v)) for v in r) for r in np.linalg.inv(to_gps))
    with open(os.path.join(video_dir, "calibration.txt"), "w") as f:
        f.write(f"Homography matrix: {rows}\n")

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    bg = np.stack([0.35 + 0.2 * yy / h, 0.4 + 0.15 * yy / h, 0.45 + 0.1 * xx / w], -1)
    bg = torch.as_tensor(bg + 0.04 * rng.rand(h, w, 3).astype(np.float32)).to(device)
    mesh, kp3d = mu.make_test_car(subdiv=3)
    bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device=device)
    cam = rz.Camera(*(f.reshape(1).expand(len(SERVE_IDS)) for f in rz.Camera.from_intrinsic(k)))
    tracks, frames = [], []
    for i in range(SERVE_FRAMES):
        exts = []
        for v in range(len(SERVE_IDS)):
            ext = torch.eye(4)
            ext[:3, :3] = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(0.4 + 0.3 * v))
            ext[:3, 3] = torch.tensor([-10.5 + 7.0 * v + 0.15 * i, 2.0, 26.0 + 0.05 * v * i])
            exts.append(ext)
        n = len(exts)
        sketch, bg_mask = rz.render_normal_sketch(
            bank.vertices[:1].expand(n, -1, -1), bank.triangles[0],
            bank.normals[:1].expand(n, -1, -1), torch.stack(exts).to(device), cam, (h, w))
        frame = bg
        for v, vid in enumerate(SERVE_IDS):
            frame = torch.where(bg_mask[v, ..., None], frame, sketch[v])
            ys, xs = torch.nonzero(~bg_mask[v], as_tuple=True)
            x0, y0, x1, y1 = (int(t) for t in (xs.min(), ys.min(), xs.max(), ys.max()))
            tracks.append([i + 1, vid, x0, y0, x1 - x0, y1 - y0, 1, -1, -1, -1])
        frames.append(frames_to_uint8(frame).cpu().numpy())
    np.savetxt(os.path.join(video_dir, "mtsc", "mtsc_tc_ssd512.txt"), np.asarray(tracks),
               delimiter=",")
    bg_u8 = frames_to_uint8(bg).cpu().numpy()
    with AsyncPngWriter(n_threads=4) as writer:
        writer.submit(os.path.join(video_dir, "background_frame.png"), bg_u8)
        for i, f in enumerate(frames):
            writer.submit(os.path.join(video_dir, "frames", f"{i + 1:04}.png"), f)
        if writer.flush():
            raise AssertionError("serve: writing the dataset's PNGs failed")
    log(f"serve: dataset written in {time.perf_counter() - t0:.2f} s: {SERVE_FRAMES} frames "
        f"{h}x{w} as PNG, {len(SERVE_IDS)} vehicles, first-frame boxes (xywh) "
        f"{[r[2:6] for r in tracks[:len(SERVE_IDS)]]}")
    ctx.update(root=root, video_dir=video_dir, frames=frames, background=bg_u8)
    return ctx


def _pixels_differ(a: np.ndarray, b: np.ndarray):
    """(share of samples that differ, largest difference) of two uint8 images."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return float((d > 0).mean()), int(d.max())


# A repeated scene on the card is expected to be bit-equal; this budget only keeps a
# last-bit flip at the uint8 truncation from failing the run.
EQUAL_SHARE, EQUAL_STEP = 1e-3, 1


def phase_serve(device, card, ctx):
    """``cli.run_test`` on the card, on the written directory, twice (cold, warm),
    with full-width seeded networks: 12 PNGs each, held against the port's
    ``run_scene`` on the same arguments; then three requests through one
    ``SceneService`` with the request's parts timed."""
    import contextlib
    import io

    from future_urban_scene_generation_tpu_torch.cli import run_test
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import runner, service
    from future_urban_scene_generation_tpu_torch.utils.native import read_png

    _serving_setup(device, ctx)
    root, video_dir = ctx["root"], ctx["video_dir"]
    ids = [str(i) for i in SERVE_IDS]
    outs = {}
    for label in ("cold", "warm"):
        outs[label] = os.path.join(root, f"results_{label}")
        argv = [video_dir, os.path.join(root, "no_kpoints"), os.path.join(root, "no_ckpts"),
                "--select-ids", *ids, "--frame-id", "1", "--device", device,
                "--frame-hw", *(str(n) for n in SERVE_HW), "--output-dir", outs[label]]
        cuda_raster.LAUNCHES = cuda_conv.LAUNCHES = 0
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            rc = run_test.main(argv)
        secs = time.perf_counter() - t0
        launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
        took = [ln for ln in said.getvalue().splitlines() if ln.startswith("Prediction of")]
        n_png = sum(len(fs) for _, _, fs in os.walk(outs[label]))
        log(f"serve[cli {label}]: exit {rc} in {secs:.2f} s (service built and one request); "
            f"the service said: {took}; {n_png} PNGs; launches per request {launches} ({card})")
        if rc != 0 or n_png != 12 or launches != {"raster": 1, "icn_stem_conv": 1}:
            raise AssertionError(f"serve[cli {label}]: rc {rc}, {n_png} PNGs, launches {launches}")

    cfg = PipelineConfig(video_dir=video_dir, kpoints_dir=os.path.join(root, "no_kpoints"),
                         checkpoints_dir=os.path.join(root, "no_ckpts"), device=device,
                         output_dir=os.path.join(root, "results_service"))
    cfg.runtime.frame_hw = SERVE_HW
    t0 = time.perf_counter()
    svc = service.SceneService(cfg)
    log(f"serve: SceneService built in {time.perf_counter() - t0:.2f} s (seeded full-width "
        f"networks, {svc.num_cads} procedural CAD, spec {svc.spec})")
    ctx["service"] = svc
    t0 = time.perf_counter()
    frame, background, bboxes, meters = svc.request_arguments(1, list(SERVE_IDS))
    t_host = time.perf_counter() - t0
    up = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_scene(svc.models, svc.cad_bank, up(frame), up(background), up(bboxes),
                           up(meters), up(svc.intrinsic), spec=svc.spec,
                           vis_res=cfg.runtime.vis_res)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    if not (bool(torch.isfinite(res.frames_icn).all())
            and bool(torch.isfinite(res.frames_vunet).all())):
        raise AssertionError("serve: run_scene gave non-finite frames")
    t0 = time.perf_counter()
    want = {"warp&learn": service.frames_to_uint8(res.frames_icn).cpu().numpy(),
            "vunet": service.frames_to_uint8(res.frames_vunet).cpu().numpy()}
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc._write_outputs(1, want["warp&learn"], want["vunet"])
    t_png = time.perf_counter() - t0
    log(f"serve: one request's parts: host arguments (PNG decode of frame and background, "
        f"tracks, meters) {t_host * 1e3:.1f} ms; upload + scene {t_scene * 1e3:.1f} ms; uint8 "
        f"conversion on the card + readback of {sum(a.nbytes for a in want.values()) / 1e6:.1f} "
        f"MB {t_read * 1e3:.1f} ms; 12 PNGs on 4 threads {t_png * 1e3:.1f} ms; pnp_error "
        f"{[round(x, 4) for x in res.pnp_error.tolist()]}")

    bg_u8 = ctx["background"]
    worst = (0.0, 0)
    for label, out in outs.items():
        for branch, frames in want.items():
            for i, fid in enumerate(range(1, 12, 2)):
                got = read_png(os.path.join(out, branch, "S01_c001", f"{fid:04}.png"))
                if got.shape != (*SERVE_HW, 3):
                    raise AssertionError(f"serve: {branch}/{fid:04}.png has shape {got.shape}")
                share, step = _pixels_differ(got, frames[i])
                worst = (max(worst[0], share), max(worst[1], step))
        # Step 0 of each branch: every vehicle's window differs from the background.
        for branch in want:
            got = read_png(os.path.join(out, branch, "S01_c001", "0001.png"))
            for x0, y0, x1, y1 in bboxes.astype(int):
                inside = np.abs(got[y0:y1, x0:x1].astype(int) - bg_u8[y0:y1, x0:x1]).max(-1)
                if not (inside > 12).mean() > 0.05:
                    raise AssertionError(f"serve[{label}]: {branch} left the window "
                                         f"{(x0, y0, x1, y1)} as the background")
    log(f"serve: the CLI's 24 PNGs against run_scene on the same arguments: share of samples "
        f"that differ {worst[0]:.2e} (budget {EQUAL_SHARE:g}), largest step {worst[1]} "
        f"(budget {EQUAL_STEP}); every vehicle window differs from the background")
    if worst[0] > EQUAL_SHARE or worst[1] > EQUAL_STEP:
        raise AssertionError("serve: the CLI's PNGs differ from run_scene's frames")

    times = []
    for _ in range(SERVE_WARM_REQUESTS):
        said = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said):
            paths = svc.run_request(1, list(SERVE_IDS))
        times.append(time.perf_counter() - t0)
        if len(paths) != 12:
            raise AssertionError("serve: a warm request did not write 12 PNGs")
    log(f"serve: warm requests through one service (decode, scene, readback, 12 PNGs): "
        f"{[round(t, 3) for t in times]} s; median {statistics.median(times):.3f} s ({card})")
    shutil.copy(os.path.join(outs["warm"], "warp&learn", "S01_c001", "0011.png"),
                os.path.join(OUT_DIR, "serve_icn_0011.png"))
    for out in list(outs.values()) + [cfg.output_dir]:
        shutil.rmtree(out)


def phase_stream(device, card, ctx):
    """``StreamRunner`` at 720x1280, V=4, 8 frames, depth 1 and depth 2, against
    direct ``run_scene`` calls; ``TrackingStreamRunner`` on the 12 frames with the
    background-difference detector."""
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig
    from future_urban_scene_generation_tpu_torch.pipeline import runner, service, streaming
    from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk

    _serving_setup(device, ctx)
    root, video_dir = ctx["root"], ctx["video_dir"]
    svc = ctx.get("service")
    if svc is None:
        cfg = PipelineConfig(
            video_dir=video_dir, kpoints_dir=os.path.join(root, "no_kpoints"),
            checkpoints_dir=os.path.join(root, "no_ckpts"), device=device,
            output_dir=os.path.join(root, "results_service"))
        cfg.runtime.frame_hw = SERVE_HW
        svc = service.SceneService(cfg)
    frames_u8, bg_u8 = ctx["frames"], ctx["background"]
    vis_res = svc.cfg.runtime.vis_res
    n_frames = STREAM_FRAMES
    requests = []
    for fid in range(1, n_frames + 1):
        _, _, bboxes, meters = svc.request_arguments(fid, list(SERVE_IDS))
        requests.append((frames_u8[fid - 1], bboxes, meters))

    upload = streaming.StreamRunner._upload
    direct = []
    for frame, bboxes, meters in requests:
        res = runner.run_scene(svc.models, svc.cad_bank, upload(frame, device),
                               upload(bg_u8, device), upload(bboxes, device),
                               upload(meters, device), upload(svc.intrinsic, device),
                               spec=svc.spec, vis_res=vis_res)
        direct.append((service.frames_to_uint8(res.frames_icn),
                       service.frames_to_uint8(res.frames_vunet)))
    torch.cuda.synchronize()

    for depth in STREAM_DEPTHS:
        stream = streaming.StreamRunner(svc.models, svc.cad_bank, svc.intrinsic, SERVE_HW,
                                        n_vehicles=len(SERVE_IDS), spec=svc.spec,
                                        vis_res=vis_res, depth=depth)
        results = []
        for frame, bboxes, meters in requests:
            out = stream.submit(frame, bboxes, meters, background=bg_u8)
            if out is not None:
                results.append(out)
        results.extend(stream.flush())
        torch.cuda.synchronize()
        if len(results) != n_frames:
            raise AssertionError(f"stream[depth {depth}]: {len(results)} results for {n_frames}")
        worst = (0.0, 0)
        for got, (icn, vun) in zip(results, direct):
            for a, b in ((got.frames_icn, icn), (got.frames_vunet, vun)):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"stream[depth {depth}]: non-finite frames")
                d = (service.frames_to_uint8(a).to(torch.int16) - b.to(torch.int16)).abs()
                worst = (max(worst[0], (d > 0).float().mean().item()),
                         max(worst[1], int(d.max().item())))
        lat = sorted(stream.latencies)
        p90 = lat[int(0.9 * (len(lat) - 1))]
        log(f"stream[depth {depth}]: {n_frames} scenes {SERVE_HW[0]}x{SERVE_HW[1]} V=4 in order; "
            f"against direct calls: share of samples that differ {worst[0]:.2e}, largest step "
            f"{worst[1]}; throughput {stream.throughput_fps:.2f} composited frames/s; latency "
            f"p50 {statistics.median(lat) * 1e3:.1f} ms, p90 {p90 * 1e3:.1f} ms, max "
            f"{lat[-1] * 1e3:.1f} ms ({card})")
        if worst[0] > EQUAL_SHARE or worst[1] > EQUAL_STEP:
            raise AssertionError(f"stream[depth {depth}]: results differ from direct calls")
        del results, stream

    detector = trk.BackgroundDiffDetector(upload(bg_u8, device))
    tracker = streaming.TrackingStreamRunner(
        svc.models, svc.cad_bank, svc.intrinsic, SERVE_HW, n_vehicles=len(SERVE_IDS),
        spec=svc.spec, vis_res=vis_res, depth=2, detector=detector,
        inv_homography=svc.inv_homography)
    scenes, first, n_conf = [], None, []
    for i, frame in enumerate(frames_u8):
        out, tracks = tracker.submit_frame(frame, background=bg_u8)
        if i == 0:
            first = (out, tracks)
        n_conf.append(len(tracks))
        if out is not None:
            scenes.append(out)
    scenes.extend(tracker.flush())
    torch.cuda.synchronize()
    ids = sorted(t.track_id for t in tracker.tracker.confirmed())
    finite = all(bool(torch.isfinite(r.frames_icn).all()) for r in scenes)
    log(f"stream[tracking]: {len(frames_u8)} frames, confirmed tracks per frame {n_conf}, ids "
        f"{ids}; {len(scenes)} scenes synthesized, finite {finite}; "
        f"{tracker.throughput_fps:.2f} composited frames/s over the synthesized scenes ({card})")
    if first != (None, []) or not ids or not scenes or not finite:
        raise AssertionError("stream[tracking]: no confirmed track or no scene synthesized")
    svc.close()


def _drop_serving_data(ctx):
    if ctx:
        shutil.rmtree(ctx["root"], ignore_errors=True)


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
    t_start = time.perf_counter()
    kernels, launches, serving = [], {}, {}
    if "k1" in phases:
        kernels.extend(phase_k1(device))
    if "k2" in phases:
        kernels.append(phase_k2(device))
    if "k3" in phases:
        kernels.extend(phase_k3(device))
    if "gpu_vs_cpu" in phases:
        phase_gpu_vs_cpu(device)
    if "main" in phases:
        launches = phase_main(device, args.profile, smi)
    if "train" in phases:
        launches.update(phase_train(device, smi))
    if "demo" in phases:
        launches["rasterize_indexed"] = phase_demo(device, smi)["rasterize_indexed"]
    try:
        if "serve" in phases:
            phase_serve(device, smi, serving)
        if "stream" in phases:
            phase_stream(device, smi, serving)
    finally:
        _drop_serving_data(serving)  # ~130 MB of frames and results stay on the machine
    log(f"phases {phases} passed in {time.perf_counter() - t_start:.1f} s after the build")
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
