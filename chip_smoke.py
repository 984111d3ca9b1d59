"""Quickest proof that the PyTorch port runs on the GPU: builds the CUDA kernels
from the checkout, holds each against its plain PyTorch version, holds the port on
the GPU against the port on the CPU, drives ``runner.run_scene`` on the benchmark
scene (1080p, 4 vehicles, 6 steps, 10 CADs of 1,944 triangles) in the bf16 serving
config, trains the full-width ICN through ``cli.train --model icn`` and the trainer
API (float32 and bfloat16 inputs), then drives the serving entry points: the
synthetic demo (360x640), ``cli.run_test`` on a CityFlow-shaped directory it writes
(720x1280, 4 vehicles), the stream runners on the same frames, ``MultiStreamRunner``
over 1, 2 and 4 cameras (threaded and not), ``cli.warmup`` in a fresh process and the
web GUI's server over one ``SceneService``. The train phase also trains the VUNet,
the hourglass and the CAD classifier at full width (``cli.train``, timed loops, one
step on the card against the CPU, the train-mode batch norm's backward).

    python3 chip_smoke.py                    # every phase, one GPU
    python3 chip_smoke.py --phases k3,train  # a subset (device and build always run)
    python3 chip_smoke.py --profile          # also write a torch.profiler table of one scene

The k1 phase holds K1 and K1' (two CUDA launches a call: triangle setup, tiles) at
every shape against their plain versions after a launch on all-NaN inputs: the setup
kernel's table bit for bit, the tile kernel's per-tile counts, images and masks; a
profiled call must show those two kernels on the device and nothing else.

Kernel launches in the ``kernels`` line, each counted over its own path with the
counters set to 0 just before: K1 and K2 from the main phase's scenes, K3 from the
train phase's CLI run, K1' from the demo; K4's entry has no caller on any path.
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the card's
peak for the kernel's type (the H100 SXM's published 67 TFLOP/s float32, 989 TFLOP/s
bf16), from this run's inputs (the raster's operations are counted from the bboxes of
the triangles it is given, by brute force); ``library_ms`` is one PyTorch call computing the same
function, timed here and used nowhere in the port.

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels' record.
Longer output (compiler report, profile) goes to ``chiprun_out/``.
"""
import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
ALL_PHASES = ("k1", "k2", "k3", "gpu_vs_cpu", "main", "train", "demo", "serve", "stream",
              "multi", "warmup", "web")
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
    # One line per kernel: registers and spills (the full report is in ptxas.txt).
    name = spill = None
    for line in _kernels.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for tag in ("raster_setup_kernel", "raster_tiles_kernel", "conv_mma_kernel",
                        "conv_wgmma_kernel", "conv_fma_kernel"):
                if tag in name:
                    loader = next((label for key, label in (
                        ("StemLoader", "Stem"), ("Padded", "Padded"), ("CornerLoader", "Corner"),
                        ("IndexedLoaderIi", "Indexed int32 "),
                        ("IndexedLoaderIx", "Indexed int64 "),
                    ) if key in name), "")
                    ints = ",".join(re.findall(r"Li(\d+)E", name.split("EvT_")[0]))
                    name = f"{tag}<{loader}{ints}>" if loader else tag
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            log(f"  ptxas: {name}: {line.split('Used')[1].split(',')[0].strip()}; {spill}")
            if " 0 bytes spill stores, 0 bytes spill loads" not in " " + spill:
                raise AssertionError(f"{name} spills registers: {spill}")
            name = spill = None
    if "(C7519)" in _kernels.BUILD_LOG:
        raise AssertionError("ptxas injected warpgroup.arrive into a wgmma group (C7519): a "
                             "product stands behind a branch between its fence and commit")
    # Which product the bf16 kernels run on: count tensor-core instructions in the SASS.
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(_kernels.build())], capture_output=True,
                              text=True, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split(":")[1].strip()
            elif "HMMA." in line or "HGMMA." in line:
                key = (fn, "wgmma (HGMMA)" if "HGMMA." in line else "mma.sync (HMMA)")
                counts[key] = counts.get(key, 0) + 1
        for (fn, kind), n in sorted(counts.items()):
            log(f"  sass: {kind} x {n} in {fn[:60]}")
        found = (len({fn for fn, kind in counts if "conv_mma_kernel" in fn and "HMMA" in kind}),
                 len({fn for fn, kind in counts if "conv_wgmma_kernel" in fn and "HGMMA" in kind}))
        if found != (4, 2):
            raise AssertionError(f"{found} of the (4 mma.sync, 2 wgmma) bf16 conv kernels hold "
                                 "their tensor-core instructions")
    else:
        log("  sass: cuobjdump not found, tensor-core instructions not checked")


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


def _raster_ops(screen, colors, cull, hw):
    """Operations this run's inputs need of the raster, by two reckonings: every
    pixel of a 16x16 tile evaluates the three barycentric planes (2 multiplies and 2
    adds each) of every triangle whose own bbox overlaps the tile (what the tile
    kernel evaluates at most), and, as until now, of all 8 triangles of every group
    whose bbox overlaps it. Counted by brute force from the inputs' bboxes (the
    plain prep's table), not from anything the kernels write."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    table = cr.triangle_planes_corners(screen, colors, cull)
    x0, y0 = cr._tile_origins(-(-hw[0] // cr.TILE), -(-hw[1] // cr.TILE), cr.TILE, table.device)
    tri_pairs = group_pairs = 0
    for tb in table:  # one render at a time: (n_tiles, rows) overlaps
        tri_pairs += int(cr._box_hits_tile(tb[None, None, :, cr._TRI_BBOX_COL:], x0, y0,
                                           cr.TILE).sum())
        group_pairs += int(cr._box_hits_tile(
            tb[None, None, ::cr.GROUP, cr._BBOX_COL:cr._BBOX_COL + 4], x0, y0, cr.TILE).sum())
    per_pair = 12.0 * cr.TILE ** 2
    return per_pair * tri_pairs, per_pair * cr.GROUP * group_pairs, tri_pairs, group_pairs


def _nan_like(t):
    return torch.full_like(t, float("nan"))


def _check_scratch_and_counts(name, out, screen, colors, cull, hw):
    """The setup kernel's table and group bboxes against the plain prep, bit for
    bit, and the tile kernel's per-tile (groups, triangles) counts against
    ``bin_scan_plain`` on that table."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    r_n, n_tris = screen.shape[0], screen.shape[-1]
    table_p = cr.triangle_planes_corners(screen, colors, cull)
    table_k, gbbox_k = cr.scratch_views(out.scratch, r_n, n_tris)
    if not torch.equal(table_k, table_p):
        bad = table_k != table_p
        raise AssertionError(
            f"k1[{name}]: the setup kernel's table differs from the torch prep in "
            f"{int(bad.sum())} of {bad.numel()} entries (columns "
            f"{sorted(set(bad.nonzero()[:, 2].tolist()))}), max abs diff "
            f"{(table_k - table_p)[bad].abs().max().item():.3e}")
    if not torch.equal(gbbox_k, table_p[:, ::cr.GROUP, cr._BBOX_COL:cr._BBOX_COL + 4]):
        raise AssertionError(f"k1[{name}]: the compact group bboxes differ from the table's")
    scan = cr.bin_scan_plain(table_p, -(-hw[0] // cr.TILE), -(-hw[1] // cr.TILE))
    if not (torch.equal(out.tile_counts[..., 0], scan.group_counts)
            and torch.equal(out.tile_counts[..., 1], scan.tri_counts)):
        raise AssertionError(f"k1[{name}]: the tile kernel's per-tile counts differ from "
                             "bin_scan_plain")
    return int(scan.group_counts.sum()), int(scan.tri_counts.sum())


def _check_plan(r_n, n_tris, hw, indexed=False):
    """The launch geometry as ``raster_plan`` states it and as the library computes it."""
    import ctypes

    from future_urban_scene_generation_tpu_torch.ops import _kernels, cuda_raster as cr

    out = (ctypes.c_int * 7)()
    rc = _kernels.load().fusg_raster_plan(n_tris, hw[0], hw[1], ctypes.addressof(out))
    plan = cr.raster_plan(r_n, n_tris, *hw, indexed=indexed)
    want = [plan.t_pad, plan.n_groups, plan.setup_grid[0], plan.tile_grid[0], plan.block,
            plan.passes, plan.smem]
    if rc != 0 or list(out) != want:
        raise AssertionError(f"raster_plan {want} disagrees with the library {list(out)} "
                             f"(rc {rc}) at T={n_tris}, {hw}")
    return plan


def _only_raster_kernels(name, fn, calls=5):
    """A profiled run of ``calls`` calls of ``fn``: raises unless the device ran the
    two kernels of csrc/raster.cu (setup, tiles), at most once a call each, and
    nothing else: no aten kernel, no copy, no memset. (The tracer may drop a launch
    of a ~1 us kernel, so fewer than ``calls`` records of a kernel pass.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ours = {tag: sum(n for key, n in rows if tag in key)
            for tag in ("raster_setup_kernel", "raster_tiles_kernel")}
    others = [key for key, _ in rows if not any(tag in key for tag in ours)]
    log(f"k1[{name}]: device kernels of {calls} profiled calls: {ours}, others {others}")
    if others or not all(0 < n <= calls for n in ours.values()):
        raise AssertionError(f"k1[{name}]: a call must run the two kernels of raster.cu and "
                             f"nothing else on the device, got {rows} in {calls} calls")


def _corners_case(name, screen, colors, cull, hw, dense=False, want_background=None):
    """K1 at one shape, after a launch on all-NaN inputs of the same shapes: table,
    group bboxes and per-tile counts against the plain versions, the wrapper equal
    to the checked launch, images and masks against the plain raster."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    _check_plan(screen.shape[0], screen.shape[-1], hw)
    cr.launch_corners(_nan_like(screen), _nan_like(colors), hw, cull)
    out = cr.launch_corners(screen, colors, hw, cull, tile_counts=True)
    torch.cuda.synchronize()
    n_groups, n_tris = _check_scratch_and_counts(name, out, screen, colors, cull, hw)
    cr.launch_corners(_nan_like(screen), _nan_like(colors), hw, cull)
    img_w, bg_w = cr.rasterize_corners(screen, colors, hw, cull=cull)
    plain = cr.rasterize_corners_plain(screen, colors, hw, cull=cull)
    torch.cuda.synchronize()
    if not (torch.equal(img_w, out.image) and torch.equal(bg_w, out.background)):
        raise AssertionError(f"k1[{name}]: the wrapper's output differs between two launches")
    if want_background is not None and not bool(bg_w[want_background].all()):
        raise AssertionError(f"k1[{name}]: render {want_background} is not all background")
    log(f"k1[{name}]: {hw[0]}x{hw[1]}; table and group bboxes equal to the torch prep bit for "
        f"bit; per-tile counts equal to bin_scan_plain ({n_groups} binned groups, {n_tris} "
        "triangles kept of them); after a NaN launch")
    return _raster_budget(name, (img_w, bg_w), plain, screen.shape[0], screen.shape[-1], dense)


def _kernel_device_ms(fn, calls=20):
    """Mean device time of each of the two raster kernels over ``calls`` calls of
    ``fn``, from the profiler's kernel records: unlike a CUDA-event loop around one
    small kernel, this does not include the host's pace between launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = []
    for tag in ("raster_setup_kernel", "raster_tiles_kernel"):
        mine = [e for e in rows if tag in e.key]
        traced = sum(e.count for e in mine)  # the tracer may drop a launch of a ~1 us kernel
        if not 0 < traced <= calls:
            raise AssertionError(f"{tag}: {traced} launches traced in {calls} calls")
        out.append(sum(e.self_device_time_total for e in mine) / traced / 1e3)
    return tuple(out)


def _raster_times(launch, wrapper, plain):
    """Times in ms: the wrapper, the setup kernel alone and the tile kernel alone by
    CUDA events around back-to-back calls (each call allocates its outputs, so the
    host paces these loops), the plain version, and each kernel's device time from
    the profiler. ``launch`` takes the launcher's ``phases`` / ``scratch`` keywords."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    scratch = launch().scratch
    return (cuda_ms(wrapper, iters=100, warmup=5),
            cuda_ms(lambda: launch(phases=cr.PHASE_SETUP, scratch=scratch), iters=100, warmup=5),
            cuda_ms(lambda: launch(phases=cr.PHASE_TILES, scratch=scratch), iters=100, warmup=5),
            cuda_ms(plain, iters=3, warmup=1)) + _kernel_device_ms(wrapper)


def _corners_times(name, screen, colors, cull, hw):
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    ms, setup_ms, tiles_ms, plain_ms, setup_dev, tiles_dev = _raster_times(
        lambda **kw: cr.launch_corners(screen, colors, hw, cull, **kw),
        lambda: cr.rasterize_corners(screen, colors, hw, cull=cull),
        lambda: cr.rasterize_corners_plain(screen, colors, hw, cull=cull))
    ops, ops_groups, tri_pairs, group_pairs = _raster_ops(screen, colors, cull, hw)
    n_bytes = nbytes(screen, colors, cull) + screen.shape[0] * hw[0] * hw[1] * 13
    bound, by = bound_ms(n_bytes, ops, PEAK_F32)
    old_bound, old_by = bound_ms(n_bytes, ops_groups, PEAK_F32)
    log(f"k1 time at {name} ({screen.shape[0]} x {screen.shape[-1]} triangles, {hw[0]}x{hw[1]}): "
        f"wrapper {ms:.4f} ms; timed apart: setup kernel alone {setup_ms:.4f} ms, tile kernel "
        f"alone {tiles_ms:.4f} ms (event loops, paced by the host); device time by the "
        f"profiler: setup {setup_dev:.4f} ms, tiles {tiles_dev:.4f} ms; plain version "
        f"{plain_ms:.3f} ms; bound {bound:.5f} ms by {by} "
        f"({n_bytes / 1e6:.2f} MB moved once = {n_bytes / PEAK_BYTES * 1e3:.5f} ms; {tri_pairs} "
        f"(triangle bbox, tile) overlaps x 256 px x 12 flop = {ops / PEAK_F32 * 1e3:.5f} ms); by "
        f"the earlier reckoning ({group_pairs} group overlaps x 8 triangles) {old_bound:.5f} ms "
        f"by {old_by}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def _indexed_case(name, verts_screen, triangles, vert_colors, hw, timed=True):
    """K1' at one shape, after a launch on all-NaN vertices: against the corners
    entry on the gathered mesh (exact: the same values minus the gather, table
    included), against its plain version, and timed. An indexed mesh carries no cull
    flag, so back faces are rastered too, and where a back and a front edge meet on
    the silhouette the kernel's affine planes and the plain raster's edge functions
    may cover a pixel differently: the plain comparison takes the dense-mesh budget
    of the corners case (tests/test_pallas_raster.py:130-151), not its equal-masks
    one."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster as cr

    args = (verts_screen, triangles, vert_colors, hw)
    r_n, n_tris = verts_screen.shape[0], triangles.shape[-2]
    _check_plan(r_n, n_tris, hw, indexed=True)
    cr.launch_indexed(_nan_like(verts_screen), triangles, _nan_like(vert_colors), hw)
    out = cr.launch_indexed(*args, tile_counts=True)
    screen = cr.gather_corners(verts_screen, triangles)
    colors = cr.gather_corners(vert_colors, triangles)
    torch.cuda.synchronize()
    _check_scratch_and_counts(f"indexed, {name}", out, screen, colors, None, hw)
    corners = cr.launch_corners(screen, colors, hw)
    cr.launch_indexed(_nan_like(verts_screen), triangles, _nan_like(vert_colors), hw)
    got = cr.rasterize_indexed(*args)
    plain = cr.rasterize_indexed_plain(*args)
    torch.cuda.synchronize()
    max_err = _raster_budget(f"indexed, {name}", got, plain, r_n, n_tris, dense=True)
    if not (torch.equal(got[0], corners.image) and torch.equal(got[1], corners.background)
            and torch.equal(out.image, got[0]) and torch.equal(out.scratch, corners.scratch)):
        raise AssertionError(f"K1' differs from the corners entry on the gathered mesh ({name})")
    if not timed:
        log(f"k1[indexed, {name}]: table, image and mask equal to the corners entry")
        return None
    ms, setup_ms, tiles_ms, plain_ms, setup_dev, tiles_dev = _raster_times(
        lambda **kw: cr.launch_indexed(*args, **kw), lambda: cr.rasterize_indexed(*args),
        lambda: cr.rasterize_indexed_plain(*args))
    ops, ops_groups, tri_pairs, group_pairs = _raster_ops(screen, colors, None, hw)
    n_bytes = nbytes(verts_screen, triangles, vert_colors) + r_n * hw[0] * hw[1] * 13
    bound, by = bound_ms(n_bytes, ops, PEAK_F32)
    old_bound, old_by = bound_ms(n_bytes, ops_groups, PEAK_F32)
    log(f"k1[indexed, {name}]: table, image and mask equal to the corners entry; K1' wrapper "
        f"{ms:.4f} ms (setup kernel alone {setup_ms:.4f} ms, tile kernel alone {tiles_ms:.4f} "
        f"ms, event loops paced by the host; device time by the profiler: setup "
        f"{setup_dev:.4f} ms, tiles {tiles_dev:.4f} ms); plain version {plain_ms:.3f} ms; bound "
        f"{bound:.5f} ms by {by} ({tri_pairs} triangle overlaps; by the earlier reckoning, "
        f"{group_pairs} group overlaps x 8: {old_bound:.5f} ms by {old_by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def _datagen_renders(device):
    """The one K1 call of an ICN training batch (batch 8: the src and dst views, 16
    renders), with the arguments ``datagen.icn_batch`` hands the wrapper."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import datagen

    generator, bank, frame, intrinsic = cli_train.icn_setup(0, device)
    seen, real = [], cuda_raster.rasterize_corners

    def spy(screen, colors, out_hw, cull=None):
        seen.append((screen, colors, cull, tuple(out_hw)))
        return real(screen, colors, out_hw, cull=cull)

    cuda_raster.rasterize_corners = spy
    try:
        with torch.no_grad():
            datagen.icn_batch(generator, bank, frame, intrinsic, batch=8)
    finally:
        cuda_raster.rasterize_corners = real
    if len(seen) != 1:
        raise AssertionError(f"datagen: {len(seen)} K1 calls a batch, not one")
    return seen[0]


def phase_k1(device):
    from future_urban_scene_generation_tpu_torch.examples.demo_synthetic import FRAME_HW
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    hw = (256, 256)
    (screen, colors, cull), indexed = _main_path_renders(device)
    max_err = _corners_case("main path: 24 culled cars", screen, colors, cull, hw)
    for subdiv in (16, 29):  # 6,144 and 20,184 triangles: 3 and 10 binning passes
        s1, c1 = _single_mesh(subdiv, device)
        _corners_case(f"dense mesh subdiv={subdiv}", s1, c1, None, hw, dense=True)
    rng = np.random.RandomState(31)
    verts = rng.rand(400, 3) * [250, 250, 3] + [0, 0, 4]
    tris = rng.randint(0, 400, (2000, 3))
    cols = rng.rand(400, 3)
    rs = torch.as_tensor(np.stack([verts[tris[:, k]].T for k in range(3)])[None].astype(np.float32),
                         device=device)
    rc = torch.as_tensor(np.stack([cols[tris[:, k]].T for k in range(3)])[None].astype(np.float32),
                         device=device)
    _corners_case("random soup, no cull", rs, rc, None, hw)
    # H, W no multiples of the tile (5.6 x 10 tiles), T no multiple of the group, T = 1.
    small = rs * torch.tensor([160 / 250, 90 / 250, 1.0], device=device)[None, None, :, None]
    _corners_case("random soup, ragged", small, rc, None, (90, 160))
    _corners_case("T = 13", small[..., 5:18].contiguous(), rc[..., 5:18].contiguous(), None,
                  (90, 160))
    _corners_case("T = 1", rs[..., 7:8].contiguous(), rc[..., 7:8].contiguous(), None, hw)
    # A render that draws nothing beside one that does: every corner of render 1
    # behind the camera.
    two = screen[:2].clone()
    two[1, :, 2] = -1.0
    _corners_case("an empty render", two, colors[:2], cull[:2], hw, want_background=1)
    dg_screen, dg_colors, dg_cull, dg_hw = _datagen_renders(device)
    _corners_case("datagen: 16 renders of a batch of 8", dg_screen, dg_colors, dg_cull, dg_hw)

    _only_raster_kernels("main path", lambda: cuda_raster.rasterize_corners(screen, colors, hw,
                                                                            cull=cull))
    times = _corners_times("the main-path shape", screen, colors, cull, hw)
    _corners_times("datagen's shape", dg_screen, dg_colors, dg_cull, dg_hw)
    # What 6,144 tile blocks cost when none draws: one triangle behind the camera a render.
    nothing = screen[..., :1].clone()
    nothing[:, :, 2] = -1.0
    _corners_times("24 renders that draw nothing", nothing, colors[..., :1].contiguous(), cull, hw)
    for subdiv in (16, 29):
        s1, c1 = _single_mesh(subdiv, device)
        _corners_times(f"the dense mesh, subdiv={subdiv}", s1, c1, None, hw)
    src = "future_urban_scene_generation_tpu_torch/csrc/raster.cu"
    k1 = dict(name="raster", route="cuda", source=src,
              replaces="future_urban_scene_generation_tpu/ops/pallas_raster.py:279",
              max_abs_err=max_err, library_ms=None, **times)

    _indexed_case("main path: 24 cars, 256^2", *indexed, hw)
    iv = torch.as_tensor(verts * [160 / 250, 90 / 250, 1.0], dtype=torch.float32, device=device)
    ic = torch.as_tensor(cols, dtype=torch.float32, device=device)
    it = torch.as_tensor(tris[5:18], device=device)
    _indexed_case("T = 13, int32, 90x160", iv[None], it.to(torch.int32), ic[None], (90, 160),
                  timed=False)
    _indexed_case("T = 13, per-render int64 lists, 90x160", iv[None].repeat(2, 1, 1),
                  torch.stack([it, it.flip(0)]), ic[None].repeat(2, 1, 1), (90, 160), timed=False)
    demo_args = _demo_render(device)
    demo_case = _indexed_case("the demo's car, 360x640", *demo_args, FRAME_HW)
    _only_raster_kernels("indexed, the demo's car",
                         lambda: cuda_raster.rasterize_indexed(*demo_args, FRAME_HW))
    # The kernels line carries K1' at the shape its own path (the demo) gives it.
    k1i = dict(name="rasterize_indexed", route="cuda", source=src,
               replaces="future_urban_scene_generation_tpu/ops/pallas_raster.py:342",
               library_ms=None, **demo_case)
    return [k1, k1i]


def _stem_inputs(device, dtype, seed=11, n=24, s=6, hw=(256, 256)):
    rng = np.random.RandomState(seed)
    h, w = hw

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device).to(dtype)

    return (t(rng.rand(n, h, w, 3)), t(rng.rand(n // s, h, w, 3)),
            t(rng.rand(n, 5, h, w, 3)), t(rng.rand(7, 7, 21, 64) - 0.5)), s


# The main-path stem, then s_repeat = 1 and an H, W that is no multiple of the 16x16 tile.
K2_CASES = (dict(n=24, s=6, hw=(256, 256)), dict(n=5, s=1, hw=(50, 37)),
            dict(n=6, s=3, hw=(33, 72)))


def _poison_shared_memory(fn, tensors, **kwargs):
    """Runs ``fn`` on NaN-filled tensors of the same shapes, so that every shared-memory
    slot the next launch stages (patch buffers, channel pads, tails, weight slots)
    holds NaN bits beforehand: a padded channel, tail or zero weight row that the
    kernel fails to write would then reach the output as NaN (0 x NaN)."""
    fn(*(torch.full_like(t, float("nan")) for t in tensors), **kwargs)


def _conv_errors(got, ref):
    """(float32 max abs error and its tolerance, bf16 worst ratio to its bound) of a
    kernel output against the float64 plain version on the same inputs. float32: the
    JAX test's atol 3e-5 (tests/test_layers.py:294) for outputs of magnitude ~10,
    scaled to this output's magnitude. bf16: within one bf16 ulp (2^-7 relative) of the
    exact result on the same bf16-rounded inputs, plus float32 summation noise."""
    diff = (got.double() - ref).abs()
    mag = ref.abs().max().item()
    bound16 = 2.0 ** -7 * ref.abs() + 1e-4 * mag
    return diff.max().item(), 3e-5 * max(1.0, mag / 10.0), (diff / bound16).max().item()


def phase_k2(device):
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    # The plain version runs in float64 on the same inputs, so the error measured is
    # the kernel's own float32 accumulation (K = 1,029 terms per output).
    err16 = None
    for case in K2_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            pieces, rep = _stem_inputs(device, dtype, **case)
            _poison_shared_memory(cuda_conv.icn_stem_conv, pieces, pad=3, s_repeat=rep)
            got = cuda_conv.icn_stem_conv(*pieces, pad=3, s_repeat=rep)
            ref = cuda_conv.icn_stem_conv_plain(*(t.double() for t in pieces), pad=3,
                                                s_repeat=rep)
            torch.cuda.synchronize()
            err, tol32, ratio16 = _conv_errors(got, ref)
            if dtype == torch.float32:
                ok = err <= tol32
                log(f"k2[f32 {case}]: max abs err {err:.3e} vs float64 plain (tol {tol32:.3e}), "
                    f"after a NaN launch -> {'ok' if ok else 'FAIL'}")
            else:
                ok = ratio16 <= 1.0 and got.dtype == torch.bfloat16
                log(f"k2[bf16 {case}]: max abs err {err:.3e} vs float64 plain on the same bf16 "
                    f"inputs (bound 2^-7 |ref| + 1e-4 max|ref|, worst ratio {ratio16:.3f}), "
                    f"after a NaN launch -> {'ok' if ok else 'FAIL'}")
                if case is K2_CASES[0]:
                    err16 = err
            if not ok:
                raise AssertionError(f"kernel K2 ({dtype}) disagrees with its plain version "
                                     f"at {case}")

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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        bound, by = bound_ms(nbytes(a, b, c, w, ker_out), 2.0 * n_out * w[..., 0].numel(), peak)
        times[dtype] += (bound, by)
        plan = cuda_conv.conv_plan(dtype, 21, 7, 64)
        log(f"k2 time at the main-path shape (N=24, 256^2, 21->64, {dtype}): K2 "
            f"{times[dtype][0]:.3f} ms ({_product(plan)}); plain version (f32 F.conv2d on the "
            f"concat it builds) {times[dtype][1]:.3f} ms; library call (F.conv2d in {dtype} on "
            f"the materialized concat) {times[dtype][2]:.3f} ms, max abs diff to K2 "
            f"{lib_err:.3e}; bound {bound:.4f} ms by {by}"
            + _padded_bound(plan, n_out, 7, peak))
    ms, plain_ms, library_ms, bound, by = times[torch.bfloat16]  # the scene serves in bf16
    return dict(name="icn_stem_conv", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/stem_conv.cu",
                replaces="future_urban_scene_generation_tpu/ops/pallas_conv.py:148",
                max_abs_err=err16, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms)


def _product(plan) -> str:
    """Which main loop of csrc/conv_core.cuh a plan runs, in words."""
    if plan.route in ("wgmma", "mma"):
        product = "wgmma m64n64k16" if plan.route == "wgmma" else "mma.sync m16n8k16"
        return (f"{product} on the tensor cores, weights "
                + ("resident" if plan.resident else "one kernel row at a time")
                + f", {plan.smem} B shared memory")
    return f"float32 FMA on the CUDA cores, {plan.smem} B shared memory"


def _padded_bound(plan, n_out, k, peak) -> str:
    """The bound of the work the tensor-core kernel really multiplies: K = k * kr."""
    if plan.route == "fma":
        return ""
    return (f"; bound of the padded work (K = {k * plan.kr}) "
            f"{2.0 * n_out * k * plan.kr / peak * 1e3:.4f} ms")


# The ICN trainer's stem conv (batch 8, 256^2 reflect-padded by 3, 21 -> 64), the
# three cases of tests/test_layers.py:222-224 (O = 12 among them), a ragged tile, the
# largest shape the conv gate admits (k = 9, C = 32; the bf16 weights are staged a
# kernel row at a time), and output widths that are no multiple of 8 (two channel
# tiles; an odd O).
K3_STEM = (8, 262, 262, 21, 7, 64)
K3_CASES = ((2, 22, 26, 21, 7, 16), (1, 19, 20, 3, 3, 8), (2, 38, 34, 6, 5, 12),
            (1, 41, 30, 21, 7, 64), (1, 40, 45, 32, 9, 64), (2, 30, 33, 16, 8, 100),
            (3, 50, 37, 21, 7, 13))


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
    from future_urban_scene_generation_tpu_torch.ops import _kernels, cuda_conv

    # The launch's shared-memory size as the Python plan states it and as the library
    # computes it, over every shape checked here.
    lib = _kernels.load()
    for shape in (K3_STEM,) + K3_CASES:
        for code, dtype in enumerate((torch.float32, torch.bfloat16)):
            want = lib.fusg_conv_smem_bytes(code, *shape[3:])
            if cuda_conv.conv_plan(dtype, *shape[3:]).smem != want:
                raise AssertionError(f"conv_plan disagrees with the library at {shape[3:]}")

    worst = {}
    for entry in ("conv_small_cin_v2", "conv_small_cin"):
        fn = getattr(cuda_conv, entry)
        for i, shape in enumerate((K3_STEM,) + K3_CASES):
            x, kern = _small_cin_inputs(shape, device, torch.float32, seed=20 + i)
            _poison_shared_memory(fn, (x, kern))
            got = fn(x, kern)
            ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
            torch.cuda.synchronize()
            err32, tol32, _ = _conv_errors(got, ref)
            x, kern = x.bfloat16(), kern.bfloat16()
            _poison_shared_memory(fn, (x, kern))
            got = fn(x, kern)
            ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
            torch.cuda.synchronize()
            err16, _, ratio16 = _conv_errors(got, ref)
            ok = err32 <= tol32 and ratio16 <= 1.0 and got.dtype == torch.bfloat16
            log(f"k3[{entry} {shape}]: f32 max abs err {err32:.3e} (tol {tol32:.3e}); bf16 max "
                f"abs err {err16:.3e}, worst ratio to its bound {ratio16:.3f}; each after a "
                f"NaN launch -> {'ok' if ok else 'FAIL'}")
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
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        times[dtype] += bound_ms(nbytes(x, kern, out), 2.0 * out.numel() * kern[..., 0].numel(),
                                 peak)
        t = times[dtype]
        plan = cuda_conv.conv_plan(dtype, *K3_STEM[3:])
        log(f"k3 time at the training stem {K3_STEM} ({dtype}): K3 {t[0]:.3f} ms, "
            f"K4 entry {t[1]:.3f} ms ({_product(plan)}); plain version (F.conv2d in f32) "
            f"{t[2]:.3f} ms; library call (F.conv2d in {dtype}) {t[3]:.3f} ms; bound "
            f"{t[4]:.4f} ms by {t[5]}" + _padded_bound(plan, out.numel(), K3_STEM[4], peak))
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


# Full-width training configurations of the three single-network families:
# (cli.train --model, batch, the bar on float32 card-vs-CPU gradients or None).
TRAIN_FAMILIES = (("vunet", 4, 5e-2), ("hourglass", 4, None), ("cad", 8, 5e-2))


def _bn_backward_check(device):
    """The hourglass's train-mode batch norm (channels_last input: the NHWC tensor's
    ``permute`` view) differentiated on the card against float64 on the CPU and
    against the same ``F.batch_norm`` on an NCHW-contiguous copy on the card."""
    import torch.nn.functional as F

    from future_urban_scene_generation_tpu_torch.models.hourglass import BatchNorm2d

    gen = torch.Generator().manual_seed(9)
    x = torch.randn(4, 64, 64, 128, generator=gen, dtype=torch.float64) * 2.0 + 0.5
    gy = torch.randn(4, 64, 64, 128, generator=gen, dtype=torch.float64)
    w = torch.rand(128, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(128, generator=gen, dtype=torch.float64)
    grads = {}
    for label, dev, dtype in (("cpu64", "cpu", torch.float64), ("card", device, torch.float32),
                              ("card nchw", device, torch.float32)):
        bn = BatchNorm2d(128).to(dev, dtype).train()
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xx = x.to(dev, dtype).requires_grad_()
        if label == "card nchw":
            xc = xx.permute(0, 3, 1, 2).contiguous()
            y = F.batch_norm(xc, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
            y = y.permute(0, 2, 3, 1)
        else:
            y = bn(xx)
        g = torch.autograd.grad(y, (xx, bn.weight, bn.bias), gy.to(dev, dtype))
        grads[label] = [t.double().cpu() for t in g] + [y.detach().double().cpu()]
    rel = {}
    for label in ("card", "card nchw"):
        rel[label] = max(((a - r).abs().max() / r.abs().max()).item()
                         for a, r in zip(grads[label], grads["cpu64"]))
    log(f"train[batch norm backward]: train-mode NHWC batch norm, output and gradients (x, "
        f"weight, bias), card f32 vs CPU f64, worst max|diff| / max|ref|: channels_last view "
        f"{rel['card']:.3e}, NCHW copy {rel['card nchw']:.3e} (tol 1e-4)")
    if not rel["card"] <= 1e-4:
        raise AssertionError("the batch norm's channels_last backward is wrong on the card")


def _family_on_both(model, batch, dtype, device):
    """One train step of a family from the same seeded weights on the same batch (made
    on the card, full width, 256^2), on the CPU and on the card, in ``dtype``. The
    VUNet's noise comes from a CPU generator on both. Returns {device: (loss,
    {name: gradient or None})} and the names of the biases that feed a batch norm."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train

    trainer, _, make_batch = cli_train.family_setup(model, seed=0, batch=batch, lr=1e-4,
                                                    image_size=256, device=device)
    args = make_batch()
    out, fed = {}, set()
    for dev in ("cpu", device):
        state = trainer.init(torch.Generator().manual_seed(5), device=dev)
        state.module.to(dtype)
        moved = []
        for a in args:
            if isinstance(a, torch.Generator):
                a = torch.Generator().manual_seed(6)
            elif a.is_floating_point():
                a = a.to(dev, dtype)
            else:
                a = a.to(dev)
            moved.append(a)
        _, metrics = trainer.train_step(state, *moved)
        named = dict(state.module.named_parameters())
        out[dev] = (float(metrics["loss"]),
                    {n: None if p.grad is None else p.grad.double().cpu()
                     for n, p in named.items()})
        if model == "hourglass":
            fed = {n for n in named if n.endswith(".bias") and not n.startswith("score.")
                   and named[n[: -len("bias")] + "weight"].dim() == 4}
    return out, fed


def _family_gpu_vs_cpu(model, batch, f32_tol, device):
    """Card against CPU for one family, at the ICN step's bars: float32 loss rtol
    1e-3 and gradients by relative L2 per tensor (``f32_tol``; None: reported only,
    where float32 itself is that far from float64 on one device), float64 loss rtol
    1e-6 and gradients atol 1e-6 * max|g|. Biases that feed a batch norm (zero in
    exact arithmetic) are held near zero against their conv's weight gradient."""
    bad = []
    for dtype, loss_tol, tol, metric in ((torch.float32, 1e-3, f32_tol, 1),
                                         (torch.float64, 1e-6, 1e-6, 0)):
        res, fed = _family_on_both(model, batch, dtype, device)
        (lc, gc), (lg, gg) = res["cpu"], res[device]
        if not abs(lg - lc) <= loss_tol * abs(lc):
            bad.append(f"{dtype} loss")
        worst = [0.0, 0.0]
        for n, r in gc.items():
            g = gg[n]
            if r is None or g is None:
                if not (r is None and g is None):
                    bad.append(f"{dtype} {n}: reached on one device only")
                continue
            if n in fed:
                scale = gc[n[: -len("bias")] + "weight"].abs().max()
                if not max(g.abs().max(), r.abs().max()) <= 1e-4 * scale:
                    bad.append(f"{dtype} {n}: a batch-norm-fed bias with a gradient")
                continue
            d = (((g - r).abs().max() / r.abs().max()).item(), ((g - r).norm() / r.norm()).item())
            worst = [max(worst[0], d[0]), max(worst[1], d[1])]
            if tol is not None and not d[metric] <= tol:
                bad.append(f"{dtype} {n}: {d[metric]:.3e}")
        log(f"train[{model} gpu_vs_cpu {dtype}]: batch 2, loss cpu {lc:.6f} gpu {lg:.6f} (rtol "
            f"{loss_tol:g}); gradients, worst max|diff| / max|g| {worst[0]:.3e}, worst relative "
            f"L2 {worst[1]:.3e} (tol {tol} on {('max|diff| / max|g|', 'relative L2')[metric]})")
    if bad:
        raise AssertionError(f"{model} step on the GPU disagrees with the CPU: {bad[:8]}")


def _train_family(model, batch, f32_tol, device, card):
    """One of the VUNet, hourglass and CAD-classifier trainers at full width on the
    card: ``cli.train`` for 2 steps and a resume to 3, a fixed-batch loop (one
    warm-up, 5 steps by CUDA events, peak memory), the batch maker's time, and one
    step card against CPU. Returns K1's launches in the CLI run (datagen)."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train
    from future_urban_scene_generation_tpu_torch.ops import cuda_raster

    out = os.path.join(OUT_DIR, f"train_{model}")
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--model", model, "--batch", str(batch), "--device", device, "--out", out,
            "--log-interval", "1", "--save-interval", "2"]
    cuda_raster.LAUNCHES = 0
    t0 = time.perf_counter()
    cli_train.main(argv + ["--steps", "2"])
    cli_train.main(argv + ["--steps", "3", "--resume"])
    torch.cuda.synchronize()
    secs, k1 = time.perf_counter() - t0, cuda_raster.LAUNCHES
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    size = os.path.getsize(os.path.join(out, "checkpoint.pt")) / 2 ** 20
    shutil.rmtree(out)  # the checkpoint (the classifier's: 1.6 GiB) stays on the machine
    log(f"train[{model} cli]: 2 steps, then --resume to 3, in {secs:.2f} s (cold); losses "
        f"{[round(r['loss'], 5) for r in recs]}; checkpoint {size:.0f} MiB; K1 launches "
        f"(datagen) {k1}")
    if ([r["step"] for r in recs] != [0, 1, 2] or k1 != 3
            or not all(math.isfinite(r["loss"]) for r in recs)):
        raise AssertionError(f"train[{model} cli]: steps {recs}, K1 launches {k1}")

    trainer, state, make_batch = cli_train.family_setup(model, seed=0, batch=batch, lr=1e-4,
                                                        image_size=256, device=device)
    args = make_batch()
    dg_ms = cuda_ms(make_batch, iters=3, warmup=1)
    trainer.train_step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, losses = [], []
    for _ in range(5):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, metrics = trainer.train_step(state, *args)
        ev[1].record()
        events.append(ev)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in events]
    losses = [float(v) for v in losses]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train[{model}]: batch {batch} at 256^2, float32, step times "
        f"{[round(t, 2) for t in times]} ms; median {med:.2f} ms = {batch * 1000.0 / med:.2f} "
        f"samples/s; peak memory {peak:.3f} GiB; datagen {dg_ms:.2f} ms per batch; loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f} on one fixed batch ({card})")
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train[{model}]: the loss does not fall on a fixed batch: {losses}")
    del state, args
    torch.cuda.empty_cache()
    _family_gpu_vs_cpu(model, 2, f32_tol, device)
    return k1


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
    del sample
    torch.cuda.empty_cache()
    _bn_backward_check(device)
    for model, batch, f32_tol in TRAIN_FAMILIES:
        _train_family(model, batch, f32_tol, device, card)
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
    # The port's own kernels are launched through ctypes, outside any aten operator:
    # their device rows carry the kernels' names.
    tags = ("conv_wgmma_kernel", "conv_mma_kernel", "conv_fma_kernel", "raster_setup_kernel",
            "raster_tiles_kernel")
    own = [(tag, e) for e in rows for tag in tags
           if e.device_type == DeviceType.CUDA and tag in e.key]
    log("profile: the port's kernels in that scene (device ms x launches): " + (", ".join(
        f"{tag} {e.self_device_time_total / 1e3:.3f} x {e.count}" for tag, e in own)
        or "none traced"))
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
STREAM_DEPTHS = (1, 2)
MULTI_FRAMES = 8  # frames a camera in the multi phase
MULTI_CONFIGS = ((1, False), (2, False), (2, True), (4, True))  # (cameras, threaded)


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


def _service(device, ctx):
    """The phases' one ``SceneService`` on the written directory (720x1280, seeded
    full-width networks, the service's own spec), built once."""
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig
    from future_urban_scene_generation_tpu_torch.pipeline import service

    _serving_setup(device, ctx)
    if "service" not in ctx:
        root = ctx["root"]
        cfg = PipelineConfig(
            video_dir=ctx["video_dir"], kpoints_dir=os.path.join(root, "no_kpoints"),
            checkpoints_dir=os.path.join(root, "no_ckpts"), device=device,
            output_dir=os.path.join(root, "results_service"))
        cfg.runtime.frame_hw = SERVE_HW
        t0 = time.perf_counter()
        ctx["service"] = service.SceneService(cfg)
        log(f"serve: SceneService built in {time.perf_counter() - t0:.2f} s (seeded full-width "
            f"networks, {ctx['service'].num_cads} procedural CAD, spec {ctx['service'].spec})")
    return ctx["service"]


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

    svc = _service(device, ctx)
    cfg = svc.cfg
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
    from future_urban_scene_generation_tpu_torch.pipeline import runner, service, streaming
    from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk

    svc = _service(device, ctx)
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
    del scenes

    # The pending detection is read through its own event: with other work in flight
    # behind it (here ~0.3 s of float32 products), ``finalize`` returns at once. A
    # read enqueued on the stream at finalize time would wait for all of it.
    for frame in frames_u8[:3]:
        tracker.submit_frame(frame, background=bg_u8)
    torch.cuda.synchronize()
    a = torch.rand(8192, 8192, device=device)
    one = cuda_ms(lambda: a @ a, iters=2)
    seen = []
    real = detector.finalize

    def probed(handle):
        t0 = time.perf_counter()
        out = real(handle)
        seen.append((busy.query(), time.perf_counter() - t0))
        return out

    detector.finalize = probed
    for _ in range(max(1, int(300.0 / one))):
        a @ a
    busy = torch.cuda.Event()
    busy.record()
    tracker.submit_frame(frames_u8[3], background=bg_u8)
    detector.finalize = real
    tracker.flush()
    torch.cuda.synchronize()
    log(f"stream[finalize]: with {int(300.0 / one)} products of {one:.1f} ms in flight, finalize "
        f"of the pending detection returned in {seen[0][1] * 1e3:.2f} ms, the work behind it "
        f"{'done' if seen[0][0] else 'still running'}")
    if len(seen) != 1 or seen[0][0]:
        raise AssertionError("stream: finalize waited for work enqueued after its detection")


def phase_multi(device, card, ctx):
    """``MultiStreamRunner`` at 720x1280, V=4, the service's spec, 8 frames a camera
    (every camera sees the written frames, through its own detector and tracker), for
    each of MULTI_CONFIGS: finite frames, the single camera's scene count on every
    camera, one K1 and one K2 launch a scene. Prints the strict aggregate (all
    cameras' frames over one wall clock), the sum over per-camera windows, and each
    camera's latency. Returns the launches of the 2-camera threaded run."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import streaming
    from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk

    svc = _service(device, ctx)
    frames_u8, bg_u8 = ctx["frames"][:MULTI_FRAMES], ctx["background"]
    bg_d = streaming.StreamRunner._upload(bg_u8, device)
    single = kept = None
    for n, threaded in MULTI_CONFIGS:
        counts, finite = [0] * n, [True] * n

        def consume(i, r):
            counts[i] += 1
            finite[i] &= bool(torch.isfinite(r.frames_icn).all()
                              and torch.isfinite(r.frames_vunet).all())

        multi = streaming.MultiStreamRunner(
            svc.models, svc.cad_bank, svc.intrinsic, SERVE_HW, n_vehicles=len(SERVE_IDS),
            n_streams=n, make_detector=lambda i: trk.BackgroundDiffDetector(bg_d),
            inv_homographies=[svc.inv_homography] * n, threaded=threaded,
            on_result=consume if threaded else None,
            spec=svc.spec, vis_res=svc.cfg.runtime.vis_res, depth=2)
        cuda_raster.LAUNCHES = cuda_conv.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            for frame in frames_u8:
                for i in range(n):
                    out, _ = multi.submit_frame(i, frame, background=bg_u8)
                    if out is not None:
                        consume(i, out)
            for i, tail in enumerate(multi.flush()):
                for r in tail:
                    consume(i, r)
        finally:
            multi.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
        lat = []
        for s in multi.streams:
            ls = sorted(s.latencies)
            p90 = ls[int(0.9 * (len(ls) - 1))]
            lat.append(f"{statistics.median(ls) * 1e3:.0f}/{p90 * 1e3:.0f}")
        label = f"{n} cameras, {'threaded' if threaded else 'one thread'}"
        log(f"multi[{label}]: depth {multi.streams[0].depth}, scenes per camera {counts}, "
            f"{sum(counts)} scenes in {wall:.2f} s; aggregate {multi.aggregate_fps:.2f} composited "
            f"frames/s by one wall clock, {multi.aggregate_fps_per_stream_windows:.2f} as the sum "
            f"over per-camera windows; latency p50/p90 ms per camera {lat}; launches {launches} "
            f"({card})")
        if single is None:
            single = counts[0]
        if counts != [single] * n or not all(finite) or single <= 0:
            raise AssertionError(f"multi[{label}]: scenes per camera {counts} (one camera alone: "
                                 f"{single}), finite {finite}")
        if launches != {"raster": sum(counts), "icn_stem_conv": sum(counts)}:
            raise AssertionError(f"multi[{label}]: {launches} launches for {sum(counts)} scenes")
        if (n, threaded) == (2, True):
            kept = launches
    return kept


def phase_warmup(card):
    """``cli.warmup`` as a deploy runs it: a fresh process, the service's resolution,
    the perception path. Prints what it prints."""
    argv = [sys.executable, "-m", "future_urban_scene_generation_tpu_torch.cli.warmup",
            "--frame-hw", *(str(n) for n in SERVE_HW), "--vehicles", "4", "--perception"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT, timeout=600,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    secs = time.perf_counter() - t0
    said = proc.stdout.strip().splitlines()
    log(f"warmup: exit {proc.returncode} in {secs:.2f} s (process start to end); it said: {said} "
        f"({card})")
    if (proc.returncode != 0 or not any(ln.startswith("BUILD_SECONDS=") for ln in said)
            or not any(ln.startswith("warmed V=4 (720x1280") and "run_scene" in ln
                       for ln in said)):
        raise AssertionError(f"warmup failed: {proc.stderr[-2000:]}")


def phase_web(device, card, ctx):
    """The web GUI's server over the phases' service, in a thread, asked over a local
    socket: the page, the boxes, an annotated frame, RUN with the four ids, a result.
    The result is held to a direct ``run_request`` under the serve phase's limits."""
    import contextlib
    import io
    import threading
    import urllib.request

    from future_urban_scene_generation_tpu_torch.gui import web
    from future_urban_scene_generation_tpu_torch.utils.native import decode_png, read_png

    svc = _service(device, ctx)
    with contextlib.redirect_stdout(io.StringIO()):
        direct = [read_png(p) for p in svc.run_request(1, list(SERVE_IDS))]
    server = web.make_server(svc.cfg, port=0, service=svc)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    took = {}

    def ask(name, path, data=None):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data is not None else "GET")
        with contextlib.redirect_stdout(io.StringIO()):
            with urllib.request.urlopen(req, timeout=120) as resp:
                body = resp.read()
        took[name] = time.perf_counter() - t0
        return body

    try:
        page = ask("page", "/").decode()
        boxes = json.loads(ask("boxes", "/boxes/1"))
        plain = decode_png(ask("frame", "/frame/1.png"))
        ids = ",".join(str(i) for i in SERVE_IDS)
        drawn = decode_png(ask("annotated frame", f"/frame/1.png?preview={SERVE_IDS[0]}"
                                                   f"&selected={ids}"))
        body = json.dumps({"frame_id": 1, "ids": list(SERVE_IDS)}).encode()
        outputs = json.loads(ask("run", "/run", body))["outputs"]
        results = [decode_png(ask(f"result {i}", f"/results/{i}.png")) for i in (0, 11)]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    if "RUN" not in page or "TPU" in page or {b["id"] for b in boxes} != set(SERVE_IDS):
        raise AssertionError(f"web: page or boxes wrong: {boxes}")
    green = int((drawn == (0, 255, 0)).all(-1).sum())
    yellow = int((drawn == (255, 255, 0)).all(-1).sum())
    if plain.shape != (*SERVE_HW, 3) or green < 1000 or yellow < 10:
        raise AssertionError(f"web: the annotated frame shows {green} green and {yellow} "
                             "yellow pixels")
    worst = (0.0, 0)
    for got, want in zip(results, (direct[0], direct[11])):
        share, step = _pixels_differ(got, want)
        worst = (max(worst[0], share), max(worst[1], step))
    log(f"web: request seconds {({k: round(v, 3) for k, v in took.items()})}; {len(outputs)} "
        f"outputs; selected boxes {green} px, preview track {yellow} px; results 0 and 11 against "
        f"a direct run_request: share of samples that differ {worst[0]:.2e} (budget "
        f"{EQUAL_SHARE:g}), largest step {worst[1]} (budget {EQUAL_STEP}) ({card})")
    if len(outputs) != 12 or worst[0] > EQUAL_SHARE or worst[1] > EQUAL_STEP:
        raise AssertionError("web: /run's results differ from a direct request's")
    shutil.rmtree(svc.cfg.output_dir, ignore_errors=True)


def _drop_serving_data(ctx):
    if "service" in ctx:
        ctx["service"].close()
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
        if "multi" in phases:
            log(f"multi: launches on this slice's path (2 cameras, threaded): "
                f"{phase_multi(device, smi, serving)}")
        if "web" in phases:
            phase_web(device, smi, serving)
    finally:
        _drop_serving_data(serving)  # ~130 MB of frames and results stay on the machine
    if "warmup" in phases:
        phase_warmup(smi)
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
