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
step on the card against the CPU, the train-mode batch norm's backward). The inpaint
and maskrcnn phases drive the inpaint branch: ``cli.run_test --inpaint`` with the
background-difference segmenter and with ``--segmenter maskrcnn``, from seeded
full-width EdgeConnect and Mask R-CNN files in the reference's layouts (written, and
read back, with PyYAML blocked), two N1 calls a frame, and ``TrackingStreamRunner``
with ``MaskRCNNDetector``. The n1 phase holds kernel N1 (Mask R-CNN's NMS: every
segment of a call in one launch, one cluster a segment) against its plain version at
the RPN's five-segment call, presorted input with -1 scores, 1 to 4,096 boxes (the
global-scratch route above 1,024), all scores invalid and fewer outputs than kept
boxes, and checks one device kernel a call. The train_ec phase
trains EdgeConnect's edge and inpainting models at full width through ``cli.train``
(batch 4, 256^2, a resume, ``--vgg-weights``), times them, holds one step on the card
against the CPU, and serves the runs back through ``cli/export_zoo`` and the zoo
loader; no kernel of the port is on that path. The int8 phase drives the int8 serving
tier (``ModelSpec.quantized_convs``): kernel N2 (wgmma, transposed convs as phase
convs) against its plain version bit for bit at every conv shape the quantized bench
scene and the quantized erase run (plus every instantiation of its plan and an
all-+127 case), kernel N3 (the quantization) against the torch composition on the
card and the CPU, one device kernel an N3 call (profiler), N2's times beside
``torch._int_mm`` and cuDNN's bf16 conv as yardsticks, N3's beside the torch
composition and a copy of its input, the device-time split of one quantized ICN
forward (N2, N3, the rest), the JAX package's quality bars at full width, then
``run_scene`` on the bench scene with the tier on. The parallel phase, in a fresh
process, joins an NCCL group of one rank a card (one rank on one card), builds the
(data, model=1) mesh and holds ``run_scene_sharded`` on the bench scene against
``run_scene`` (its profile must show K1's two kernels and K2), ``StreamRunner(mesh=)``
against the unsharded runner over 4 frames and the full-width ICN step placed on the
mesh against the unsharded step, times both pairs alternately, and holds K3 at the
stem's output-channel slice of a model=2 rank against its plain version. The aot phase
drives ahead-of-time scene programs (pipeline/aot.py, ``torch.export`` with the kernels as
``fusg::`` operators) as a deploy uses them, each step in a fresh process:
``cli.warmup --export-aot`` at the serve phase's shape and the service's spec, a restart
that must find the artifact, holds the restored scene to the live ``run_scene`` (atol
2e-5), counts the graph's ``fusg::`` nodes and the kernels' launches a restored scene and
times the restart's parts, then the same on the int8 tier; and the dispatcher's cost a
``fusg::`` call.

    python3 chip_smoke.py                    # every phase, one GPU
    python3 chip_smoke.py --phases k3,train  # a subset (device and build always run)
    python3 chip_smoke.py --phases int8      # the int8 tier, kernels N2 and N3, alone
    python3 chip_smoke.py --phases parallel  # the 1-rank NCCL mesh: sharded scene, stream
                                             # runner and ICN step (a fresh process)
    python3 chip_smoke.py --split DIR        # only where the device time goes for the port
                                             # under DIR (an earlier commit, or .): one N1
                                             # and one N3 call, N3 over a quantized scene,
                                             # the quantized ICN forward
    python3 chip_smoke.py --phases aot       # ahead-of-time scene programs: export, restarts
    python3 chip_smoke.py --scene-times DIR  # only the bench scene's times (serving spec and
                                             # int8 tier) for the port package under DIR
    python3 chip_smoke.py --profile          # also profile one scene and one EdgeConnect step each

The pnp phase holds kernel P1 (``csrc/pnp.cu``, the scene's whole CPC pose solve in one
launch; no TPU kernel: the JAX package's LM loop runs in XLA) to the plain solve bit for
bit: the card's cases of tests/test_torch_pnp_kernel.py, the keypoints of a 720x1280
scene at V = 4 and 16, two launches bit-equal; times it beside the plain solve and counts
the device kernels of the scene's pose span.

The plane_warp phase holds kernel W1 (``csrc/plane_warp.cu``, the scene's plane warp past
its homographies in one or two launches; no TPU kernel: the JAX package warps in XLA) to
the plain warp: the card's
cases of tests/test_torch_plane_warp_kernel.py, the warps of the scene cells' kind of
scene and of datagen's batch (the largest difference, the share of texels that
differ); times it and the plain warp by CUDA events beside the bytes
bound and each one's host enqueue, counts the device kernels of a served scene's warp
span, and lists the calls of that scene that still make the host wait for the card.

The k1 phase holds K1 and K1' (two CUDA launches a call: triangle setup, tiles) at
every shape against their plain versions after a launch on all-NaN inputs: the setup
kernel's table bit for bit, the tile kernel's per-tile counts, images and masks; a
profiled call must show those two kernels on the device and nothing else.

Kernel launches in the ``kernels`` line, each counted over its own path with the
counters set to 0 just before: K1, K2 and P1 from the main phase's scenes, N2 and N3 from
the int8 phase's quantized scenes, K3 from the train phase's CLI run, K1' from the
demo, N1 from the maskrcnn phase's CLI request (its record from the n1 phase) (N1, N2,
N3 and P1 port no TPU kernel: the JAX package's NMS is a ``lax.scan``, its int8 conv an
XLA convolution with XLA's quantization ops around it, its PnP a ``lax.while_loop``);
K4's entry has no caller on any path.
``bound_ms`` is the larger of bytes over 3.35 TB/s and operations over the card's
peak for the kernel's type (the H100 SXM's published 67 TFLOP/s float32, 989 TFLOP/s
bf16, 1,979 TOP/s int8), from this run's inputs (the raster's operations are counted from the bboxes of
the triangles it is given, by brute force); ``library_ms`` is one PyTorch call computing the same
function, timed here and used nowhere in the port.

Any failure raises and exits non-zero. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels' record.
Longer output (compiler report, profile) goes to ``chiprun_out/``.
"""
import argparse
import contextlib
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
ALL_PHASES = ("k1", "k2", "k3", "pnp", "plane_warp", "gpu_vs_cpu", "main", "int8", "train",
              "demo", "n1",
              "serve", "stream", "multi", "warmup", "aot", "web", "inpaint", "maskrcnn",
              "train_ec", "parallel")
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
            for tag in ("conv_int8_wgmma_kernel", "quant_int8_kernel"):
                if tag in name:  # N2 <N, output type>, N3 <input type, V>
                    ints = re.findall(r"Li(\d+)E", name)
                    kind = "bf16" if "bfloat16" in name else "f32"
                    name = f"{tag}<{','.join(ints[:1] + [kind] + ints[1:])}>"
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
            elif "HMMA." in line or "HGMMA." in line or "IMMA." in line or "IGMMA." in line:
                kind = ("wgmma (HGMMA)" if "HGMMA." in line else
                        "int8 wgmma (IGMMA)" if "IGMMA." in line else
                        "int8 mma.sync (IMMA)" if "IMMA." in line else "mma.sync (HMMA)")
                counts[(fn, kind)] = counts.get((fn, kind), 0) + 1
        for (fn, kind), n in sorted(counts.items()):
            log(f"  sass: {kind} x {n} in {fn[:60]}")
        found = (len({fn for fn, kind in counts if "conv_mma_kernel" in fn and "HMMA" in kind}),
                 len({fn for fn, kind in counts if "conv_wgmma_kernel" in fn and "HGMMA" in kind}))
        if found != (4, 2):
            raise AssertionError(f"{found} of the (4 mma.sync, 2 wgmma) bf16 conv kernels hold "
                                 "their tensor-core instructions")
        # N2: every instantiation (N = 64, 128, 256 x float32, bf16 out) on the warpgroup
        # int8 MMA; int8_plan keeps no mma.sync route.
        n_int8 = len({fn for fn, kind in counts
                      if "conv_int8_wgmma_kernel" in fn and "IGMMA" in kind})
        if n_int8 != 6 or any("IMMA" in kind for _, kind in counts):
            raise AssertionError(f"{n_int8} of the 6 int8 conv kernels (N2) hold IGMMA, or an "
                                 "int8 mma.sync (IMMA) is left")
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
            weight = name[: -len("bias")] + "weight"
            scale = ref.get(weight, ref.get(weight + "_orig")).abs().max()
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
    from future_urban_scene_generation_tpu_torch.geometry import pnp
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
    from future_urban_scene_generation_tpu_torch.render import plane_warp
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
    pnp.LAUNCHES = 0
    plane_warp.LAUNCHES = 0
    times, res = [], None
    for _ in range(MAIN_SCENES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES,
                "pnp_cpc": pnp.LAUNCHES, "plane_warp": plane_warp.LAUNCHES}
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


# int8 serving tier (kernels N3 and N2). Bars of the JAX package's
# tests/test_int8_inference.py: ICN (bf16 + int8) and EdgeConnect's inpaint generator
# against their own float32 > 27 dB.
INT8_PSNR_BAR = 27.0
PEAK_INT8 = 1979e12  # the H100 SXM's published dense int8 tensor-core rate, operations/s
INT8_ERASE_HW = (720, 1280)


def _record_int8_shapes(fn):
    """Runs ``fn`` with the tier's conv entry (``cuda_conv.conv_int8_quantized``: N3 then
    N2) recording each distinct call: returns {(x shape, w shape, out dtype, geometry):
    count}; the geometry holds ``flip`` (a transposed conv's kernel)."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    seen, inner = {}, cuda_conv.conv_int8_quantized

    def recording(x, w_hwio, out_dtype, **geom):
        key = (tuple(x.shape), tuple(w_hwio.shape), out_dtype, tuple(sorted(geom.items())))
        seen[key] = seen.get(key, 0) + 1
        return inner(x, w_hwio, out_dtype, **geom)

    cuda_conv.conv_int8_quantized = recording
    try:
        fn()
    finally:
        cuda_conv.conv_int8_quantized = inner
    return seen


def _conv_geom(key):
    """N2's geometry of a recorded call (``flip`` is N3's)."""
    return {k: v for k, v in key[3] if k != "flip"}


def _int8_work(key):
    """(operations, bytes) one N2 launch at ``key`` needs: 2 multiply-adds a useful tap
    (a transposed conv's holes of input dilation are no work), each code and scale read
    once, the output written once."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    (n, h, w, c), (k, _, _, o), out_dtype, _ = key
    g = _conv_geom(key)
    ho, wo = cuda_conv.int8_out_hw(h, w, k, g.get("stride", 1), g.get("pad_lo", 0),
                                   g.get("pad_hi", 0), g.get("dilation", 1),
                                   g.get("in_dilation", 1))
    if g.get("in_dilation", 1) > 1:
        ops = 2.0 * n * h * w * c * o * k * k
    else:
        ops = 2.0 * n * ho * wo * o * k * k * c
    out_bytes = n * ho * wo * o * (4 if out_dtype == torch.float32 else 2)
    return ops, n * h * w * c + k * k * c * o + 4 * o + out_bytes


def _int8_codes(key, device, gen, fill=None):
    (n, h, w, c), (k, _, _, o), out_dtype, _ = key
    if fill is not None:
        xq = torch.full((n, h, w, c), fill, dtype=torch.int8, device=device)
        wq = torch.full((k, k, c, o), fill, dtype=torch.int8, device=device)
    else:
        xq = torch.randint(-127, 128, (n, h, w, c), generator=gen, device=device,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (k, k, c, o), generator=gen, device=device,
                           dtype=torch.int8)
    sw = torch.rand(o, generator=gen, device=device) * 1e-3 + 1e-5
    return xq, wq, sw, out_dtype, _conv_geom(key)


def _int8_kernel_checks(shapes, device, report):
    """N2 against its plain version (float64 on the codes, exact) on the card, bit for
    bit, at every recorded shape (after a launch on other codes), then the transposed
    and dilation-2 forms if the paths had none, every ``int8_plan`` instantiation (N 64,
    128, 256 x float32, bfloat16 out) the paths missed, then all codes +127. One line a
    case goes to ``report``. Returns the largest |kernel - plain| over the cases."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device=device).manual_seed(5)
    cases = [(key, None) for key in shapes]
    geoms = [_conv_geom(key) for key in shapes]
    if not any(g.get("in_dilation", 1) > 1 for g in geoms):
        cases.append((((2, 33, 37, 64), (4, 4, 64, 48), torch.float32,
                       (("in_dilation", 2), ("pad_hi", 2), ("pad_lo", 2))), None))
    if not any(g.get("dilation", 1) > 1 for g in geoms):
        cases.append((((2, 40, 36, 96), (3, 3, 96, 80), torch.bfloat16,
                       (("dilation", 2), ("pad_hi", 2), ("pad_lo", 2))), None))
    seen = {(cuda_conv.int8_plan(key[0][3], key[1][0], key[1][3]).bn, key[2])
            for key, _ in cases}
    for bn, o in ((64, 48), (128, 96), (256, 300)):
        for dt in (torch.float32, torch.bfloat16):
            if (bn, dt) not in seen:
                cases.append((((2, 9, 11, 64), (3, 3, 64, o), dt,
                               (("pad_hi", 1), ("pad_lo", 1))), None))
    cases.append((((2, 24, 24, 256), (5, 5, 256, 64), torch.float32,
                   (("pad_hi", 2), ("pad_lo", 2))), 127))
    max_err = 0.0
    for key, fill in cases:
        xq, wq, sw, dt, geom = _int8_codes(key, device, gen, fill)
        cuda_conv.conv_int8(-xq, wq.flip(0), sw, dt, **geom)  # other codes first
        got = cuda_conv.conv_int8(xq, wq, sw, dt, **geom)
        want = cuda_conv.conv_int8_plain(xq, wq, sw, dt, **geom)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max())
        max_err = max(max_err, err)
        k, c = key[1][0], key[0][3]
        plan = cuda_conv.int8_plan(c, k, key[1][3], geom.get("in_dilation", 1))
        report.append(f"int8[N2 {key[0]} * {key[1]} -> {dt}, {geom}, N {plan.bn}, "
                      f"{plan.phases} phase(s) of {plan.taps}^2 taps"
                      + (f", all codes +127: interior sums 127^2 * {k * k * c} = "
                         f"{127 * 127 * k * k * c}" if fill else "")
                      + f"]: equal to the plain version bit for bit: {ok}, max |diff| {err!r}")
        if not ok:
            raise AssertionError(f"kernel N2 disagrees with its plain version at {key}")
    log(f"int8: N2 equal to its plain version bit for bit at all {len(cases)} cases (the "
        "paths' shapes, the phase-packed up stages and the per-phase transposed convs "
        "among them, every int8_plan instantiation, all codes +127), each after a launch "
        f"on other codes; max |kernel - plain| {max_err!r}")
    return max_err


def _int8_plan_check(shapes):
    """``cuda_conv.int8_plan`` against the C plan N2 and N3 run (``fusg_int8_plan``)."""
    import ctypes

    from future_urban_scene_generation_tpu_torch.ops import _kernels, cuda_conv

    lib = _kernels.load()
    for key in shapes:
        c, k, o, s = key[0][3], key[1][0], key[1][3], _conv_geom(key).get("in_dilation", 1)
        out = (ctypes.c_int * 9)()
        lib.fusg_int8_plan(c, k, o, s, out)
        if tuple(out) != tuple(cuda_conv.int8_plan(c, k, o, s)):
            raise AssertionError(f"int8_plan {cuda_conv.int8_plan(c, k, o, s)} != the kernel's "
                                 f"{tuple(out)} at {key}")
    log(f"int8: int8_plan equal to the kernels' plan at all {len(shapes)} shapes")


def _n3_inputs(key, device, gen):
    """A float activation and weight for a recorded call: the weight as the layer hands
    it, a view (a transposed conv's (in, out, kh, kw) tensor permuted, read flipped)."""
    (n, h, w, c), (k, _, _, o), dt, _ = key
    x = (torch.randn((n, h, w, c), generator=gen) * 3).to(dt)
    if dict(key[3]).get("flip"):
        w_raw = (torch.randn((c, o, k, k), generator=gen) * 0.05).to(dt)
        return x, w_raw.permute(2, 3, 0, 1)
    w_raw = (torch.randn((o, c, k, k), generator=gen) * 0.05).to(dt)
    return x, w_raw.permute(2, 3, 1, 0)


def _n3_checks(shapes, device, report):
    """N3 on the card against its plain version (``quantize_int8_plain`` + packing) on
    the card, bit for bit (x codes, weight image, sw), at every recorded shape, and
    against the CPU's at the three largest. Returns the largest |kernel - plain| over
    codes and scales."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    gen = torch.Generator().manual_seed(24)
    largest = sorted(shapes, key=lambda key: -math.prod(key[0]))[:3]
    max_err = 0.0
    for key in shapes:
        x, w = _n3_inputs(key, device, gen)
        g = dict(key[3])
        kw = dict(in_dilation=g.get("in_dilation", 1), pad_lo=g.get("pad_lo", 0))
        flip = bool(g.get("flip"))
        xd, wd = x.to(device), w.to(device)
        got = cuda_conv.quantize_int8_packed(xd, wd, flip=flip, **kw)
        want = cuda_conv.quantize_int8_packed_plain(xd, wd.flip(0, 1) if flip else wd, **kw)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
        max_err = max(max_err, err)
        cpu = None
        if key in largest:
            ref = cuda_conv.quantize_int8_packed_plain(x, w.flip(0, 1) if flip else w, **kw)
            cpu = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
        report.append(f"int8[N3 {key[0]} * {key[1]} {key[2]} {g}]: (x codes, weight image, "
                      f"sw) equal to the plain version on the card: {same}; to the CPU's: "
                      f"{'not checked' if cpu is None else cpu}")
        if not all(same) or cpu is False:
            raise AssertionError(f"kernel N3 disagrees with its plain version at {key}")
    log(f"int8: N3 equal to its plain version bit for bit at all {len(shapes)} shapes (x "
        "codes, weight image, sw; the weight read through the layer's view, flipped for "
        "the transposed convs), and to the CPU's at the three largest; max |kernel - plain| "
        f"{max_err!r}")
    return max_err


def _int8_times(key, device, card, report):
    """N2 alone (operands packed beforehand), its plain version, and two yardsticks the
    port never calls: the int8 GEMM alone (``torch._int_mm`` on an im2col built
    beforehand; plain convs) and cuDNN's bf16 convolution of the same shapes
    (``F.conv_transpose2d`` for a transposed conv). Then N3 and the torch composition
    it replaces at the call's activation and weight, with N3's bytes bound."""
    import torch.nn.functional as F

    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    gen = torch.Generator(device=device).manual_seed(6)
    xq, wq, sw, dt, geom = _int8_codes(key, device, gen)
    (n, h, w, c), (k, _, _, o) = key[0], key[1]
    s, p, stride = geom.get("in_dilation", 1), geom.get("pad_lo", 0), geom.get("stride", 1)
    ho, wo = cuda_conv.int8_out_hw(h, w, k, stride, p, geom.get("pad_hi", 0),
                                   geom.get("dilation", 1), s)
    xq_p = F.pad(xq, (0, cuda_conv.int8_plan(c, k, o, s).cp - c)).contiguous()
    img = cuda_conv.pack_int8_image(wq, s, p)
    ms = cuda_ms(lambda: cuda_conv._launch_conv_int8(xq_p, img, sw, dt, c, k, ho, wo, stride, p,
                                                     geom.get("dilation", 1), s),
                 iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: cuda_conv.conv_int8_plain(xq, wq, sw, dt, **geom), iters=3)
    ops, n_bytes = _int8_work(key)
    bound, by = bound_ms(n_bytes, ops, PEAK_INT8)
    xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    mm_ms = None
    if s == 1:
        # im2col in int8, rows (n, oy, ox), columns (ky, kx, c): the HWIO weight's order.
        d = geom.get("dilation", 1)
        kd = (k - 1) * d + 1
        patches = F.pad(xq, (0, 0, p, p, p, p)).unfold(1, kd, stride).unfold(2, kd, stride)
        a = patches[..., ::d, ::d].permute(0, 1, 2, 4, 5, 3).reshape(-1, k * k * c).contiguous()
        b_col = wq.reshape(k * k * c, o).t().contiguous().t()
        mm_ms = cuda_ms(lambda: torch._int_mm(a, b_col), iters=10, warmup=2)
        wb = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bf16_ms = cuda_ms(lambda: F.conv2d(xb, wb, padding=p, stride=stride,
                                           dilation=geom.get("dilation", 1)),
                          iters=10, warmup=2)
    else:  # the transposed conv's weight (in, out, kh, kw), unflipped; padding k - 1 - lo
        wt = wq.flip(0, 1).permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()
        bf16_ms = cuda_ms(lambda: F.conv_transpose2d(xb, wt, stride=s, padding=k - 1 - p),
                          iters=10, warmup=2)
    x, wgt = _n3_inputs(key, device, torch.Generator().manual_seed(7))
    x, wgt = x.to(device), wgt.to(device)
    flip = bool(dict(key[3]).get("flip"))
    n3_ms = cuda_ms(lambda: cuda_conv.quantize_int8_packed(x, wgt, flip=flip, in_dilation=s,
                                                           pad_lo=p), iters=10, warmup=2)
    kernel = wgt.flip(0, 1) if flip else wgt
    n3_plain_ms = cuda_ms(lambda: cuda_conv.quantize_int8_packed_plain(
        x, kernel, in_dilation=s, pad_lo=p), iters=3)
    plan = cuda_conv.int8_plan(c, k, o, s)
    n3_bytes = (nbytes(x, wgt) + n * h * w * plan.cp + img.numel() + 4 * o)
    n3_bound, n3_by = bound_ms(n3_bytes, 0, PEAK_INT8)
    line = (f"int8 time at {key[0]} * {key[1]} -> {dt} {geom}: N2 {ms:.4f} ms; plain "
            f"version (float64 conv on the codes) {plain_ms:.3f} ms; bound {bound:.4f} ms by "
            f"{by} ({ops:.3e} int8 operations at 1,979 TOP/s); yardsticks: torch._int_mm on a "
            f"prebuilt im2col " + (f"{mm_ms:.4f} ms" if mm_ms is not None else "n/a (transposed)")
            + f", cuDNN bf16 {'F.conv2d' if s == 1 else 'F.conv_transpose2d'} {bf16_ms:.4f} ms. "
            f"N3 {n3_ms:.4f} ms against the torch composition {n3_plain_ms:.4f} ms, bound "
            f"{n3_bound:.4f} ms by {n3_by} ({n3_bytes / 1e6:.1f} MB) ({card})")
    (log if n == 24 or s > 1 else report.append)(line)  # the ICN's and transposed on the log
    return dict(ms=ms, plain_ms=plain_ms, bound=bound, by=by, mm_ms=mm_ms, bf16_ms=bf16_ms,
                n3_ms=n3_ms, n3_plain_ms=n3_plain_ms, n3_bound=n3_bound, n3_by=n3_by)


def _n3_one_launch(key, device, calls=5):
    """Profiled calls of N3 at ``key``: raises unless the device ran ``quant_int8_kernel``
    at most once a call and nothing else (no memset, no copy; the tracer may drop a
    kernel's record, so fewer than ``calls`` records pass, none does not). Returns its
    device ms a call, over the records traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    x, w = _n3_inputs(key, device, torch.Generator().manual_seed(8))
    x, w = x.to(device), w.to(device)
    g = dict(key[3])
    kw = dict(flip=bool(g.get("flip")), in_dilation=g.get("in_dilation", 1),
              pad_lo=g.get("pad_lo", 0))
    cuda_conv.quantize_int8_packed(x, w, **kw)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cuda_conv.quantize_int8_packed(x, w, **kw)
        torch.cuda.synchronize()
    rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ours = [e for e in rows if "quant_int8_kernel" in e.name]
    others = sorted({e.name for e in rows if "quant_int8_kernel" not in e.name})
    log(f"int8: N3 at {key[0]} * {key[1]}: {calls} profiled calls ran {len(ours)} device "
        f"kernel records of quant_int8_kernel and {others or 'nothing else'} (no memset, no "
        f"copy)")
    if not 0 < len(ours) <= calls or others:
        raise AssertionError(f"int8: an N3 call must be one device kernel: {len(ours)} in "
                             f"{calls} calls, others {others}")
    return sum(e.time_range.elapsed_us() for e in ours) / 1e3 / len(ours)


N3_TRUNK = ((24, 66, 66, 256), (3, 3, 256, 256), torch.bfloat16, ())  # the ICN trunk's conv


def launch_checks(device="cuda"):
    """One device kernel a call, and its device time: N1 on 1,000 presorted boxes and on
    the RPN's five segments (nothing but ``nms_kernel`` on the device), N3 at the ICN
    trunk's activation (``_n3_one_launch``), each under the profiler. Run in a fresh
    process: late in a long run the profiler drops kernel records."""
    from future_urban_scene_generation_tpu_torch.ops import detection

    gen = torch.Generator().manual_seed(3)
    out = {}
    b = torch.cat([_n1_boxes(k, gen, 1024.0) for k in N1_RPN_SEGMENTS]).to(device)
    sc = torch.cat([_n1_rpn_scores(k, gen, device) for k in N1_RPN_SEGMENTS])
    n = N1_RPN_SEGMENTS[0]
    for name, args in (("n1_ms", (b[:n], sc[:n], [n], 0.7, -0.5, [n])),
                       ("n1_rpn_ms", (b, sc, N1_RPN_SEGMENTS, 0.7, -0.5, N1_RPN_SEGMENTS))):
        rows = _n1_device_rows(lambda a=args: detection.nms_sorted_segments(*a))
        log(f"launch check, N1 {name}: device rows of 10 calls (records, ms a record) {rows}")
        if len(rows) != 1 or "nms_kernel" not in next(iter(rows)) or \
                not 0 < next(iter(rows.values()))[0] <= 10:
            raise AssertionError(f"N1: a presorted call must run one device kernel "
                                 f"(nms_kernel) and nothing else: {rows}")
        out[name] = next(iter(rows.values()))[1]
    out["n3_ms"] = _n3_one_launch(N3_TRUNK, device)
    return out


def phase_launch_checks(card):
    """``launch_checks`` in a fresh process of this script; returns its results."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--launch-checks"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    for line in res.stdout.splitlines()[:-1]:
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"launch checks failed ({res.returncode}):\n{res.stderr[-3000:]}")
    out = json.loads(res.stdout.splitlines()[-1])
    log(f"launch checks (fresh process): one device kernel a call for N1 and N3; device ms "
        f"{out} ({card})")
    return out


def icn_int8_split(device="cuda", n=24, hw=256):
    """Device time of one quantized ICN forward at the scene's batch (N=24, 256^2,
    bf16 generators + the int8 tier), by kernel: N2 (kernels named ``conv_int8``), the
    quantization (N3's ``quant_int8_kernel``, or the earlier two-kernel N3's ``amax_kernel`` /
    ``codes_kernel``,
    or, on a tree without N3,
    the device time under ``layers.quantize_int8`` and ``cuda_conv.pack_int8_weights``)
    and the rest; with the forward's CUDA-event time, the bf16 forward's, and launches.
    Runs on whichever port package is first on ``sys.path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from future_urban_scene_generation_tpu_torch.models import layers
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv
    from future_urban_scene_generation_tpu_torch.pipeline import stages
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC
    from future_urban_scene_generation_tpu_torch.utils import profiling

    spec_q = SERVING_SPEC.replace(quantized_convs=True)
    models = stages.Models.build(SERVING_SPEC, torch.Generator().manual_seed(0), device=device)
    rng = np.random.RandomState(11)
    f = lambda a: torch.as_tensor(np.float32(a), device=device)  # noqa: E731
    sk, ce, pl = f(rng.rand(n, hw, hw, 3)), f(rng.rand(n // 6, hw, hw, 3) * 2 - 1), \
        f(rng.rand(n, 5, hw, hw, 3) * 2 - 1)

    def forward(spec):
        return stages.icn_synthesize_batch(models, spec, sk, ce, pl, s_repeat=6)

    patched = []
    for mod, name in ((layers, "quantize_int8"), (cuda_conv, "pack_int8_weights")):
        fn = getattr(mod, name, None)
        if fn is not None:
            def ranged(*a, _fn=fn, **kw):
                with profiling.trace("fusg.int8_quantize"):
                    return _fn(*a, **kw)
            patched.append((mod, name, fn))
            setattr(mod, name, ranged)
    try:
        forward(spec_q)
        times = {name: cuda_ms(lambda s=s: forward(s), iters=5)
                 for name, s in (("bf16", SERVING_SPEC), ("bf16 + int8", spec_q))}
        n2_before = cuda_conv.INT8_LAUNCHES
        n3_before = getattr(cuda_conv, "QUANT_LAUNCHES", 0)
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward(spec_q)
            torch.cuda.synchronize()
        launches = (cuda_conv.INT8_LAUNCHES - n2_before,
                    getattr(cuda_conv, "QUANT_LAUNCHES", 0) - n3_before)
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    events = prof.events()
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3) for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("fusg.")]
    total = sum(t for _, t in kernels)
    n2 = sum(t for name, t in kernels if "conv_int8" in name)
    n3 = sum(t for name, t in kernels
             if any(tag in name for tag in ("quant_int8_kernel", "amax_kernel", "codes_kernel")))
    torch_quant = sum(e.device_time_total for e in events
                      if e.name == "fusg.int8_quantize" and e.device_type == DeviceType.CPU) / 1e3
    quant = n3 + torch_quant
    memsets = [e for e in events if e.device_type == DeviceType.CUDA and "emset" in e.name]
    return dict(forward_ms=times, device_ms=total, n2_ms=n2, quant_ms=quant,
                quant_by="N3" if n3 > 0 else "torch ops", rest_ms=total - n2 - quant,
                n2_launches=launches[0], n3_launches=launches[1],
                memsets=len(memsets),
                memset_ms=sum(e.time_range.elapsed_us() for e in memsets) / 1e3)


def split_report(device="cuda"):
    """Where the device time goes, for the port package first on ``sys.path`` (this
    tree's, or an earlier one's for before / after in one call). N1: ``nms_static`` on
    1,000 boxes at the RPN's thresholds (and the presorted entry where the tree has it).
    N3 at three shapes of the quantized bench scene (the trunk conv, the smallest
    activation, the ICN's larger up stage), and again with the weight cut to 1x1xCx1
    (the x codes alone) and with x cut to one pixel (the weight rows alone). Each: the
    call by CUDA events over 20 back-to-back calls, one call's latency on the host's
    clock (synchronized), and every device row of 10 profiled calls by name, ms a call
    (launch gaps are the events' time less the rows'), and the time a call when the card
    paces 20 queued calls (``paced``: the gaps between kernels on the card included).
    Then N3's device time over one quantized bench scene: at each conv shape the scene
    quantizes, the device rows of 10 profiled calls a call (memsets included) and the
    paced time, times the scene's calls at that shape, summed. Last,
    ``icn_int8_split``."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, detection
    from future_urban_scene_generation_tpu_torch.pipeline import runner, synthetic
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    def paced(fn, calls=20):
        """ms a call with the card pacing the calls, gaps between kernels included: the
        host queues them behind a kernel that sleeps ~25 ms, then events time them."""
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        queued = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued > 0.01:
            raise AssertionError(f"split: queueing {calls} calls took {queued:.4f} s, so the "
                                 "card may have waited for the host")
        return start.elapsed_time(end) / calls

    def split(label, fn):
        fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, iters=20, warmup=2)
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3
        rows = _n1_device_rows(fn)
        listed = ", ".join(f"{k[:48]} x{n / 10:g} {t:.4f}" for k, (n, t) in
                           sorted(rows.items(), key=lambda kv: -kv[1][0] * kv[1][1]))
        log(f"split[{label}]: events {ms:.4f} ms a call, paced by the card {paced(fn):.4f} ms, "
            f"one synchronized call {host_ms:.4f} ms, device rows "
            f"{sum(n / 10 * t for n, t in rows.values()):.4f} ms a call (name, records a call, "
            f"ms a record): {listed}")

    gen = torch.Generator().manual_seed(3)
    boxes = _n1_boxes(N1_BOXES, gen).to(device)
    scores = _n1_rpn_scores(N1_BOXES, gen, device)
    split("N1 nms_static, 1,000 boxes", lambda: detection.nms_static(boxes, scores, 0.7, -0.5,
                                                                       N1_BOXES))
    if hasattr(detection, "nms_sorted_segments"):
        split("N1 presorted, 1,000 boxes", lambda: detection.nms_sorted_segments(
            boxes, scores, [N1_BOXES], 0.7, -0.5, [N1_BOXES]))

    spec_q = SERVING_SPEC.replace(quantized_convs=True)
    sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device, spec=spec_q)
    shapes = _record_int8_shapes(lambda: runner.run_scene(
        sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes, sc.meters, sc.intrinsic,
        spec=spec_q))
    del sc
    trunk = max(shapes, key=lambda k: (shapes[k], _int8_work(k)[0]))
    smallest = min(shapes, key=lambda k: math.prod(k[0]))
    # The ICN's up stages: 3x3 phase-packed convs to four phases of half the channels.
    up = max((k for k in shapes if k[0][0] == 24 and k[1][0] == 3 and k[1][3] == 2 * k[0][3]),
             key=lambda k: math.prod(k[0]))
    for name, key in (("trunk", trunk), ("smallest", smallest), ("up stage", up)):
        x, w = _n3_inputs(key, device, torch.Generator().manual_seed(7))
        x, w = x.to(device), w.to(device)
        g = dict(key[3])
        kw = dict(flip=bool(g.get("flip")), in_dilation=g.get("in_dilation", 1),
                  pad_lo=g.get("pad_lo", 0))
        x1, w1 = x[:1, :1, :1].contiguous(), w[:1, :1, :, :1]
        for part, args in (("call", (x, w, kw)), ("x codes alone", (x, w1, {})),
                           ("weight rows alone", (x1, w, kw))):
            split(f"N3 {name} {key[0]} * {key[1]} {key[2]} {g}: {part}",
                  lambda a=args: cuda_conv.quantize_int8_packed(a[0], a[1], **a[2]))
    total, small, total_paced, small_paced = 0.0, 0.0, 0.0, 0.0
    calls = sum(shapes.values())
    for key, count in sorted(shapes.items(), key=lambda kv: -math.prod(kv[0][0])):
        x, w = _n3_inputs(key, device, torch.Generator().manual_seed(7))
        x, w = x.to(device), w.to(device)
        g = dict(key[3])
        kw = dict(flip=bool(g.get("flip")), in_dilation=g.get("in_dilation", 1),
                  pad_lo=g.get("pad_lo", 0))
        for _ in range(3):  # the tracer may drop every record of a profile: profile again
            rows = _n1_device_rows(lambda: cuda_conv.quantize_int8_packed(x, w, **kw))
            if any(tag in name for name in rows
                   for tag in ("quant_int8_kernel", "amax_kernel", "codes_kernel")):
                break
        else:
            raise AssertionError(f"split: no N3 kernel record at {key} in three profiles")
        ms = sum(n / 10 * t for n, t in rows.values())
        ms_paced = paced(lambda: cuda_conv.quantize_int8_packed(x, w, **kw))
        total += count * ms
        total_paced += count * ms_paced
        if key[0][0] != 24:  # perception's convs (the ICN's run at the scene's batch, 24)
            small += count * ms
            small_paced += count * ms_paced
        log(f"split[N3 scene {key[0]} * {key[1]} {key[2]} {g}]: {count} calls x "
            f"{ms:.4f} ms on the device ({ms_paced:.4f} paced by the card)")
    log(f"split[N3 over one quantized scene]: {calls} calls, {total:.4f} ms on the device "
        f"({small:.4f} of it in the perception's convs, the rest the ICN's); paced by the "
        f"card, gaps between kernels included: {total_paced:.4f} ({small_paced:.4f})")
    log("split[ICN]: " + json.dumps(icn_int8_split(device)))


def phase_int8(device, card, launch):
    """The int8 serving tier: N2 against its plain version at every conv shape of the
    quantized bench scene and erase and at every instantiation, N3 against its plain
    version and the CPU, times, the ICN forward's split, the JAX package's quality bars
    at full width, then ``run_scene`` on the bench scene with ``quantized_convs``.
    Returns (the kernels line's records, launches)."""
    from future_urban_scene_generation_tpu_torch.models import edgeconnect, layers
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import inpaint, runner, stages, synthetic
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    spec_q = SERVING_SPEC.replace(quantized_convs=True)
    sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device, spec=spec_q)

    def run(spec):
        return runner.run_scene(sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes,
                                sc.meters, sc.intrinsic, spec=spec)

    # The shapes each path runs the tier at: the scene, and the erase of 4 vehicles on
    # 6 frames (EdgeConnect at full width, seeded).
    scene_shapes = _record_int8_shapes(lambda: run(spec_q))
    edge, inp = edgeconnect.build_generators(torch.Generator().manual_seed(21), device=device)
    h, w = INT8_ERASE_HW
    gen = torch.Generator().manual_seed(22)
    frames = torch.rand((6, h, w, 3), generator=gen).to(device)
    boxes = np.float32([[100 + 260 * v, 300, 300 + 260 * v, 460] for v in range(4)])
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    masks = torch.stack([(xx >= b[0] + 10) & (xx < b[2] - 10) & (yy >= b[1] + 10)
                         & (yy < b[3] - 10) for b in boxes]).to(device)
    masks = masks[None].expand(6, -1, -1, -1)
    def erase():
        with layers.quantized_convs():  # as the service erases under its spec
            inpaint.erase_vehicles(edge, inp, frames, boxes, masks)

    erase_shapes = _record_int8_shapes(erase)
    report = []
    for label, shapes in (("scene", scene_shapes), ("erase", erase_shapes)):
        log(f"int8: the quantized {label} runs the tier at {len(shapes)} shapes, "
            f"{sum(shapes.values())} convs (list in chiprun_out/int8.txt)")
        report += [f"{label}: {k[0]} * {k[1][0]}x{k[1][1]} -> {k[1][3]} {dict(k[3])} x{v}"
                   for k, v in shapes.items()]
    all_shapes = {**scene_shapes, **erase_shapes}
    _int8_plan_check(all_shapes)
    max_err = _int8_kernel_checks(all_shapes, device, report)
    n3_err = _n3_checks(all_shapes, device, report)

    # Times at each distinct shape of the scene and the erase; the kernels line takes
    # the trunk conv (the most launches).
    timed = {key: _int8_times(key, device, card, report) for key in all_shapes}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "int8.txt"), "w") as fh:
        fh.write("\n".join(report) + "\n")
    trunk = max(scene_shapes, key=lambda k: (scene_shapes[k], _int8_work(k)[0]))
    t = timed[trunk]
    n3_device = launch["n3_ms"]
    # Yardstick for N3's two passes over x: the card's practical rate on one copy of the
    # trunk activation (read once, written once), by CUDA events.
    xb = _n3_inputs(trunk, device, torch.Generator().manual_seed(9))[0].to(device)
    yb = torch.empty_like(xb)
    copy_ms = cuda_ms(lambda: yb.copy_(xb), iters=20, warmup=3)
    log(f"int8: yardstick: a copy of the trunk activation ({nbytes(xb) / 1e6:.1f} MB read, the "
        f"same written) {copy_ms:.4f} ms = {2 * nbytes(xb) / copy_ms / 1e9:.2f} TB/s; N3 reads "
        f"x twice and writes its codes once ({card})")
    del xb, yb
    log(f"int8: N3 at the trunk's activation {trunk[0]} {trunk[2]}: {t['n3_ms']:.4f} ms by CUDA "
        f"events, {n3_device:.4f} ms on the device (profiler), one launch a call (the earlier "
        f"design: 0.0990 ms in three device operations, a memset and two kernels); bound "
        f"{t['n3_bound']:.4f} ms by {t['n3_by']}: {100 * t['n3_bound'] / t['n3_ms']:.0f}% of it; "
        f"the torch composition {t['n3_plain_ms']:.4f} ms ({card})")
    for label, shapes in (("scene", scene_shapes), ("erase", erase_shapes)):
        per = {name: sum(timed[k][name] * shapes[k] for k in shapes)
               for name in ("ms", "bound", "n3_ms", "n3_bound")}
        log(f"int8: one quantized {label}: N2 {per['ms']:.3f} ms of kernel time against a "
            f"{per['bound']:.3f} ms bound, N3 {per['n3_ms']:.3f} ms against "
            f"{per['n3_bound']:.3f} ms, over {sum(shapes.values())} convs ({card})")

    split = icn_int8_split(device)
    log("int8: ICN forward (N=24, 256^2) split by device time: " + json.dumps(split)
        + f" ({card})")

    # The JAX package's quality bars at full width (tests/test_int8_inference.py).
    rng = np.random.RandomState(11)
    f = lambda a: torch.as_tensor(np.float32(a), device=device)  # noqa: E731
    sk, ce, pl = f(rng.rand(24, 256, 256, 3)), f(rng.rand(4, 256, 256, 3) * 2 - 1), \
        f(rng.rand(24, 5, 256, 256, 3) * 2 - 1)
    f32 = SERVING_SPEC.replace(generator_dtype="float32")
    icn_f = stages.icn_synthesize_batch(sc.models, f32, sk, ce, pl, s_repeat=6)
    icn_q = stages.icn_synthesize_batch(sc.models, spec_q, sk, ce, pl, s_repeat=6)
    icn_bf = stages.icn_synthesize_batch(sc.models, SERVING_SPEC, sk, ce, pl, s_repeat=6)
    p_icn = _psnr(icn_f, icn_q)
    ex = f(rng.rand(1, 256, 256, 4))
    with torch.no_grad():
        ec_f = inp(ex)
        with layers.quantized_convs():
            ec_q = inp(ex)
    p_ec = _psnr(ec_f, ec_q)
    masks4 = torch.as_tensor(rng.rand(4, 256, 256) > 0.5, device=device)
    win = stages.cr.Window(*(torch.full((4,), float(v), device=device)
                             for v in (100.0, 50.0, 256.0, 256.0)))
    vun = {}
    for spec in (f32, f32.replace(quantized_convs=True)):
        mu = stages.vunet_encode_appearance_batch(sc.models, spec, sc.frame, sk[::6], masks4, win)
        vun[spec.quantized_convs] = mu + [stages.vunet_decode_batch(
            sc.models, spec, sk, [m.repeat_interleave(6, 0) for m in mu])]
    vun_equal = all(torch.equal(a, b) for a, b in zip(vun[False], vun[True]))
    log(f"int8: quality at full width: ICN (N=24, 256^2) bf16 + int8 vs float32 "
        f"{p_icn:.2f} dB (bf16 alone {_psnr(icn_f, icn_bf):.2f}), EdgeConnect inpaint generator "
        f"(256^2) int8 vs float32 {p_ec:.2f} dB (bars > {INT8_PSNR_BAR}); VUNet float32 with "
        f"the knob on bit-equal: {vun_equal} ({card})")
    if not (p_icn > INT8_PSNR_BAR and p_ec > INT8_PSNR_BAR and vun_equal):
        raise AssertionError("int8: a quality bar of the JAX package's tests is not met")

    # The main path on the tier: run_scene on the bench scene with quantized_convs.
    t0 = time.perf_counter()
    run(spec_q)
    torch.cuda.synchronize()
    log(f"int8: first quantized scene after the checks {time.perf_counter() - t0:.2f} s")
    cuda_conv.INT8_LAUNCHES = cuda_conv.QUANT_LAUNCHES = cuda_conv.LAUNCHES = 0
    cuda_raster.LAUNCHES = 0
    times, res = [], None
    for _ in range(MAIN_SCENES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = run(spec_q)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = {"conv_int8": cuda_conv.INT8_LAUNCHES, "quant_int8": cuda_conv.QUANT_LAUNCHES,
                "raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES}
    for name, frames_out in (("icn", res.frames_icn), ("vunet", res.frames_vunet)):
        if tuple(frames_out.shape) != (6, 1080, 1920, 3) or not bool(
                torch.isfinite(frames_out).all()):
            raise AssertionError(f"int8: quantized scene output {name} malformed")
    if min(launches.values()) <= 0:
        raise AssertionError(f"int8: a kernel of the quantized scene never launched: {launches}")
    float_times = []
    for _ in range(MAIN_SCENES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(SERVING_SPEC)
        end.record()
        torch.cuda.synchronize()
        float_times.append(start.elapsed_time(end))
    med = statistics.median(times)
    log(f"int8: quantized bench scene times {[round(t, 2) for t in times]} ms, median "
        f"{med:.2f} ms = {12 * 1000.0 / med:.2f} composited 1080p frames/s (the same scene in "
        f"bf16 alone, same call: median {statistics.median(float_times):.2f} ms); launches a "
        f"scene: " + ", ".join(f"{k} {v / MAIN_SCENES:g}" for k, v in launches.items())
        + f"; frames finite ({card})")
    records = [
        dict(name="conv_int8", route="cuda",
             source="future_urban_scene_generation_tpu_torch/csrc/conv_int8.cu",
             replaces="none: not a TPU kernel port (the JAX _int8_conv / _int8_conv_transpose, "
                      "future_urban_scene_generation_tpu/models/layers.py:178, :218, run an "
                      "int8 conv in XLA)",
             max_abs_err=max_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound"],
             bound_by=t["by"], library_ms=None),
        dict(name="quant_int8", route="cuda",
             source="future_urban_scene_generation_tpu_torch/csrc/quant_int8.cu",
             replaces="none: not a TPU kernel port (the JAX _int8_conv's quantization, "
                      "future_urban_scene_generation_tpu/models/layers.py:197-205, XLA ops)",
             max_abs_err=n3_err, ms=t["n3_ms"], plain_ms=t["n3_plain_ms"],
             bound_ms=t["n3_bound"], bound_by=t["n3_by"], library_ms=None),
    ]
    log(f"int8: kernels line rows at the trunk conv {trunk[0]} * {trunk[1]}: no PyTorch call "
        f"computes an int8 convolution on CUDA or the tier's quantization (library_ms null; "
        f"yardsticks above)")
    return records, launches


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
            f"frames/s by one wall clock; latency p50/p90 ms per camera {lat}; launches {launches} "
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


AOT_V = 4  # vehicles of the aot phase's scenes (the serve phase's request)
AOT_VIS_RES = 192  # the service's and cli.warmup's default


def _fusg_nodes(module):
    """Counts of the ``fusg::`` operator nodes in a restored program's graph, and the
    graph's node count."""
    counts = {}
    for node in module.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("fusg."):
            op = name.split(".")[1]
            counts[op] = counts.get(op, 0) + 1
    return counts, len(module.graph.nodes)


def _dispatch_cost(device, calls=200):
    """The ``torch.library`` dispatcher's cost a call: each ``fusg::`` operator against
    its registered implementation called as a plain function, on the same small inputs:
    the host's clock over ``calls`` calls queued without a synchronization (the host's
    time a call; the card's work is the same on both sides). Returns {op: (us a call
    through the op, us direct)}, the lesser of two runs each."""
    from future_urban_scene_generation_tpu_torch.geometry import pnp
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    try:
        from future_urban_scene_generation_tpu_torch.render import plane_warp
    except ImportError:  # an earlier package (--scene-times DIR) may lack it
        plane_warp = None

    g = torch.Generator().manual_seed(9)
    screen = torch.rand(2, 3, 3, 64, generator=g) * 30.0
    screen[:, :, 2] += 1.0
    dev = lambda t: t.to(device)  # noqa: E731
    cases = {
        "rasterize_corners": (cuda_raster._rasterize_corners_op, cuda_raster._rasterize_corners_cuda,
                              (dev(screen), dev(torch.rand(2, 3, 3, 64, generator=g)), [16, 16],
                               None)),
        "icn_stem_conv": (cuda_conv._icn_stem_conv_op, cuda_conv._icn_stem_conv_cuda,
                          (dev(torch.rand(1, 16, 16, 3, generator=g)),
                           dev(torch.rand(1, 16, 16, 3, generator=g)),
                           dev(torch.rand(1, 5, 16, 16, 3, generator=g)),
                           dev(torch.rand(7, 7, 21, 64, generator=g)), 3, 1)),
        "conv_int8_quantized": (cuda_conv._conv_int8_quantized_op,
                                cuda_conv._conv_int8_quantized_cuda,
                                (dev(torch.randn(1, 8, 8, 32, generator=g)),
                                 dev(torch.randn(3, 3, 32, 32, generator=g)), torch.float32,
                                 False, 1, 1, 1, 1, 1)),
    }
    if hasattr(pnp, "_pnp_cpc_op"):  # an earlier package (--scene-times DIR) may lack it
        cases["pnp_cpc"] = (pnp._pnp_cpc_op, pnp._pnp_cpc_cuda,
                            (dev(torch.randn(4, 12, 3, generator=g)),
                             dev(torch.randn(4, 12, 2, generator=g)),
                             dev(torch.tensor([300.0, 300.0])), dev(torch.tensor([64.0, 48.0]))))
    if plane_warp is not None:
        one, two = torch.ones(1), torch.ones(2)
        cases["plane_warp"] = (plane_warp._plane_warp_op, plane_warp._plane_warp_cuda,
                               (dev(torch.rand(1, 16, 16, 3, generator=g)), *map(dev, (
                                   one * 0, one * 0, one * 16, one * 16,
                                   torch.rand(2, 5, 6, 2, generator=g) * 16,
                                   torch.rand(2, 5, 6, 2, generator=g) * 16,
                                   torch.ones(2, 5, dtype=torch.bool),
                                   torch.ones(2, 5, dtype=torch.bool),
                                   two * 0, two * 0, two * 16, two * 16,
                                   torch.zeros(2, dtype=torch.int64))), 256, 256, True))
    out = {}
    for name, (op, direct, args) in cases.items():
        times = {}
        for label, fn in (("op", op), ("direct", direct), ("direct", direct), ("op", op)):
            for _ in range(5):
                fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*args)
            host = time.perf_counter() - t0
            torch.cuda.synchronize()
            times.setdefault(label, []).append(host / calls * 1e6)
        out[name] = (min(times["op"]), min(times["direct"]))
    return out


def _aot_inputs(device, hw, v, steps):
    """``cli.warmup``'s seeded arguments of one bucket but the networks: (cad_bank,
    frame, background, bboxes, meters, intrinsic)."""
    from future_urban_scene_generation_tpu_torch.cli import warmup

    cad_bank, frame, background, intrinsic, k_mat = warmup.seeded_scene(hw, device)
    bboxes, _, meters = (torch.as_tensor(a).to(device) for a in warmup.bucket_inputs(
        v, steps, k_mat, cad_bank.keypoints3d[0].cpu()))
    return cad_bank, frame, background, bboxes, meters, intrinsic


def aot_export_int8(directory, device="cuda", hw=SERVE_HW, v=AOT_V, steps=6):
    """The aot phase's int8-tier export (``--aot-export-int8``, a fresh process beside
    the CLI's export): ``cli.warmup``'s arguments and networks, the service's spec with
    ``quantized_convs``. Returns the export's seconds, MB and file name."""
    from future_urban_scene_generation_tpu_torch.pipeline import aot, stages
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec

    spec = ModelSpec(quantized_convs=True)
    models = stages.Models.build(spec, torch.Generator().manual_seed(0), device=device)
    args = (models, *_aot_inputs(device, hw, v, steps))
    t0 = time.perf_counter()
    path = aot.export_run_scene(*args, spec=spec, vis_res=AOT_VIS_RES, directory=directory)
    return {"seconds": time.perf_counter() - t0, "mb": path.stat().st_size / 1e6,
            "name": path.name}


def aot_restart(directory, quantized: bool, t_spawn: float, device="cuda", hw=SERVE_HW,
                v=AOT_V, steps=6):
    """The aot phase's fresh process (``--aot-restart``): a restart as a service makes
    it, on the arguments ``cli.warmup`` exported (its seeded scene, the service's spec,
    ``quantized`` the int8 tier). Times each part on the wall clock around
    ``torch.cuda.synchronize()``: process start to the port imported (``t_spawn`` is the
    parent's clock at the spawn), the CUDA context, the kernel library (on disk), the
    networks' build, the artifact's lookup (``torch.export.load`` and ``.module()``),
    then two restored scenes and two live ``run_scene`` scenes. Holds the restored
    result to the live one (atol 2e-5, ``cad_idx`` equal), counts the graph's ``fusg::``
    nodes and the kernels' launches a scene on both paths. Returns the record."""
    from future_urban_scene_generation_tpu_torch.geometry import pnp
    from future_urban_scene_generation_tpu_torch.ops import _kernels, cuda_conv, cuda_raster
    from future_urban_scene_generation_tpu_torch.pipeline import aot, runner, stages
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec
    from future_urban_scene_generation_tpu_torch.render import plane_warp

    split = {"import": time.time() - t_spawn}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        split[name] = time.perf_counter() - t0
        return out

    timed("context", lambda: torch.zeros(1, device=device))
    if device == "cuda":
        timed("kernel_library", _kernels.load)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = ModelSpec(quantized_convs=quantized)  # the service's: config.model_spec()
    models = timed("models_build", lambda: stages.Models.build(
        spec, torch.Generator().manual_seed(0), device=device))
    args = (models, *_aot_inputs(device, hw, v, steps))
    run = timed("artifact_load", lambda: aot.lookup_run_scene(
        *args, spec=spec, vis_res=AOT_VIS_RES, directory=directory))
    if run is None:
        raise AssertionError(f"aot: no artifact for the {'int8' if quantized else 'service'} "
                             f"spec under {directory}: {os.listdir(directory)}")
    fusg, nodes = _fusg_nodes(run.module)

    def counters():
        return {"rasterize_corners": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES,
                "conv_int8": cuda_conv.INT8_LAUNCHES, "quant_int8": cuda_conv.QUANT_LAUNCHES,
                "pnp_cpc": pnp.LAUNCHES, "plane_warp": plane_warp.LAUNCHES}

    def live(*a):
        return runner.run_scene(*a, spec=spec, vis_res=AOT_VIS_RES)

    results, launches = {}, {}
    for label, fn in (("restored", run), ("live", live)):
        for i in (1, 2):
            before = counters()
            results[label] = timed(f"{label}_scene_{i}", lambda: fn(*args))
            launches.setdefault(label, []).append(
                {k: n - before[k] for k, n in counters().items()})
    got, want = results["restored"], results["live"]
    err = {f: float((a.float() - b.float()).abs().max()) for f, a, b in
           zip(runner.SceneResult._fields, got, want) if f != "cad_idx"}
    record = {"quantized": quantized, "split": split, "nodes": nodes, "fusg": fusg,
              "launches": launches, "max_abs_err": err,
              "cad_idx_equal": bool(torch.equal(got.cad_idx, want.cad_idx)),
              "shapes": [list(t.shape) for t in got]}
    return record


def _aot_spawn(*flags):
    """A fresh process of this script with the aot phase's ``flags``."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _aot_result(proc, what, timeout=900):
    """The JSON record on the last line of ``proc``'s output; raises if it failed."""
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"aot: {what} failed ({proc.returncode}):\n{err[-3000:]}")
    return json.loads(out.splitlines()[-1])


def _aot_restart(directory, quantized):
    flags = ["--aot-restart", directory, "--t-spawn", repr(time.time())]
    return _aot_spawn(*flags, *(["--aot-int8"] if quantized else []))


def _aot_restart_checked(proc, quantized, card):
    rec = _aot_result(proc, "the restart process")
    tier = "int8 tier" if quantized else "service spec"
    split = ", ".join(f"{k} {v:.3f}" for k, v in rec["split"].items())
    log(f"aot: restart ({tier}, V={AOT_V}, {SERVE_HW[0]}x{SERVE_HW[1]}): seconds {split} "
        f"({card})")
    log(f"aot: restored graph ({tier}): {rec['nodes']} nodes, fusg:: nodes {rec['fusg']}; "
        f"launches a scene restored {rec['launches']['restored']}, live "
        f"{rec['launches']['live']}; max abs err restored vs live {rec['max_abs_err']}, "
        f"cad_idx equal {rec['cad_idx_equal']}")
    if max(rec["max_abs_err"].values()) > 2e-5 or not rec["cad_idx_equal"]:
        raise AssertionError(f"aot: the restored scene ({tier}) differs from the live one")
    fusg = rec["fusg"]
    want = {"rasterize_corners": 1, "icn_stem_conv": 1, "pnp_cpc": 1, "plane_warp": 1}
    if quantized:
        want["conv_int8_quantized"] = fusg.get("conv_int8_quantized", 0)
        if want["conv_int8_quantized"] <= 0:
            raise AssertionError(f"aot: the int8 tier's graph holds no quantized conv: {fusg}")
    if fusg != want:
        raise AssertionError(f"aot: the restored graph's operators {fusg} are not {want}")
    n_int8 = fusg.get("conv_int8_quantized", 0)
    per_scene = {"rasterize_corners": 1, "icn_stem_conv": 1, "conv_int8": n_int8,
                 "quant_int8": n_int8, "pnp_cpc": 1, "plane_warp": 1}
    for label in ("restored", "live"):
        for got in rec["launches"][label]:
            if got != per_scene:
                raise AssertionError(f"aot: {label} scene launched {got}, not {per_scene}")
    return rec


def phase_aot(card):
    """Ahead-of-time scene programs (pipeline/aot.py) as a deploy uses them, each step in
    a fresh process: ``cli.warmup --export-aot`` at the serve phase's shape (720x1280,
    V=4, 6 steps) and the service's spec exports, restores and runs the artifact, while
    a second process exports the int8 tier (both trace on the host, one core each); a
    restart of each tier restores its artifact (a hit) and holds it to the live
    ``run_scene``, the int8 tier's beside the CLI's restore, the service spec's alone
    afterwards: its times of the restart's parts are the record. Also the dispatcher's
    cost a ``fusg::`` call. Returns the records."""
    directory = os.path.join(OUT_DIR, "aot_artifacts")
    shutil.rmtree(directory, ignore_errors=True)
    cost = _dispatch_cost("cuda")
    log("aot: dispatcher cost a call, host us through the op vs its implementation called "
        "directly (min of two runs of 200 queued calls): " + ", ".join(
            f"{k} {a:.1f} vs {b:.1f} (+{a - b:.1f})" for k, (a, b) in cost.items()) + f" ({card})")
    argv = [sys.executable, "-m", "future_urban_scene_generation_tpu_torch.cli.warmup",
            "--frame-hw", *(str(n) for n in SERVE_HW), "--vehicles", str(AOT_V),
            "--generator-dtype", "float32", "--warp-plane-res", "256", "--export-aot",
            directory]
    procs = []
    try:
        # The two exports trace side by side (one core each); the int8 tier's restart
        # starts when its artifact is there, beside the CLI's own restore; the service
        # spec's restart, whose split is the record, runs alone after both.
        procs.append(_aot_spawn("--aot-export-int8", directory))
        t0 = time.perf_counter()
        procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT)))
        int8_rec = _aot_result(procs[0], "the int8 tier's export")
        log(f"aot: int8 tier exported beside the CLI in {int8_rec['seconds']:.1f} s "
            f"({int8_rec['mb']:.1f} MB, {int8_rec['name']}) ({card})")
        procs.append(_aot_restart(directory, True))
        out, err = procs[1].communicate(timeout=900)
        secs = time.perf_counter() - t0
        said = out.strip().splitlines()
        log(f"aot: export process exit {procs[1].returncode} in {secs:.2f} s (process start "
            f"to end); it said: {said} ({card})")
        exported = [re.match(rf"exported V={AOT_V} AOT artifact (\S+) \(([\d.]+) MB\) in "
                             r"([\d.]+)s", ln) for ln in said]
        if (procs[1].returncode != 0 or len([m for m in exported if m]) != 1
                or not any(ln.startswith(f"restored V={AOT_V} AOT artifact") for ln in said)):
            raise AssertionError(f"aot: the export failed: {err[-2000:]}")
        int8 = _aot_restart_checked(procs[2], True, card)
        procs.append(_aot_restart(directory, False))
        service = _aot_restart_checked(procs[3], False, card)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(directory, ignore_errors=True)  # artifacts of tens of MB stay there
    return {"dispatch_us": cost, "service": service, "int8": int8, "int8_export": int8_rec}


def _direct_routes():
    """The scene's kernel wrappers and the PnP solve bound straight to the
    implementations registered under their ``fusg::`` operators (the ``torch.library``
    dispatcher skipped, as the wrappers called them before the operators existed):
    {(module, name): replacement}."""
    from future_urban_scene_generation_tpu_torch.geometry import pnp
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
    try:
        from future_urban_scene_generation_tpu_torch.render import plane_warp
    except ImportError:  # an earlier package (--scene-times DIR) may lack it
        plane_warp = None

    routes = {
        (cuda_raster, "rasterize_corners"): lambda screen, colors, out_hw, cull=None: (
            cuda_raster._rasterize_corners_cuda(screen, colors, list(out_hw), cull)),
        (cuda_conv, "icn_stem_conv"): lambda sketch, central, planes, kernel, pad=3, s_repeat=1: (
            cuda_conv._icn_stem_conv_cuda(sketch, central, planes, kernel, pad, s_repeat)),
        (cuda_conv, "conv_int8_quantized"): lambda x, w, out_dtype, *, flip=False, stride=1, pad_lo=0, pad_hi=0, dilation=1, in_dilation=1: (  # noqa: E501
            cuda_conv._conv_int8_quantized_cuda(x, w, out_dtype, flip, stride, pad_lo, pad_hi,
                                                dilation, in_dilation)),
    }
    if hasattr(pnp, "_pnp_cpc_cuda"):  # an earlier package (--scene-times DIR) may lack it
        routes[(pnp, "pnp_cpc")] = pnp._pnp_cpc_cuda
    if plane_warp is not None:
        routes[(plane_warp, "_plane_warp_op")] = plane_warp._plane_warp_cuda
    return routes


@contextlib.contextmanager
def _routed(direct: bool):
    """Inside the block, the scene reaches its kernels directly (``direct``) or through
    the ``fusg::`` operators (the wrappers as they are)."""
    routes = _direct_routes() if direct else {}
    saved = {key: getattr(*key) for key in routes}
    for (module, name), fn in routes.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for (module, name), fn in saved.items():
            setattr(module, name, fn)


def scene_times(device="cuda", scenes=3):
    """The main phase's bench scene (1080p, V=4, 6 steps, the serving spec) and the same
    scene on the int8 tier, ``scenes`` timed calls each after a cold one, by CUDA events,
    for the port package first on ``sys.path`` (this tree's, or an earlier one's). Where
    the package has the ``fusg::`` operators, the calls alternate between the operators
    and the kernels reached directly (``_routed``), ``scenes`` of each, in one process:
    the dispatcher's cost a scene. Returns {label: [ms, ...]}."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv
    from future_urban_scene_generation_tpu_torch.pipeline import runner, synthetic
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    has_ops = hasattr(cuda_conv, "_conv_int8_quantized_op")
    out = {}
    for label, spec in (("main", SERVING_SPEC),
                        ("int8", SERVING_SPEC.replace(quantized_convs=True))):
        sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device,
                                        spec=spec)

        def run():
            return runner.run_scene(sc.models, sc.cad_bank, sc.frame, sc.background,
                                    sc.bboxes, sc.meters, sc.intrinsic, spec=spec)

        run()
        if not has_ops:
            out[label] = [cuda_ms(run, iters=1, warmup=0) for _ in range(scenes)]
        else:
            routes = [False, True, True, False] * -(-scenes // 2)
            for direct in routes[:2 * scenes]:
                with _routed(direct):
                    out.setdefault(f"{label}_{'direct' if direct else 'ops'}", []).append(
                        cuda_ms(run, iters=1, warmup=0))
        del sc
    return out


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


# --- The inpaint branch (S7): EdgeConnect erase, Mask R-CNN, kernel N1 ---------------
EDGE_SIGMA = 2  # written into inpainting/config.yml, read back by cli.run_test (F3)
CANNY_BUDGET = 0.002  # tests/test_crop_canny_morph.py:166
GEN_TOL = 2e-3  # tests/test_edgeconnect.py:30
GPU_CPU_REL_L2 = 5e-2  # the standing GPU-vs-CPU bar (ROADMAP.md); float64 at 1e-6 max|ref|
MASKRCNN_INPUT_HW = (512, 1024)
MASKRCNN_FRAMES = 8  # TrackingStreamRunner frames with the Mask R-CNN detector
N1_BOXES = 1000
# The RPN's five levels at MASKRCNN_INPUT_HW: the top 1,000 anchors of each, of the
# 8 x 16 x 3 = 384 at stride 64.
N1_RPN_SEGMENTS = (1000, 1000, 1000, 1000, 384)


def _sn_triple(w: torch.Tensor, dim: int, gen: torch.Generator):
    """(weight_orig, weight_u, weight_v) whose spectral-norm fold is w / sigma, sigma =
    |W_mat^T u| (u random, v along W_mat^T u): a reference-layout checkpoint entry."""
    w_mat = w.movedim(dim, 0).reshape(w.shape[dim], -1)
    u = torch.randn(w.shape[dim], generator=gen, dtype=torch.float64)
    u /= u.norm()
    v = w_mat.double().T @ u
    v /= v.norm()
    return w, u.float(), v.float()


def _write_edgeconnect_zoo(ckpt):
    """Seeded full-width EdgeConnect generators in the reference's layout under
    ``ckpt/inpainting/``: the edge generator with spectral-norm (weight_orig, u, v)
    triples on every conv but the last, both wrapped as {"iteration", "generator"},
    and a config.yml with SIGMA (written as text; PyYAML is blocked in this process)."""
    from future_urban_scene_generation_tpu_torch.models import edgeconnect
    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint

    gen = torch.Generator().manual_seed(7)
    edge, inp = edgeconnect.build_generators(gen, device="cpu")
    for name, net in (("edge", edge), ("inpaint", inp)):
        sd = {}
        for key, val in net.state_dict().items():
            if name == "edge" and key.endswith(".weight") and val.dim() == 4 and (
                    key != "decoder.7.weight"):
                prefix = key[: -len("weight")]
                dim = 1 if key.startswith(("decoder.0.", "decoder.3.")) else 0
                (sd[prefix + "weight_orig"], sd[prefix + "weight_u"],
                 sd[prefix + "weight_v"]) = _sn_triple(val, dim, gen)
            else:
                sd[key] = val
        path = checkpoint.zoo_path(ckpt, name)
        os.makedirs(path.parent, exist_ok=True)
        torch.save({"iteration": 0, "generator": sd}, path)
    with open(os.path.join(ckpt, "inpainting", "config.yml"), "w") as f:
        f.write(f"MODE: 1             # edgeconnect/config.yml's keys\nMODEL: 3\n"
                f"SIGMA: {EDGE_SIGMA}            # Canny's sigma\nMAX_ITERS: 2e6\n")


def _write_maskrcnn_zoo(ckpt):
    """Seeded full-width Mask R-CNN (ResNet-50-FPN, 91 classes) as
    ``ckpt/maskrcnn/maskrcnn.pth`` = {"model": state dict} under torchvision's names,
    half of the FPN convs, the RPN head's conv and half the mask head under newer
    torchvision's Conv2dNormActivation names, and a config.yml sidecar. The class
    bias of COCO 3 (car) is raised so that random weights still detect "cars"."""
    from future_urban_scene_generation_tpu_torch.models.maskrcnn import MaskRCNN

    model = MaskRCNN.build(torch.Generator().manual_seed(11), device="cpu")
    sd = model.state_dict()
    sd["roi_heads.box_predictor.cls_score.bias"][3] = 6.0
    out = {}
    for k, v in sd.items():
        for i in (0, 2):
            for blk in ("inner_blocks", "layer_blocks"):
                k = k.replace(f"fpn.{blk}.{i}.", f"fpn.{blk}.{i}.0.")
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        for i in (1, 3):
            k = k.replace(f"mask_head.mask_fcn{i}.", f"mask_head.{i - 1}.0.")
        out[k] = v
    path = os.path.join(ckpt, "maskrcnn", "maskrcnn.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": out}, path)
    ih, iw = MASKRCNN_INPUT_HW
    with open(os.path.join(ckpt, "maskrcnn", "config.yml"), "w") as f:
        f.write(f"num_classes: 91\nlayers: [3, 4, 6, 3]\ninput_hw: [{ih}, {iw}]\n"
                f"classes: [3, 6, 8]   # car, bus, truck\nmin_iou: 0.05\n")


def _cli_request(device, ctx, ckpt, label, extra, card):
    """``cli.run_test`` with ``extra`` flags on the phases' directory: (exit code, PNG
    count, launches, seconds, output directory)."""
    import contextlib
    import io

    from future_urban_scene_generation_tpu_torch.cli import run_test
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster, detection

    out = os.path.join(ctx["root"], f"results_{label}")
    argv = [ctx["video_dir"], os.path.join(ctx["root"], "no_kpoints"), ckpt, *extra,
            "--select-ids", *(str(i) for i in SERVE_IDS), "--frame-id", "1", "--device", device,
            "--frame-hw", *(str(n) for n in SERVE_HW), "--output-dir", out]
    cuda_raster.LAUNCHES = cuda_conv.LAUNCHES = detection.NMS_LAUNCHES = 0
    said = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(said):
        rc = run_test.main(argv)
    secs = time.perf_counter() - t0
    launches = {"raster": cuda_raster.LAUNCHES, "icn_stem_conv": cuda_conv.LAUNCHES,
                "nms_segments": detection.NMS_LAUNCHES}
    n_png = sum(len(fs) for _, _, fs in os.walk(out))
    took = [ln for ln in said.getvalue().splitlines() if ln.startswith("Prediction of")]
    log(f"{label}[cli]: exit {rc} in {secs:.2f} s (service built and one request); the service "
        f"said: {took}; {n_png} PNGs; launches in the request {launches} ({card})")
    if rc != 0 or n_png != 12 or launches["raster"] != 1 or launches["icn_stem_conv"] != 1:
        raise AssertionError(f"{label}[cli]: rc {rc}, {n_png} PNGs, launches {launches}")
    return launches, out


def _inpaint_service(device, ctx, ckpt, segmenter):
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig
    from future_urban_scene_generation_tpu_torch.pipeline import service

    cfg = PipelineConfig(
        video_dir=ctx["video_dir"], kpoints_dir=os.path.join(ctx["root"], "no_kpoints"),
        checkpoints_dir=ckpt, device=device, inpaint=True, segmenter=segmenter,
        output_dir=os.path.join(ctx["root"], f"results_service_{segmenter}"))
    cfg.runtime.frame_hw = SERVE_HW
    cfg.load_edgeconnect_yaml()
    return service.SceneService(cfg)


def _request_parts(svc, device, label, card):
    """One warm request through ``svc``, its parts timed: host arguments with the
    segmenter and the erase (the background stack), upload + scene, readback, PNGs."""
    from future_urban_scene_generation_tpu_torch.pipeline import runner, service

    svc.request_arguments(1, list(SERVE_IDS))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame, background, bboxes, meters = svc.request_arguments(1, list(SERVE_IDS))
    torch.cuda.synchronize()
    t_args = time.perf_counter() - t0
    up = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    t0 = time.perf_counter()
    res = runner.run_scene(svc.models, svc.cad_bank, up(frame), background, up(bboxes),
                           up(meters), up(svc.intrinsic), spec=svc.spec,
                           vis_res=svc.cfg.runtime.vis_res)
    torch.cuda.synchronize()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    icn = service.frames_to_uint8(res.frames_icn).cpu().numpy()
    vun = service.frames_to_uint8(res.frames_vunet).cpu().numpy()
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    svc._write_outputs(1, icn, vun)
    t_png = time.perf_counter() - t0
    log(f"{label}: one warm request's parts: host arguments + segment + erase (6 frames "
        f"{SERVE_HW[0]}x{SERVE_HW[1]}, V=4) {t_args * 1e3:.1f} ms; upload + scene "
        f"{t_scene * 1e3:.1f} ms; readback {t_read * 1e3:.1f} ms; 12 PNGs {t_png * 1e3:.1f} ms "
        f"({card})")
    if not (bool(torch.isfinite(res.frames_icn).all()) and background.shape == (6, *SERVE_HW, 3)):
        raise AssertionError(f"{label}: non-finite frames or a background stack of shape "
                             f"{tuple(background.shape)}")
    return frame, background, bboxes


def _erased_only_in_windows(svc, background, bboxes, label):
    """The background stack differs from the future frames only inside the vehicles'
    context windows, and inside every window somewhere."""
    from future_urban_scene_generation_tpu_torch.pipeline import inpaint

    bg = background.cpu().numpy()
    inside = np.zeros(SERVE_HW, bool)
    for b in bboxes:
        if inpaint.window_is_empty(b, SERVE_HW):
            continue
        w = inpaint.context_window(torch.as_tensor(b), SERVE_HW)
        x0, y0 = int(w.x_start), int(w.y_start)
        inside[y0:y0 + int(w.h), x0:x0 + int(w.w)] = True
    changed_share = []
    for n in range(6):
        frame = svc.reader.read(1 + 2 * n)
        diff = np.abs(bg[n] - frame).max(-1) > 0
        if diff[~inside].any():
            raise AssertionError(f"{label}: step {n} changed pixels outside the context windows")
        changed_share.append(round(float(diff[inside].mean()), 3))
    log(f"{label}: background stack {bg.shape}: pixels changed only inside the context "
        f"windows; share changed inside, per step {changed_share}")
    if min(changed_share) <= 0:
        raise AssertionError(f"{label}: a step's windows were left unchanged")


def _erase_card_vs_cpu(svc, frame, background, bboxes, device, label):
    """One vehicle's erase on the card against the CPU: Canny maps, then the generators
    with the CPU's inputs (edge map included) handed to both."""
    import copy

    from future_urban_scene_generation_tpu_torch.models.detector import BackgroundDiffSegmenter
    from future_urban_scene_generation_tpu_torch.pipeline import inpaint

    frame_d = torch.as_tensor(frame).to(device)[None]
    bbox = torch.as_tensor(bboxes[0])
    seg = svc.segmenter or BackgroundDiffSegmenter(svc._static_background(), device=device)
    with torch.no_grad():
        if hasattr(seg, "masks_for_bboxes"):
            mask = seg.masks_for_bboxes(frame_d[0], bbox[None].to(device))[0][None]
        else:
            mask = seg.masks(frame_d, bbox[None].to(device))[:, 0]
    sigma = float(svc.cfg.edgeconnect.sigma)
    ins_card = inpaint.erase_inputs(frame_d, bbox, mask, sigma)
    ins_cpu = inpaint.erase_inputs(frame_d.cpu(), bbox, mask.cpu(), sigma)
    disagree = (ins_card.edge.cpu() != ins_cpu.edge).float().mean().item()
    nets_cpu = [copy.deepcopy(n).cpu() for n in svc.inpaint_models]
    to_dev = ins_cpu._replace(window=ins_cpu.window.map(lambda f: f.to(device)),
                              **{k: getattr(ins_cpu, k).to(device)
                                 for k in ("img", "mask", "gray", "edge")})
    got = inpaint.erase_from_inputs(*svc.inpaint_models, frame_d, to_dev)
    want = inpaint.erase_from_inputs(*nets_cpu, frame_d.cpu(), ins_cpu)
    err = (got.cpu() - want).abs().max().item()
    log(f"{label}: one vehicle's erase, card against CPU: Canny maps disagree on "
        f"{disagree:.2e} of the pixels (budget {CANNY_BUDGET}); the generators and paste with "
        f"the CPU's edge map handed to both: max abs {err:.2e} (tolerance {GEN_TOL}; mask "
        f"pixels {int(ins_cpu.mask.sum())})")
    if disagree >= CANNY_BUDGET or err >= GEN_TOL:
        raise AssertionError(f"{label}: the card's erase disagrees with the CPU's")


def phase_inpaint(device, card, ctx):
    """``cli.run_test --inpaint`` at 720x1280 with the four vehicles, EdgeConnect from
    a reference-layout zoo (seeded, full width: 8 blocks, 256^2 crops) and the
    background-difference segmenter; the request's parts; the stack against the
    frames; one erase on the card against the CPU; the erase's device time."""
    from future_urban_scene_generation_tpu_torch.models.detector import BackgroundDiffSegmenter
    from future_urban_scene_generation_tpu_torch.pipeline import inpaint

    sys.modules["yaml"] = None  # the inpaint branch reads its YAML without PyYAML (F7)
    _serving_setup(device, ctx)
    ckpt = os.path.join(ctx["root"], "ckpt_inpaint")
    _write_edgeconnect_zoo(ckpt)
    launches, out = _cli_request(device, ctx, ckpt, "inpaint", ["--inpaint"], card)
    shutil.rmtree(out)

    svc = _inpaint_service(device, ctx, ckpt, "background")
    if svc.cfg.edgeconnect.sigma != EDGE_SIGMA:
        raise AssertionError(f"inpaint: SIGMA {svc.cfg.edgeconnect.sigma} read from config.yml")
    frame, background, bboxes = _request_parts(svc, device, "inpaint", card)
    _erased_only_in_windows(svc, background, bboxes, "inpaint")
    _erase_card_vs_cpu(svc, frame, background, bboxes, device, "inpaint")

    frames_d = torch.as_tensor(np.stack([svc.reader.read(1 + 2 * n) for n in range(6)])).to(device)
    seg = BackgroundDiffSegmenter(svc._static_background(), device=device)
    with torch.no_grad():
        masks = seg.masks(frames_d, torch.as_tensor(bboxes).to(device))
    erase_ms = cuda_ms(lambda: inpaint.erase_vehicles(*svc.inpaint_models, frames_d, bboxes,
                                                      masks, sigma=float(EDGE_SIGMA)), iters=3)
    flop = 2 * 6 * 4 * sum(_conv_flop(n) for n in svc.inpaint_models)
    log(f"inpaint: erase of V=4 vehicles on 6 frames (8 generator calls of batch 6): "
        f"{erase_ms:.1f} ms by CUDA events; the generators' float32 work {flop / 1e12:.2f} TFLOP, "
        f"bound {flop / PEAK_F32 * 1e3:.1f} ms at the published 67 TFLOP/s ({card})")
    svc.close()
    shutil.rmtree(svc.cfg.output_dir, ignore_errors=True)
    shutil.rmtree(ckpt)
    log(f"inpaint: launches in the CLI's request: K1 {launches['raster']}, K2 "
        f"{launches['icn_stem_conv']}")


def _conv_flop(net) -> float:
    """Multiply-adds of one 256^2 pass of an EdgeConnect generator (convs only)."""
    from future_urban_scene_generation_tpu_torch.models import layers

    total, hw = 0.0, {"encoder.1": 256, "encoder.4": 128, "encoder.7": 64, "decoder.0": 64,
                      "decoder.3": 128, "decoder.7": 256}
    for name, m in net.named_modules():
        if isinstance(m, (layers.Conv2d, layers.ConvTranspose2d)):
            side = hw.get(name, 64)  # every middle block runs at 64^2
            total += side * side * m.weight.numel()
    return total


def _n1_boxes(n, gen, extent=800.0):
    """n xyxy boxes in an ``extent``-wide field, every fifth duplicated (tied overlaps)."""
    ctr = torch.rand(n, 2, generator=gen) * extent
    size = torch.rand(n, 2, generator=gen) * 120 + 8
    boxes = torch.cat([ctr - size / 2, ctr + size / 2], 1)
    boxes[1::5] = boxes[0::5][: boxes[1::5].shape[0]]
    return boxes


def _n1_rpn_scores(n, gen, device):
    """An RPN level's scores as ``maskrcnn._rpn_proposals`` makes them, on the card: the
    sigmoid of logits in stable descending order (repeated logits, and logits whose
    sigmoid rounds to 1: ties), -1 for a fifth of the boxes, wherever they fall."""
    logits = torch.round(torch.randn(n, generator=gen) * 40) / 10
    logits[torch.rand(n, generator=gen) < 0.1] = 20.0
    logits = torch.sort(logits, descending=True, stable=True).values.to(device)
    tiny = (torch.rand(n, generator=gen) < 0.2).to(device)
    return torch.where(tiny, torch.full_like(logits, -1.0), torch.sigmoid(logits))


def _n1_segments_case(label, boxes, scores, lens, iou, thr, max_outs):
    """One N1 call over presorted segments against the plain loop a segment (no sort),
    after a call on other thresholds (so that stale outputs would show). Returns the
    number of indices that differ."""
    from future_urban_scene_generation_tpu_torch.ops import detection

    detection.nms_sorted_segments(boxes, scores, lens, 0.0, -2.0, max_outs)
    got = detection.nms_sorted_segments(boxes, scores, lens, iou, thr, max_outs)
    want = [detection.nms_sorted_plain(b, sc, iou, thr, m)
            for b, sc, m in zip(boxes.split(lens), scores.split(lens), max_outs)]
    torch.cuda.synchronize()
    bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    kept = [int((w >= 0).sum()) for w in want]
    log(f"n1[{label}: segments {list(lens)}, iou {iou}, score > {thr}, max {list(max_outs)}]: "
        f"kept {kept}; indices equal to the plain loop's: {bad == 0}")
    return bad, got


def _n1_device_rows(fn, calls=10):
    """Device rows of ``calls`` profiled calls of ``fn``: {kernel name: (records, ms a
    record)} (the tracer may drop a record, so the time is over the records traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.self_device_time_total / 1e3 / max(e.count, 1))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _n1_check(device, card, launch):
    """Kernel N1 against its plain version on the card's tensors, indices equal in every
    case: ``nms_static`` (a sort, then one launch) on 1,000 boxes with tied scores and
    the -1 scores of invalid entries at the RPN's and the class NMS's thresholds; the
    presorted entry on the RPN's five segments (and each segment against ``nms_static``,
    which sorts: the RPN's -1 scores and sigmoid ties change no kept index), on single
    segments of 1, 63, 65 and 1,000 boxes, segments above 1,024 boxes (the mask in a
    global scratch), all scores invalid and fewer outputs than kept boxes. Then the times
    and the bound; ``launch`` holds the device times of ``launch_checks`` (a fresh
    process). The record's ``ms`` is the wrapper ``maskrcnn_infer`` calls
    (``nms_sorted_segments``) at 1,000 boxes."""
    from future_urban_scene_generation_tpu_torch.ops import _kernels, detection

    gen = torch.Generator().manual_seed(3)
    n = N1_BOXES
    boxes = _n1_boxes(n, gen)
    scores = torch.round(torch.rand(n, generator=gen) * 16) / 16
    scores[torch.rand(n, generator=gen) < 0.2] = -1.0
    boxes, scores = boxes.to(device), scores.to(device)
    mismatched = 0
    for iou, thr, max_out in ((0.7, -0.5, n), (0.5, -0.5, 100), (0.5, 0.3, 50)):
        got, _ = detection.nms_static(boxes, scores, iou, thr, max_out)
        want = detection.nms_plain(boxes, scores, iou, thr, max_out)
        torch.cuda.synchronize()
        mismatched += int((got != want).sum())
        log(f"n1[nms_static, {n} boxes, iou {iou}, score > {thr}, max {max_out}]: "
            f"{int((want >= 0).sum())} kept; indices equal to the plain version: "
            f"{bool(torch.equal(got, want))}")

    # The RPN's call: five presorted segments, and each against nms_static (it sorts).
    rpn_b = torch.cat([_n1_boxes(k, gen, 1024.0) for k in N1_RPN_SEGMENTS]).to(device)
    rpn_s = torch.cat([_n1_rpn_scores(k, gen, device) for k in N1_RPN_SEGMENTS])
    rpn = (rpn_b, rpn_s, N1_RPN_SEGMENTS, 0.7, -0.5, N1_RPN_SEGMENTS)
    bad, got = _n1_segments_case("RPN", *rpn)
    mismatched += bad
    sorted_bad = 0
    for b, sc, g in zip(rpn_b.split(N1_RPN_SEGMENTS), rpn_s.split(N1_RPN_SEGMENTS), got):
        ref, _ = detection.nms_static(b, sc, 0.7, -0.5, b.shape[0])
        sorted_bad += int((g != ref).sum())
    log(f"n1[RPN]: each segment equal to nms_static on it (which sorts): {sorted_bad == 0}")
    mismatched += sorted_bad
    cases = [(f"{k} boxes", [k], 0.7, [k]) for k in (1, 63, 65, n)]
    cases += [("class NMS, 100 of more kept", [n], 0.5, [100]),
              ("max below kept", [n], 0.7, [40])]
    for label, lens, iou, max_outs in cases:
        b = _n1_boxes(sum(lens), gen).to(device)
        sc = _n1_rpn_scores(sum(lens), gen, device)
        if sum(lens) == 1:
            sc = sc.abs()  # one box, kept
        mismatched += _n1_segments_case(label, b, sc, lens, iou, -0.5, max_outs)[0]
    invalid = torch.full((n,), -1.0, device=device)
    bad, got = _n1_segments_case("all scores invalid", boxes, invalid, [n], 0.7, -0.5, [n])
    mismatched += bad + int((got[0] != -1).sum())
    big_lens = (2048, 700, 4096)
    big = (torch.cat([_n1_boxes(k, gen, 1600.0) for k in big_lens]).to(device),
           torch.cat([_n1_rpn_scores(k, gen, device) for k in big_lens]), big_lens, 0.5, -0.5,
           (2048, 100, 4096))
    mismatched += _n1_segments_case("global scratch above 1,024", *big)[0]
    one = (rpn_b[:n], rpn_s[:n], [n], 0.7, -0.5, [n])
    big1 = (big[0][:2048], big[1][:2048], [2048], 0.5, -0.5, [2048])
    # Times by CUDA events over 50 back-to-back calls: the wrapper (whose host time paces
    # the loop where it exceeds the kernel's) and the kernel alone (its launch arguments
    # built beforehand, so that the host outpaces the card).
    lib = _kernels.load()
    times, wrapper = {}, {}
    for label, (b, sc, lens, iou, thr, max_outs) in (("1,000", one), ("RPN", rpn),
                                                     ("2,048", big1)):
        _, args, keep = detection._nms_args(b, sc, lens, max_outs, iou, thr)
        times[label] = cuda_ms(lambda a=args: lib.fusg_nms_segments(*a), iters=50, warmup=3)
        wrapper[label] = cuda_ms(
            lambda: detection.nms_sorted_segments(b, sc, lens, iou, thr, max_outs),
            iters=50, warmup=3)
        del keep
    if mismatched:
        raise AssertionError(f"kernel N1 disagrees with its plain version ({mismatched} indices)")
    static_ms = cuda_ms(lambda: detection.nms_static(boxes, scores, 0.7, -0.5, n), iters=50,
                        warmup=3)
    device_ms, rpn_device_ms = launch["n1_ms"], launch["n1_rpn_ms"]

    def plain():
        detection.nms_sorted_segments(one[0].cpu(), one[1].cpu(), *one[2:])

    plain()
    t0 = time.perf_counter()
    for _ in range(3):
        plain()
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    # Each input read once (boxes, scores), the indices written once; n^2 / 2 IoUs of
    # about 12 float32 operations.
    bound, by = bound_ms(nbytes(*one[:2]) + 8 * n, 12.0 * n * n / 2, PEAK_F32)
    log(f"n1 times (CUDA events, 50 calls; wrapper / kernel alone): nms_static with its sort, "
        f"{n} boxes, {static_ms:.4f} ms (the earlier two-kernel nms_static, measured the same "
        f"way: 0.2911 ms = stable sort, gather, copies, mask kernel, one warp's scan); one "
        f"presorted segment of {n} boxes {wrapper['1,000']:.4f} / {times['1,000']:.4f} ms, "
        f"nms_kernel {device_ms:.4f} ms on the device (profiler); the RPN's five segments "
        f"{list(N1_RPN_SEGMENTS)} in one call {wrapper['RPN']:.4f} / {times['RPN']:.4f} ms, "
        f"device {rpn_device_ms:.4f} (before: five nms_static calls, ~5 x 0.2512); one "
        f"2,048-box segment (global scratch) {wrapper['2,048']:.4f} / {times['2,048']:.4f} ms; "
        f"plain version (IoU matrix and greedy loop on the host) {plain_ms:.3f} ms; bound "
        f"{bound:.5f} ms by {by}; no library call in PyTorch ({card})")
    return dict(name="nms_segments", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/nms.cu",
                replaces="none: not a TPU kernel port (the JAX nms_static, "
                         "future_urban_scene_generation_tpu/ops/detection.py:45, is a lax.scan)",
                max_abs_err=float(mismatched), ms=wrapper["1,000"], plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _pnp_scene_inputs(v, device, seed=0):
    """PnP's inputs in the scene cells' kind of scene (720x1280, focal 1400 px, V cars
    of the 10-CAD bank), keypoints from the random-init hourglass as the scene reads
    them: (points3d (V, 12, 3), points2d (V, 12, 2), focals, centers)."""
    from future_urban_scene_generation_tpu_torch.pipeline import stages, synthetic
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec

    spec = ModelSpec()
    sc = synthetic.make_bench_scene(V=v, hw=(720, 1280), t_steps=6, device=device, spec=spec,
                                    seed=seed)
    with torch.no_grad():
        per = stages.perceive(sc.models, spec, sc.frame, sc.bboxes)
    k = sc.intrinsic
    return (sc.cad_bank.keypoints3d[per.cad_idx.clamp(max=spec.num_cads - 1)], per.kp_frame,
            torch.stack([k[0, 0], k[1, 1]]), torch.stack([k[0, 2], k[1, 2]]))


def _pnp_ops(v: int, n: int) -> float:
    """Floating-point operations of one P1 call at V vehicles of N keypoints, the most
    its loop takes (4V solves x 52 iterations), by the kernel's own arithmetic: a
    solve's iteration builds the rotation and its 3 tangents (~200), each of its 2N
    rows the camera point in 6 tangents and the projection's quotient (~100), J^T J's
    21 entries, J^T r's 6 and |r|^2 (2 each a row), and the damped 6 x 6 Cholesky solve
    and the policy (~200)."""
    per_iter = 200 + 2 * n * (100 + 2 * (21 + 6 + 1)) + 200
    return 4 * v * 52 * per_iter


def phase_pnp(device, card):
    """Kernel P1 (``csrc/pnp.cu`` behind ``fusg::pnp_cpc``, the scene's CPC pose solve
    in one launch): the card's cases of tests/test_torch_pnp_kernel.py, the kernel
    against the plain solve on the same CUDA tensors, bit for bit, on the keypoints of
    the scene cells' kind of scene at V = 4 and 16 (with each plain restart's error:
    most never converge on the random-weight keypoints), times by CUDA events, the
    bound, and the launches of the scene's pose span."""
    from future_urban_scene_generation_tpu_torch.geometry import pnp
    from future_urban_scene_generation_tpu_torch.geometry.rotations import (
        extrinsic_from_rodrigues,
    )
    from future_urban_scene_generation_tpu_torch.pipeline import stages

    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider", "-m", "chip",
                           os.path.join(ROOT, "tests", "test_torch_pnp_kernel.py")],
                          capture_output=True, text=True, cwd=ROOT)
    log("pnp: card cases of tests/test_torch_pnp_kernel.py: "
        + (proc.stdout.strip().splitlines() or ["(no output)"])[-1])
    if proc.returncode != 0:
        raise AssertionError(f"pnp: the card's cases failed:\n{proc.stdout[-6000:]}"
                             f"{proc.stderr[-2000:]}")

    times, record = {}, {}
    for v in (4, 16):
        args = _pnp_scene_inputs(v, device)
        got = pnp.pnp_cpc(*args)
        again = pnp.pnp_cpc(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"pnp: two launches at V={v} differ")
        want = pnp.solve_pnp_4restarts(*args)
        n = args[0].shape[1]
        _, _, restart_mse = pnp.lm_pnp_batch(
            args[0].repeat_interleave(4, 0), args[1].repeat_interleave(4, 0),
            torch.tensor(pnp.CANONICAL_RVECS, device=device).repeat(v, 1),
            torch.tensor(pnp.CANONICAL_TVEC, device=device).expand(4 * v, 3), *args[2:])
        gaps = [(got[0] - want[0]).abs() / want[0].abs().clamp(min=1e-6),
                (got[1] - want[1]).abs().amax(-1), (got[2] - want[2]).abs().amax(-1)]
        log(f"pnp: scene keypoints V={v}: mse kernel {[round(x, 4) for x in got[0].tolist()]}, "
            f"plain {[round(x, 4) for x in want[0].tolist()]}; relative mse gap "
            f"{[float(f'{x:.3g}') for x in gaps[0].tolist()]}; |rvec| gap "
            f"{[float(f'{x:.3g}') for x in gaps[1].tolist()]}; |tvec| gap "
            f"{[float(f'{x:.3g}') for x in gaps[2].tolist()]}; the plain restarts' mse "
            f"{[[round(x, 2) for x in row] for row in restart_mse.reshape(v, 4).tolist()]}")
        if not all(bool(((a == b) | (a.isnan() & b.isnan())).all()) for a, b in zip(got, want)):
            raise AssertionError(f"pnp: the kernel differs from the plain solve at V={v}")
        record[v] = max(float(g.nan_to_num().max()) for g in gaps[1:])
        plain_ms = cuda_ms(lambda: pnp.solve_pnp_4restarts(*args), iters=3)
        kernel_ms = cuda_ms(lambda: pnp.pnp_cpc(*args), iters=200, warmup=5)
        bound, by = bound_ms(nbytes(*args) + 7 * 4 * v, _pnp_ops(v, n), PEAK_F32)
        times[v] = (kernel_ms, plain_ms, bound, by)
        log(f"pnp: V={v}: kernel {kernel_ms:.4f} ms (CUDA events over 200 calls through "
            f"pnp.pnp_cpc); plain solve {plain_ms:.1f} ms; bound {bound:.6f} ms by {by} "
            f"({_pnp_ops(v, n):.3g} operations at most) ({card})")

    # The scene's pose span (runner.scene_geometry's fusg.pnp) by the profiler's device rows.
    args = _pnp_scene_inputs(4, device)
    meters = torch.zeros(4, 6, 2, device=device)

    def span():
        _, rvec, tvec = pnp.pnp_cpc(*args)
        extrinsic_from_rodrigues(rvec, tvec)
        stages.pose_rollout(meters)

    span()
    torch.cuda.synchronize()
    before = pnp.LAUNCHES
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        span()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    p1 = [e for e in kernels if "pnp_cpc_kernel" in e.name]
    log(f"pnp: the pose span at V=4 launched {len(kernels)} device kernels, P1 {len(p1)} "
        f"(pnp.LAUNCHES +{pnp.LAUNCHES - before}), P1 {sum(e.device_time for e in p1) / 1e3:.4f}"
        f" ms on the device")
    if pnp.LAUNCHES - before != 1 or len(p1) > 1:
        raise AssertionError("pnp: the pose span did not launch P1 once")
    kernel_ms, plain_ms, bound, by = times[4]
    return dict(name="pnp_cpc", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/pnp.cu",
                replaces="none: not a TPU kernel port (the JAX lm_pnp_single, "
                         "future_urban_scene_generation_tpu/geometry/pnp.py:123, is a "
                         "lax.while_loop in XLA)",
                max_abs_err=max(record.values()), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)


def _w1_bytes(args) -> int:
    """Bytes the warp has to move at least: its (N, 5, 256, 256, 3) f32 output written
    once. The texels it samples are left out (a plane reads a part of its table, which
    the L2 may hold), and so is W1's own r^2 scratch."""
    return args[2].shape[0] * 5 * 256 * 256 * 3 * 4


def _host_syncs(fn):
    """Each point of ``fn`` at which the host waited for the card
    (``torch.cuda.set_sync_debug_mode("warn")``), by the port's innermost frame and the
    runner's line that led there, with counts."""
    import traceback
    import warnings

    found = {}

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        port = [f for f in traceback.extract_stack()[:-1]
                if "future_urban_scene_generation_tpu_torch" in f.filename]
        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
                 for f in (port[-1:] + [f for f in port if f.filename.endswith("runner.py")][-1:])]
        key = " <- ".join(where) or f"{filename}:{lineno}"
        found[key] = found.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def phase_plane_warp(device, card):
    """Kernel W1 (``csrc/plane_warp.cu`` behind ``fusg::plane_warp``, the scene's plane
    warp past its homographies): the card's cases of tests/test_torch_plane_warp_kernel.py;
    W1 against the plain warp on the warps of the scene cells' kind of scene and of
    datagen's batch (the largest difference, the share of texels that differ);
    W1's time by CUDA events beside the plain warp's and the bytes bound, and each one's
    host enqueue; the device kernels launched under the scene's ``fusg.plane_warp``
    span; and which calls of a served scene still make the host wait for the card."""
    from perfbench.harness import trace as ptrace
    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
    from future_urban_scene_generation_tpu_torch.render import plane_warp
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    from future_urban_scene_generation_tpu_torch.ops import _kernels

    lines = _kernels.BUILD_LOG.splitlines()
    for i, line in enumerate(lines[:-1]):  # W1's kernels and the out-of-line solve
        if "Function properties for" in line and "plane_warp_cu" in line:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_plane_warp_cu_\w{8}", "", line.split("for ")[-1])
            log(f"  ptxas: {fn[:70]}: {lines[i + 1].strip()}")
            if " 0 bytes spill stores, 0 bytes spill loads" not in " " + lines[i + 1]:
                raise AssertionError(f"W1 spills registers: {line}: {lines[i + 1]}")
    test_file = os.path.join(ROOT, "tests", "test_torch_plane_warp_kernel.py")
    proc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-q",
                           "-p", "no:cacheprovider", "-m", "chip", test_file],
                          capture_output=True, text=True, cwd=ROOT)
    log("plane_warp: card cases of tests/test_torch_plane_warp_kernel.py: "
        + (proc.stdout.strip().splitlines() or ["(no output)"])[-1])
    if proc.returncode != 0:
        raise AssertionError(f"plane_warp: the card's cases failed:\n{proc.stdout[-6000:]}"
                             f"{proc.stderr[-2000:]}")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_plane_warp_kernel as cases

    records = {}
    for name in sorted(cases.CARD_SCENES):
        spec, args = cases.CARD_SCENES[name](device)
        got = stages.warp_planes_to_crop(spec, *args)
        want = cases._plain(spec, args)
        nan = torch.isnan(want)
        err = float((got - want).abs()[~nan].max())
        differ = float(((got != want) & ~nan).float().mean())
        if err or not torch.equal(torch.isnan(got), nan):
            raise AssertionError(f"plane_warp: W1 is not the plain warp bit for bit on {name}")

        def host(fn, iters):
            times = []
            for _ in range(iters):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return statistics.median(times)

        w1 = lambda: stages.warp_planes_to_crop(spec, *args)  # noqa: E731
        plain = lambda: cases._plain(spec, args)  # noqa: E731
        call_ms, plain_ms = cuda_ms(w1, iters=200, warmup=5), cuda_ms(plain, iters=5)
        host_w1, host_plain = host(w1, 50), host(plain, 5)
        # W1's own kernels: their device time by the profiler, over 20 calls.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                w1()
            torch.cuda.synchronize()
        kernel_ms = sum(e.device_time for e in prof.events()
                        if "plane_warp_" in e.name and "_kernel" in e.name) / 20 / 1e3
        bound, by = bound_ms(_w1_bytes(args), 0.0, PEAK_F32)
        records[name] = (kernel_ms, plain_ms, bound, by, err)
        log(f"plane_warp: {name}: N={args[2].shape[0]} grid {spec.warp_plane_res}^2 table "
            f"{tuple(args[0].shape)} {str(args[0].dtype)[6:]}: W1 against the plain warp: "
            f"largest difference {err:.3g}, {differ:.3g} of the texels differ; W1's kernels "
            f"{kernel_ms:.4f} ms on the device (profiler, 20 calls); the call with the plain "
            f"homographies {call_ms:.3f} ms (CUDA events over 200 calls), the plain warp "
            f"{plain_ms:.3f} ms; host enqueue {host_w1:.3f} ms against {host_plain:.3f} ms; "
            f"bound {bound:.4f} ms by {by} ({_w1_bytes(args) / 1e6:.1f} MB, the output "
            f"write) ({card})")

    # The scene's warp span: the runner's source-row copies, the homographies and W1.
    spec = SERVING_SPEC
    sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device, spec=spec)

    def scene():
        return runner.run_scene(sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes,
                                sc.meters, sc.intrinsic, spec=spec)

    scene()
    torch.cuda.synchronize()
    before = plane_warp.LAUNCHES
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scene()
        torch.cuda.synchronize()
    tr = ptrace.reduce(prof.profiler.kineto_results.events(), 1)
    under = tr.under("fusg.plane_warp")
    log(f"plane_warp: a served scene's fusg.plane_warp span launched {len(under)} device "
        f"kernels ({sorted({k.name[:48] for k in under})}), plane_warp.LAUNCHES "
        f"+{plane_warp.LAUNCHES - before}")
    if plane_warp.LAUNCHES - before != 1:
        raise AssertionError("plane_warp: the scene's warp span did not run W1 once")
    filed = [(k.name.split("<")[0].split()[-1], k.span) for k in under
             if "plane_warp_" in k.name]
    log(f"plane_warp: W1's kernels in the served scene, by the span open at their launch: "
        f"{filed}")
    if sorted(span for _, span in filed) != ["fusg.plane_warp.paste", "fusg.plane_warp.sample"]:
        raise AssertionError("plane_warp: W1's kernels are not filed under the warp's spans")
    syncs = _host_syncs(scene)
    log(f"plane_warp: host syncs of a served scene (set_sync_debug_mode): "
        f"{json.dumps(syncs, indent=1)}")
    if any(k.startswith("future_urban_scene_generation_tpu_torch/render/plane_warp.py")
           for k in syncs):
        raise AssertionError("plane_warp: W1's path syncs the host past the homographies")
    kernel_ms, plain_ms, bound, by, err = records["bf16_1080p_v4_r96"]
    return dict(name="plane_warp", route="cuda",
                source="future_urban_scene_generation_tpu_torch/csrc/plane_warp.cu",
                replaces="none: not a TPU kernel port (the JAX stages.warp_planes_to_crop, "
                         "future_urban_scene_generation_tpu/pipeline/stages.py, runs in XLA)",
                max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None)


def _rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / max(b.double().norm(), 1e-30))


def _maskrcnn_card_vs_cpu(model, frame, device, card):
    """Backbone, RPN and head tensors of one frame on the card against the CPU:
    float32 (relative L2 per tensor) and float64 (max abs against 1e-6 max|ref|)."""
    import copy

    from future_urban_scene_generation_tpu_torch.ops.resize import resize_bilinear

    img = resize_bilinear(torch.as_tensor(frame).to(device), MASKRCNN_INPUT_HW)
    pooled = torch.rand(64, 7, 7, 256, generator=torch.Generator().manual_seed(1))
    mpooled = torch.rand(16, 14, 14, 256, generator=torch.Generator().manual_seed(2))

    def tensors(net, dev, dtype):
        x = ((img.to(dev, dtype) - net.image_mean.to(dtype)) / net.image_std.to(dtype))[None]
        with torch.no_grad():
            feats = net.features(x)
            logits, deltas = net.rpn_head(feats)
            box = net.box_heads(pooled.to(dev, dtype))
            mask = net.mask_heads(mpooled.to(dev, dtype))
        return [*feats, *logits, *deltas, *box, mask]

    worst32 = 0.0
    cpu32 = copy.deepcopy(model).cpu()
    pairs = zip(tensors(model, device, torch.float32), tensors(cpu32, "cpu", torch.float32))
    for got, want in pairs:
        worst32 = max(worst32, _rel_l2(got.cpu(), want))
    del cpu32
    card64 = copy.deepcopy(model).double()
    cpu64 = copy.deepcopy(model).cpu().double()
    worst64 = 0.0
    pairs = zip(tensors(card64, device, torch.float64), tensors(cpu64, "cpu", torch.float64))
    for got, want in pairs:
        worst64 = max(worst64, (got.cpu() - want).abs().max().item() / want.abs().max().item())
    del card64, cpu64
    log(f"maskrcnn: card against CPU on one {MASKRCNN_INPUT_HW[0]}x{MASKRCNN_INPUT_HW[1]} frame "
        f"(5 FPN levels, RPN logits and deltas, box and mask heads): float32 worst relative L2 "
        f"{worst32:.2e} (bar {GPU_CPU_REL_L2}); float64 worst max abs {worst64:.2e} of max|ref| "
        f"(bar 1e-6) ({card})")
    if worst32 > GPU_CPU_REL_L2 or worst64 > 1e-6:
        raise AssertionError("maskrcnn: the card's network disagrees with the CPU's")


def phase_maskrcnn(device, card, ctx):
    """``cli.run_test --inpaint --segmenter maskrcnn`` at 720x1280, V=4, with a seeded
    full-width ResNet-50-FPN (91 classes) from the zoo, whose request must make two N1
    calls a frame; the detector's time per frame; ``TrackingStreamRunner`` with
    ``MaskRCNNDetector`` over 8 frames; the network on the card against the CPU.
    Returns N1's launches in the CLI's request (the n1 phase holds the kernel)."""
    from future_urban_scene_generation_tpu_torch.models.maskrcnn import maskrcnn_infer
    from future_urban_scene_generation_tpu_torch.ops import detection
    from future_urban_scene_generation_tpu_torch.ops.resize import resize_bilinear
    from future_urban_scene_generation_tpu_torch.pipeline import streaming
    from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk

    sys.modules["yaml"] = None  # the sidecar and config.yml are read without PyYAML (F7)
    _serving_setup(device, ctx)
    ckpt = os.path.join(ctx["root"], "ckpt_maskrcnn")
    _write_edgeconnect_zoo(ckpt)
    _write_maskrcnn_zoo(ckpt)
    launches, out = _cli_request(device, ctx, ckpt, "maskrcnn",
                                 ["--inpaint", "--segmenter", "maskrcnn"], card)
    shutil.rmtree(out)
    # Six frames a request, two N1 calls a frame: the RPN's five levels in one, the class
    # NMS (six a frame before the levels shared one call).
    if launches["nms_segments"] != 6 * 2:
        raise AssertionError(f"maskrcnn: {launches['nms_segments']} N1 launches, not 6 frames "
                             "x 2")

    svc = _inpaint_service(device, ctx, ckpt, "maskrcnn")
    frame, background, bboxes = _request_parts(svc, device, "maskrcnn", card)
    _erased_only_in_windows(svc, background, bboxes, "maskrcnn")
    seg = svc.segmenter
    frame_d = torch.as_tensor(frame).to(device)
    with torch.no_grad():
        masks = seg.masks_for_bboxes(frame_d, torch.as_tensor(bboxes).to(device))
        det = seg.detect(frame_d)
    log(f"maskrcnn: frame 1: {int(det.valid.sum())} detections, labels "
        f"{sorted(set(det.labels[det.valid].tolist()))}; mask pixels per vehicle "
        f"{[int(m.sum()) for m in masks]}")
    infer_ms = cuda_ms(lambda: maskrcnn_infer(seg.model, resize_bilinear(frame_d, seg.input_hw)),
                       iters=5, warmup=1)
    detection.NMS_LAUNCHES = 0
    maskrcnn_infer(seg.model, resize_bilinear(frame_d, seg.input_hw))
    log(f"maskrcnn: detector (resize + maskrcnn_infer, {MASKRCNN_INPUT_HW[0]}x"
        f"{MASKRCNN_INPUT_HW[1]}) {infer_ms:.2f} ms a frame by CUDA events (31.26 ms with six N1 "
        f"calls a frame); N1 {detection.NMS_LAUNCHES} calls a frame (the n1 phase times them "
        f"at these shapes) ({card})")
    _maskrcnn_card_vs_cpu(seg.model, frame, device, card)

    detector = trk.MaskRCNNDetector(seg.model, input_hw=seg.input_hw, device=device)
    frames_u8 = ctx["frames"][:MASKRCNN_FRAMES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_boxes = [len(detector(torch.as_tensor(f).to(device).float() / 255.0)[0])
               for f in frames_u8]
    det_fps = len(frames_u8) / (time.perf_counter() - t0)
    tracker = streaming.TrackingStreamRunner(
        svc.models, svc.cad_bank, svc.intrinsic, SERVE_HW, n_vehicles=len(SERVE_IDS),
        spec=svc.spec, vis_res=svc.cfg.runtime.vis_res, depth=2, detector=detector,
        inv_homography=svc.inv_homography, min_track_frames=1)
    scenes, n_conf = [], []
    bg_u8 = ctx["background"]
    for f in frames_u8:
        res, tracks = tracker.submit_frame(f, background=bg_u8)
        n_conf.append(len(tracks))
        if res is not None:
            scenes.append(res)
    scenes.extend(tracker.flush())
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(r.frames_icn).all()) for r in scenes)
    log(f"maskrcnn[stream]: {len(frames_u8)} frames, detections kept per frame {n_boxes}, "
        f"detector alone {det_fps:.2f} frames/s; TrackingStreamRunner (depth 2) confirmed "
        f"tracks per frame {n_conf}, {len(scenes)} scenes, finite {finite}, "
        f"{tracker.throughput_fps:.2f} composited frames/s ({card})")
    if not finite:
        raise AssertionError("maskrcnn[stream]: non-finite frames")
    svc.close()
    shutil.rmtree(svc.cfg.output_dir, ignore_errors=True)
    shutil.rmtree(ckpt)
    return launches["nms_segments"]


# --- The EdgeConnect trainers (S9b): cli.train --model edge|inpaint, export -> serve ---
EC_BATCH = 4  # the JAX CLI's default --batch
EC_HW = 256
EC_CPU_HW = {"edge": 256, "inpaint": 256}  # card-vs-CPU step size, batch 2


def _write_vgg19_trunk(path):
    """A seeded VGG19 trunk under torchvision's keys (features.N.weight / .bias), as
    ``--vgg-weights`` reads a torchvision vgg19 state dict."""
    from future_urban_scene_generation_tpu_torch.models.layers import seeded_init_
    from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Features

    net = seeded_init_(VGG19Features(), torch.Generator().manual_seed(13))
    torch.save(net.state_dict(), path)


def _ec_cli(model, out, extra, device):
    """``cli.train --model edge|inpaint`` at batch 4, 256^2 on the card in a fresh
    directory: 2 steps, then ``--resume`` to 3. Checks the logged steps, finite
    losses and that every spectral-norm u with more than one entry moved from its
    initial draw (a one-entry u is +-1)."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train
    from future_urban_scene_generation_tpu_torch.pipeline import training

    shutil.rmtree(out, ignore_errors=True)
    argv = ["--model", model, "--batch", str(EC_BATCH), "--image-size", str(EC_HW),
            "--device", device, "--out", out, "--log-interval", "1", "--save-interval", "1",
            *extra]
    t0 = time.perf_counter()
    cli_train.main(argv + ["--steps", "2"])
    cli_train.main(argv + ["--steps", "3", "--resume"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [{k: v for k, v in r.items() if k not in ("step", "time")} for r in recs]
    saved = torch.load(os.path.join(out, "checkpoint.pt"), map_location="cpu", weights_only=True)
    trainer = (training.EdgeModelTrainer() if model == "edge"
               else training.InpaintingModelTrainer())
    fresh = trainer.init(torch.Generator().manual_seed(10), device="cpu")  # the CLI's seed
    moved, still = 0, []
    for net in ("gen", "dis"):
        for k, v in getattr(fresh, net).state_dict().items():
            if k.endswith("weight_u") and v.numel() > 1:
                if torch.equal(saved[net][k], v):
                    still.append(f"{net}.{k}")
                moved += 1
    size = os.path.getsize(os.path.join(out, "checkpoint.pt")) / 2 ** 20
    log(f"train_ec[{model} cli]: 2 steps, then --resume to 3, in {secs:.2f} s (cold); losses "
        f"{[{k: float(f'{v:.5g}') for k, v in r.items()} for r in losses]}; checkpoint {size:.0f} "
        f"MiB at iteration {saved['iteration']}; spectral-norm u moved: {moved - len(still)} "
        f"of {moved}")
    if ([r["step"] for r in recs] != [0, 1, 2] or saved["iteration"] != 3 or still
            or not all(math.isfinite(v) for r in losses for v in r.values())):
        raise AssertionError(f"train_ec[{model} cli]: steps {recs}, u not moved {still}")


def _ec_timed(model, vgg_path, device, card, profile=False):
    """A fixed-batch loop at batch 4, 256^2: one warm-up step, 5 steps by CUDA
    events, the peak memory; the batch maker's time (Canny on the card). With
    ``profile``, a torch.profiler table of one more step: device busy time against
    the median step, and the operators with the most device time."""
    from future_urban_scene_generation_tpu_torch.cli import train as cli_train

    trainer, state, make_batch = cli_train.family_setup(
        model, seed=0, batch=EC_BATCH, lr=1e-4, image_size=EC_HW, device=device,
        vgg_weights=vgg_path)
    args = make_batch()
    dg_ms = cuda_ms(make_batch, iters=3, warmup=1)
    trainer.train_step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [], []
    for _ in range(5):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, m = trainer.train_step(state, *args)
        ev[1].record()
        events.append(ev)
        metrics.append(m)
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in events]
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first, last = ({k: float(f"{float(v):.5g}") for k, v in m.items()}
                   for m in (metrics[0], metrics[-1]))
    log(f"train_ec[{model}]: batch {EC_BATCH} at {EC_HW}^2, float32, step times "
        f"{[round(t, 2) for t in times]} ms; median {med:.2f} ms = "
        f"{EC_BATCH * 1000.0 / med:.2f} samples/s; peak memory {peak:.3f} GiB; datagen "
        f"(edgeconnect_batch, Canny on the card) {dg_ms:.2f} ms per batch; losses {first} -> "
        f"{last} on one fixed batch ({card})")
    if not all(math.isfinite(float(v)) for m in metrics for v in m.values()):
        raise AssertionError(f"train_ec[{model}]: non-finite losses")
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(state, *args)
            torch.cuda.synchronize()
        rows = prof.key_averages()
        with open(os.path.join(OUT_DIR, f"profile_train_ec_{model}.txt"), "w") as fh:
            fh.write(rows.table(sort_by="device_time_total", row_limit=60))
        dev = sorted((e for e in rows if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        conv = {k: sum(e.device_time_total for e in rows if e.key == k) / 1e3
                for k in ("aten::convolution", "aten::convolution_backward")}
        log(f"train_ec[{model} profile]: device busy {busy:.2f} ms of the {med:.2f} ms median "
            f"step (idle share {1.0 - busy / med:.3f}), {sum(e.count for e in dev)} device "
            f"launches; convolution forward {conv['aten::convolution']:.2f} ms, backward "
            f"{conv['aten::convolution_backward']:.2f} ms, the rest "
            f"{busy - sum(conv.values()):.2f} ms; top kernels: " + ", ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} x {e.count}" for e in dev[:6])
            + f"; table in chiprun_out/profile_train_ec_{model}.txt")
    return med


def _ec_step_on_both(model, dtype, hw, device):
    """One step of ``model``'s trainer from the same seeded state on the same batch of
    2 (made on the CPU: seeded images, ``edgeconnect_batch``), on the CPU and on the
    card, in ``dtype``. Returns {device: (losses, {net: grads}, {net: u})} and the
    instance-norm-fed biases."""
    from future_urban_scene_generation_tpu_torch.models.layers import seeded_init_
    from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Features
    from future_urban_scene_generation_tpu_torch.pipeline import datagen, training

    gen = torch.Generator().manual_seed(3)
    images = torch.rand((2, hw, hw, 3), generator=gen)
    sample = datagen.edgeconnect_batch(gen, images)
    if model == "edge":
        trainer, args = training.EdgeModelTrainer(), tuple(sample)
    else:
        trainer = training.InpaintingModelTrainer()
        vgg = seeded_init_(VGG19Features(), gen).eval().requires_grad_(False)
        args = (vgg, images, sample.edges, sample.masks)
    out = {}
    for dev in ("cpu", device):
        state = trainer.init(torch.Generator().manual_seed(5), device=dev)
        state.gen.to(dtype)
        state.dis.to(dtype)
        state.gen_opt, state.dis_opt = training.make_optimizers(state.gen, state.dis,
                                                                trainer.lr)
        _, metrics = trainer.train_step(state, *(a.to(dev, dtype) for a in args))
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {net: {n: p.grad.double().cpu()
                           for n, p in getattr(state, net).named_parameters()}
                     for net in ("dis", "gen")},
                    {net: {k: v.double().cpu() for k, v in getattr(state, net).state_dict().items()
                           if k.endswith("weight_u")} for net in ("dis", "gen")})
    return out, training.instance_norm_fed_biases(state)


def _ec_gpu_vs_cpu(model, device):
    """Card against CPU for one EdgeConnect trainer, at the bars of
    ``_family_gpu_vs_cpu``: float32 losses rtol 1e-3 and gradients relative L2 5e-2 per
    tensor; float64 losses rtol 1e-6, gradients atol 1e-6 * max|g|, and the advanced u
    to 1e-9; instance-norm-fed biases near zero against their conv's weight gradient."""
    hw, bad = EC_CPU_HW[model], []
    for dtype, loss_tol, tol, metric in ((torch.float32, 1e-3, GPU_CPU_REL_L2, 1),
                                         (torch.float64, 1e-6, 1e-6, 0)):
        t0 = time.perf_counter()
        res, zero = _ec_step_on_both(model, dtype, hw, device)
        (lc, gc, uc), (lg, gg, ug) = res["cpu"], res[device]
        bad += [f"{dtype} {k}" for k in lc if not abs(lg[k] - lc[k]) <= loss_tol * abs(lc[k])]
        worst, u_err = {}, 0.0
        for net in ("dis", "gen"):
            dist = _grad_distances(gg[net], gc[net], zero, net)
            bad += [f"{dtype} {net}.{n}" for n, d in dist.items() if not d[metric] <= tol]
            bad += [f"{dtype} {net}.{n} (near zero)" for n, d in dist.items()
                    if f"{net}.{n}" in zero and not d[0] <= 1e-4]
            worst[net] = tuple(max(d[i] for n, d in dist.items() if f"{net}.{n}" not in zero)
                               for i in (0, 1))
            u_err = max([u_err] + [(ug[net][k] - uc[net][k]).abs().max().item() for k in uc[net]])
        if dtype == torch.float64 and not u_err <= 1e-9:
            bad.append(f"{dtype} advanced u {u_err:.3e}")
        log(f"train_ec[{model} gpu_vs_cpu {dtype}]: batch 2 at {hw}^2 in "
            f"{time.perf_counter() - t0:.1f} s; losses cpu {lc} gpu {lg} (rtol {loss_tol:g}); "
            "gradients, worst max|diff| / max|g| and relative L2: " + ", ".join(
                f"{net} {w[0]:.3e} / {w[1]:.3e}" for net, w in worst.items())
            + f" (tol {tol:g} on {('max|diff| / max|g|', 'relative L2')[metric]}); advanced u "
            f"max|diff| {u_err:.3e}")
    if bad:
        raise AssertionError(f"{model} step on the GPU disagrees with the CPU: {bad[:8]}")


def _ec_served_equals_trained(runs, zoo, device, card):
    """Export both runs with ``cli/export_zoo``, load the files back through
    ``checkpoint.zoo_state_dict`` into ``edgeconnect.build_generators`` (strict), and
    hold the served generators to the trained ones' eval-mode forward (the edge
    generator's spectral norm from its stored u and v) at 1e-5 max abs."""
    from future_urban_scene_generation_tpu_torch.cli import export_zoo
    from future_urban_scene_generation_tpu_torch.models import edgeconnect
    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint

    shutil.rmtree(zoo, ignore_errors=True)
    export_zoo.main(["--runs", *(f"{m}={r}" for m, r in runs.items()), "--out", zoo])
    served = dict(zip(("edge", "inpaint"), edgeconnect.build_generators(device=device)))
    gen = torch.Generator().manual_seed(17)
    errs = {}
    for model, run in runs.items():
        served[model].load_state_dict(checkpoint.zoo_state_dict(zoo, model), strict=True)
        trained = (edgeconnect.EdgeGenerator(spectral=True) if model == "edge"
                   else edgeconnect.InpaintGenerator())
        trained.load_state_dict(torch.load(os.path.join(run, "checkpoint.pt"), map_location="cpu",
                                           weights_only=True)["gen"], strict=True)
        trained = trained.to(device).eval()
        x = torch.rand((2, EC_HW, EC_HW, 3 if model == "edge" else 4), generator=gen).to(device)
        with torch.no_grad():
            errs[model] = (served[model](x) - trained(x)).abs().max().item()
    log(f"train_ec[export -> serve]: cli/export_zoo -> zoo_state_dict -> build_generators "
        f"(strict); served vs trained eval-mode forward, max abs {errs} (tol 1e-5; {card})")
    if not all(e <= 1e-5 for e in errs.values()):
        raise AssertionError(f"train_ec: the served generators are not the trained ones: {errs}")


def phase_train_ec(device, card, profile=False):
    """The EdgeConnect trainers at full width (8 residual blocks, 256^2, float32): the
    CLI with a resume for both (the inpainting model with ``--vgg-weights``, a seeded
    trunk in torchvision's layout), fixed-batch timed loops, one step on the card
    against the CPU, and export -> serve. No kernel of the port is on this path: the
    launch counters stay 0 over the CLI runs."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster, detection

    t0 = time.perf_counter()
    vgg_path = os.path.join(OUT_DIR, "ec_vgg19.pth")
    runs = {m: os.path.join(OUT_DIR, f"train_ec_{m}") for m in ("edge", "inpaint")}
    zoo = os.path.join(OUT_DIR, "ec_zoo")
    try:
        _write_vgg19_trunk(vgg_path)
        cuda_conv.SMALL_CIN_V2_LAUNCHES = cuda_conv.SMALL_CIN_LAUNCHES = cuda_conv.LAUNCHES = 0
        cuda_raster.LAUNCHES = cuda_raster.INDEXED_LAUNCHES = detection.NMS_LAUNCHES = 0
        _ec_cli("edge", runs["edge"], [], device)
        _ec_cli("inpaint", runs["inpaint"], ["--vgg-weights", vgg_path], device)
        launches = (cuda_conv.SMALL_CIN_V2_LAUNCHES, cuda_conv.SMALL_CIN_LAUNCHES,
                    cuda_conv.LAUNCHES, cuda_raster.LAUNCHES, cuda_raster.INDEXED_LAUNCHES,
                    detection.NMS_LAUNCHES)
        log(f"train_ec: kernel launches in both CLI runs (K3, K4, K2, K1, K1', N1): {launches}")
        if any(launches):
            raise AssertionError("train_ec: a kernel of the port ran on the EdgeConnect path")
        _ec_served_equals_trained(runs, zoo, device, card)
        for model in runs:
            _ec_timed(model, vgg_path if model == "inpaint" else None, device, card, profile)
            torch.cuda.empty_cache()
        for model in runs:
            _ec_gpu_vs_cpu(model, device)
    finally:
        for path in (*runs.values(), zoo):
            shutil.rmtree(path, ignore_errors=True)  # ~0.4 GB of checkpoints
        if os.path.exists(vgg_path):
            os.remove(vgg_path)
    log(f"train_ec: phase in {time.perf_counter() - t0:.1f} s")


def _drop_serving_data(ctx):
    if "service" in ctx:
        ctx["service"].close()
    if ctx:
        shutil.rmtree(ctx["root"], ignore_errors=True)


# The parallel phase (the (data, model) mesh on torch.distributed): the sharded scene,
# the stream runner on a mesh and the ICN train step under data parallelism, in a fresh
# process with one rank a card (NCCL cannot put two ranks on one card).
PARALLEL_SCENES = 3  # timed scenes each, sharded and not, alternating
PARALLEL_STEPS = 3  # timed ICN steps each, after the compared one
PARALLEL_FRAMES = 4  # frames through the stream runner, on a mesh and not
K3_MODEL_SLICE = (8, 262, 262, 21, 7, 32)  # K3 at the stem's slice on a model=2 rank
# Sharded == unsharded frames, the JAX package's bars (tests/test_sharded_inference.py:
# 112-140): a mean and a share of pixels beyond an atol.
SHARD_ATOL, SHARD_BAD_FRAC, SHARD_MEAN = 2e-3, 5e-3, 1e-4


def _scene_gap(ref, got):
    """(bit-equal, max |diff|, mean |diff|, share beyond SHARD_ATOL) of two SceneResults'
    frames, after checking cad_idx equal and pnp_error within 1e-5."""
    if not torch.equal(ref.cad_idx, got.cad_idx):
        raise AssertionError(f"cad_idx differ: {ref.cad_idx.tolist()} {got.cad_idx.tolist()}")
    if not torch.allclose(ref.pnp_error, got.pnp_error, rtol=0, atol=1e-5, equal_nan=True):
        raise AssertionError(f"pnp_error differ: {ref.pnp_error.tolist()} "
                             f"{got.pnp_error.tolist()}")
    d = torch.cat([(a.double() - b.double()).abs().flatten() for a, b in
                   ((ref.frames_icn, got.frames_icn), (ref.frames_vunet, got.frames_vunet))])
    equal = all(torch.equal(a, b) for a, b in zip(ref, got) if a.is_floating_point()
                and a.dim() > 1)
    return equal, d.max().item(), d.mean().item(), (d > SHARD_ATOL).double().mean().item()


def _check_gap(what, gap):
    equal, dmax, dmean, bad = gap
    log(f"parallel[{what}]: bit-equal {equal}; max |diff| {dmax:.3e}, mean {dmean:.3e}, share "
        f"beyond {SHARD_ATOL} {bad:.3e} (bars: mean {SHARD_MEAN}, share {SHARD_BAD_FRAC})")
    if not (dmean < SHARD_MEAN and bad < SHARD_BAD_FRAC):
        raise AssertionError(f"parallel[{what}]: sharded and unsharded results differ")


class _Counted:
    """The launches of K1, K2 and K3 made inside ``with counted:`` blocks only, so that
    the unsharded references run between them are not counted."""

    def __init__(self):
        self.launches = {"raster": 0, "icn_stem_conv": 0, "conv_small_cin_v2": 0}

    def _read(self):
        from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster

        return (cuda_raster.LAUNCHES, cuda_conv.LAUNCHES, cuda_conv.SMALL_CIN_V2_LAUNCHES)

    def __enter__(self):
        self._start = self._read()

    def __exit__(self, *exc):
        for key, a, b in zip(self.launches, self._start, self._read()):
            self.launches[key] += b - a


def _parallel_scene(sc, mesh, counted, device):
    """run_scene_sharded on the bench scene against run_scene: equal, timed, profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from future_urban_scene_generation_tpu_torch.pipeline import runner

    args = (sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes, sc.meters, sc.intrinsic)
    ref = runner.run_scene(*args, spec=sc.spec)
    with counted:
        got = runner.run_scene_sharded(*args, mesh, spec=sc.spec)
    torch.cuda.synchronize()
    _check_gap("scene", _scene_gap(ref, got))
    times = {"run_scene": [], "run_scene_sharded": []}
    for _ in range(PARALLEL_SCENES):
        for name in times:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if name == "run_scene":
                runner.run_scene(*args, spec=sc.spec)
            else:
                with counted:
                    runner.run_scene_sharded(*args, mesh, spec=sc.spec)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with counted:
            runner.run_scene_sharded(*args, mesh, spec=sc.spec)
        torch.cuda.synchronize()
    rows = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    found = {tag: sum(n for k, n in rows.items() if tag in k) for tag in
             ("raster_setup_kernel", "raster_tiles_kernel", "conv_wgmma_kernel", "nccl")}
    log(f"parallel[profile]: device rows of one sharded scene by kernel: {found}")
    if not all(found[k] for k in ("raster_setup_kernel", "raster_tiles_kernel",
                                  "conv_wgmma_kernel")):
        raise AssertionError(f"parallel: the sharded scene did not run K1's two kernels and "
                             f"K2 on the card: {found}")
    return times


def _parallel_stream(sc, mesh, counted, device):
    """The same frames through StreamRunner(mesh=) and StreamRunner: the same results."""
    from future_urban_scene_generation_tpu_torch.pipeline import streaming

    rng = np.random.RandomState(7)
    base = sc.frame.cpu().numpy()
    frames = [np.uint8(np.clip(base + rng.rand(*base.shape) * 0.05, 0, 1) * 255)
              for _ in range(PARALLEL_FRAMES)]
    boxes, meters = sc.bboxes.cpu().numpy(), sc.meters.cpu().numpy()
    out = {}
    for key in (None, mesh):
        stream = streaming.StreamRunner(sc.models, sc.cad_bank, sc.intrinsic.cpu().numpy(),
                                        tuple(base.shape[:2]), n_vehicles=len(boxes),
                                        spec=sc.spec, depth=2, mesh=key)
        res = []
        with counted if key is not None else contextlib.nullcontext():
            for f in frames:
                r = stream.submit(f, boxes, meters)
                if r is not None:
                    res.append(r)
            res.extend(stream.flush())
        torch.cuda.synchronize()
        out[key is not None] = res
    if not len(out[True]) == len(out[False]) == PARALLEL_FRAMES:
        raise AssertionError(f"parallel[stream]: {len(out[True])} / {len(out[False])} results")
    worst = max((_scene_gap(a, b) for a, b in zip(out[False], out[True])),
                key=lambda g: (g[3], g[2]))
    _check_gap(f"stream, {PARALLEL_FRAMES} frames, worst", worst)


def _parallel_step(mesh, counted, device, batch=8, hw=256):
    """The full-width ICN step (batch 8, 256^2, float32) placed on the mesh against the
    unsharded step from the same seed: l_g within 1e-3 (tests/test_parallel_training.py:
    82); then both timed, alternating."""
    from future_urban_scene_generation_tpu_torch.parallel import training as ptraining
    from future_urban_scene_generation_tpu_torch.pipeline import training

    trainer = training.ICNTrainer(lr=1e-3)
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.rand(batch, hw, hw, 21).astype(np.float32) * 2 - 1, device=device)
    y = torch.as_tensor(rng.rand(batch, hw, hw, 3).astype(np.float32) * 2 - 1, device=device)
    plain = trainer.init(torch.Generator().manual_seed(0), device=device)
    sharded = ptraining.shard_state(trainer.init(torch.Generator().manual_seed(0),
                                                 device=device), mesh)

    def step(name):
        if name == "train_step":
            return trainer.train_step(plain, x, y)[1]
        with counted:
            return ptraining.sharded_train_step(trainer, sharded, x, y)[1]

    first = {name: {k: float(v) for k, v in step(name).items()}
             for name in ("train_step", "sharded_train_step")}
    gap = abs(first["train_step"]["l_g"] - first["sharded_train_step"]["l_g"])
    log(f"parallel[step]: losses of the first step, unsharded {first['train_step']}, "
        f"sharded {first['sharded_train_step']}; |l_g - l_g'| {gap:.3e} (bar 1e-3)")
    if not gap < 1e-3:
        raise AssertionError("parallel[step]: the sharded step's l_g strays from the unsharded")
    times = {"train_step": [], "sharded_train_step": []}
    for _ in range(PARALLEL_STEPS):
        for name in times:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(name)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def _k3_model_slice(device):
    """K3 at the ICN stem's output-channel slice on a model=2 rank (O = 32), float32
    and bfloat16, against its float64 plain version (phase k3's tolerances)."""
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv

    for dtype in (torch.float32, torch.bfloat16):
        x, kern = _small_cin_inputs(K3_MODEL_SLICE, device, dtype, seed=50)
        _poison_shared_memory(cuda_conv.conv_small_cin_v2, (x, kern))
        got = cuda_conv.conv_small_cin_v2(x, kern)
        ref = cuda_conv.conv_small_cin_plain(x.double(), kern.double())
        torch.cuda.synchronize()
        err, tol32, ratio16 = _conv_errors(got, ref)
        ok = err <= tol32 if dtype == torch.float32 else ratio16 <= 1.0
        log(f"parallel[k3 {K3_MODEL_SLICE} {dtype}]: max abs err {err:.3e} (f32 tol "
            f"{tol32:.3e}; bf16 worst ratio to its bound {ratio16:.3f}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version at {K3_MODEL_SLICE}")


def _parallel_rank(rank, world, port, queue=None):
    """One rank of the parallel phase: joins an NCCL group of ``world`` ranks, one card
    each, runs every check on the mesh (data=world, model=1), and leaves the group."""
    import torch.distributed as dist

    from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
    from future_urban_scene_generation_tpu_torch.pipeline import synthetic
    from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cuda"
    pmesh.init_distributed(f"localhost:{port}", world_size=world, rank=rank, device_type="cuda")
    try:
        mesh = pmesh.make_mesh(data=-1, model=1, device_type="cuda")
        log(f"parallel: rank {rank} of {world} on cuda:{rank}, mesh {mesh}")
        counted = _Counted()
        sc = synthetic.make_bench_scene(V=4, hw=(1080, 1920), t_steps=6, device=device,
                                        spec=SERVING_SPEC)
        scene_ms = _parallel_scene(sc, mesh, counted, device)
        _parallel_stream(sc, mesh, counted, device)
        del sc
        torch.cuda.empty_cache()
        step_ms = _parallel_step(mesh, counted, device)
        _k3_model_slice(device)
        out = {"world": world, "launches": counted.launches,
               **{f"{k}_ms": v for k, v in {**scene_ms, **step_ms}.items()}}
    finally:
        dist.destroy_process_group()
    if queue is not None:
        queue.put((rank, out))
    return out


def parallel_main():
    """The parallel phase's body (``--parallel``): one rank on the one card, or a rank
    a card by spawn on up to four (the bench scene's V=4 must split over 'data')."""
    import socket

    world = max(n for n in (1, 2, 4) if n <= torch.cuda.device_count())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if world == 1:
        return _parallel_rank(0, 1, port)
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    mp.spawn(_parallel_rank, args=(world, port, queue), nprocs=world)
    return dict(queue.get() for _ in range(world))[0]


def phase_parallel(card):
    """``parallel_main`` in a fresh process of this script, so that no other phase sees
    a process group; returns the launches of K1, K2 and K3 on its sharded path."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    for line in res.stdout.splitlines()[:-1]:
        log(line)
    if res.returncode != 0:
        raise AssertionError(f"parallel phase failed ({res.returncode}):\n{res.stderr[-3000:]}")
    out = json.loads(res.stdout.splitlines()[-1])
    med = {k: statistics.median(v) for k, v in out.items() if k.endswith("_ms")}
    log(f"parallel: {out['world']} rank(s), mesh (data={out['world']}, model=1); medians (ms) "
        f"run_scene {med['run_scene_ms']:.2f}, run_scene_sharded {med['run_scene_sharded_ms']:.2f}, "
        f"train_step {med['train_step_ms']:.2f}, sharded_train_step "
        f"{med['sharded_train_step_ms']:.2f}; all {json.dumps({k: [round(t, 2) for t in v] for k, v in out.items() if k.endswith('_ms')})} "
        f"({card})")
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"parallel: a kernel of the sharded path never launched: "
                             f"{out['launches']}")
    log(f"parallel: launches on the sharded path (scenes, stream, steps): {out['launches']}")
    return out["launches"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--split", metavar="PACKAGE_ROOT",
                    help="only where the device time of N1, N3 and the quantized ICN forward "
                         "goes, for the port package under PACKAGE_ROOT (e.g. an unpacked "
                         "earlier commit)")
    ap.add_argument("--launch-checks", action="store_true",
                    help="only the profiled one-kernel-a-call checks of N1 and N3 (run by "
                         "the n1 and int8 phases in a fresh process)")
    ap.add_argument("--parallel", action="store_true",
                    help="only the parallel phase's checks (run by that phase in a fresh "
                         "process)")
    ap.add_argument("--aot-restart", metavar="DIR",
                    help="only the aot phase's restart from the artifacts under DIR (run by "
                         "that phase in a fresh process)")
    ap.add_argument("--aot-int8", action="store_true", help="--aot-restart on the int8 tier")
    ap.add_argument("--aot-export-int8", metavar="DIR",
                    help="only the aot phase's int8-tier export into DIR (run by that phase "
                         "in a fresh process)")
    ap.add_argument("--t-spawn", type=float, default=None,
                    help="--aot-restart: the parent's time.time() at the spawn")
    ap.add_argument("--scene-times", metavar="PACKAGE_ROOT",
                    help="only the bench scene's times, serving spec and int8 tier, for the "
                         "port package under PACKAGE_ROOT (e.g. an unpacked earlier commit)")
    args = ap.parse_args()
    if args.aot_restart:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: CUDA is not available")
        sys.path.insert(0, ROOT)
        print(json.dumps(aot_restart(args.aot_restart, args.aot_int8, args.t_spawn)),
              flush=True)
        return
    if args.aot_export_int8:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: CUDA is not available")
        sys.path.insert(0, ROOT)
        print(json.dumps(aot_export_int8(args.aot_export_int8)), flush=True)
        return
    if args.scene_times:
        name, smi = phase_device()
        sys.path.insert(0, os.path.abspath(args.scene_times))
        from future_urban_scene_generation_tpu_torch.ops import _kernels

        _kernels.load()
        times = scene_times()
        log(f"scene times (ms) of {_kernels.__file__}: " + json.dumps(times) + f" ({smi})")
        if any(k.endswith("_ops") for k in times):
            log("dispatcher cost a call, host us through the op vs direct: "
                + json.dumps(_dispatch_cost("cuda")) + f" ({smi})")
        return
    if args.parallel:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: CUDA is not available")
        sys.path.insert(0, ROOT)
        print(json.dumps(parallel_main()), flush=True)
        return
    if args.launch_checks:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: CUDA is not available")
        sys.path.insert(0, ROOT)
        print(json.dumps(launch_checks()), flush=True)
        return
    if args.split:
        name, smi = phase_device()
        sys.path.insert(0, os.path.abspath(args.split))
        from future_urban_scene_generation_tpu_torch.ops import _kernels

        _kernels.load()
        log(f"split of {_kernels.__file__} ({smi})")
        split_report()
        return
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    name, smi = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    device = "cuda"
    launch = phase_launch_checks(smi) if {"n1", "int8"} & set(phases) else {}
    t_start = time.perf_counter()
    kernels, launches, serving = [], {}, {}
    if "k1" in phases:
        kernels.extend(phase_k1(device))
    if "k2" in phases:
        kernels.append(phase_k2(device))
    if "k3" in phases:
        kernels.extend(phase_k3(device))
    if "pnp" in phases:
        kernels.append(phase_pnp(device, smi))
    if "plane_warp" in phases:
        kernels.append(phase_plane_warp(device, smi))
    if "gpu_vs_cpu" in phases:
        phase_gpu_vs_cpu(device)
    if "main" in phases:
        launches = phase_main(device, args.profile, smi)
    if "int8" in phases:
        records, int8_launches = phase_int8(device, smi, launch)
        kernels.extend(records)
        launches["conv_int8"] = int8_launches["conv_int8"]
        launches["quant_int8"] = int8_launches["quant_int8"]
    if "train" in phases:
        launches.update(phase_train(device, smi))
    if "demo" in phases:
        launches["rasterize_indexed"] = phase_demo(device, smi)["rasterize_indexed"]
    if "n1" in phases:
        kernels.append(_n1_check(device, smi, launch))
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
        if "inpaint" in phases:
            phase_inpaint(device, smi, serving)
        if "maskrcnn" in phases:
            launches["nms_segments"] = phase_maskrcnn(device, smi, serving)
    finally:
        _drop_serving_data(serving)  # ~130 MB of frames and results stay on the machine
    if "warmup" in phases:
        phase_warmup(smi)
    if "aot" in phases:
        phase_aot(smi)
    if "train_ec" in phases:
        phase_train_ec(device, smi, args.profile)
    if "parallel" in phases:
        phase_parallel(smi)
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
