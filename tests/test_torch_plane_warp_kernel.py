"""Kernel W1 (``csrc/plane_warp.cu``) behind the operator ``fusg::plane_warp``
(render/plane_warp.py): the scene's plane warp past its homographies, in one launch at
the crop's grid and two below it.

On the CPU the operator, through ``stages.warp_planes_to_crop`` as the scene calls it,
is the plain warp, :func:`plane_warp.warp_planes_plain`, bit for bit: the exact 256^2
grid and the 96^2 grid pasted into the crop, invisible and skipped planes, a degenerate
quad, a row whose polygons are NaN (a failed pose), a plane spanning fewer than 96 crop
pixels (the antialiased paste), planes a few pixels wide whose homographies are near
singular (what random-weight perception makes of a far vehicle), the 4-gons through the
DLT (``quad_homography=False``). Its fake gives the real call's shapes, dtypes and
strides, and the wrapper refuses meta and other devices.

On the card (marker ``chip``; they skip without one) W1 is held to the plain warp on
the same CUDA tensors, on those cases and on the warps of the scene cells' kind of scene
(V = 4 at 1080x1920 on the served spec: 96^2 grids, bf16 tables, with the 4-gons'
closed form and through the DLT; V = 4 and 16 at 720x1280 on the default spec: 256^2,
f32) and of ICN datagen's batch of 8. The
homographies are the plain warp's own calls (batched), and W1 repeats the rest rounding
for rounding (the paste's sums in ATen's and cuBLAS's orders), so it is bit-equal, NaNs
included: a far vehicle's near-singular homography turns any rounding apart into percents
of its sample, and the scene judge sees that. The only host sync of the call is the
homographies' ``eigh``, the profiler files W1's kernels under the warp's spans, and two
calls are bit-equal; W1 refuses tables other than float32 and bfloat16. This
file imports no JAX, so that the card's cases run there:
``python -m pytest --noconftest tests/test_torch_plane_warp_kernel.py -m chip``.
"""
import math

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.geometry.projection import project_normalized
from future_urban_scene_generation_tpu_torch.geometry.rotations import (
    matrix_to_rodrigues,
    x_rot,
    z_rot,
)
from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.render import plane_warp
from future_urban_scene_generation_tpu_torch.render import visibility as vis
from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC, ModelSpec
from future_urban_scene_generation_tpu_torch.utils import mesh as mu
import torch_threads  # noqa: F401

FOCAL, CENTER = 1400.0, (640.0, 360.0)
# Planes a few pixels wide (a far vehicle's, read off a benchmark scene): near-singular
# homographies, (source, destination) polygons of the right side and the roof.
TINY_SIDE = ([[645, 650], [644, 649], [642, 646], [641, 646], [642, 648], [644, 650]],
             [[650, 648], [650, 647], [647, 644], [647, 644], [648, 646], [649, 648]])
TINY_ROOF = ([[642, 651], [641, 649], [642, 648], [644, 650], [644, 650], [644, 650]],
             [[648, 649], [646, 647], [648, 646], [649, 648], [649, 648], [649, 648]])


def _polygons(yaws, dists, seed):
    """Plane polygons (R, 5, 6, 2) of the test car at R poses (the camera tilted by
    pi / 2.4, the given yaws and distances), pixel-truncated as the scene's are."""
    _, kp3d = mu.make_test_car(subdiv=1)
    r = len(yaws)
    points3d = torch.as_tensor(np.float32(kp3d) * 5.0).expand(r, -1, -1)
    rot = x_rot(torch.tensor(-math.pi / 2.4)) @ z_rot(torch.tensor(yaws, dtype=torch.float32))
    rng = np.random.RandomState(seed)
    tvec = torch.tensor([[rng.uniform(-4, 4), 2.0, d] for d in dists], dtype=torch.float32)
    kp2d = project_normalized(points3d, matrix_to_rodrigues(rot), tvec,
                              torch.tensor([FOCAL, FOCAL]), torch.tensor(CENTER))
    polys = vis.plane_polygons_2d(torch.trunc(kp2d), vis.TEXTURE_PLANES)
    return polys, kp2d


def _window(kp2d, grow: float = 1.0) -> cr.Window:
    lo, hi = kp2d.amin(1), kp2d.amax(1)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * grow
    return cr.square_window_from_bbox(torch.cat([mid - half, mid + half], -1))


def _case(name: str):
    """(spec, warp_planes_to_crop's arguments after the spec) of one CPU case."""
    v, s = 2, 2
    n = v * s
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    table = torch.rand(v, 48, 48, 3, generator=g) * 2.0 - 1.0
    src_polys, src_kp = _polygons([0.4, 1.9], [18.0, 24.0], seed=1)
    dst_polys, dst_kp = _polygons([0.5, 0.9, 1.6, 2.2], [18.0, 19.0, 25.0, 27.0], seed=2)
    src_window = _window(src_kp)
    dst_window = _window(dst_kp, grow=8.0 if name == "small_plane" else 1.0)
    table_index = torch.arange(n) // s
    src_polys = src_polys[table_index].clone()
    src_vis = torch.ones(n, 5, dtype=torch.bool)
    dst_vis = torch.ones(n, 5, dtype=torch.bool)
    spec = SERVING_SPEC if name in ("reduced", "small_plane", "tiny_planes_r96") else ModelSpec()
    if name == "quad_dlt":  # both 4-gon warps through find_homography, one batch on the card
        spec = SERVING_SPEC.replace(quad_homography=False)
    if name == "invisible":
        src_vis[1, 0] = False  # the side from the right plane
        dst_vis[2] = False  # nothing to write
        src_vis[3, 3] = False  # front/back skipped; the roof unseen at the destination
        dst_vis[3, 2] = False
        src_vis[0, 4] = dst_vis[0, 3] = False
    elif name == "degenerate_quad":
        dst_polys = dst_polys.clone()
        dst_polys[0, 2, :, 1] = dst_polys[0, 2, 0, 1]  # the roof collapsed onto a line
        dst_polys[1, 3, 1] = dst_polys[1, 3, 0]  # the front's first edge of length 0
    elif name == "nonfinite_row":
        src_polys, dst_polys = src_polys.clone(), dst_polys.clone()
        src_polys[1] = float("nan")
        dst_polys[1] = float("nan")
    elif name.startswith("tiny_planes"):  # every row a far vehicle, shifted a pixel a row
        src_polys, dst_polys = src_polys.clone(), dst_polys.clone()
        for plane, (sp, dp) in ((1, TINY_SIDE), (2, TINY_ROOF), (3, TINY_ROOF)):
            src_polys[:, plane] = torch.tensor(sp, dtype=torch.float32)
            dst_polys[:, plane] = torch.tensor(dp, dtype=torch.float32) + torch.arange(n)[
                :, None, None]
        src_vis[:, 0] = dst_vis[:, 0] = src_vis[:, 4] = dst_vis[:, 4] = False
        src_window = cr.Window(*(torch.tensor([v_] * v) for v_ in (640.0, 645.0, 8.0, 8.0)))
        dst_window = cr.Window(*(torch.tensor([v_] * n) for v_ in (644.0, 642.0, 10.0, 10.0)))
    return spec, (table, src_window, src_polys, dst_polys, src_vis, dst_vis, dst_window,
                  table_index)


CPU_CASES = ("exact", "reduced", "invisible", "degenerate_quad", "nonfinite_row", "small_plane",
             "tiny_planes", "tiny_planes_r96", "quad_dlt")


def _plain(spec, args):
    return plane_warp.warp_planes_plain(*args, res=spec.warp_plane_res,
                                        out_res=stages.SKETCH_RES, quad=spec.quad_homography)


@pytest.mark.parametrize("case", CPU_CASES)
def test_plane_warp_on_cpu_is_the_plain_warp(case):
    """``fusg::plane_warp`` on CPU tensors, through the stage the scene calls, equals
    the plain warp bit for bit (NaNs where it has them)."""
    spec, args = _case(case)
    got = stages.warp_planes_to_crop(spec, *args)
    want = _plain(spec, args)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    black = torch.tensor(plane_warp.LAB_BLACK_SIGNED)
    if case == "nonfinite_row":  # a failed pose warps nothing, and stays finite
        assert bool(torch.isfinite(got).all()) and torch.equal(got[1], black.expand_as(got[1]))
    if case == "invisible":  # a row with nothing visible at the destination is black
        assert torch.equal(got[2], black.expand_as(got[2]))
    if case == "small_plane":  # planes spanning under 96 crop pixels: the paste shrinks
        span = (args[3][..., 0].amax(-1) - args[3][..., 0].amin(-1)) * 256 / args[6].w[:, None]
        assert float(span.max()) < 96


def _opcheck_args():
    spec, (table, sw, sp, dp, sv, dv, dw, ti) = _case("exact")
    return (table, *sw, sp, dp, sv, dv, *dw, ti)


@pytest.mark.parametrize("res", [8, 32])
def test_plane_warp_fake_matches_real(res):
    """``torch.library.opcheck`` at a 32^2 crop (the CPU kernel takes any): the schema,
    the autograd registration, the fake's shapes, dtypes and strides against the real
    call, and a trace with dynamic shapes; at a reduced grid and at the crop's."""
    torch.library.opcheck(torch.ops.fusg.plane_warp.default, (*_opcheck_args(), res, 32, True))


@pytest.mark.parametrize("device", ["meta"])
def test_plane_warp_refuses_other_devices(device):
    spec, args = _case("exact")
    moved = [a.map(lambda f: f.to(device)) if isinstance(a, cr.Window) else a.to(device)
             for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        stages.warp_planes_to_crop(spec, *moved)


# ---------------------------------------------------------------------------
# On the card: W1 against the plain warp on the same CUDA tensors.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _on(device, args):
    return tuple(a.map(lambda f: f.to(device)) if isinstance(a, cr.Window) else a.to(device)
                 for a in args)


def _kernel_and_plain(spec, args):
    before = plane_warp.LAUNCHES
    got = stages.warp_planes_to_crop(spec, *args)
    torch.cuda.synchronize()
    assert plane_warp.LAUNCHES == before + 1
    return got, _plain(spec, args)


@pytest.mark.chip
@pytest.mark.parametrize("case", CPU_CASES)
def test_kernel_matches_plain_synthetic(card, case):
    spec, args = _case(case)
    got, want = _kernel_and_plain(spec, _on(card, args))
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    if case == "nonfinite_row":
        assert bool(torch.isfinite(got).all())


def scene_warp_args(spec, v, hw, device, seed=0):
    """The arguments ``runner.scene_geometry`` hands ``stages.warp_planes_to_crop`` in
    the bench scene (random-init perception, P1's poses), captured on ``device``."""
    from future_urban_scene_generation_tpu_torch.pipeline import runner, synthetic

    sc = synthetic.make_bench_scene(V=v, hw=hw, t_steps=6, device=device, spec=spec,
                                    seed=seed)
    calls = []
    real = stages.warp_planes_to_crop

    def spy(*a):
        calls.append(a)
        return real(*a)

    stages.warp_planes_to_crop = spy
    try:
        with torch.no_grad():
            per = stages.perceive(sc.models, spec, sc.frame, sc.bboxes)
            runner.scene_geometry(sc.cad_bank, sc.frame, per, sc.meters, sc.intrinsic, spec=spec)
    finally:
        stages.warp_planes_to_crop = real
    return calls[0][0], calls[0][1:]


def datagen_warp_args(device, batch=8, seed=0):
    """The arguments ``datagen.icn_pairs`` hands the warp for a batch of ICN pairs."""
    from future_urban_scene_generation_tpu_torch.pipeline import datagen, synthetic

    sc = synthetic.make_bench_scene(V=1, hw=(720, 1280), t_steps=2, device=device,
                                    spec=ModelSpec(), seed=seed, with_models=False)
    calls = []
    real = stages.warp_planes_to_crop

    def spy(*a):
        calls.append(a)
        return real(*a)

    stages.warp_planes_to_crop = spy
    try:
        datagen.icn_batch(torch.Generator().manual_seed(seed), sc.cad_bank, sc.frame,
                          sc.intrinsic, batch=batch)
    finally:
        stages.warp_planes_to_crop = real
    return calls[0][0], calls[0][1:]


CARD_SCENES = {
    "bf16_1080p_v4_r96": lambda dev: scene_warp_args(SERVING_SPEC, 4, (1080, 1920), dev),
    "bf16_1080p_v4_r96_dlt": lambda dev: scene_warp_args(
        SERVING_SPEC.replace(quad_homography=False), 4, (1080, 1920), dev),
    "f32_720p_v4_r256": lambda dev: scene_warp_args(ModelSpec(), 4, (720, 1280), dev),
    "f32_720p_v16_r256": lambda dev: scene_warp_args(ModelSpec(), 16, (720, 1280), dev),
    "datagen_b8_r256": lambda dev: datagen_warp_args(dev),
}


@pytest.mark.chip
@pytest.mark.parametrize("case", sorted(CARD_SCENES))
def test_kernel_matches_plain_on_scenes(card, case):
    """W1 on the warps of the benchmark cells' kind of scene and of datagen's batch."""
    spec, args = CARD_SCENES[case](card)
    got, want = _kernel_and_plain(spec, args)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.chip
def test_kernel_syncs_only_in_eigh_and_launches_w1(card):
    """Under ``set_sync_debug_mode("warn")`` a warp at each grid makes the host wait only
    in the homographies' ``eigh`` (geometry/homography.py), once. The profiler files W1's
    kernels under the span open at their launch (below 256^2 the grid kernel under
    ``fusg.plane_warp.sample``, the compose kernel under ``.paste``; at 256^2 the compose
    kernel under the caller's ``fusg.plane_warp``), and repeated calls are bit-equal."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from future_urban_scene_generation_tpu_torch.utils import profiling
    from perfbench.harness import trace as ptrace

    for name, kernels in (("exact", [("compose", "fusg.plane_warp")]),
                          ("reduced", [("grid", "fusg.plane_warp.sample"),
                                       ("compose", "fusg.plane_warp.paste")])):
        spec, args = _case(name)
        args = _on(card, args)
        first = stages.warp_planes_to_crop(spec, *args)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                again = stages.warp_planes_to_crop(spec, *args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        assert [w.filename.endswith("homography.py") for w in syncs] == [True], \
            [(w.filename, w.lineno) for w in syncs]
        torch.cuda.synchronize()
        torch.testing.assert_close(again, first, rtol=0, atol=0, equal_nan=True)
        w1 = []
        for _ in range(3):  # a profiler session on the card now and then records nothing
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with profiling.trace("fusg.plane_warp"):
                    stages.warp_planes_to_crop(spec, *args)
                torch.cuda.synchronize()
            tr = ptrace.reduce(prof.profiler.kineto_results.events(), 1)
            w1 = [k for k in tr.kernels if "plane_warp_" in k.name]
            if w1:
                break
        # Each launch is filed under the span open where it began, as the benchmark's
        # readers (plane_warp.launches, plane_paste.device_ms) count them.
        assert [(next(p for p in ("grid", "compose") if f"plane_warp_{p}_kernel" in k.name),
                 k.span) for k in w1] == kernels, [(k.name, k.spans) for k in w1]


@pytest.mark.chip
def test_kernel_refuses_other_table_dtypes(card):
    spec, args = _case("exact")
    args = _on(card, args)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stages.warp_planes_to_crop(spec, args[0].half(), *args[1:])
