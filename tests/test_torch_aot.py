"""The port's ahead-of-time scene programs (pipeline/aot.py, on ``torch.export``) case
for case against tests/test_aot.py, and the ``fusg::`` operators under them.

The toy program goes through the JAX ``aot`` and the port's on the same numpy inputs.
The scene's parts are each exported and restored bit-equal to their live calls: PnP
through ``fusg::pnp_jacobian``, the generators and the composite through
``fusg::icn_stem_conv``, a render through ``fusg::rasterize_corners`` and an int8-tier
conv through ``fusg::conv_int8_quantized``. Exporting PnP's 52 unrolled iterations
takes about a minute on a CPU (20,000 graph nodes), so the part's test cuts
``_MAX_ITERS`` to 2, four iterations (the Jacobian's operator and the loop's arithmetic
are what it holds);
the whole scene, exported once a module at the tiny shape of
tests/test_torch_pipeline.py, runs in the slow tier as the JAX package's own does
(tests/test_aot.py:145), and on the card by ``chip_smoke.py --phases aot``.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.pipeline import aot as jaot
from future_urban_scene_generation_tpu_torch.geometry import pnp
from future_urban_scene_generation_tpu_torch.geometry.projection import project_normalized
from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.ops import cuda_conv, cuda_raster
from future_urban_scene_generation_tpu_torch.pipeline import aot, runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_intra_op_threads():
    """The exports trace on the host; two threads an op keep this file from
    oversubscribing the machine beside the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_toy(d, x):
    return {"y": d["a"] @ x + d["b"], "z": jnp.sum(x) * d["b"]}


def _toy(d, x):
    return {"y": d["a"] @ x + d["b"], "z": torch.sum(x) * d["b"]}


def _toy_np():
    return {"a": np.arange(64.0, dtype=np.float32).reshape(8, 8) / 64.0,
            "b": np.arange(8.0, dtype=np.float32)}, np.linspace(0.0, 1.0, 8, dtype=np.float32)


@pytest.fixture
def toy_args():
    d, x = _toy_np()
    return {k: torch.as_tensor(v) for k, v in d.items()}, torch.as_tensor(x)


def _fusg_nodes(run):
    """Counts of the ``fusg::`` operator nodes in a restored program's graph."""
    counts = {}
    for node in run.module.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("fusg."):
            counts[name.split(".")[1]] = counts.get(name.split(".")[1], 0) + 1
    return counts


def _assert_equal_trees(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_roundtrip_matches_direct_call(tmp_path):
    """tests/test_aot.py:37: both frameworks' restored toys equal their direct calls,
    and each other at rtol 1e-6."""
    d, x = _toy_np()
    jd, jx = {k: jnp.asarray(v) for k, v in d.items()}, jnp.asarray(x)
    jrun = jaot.load_program(jaot.export_program(_jax_toy, (jd, jx), kind="toy", static=(1,),
                                                 directory=tmp_path / "jax"))
    jgot = jrun(jd, jx)
    for a, b in zip(jgot, jax.tree_util.tree_leaves(_jax_toy(jd, jx))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)

    td, tx = {k: torch.as_tensor(v) for k, v in d.items()}, torch.as_tensor(x)
    path = aot.export_program(_toy, (td, tx), kind="toy", static=(1,), directory=tmp_path)
    got = aot.load_program(path, out_unflatten=tuple)(td, tx)
    want = tuple(torch.utils._pytree.tree_leaves(_toy(td, tx)))
    assert len(got) == len(want) == len(jgot)
    _assert_equal_trees(got, want)
    for a, b in zip(got, jgot):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_export_idempotent_and_static_keyed(tmp_path, toy_args):
    d, x = toy_args
    p1 = aot.export_program(_toy, (d, x), kind="toy", static=(1,), directory=tmp_path)
    mtime = p1.stat().st_mtime_ns
    # Same key: the artifact is left untouched (concurrent warmers race benignly).
    assert aot.export_program(_toy, (d, x), kind="toy", static=(1,), directory=tmp_path) == p1
    assert p1.stat().st_mtime_ns == mtime
    # Another static tuple (a ModelSpec change): another artifact.
    p2 = aot.export_program(_toy, (d, x), kind="toy", static=(2,), directory=tmp_path)
    assert p2 != p1
    # Other leaf shapes: another artifact.
    d16 = {"a": torch.zeros(16, 16), "b": torch.zeros(16)}
    p3 = aot.export_program(_toy, (d16, torch.zeros(16)), kind="toy", static=(1,),
                            directory=tmp_path)
    assert p3 not in (p1, p2)
    assert len({p1.name, p2.name, p3.name}) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted((p1.name, p2.name, p3.name))


def test_output_pytree_reconstruction(tmp_path, toy_args):
    d, x = toy_args
    path = aot.export_program(_toy, (d, x), kind="toy", static=(), directory=tmp_path)
    run = aot.load_program(path, out_unflatten=lambda outs: dict(y=outs[0], z=outs[1]))
    out = run(d, x)
    torch.testing.assert_close(out["y"], _toy(d, x)["y"], rtol=0, atol=0)


def test_corrupt_artifact_degrades_to_none(tmp_path, toy_args):
    """A truncated or foreign artifact reports a miss (None and a warning) instead of
    raising in the request path; the restored bytes load again."""
    d, x = toy_args
    path = aot.export_program(_toy, (d, x), kind="toy", static=(), directory=tmp_path)
    good = path.read_bytes()
    try:
        path.write_bytes(good[: len(good) // 2])  # a truncated write
        with pytest.warns(UserWarning, match="falling back to the live path"):
            assert aot.load_program(path) is None
        path.write_bytes(b"not an export artifact")
        with pytest.warns(UserWarning, match="failed to deserialize"):
            assert aot.load_program(path) is None
    finally:
        path.write_bytes(good)
    run = aot.load_program(path)  # keyed by mtime: the good bytes load again
    assert run is not None and len(run(d, x)) == 2


def test_service_scene_program_dispatch(tmp_path, monkeypatch):
    """SceneService._scene_program (tests/test_aot.py:103): a hit serves the restored
    program; a miss, or no aot_dir, the live runner with the service's spec."""
    import future_urban_scene_generation_tpu_torch.pipeline as pl
    from future_urban_scene_generation_tpu_torch.pipeline.service import SceneService

    calls = {}

    class _FakeAot:
        @staticmethod
        def lookup_run_scene(*args, spec, vis_res, directory):
            calls["lookup"] = (spec, vis_res, directory)
            return calls.get("hit")

    spec = ModelSpec(warp_plane_res=96)
    monkeypatch.setattr(pl, "aot", _FakeAot(), raising=False)
    monkeypatch.setattr(runner, "run_scene", lambda *a, spec, vis_res: ("live", a, spec, vis_res))
    fake_self = SimpleNamespace(
        spec=spec, cfg=SimpleNamespace(runtime=SimpleNamespace(vis_res=96, aot_dir=None)))
    args = (1, 2, 3, 4, 5, 6, 7)
    # aot_dir unset: the live path, no lookup.
    fn = SceneService._scene_program(fake_self, args)
    assert "lookup" not in calls and fn(*args) == ("live", args, spec, 96)
    # aot_dir set, a miss: the lookup is consulted, then the live path.
    fake_self.cfg.runtime.aot_dir = tmp_path
    fn = SceneService._scene_program(fake_self, args)
    assert calls["lookup"] == (spec, 96, tmp_path) and fn(*args)[0] == "live"
    # A hit: the restored program is returned as it is.
    marker = lambda *a: "aot-result"  # noqa: E731
    calls["hit"] = marker
    assert SceneService._scene_program(fake_self, args) is marker


# ---------------------------------------------------------------------------
# The fusg:: operators: fake implementations against the real (CPU) calls.


def _raster_inputs(seed=0, r_n=2, t=20):
    g = torch.Generator().manual_seed(seed)
    screen = torch.rand(r_n, 3, 3, t, generator=g) * 30.0
    screen[:, :, 2] += 1.0
    return screen, torch.rand(r_n, 3, 3, t, generator=g)


def _opcheck_cases():
    g = torch.Generator().manual_seed(1)
    screen, colors = _raster_inputs()
    x = torch.randn(2, 8, 8, 32, generator=g)
    return {
        "rasterize_corners": (torch.ops.fusg.rasterize_corners.default,
                              (screen, colors, [32, 40], torch.tensor([True, False]))),
        "rasterize_corners_nocull": (torch.ops.fusg.rasterize_corners.default,
                                     (screen, colors, [17, 23], None)),
        "icn_stem_conv": (torch.ops.fusg.icn_stem_conv.default,
                          (torch.rand(4, 16, 16, 3, generator=g),
                           torch.rand(2, 16, 16, 3, generator=g),
                           torch.rand(4, 5, 16, 16, 3, generator=g),
                           torch.rand(7, 7, 21, 64, generator=g), 3, 2)),
        "conv_int8_quantized": (torch.ops.fusg.conv_int8_quantized.default,
                                (x, torch.randn(3, 3, 32, 48, generator=g), torch.float32,
                                 False, 2, 1, 1, 1, 1)),
        "conv_int8_quantized_transposed": (
            torch.ops.fusg.conv_int8_quantized.default,
            (x.to(torch.bfloat16),
             torch.randn(32, 32, 4, 4, generator=g).to(torch.bfloat16).permute(2, 3, 0, 1),
             torch.bfloat16, True, 1, 2, 2, 1, 2)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_kernel_ops_pass_opcheck(case):
    """``torch.library.opcheck``: the schema, the autograd registration, the fake
    implementation's shapes, dtypes and strides against the real call, and a trace
    with dynamic shapes."""
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_pnp_jacobian_op_fake_matches_real():
    """``fusg::pnp_jacobian``: the real call equals the ``jacfwd`` it wraps, bit for
    bit, and the fake implementation gives its shape, dtype and strides. ``opcheck``
    takes the autograd check only: its other checks call the kernel from a dispatch
    mode's handler, where functorch's transform cannot run (the operator's docstring)."""
    g = torch.Generator().manual_seed(2)
    args = (torch.randn(4, 6, generator=g), torch.randn(4, 12, 3, generator=g),
            torch.randn(4, 12, 2, generator=g), torch.tensor([300.0, 310.0]),
            torch.tensor([64.0, 48.0]))
    real = pnp.pnp_jacobian(*args)
    want = torch.func.vmap(torch.func.jacfwd(pnp._residual), in_dims=(0, 0, 0, None, None))(*args)
    torch.testing.assert_close(real, want, rtol=0, atol=0)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = pnp.pnp_jacobian(*(mode.from_tensor(a) for a in args))
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    torch.library.opcheck(torch.ops.fusg.pnp_jacobian.default, args,
                          test_utils=("test_autograd_registration",))


def test_wrappers_refuse_other_devices():
    """The wrappers take CPU and CUDA tensors only: a meta tensor (which the fake
    implementations would take) is refused before it reaches the operator."""
    screen, colors = (t.to("meta") for t in _raster_inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_raster.rasterize_corners(screen, colors, (8, 8))
    planes = torch.zeros(1, 5, 8, 8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_conv.icn_stem_conv(torch.zeros(1, 8, 8, 3, device="meta"),
                                torch.zeros(1, 8, 8, 3, device="meta"), planes,
                                torch.zeros(7, 7, 21, 64, device="meta"))


# ---------------------------------------------------------------------------
# The scene's parts, each exported and restored.


def _graph_has_no_grad_switch(run):
    return not any("set_grad_enabled" in str(n.target) for n in run.module.graph.nodes)


def test_pnp_part_roundtrip(tmp_path, monkeypatch):
    """``lm_pnp_batch`` at B=4 through ``fusg::pnp_jacobian``, restored bit-equal to
    the live solve; one Jacobian node an iteration."""
    monkeypatch.setattr(pnp, "_MAX_ITERS", 2)
    g = torch.Generator().manual_seed(4)
    p3 = torch.randn(4, 12, 3, generator=g)
    focals, centers = torch.tensor([300.0, 300.0]), torch.tensor([100.0, 80.0])
    tvec = torch.tensor([[0.0, 0.0, 10.0]]).repeat(4, 1)
    rvec = torch.randn(4, 3, generator=g) * 0.3
    p2 = project_normalized(p3, rvec, tvec, focals, centers) + torch.randn(4, 12, 2,
                                                                          generator=g) * 0.5
    args = (p3, p2, torch.zeros(4, 3), tvec, focals, centers)
    run = aot.load_program(aot.export_program(pnp.lm_pnp_batch, args, kind="pnp",
                                              directory=tmp_path))
    _assert_equal_trees(run(*args), pnp.lm_pnp_batch(*args))
    assert _fusg_nodes(run) == {"pnp_jacobian": pnp._MAX_ITERS + 2}
    assert _graph_has_no_grad_switch(run)


@pytest.fixture(scope="module")
def tiny_scene():
    """The tiny scene of tests/test_torch_pipeline.py:149 (V=1, 200x280, 2 steps,
    warp 96) and its live geometry."""
    spec = ModelSpec(warp_plane_res=96)
    sc = synthetic.make_bench_scene(V=1, hw=(200, 280), t_steps=2, subdiv=2, spec=spec, seed=3,
                                    device="cpu")
    per = stages.perceive(sc.models, spec, sc.frame, sc.bboxes)
    per = per._replace(cad_idx=per.cad_idx.clamp(max=sc.cad_bank.vertices.shape[0] - 1))
    geom = runner.scene_geometry(sc.cad_bank, sc.frame, per, sc.meters, sc.intrinsic,
                                 spec=spec)
    return sc, spec, per, geom


def test_generate_composite_part_roundtrip(tiny_scene, tmp_path):
    """``runner.generate`` + ``composite`` on the tiny scene's fixed geometry, through
    ``fusg::icn_stem_conv``: restored bit-equal, and the artifact holds the program,
    not the networks' weights."""
    sc, spec, per, geom = tiny_scene

    def fn(models, frame, background, geom, cad_idx):
        icn, vun = runner.generate(models, frame, geom, spec=spec)
        return runner.composite(background, geom, icn, vun, cad_idx, spec=spec)

    args = (sc.models, sc.frame, sc.background, geom, per.cad_idx)
    path = aot.export_program(fn, args, kind="generate", static=(spec,), directory=tmp_path)
    run = aot.load_program(path, out_unflatten=lambda outs: runner.SceneResult(*outs))
    got = run(*args)
    assert isinstance(got, runner.SceneResult)
    _assert_equal_trees(got, fn(*args))
    assert _fusg_nodes(run) == {"icn_stem_conv": 1}
    assert _graph_has_no_grad_switch(run)
    weight_bytes = sum(t.numel() * t.element_size() for m in sc.models
                       for t in (*m.parameters(), *m.buffers()))
    assert path.stat().st_size < 0.05 * weight_bytes, (path.stat().st_size, weight_bytes)


def test_render_part_roundtrip(tiny_scene, tmp_path):
    """One render of the tiny scene's vehicle-steps through ``fusg::rasterize_corners``,
    restored bit-equal."""
    sc, spec, per, geom = tiny_scene
    bank, n = sc.cad_bank, geom.sketches.shape[0]
    rep = lambda t: t.repeat_interleave(n, dim=0)  # noqa: E731
    ext = torch.eye(4).repeat(n, 1, 1)
    ext[:, 2, 3] = 25.0
    args = (rep(bank.vertices[:1]), rep(bank.corners[:1]), rep(bank.corner_normals[:1]), ext,
            sc.intrinsic, torch.linspace(0.0, 0.5, n), torch.zeros(n, 3), rep(bank.cullable[:1]))
    run = aot.load_program(aot.export_program(stages.render_vehicle, args, kind="render",
                                              directory=tmp_path))
    got = run(*args)
    want = torch.utils._pytree.tree_leaves(stages.render_vehicle(*args))
    _assert_equal_trees(got, want)
    assert bool((~got[1]).any()), "the render drew nothing"
    assert _fusg_nodes(run) == {"rasterize_corners": 1}


def test_int8_conv_part_roundtrip(tmp_path):
    """One conv on the int8 tier (``layers.conv_nhwc`` inside the scope the stages
    open) and one transposed conv, through ``fusg::conv_int8_quantized``, restored
    bit-equal."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 12, 12, 32, generator=g)
    w = torch.randn(48, 32, 3, 3, generator=g) * 0.1
    wt = torch.randn(48, 32, 4, 4, generator=g) * 0.1
    bias = torch.randn(48, generator=g)

    def fn(x, w, wt, bias):
        with layers.quantized_convs(True):
            y = layers.conv_nhwc(x, w, bias, stride=1, padding=1)
            return y, layers.conv_transpose_nhwc(y, wt, None, stride=2, padding=1)

    args = (x, w, wt, bias)
    run = aot.load_program(aot.export_program(fn, args, kind="int8", directory=tmp_path))
    _assert_equal_trees(run(*args), fn(*args))
    assert _fusg_nodes(run) == {"conv_int8_quantized": 2}


# ---------------------------------------------------------------------------
# The whole tiny scene (slow tier: one export and two restores take minutes on a CPU).


@pytest.fixture(scope="module")
def scene_artifact(tiny_scene, tmp_path_factory):
    sc, spec, _, _ = tiny_scene
    directory = tmp_path_factory.mktemp("aot")
    args = (sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes, sc.meters, sc.intrinsic)
    assert aot.lookup_run_scene(*args, spec=spec, vis_res=96, directory=directory) is None
    path = aot.export_run_scene(*args, spec=spec, vis_res=96, directory=directory)
    return args, directory, path


@pytest.mark.slow
def test_run_scene_lookup_misses_and_hits(tiny_scene, scene_artifact):
    """A miss before the export (the fixture), a hit after it; misses at another
    ``vis_res`` and at another spec (warp resolution, the int8 tier)."""
    _, spec, _, _ = tiny_scene
    args, directory, _ = scene_artifact
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert aot.lookup_run_scene(*args, spec=spec, vis_res=96, directory=directory)
        assert aot.lookup_run_scene(*args, spec=spec, vis_res=128, directory=directory) is None
        for other in (spec.replace(warp_plane_res=64), spec.replace(quantized_convs=True)):
            assert aot.lookup_run_scene(*args, spec=other, vis_res=96,
                                        directory=directory) is None


@pytest.mark.slow
def test_run_scene_restored_equals_live(tiny_scene, scene_artifact):
    """The restored scene equals the live ``run_scene`` at tests/test_aot.py:193's
    atol of 2e-5 (the live path is held to the JAX package by
    tests/test_torch_pipeline.py), ``cad_idx`` equal; the graph holds the kernels'
    and the Jacobian's operators and no grad-mode switch."""
    _, spec, _, _ = tiny_scene
    args, directory, _ = scene_artifact
    run = aot.lookup_run_scene(*args, spec=spec, vis_res=96, directory=directory)
    got, want = run(*args), runner.run_scene(*args, spec=spec, vis_res=96)
    assert isinstance(got, runner.SceneResult)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5, equal_nan=True)
    assert torch.equal(got.cad_idx, want.cad_idx)
    assert _fusg_nodes(run) == {"rasterize_corners": 1, "icn_stem_conv": 1,
                                "pnp_jacobian": pnp._MAX_ITERS + 2}
    assert _graph_has_no_grad_switch(run)


@pytest.mark.slow
def test_run_scene_restores_in_a_fresh_process(tiny_scene, scene_artifact, tmp_path):
    """A fresh interpreter on the CPU restores the artifact and gets the same frames:
    the port has no CPU gate (JAX aot.py:197-209)."""
    sc, spec, _, _ = tiny_scene
    args, directory, _ = scene_artifact
    want = runner.run_scene(*args, spec=spec, vis_res=96)
    out = tmp_path / "frames.pt"
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from future_urban_scene_generation_tpu_torch.pipeline import aot, synthetic\n"
        "from future_urban_scene_generation_tpu_torch.spec import ModelSpec\n"
        "spec = ModelSpec(warp_plane_res=96)\n"
        "sc = synthetic.make_bench_scene(V=1, hw=(200, 280), t_steps=2, subdiv=2, spec=spec,\n"
        "    seed=3, device='cpu')\n"
        "args = (sc.models, sc.cad_bank, sc.frame, sc.background, sc.bboxes, sc.meters,\n"
        "    sc.intrinsic)\n"
        "run = aot.lookup_run_scene(*args, spec=spec, vis_res=96, directory=sys.argv[1])\n"
        "assert run is not None, 'miss'\n"
        "res = run(*args)\n"
        "torch.save((res.frames_icn, res.frames_vunet), sys.argv[2])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code, str(directory), str(out)],
                          capture_output=True, text=True, env=env, cwd=str(REPO), timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    icn, vunet = torch.load(out)
    torch.testing.assert_close(icn, want.frames_icn, rtol=0, atol=2e-5)
    torch.testing.assert_close(vunet, want.frames_vunet, rtol=0, atol=2e-5)
