"""The port's (data, model) mesh on a real 4-rank gloo cluster on the CPU.

The counterpart of the JAX package's slow-tier tests/test_multihost_cpu.py (one
cross-process reduction, one data- plus tensor-parallel gradient against its closed
form), tests/test_sharded_inference.py (``run_scene_sharded`` equal to ``run_scene``)
and tests/test_parallel_training.py (the ICN step under a (data, model) mesh). One
``torch.multiprocessing.spawn`` of four ranks serves the whole file: each rank runs
every case with one torch thread and returns its numbers; the parent makes the
unsharded reference scene meanwhile, from the same seeded models (built once here and
handed to the ranks in shared memory).
"""
import queue as _queue
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
from future_urban_scene_generation_tpu_torch.parallel import training as ptraining
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.pipeline.training import (
    ICNTrainer,
    instance_norm_fed_biases,
)
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

WORLD = 4
SCENE_MESHES = ((2, 2), (4, 1))
STEP_MESHES = ((2, 2), (1, 4))
SPEC = ModelSpec(warp_plane_res=96)
# The ICN step of tests/test_parallel_training.py:59-83: a 5-channel generator, ndf 8,
# batch 8 at 32^2, Adam at 1e-3.
STEP_SHAPES = ((8, 32, 32, 5), (8, 32, 32, 3))
LR = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _closed_form_case(mesh):
    """tests/test_multihost_cpu.py:62-80 in the port: loss = mean((X W)^2), the batch
    over 'data' and W's output columns over 'model' (JAX (in, out) W is the port's
    (out, in) linear weight W^T). Returns (loss, sum |dL/dW|, W's placements)."""
    n, d = 8, 64
    x = torch.as_tensor((np.arange(n * d, dtype=np.float32).reshape(n, d) % 7.0) / 7.0 - 0.4)
    lin = torch.nn.Linear(d, d, bias=False)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(np.eye(d, dtype=np.float32) + 0.01).T)
    placements = pmesh.param_shardings(lin, mesh)["weight"]
    pmesh.shard_params(lin, mesh)
    y = lin(x[pmesh.axis_rows(n, mesh, "data")])
    loss = torch.mean(y * y)
    loss.backward()
    ptraining.average_gradients(lin.parameters(), mesh)
    grad = pmesh.gather_param(lin.weight, mesh, lin.weight.grad)
    return (float(pmesh.mean_over_axis(loss, mesh, "data")), float(grad.abs().sum()),
            [repr(p) for p in placements])


def _step_inputs():
    rng = np.random.RandomState(0)
    return tuple(torch.as_tensor(rng.rand(*s).astype(np.float32)) for s in STEP_SHAPES)


def _fresh_state(trainer):
    return trainer.init(torch.Generator().manual_seed(0), device="cpu")


def _step_case(trainer, mesh, ref_state, ref_metrics):
    """One sharded ICN step against the replicated one: |l_g - l_g'|, and for the
    generator the largest gradient difference over max|g| of each tensor, the largest
    |g'| of the biases that feed an instance norm (rounding noise: their gradient is
    zero in exact arithmetic), and the largest updated-weight difference where Adam's
    first step is well conditioned (|g| > 1e-5 max|g| of the tensor; below that
    g / (|g| + eps) turns a gradient at rounding-noise level into a step of up to the
    learning rate of either sign: those weights are held by the gradient bar)."""
    inputs, targets = _step_inputs()
    state = ptraining.shard_state(_fresh_state(trainer), mesh)
    state, metrics = ptraining.sharded_train_step(trainer, state, inputs, targets)
    noise = {k[len("gen."):] for k in instance_norm_fed_biases(ref_state)
             if k.startswith("gen.")}
    ref = dict(ref_state.gen.named_parameters())
    grad_err = noise_grad = weight_err = 0.0
    for name, p in state.gen.named_parameters():
        g_ref, w_ref = ref[name].grad, ref[name].detach()
        g = pmesh.gather_param(p, mesh, p.grad)
        w = pmesh.gather_param(p, mesh)
        scale = float(g_ref.abs().max())
        if name in noise:
            noise_grad = max(noise_grad, float(g.abs().max()))
            continue
        grad_err = max(grad_err, float((g - g_ref).abs().max()) / scale)
        settled = g_ref.abs() > 1e-5 * scale
        weight_err = max(weight_err, float((w - w_ref).abs()[settled].max()))
    return {"l_g": (float(metrics["l_g"]), float(ref_metrics["l_g"])),
            "grad_err": grad_err, "noise_grad": noise_grad, "weight_err": weight_err}


def _rank_main(rank, port, scene, weights, queue):
    torch.set_num_threads(1)
    models = stages.Models.build(SPEC, device="cpu")
    for net, sd in zip(models, weights):
        net.load_state_dict(sd)
    scene = scene._replace(models=models)
    pmesh.init_distributed(f"localhost:{port}", world_size=WORLD, rank=rank,
                           device_type="cpu")
    out = {}
    try:
        base = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        t = torch.as_tensor(base[2 * rank: 2 * rank + 2])
        dist.all_reduce(t)
        out["all_reduce"] = t.sum().item()

        out["closed_form"] = _closed_form_case(pmesh.make_mesh(2, 2, device_type="cpu"))

        for shape in SCENE_MESHES:
            mesh = pmesh.make_mesh(*shape, device_type="cpu")
            res = runner.run_scene_sharded(scene.models, scene.cad_bank, scene.frame,
                                           scene.background, scene.bboxes, scene.meters,
                                           scene.intrinsic, mesh, spec=SPEC)
            out[("scene", shape)] = tuple(x.numpy() for x in res)

        trainer = ICNTrainer(input_nc=STEP_SHAPES[0][-1], ndf=8, lr=LR)
        ref_state, ref_metrics = trainer.train_step(_fresh_state(trainer), *_step_inputs())
        for shape in STEP_MESHES:
            mesh = pmesh.make_mesh(*shape, device_type="cpu")
            out[("step", shape)] = _step_case(trainer, mesh, ref_state, ref_metrics)
    finally:
        queue.put((rank, out))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def cluster():
    scene = synthetic.make_bench_scene(V=4, hw=(200, 280), t_steps=2, subdiv=2, spec=SPEC,
                                       device="cpu")
    queue = mp.get_context("spawn").Queue()
    weights = [net.state_dict() for net in scene.models]
    ranks = mp.spawn(_rank_main, args=(_free_port(), scene._replace(models=None), weights,
                                       queue), nprocs=WORLD, join=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))  # beside the four one-thread ranks
    try:
        with torch.no_grad():
            ref = runner.run_scene(scene.models, scene.cad_bank, scene.frame,
                                   scene.background, scene.bboxes, scene.meters,
                                   scene.intrinsic, spec=SPEC)
    finally:
        torch.set_num_threads(threads)
    # Read the results while the ranks run: a rank's put blocks until they are read.
    results, deadline = {}, time.monotonic() + 600
    try:
        while len(results) < WORLD and time.monotonic() < deadline:
            try:
                rank, out = queue.get(timeout=1.0)
                results[rank] = out
            except _queue.Empty:
                if ranks.join(timeout=0):  # every rank exited (raises if one failed)
                    break
    finally:
        for proc in ranks.processes:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    ranks.join()  # raises if a rank failed or was killed
    assert sorted(results) == list(range(WORLD))
    return ref, results


def test_cross_process_all_reduce(cluster):
    _, results = cluster
    base = np.arange(8 * 16, dtype=np.float32)
    for out in results.values():
        assert out["all_reduce"] == float(base.sum())


def test_dp_tp_gradient_matches_closed_form(cluster):
    """Every rank holds the same loss and gradient, within rel 1e-4 of the closed form
    (tests/test_multihost_cpu.py's bars), with W sharded on its output columns."""
    _, results = cluster
    n, d = 8, 64
    x = (np.arange(n * d, dtype=np.float64).reshape(n, d) % 7.0) / 7.0 - 0.4
    y = x @ (np.eye(d) + 0.01)
    ref_loss = float((y * y).mean())
    ref_gsum = float(np.abs(2.0 / (n * d) * x.T @ y).sum())
    got = [out["closed_form"] for out in results.values()]
    assert all(g == got[0] for g in got)
    loss, gsum, placements = got[0]
    assert placements == ["Replicate()", "Shard(dim=0)"]
    assert loss == pytest.approx(ref_loss, rel=1e-4)
    assert gsum == pytest.approx(ref_gsum, rel=1e-4)


def _assert_visually_equal(ref, got, what, atol=2e-3, bad_frac=5e-3, mean_tol=1e-4):
    """tests/test_sharded_inference.py:112-140: random-init generators amplify a
    last-bit difference on a polygon-edge texel, so frames are held to a tight mean
    and a tiny share of pixels beyond ``atol``."""
    diff = np.abs(np.asarray(ref, np.float64) - np.asarray(got, np.float64))
    assert diff.mean() < mean_tol, f"{what}: mean |diff| {diff.mean():.3g}"
    frac = float((diff > atol).mean())
    assert frac < bad_frac, f"{what}: {frac:.4%} of pixels exceed {atol}"


@pytest.mark.parametrize("shape", SCENE_MESHES, ids=lambda s: f"data{s[0]}_model{s[1]}")
def test_run_scene_sharded_matches_run_scene(cluster, shape):
    """run_scene_sharded at this mesh on every rank against run_scene, at the JAX
    package's bars (tests/test_sharded_inference.py:279-285)."""
    ref, results = cluster
    for rank, out in results.items():
        frames_icn, frames_vunet, pnp_error, cad_idx = out[("scene", shape)]
        np.testing.assert_array_equal(cad_idx, ref.cad_idx.numpy())
        np.testing.assert_allclose(pnp_error, ref.pnp_error.numpy(), atol=1e-5)
        assert frames_icn.shape == (2, 200, 280, 3)
        _assert_visually_equal(ref.frames_icn, frames_icn, f"rank {rank} frames_icn")
        _assert_visually_equal(ref.frames_vunet, frames_vunet, f"rank {rank} frames_vunet")


@pytest.mark.parametrize("shape", STEP_MESHES, ids=lambda s: f"data{s[0]}_model{s[1]}")
def test_icn_step_sharded_matches_replicated(cluster, shape):
    """The ICN GAN step at this mesh against the replicated step: l_g within 1e-3
    (tests/test_parallel_training.py:82), the generator's gradients within 1e-4 of
    each tensor's max|g| (a gather whose backward sums over 'model' makes them 2x or
    4x too large: Adam's first step is blind to that scale, the gradients are not),
    the instance-norm-fed biases' gradients at rounding-noise level, and the updated
    weights within 1e-4 where Adam's first step is well conditioned."""
    _, results = cluster
    for out in results.values():
        case = out[("step", shape)]
        sharded, replicated = case["l_g"]
        assert np.isfinite(sharded)
        assert abs(sharded - replicated) < 1e-3
        assert case["grad_err"] < 1e-4, case
        assert case["noise_grad"] < 1e-5, case
        assert case["weight_err"] < 1e-4, case
