"""The port's parallel/mesh.py and sharded scene in one process, against the JAX package.

Meshes of the JAX tests' shapes (tests/test_parallel_training.py:21-38) are built on
torch's single-process "fake" process group (any world size, collectives are no-ops),
which is enough for shapes, errors and placements. The sharded scene on a real
1-rank gloo group is held against the JAX scene in tests/test_torch_pipeline.py (it
shares that file's oracle fixture and compiled JAX reference); the 4-rank cluster is
tests/test_torch_multiprocess.py.
"""
import contextlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from future_urban_scene_generation_tpu.parallel import mesh as jmesh
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu_torch.models import convert, layers
from future_urban_scene_generation_tpu_torch.models.icn import GResnet
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet
from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
from future_urban_scene_generation_tpu_torch.parallel import training as ptraining
from future_urban_scene_generation_tpu_torch.pipeline import runner, streaming
from future_urban_scene_generation_tpu_torch.pipeline.training import ICNTrainer
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import mesh as mu
import torch_threads  # noqa: F401


@contextlib.contextmanager
def group(world=1, backend="gloo"):
    """A process group of this process alone: gloo over a HashStore (1 rank), or the
    fake backend with ``world`` ranks of which this is rank 0."""
    if backend == "fake":
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_shapes():
    with group(8, "fake"):
        m = pmesh.make_mesh(data=4, model=2, device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (4, 2)
        assert tuple(pmesh.make_mesh(model=2, device_type="cpu").shape) == (4, 2)
        m3 = pmesh.make_mesh(data=2, model=2, context=2, device_type="cpu")
        assert m3.mesh_dim_names == ("data", "model", "context") and tuple(m3.shape) == (2, 2, 2)
        sub = pmesh.make_mesh(data=2, ranks=[0, 1], device_type="cpu")  # devices[:data]
        assert tuple(sub.shape) == (2, 1) and pmesh.holds_rank(sub)
        assert not pmesh.holds_rank(pmesh.make_mesh(data=2, ranks=[4, 5], device_type="cpu"))
        assert pmesh.batch_sharding(m) == (Shard(0), Replicate())
        assert pmesh.replicated(m3) == (Replicate(),) * 3
    with group():
        assert tuple(pmesh.make_mesh(device_type="cpu").shape) == (1, 1)


def test_make_mesh_errors():
    """The JAX errors (mesh.py:35-47), and no mesh without a process group."""
    with pytest.raises(RuntimeError, match="no process group"):
        pmesh.make_mesh(device_type="cpu")
    with group(8, "fake"):
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.make_mesh(model=3, device_type="cpu")
        with pytest.raises(ValueError, match="exceeds"):
            pmesh.make_mesh(data=4, model=4, device_type="cpu")
    with group():
        with pytest.raises(ValueError, match="exceeds"):
            pmesh.make_mesh(data=2, device_type="cpu")


def test_init_distributed_ordering_contract(monkeypatch):
    """A no-op without a coordinator or keywords, an error with keywords and no
    coordinator; otherwise it initializes before anything asks for a device or rank
    count (JAX mesh.py:51-66), and a second call is a no-op."""

    def forbidden(*_):
        raise AssertionError("queried before the process group was initialized")

    monkeypatch.setattr(torch.cuda, "device_count", forbidden)
    monkeypatch.setattr(dist, "get_world_size", forbidden)
    pmesh.init_distributed()
    assert not dist.is_initialized()
    with pytest.raises(TypeError, match="coordinator_address"):
        pmesh.init_distributed(world_size=1, rank=0, device_type="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pmesh.init_distributed(f"localhost:{port}", world_size=1, rank=0, device_type="cpu")
    try:
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        pmesh.init_distributed(f"localhost:{port}", world_size=1, rank=0, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _jax_tree(net):
    """The JAX network's parameter tree (shapes only) and the port's module class."""
    key = jax.random.PRNGKey(0)
    _, _, icnm, vunm = jstages.Models.modules()
    if net == "icn":
        return jax.eval_shape(lambda: icnm.init(key, jnp.zeros((1, 64, 64, 21)))), GResnet
    return jax.eval_shape(lambda: vunm.init({"params": key}, jnp.zeros((1, 128, 128, 3)),
                                            jnp.zeros((1, 128, 128, 6)), cov=0.0)), Vunet


@pytest.mark.parametrize("net", ["icn", "vunet"])
def test_param_shardings_match_jax(net):
    """For every leaf of the JAX network's tree, JAX ``param_shardings`` at (4, 2) and
    the port's make the same sharded/replicated decision, on the port's output-channel
    axis. The JAX decision crosses into the port's keys and layouts through
    ``convert``'s own name map: each sharded leaf is coded 1, 2, ... along its sharded
    axis and 0 elsewhere, a replicated leaf all 0, and the exported state dict shows
    the axis the values vary along (the weight-norm g: 1-D in JAX, (O, 1, 1, 1) here)."""
    tree, cls = _jax_tree(net)
    shardings = jmesh.param_shardings(tree, jmesh.make_mesh(data=4, model=2))

    def code(leaf, sharding):
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        shape = [1] * len(leaf.shape)
        shape[axes[0]] = leaf.shape[axes[0]]
        ramp = np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32).reshape(shape)
        return np.broadcast_to(ramp, leaf.shape).copy()

    module = cls()
    coded = convert.export_state_dict(
        jax.tree_util.tree_map(code, tree, shardings),
        {k: tuple(v.shape) for k, v in module.state_dict().items()})
    with group(8, "fake"):
        ours = pmesh.param_shardings(module, pmesh.make_mesh(data=4, model=2, device_type="cpu"))
    assert set(ours) == set(coded)
    n_sharded = 0
    for key, value in coded.items():
        varying = [d for d in range(value.ndim) if np.ptp(value, axis=d).any()]
        want = (Replicate(), Shard(varying[0])) if value.any() else (Replicate(), Replicate())
        assert len(varying) <= 1, key
        assert ours[key] == want, (key, ours[key], want)
        n_sharded += value.any()
    assert n_sharded > 0 and n_sharded < len(coded)


def test_param_shardings_rules():
    """tests/test_parallel_training.py:31-38 in the port's layouts, and the rule by
    parameter kind: a 32-channel weight-norm g stays replicated though its v shards."""
    net = torch.nn.ModuleDict({
        "conv": layers.Conv2d(16, 64, 3), "odd": layers.Conv2d(4, 7, 3, bias=False),
        "up": layers.ConvTranspose2d(64, 32, 4), "wn": layers.WNConv2d(16, 32, 3),
        "wn64": layers.WNConv2d(16, 64, 3), "fc": torch.nn.Linear(8, 64),
    })
    shard = lambda d: (Replicate(), Shard(d))  # noqa: E731
    repl = (Replicate(), Replicate())
    with group(8, "fake"):
        sh = pmesh.param_shardings(net, pmesh.make_mesh(data=4, model=2, device_type="cpu"))
        assert all(v == repl for v in pmesh.param_shardings(
            net, pmesh.make_mesh(data=8, model=1, device_type="cpu")).values())
    assert sh == {
        "conv.weight": shard(0), "conv.bias": shard(0), "odd.weight": repl,
        "up.weight": shard(1), "up.bias": repl,
        "wn.weight_g": repl, "wn.weight_v": shard(0), "wn.bias": repl,
        "wn64.weight_g": shard(0), "wn64.weight_v": shard(0), "wn64.bias": shard(0),
        "fc.weight": shard(0), "fc.bias": shard(0),
    }


def test_shard_params_refuses_a_layer_without_a_parallel_forward():
    """No hidden fallback: a sharded parameter whose layer has no tensor-parallel
    forward raises, and the module is left as it was."""
    net = torch.nn.Sequential(layers.Conv2d(16, 64, 3), layers.WNConv2d(64, 64, 3))
    with group(8, "fake"):
        with pytest.raises(NotImplementedError, match="WNConv2d"):
            pmesh.shard_params(net, pmesh.make_mesh(data=4, model=2, device_type="cpu"))
    assert net[0].weight.shape == (64, 16, 3, 3) and type(net[0]) is layers.Conv2d


def _tiny_bank():
    car, kp = mu.make_test_car(subdiv=1)
    return runner.build_cad_bank([car], [kp], device="cpu")


def test_sharded_scene_and_streams_raise():
    """No process group, V % data, a stream runner whose vehicle count does not split
    over 'data', a stream whose mesh does not hold this rank, and threaded streams
    whose meshes share a rank: each raises."""
    boxes, meters, k = torch.zeros(3, 4), torch.zeros(3, 2, 2), torch.eye(3)
    with pytest.raises(RuntimeError, match="process group"):
        runner.run_scene_sharded(None, None, None, None, boxes, meters, k, None,
                                 spec=ModelSpec())
    bank = _tiny_bank()
    with group(2, "fake"):
        mesh = pmesh.make_mesh(data=2, device_type="cpu")
        with pytest.raises(ValueError, match="3 vehicles"):
            runner.run_scene_sharded(None, bank, None, None, boxes, meters, k, mesh,
                                     spec=ModelSpec())
        with pytest.raises(ValueError, match="3 vehicles"):
            runner.synthesize_scene_sharded(None, bank, None, None, None, meters, k, mesh,
                                            spec=ModelSpec())
        with pytest.raises(ValueError, match="split evenly"):
            streaming.StreamRunner(None, bank, np.eye(3), (64, 64), 3, spec=ModelSpec(),
                                   mesh=mesh)
        there = pmesh.make_mesh(data=1, ranks=[1], device_type="cpu")
        multi = streaming.MultiStreamRunner(
            None, bank, np.eye(3), (64, 64), 2, n_streams=2, make_detector=lambda i: None,
            meshes=[mesh, there], spec=ModelSpec())
        assert multi.streams[0].mesh is mesh and multi.streams[1] is None
        with pytest.raises(ValueError, match="stream 1 is not on rank 0"):
            multi.submit_frame(1, np.zeros((64, 64, 3), np.uint8))
        assert multi.flush() == [[], []]
        with pytest.raises(ValueError, match="threaded streams 0 and 1 share rank 1"):
            streaming.MultiStreamRunner(
                None, bank, np.eye(3), (64, 64), 2, n_streams=2,
                make_detector=lambda i: None, meshes=[mesh, there], threaded=True,
                spec=ModelSpec())


def test_sharded_train_step_raises():
    """B % data, and a state that was not placed on the mesh."""
    trainer = ICNTrainer(input_nc=5, ndf=8)
    x, y = torch.zeros(3, 32, 32, 5), torch.zeros(3, 32, 32, 3)
    with group(2, "fake"):
        mesh = pmesh.make_mesh(data=2, device_type="cpu")
        state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
        with pytest.raises(ValueError, match="shard_state"):
            ptraining.sharded_train_step(trainer, state, x, y)
        state = ptraining.shard_state(state, mesh)
        with pytest.raises(ValueError, match="3 rows"):
            ptraining.sharded_train_step(trainer, state, x, y)
