"""A GAN train step under a (data, model) mesh.

The port's counterpart of ``jax.jit(trainer.train_step)`` over a state placed by
``param_shardings`` and a batch placed by ``batch_sharding`` (the JAX package's
tests/test_parallel_training.py:59-83). Under torch's one process per device:

* 'data': each rank takes its ``B / data`` samples and runs the trainer's own step on
  them; before each Adam update the gradients are averaged over the 'data' group
  (one all-reduce an optimizer, through a step pre-hook), so every update is the
  global batch's. The networks normalize per sample (instance norm, the ICN's layer
  norm), so nothing else needs syncing.
* 'model': ``mesh.shard_params`` makes each sharded conv compute its own output
  channels, gathered over 'model'; Adam is elementwise and runs on the local slices.

    state = shard_state(trainer.init(gen, device=dev), mesh)
    state, metrics = sharded_train_step(trainer, state, inputs, targets)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
from future_urban_scene_generation_tpu_torch.pipeline.training import GANTrainState


@dataclasses.dataclass
class ShardedTrainState(GANTrainState):
    """A :class:`GANTrainState` placed on ``mesh`` by :func:`shard_state`: its networks
    hold their local parameter slices, and its optimizers average their gradients
    over 'data' before each update."""

    mesh: DeviceMesh = None


def average_gradients(params, mesh: DeviceMesh) -> None:
    """Average the gradients of ``params`` over the mesh's 'data' axis, in place, with
    one all-reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.get_group("data"))
    flat /= pmesh.axis_size(mesh, "data")
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def shard_state(state: GANTrainState, mesh: DeviceMesh) -> ShardedTrainState:
    """Place ``state`` on ``mesh``, in place: each network's parameters by
    ``mesh.shard_params`` (with the Adam moments of a sharded parameter sliced
    alike), and a step pre-hook on each optimizer that averages its gradients over
    'data'. Every rank must start from the same state (the same seed)."""
    for net, opt in ((state.gen, state.gen_opt), (state.dis, state.dis_opt)):
        pmesh.shard_params(net, mesh)
        for p in net.parameters():
            dim = getattr(p, "model_dim", None)
            for key, v in opt.state.get(p, {}).items():
                if dim is not None and torch.is_tensor(v) and v.dim() == p.dim():
                    k = p.shape[dim]
                    opt.state[p][key] = v.narrow(dim, pmesh.axis_index(mesh, "model") * k,
                                                 k).clone()

        def hook(optimizer, args, kwargs):
            average_gradients([p for g in optimizer.param_groups for p in g["params"]], mesh)

        opt.register_step_pre_hook(hook)
    return ShardedTrainState(state.gen, state.dis, state.gen_opt, state.dis_opt,
                             state.iteration, mesh)


def sharded_train_step(trainer, state: ShardedTrainState, inputs, targets
                       ) -> Tuple[ShardedTrainState, Dict[str, torch.Tensor]]:
    """``trainer.train_step`` on this rank's ``B / data`` samples of the global batch
    ``inputs`` / ``targets`` (every rank passes the whole batch), for a state placed
    on its mesh by :func:`shard_state`. Returns the state and the global batch's
    losses (0-d tensors, the mean over 'data' of the ranks' losses: one all-reduce)."""
    if not isinstance(state, ShardedTrainState):
        raise ValueError("sharded_train_step: the state is not placed on a mesh; "
                         "call shard_state(state, mesh) first")
    mesh = state.mesh
    rows = pmesh.axis_rows(inputs.shape[0], mesh, "data")
    state, metrics = trainer.train_step(state, inputs[rows], targets[rows])
    names = sorted(metrics)
    mean = pmesh.mean_over_axis(torch.stack([metrics[k] for k in names]), mesh, "data")
    return state, dict(zip(names, mean.unbind()))
