"""Device mesh construction, sharding placements and the tensor-parallel layers.

Counterpart of the JAX package's parallel/mesh.py (``make_mesh`` :24,
``init_distributed`` :51, ``batch_sharding`` / ``replicated`` :69-74,
``param_shardings`` :83, ``shard_params`` :105). Axes, as there:

* ``data`` — batch / vehicles: each rank takes its contiguous share; results are
  all-gathered (the sharded scene) or gradients averaged (the sharded train step);
* ``model`` — channel (tensor) parallelism: a sharded conv or linear layer computes
  its own output-channel slice, and the slices are gathered over 'model'.

The JAX runtime is single-controller per host: one process drives every device and
XLA inserts the collectives. ``torch.distributed`` is multi-controller: one process
per device, as ``jax.distributed`` across hosts, so each process takes its own share
and calls the collectives itself. A mesh is a ``DeviceMesh``; placements are
``torch.distributed.tensor`` placements. DTensor dispatch is not used: its
convolution rule takes the output's placement from the input alone and ignores a
weight sharded on its output channels, so the tensor-parallel layers here are
explicit (the local weight slice, then a gather of the channels).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from future_urban_scene_generation_tpu_torch.models import icn, layers


def make_mesh(data: int = -1, model: int = 1, context: int = 1, *, device_type: str,
              ranks: Optional[Sequence[int]] = None) -> DeviceMesh:
    """Build a (data, model[, context]) mesh over ``ranks`` (default: every rank of
    the initialized process group). ``data=-1`` takes the remaining ranks. Every rank
    of the world must call this with the same arguments (the axes' process groups are
    made collectively); a rank outside ``ranks`` gets a mesh that does not hold it.

    The 'context' axis is reserved, as in the JAX package, for sequence parallelism
    of attention-based generators; with ``context=1`` the mesh stays 2-axis."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialized; call "
                           "init_distributed first (one process per device)")
    ranks = list(range(dist.get_world_size())) if ranks is None else [int(r) for r in ranks]
    n = len(ranks)
    per_replica = model * context
    if data == -1:
        if n % per_replica:
            raise ValueError(f"{n} ranks not divisible by model*context={per_replica}")
        data = n // per_replica
    if data * per_replica > n:
        raise ValueError(f"mesh {data}x{model}x{context} exceeds {n} ranks")
    if context > 1:
        shape, names = (data, model, context), ("data", "model", "context")
    else:
        shape, names = (data, model), ("data", "model")
    grid = torch.tensor(ranks[: data * per_replica], dtype=torch.int).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def init_distributed(coordinator_address: Optional[str] = None, **kwargs) -> None:
    """Join the process group: ``init_process_group`` over ``tcp://`` at
    ``coordinator_address`` ("host:port") with ``world_size`` and ``rank`` from
    ``kwargs``, and the backend of ``device_type`` ("cpu": gloo, "cuda": nccl). A
    no-op with no coordinator and no keywords (an explicit single process) and when a
    group is already initialized.

    Ordering contract (JAX mesh.py:51-66): this runs before anything that asks how
    many devices or ranks there are, so it only reads ``dist.is_initialized()`` and
    never calls ``torch.cuda.device_count()`` or ``dist.get_world_size()`` itself."""
    if coordinator_address is None and not kwargs:
        return
    if dist.is_initialized():
        return
    if coordinator_address is None:
        raise TypeError("init_distributed: keywords given without a coordinator_address")
    kwargs = dict(kwargs)
    device_type = kwargs.pop("device_type", None)
    if device_type not in ("cpu", "cuda"):
        raise TypeError("init_distributed: pass device_type='cpu' or 'cuda'")
    backend = "nccl" if device_type == "cuda" else "gloo"
    init_method = (coordinator_address if coordinator_address.startswith("tcp://")
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def _placements(mesh: DeviceMesh, axis: str, dim: Optional[int]) -> Tuple:
    """``Shard(dim)`` on ``axis`` (``dim`` None: nowhere), ``Replicate()`` on the
    mesh's other axes. (Imported here: ``torch.distributed.tensor`` takes about a
    second to import, and the scene path never needs it.)"""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if n == axis and dim is not None else Replicate()
                 for n in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh) -> Tuple:
    """Leading-axis data sharding for batches (B, ...): ``Shard(0)`` on 'data'."""
    return _placements(mesh, "data", 0)


def replicated(mesh: DeviceMesh) -> Tuple:
    return _placements(mesh, "data", None)


# ---------------------------------------------------------------------------
# Axes of a mesh from this rank's point of view
# ---------------------------------------------------------------------------


def _axis_dim(mesh: DeviceMesh, axis: str) -> int:
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {axis!r}: {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(_axis_dim(mesh, axis))


def holds_rank(mesh: DeviceMesh) -> bool:
    """Whether this process's rank is in ``mesh``."""
    return mesh.get_coordinate() is not None


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return coord[_axis_dim(mesh, axis)]


def axis_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """This rank's contiguous share of ``n`` rows split over ``axis``. Shares must be
    equal (the mean of the per-rank means is the global mean only then), so ``n``
    must divide, as a JAX ``device_put`` with ``P(axis)`` requires."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over the mesh axis {axis!r} of "
                         f"size {size}")
    k = n // size
    i = axis_index(mesh, axis)
    return slice(i * k, (i + 1) * k)


class _Axis:
    """The process group of this rank's line along one mesh axis, the group rank of
    each coordinate of that line in order, and this rank's coordinate."""

    def __init__(self, mesh: DeviceMesh, axis: str):
        d = _axis_dim(mesh, axis)
        self.index = axis_index(mesh, axis)
        line = list(mesh.get_coordinate())
        line[d] = slice(None)
        self.group = mesh.get_group(d)
        self.order = [dist.get_group_rank(self.group, int(r))
                      for r in mesh.mesh[tuple(line)].tolist()]


class _Gather(torch.autograd.Function):
    """All-gather over an axis, concatenated along ``dim`` in coordinate order. The
    backward is this rank's own slice of the gradient, not the sum over the group
    that ``torch.distributed.nn.functional.all_gather`` takes: the gathered tensor
    feeds computation replicated over the axis, so every rank already holds the whole
    gradient, and a sum would make each sharded gradient ``size`` times too large."""

    @staticmethod
    def forward(ctx, t, axis: _Axis, dim: int):
        ctx.slice = (dim, axis.index * t.shape[dim], t.shape[dim])
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(wire) for _ in axis.order]
        dist.all_gather(parts, wire, group=axis.group)
        out = torch.cat([parts[g] for g in axis.order], dim)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(*ctx.slice), None, None


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward all-reduces (sums) the gradient over an axis. The
    input of a tensor-parallel layer is replicated over 'model' and each rank's
    slice of output channels contributes its own part of that input's gradient."""

    @staticmethod
    def forward(ctx, t, axis: _Axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


def gather_axis(t: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in coordinate
    order (differentiable: the backward is this rank's slice)."""
    return _Gather.apply(t, _Axis(mesh, axis), dim)


def mean_over_axis(t: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis`` (one all-reduce)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_Axis(mesh, axis).group)
    return out / axis_size(mesh, axis)


# ---------------------------------------------------------------------------
# Parameter placements
# ---------------------------------------------------------------------------

# (module type, parameter name) -> the kernel's output-channel axis in the port's
# layout: OIHW convs 0, (in, out, kh, kw) transposed convs 1, weight-norm v 0.
_KERNEL_AXIS = {
    (layers.Conv2d, "weight"): 0,
    (layers.ConvTranspose2d, "weight"): 1,
    (layers.WNConv2d, "weight_v"): 0,
    (layers.SNConv2d, "weight_orig"): 0,
    (layers.SNConvTranspose2d, "weight_orig"): 1,
}
# The JAX rule's threshold for per-channel vectors and linear kernels (mesh.py:97-100).
MIN_SHARDED_VECTOR = 64


def _model_axis(module: nn.Module, name: str, p: torch.Tensor, model: int) -> Optional[int]:
    """The axis a parameter shards on over a 'model' axis of ``model`` ranks, or None
    (replicated): the JAX rule (mesh.py:83-102) by parameter kind, in the port's
    layouts. Conv kernels shard their output channels when divisible; linear kernels
    (JAX (in, out), here (out, in)) and per-channel vectors (biases, norm scales and
    shifts, the weight-norm g: 1-D in JAX, (O, 1, 1, 1) here) when also >= 64."""
    if model == 1:
        return None
    kernel_axis = _KERNEL_AXIS.get((type(module), name))
    if kernel_axis is not None:
        return kernel_axis if p.shape[kernel_axis] % model == 0 else None
    if (isinstance(module, nn.Linear) and name == "weight") or p.dim() == 1 or \
            (isinstance(module, layers.WNConv2d) and name == "weight_g"):
        n = p.shape[0]
        return 0 if n % model == 0 and n >= MIN_SHARDED_VECTOR else None
    return None


def _sharded_layers(module: nn.Module, model: int):
    """(prefix, layer, {parameter name: axis}) for each layer of ``module`` with a
    parameter that shards over a 'model' axis of ``model`` ranks."""
    for prefix, m in module.named_modules():
        axes = {name: _model_axis(m, name, p, model)
                for name, p in m.named_parameters(recurse=False)}
        axes = {k: a for k, a in axes.items() if a is not None}
        if axes:
            yield prefix, m, axes


def param_shardings(module: nn.Module, mesh: DeviceMesh) -> Dict[str, Tuple]:
    """Tensor-parallel placements of ``module``'s parameters, by state-dict key:
    ``Shard(axis)`` on 'model' where the JAX rule shards the parameter (see
    :func:`_model_axis`), ``Replicate()`` everywhere else. With model=1 everything is
    replicated."""
    out = {k: replicated(mesh) for k, _ in module.named_parameters()}
    for prefix, _, axes in _sharded_layers(module, axis_size(mesh, "model")):
        for name, axis in axes.items():
            out[f"{prefix}.{name}" if prefix else name] = _placements(mesh, "model", axis)
    return out


# ---------------------------------------------------------------------------
# Tensor-parallel layers
# ---------------------------------------------------------------------------


def _channel_parallel(layer: nn.Module, fn, x):
    """``fn(x, weight, bias)`` of a layer whose weight holds this rank's output
    channels: the local channels (with the bias where it is sharded too), gathered
    over 'model' on the last axis, then the bias where it is replicated."""
    axis, bias = layer.model_axis, layer.bias
    bias_sharded = bias is not None and getattr(bias, "model_dim", None) is not None
    if x.requires_grad:
        x = _SumGrad.apply(x, axis)
    y = _Gather.apply(fn(x, layer.weight, bias if bias_sharded else None), axis, -1)
    return y if bias is None or bias_sharded else y + bias.to(y.dtype)


def _gathered(layer: nn.Module, p: torch.Tensor) -> torch.Tensor:
    dim = getattr(p, "model_dim", None)
    return p if dim is None else _Gather.apply(p, layer.model_axis, dim)


class _ParallelConv2d(layers.Conv2d):
    def forward(self, x):
        return _channel_parallel(self, lambda x, w, b: layers.conv_nhwc(
            x, w, b, self.stride, self.padding, self.dilation), x)


class _ParallelLinear(nn.Linear):
    def forward(self, x):
        return _channel_parallel(self, F.linear, x)


class _ParallelUpConv2dBlock(icn.UpConv2dBlock):
    def forward(self, x):
        return self._post(_channel_parallel(self.conv, layers.upconv2x_nearest_reflect, x))


class _ParallelLayerNorm(layers.WarpLearnLayerNorm):
    def forward(self, x):
        return self.affine(self.normalize(x), _gathered(self, self.gamma),
                           _gathered(self, self.beta))


# Layers that hold a sharded parameter -> their tensor-parallel forward. A conv or
# linear layer shards its bias only where its weight is sharded (the bias's rule is
# the stricter one), so channel parallelism is keyed on the weight.
_PARALLEL = {
    layers.Conv2d: _ParallelConv2d,
    nn.Linear: _ParallelLinear,
    layers.WarpLearnLayerNorm: _ParallelLayerNorm,
}


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Place ``module``'s parameters by :func:`param_shardings`, in place: a sharded
    parameter keeps this rank's slice along its axis (recorded as ``p.model_dim``),
    and each layer that holds one computes on it (a conv or linear layer its output
    channels, gathered over 'model'; the ICN's layer norm gathers its sharded scale
    and shift). Raises, before changing anything, for a layer that would hold a
    sharded parameter and has no tensor-parallel forward here. With model=1 nothing
    changes. Returns ``module``."""
    size = axis_size(mesh, "model")
    plan = list(_sharded_layers(module, size))
    for prefix, m, axes in plan:
        if type(m) not in _PARALLEL:
            raise NotImplementedError(f"{prefix or type(m).__name__}: a {type(m).__name__} "
                                      f"with sharded {sorted(axes)} has no tensor-parallel "
                                      "forward")
    if not plan:
        return module
    axis = _Axis(mesh, "model")
    for _, m, axes in plan:
        for name, dim in axes.items():
            p = getattr(m, name)
            k = p.shape[dim] // size
            p.data = p.data.narrow(dim, axis.index * k, k).clone()
            p.model_dim = dim
        m.model_axis = axis
        m.__class__ = _PARALLEL[type(m)]
    for m in module.modules():
        if type(m) is icn.UpConv2dBlock and hasattr(m.conv, "model_axis"):
            m.__class__ = _ParallelUpConv2dBlock
    return module


def gather_param(p: torch.Tensor, mesh: DeviceMesh, value: Optional[torch.Tensor] = None):
    """The whole of a parameter placed by :func:`shard_params` (or of ``value``, a
    tensor of its local shape such as its gradient), gathered over 'model'."""
    t = p if value is None else value
    dim = getattr(p, "model_dim", None)
    return t.detach() if dim is None else _Gather.apply(t.detach(), _Axis(mesh, "model"), dim)
