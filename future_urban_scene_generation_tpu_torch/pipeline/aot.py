"""Ahead-of-time scene programs: a restarting service serves an exported program.

Counterpart of the JAX package's pipeline/aot.py (``export_program`` :73,
``load_program`` :129, ``export_run_scene`` :175, ``lookup_run_scene`` :191), on
``torch.export``: warm-up traces the scene once and saves the graph of ATen and
``fusg::`` operators (the kernels K1, K2 and the int8 tier's N3 + N2, the PnP solve,
kernel P1 on the card, and the plane warp, kernel W1: ops/cuda_raster.py,
ops/cuda_conv.py, geometry/pnp.py, render/plane_warp.py) to
``<key>.pt2``;
a restarted service loads it and runs it without tracing the Python scene.

- Programs are exported FLAT, as in the JAX module: the argument tree (``Models``,
  ``CadBank``, tensors) is flattened to a tuple of tensor leaves, an ``nn.Module``
  giving its parameters and buffers (swapped in by ``torch.func.functional_call``),
  so the artifact holds the program and not the weights. Outputs are a leaf tuple;
  the loader rebuilds ``runner.SceneResult``.
- The export runs inside one outer ``torch.no_grad()``: the runner's own
  ``@torch.no_grad()`` stages then trace to plain ATen nodes, where a grad-mode
  switch inside the trace leaves nodes that ``torch.export.load`` refuses.
- The key covers everything that shapes the traced program: the format, ``kind``,
  torch's version, the device type (on CUDA also the CUDA version and the device's
  capability), the kernel sources' digest, every leaf's shape, dtype and device
  type, and ``static`` (``vis_res`` and the frozen ``ModelSpec``: the int8 tier, the
  generator dtype and the warp resolution reach the key). A stale artifact is
  unreachable, not wrong; a CPU artifact never serves a CUDA request.

Unlike the JAX module, restoring has no CPU gate: that gate works around an XLA:CPU
fault, and a restored program of the port runs the same operators on any device.
"""
from __future__ import annotations

import hashlib
import os
import threading
import warnings
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils import _pytree as pytree

from future_urban_scene_generation_tpu_torch.ops import _kernels
# The scene's modules register the fusg:: operators an artifact's graph names, which
# torch.export.load must find.
from future_urban_scene_generation_tpu_torch.pipeline import runner

_FORMAT_VERSION = 1


def _device_key(leaves) -> str:
    devices = {t.device for t in leaves}
    if len({d.type for d in devices}) > 1:
        raise ValueError(f"an exported program takes tensors of one device type, got "
                         f"{sorted(str(d) for d in devices)}")
    device = next(iter(devices))
    if device.type == "cuda":
        return f"cuda|{torch.version.cuda}|{torch.cuda.get_device_capability(device)}"
    return device.type


def _artifact_key(kind: str, leaves, static: tuple) -> str:
    """Filename-safe digest of everything that shapes the traced program."""
    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION}|{kind}|{torch.__version__}|{_device_key(leaves)}|".encode())
    h.update(f"{_kernels._digest()}|".encode())
    for leaf in leaves:
        h.update(f"{tuple(leaf.shape)}{leaf.dtype}{leaf.device.type}|".encode())
    h.update(repr(static).encode())
    return f"{kind}-{h.hexdigest()[:20]}"


class _Weights(nn.Module):
    """The argument tree's modules under one root, so that ``functional_call`` swaps
    the weights of all of them for the program's inputs around one call."""

    def __init__(self, modules):
        super().__init__()
        self.mods = nn.ModuleList(modules)

    def forward(self, call):
        return call()


def _is_module(x) -> bool:
    return isinstance(x, nn.Module)


def _flatten(args: tuple):
    """(tensor leaves, weight names, top-level leaves, tree spec) of an argument
    tree: the modules' parameters and buffers in named order, then the tree's tensor
    leaves in tree order."""
    top, spec = pytree.tree_flatten(args, is_leaf=_is_module)
    weights = _Weights([m for m in top if _is_module(m)])
    names, leaves = [], []
    for name, t in (*weights.named_parameters(), *weights.named_buffers()):
        names.append(name)
        leaves.append(t)
    for leaf in top:
        if _is_module(leaf):
            continue
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"an exported program takes tensors and modules, got "
                            f"{type(leaf).__name__}")
        leaves.append(leaf)
    return leaves, names, weights, top, spec


class _FlatProgram(nn.Module):
    """``fn`` over the flat leaves. The weights' owner is kept off the module tree
    (``object.__setattr__``) so that the export lifts no weight into the artifact."""

    def __init__(self, fn, names, weights, top, spec):
        super().__init__()
        object.__setattr__(self, "_weights", weights)
        self._fn, self._names, self._top, self._spec = fn, names, top, spec

    def forward(self, *flat):
        state = dict(zip(self._names, flat))
        rest = iter(flat[len(self._names):])
        args = pytree.tree_unflatten(
            [m if _is_module(m) else next(rest) for m in self._top], self._spec)
        out = torch.func.functional_call(self._weights, state, (lambda: self._fn(*args),))
        return tuple(pytree.tree_leaves(out))


def export_program(fn: Callable, example_args: tuple, *, kind: str, static: tuple = (),
                   directory: os.PathLike) -> Path:
    """Trace ``fn(*example_args)`` once with ``torch.export`` and save it under
    ``directory``. ``fn`` takes the argument tree (tensors, NamedTuples of them,
    modules) and returns any tree of tensors; ``static`` is extra key material that
    ``fn`` closes over (``vis_res``, the spec). Returns the artifact's path.
    Idempotent: an existing artifact of the same key is left untouched."""
    leaves, names, weights, top, spec = _flatten(tuple(example_args))
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / (_artifact_key(kind, leaves, static) + ".pt2")
    if path.exists():
        return path
    program = _FlatProgram(fn, names, weights, top, spec)
    with torch.no_grad():
        exported = torch.export.export(program, tuple(leaves), strict=False)
    exported.example_inputs = None  # the example inputs hold the weights: not saved
    # A tmp name of this writer's own: os.replace publishes whole files only, and two
    # exporters of one key each write theirs (the last one wins).
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        torch.export.save(exported, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


# (path, mtime_ns) -> the loaded program: a request reuses the module a process
# loaded, and rewritten bytes (a new mtime) load anew.
_LOADED: dict = {}
_LOADED_LOCK = threading.Lock()


def load_program(path: os.PathLike,
                 out_unflatten: Callable[[Sequence], object] = tuple) -> Optional[Callable]:
    """Restore an exported program: returns ``run(*args) -> out``, or ``None`` with a
    ``UserWarning`` when the artifact cannot be read or deserialized (a truncated
    write, foreign bytes): the caller serves the live path instead. ``run`` flattens
    its arguments as the export did and rebuilds the output with ``out_unflatten``
    from the flat leaf tuple; ``run.module`` is the restored graph module. A restored
    program whose operator fails at run time raises; it does not fall back."""
    path = Path(path)
    cache_key = (str(path), path.stat().st_mtime_ns)
    with _LOADED_LOCK:
        module = _LOADED.get(cache_key)
        if module is None:
            try:
                module = torch.export.load(path).module()
            except Exception as e:  # noqa: BLE001 - any bad artifact is a miss
                warnings.warn(f"AOT artifact {path.name} failed to deserialize "
                              f"({type(e).__name__}: {e}); falling back to the live path")
                return None
            _LOADED[cache_key] = module

    def run(*args):
        with torch.no_grad():
            return out_unflatten(module(*_flatten(tuple(args))[0]))

    run.module = module
    return run


# ----------------------------------------------------------------------------
# The scene program SceneService serves.


def _scene_static(spec, vis_res: int) -> tuple:
    return (int(vis_res), spec)


def export_run_scene(models, cad_bank, frame, background, bboxes, meter_coords, intrinsic,
                     *, spec, vis_res: int, directory) -> Path:
    """Export ``runner.run_scene`` (perception included) at these arguments' shapes."""
    def fn(m, cb, f, bg, bb, mc, k):
        return runner.run_scene(m, cb, f, bg, bb, mc, k, spec=spec, vis_res=vis_res)

    return export_program(
        fn, (models, cad_bank, frame, background, bboxes, meter_coords, intrinsic),
        kind="run_scene", static=_scene_static(spec, vis_res), directory=directory)


def lookup_run_scene(models, cad_bank, frame, background, bboxes, meter_coords, intrinsic,
                     *, spec, vis_res: int, directory) -> Optional[Callable]:
    """``run(models, cad_bank, frame, background, bboxes, meter_coords, intrinsic) ->
    SceneResult`` from the artifact of these arguments' shapes, ``spec`` and
    ``vis_res`` under ``directory``; None when there is none (or it does not load)."""
    leaves = _flatten((models, cad_bank, frame, background, bboxes, meter_coords,
                       intrinsic))[0]
    path = Path(directory) / (
        _artifact_key("run_scene", leaves, _scene_static(spec, vis_res)) + ".pt2")
    if not path.exists():
        return None
    return load_program(path, out_unflatten=lambda outs: runner.SceneResult(*outs))
