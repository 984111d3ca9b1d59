"""A module's fixed-shape serving pass as a captured CUDA graph, replayed.

A serving pass of a network at fixed shapes enqueues the same hundreds of small
operations every call (the VUNet's two passes ~1,330 a scene: each weight-normed conv
recomputes its norm, permutes and adds its bias), and while the host enqueues them the
card runs out of work. :func:`call` runs ``fn(module, *static, *args)``, a pass of
``module`` with the stage's own work around it, and, where it can, replays it as one CUDA
graph instead:

- It engages on plain CUDA tensors with grad off, and steps aside (the eager call, exactly
  as without it) on the CPU, with grad on (the trainers), under a dispatch mode, fake
  tensors, ``torch.export`` or compilation (``pipeline/aot.py`` exports the scene with
  ``strict=False``), and inside another capture.
- Its key is ``fn``, the hashable ``static`` arguments (the stage's spec), every input's
  shape, strides, dtype and device, the grad and inference modes, the int8 tier's scope,
  and the module's training flag and each parameter's and buffer's ``data_ptr`` and
  ``_version`` (a weight load or an in-place update captures anew). The cache lives with
  the module (weakly keyed) and holds :data:`MAX_KEYS` keys, the least recently used
  dropped first: service buckets and sharded ranks bring new shapes.
- A key's first call runs eagerly: it warms cuDNN's plans and the allocator. Its second
  call captures on a side stream (``capture_error_mode="thread_local"``: other threads'
  streams keep working) into the module's private memory pool, which all its graphs
  share, and replays. Later calls copy their inputs into the graph's static buffers,
  replay on the current stream and clone the outputs out, under one lock; each use waits
  on the card for the module's previous use, so streams of several threads
  (``MultiStreamRunner``) never overlap on its buffers, and a clone is the caller's own
  (the depth-2 ``StreamRunner`` holds one scene's outputs while the next is enqueued).

The replay goes through the operator ``fusg::graph_replay``: the profiler links a kernel
to the operator that launched it, and the trace files it under the spans open where that
operator began, here the caller's span and ``span`` around the copy-in, replay and
clone-out. Captures and replays count in :data:`CAPTURES` and :data:`REPLAYS`.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import weakref
from typing import Dict, List

import torch
from torch import nn
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils._pytree import tree_flatten, tree_unflatten

from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.utils import profiling

MAX_KEYS = 8  # keys a module's cache holds: the warmed ones and the captured
CAPTURES = 0  # graphs captured
REPLAYS = 0  # graph replays (a capture's own first replay included)

_LOCK = threading.Lock()  # the caches, the counters, capture and each replay
_CACHES: "weakref.WeakKeyDictionary[nn.Module, _Cache]" = weakref.WeakKeyDictionary()
_GRAPHS: Dict[int, "torch.cuda.CUDAGraph"] = {}  # the replay operator's handles
_HANDLES = itertools.count(1)
_WARM = object()  # a key called once, eagerly
# Registrations of a parameter, buffer or submodule on any module: a cache lists its
# module's tensors again after one (walking the VUNet's ~300 submodules on every call
# took ~1 ms of host time).
_REGISTRATIONS = [0]


def _registered(*_) -> None:
    _REGISTRATIONS[0] += 1


nn.modules.module.register_module_parameter_registration_hook(_registered)
nn.modules.module.register_module_buffer_registration_hook(_registered)
nn.modules.module.register_module_module_registration_hook(_registered)


@torch.library.custom_op("fusg::graph_replay", mutates_args=("outputs",))
def _replay_op(outputs: List[torch.Tensor], handle: int) -> None:
    """Replay the graph ``handle``, which writes ``outputs`` (its static outputs)."""
    _GRAPHS[handle].replay()


class _Graph:
    """One captured pass: the graph, its static input buffers and outputs (flat), and the
    cache whose pool and event it shares."""

    def __init__(self, graph, inputs, out, cache: "_Cache", device):
        self.inputs = inputs
        self.outputs, self.out_spec = tree_flatten(out)
        self.cache, self.device = cache, device
        self.handle = next(_HANDLES)
        _GRAPHS[self.handle] = graph
        weakref.finalize(self, _GRAPHS.pop, self.handle, None)

    def run(self, leaves, span: str):
        """Copy in, replay and clone out, behind the module's previous replay."""
        with profiling.trace(span), _behind(self.cache, self.device):
            for buf, x in zip(self.inputs, leaves):
                buf.copy_(x)
            _replay_op(self.outputs, self.handle)
            out = [o.clone() for o in self.outputs]
        return tree_unflatten(out, self.out_spec)


@contextlib.contextmanager
def _behind(cache: "_Cache", device: torch.device):
    """On a card: the block runs on the current stream behind the module's previous
    replay, whichever stream that was on, and its end is the module's last use."""
    if device.type != "cuda":
        yield
        return
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        stream.wait_event(cache.done)
        yield
        cache.done.record(stream)


class _Cache:
    """One module's graphs by key, the memory pool they share, the event behind the
    module's last replay, and the module's parameters and buffers."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.pool = None
        self.done = None
        self.listed, self.tensors = None, []

    def state(self, module: nn.Module):
        """Each parameter's and buffer's ``data_ptr`` and ``_version``."""
        if self.listed != _REGISTRATIONS[0]:
            self.listed = _REGISTRATIONS[0]
            self.tensors = list(itertools.chain(module.parameters(), module.buffers()))
        return tuple((t.data_ptr(), t._version) for t in self.tensors)

    def put(self, key, value) -> None:
        self.entries[key] = value
        self.entries.move_to_end(key)
        while len(self.entries) > MAX_KEYS:
            self.entries.popitem(last=False)


def _capture(cache: _Cache, fn, leaves, in_spec) -> _Graph:
    """Capture ``fn`` on static input buffers shaped as ``leaves``, allocated in the
    module's pool as the pass's activations and outputs are."""
    device = leaves[0].device
    with torch.cuda.device(device):
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
            cache.done = torch.cuda.Event()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=cache.pool, capture_error_mode="thread_local"):
            inputs = [torch.empty_like(x) for x in leaves]
            out = fn(*tree_unflatten(inputs, in_spec))
    return _Graph(graph, inputs, out, cache, device)


def _on_card(t) -> bool:
    return type(t) is torch.Tensor and t.device.type == "cuda"


def untraced() -> bool:
    """Nothing tracing, faking, compiling or capturing: eager calls run as written."""
    return (_get_current_dispatch_mode() is None and not torch.compiler.is_compiling()
            and not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()))


def _engages(leaves) -> bool:
    """Whether a call on these flattened arguments can replay: all plain CUDA tensors,
    grad off, and :func:`untraced`."""
    return (bool(leaves) and not torch.is_grad_enabled()
            and all(_on_card(t) for t in leaves) and untraced())


def _key(fn, static, module: nn.Module, cache: _Cache, leaves, in_spec):
    return (fn, static, in_spec, module.training, torch.is_inference_mode_enabled(),
            layers.quantization_active(),
            tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in leaves),
            cache.state(module))


def call(fn, module: nn.Module, *args, span: str, static: tuple = ()):
    """``fn(module, *static, *args)``, replayed from a CUDA graph where it engages
    (module docstring). ``fn``: a function of the module's pass (its identity is part of
    the key); ``static``: hashable arguments that are not tensors; ``args``: tensors, or
    lists and named tuples of them, and so is the result; ``span``: the name of the span
    around each replay."""
    global CAPTURES, REPLAYS
    leaves, in_spec = tree_flatten(args)
    if not _engages(leaves):
        return fn(module, *static, *args)
    run = lambda *a: fn(module, *static, *a)  # noqa: E731
    with _LOCK:
        cache = _CACHES.get(module)
        if cache is None:
            cache = _CACHES[module] = _Cache()
        key = _key(fn, static, module, cache, leaves, in_spec)
        entry = cache.entries.get(key)
        if entry is None:
            cache.put(key, _WARM)
        else:
            if entry is _WARM:
                entry = _capture(cache, run, leaves, in_spec)
                CAPTURES += 1
            cache.put(key, entry)
            out = entry.run(leaves, span)
            REPLAYS += 1
            return out
    return run(*args)
