"""The int8 tier's work a scene, counted from shapes: each call of kernels N2 (the int8
conv) and N3 (its quantization), and the scene's float work beside them.

The calls are those the plain int8 reference (``reference/int8.py``) makes when its
networks run on the meta device at the cell's shapes: the CAD classifier and the
hourglass over the V crops, the ICN over the N = V x T vehicle-steps. The tier defines
the work, whatever implements it:

* N2's operations: 2 x the multiply-adds of each conv over its real channels and taps
  (an up stage at its phase-packed 3x3 x 4 C_out taps at source resolution); its bytes:
  the x codes and the weight codes read once, the float32 output written once.
* N3's bytes: x (float32) read once, its codes and the weight codes written once.
* The float FLOPs: ``torch.utils.flop_counter`` over the same forwards (the ICN's stem
  included, and the VUNet's two passes as ``flops.scene_flops`` runs them) less the
  int8 calls' operations.

Each call's bound is the larger of its operations over the int8 peak and its bytes over
the memory rate, so no implementation reads over 100% of it.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.roofline import kernels as rk

PEAK_INT8 = 1979e12  # dense int8 operations/s, H100 SXM data sheet at 700 W

# Device kernel names (as the profiler reports them, demangled).
N2_NAME = "conv_int8_wgmma_kernel"
N3_NAME = "quant_int8_kernel"


def n2_call(call) -> Tuple[float, float]:
    """(bytes, operations) of N2 on one ``reference.int8.Call``."""
    ho, wo = call.out_hw
    ops = 2.0 * call.n * ho * wo * call.o * call.k * call.k * call.c
    n_bytes = call.n * call.h * call.w * call.c + call.k * call.k * call.c * call.o \
        + 4 * call.n * ho * wo * call.o
    return float(n_bytes), ops


def n3_bytes(call) -> float:
    """Bytes of N3 on one call: x float32 read, its codes and the weight codes written."""
    x = call.n * call.h * call.w * call.c
    return float(4 * x + x + call.k * call.k * call.c * call.o)


class SceneWork:
    """One scene's int8 calls (in their order), its int8 operations and float FLOPs."""

    def __init__(self, calls, float_flops: float):
        self.calls = calls
        self.float_flops = float_flops

    @property
    def int8_ops(self) -> float:
        return sum(n2_call(c)[1] for c in self.calls)

    def n2_bound_s(self) -> float:
        return sum(rk.bound_s(*n2_call(c), PEAK_INT8) for c in self.calls)

    def n3_bound_s(self) -> float:
        return sum(n3_bytes(c) / rk.PEAK_BYTES for c in self.calls)

    def bound_s(self) -> float:
        """The scene at the peaks: its int8 operations at the int8 rate and its float
        FLOPs at the float32 rate."""
        return self.int8_ops / PEAK_INT8 + self.float_flops / rk.PEAK_F32


def _key(spec_fields: dict):
    return tuple(sorted(spec_fields.items()))


@functools.lru_cache(maxsize=None)
def _scene_work(spec_items, vehicles: int, steps: int) -> SceneWork:
    from perfbench.reference import int8
    from perfbench.reference.pipeline.stages import Models
    from perfbench.reference.spec import ModelSpec
    from perfbench.roofline import flops

    spec = ModelSpec(**dict(spec_items))
    n = vehicles * steps
    with torch.device("meta"):
        models = Models(*(m.eval().requires_grad_(False) for m in flops._networks(spec)))
        tier = int8.apply(models)
        crops = torch.empty(vehicles, 256, 256, 3)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            models.cad(crops)
            models.hourglass(crops)
            models.icn(torch.empty(n, 256, 256, spec.icn_input_nc))
            mu = models.vunet.encode_appearance(torch.empty(vehicles, 256, 256, 6))
            models.vunet.decode_shape(torch.empty(n, 256, 256, 3),
                                      [m.repeat_interleave(steps, dim=0) for m in mu])
    int8_ops = sum(n2_call(c)[1] for c in tier.calls)
    return SceneWork(list(tier.calls), float(counter.get_total_flops()) - int8_ops)


def scene_work(spec_fields: dict, vehicles: int, steps: int) -> SceneWork:
    """The int8 tier's work in one scene of a configuration's ``spec`` at V vehicles and
    T steps (made once a shape)."""
    return _scene_work(_key(spec_fields), vehicles, steps)


def cell_work(run) -> SceneWork:
    cfg, traffic = run.cell.config, run.cell.cell["traffic"]
    return scene_work(cfg["spec"], traffic["vehicles"], cfg["steps"])
