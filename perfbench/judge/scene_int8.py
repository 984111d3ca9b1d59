"""The int8 scene cells' comparison, in two parts, each against the plain reference with
the int8 tier (``reference/int8.py``) applied to its CAD classifier, hourglass and ICN:

* ``judge/scene_branches.py``'s numbers (the whole frames' and each branch's) for a
  sample of the pool scenes the window finished;
* the ICN's trunk (every layer after its stem, where all its int8 convs are) for the
  scenes whose trunk the entry kept from the window (the same sample once the window
  has finished every pool scene): the reference's trunk on the program's own stem
  activation against the program's trunk output.

Why the second part (``PERF.md`` §2): the ICN stem (kernel K2 in the program, the plain
conv here) sums in another order, and a code that rounds the other way there is carried
on by the ICN's later int8 convs, so the whole scene reads as far off the reference in
the ICN as a float ICN would. Given the program's stem activation, the trunk's codes and
sums are the reference's to the bit, and a fault in the trunk's tier shows.

Numbers of the trunk (each the worst over the judged scenes): ``icn_trunk_q90_abs``,
the 90th percentile of the absolute difference of the trunk's outputs (tanh, in
[-1, 1]); ``icn_trunk_max_abs`` and ``icn_trunk_bad05_share`` (values off by more than
0.05), readings with no limit; ``icn_judged_scenes``, the judged scenes whose trunk the
window kept.
"""
from __future__ import annotations

import contextlib

import torch

from perfbench.harness import weights
from perfbench.judge import scene, scene_branches, tf32
from perfbench.reference import int8


@contextlib.contextmanager
def on_tier(qmax):
    """Inside the block the reference's ``Models.build`` puts what it builds on the tier
    at ``qmax`` (None: left float)."""
    from perfbench.reference.pipeline.stages import Models

    real = Models.__dict__["build"]

    def build(*args, **kwargs):
        models = real.__func__(*args, **kwargs)
        int8.apply(models, qmax)
        return models

    Models.build = staticmethod(build)
    try:
        yield
    finally:
        Models.build = real


def reference_scenes(run, held: dict, indices, qmax=int8.QMAX, use_tf32: bool = False):
    """``scene.reference_scenes`` with the tier at ``qmax`` (None: the tier off, the
    float reference) and TF32 as asked."""
    with on_tier(qmax):
        yield from scene.reference_scenes(run, held, indices, use_tf32=use_tf32)


def reference_icn(run, qmax=int8.QMAX):
    """The reference's ICN with the run's seeded weights, on the tier at ``qmax``."""
    from perfbench.reference.models.icn import GResnet
    from perfbench.reference.spec import ModelSpec

    spec = ModelSpec(**run.cell.config["spec"])
    net = GResnet(input_nc=spec.icn_input_nc).eval().requires_grad_(False).to(run.device)
    net.load_state_dict(weights.seeded_state(net, run.seed, "icn", run.device))
    int8.put(net, int8.Tier(qmax), "icn")
    return net


def icn_trunks(run, held: dict, qmax=int8.QMAX):
    """Yield (pool index, the reference's ICN trunk at ``qmax`` on the program's stem
    activation) for each pool scene whose trunk the window kept."""
    net = reference_icn(run, qmax)
    with tf32(False), torch.no_grad():
        for k in sorted(held["icn"]):
            yield k, net(held["icn"][k][0], from_stem=True)


def trunk_numbers(got, ref) -> dict:
    values = (got.to(torch.float32) - ref.to(torch.float32)).abs().flatten()
    return {"icn_trunk_q90_abs": scene.q90(values),
            "icn_trunk_max_abs": float(values.max()),
            "icn_trunk_bad05_share": float((values > scene_branches.BAD).to(torch.float32)
                                           .mean())}


def judge(run, held: dict) -> dict:
    """Readings of the sampled scenes against the int8 reference; {} if none finished."""
    idx = scene.sample(run.seed, held["kept"], run.cell.cell["judge"]["scenes"])
    per_scene = [scene_branches.compare(held["kept"][k], r, scene.background(run, held, k), w)
                 for k, r, w in reference_scenes(run, held, idx)]
    trunks = [trunk_numbers(held["icn"][k][1], r) for k, r in icn_trunks(run, held)]
    readings = scene.worst(per_scene + trunks)
    readings["judged_scenes"] = float(len(per_scene))
    readings["icn_judged_scenes"] = float(len(trunks))
    return readings
