"""The training cell's comparison, in two stages. The data: the plain reference makes
the same batches from the seed (its own copy of the data pipeline and of the
generator's draws) and the program's batches are held against them. The steps: the
reference loads the same weights and takes the same first steps with a written-out
Adam on the program's batches, following the program from its own data (K1 and the
plain raster may cover a silhouette pixel differently, which the data stage judges and
which would otherwise swamp the steps' numbers); the program's losses, first gradient
and parameter changes are held against it.

Numbers:

* ``batch_mean_abs``: mean absolute difference of the generated batches (inputs and
  targets) of the judged steps; ``batch_bad_share``, the share of values off by more
  than 0.02, is a reading with no limit.
* ``loss_gap``: the largest relative gap of the first step's losses (l_d, l_g, l_l1).
  The later steps' (``loss_gap_later``, a reading with no limit) swing from seed to
  seed: Adam with beta1 = 0 moves each weight by about lr times the sign of its
  gradient, so a component within rounding of zero moves a full step either way.
* ``grad_gap``: over the parameters (leaves), the largest gap between the norm of the
  program's first gradient and the reference's, over the larger of the reference's
  norm of that leaf and the median leaf's.
* ``change_gap``: the same for each leaf's change over the judged steps, leaving out
  the leaves whose reference gradient norm is under a thousandth of the median
  leaf's (a key's bias under a norm that subtracts it: Adam moves it by round-off).
"""
from __future__ import annotations

import statistics

import torch

from perfbench.harness import weights
from perfbench.judge import tf32
from perfbench.traffic.cars import make_test_car


def reference_run(run, steps: int, use_tf32: bool = False, half: bool = False,
                  alter: bool = False, batches=None):
    """(batches it made, losses, first-gradient norms, change norms) of the reference,
    trained on ``batches`` where given (else on its own); with ``use_tf32`` computed in
    TF32 (the control); planted faults: with ``half`` trained on the first half of each
    batch, with ``alter`` each batch's first target flipped upside down where it is
    made."""
    from perfbench.reference.pipeline import datagen, runner, training

    cfg = run.cell.config
    dev = run.device
    gen = torch.Generator().manual_seed(run.seed)
    mesh, kp3d = make_test_car(subdiv=cfg["cad_subdiv"])
    bank = runner.build_cad_bank([mesh] * cfg["cads"], [kp3d] * cfg["cads"], scale=5.0,
                                 device=dev)
    h, w = cfg["frame_hw"]
    f = cfg["focal_px"]
    k_mat = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], device=dev)
    frame = torch.rand((h, w, 3), generator=gen).to(dev)
    trainer = training.ICNTrainer(input_nc=cfg["input_nc"], ndf=cfg["ndf"], lr=cfg["lr"])
    state = trainer.init(gen, device=dev)  # the draws the program's set-up takes
    for tag, net in (("gen", state.gen), ("dis", state.dis)):
        net.load_state_dict(weights.seeded_state(net, run.seed, tag, dev))
    leaves = {**{f"gen.{n}": p for n, p in state.gen.named_parameters()},
              **{f"dis.{n}": p for n, p in state.dis.named_parameters()}}
    theta0 = {n: p.detach().clone() for n, p in leaves.items()}
    made, losses = [], []
    with tf32(use_tf32):
        for i in range(steps):
            with torch.no_grad():
                made.append(tuple(datagen.icn_batch(gen, bank, frame, k_mat,
                                                    batch=run.cell.cell["traffic"]["batch"],
                                                    vis_res=192)))
                if alter:
                    made[-1][1][0] = made[-1][1][0].flip(0)
            batch = made[-1] if batches is None else batches[i]
            if half:
                batch = tuple(x[: x.shape[0] // 2] for x in batch)
            state, m = trainer.train_step(state, *batch)
            losses.append(m)
            if i == 0:
                grads = {}
                for prefix, opt in (("gen", state.gen_opt), ("dis", state.dis_opt)):
                    names = [n for n in leaves if n.startswith(prefix + ".")]
                    for n, mom in zip(names, opt.m):
                        grads[n] = (mom / (1.0 - opt.b1)).norm()
    change = {n: (p.detach() - theta0[n]).norm() for n, p in leaves.items()}
    return made, losses, grads, change


def _leaf_gap(got: dict, ref: dict, keep=None) -> float:
    ref_f = {n: float(v) for n, v in ref.items()}
    median = statistics.median(ref_f.values())
    gaps = [abs(float(got[n]) - r) / max(r, median, 1e-30)
            for n, r in ref_f.items() if keep is None or n in keep]
    return max(gaps)


def numbers(held: dict, ref) -> dict:
    r_batches, r_losses, r_grads, r_change = ref
    diffs = torch.cat([(a.float() - b.float()).abs().flatten()
                       for got, want in zip(held["batches"], r_batches)
                       for a, b in zip(got, want)])
    def loss_gap(steps):
        return max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-6)
                   for got, want in steps for k in want)

    pairs = list(zip(held["losses"], r_losses))
    median_g = statistics.median(float(v) for v in r_grads.values())
    moved = {n for n, v in r_grads.items() if float(v) >= 1e-3 * median_g}
    out = {
        "batch_mean_abs": float(diffs.mean()),
        "batch_bad_share": float((diffs > 0.02).float().mean()),
        "loss_gap": loss_gap(pairs[:1]),
        "loss_gap_later": loss_gap(pairs[1:]) if len(pairs) > 1 else 0.0,
        "grad_gap": _leaf_gap(held["grad_norms"], r_grads),
        "change_gap": _leaf_gap(held["change_norms"], r_change, keep=moved),
        "leaves_left_out": float(len(r_grads) - len(moved)),
    }
    return {k: (float("inf") if v != v else v) for k, v in out.items()}


def judge(run, held: dict) -> dict:
    ref = reference_run(run, len(held["losses"]), batches=held["batches"])
    return numbers(held, ref)
