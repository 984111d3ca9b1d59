"""Entry ``train``: ``cli.train``'s loop for one family, at the cell's batch.

Set-up is ``cli.train.family_setup`` (the family's trainer, train state and seeded
``make_batch``), the seeded weights loaded over the state's networks, and the first
``judge.steps`` steps through the window's own calls: those steps are the warm-up and
what the judge holds against the reference (each step's losses, the first gradient
as the optimizer got it, and every parameter's change over the steps). The window
then runs ``make_batch`` and ``train_step`` in turn, reading the losses every
``log_interval`` steps as the CLI logs them, and ends on a device synchronize.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from perfbench.harness import weights


class State:
    pass


def _step(st):
    with record_function("bench.make_batch"):
        batch = st.make_batch()
    with record_function("bench.train_step"):
        st.state, losses = st.trainer.train_step(st.state, *batch)
    return batch, losses


def _leaves(state):
    return {**{f"gen.{n}": p for n, p in state.gen.named_parameters()},
            **{f"dis.{n}": p for n, p in state.dis.named_parameters()}}


def _first_gradient(state) -> dict:
    """Each parameter's gradient as its optimizer got it on the first step, from
    Adam's first moment: m_1 = (1 - beta1) g (zero where the optimizer holds none)."""
    out = {}
    for prefix, opt, net in (("gen", state.gen_opt, state.gen), ("dis", state.dis_opt, state.dis)):
        b1 = opt.param_groups[0]["betas"][0]
        for n, p in net.named_parameters():
            m = opt.state.get(p, {}).get("exp_avg")
            out[f"{prefix}.{n}"] = torch.zeros_like(p) if m is None else m / (1.0 - b1)
    return out


def setup(run) -> State:
    parts = run.setup_parts
    t = time.perf_counter()
    from future_urban_scene_generation_tpu_torch.cli import train as train_cli
    from future_urban_scene_generation_tpu_torch.ops import _kernels
    parts["import_s"] += time.perf_counter() - t

    t = time.perf_counter()
    run.init_device()
    parts["context_s"] = time.perf_counter() - t
    if run.device.type == "cuda":
        t = time.perf_counter()
        _kernels.load()
        parts["library_s"] = time.perf_counter() - t
        parts["library_build_s"] = float(_kernels.BUILD_SECONDS or 0.0)

    cfg, traffic = run.cell.config, run.cell.cell["traffic"]
    st = State()
    t = time.perf_counter()
    st.trainer, st.state, st.make_batch = train_cli.family_setup(
        cfg["family"], seed=run.seed, batch=traffic["batch"], lr=cfg["lr"],
        image_size=cfg["image_size"], device=run.device)
    parts["family_setup_s"] = time.perf_counter() - t

    t = time.perf_counter()
    for tag, net in (("gen", st.state.gen), ("dis", st.state.dis)):
        net.load_state_dict(weights.seeded_state(net, run.seed, tag, run.device))
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    theta0 = {n: p.detach().clone() for n, p in _leaves(st.state).items()}
    st.batches, st.losses = [], []
    for i in range(run.cell.cell["judge"]["steps"]):
        batch, losses = _step(st)
        st.batches.append(batch)
        st.losses.append(losses)
        if i == 0:
            st.grad_norms = {n: g.norm() for n, g in _first_gradient(st.state).items()}
    st.change_norms = {n: (p.detach() - theta0[n]).norm()
                       for n, p in _leaves(st.state).items()}
    del theta0
    run.synchronize()
    parts["first_steps_s"] = time.perf_counter() - t
    return st


def window(run, st: State) -> dict:
    log_every = run.cell.cell["traffic"]["log_interval"]
    tracer = run.tracer
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        tracer.unit(i)
        _, losses = _step(st)
        if log_every and i % log_every == 0:  # the CLI's log line reads the losses
            [float(v) for v in losses.values()]
        i += 1
    run.synchronize()
    t1 = time.perf_counter()
    tracer.close(i)
    batch = run.cell.cell["traffic"]["batch"]
    return {"seconds": t1 - t0, "attempted": i, "failed": 0, "samples": batch * i,
            "units": i}


def release(run, st: State) -> dict:
    held = {"batches": st.batches, "losses": st.losses, "grad_norms": st.grad_norms,
            "change_norms": st.change_norms}
    del st.state, st.trainer, st.make_batch
    return held


def judge(run, held: dict):
    from perfbench.judge import train

    return train.judge(run, held)
