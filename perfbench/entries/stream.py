"""Entry ``stream``: one camera stream on ``pipeline/streaming.StreamRunner``, closed
loop, the port's own submit / flush at the cell's depth; each scene goes through
``runner.run_scene``.

Set-up builds the port's side from the harness's inputs (the CAD bank from the
seeded procedural cars, the networks with the seeded weights loaded, the scene pool)
and runs one cold and one warm scene. The window submits the pool's scenes in turn
until ``seconds`` have passed, then flushes. A scene's latency runs from the
benchmark's submit of its frame to the return of its result, which the runner hands
back once the scene's event has synchronized.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import weights
from perfbench.traffic import scenes


class State:
    pass


def setup(run) -> State:
    parts = run.setup_parts
    t = time.perf_counter()
    from future_urban_scene_generation_tpu_torch.ops import _kernels
    from future_urban_scene_generation_tpu_torch.pipeline import runner, streaming
    from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec
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
    st.spec = ModelSpec(**cfg["spec"])
    t = time.perf_counter()
    st.models = Models.build(st.spec, None, device=run.device)
    for name, net in zip(Models._fields, st.models):
        net.load_state_dict(weights.seeded_state(net, run.seed, name, run.device))
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    rng = np.random.default_rng(weights.sub_seed(run.seed, "traffic"))
    meshes = scenes.cad_meshes(cfg["cads"], cfg["cad_subdiv"])
    st.cad_bank = runner.build_cad_bank([m for m, _ in meshes], [k for _, k in meshes],
                                        scale=cfg["cad_scale"], device=run.device)
    st.pool = scenes.make_pool(traffic, cfg, [k for _, k in meshes], rng)
    st.intrinsic = scenes.intrinsic(traffic["focal_px"], cfg["frame_hw"])
    st.stream = streaming.StreamRunner(
        st.models, st.cad_bank, st.intrinsic, tuple(cfg["frame_hw"]), traffic["vehicles"],
        spec=st.spec, n_steps=cfg["steps"], depth=traffic["depth"])
    parts["pool_s"] = time.perf_counter() - t

    t = time.perf_counter()
    for sc in st.pool[:2]:  # one cold scene, one warm
        st.stream.submit(sc.frame, sc.bboxes, sc.meters, background=sc.background)
    st.stream.flush()
    run.synchronize()
    parts["first_scenes_s"] = time.perf_counter() - t
    st.stream.latencies.clear()
    return st


def window(run, st: State) -> dict:
    """Submit the pool's scenes in turn for ``run.seconds``, then flush. Returns the
    window's record; keeps the newest result of each pool scene for the judge."""
    steps = run.cell.config["steps"]
    pending = collections.deque()  # (submit time, pool index) of scenes in flight
    latencies, kept = [], {}
    tracer = run.tracer

    def returned(result):
        t_sub, k = pending.popleft()
        latencies.append(time.perf_counter() - t_sub)
        kept[k] = result

    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        tracer.unit(i)
        k = i % len(st.pool)
        sc = st.pool[k]
        pending.append((time.perf_counter(), k))
        with record_function("bench.submit"):
            out = st.stream.submit(sc.frame, sc.bboxes, sc.meters, background=sc.background)
        if out is not None:
            returned(out)
        i += 1
    for out in st.stream.flush():
        returned(out)
    t1 = time.perf_counter()
    tracer.close(i)
    st.kept = kept
    return {"seconds": t1 - t0, "attempted": i, "failed": i - len(latencies),
            "latencies_s": latencies, "frames": 2 * steps * len(latencies), "units": i}


def release(run, st: State) -> dict:
    """Free the port's side; return what the judge reads: the kept results, the pool
    and the intrinsic."""
    kept = {k: (r.frames_icn, r.frames_vunet, r.pnp_error, r.cad_idx)
            for k, r in st.kept.items()}
    out = {"kept": kept, "pool": st.pool, "intrinsic": st.intrinsic}
    del st.stream, st.models, st.cad_bank, st.kept
    return out


def judge(run, held: dict):
    from perfbench.judge import scene

    return scene.judge(run, held)
