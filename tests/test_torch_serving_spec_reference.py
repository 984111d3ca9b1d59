"""The port's served configuration (``spec.SERVING_SPEC``: bfloat16 generators, 96^2
plane warps) against the benchmark's plain reference (``perfbench/reference``), on the
CPU at a tiny size: a 96x128 frame, one vehicle, T = 2, a bank of 2 CADs at subdiv 2.

Both sides load the same seeded state dicts (``perfbench/harness/weights``). On the CPU
every kernel wrapper of the port takes its plain version (K1, K2, P1's plain solve), the
very code the reference froze, so the frames are compared for equality. A float32 run
of the same scene must read off that: the test sees the generators' precision. The
reduced grid's two steps leave spans of their own under ``fusg.plane_warp``; the exact
256^2 warp leaves none.
"""
import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.ops import crop as cr
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import SERVING_SPEC, ModelSpec
from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench.harness import weights
from perfbench.reference.pipeline import runner as ref_runner
from perfbench.reference.pipeline.stages import Models as RefModels
from perfbench.reference.spec import ModelSpec as RefSpec
from perfbench.traffic import scenes
import torch_threads  # noqa: F401

SEED = 2**31 + 18
CONFIG = {"frame_hw": [96, 128], "steps": 2, "cads": 2, "cad_subdiv": 2, "cad_scale": 5.0}
TRAFFIC = {"vehicles": 1, "pool": 1, "focal_px": 150.0, "yaw_jitter": 0.3,
           "offset_jitter_m": 1.0, "speed_mps": [3.0, 15.0], "dt_s": 0.2,
           "heading_jitter": 0.2, "box_pad_px": 5.0}
# The largest absolute difference of the two sides' frames. Equal sides read 0; the
# same scene with float32 generators reads 0.89 here (a bf16 activation keeps 8 bits
# of mantissa, and the random-weight generators carry a rounding into whole pixels).
# The tolerance lies between the two, far from both:
TOL = 1e-3


@pytest.fixture(scope="module")
def sides():
    """Both sides' networks with one set of seeded state dicts, the CAD banks and the
    scene's inputs."""
    rng = np.random.default_rng(weights.sub_seed(SEED, "traffic"))
    meshes = scenes.cad_meshes(CONFIG["cads"], CONFIG["cad_subdiv"])
    sc = scenes.make_pool(TRAFFIC, CONFIG, [k for _, k in meshes], rng)[0]
    port = Models.build(SERVING_SPEC, None, device="cpu")
    ref = RefModels.build(RefSpec(**_fields(SERVING_SPEC)), None, device="cpu")
    for name, net, ref_net in zip(Models._fields, port, ref):
        state = weights.seeded_state(net, SEED, name, "cpu")
        net.load_state_dict(state)
        ref_net.load_state_dict(state)
    img = lambda a: torch.from_numpy(a).to(torch.float32) / 255.0  # noqa: E731
    inputs = (img(sc.frame), img(sc.background), torch.as_tensor(sc.bboxes),
              torch.as_tensor(sc.meters),
              torch.as_tensor(scenes.intrinsic(TRAFFIC["focal_px"], CONFIG["frame_hw"])))
    banks = [rn.build_cad_bank([m for m, _ in meshes], [k for _, k in meshes],
                               scale=CONFIG["cad_scale"], device="cpu")
             for rn in (runner, ref_runner)]
    return {"port": (runner, port, banks[0], ModelSpec),
            "reference": (ref_runner, ref, banks[1], RefSpec), "inputs": inputs}


def _fields(spec):
    return {f: getattr(spec, f) for f in spec.__dataclass_fields__}


def _run(sides, side, spec):
    """One scene through ``side``'s ``run_scene``, its spans under the request
    (side, spec)."""
    rn, models, bank, spec_cls = sides[side]
    with profiling.request((side, spec)), torch.no_grad():
        return rn.run_scene(models, bank, *sides["inputs"], spec=spec_cls(**_fields(spec)))


@pytest.fixture(scope="module")
def served(sides):
    return {side: _run(sides, side, SERVING_SPEC) for side in ("port", "reference")}


def _gap(a, b):
    return max(float((a.frames_icn - b.frames_icn).abs().max()),
               float((a.frames_vunet - b.frames_vunet).abs().max()))


def test_serving_spec_matches_the_reference(served):
    assert SERVING_SPEC.generator_dtype == "bfloat16" and SERVING_SPEC.warp_plane_res == 96
    port, ref = served["port"], served["reference"]
    assert _gap(port, ref) <= TOL
    assert torch.equal(port.frames_icn, ref.frames_icn)
    assert torch.equal(port.frames_vunet, ref.frames_vunet)
    assert torch.equal(port.cad_idx, ref.cad_idx)


def test_float32_generators_read_off_the_served_frames(sides, served):
    f32 = _run(sides, "port", SERVING_SPEC.replace(generator_dtype="float32"))
    assert _gap(f32, served["port"]) > TOL


def _plane_warp_children(key):
    spans = [s for s in profiling.spans() if s.request == key]
    warps = [s for s in spans if s.name == "fusg.plane_warp"]
    assert len(warps) == 1
    kids = [s for s in spans if s.name.startswith("fusg.plane_warp.")]
    assert all(s.parent_id == warps[0].span_id for s in kids)
    return sorted(s.name for s in kids)


def test_reduced_grid_spans(served):
    want = ["fusg.plane_warp.paste"] * 3 + ["fusg.plane_warp.sample"] * 3
    assert _plane_warp_children(("port", SERVING_SPEC)) == want


def test_exact_grid_opens_no_spans():
    """The 256^2 warp, called as the scene's geometry calls it, records no child of
    ``fusg.plane_warp``."""
    spec = SERVING_SPEC.replace(warp_plane_res=256)
    table = torch.zeros(1, stages.SRC_TABLE, stages.SRC_TABLE, 3)
    window = cr.Window(*(torch.tensor([v]) for v in (10.0, 10.0, 50.0, 50.0)))
    quad = [[20.0, 20.0], [40.0, 20.0], [40.0, 40.0], [20.0, 40.0], [20.0, 20.0], [20.0, 20.0]]
    polys = torch.tensor(quad).expand(1, 5, 6, 2)
    seen = torch.ones(1, 5, dtype=torch.bool)
    with profiling.request(("port", spec)), profiling.trace("fusg.plane_warp"):
        stages.warp_planes_to_crop(spec, table, window, polys, polys, seen, seen, window,
                                   torch.zeros(1, dtype=torch.long))
    assert _plane_warp_children(("port", spec)) == []
