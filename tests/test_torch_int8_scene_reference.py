"""The port's int8 serving tier (``ModelSpec(quantized_convs=True)``) against the
benchmark's plain int8 reference (``perfbench/reference/int8.py`` on the frozen
reference's networks), on the CPU at a tiny size: a 96x128 frame, V = 2 vehicles (so
each scale is a statistic of two vehicles' rows), T = 2, a bank of 2 CADs at subdiv 2.

Both sides load the same seeded state dicts (``perfbench/harness/weights``). On the CPU
the port's tier is the torch composition of the quantization and N2's float64 plain
version, and its other kernels take their plain versions, so the scene and each
network are compared for equality. The float reference (the tier off) and the
reference with 7-bit codes must read off it: the test sees the tier and its precision.
"""
import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.ops import cuda_conv
from future_urban_scene_generation_tpu_torch.pipeline import runner
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from perfbench.harness import weights
from perfbench.reference import int8
from perfbench.reference.pipeline import runner as ref_runner
from perfbench.reference.pipeline.stages import Models as RefModels
from perfbench.reference.spec import ModelSpec as RefSpec
from perfbench.traffic import scenes
import torch_threads  # noqa: F401

SEED = 2**31 + 22
SPEC = ModelSpec(quantized_convs=True)
CONFIG = {"frame_hw": [96, 128], "steps": 2, "cads": 2, "cad_subdiv": 2, "cad_scale": 5.0}
TRAFFIC = {"vehicles": 2, "pool": 1, "focal_px": 150.0, "yaw_jitter": 0.3,
           "offset_jitter_m": 1.0, "speed_mps": [3.0, 15.0], "dt_s": 0.2,
           "heading_jitter": 0.2, "box_pad_px": 5.0}
# The largest absolute difference of the two sides' frames. Equal sides read 0; the
# float reference and the 7-bit codes in the reference's place read 1.0 at this scene
# (their keypoints move, and the random-weight generators' output with them; the
# networks' test below holds them off on every network). Far from both:
TOL = 1e-3
# Networks: the largest difference relative to the int8 reference's largest |output|.
# The port reads 0; float and 7-bit codes read 1e-2 and more (a code is 1/127 or 1/63
# of its channel's range). Far from both:
NET_TOL = 1e-4
CALLS = {"cad": 15, "hourglass": 98, "icn": 16}


def _fields(spec):
    return {f: getattr(spec, f) for f in spec.__dataclass_fields__}


@pytest.fixture(scope="module")
def sides():
    """The port's networks and the reference's, one set of seeded state dicts; the CAD
    banks and the scene's inputs."""
    rng = np.random.default_rng(weights.sub_seed(SEED, "traffic"))
    meshes = scenes.cad_meshes(CONFIG["cads"], CONFIG["cad_subdiv"])
    sc = scenes.make_pool(TRAFFIC, CONFIG, [k for _, k in meshes], rng)[0]
    port = Models.build(SPEC, None, device="cpu")
    ref = RefModels.build(RefSpec(**_fields(SPEC)), None, device="cpu")
    for name, net in zip(Models._fields, port):
        state = weights.seeded_state(net, SEED, name, "cpu")
        net.load_state_dict(state)
        getattr(ref, name).load_state_dict(state)
    img = lambda a: torch.from_numpy(a).to(torch.float32) / 255.0  # noqa: E731
    inputs = (img(sc.frame), img(sc.background), torch.as_tensor(sc.bboxes),
              torch.as_tensor(sc.meters),
              torch.as_tensor(scenes.intrinsic(TRAFFIC["focal_px"], CONFIG["frame_hw"])))
    banks = [rn.build_cad_bank([m for m, _ in meshes], [k for _, k in meshes],
                               scale=CONFIG["cad_scale"], device="cpu")
             for rn in (runner, ref_runner)]
    return {"port": port, "ref": ref, "inputs": inputs, "banks": banks}


def _gap(a, b):
    return max(float((a.frames_icn - b.frames_icn).abs().max()),
               float((a.frames_vunet - b.frames_vunet).abs().max()))


@torch.no_grad()
def test_int8_scene_matches_the_int8_reference(sides):
    tier = int8.apply(sides["ref"])
    port = runner.run_scene(sides["port"], sides["banks"][0], *sides["inputs"], spec=SPEC)
    ref = ref_runner.run_scene(sides["ref"], sides["banks"][1], *sides["inputs"],
                               spec=RefSpec(**_fields(SPEC)))
    assert _gap(port, ref) <= TOL
    assert torch.equal(port.frames_icn, ref.frames_icn)
    assert torch.equal(port.frames_vunet, ref.frames_vunet)
    assert torch.equal(port.cad_idx, ref.cad_idx)
    # one scene: the V crops through the classifier and the hourglass, the N = V x T
    # vehicle-steps through the ICN, each conv on the tier once
    assert {net: sum(c.net == net for c in tier.calls) for net in CALLS} == CALLS
    assert {c.n for c in tier.calls if c.net != "icn"} == {2}
    assert {c.n for c in tier.calls if c.net == "icn"} == {4}


def _forward(models, net: str, scoped: bool):
    """``net``'s output on small inputs (crops 64x64; the ICN after its stem on 32x32, so
    both up stages' sources are at least 4x4), inside the port's tier scope if
    ``scoped``."""
    g = torch.Generator().manual_seed(SEED % 2**32)
    crops = torch.randn(2, 64, 64, 3, generator=g)
    trunk = torch.randn(2, 32, 32, 64, generator=g).relu()
    with torch.no_grad(), layers.quantized_convs(scoped):
        if net == "icn":
            return models.icn(trunk, from_stem=True)
        out = getattr(models, net)(crops)
        return out[-1] if net == "hourglass" else out


def test_networks_match_with_their_call_counts(sides, monkeypatch):
    seen = []
    real = cuda_conv.conv_int8_quantized
    monkeypatch.setattr(cuda_conv, "conv_int8_quantized",
                        lambda *a, **k: seen.append(a[0].shape) or real(*a, **k))
    tier = int8.apply(sides["ref"])
    for net, calls in CALLS.items():
        del seen[:], tier.calls[:]
        port = _forward(sides["port"], net, True)
        ref = _forward(sides["ref"], net, False)
        assert len(seen) == len(tier.calls) == calls, net
        assert [tuple(s) for s in seen] == [(c.n, c.h, c.w, c.c) for c in tier.calls]
        assert torch.equal(port, ref), net


@pytest.mark.parametrize("control", ["float", "bits7"])
def test_controls_read_off_the_int8_reference(sides, control):
    """The float reference (the tier taken off again) and 7-bit codes (+-63)."""
    for net in CALLS:
        int8.apply(sides["ref"])
        ref = _forward(sides["ref"], net, False)
        int8.apply(sides["ref"], None if control == "float" else 63)
        got = _forward(sides["ref"], net, False)
        gap = float((got - ref).abs().max()) / float(ref.abs().max())
        assert gap > NET_TOL, net


# ---------------------------------------------------------------------------
# On the card (marker ``chip``; it skips without one): the served scene's launches and
# spans. This file imports no JAX: ``python -m pytest --noconftest
# tests/test_torch_int8_scene_reference.py -m chip``.


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.chip
@torch.no_grad()
def test_card_scene_launches_and_spans(card):
    """At V = 16, T = 6 on 720x1280 frames a scene launches N3 and N2 129 times each,
    and opens one ``fusg.int8`` span a call: 113 under ``fusg.perceive`` (the
    classifier's 15, the hourglass's 98), 16 under ``fusg.icn``."""
    from future_urban_scene_generation_tpu_torch.utils import profiling

    config = dict(CONFIG, frame_hw=[720, 1280], steps=6, cads=10, cad_subdiv=9)
    traffic = dict(TRAFFIC, vehicles=16, focal_px=1400.0)
    rng = np.random.default_rng(weights.sub_seed(SEED, "traffic"))
    meshes = scenes.cad_meshes(config["cads"], config["cad_subdiv"])
    sc = scenes.make_pool(traffic, config, [k for _, k in meshes], rng)[0]
    models = Models.build(SPEC, None, device=card)
    for name, net in zip(Models._fields, models):
        net.load_state_dict(weights.seeded_state(net, SEED, name, card))
    bank = runner.build_cad_bank([m for m, _ in meshes], [k for _, k in meshes],
                                 scale=config["cad_scale"], device=card)
    img = lambda a: torch.from_numpy(a).to(card).to(torch.float32) / 255.0  # noqa: E731
    inputs = (img(sc.frame), img(sc.background), torch.as_tensor(sc.bboxes, device=card),
              torch.as_tensor(sc.meters, device=card),
              torch.as_tensor(scenes.intrinsic(traffic["focal_px"], config["frame_hw"]),
                              device=card))
    runner.run_scene(models, bank, *inputs, spec=SPEC)  # warm
    n2, n3 = cuda_conv.INT8_LAUNCHES, cuda_conv.QUANT_LAUNCHES
    key = ("int8 scene", SEED)
    with profiling.request(key):
        runner.run_scene(models, bank, *inputs, spec=SPEC)
    torch.cuda.synchronize()
    assert (cuda_conv.INT8_LAUNCHES - n2, cuda_conv.QUANT_LAUNCHES - n3) == (129, 129)
    spans = [s for s in profiling.spans() if s.request == key]
    names = {s.span_id: s.name for s in spans}
    parents = [names.get(s.parent_id) for s in spans if s.name == "fusg.int8"]
    assert parents.count("fusg.perceive") == 113 and parents.count("fusg.icn") == 16
    assert len(parents) == 129
