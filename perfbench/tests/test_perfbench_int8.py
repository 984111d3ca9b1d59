"""The int8 tier's cell (``scene-720p-int8.v16``) on the CPU: a tiny copy of its
configuration, still ``quantized_convs``, run through the harness (the look for a card
skipped): the result line carries the new metrics and is ``correct``; the calibration's
float and 7-bit controls are not. Beside it the reckoning of N2's and N3's work against
the convs the port hands ``conv_int8_quantized`` at V = 16, and the four new readers
against a synthetic trace and span record."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench import calibrate_int8
from perfbench import run as bench_run
from perfbench.harness import bench, program_spans
from perfbench.harness.trace import Kernel, Span, Trace
from perfbench.roofline import int8 as ri
from perfbench.roofline import kernels as rk
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELL = "scene-720p-int8.v16"
TWIN = "scene-720p-f32.v16"
TINY = "scene-tiny-int8.tiny"
SEED = 2**31 + 22
NEW_METRICS = {"int8.n2_roofline", "int8.n3_roofline", "int8.host_ms", "scene_int8.mfu"}


def make_root(tmp: Path) -> Path:
    """``tiny.make_root`` plus the cell ``scene-tiny-int8.tiny``: the int8 configuration
    at the tiny scene's sizes, the new cell's traffic at the tiny traffic, listed by
    every metric the new cell reports."""
    root = tiny.make_root(tmp)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "scene-720p-int8.json").read_text())
    assert cfg["spec"]["quantized_convs"] is True
    cfg.update(tiny.TINY_SCENE, name="scene-tiny-int8")
    (pb / "configs" / "scene-tiny-int8.json").write_text(json.dumps(cfg))
    cell = json.loads((pb / "cells" / f"{CELL}.json").read_text())
    cell["config"] = "scene-tiny-int8"
    cell["traffic"].update(tiny.TINY_TRAFFIC)
    cell["trace"] = {"first": 0, "count": 1}
    cell["judge"] = {"scenes": 1}
    (pb / "cells" / f"{TINY}.json").write_text(json.dumps(cell))
    data = json.loads((root / "BENCHMARK.json").read_text())
    conf = next(c for c in data["configs"] if c["name"] == "scene-720p-int8")
    data["configs"].append(dict(conf, name="scene-tiny-int8",
                                file="perfbench/configs/scene-tiny-int8.json"))
    data["workloads"].append({"name": TINY, "config": "scene-tiny-int8", "traffic": "tiny",
                              "chips": 1, "why": "tiny int8 scene for the CPU"})
    for m in data["end_to_end"] + data["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [TINY]
    (root / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp("bench_int8"))


def _run(root, trace=False):
    return bench_run.run_cell(root, TINY, SEED, 0.5, trace, device="cpu")


def test_cell_is_the_f32_twin_on_the_int8_tier():
    cell, twin = bench.load_cell(REPO, CELL), bench.load_cell(REPO, TWIN)
    assert cell.cell["traffic"] == twin.cell["traffic"]
    assert cell.cell["entry"] == "stream_int8" and cell.workload["chips"] == 1
    assert {k: v for k, v in cell.config["spec"].items() if k != "quantized_convs"} == \
        {k: v for k, v in twin.config["spec"].items() if k != "quantized_convs"}
    assert cell.config["spec"]["quantized_convs"] and not twin.config["spec"]["quantized_convs"]
    for key in ("frame_hw", "steps", "cads", "cad_subdiv", "cad_scale", "assumed"):
        assert cell.config[key] == twin.config[key], key
    per_layer = {m["name"] for m in cell.per_layer}
    assert NEW_METRICS <= per_layer
    # scene.mfu reads every FLOP at the float32 peak, which the int8 scene may beat.
    assert not {"scene.mfu", "plane_paste.device_ms", "plane_paste.host_ms"} & per_layer
    assert per_layer - NEW_METRICS == {m["name"] for m in twin.per_layer} - {"scene.mfu"}
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "scene_p90_ms", "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_int8_result_line(root, trace):
    result = _run(root, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    # The CPU's tier is the plain one: the frames and the ICN's trunk are the reference's.
    assert result["checks"]["frames_q90_abs"]["value"] == 0.0
    assert result["checks"]["icn_trunk_q90_abs"]["value"] == 0.0
    if trace:
        assert {"int8.host_ms", "scene_int8.mfu"} <= set(result["metrics"])
        assert result["metrics"]["int8.host_ms"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"frames_per_s", "scene_p90_ms", "setup_s"}
    json.dumps(result)


def test_calibration_controls_fail(root):
    """``calibrate_int8.readings`` on the tiny cell: the ICN's trunk with the tier off
    and with 7-bit codes each break the trunk's limit; the float reference and the 7-bit
    codes in the whole scene each break a limit of the cell (TF32, the control, does
    nothing on the CPU)."""
    from perfbench.judge import checks, passed

    cell = bench.load_cell(root, TINY)
    run, _, held = bench_run.drive(cell, SEED, 0.5, False, "cpu")
    assert held["icn"]
    got = calibrate_int8.readings(run, held)
    assert set(got) == {"icn_float", "icn_bits7", "float", "bits7", "control"}
    limit = cell.cell["limits"]["icn_trunk_q90_abs"]
    for name in ("icn_float", "icn_bits7"):
        assert got[name]["icn_trunk_q90_abs"] > limit, name
    for name in ("float", "bits7"):
        assert not passed(checks(got[name], cell.cell["limits"])), name
    assert set(calibrate_int8.readings(run, held, scenes=False)) == {"icn_float", "icn_bits7"}


def test_a_float_icn_fails_the_trunk_limit(root, monkeypatch):
    """A program whose ICN skips the tier (its trunk's convs float, the rest of the
    scene on it) reads off the reference's trunk past the limit."""
    import dataclasses

    from future_urban_scene_generation_tpu_torch.pipeline import stages

    real = stages.icn_synthesize_batch

    def float_icn(models, spec, *args, **kwargs):
        return real(models, dataclasses.replace(spec, quantized_convs=False), *args, **kwargs)

    monkeypatch.setattr(stages, "icn_synthesize_batch", float_icn)
    result = _run(root)
    assert result["correct"] is False
    trunk = result["checks"]["icn_trunk_q90_abs"]
    assert trunk["value"] > trunk["limit"]


def _port_calls(v: int, steps: int):
    """The shapes the port's CAD classifier, hourglass and ICN hand
    ``cuda_conv.conv_int8_quantized`` on the tier at V crops and N = V x T vehicle-steps,
    under fake tensors (no data)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from future_urban_scene_generation_tpu_torch.models import layers
    from future_urban_scene_generation_tpu_torch.ops import cuda_conv
    from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec

    spec = ModelSpec(quantized_convs=True)
    models = Models.build(spec, None, device="cpu")
    calls, real = [], cuda_conv.conv_int8_quantized

    def record(x, w, out_dtype, **k):
        calls.append((tuple(x.shape), tuple(w.shape), k))
        return real(x, w, out_dtype, **k)

    strips = dict(layers._STRIP_ROWS)
    try:
        cuda_conv.conv_int8_quantized = record
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad(), \
                layers.quantized_convs(True):
            crops = torch.empty(v, 256, 256, 3)
            models.cad(crops)
            models.hourglass(crops)
            models.icn(torch.empty(v * steps, 256, 256, spec.icn_input_nc))
    finally:
        cuda_conv.conv_int8_quantized = real
        layers._STRIP_ROWS.clear()  # fake index tensors made under the mode
        layers._STRIP_ROWS.update(strips)
    return calls


def test_reckoning_is_the_ports_calls():
    """At V = 16, T = 6: the reckoning's 129 calls, in order, are the convs the port's
    forward hands the int8 wrapper; its operations come to 9.34e12."""
    cfg = json.loads((REPO / "perfbench" / "configs" / "scene-720p-int8.json").read_text())
    work = ri.scene_work(cfg["spec"], 16, 6)
    port = _port_calls(16, 6)
    assert [c.net for c in work.calls].count("cad") == 15
    assert [c.net for c in work.calls].count("hourglass") == 98
    assert [c.net for c in work.calls].count("icn") == 16
    assert len(port) == len(work.calls) == 129
    for c, (x, w, k) in zip(work.calls, port):
        assert x == (c.n, c.h, c.w, c.c) and w == (c.k, c.k, c.c, c.o)
        assert (k["stride"], k["pad_lo"], k["pad_hi"], k["dilation"]) == \
            (c.stride, c.padding, c.padding, c.dilation)
        assert k.get("in_dilation", 1) == 1 and not k.get("flip", False)
    assert work.int8_ops == pytest.approx(9.34e12, rel=5e-4)
    icn = sum(ri.n2_call(c)[1] for c in work.calls if c.net == "icn")
    assert icn == pytest.approx(8.246e12, rel=5e-4)
    assert 3e12 < work.float_flops < 5e12  # the VUNet 2.67e12, the ICN stem and head, ...


MS = 1_000_000  # ns
CONFIG = {"spec": json.loads((REPO / "perfbench" / "configs" / "scene-720p-int8.json")
                             .read_text())["spec"], "steps": 6}


def _run_on(trace):
    cell = SimpleNamespace(config=CONFIG, cell={"traffic": {"vehicles": 16}})
    return SimpleNamespace(trace=trace, cell=cell)


def _kernels(name: str, count: int, each_ns: int):
    return [Kernel(f"void {name}<128, float>(int8 const*, Geom)", i * 10 * each_ns,
                   i * 10 * each_ns + each_ns, "fusg.int8", ("fusg.icn", "fusg.int8"))
            for i in range(count)]


def reader(name):
    return bench.load_module(REPO / "perfbench" / "metrics" / f"{name}.py")


def test_roofline_readers_at_the_bound():
    """Two scenes' launches, each kernel as long as a scene's bound over its calls: both
    shares read 100; at twice that, 50; without their kernels, nothing."""
    work = ri.scene_work(CONFIG["spec"], 16, 6)
    n = 2 * len(work.calls)
    for metric, name, bound in (("int8.n2_roofline", ri.N2_NAME, work.n2_bound_s()),
                                ("int8.n3_roofline", ri.N3_NAME, work.n3_bound_s())):
        each = round(bound / len(work.calls) * 1e9)
        t = Trace(_kernels(name, n, each), [], 2, 1.0, 0.5, [])
        # each kernel's time rounded to the ns: within 1e-4 of the bound
        assert reader(metric).read(_run_on(t)) == pytest.approx(100.0, rel=1e-4)
        t.kernels = _kernels(name, n, 2 * each)
        assert reader(metric).read(_run_on(t)) == pytest.approx(50.0, rel=1e-4)
        t.kernels = _kernels("conv_wgmma_kernel", n, each)
        assert reader(metric).read(_run_on(t)) is None
        assert reader(metric).read(_run_on(None)) is None


def test_scene_mfu_at_the_peaks_reads_at_most_100():
    work = ri.scene_work(CONFIG["spec"], 16, 6)
    t = Trace([], [], 3, 3 * work.bound_s(), 1.0, [])
    assert reader("scene_int8.mfu").read(_run_on(t)) == pytest.approx(100.0, rel=1e-9)
    assert reader("scene_int8.mfu").read(_run_on(t)) <= 100.0 + 1e-9
    t.window_s *= 4
    assert reader("scene_int8.mfu").read(_run_on(t)) == pytest.approx(25.0, rel=1e-9)
    assert work.bound_s() == pytest.approx(work.int8_ops / ri.PEAK_INT8
                                           + work.float_flops / rk.PEAK_F32)
    assert reader("scene_int8.mfu").read(_run_on(None)) is None


def _int8_spans():
    """Two ``fusg.int8`` spans a scene (1 and 2 ms; scene 2's 5 ms each) for scenes 0-3
    at 0, 1.5, 10.5 and 13 s; scene 2 runs inside the traced stretch."""
    out, ids = [], iter(range(1, 100))
    for scene, start, dur in ((0, 0, 1), (1, 1_500, 2), (2, 10_500, 5), (3, 13_000, 1)):
        for i, d in enumerate((dur, 2 * dur if scene != 2 else dur)):
            t = start + 10 * i
            out.append(profiling.Span("fusg.int8", t * MS, (t + d) * MS, next(ids), 99,
                                      scene, 1))
        out.append(profiling.Span("fusg.icn", start * MS, (start + 50) * MS, next(ids),
                                  None, scene, 1))
    return out


STRETCH = Trace(kernels=[Kernel("k", 11_500 * MS, 12_000 * MS, None, ())],
                spans=[Span("bench.submit", 10_000 * MS, 11_000 * MS)],
                units=1, window_s=2.0, busy_s=0.5, idle_gaps=[])


def test_host_ms_sums_a_scene_outside_the_stretch(monkeypatch):
    monkeypatch.setattr(program_spans, "record", _int8_spans)
    # scenes 0, 1, 3 sum to 3, 6, 3 ms: median 3; scene 2 (10 ms) is in the stretch.
    assert reader("int8.host_ms").read(SimpleNamespace(trace=STRETCH)) == 3.0
    assert reader("int8.host_ms").read(SimpleNamespace(trace=None)) == 4.5
    monkeypatch.setattr(program_spans, "record",
                        lambda: [s for s in _int8_spans() if s.name == "fusg.icn"])
    assert reader("int8.host_ms").read(SimpleNamespace(trace=STRETCH)) is None
    monkeypatch.setattr(program_spans, "record", lambda: None)
    assert reader("int8.host_ms").read(SimpleNamespace(trace=STRETCH)) is None
