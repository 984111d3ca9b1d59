"""The served configuration's cell (``scene-1080p-bf16.v4``) on the CPU: a tiny copy of
its configuration, still bfloat16 generators and 96^2 plane warps, run through the
harness (the look for a card skipped): the result line carries the new readers'
metrics and is ``correct``; the paste without its antialiasing is not, nor are the
calibration's reduced mantissa and planted paste fault. Beside it the by-branch numbers
and the two readers of the paste against synthetic frames, record and trace."""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from future_urban_scene_generation_tpu_torch.utils import profiling
from perfbench import calibrate_bf16
from perfbench import run as bench_run
from perfbench.harness import bench, program_spans
from perfbench.harness.trace import Kernel, Span, Trace
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELL = "scene-1080p-bf16.v4"
TINY = "scene-tiny-bf16.tiny"
SEED = 2**31 + 18


def make_root(tmp: Path) -> Path:
    """``tiny.make_root`` plus the cell ``scene-tiny-bf16.tiny``: the new configuration
    at the tiny scene's sizes, the new cell's traffic at the tiny traffic, listed by
    every metric the new cell reports."""
    root = tiny.make_root(tmp)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "scene-1080p-bf16.json").read_text())
    assert cfg["spec"]["generator_dtype"] == "bfloat16" and cfg["spec"]["warp_plane_res"] == 96
    cfg.update(tiny.TINY_SCENE, name="scene-tiny-bf16")
    (pb / "configs" / "scene-tiny-bf16.json").write_text(json.dumps(cfg))
    cell = json.loads((pb / "cells" / f"{CELL}.json").read_text())
    cell["config"] = "scene-tiny-bf16"
    cell["traffic"].update(tiny.TINY_TRAFFIC)
    cell["trace"] = {"first": 0, "count": 1}
    cell["judge"] = {"scenes": 1}
    (pb / "cells" / f"{TINY}.json").write_text(json.dumps(cell))
    data = json.loads((root / "BENCHMARK.json").read_text())
    conf = next(c for c in data["configs"] if c["name"] == "scene-1080p-bf16")
    data["configs"].append(dict(conf, name="scene-tiny-bf16",
                                file="perfbench/configs/scene-tiny-bf16.json"))
    data["workloads"].append({"name": TINY, "config": "scene-tiny-bf16", "traffic": "tiny",
                              "chips": 1, "why": "tiny bf16 scene for the CPU"})
    for m in data["end_to_end"] + data["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + [TINY]
    (root / "BENCHMARK.json").write_text(json.dumps(data, indent=1))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp("bench_bf16"))


def _run(root, trace=False):
    return bench_run.run_cell(root, TINY, SEED, 0.5, trace, device="cpu")


def test_cell_reports_the_paste_metrics():
    cell = bench.load_cell(REPO, CELL)
    names = {m["name"] for m in cell.per_layer}
    assert {"plane_paste.device_ms", "plane_paste.host_ms", "icn_stem.k2_roofline",
            "scene.mfu", "warp_composite.host_ms"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "scene_p90_ms", "setup_s"}
    assert cell.config["spec"]["generator_dtype"] == "bfloat16"
    assert cell.config["frame_hw"] == [1080, 1920]


@pytest.mark.parametrize("trace", [False, True])
def test_bf16_result_line(root, trace):
    result = _run(root, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    if trace:
        assert {"plane_paste.host_ms", "warp_composite.host_ms"} <= set(result["metrics"])
        assert result["metrics"]["plane_paste.host_ms"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"frames_per_s", "scene_p90_ms", "setup_s"}
    json.dumps(result)


def test_paste_without_antialias_is_not_correct(root, monkeypatch):
    """The port's plane-warp paste (its one antialiased resample) with the antialiasing
    off: the fault the calibration plants in the reference, here in the program."""
    from future_urban_scene_generation_tpu_torch.ops import crop

    real = crop.scale_and_translate
    monkeypatch.setattr(crop, "scale_and_translate",
                        lambda *a, **k: real(*a, **dict(k, antialias=False)))
    result = _run(root)
    assert result["correct"] is False
    check = result["checks"]["icn_bad05_share"]
    assert check["value"] > check["limit"]


def test_calibration_readings(root):
    """``calibrate_bf16.readings`` on the tiny cell: the reduced mantissa and the paste
    without its antialiasing each break a limit of the cell (TF32, the control, does
    nothing on the CPU)."""
    from perfbench.judge import checks, passed

    cell = bench.load_cell(root, TINY)
    run, _, held = bench_run.drive(cell, SEED, 0.5, False, "cpu")
    got = calibrate_bf16.readings(run, held)
    assert set(got) == {"control", "mantissa", "paste_fault"}
    for name in ("mantissa", "paste_fault"):
        assert not passed(checks(got[name], cell.cell["limits"])), name


def test_branch_numbers():
    """Each branch over its own painted pixels: the ICN frames differ in 2 of the 9
    values of their 3 painted pixels, by 0.1 and 0.01; the VUNet frames not at all."""
    from perfbench.judge import scene_branches

    bg = torch.zeros(2, 2, 3)
    icn_ref = torch.zeros(1, 2, 2, 3)
    icn_ref[0, 0] = 0.5  # two painted pixels, six values
    icn_ref[0, 1, 0] = 0.5  # a third, nine values in all
    icn_got = icn_ref.clone()
    icn_got[0, 0, 0, 0] += 0.1
    icn_got[0, 0, 1, 0] += 0.01
    vun = icn_ref.clone()
    got = scene_branches.branch_numbers((icn_got, vun), (icn_ref, vun), bg)
    assert got["icn_bad05_share"] == pytest.approx(1 / 9)
    assert got["icn_q90_abs"] == pytest.approx(0.1, abs=1e-6)  # the 9th of 9
    assert got["vunet_bad05_share"] == got["vunet_q90_abs"] == 0.0
    icn_got[0, 0, 0, 0] -= 0.1
    got = scene_branches.branch_numbers((icn_got, vun), (icn_ref, vun), bg)
    assert got["icn_q90_abs"] == pytest.approx(0.01, abs=1e-6)
    assert got["icn_bad05_share"] == 0.0


MS = 1_000_000  # ns
STRETCH = Trace(kernels=[Kernel("k", 11_500 * MS, 12_000 * MS, None, ())],
                spans=[Span("bench.submit", 10_000 * MS, 11_000 * MS)],
                units=1, window_s=2.0, busy_s=0.5, idle_gaps=[])


def reader(name):
    return bench.load_module(REPO / "perfbench" / "metrics" / f"{name}.py")


def _paste_spans():
    """Three paste spans a scene (1 ms each, scene 2's are 2 ms) for scenes 0-3 at
    0, 1.5, 10.5 and 13 s; scene 2 runs inside the traced stretch (its spans 5 ms)."""
    out, ids = [], iter(range(1, 100))
    for scene, start, dur in ((0, 0, 1), (1, 1_500, 2), (2, 10_500, 5), (3, 13_000, 1)):
        for i in range(3):
            t = start + 10 * i
            out.append(profiling.Span("fusg.plane_warp.paste", t * MS, (t + dur) * MS,
                                      next(ids), 99, scene, 1))
        out.append(profiling.Span("fusg.plane_warp", start * MS, (start + 50) * MS,
                                  next(ids), None, scene, 1))
    return out


def test_paste_host_ms_sums_a_scene_outside_the_stretch(monkeypatch):
    monkeypatch.setattr(program_spans, "record", _paste_spans)
    # scenes 0, 1, 3 sum to 3, 6, 3 ms: median 3; scene 2 (15 ms) is in the stretch.
    assert reader("plane_paste.host_ms").read(SimpleNamespace(trace=STRETCH)) == 3.0
    assert reader("plane_paste.host_ms").read(SimpleNamespace(trace=None)) == 4.5


def test_paste_host_ms_reads_nothing_without_the_spans(monkeypatch):
    run = SimpleNamespace(trace=STRETCH)
    monkeypatch.setattr(program_spans, "record", lambda: None)
    assert reader("plane_paste.host_ms").read(run) is None
    monkeypatch.setattr(program_spans, "record",
                        lambda: [s for s in _paste_spans() if s.name == "fusg.plane_warp"])
    assert reader("plane_paste.host_ms").read(run) is None


def test_paste_device_ms_per_scene():
    warp, paste = "fusg.plane_warp", "fusg.plane_warp.paste"
    kernels = [Kernel("a", 0, 2 * MS, paste, ("fusg.stream.dispatch", warp, paste)),
               Kernel("b", 3 * MS, 4 * MS, paste, ("fusg.stream.dispatch", warp, paste)),
               Kernel("c", 5 * MS, 9 * MS, warp, ("fusg.stream.dispatch", warp))]
    spans = [Span(warp, 0, 10 * MS), Span(warp, 20 * MS, 30 * MS)]
    t = Trace(kernels, spans, units=2, window_s=1.0, busy_s=0.1, idle_gaps=[])
    assert reader("plane_paste.device_ms").read(SimpleNamespace(trace=t)) == 1.5
    t.kernels = kernels[2:]  # a port without the span, or a 256^2 cell
    assert reader("plane_paste.device_ms").read(SimpleNamespace(trace=t)) is None
    assert reader("plane_paste.device_ms").read(SimpleNamespace(trace=None)) is None


def test_clear_low_mantissa():
    x = torch.tensor([1.0 + 2 ** -7, 1.0 + 2 ** -3 + 2 ** -4, -3.0 - 2 ** -6 * 3],
                     dtype=torch.bfloat16)
    got = calibrate_bf16.clear_low_mantissa(x)
    assert got.tolist() == [1.0, 1.0 + 2 ** -3, -3.0]
    f32 = torch.tensor([1.0 + 2 ** -7])
    assert calibrate_bf16.clear_low_mantissa(f32) is f32


def test_calibration_patches_are_undone():
    from perfbench.reference.models import layers
    from perfbench.reference.ops import crop, plain_kernels

    before = (layers.conv_nhwc, layers.conv_transpose_nhwc,
              plain_kernels.icn_stem_conv_plain, crop.scale_and_translate)
    with calibrate_bf16.reduced_mantissa():
        x = torch.randn(1, 4, 4, 3).to(torch.bfloat16)
        w = torch.randn(2, 3, 1, 1)
        y = layers.conv_nhwc(x, w, None)
        assert torch.equal(y, calibrate_bf16.clear_low_mantissa(y))
    with calibrate_bf16.paste_without_antialias():
        assert crop.scale_and_translate is not before[3]
    assert (layers.conv_nhwc, layers.conv_transpose_nhwc,
            plain_kernels.icn_stem_conv_plain, crop.scale_and_translate) == before
