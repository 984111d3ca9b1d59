"""Runs of tiny cells on the CPU through the harness (the look for a card skipped):
the result line's keys, and ``correct`` coming out false with the timed path broken
underneath: a scene's answer altered where it is produced, a conv's bias dropped, a training step that leaves its state unchanged,
half of each batch left out, a batch altered where it is made. On the card (``-m chip``): the control, the reference in
TF32 in the program's place at the cell's own size, fails the cell's limits."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run as bench_run
from perfbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def _limits(cell):
    return json.loads((REPO / "perfbench" / "cells" / f"{cell}.json").read_text())["limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    r = tiny.make_root(tmp_path_factory.mktemp("bench"))
    tiny.with_limits(r, "scene-tiny.tiny", _limits("scene-720p-f32.v4"))
    tiny.with_limits(r, "train-tiny.tiny", _limits("icn-train-256-f32.b8"))
    return r


def _run(root, cell, trace=False):
    return bench_run.run_cell(root, cell, SEED, 0.5, trace, device="cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_scene_result_line(root, trace):
    result = _run(root, "scene-tiny.tiny", trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert "pose.host_ms" in result["metrics"]
    else:
        assert set(result["metrics"]) == {"frames_per_s", "scene_p90_ms", "setup_s"}
    json.dumps(result)


def test_train_result_line(root):
    result = _run(root, "train-tiny.tiny")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_scene_answer_altered_is_not_correct(root, monkeypatch):
    from future_urban_scene_generation_tpu_torch.pipeline import runner

    real = runner.run_scene

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        frames = res.frames_icn.clone()
        frames[:, : frames.shape[1] // 8] += 0.25
        return res._replace(frames_icn=frames)

    monkeypatch.setattr(runner, "run_scene", altered)
    assert _run(root, "scene-tiny.tiny")["correct"] is False


def test_conv_bias_dropped_is_not_correct(root, monkeypatch):
    """The hourglass stem's conv run without its bias."""
    from future_urban_scene_generation_tpu_torch.models import layers

    real = layers.Conv2d.forward

    def forward(self, x):
        if tuple(self.weight.shape) == (64, 3, 7, 7):
            return layers.conv_nhwc(x, self.weight, None, self.stride, self.padding,
                                    self.dilation)
        return real(self, x)

    monkeypatch.setattr(layers.Conv2d, "forward", forward)
    assert _run(root, "scene-tiny.tiny")["correct"] is False


def test_train_state_unchanged_is_not_correct(root, monkeypatch):
    from future_urban_scene_generation_tpu_torch.pipeline import training

    def unchanged(self, state, inputs, targets):
        with torch.no_grad():
            fake = state.gen(inputs)
            l1 = torch.mean(torch.abs(fake - targets))
        return state, {"l_d": l1, "l_g": l1, "l_l1": l1}

    monkeypatch.setattr(training.ICNTrainer, "train_step", unchanged)
    assert _run(root, "train-tiny.tiny")["correct"] is False


def test_train_half_batch_is_not_correct(root, monkeypatch):
    from future_urban_scene_generation_tpu_torch.pipeline import training

    real = training.ICNTrainer.train_step

    def half(self, state, inputs, targets):
        b = inputs.shape[0] // 2
        return real(self, state, inputs[:b], targets[:b])

    monkeypatch.setattr(training.ICNTrainer, "train_step", half)
    assert _run(root, "train-tiny.tiny")["correct"] is False


def test_train_batch_altered_is_not_correct(root, monkeypatch):
    """Each batch's first target flipped upside down where ``make_batch`` makes it."""
    from future_urban_scene_generation_tpu_torch.cli import train as train_cli

    real = train_cli.family_setup

    def setup(*args, **kwargs):
        trainer, state, make_batch = real(*args, **kwargs)

        def altered():
            inputs, targets = make_batch()
            targets = targets.clone()
            targets[0] = targets[0].flip(0)
            return inputs, targets

        return trainer, state, altered

    monkeypatch.setattr(train_cli, "family_setup", setup)
    result = _run(root, "train-tiny.tiny")
    check = result["checks"]["batch_mean_abs"]
    assert result["correct"] is False and check["value"] > check["limit"]


def test_jax_loaded_stops_the_run(root, monkeypatch):
    from perfbench.harness import jaxcheck

    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    with pytest.raises(jaxcheck.JaxLoaded):
        bench_run.run_cell(root, "scene-tiny.tiny", SEED, 0.5, False, device="cpu")


def test_bare_checkout_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and perfbench/ the run fails (here for
    want of a card, on the card for want of the port) and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "scene-720p-f32.v4", "--seed", str(SEED), "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["scene-720p-f32.v4", "icn-train-256-f32.b8",
                                  "scene-720p-f32.v16"])
def test_control_fails_the_limits(card, cell):
    """The control (the reference with TF32 on, in the program's place) read at the
    cell's own size breaks at least one of the cell's limits, on three seeds."""
    from perfbench import calibrate
    from perfbench.harness import bench
    from perfbench.judge import checks, passed

    c = bench.load_cell(REPO, cell)
    control = calibrate.scene_control if c.cell["entry"] == "stream" else calibrate.train_control
    for seed in (SEED, SEED + 1, SEED + 2):
        run, _, held = bench_run.drive(c, seed, 1.0, False, card)
        readings = control(run, held)["control"]
        print(cell, seed, "control", readings)
        assert not passed(checks(readings, c.cell["limits"]))
