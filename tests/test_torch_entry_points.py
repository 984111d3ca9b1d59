"""Entry points of the PyTorch port: which device they run on, what they import,
and the synthetic demo (the path of kernel K1') on the CPU at a small size.
"""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.examples import demo_synthetic
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic, training
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils.native import read_png

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "future_urban_scene_generation_tpu_torch"


def test_every_module_imports_without_jax():
    """Every module of the port imports in a fresh interpreter, and neither ``jax``
    nor anything of the JAX package is loaded by it."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py") if "_build" not in p.parts
    )
    assert len(modules) > 40 and f"{PKG.name}.cli.run_test" in modules
    for new in ("gui.web", "gui.app", "cli.warmup", "ops.heatmap"):
        assert f"{PKG.name}.{new}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "jax_pkg = 'future_urban_scene_generation_tpu'\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'jaxlib' or m == jax_pkg or m.startswith(jax_pkg + '.')]\n"
        "assert not bad, bad\n"
        "for opt in ('yaml', 'cv2', 'PIL', 'PyQt5', 'matplotlib'):\n"
        "    assert opt not in sys.modules, opt\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(REPO), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("fn", [
    runner.build_cad_bank, synthetic.make_bench_scene, synthetic.oracle_perception,
    stages.Models.build, training.ICNTrainer.init, training.VunetTrainer.init,
    training.HourglassTrainer.init, training.CadClassifierTrainer.init,
], ids=lambda f: f.__qualname__)
def test_library_entry_points_require_a_device(fn):
    """No library entry point picks a device for its caller."""
    p = inspect.signature(fn).parameters["device"]
    assert p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is inspect.Parameter.empty


def test_entry_points_default_to_cuda_and_raise_without_a_card(tmp_path):
    from future_urban_scene_generation_tpu_torch.cli import run_test, train, warmup
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig

    assert run_test.build_parser().get_default("device") == "cuda"
    assert train.build_parser().get_default("device") == "cuda"
    assert warmup.build_parser().get_default("device") == "cuda"
    assert PipelineConfig().device == "cuda"
    assert inspect.signature(demo_synthetic.main).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_synthetic.main(tmp_path / "strip.png")
    assert not (tmp_path / "strip.png").exists()


def test_demo_on_cpu_writes_a_strip(tmp_path):
    """The demo at a quarter of its size (90x160, 2 steps): the oracle keypoints fit
    (PnP error under 1 px^2, as the JAX demo prints it), the strip decodes to what
    was returned, and the car is drawn into both branches."""
    out = tmp_path / "strip.png"
    spec = ModelSpec(warp_plane_res=96)
    err, strip = demo_synthetic.main(out, "cpu", hw=(90, 160), steps=2, spec=spec)
    assert 0.0 <= err < 1.0
    assert strip.shape == (2 * 90, 2 * 160, 3) and strip.dtype == np.uint8
    np.testing.assert_array_equal(read_png(out), strip)
    _, frame, background, perception, _, _ = demo_synthetic.demo_inputs("cpu", (90, 160), 2, 2)
    car = (frame - background).abs().amax(-1) > 0.02
    assert 0.01 < float(car.float().mean()) < 0.5  # render_normal_sketch drew the car
    bg_u8 = np.clip(background.numpy() * 255.0, 0, 255).astype(np.uint8)
    for row in (strip[:90], strip[90:]):  # ICN branch, VUNet branch; step 0 each
        changed = np.abs(row[:, :160].astype(int) - bg_u8).max(-1) > 4
        assert changed.mean() > 0.005
    assert perception.kp_frame.shape == (1, 12, 2)
