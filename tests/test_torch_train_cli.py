"""``cli.train`` of the PyTorch port for the VUNet, hourglass and CAD-classifier
families on the CPU: one step, ``--resume`` to two (continuing from the saved
iteration), the widened checkpoint's round trip, and the saved network loading
strict into the scene's ``Models``. (The ICN family: tests/test_torch_training.py;
the EdgeConnect pair: tests/test_torch_train_chain.py.)
"""
import json

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.cli import train as cli_train
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, training
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import ModelSpec


@pytest.fixture(scope="module", autouse=True)
def few_intra_op_threads():
    """The whole suite runs in several worker processes at once; a few threads an op
    keep this file's full-width networks from oversubscribing the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("model,field,size", [
    ("vunet", "vunet", 256), ("hourglass", "hourglass", 64), ("cad", "cad", 64)])
def test_cli_trains_resumes_and_serves(tmp_path, model, field, size):
    """``cli.train --device cpu``: 1 step, ``--resume`` to 2 (continuing from the
    saved iteration), and the saved module loads strict into the scene's network."""
    out = tmp_path / model
    common = ["--model", model, "--batch", "1" if model == "vunet" else "2", "--device", "cpu",
              "--out", str(out), "--log-interval", "1", "--save-interval", "1",
              "--image-size", str(size)]
    assert cli_train.main(common + ["--steps", "1"]) == 0
    assert cli_train.main(common + ["--steps", "2", "--resume"]) == 0
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
    saved = torch.load(out / "checkpoint.pt", weights_only=True)
    assert saved["iteration"] == 2 and set(saved) == {"module", "opt", "iteration"}
    models = Models.build(ModelSpec(vunet_256=size == 256), device="cpu")
    net = getattr(models, field)
    net.load_state_dict(saved["module"], strict=True)
    # save / restore round trip of the widened checkpoint, and a wrong kind of file
    _trainer, state, _make_batch = cli_train.family_setup(model, seed=0, batch=1, lr=1e-4,
                                                   image_size=size, device="cpu")
    checkpoint.restore(out / "checkpoint.pt", state)
    assert state.iteration == 2
    for k, v in state.module.state_dict().items():
        assert torch.equal(v, saved["module"][k]), k
    icn_state = training.ICNTrainer(ndf=8).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(KeyError):
        checkpoint.restore(out / "checkpoint.pt", icn_state)


def test_cli_refuses_what_it_cannot_train(capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        cli_train.main(["--model", "vunet", "--device", "cpu", "--image-size", "128"])
    assert exc.value.code != 0
    assert "256x256" in capsys.readouterr().err
    # The inpainting model parses and trains (one step at 32^2; its chain:
    # tests/test_torch_train_chain.py).
    out = tmp_path / "inpaint"
    assert cli_train.main(["--model", "inpaint", "--device", "cpu", "--image-size", "32",
                           "--batch", "1", "--steps", "1", "--log-interval", "1",
                           "--out", str(out)]) == 0
    rec = json.loads((out / "metrics.jsonl").read_text())
    assert np.isfinite([rec[k] for k in ("l_d2", "l_g2", "l_l1", "l_per", "l_sty")]).all()
    assert cli_train.build_parser().get_default("device") == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli_train.main(["--model", "cad"])
