"""Train -> export -> serve in the PyTorch port, on the CPU: ``cli.train`` runs,
``cli/export_zoo`` writes them into the reference's checkpoint tree, and
``checkpoint.load_reference_model_zoo`` serves them back, equal to the trained
networks (the port's counterpart of tests/test_train_export_chain.py).

The EdgeConnect pair runs at 32^2, batch 1 (the CLI's full-width networks), 2 steps
and a ``--resume`` to 3; the served edge generator is the trained one's eval-mode
network (its spectral norm folded from the stored u and v), not its raw weights
(fault F8 of the JAX exporter). The six-family chain is marked slow, as the JAX one.
"""
import json

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.cli import export_zoo
from future_urban_scene_generation_tpu_torch.cli import train as cli_train
from future_urban_scene_generation_tpu_torch.models import edgeconnect, layers, vgg
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, training
from future_urban_scene_generation_tpu_torch.pipeline.service import InpaintModels
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
import torch_threads  # noqa: F401


def _train(tmp_path, model, size, batch, extra=()):
    out = tmp_path / f"run_{model}"
    common = ["--model", model, "--image-size", str(size), "--batch", str(batch),
              "--device", "cpu", "--out", str(out), "--log-interval", "1",
              "--save-interval", "1", *extra]
    assert cli_train.main(common + ["--steps", "2"]) == 0
    assert cli_train.main(common + ["--steps", "3", "--resume"]) == 0
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2]  # the resumed run picked up at 2
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k not in ("step", "time"))
    return out, recs


def _trained_gen(run, model):
    """The run's generator as a training module would hold it, in eval mode."""
    saved = torch.load(run / "checkpoint.pt", weights_only=True)
    net = (edgeconnect.EdgeGenerator(spectral=True) if model == "edge"
           else edgeconnect.InpaintGenerator())
    net.load_state_dict(saved["gen"], strict=True)
    return net.eval(), saved


def _write_vgg(path):
    """A seeded VGG19 in torchvision's layout (trunk and classifier), as a user's
    ``vgg19.pth`` would be."""
    sd = layers.seeded_init_(vgg.VGG19Classifier(1000), torch.Generator().manual_seed(8)).state_dict()
    torch.save(sd, path)
    return sd


def test_edgeconnect_train_export_serve(tmp_path, capsys):
    vgg_sd = _write_vgg(tmp_path / "vgg19.pth")
    edge_run, edge_recs = _train(tmp_path, "edge", 32, 1)
    inpaint_run, recs = _train(tmp_path, "inpaint", 32, 1,
                               ["--vgg-weights", str(tmp_path / "vgg19.pth")])
    out = capsys.readouterr().out
    assert "loaded pretrained VGG19 features" in out and "WARNING" not in out
    assert set(edge_recs[0]) == {"step", "time", "l_d1", "l_g1", "l_fm"}
    assert set(recs[0]) == {"step", "time", "l_d2", "l_g2", "l_l1", "l_per", "l_sty"}
    # The u of every spectral layer moved from its initial draw (the last conv of
    # the discriminator has a one-entry u, +-1).
    fresh = training.EdgeModelTrainer().init(torch.Generator().manual_seed(10), device="cpu")
    saved = torch.load(edge_run / "checkpoint.pt", weights_only=True)
    assert saved["iteration"] == 3
    for net in ("gen", "dis"):
        for k, v in getattr(fresh, net).state_dict().items():
            if k.endswith("weight_u") and v.numel() > 1:
                assert not torch.equal(saved[net][k], v), (net, k)

    zoo = tmp_path / "checkpoints"
    assert export_zoo.main(["--runs", f"edge={edge_run}", f"inpaint={inpaint_run}",
                            "--out", str(zoo)]) == 0
    for name in ("edge", "inpaint"):
        wrapped = torch.load(checkpoint.zoo_path(zoo, name), weights_only=True)
        assert set(wrapped) == {"iteration", "generator"} and wrapped["iteration"] == 3
    served = InpaintModels(*edgeconnect.build_generators(device="cpu"))
    assert checkpoint.load_reference_model_zoo(zoo, served) == ["edge", "inpaint"]
    x = torch.rand(1, 32, 32, 4, generator=torch.Generator().manual_seed(1))
    for name, net in (("edge", served.edge), ("inpaint", served.inpaint)):
        trained, _ = _trained_gen(edge_run if name == "edge" else inpaint_run, name)
        inp = x[..., :3] if name == "edge" else x
        with torch.no_grad():
            torch.testing.assert_close(net(inp), trained(inp), rtol=0, atol=1e-5)
    # The loss trunk the run used is the file's.
    loaded = vgg.load_vgg19_features(tmp_path / "vgg19.pth", device="cpu")
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, vgg_sd[k]), k


def test_inpaint_without_vgg_weights_warns(capsys):
    net = cli_train.loss_vgg(None, 10, device="cpu")
    assert "WARNING: no --vgg-weights given" in capsys.readouterr().out
    assert not net.training and not any(p.requires_grad for p in net.parameters())
    again = cli_train.loss_vgg(None, 10, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(net.parameters(), again.parameters()))


@pytest.mark.slow
def test_six_family_train_export_serve_chain(tmp_path):
    """Every family: trained by ``cli.train``, exported by ``cli/export_zoo``, served
    by ``load_reference_model_zoo`` into the scene's and the inpaint branch's
    networks, equal to the trained weights (the edge generator's folded)."""
    runs = {
        "icn": _train(tmp_path, "icn", 256, 1)[0],
        "vunet": _train(tmp_path, "vunet", 256, 1)[0],
        "hourglass": _train(tmp_path, "hourglass", 64, 2)[0],
        "cad": _train(tmp_path, "cad", 64, 2)[0],
        "edge": _train(tmp_path, "edge", 32, 1)[0],
        "inpaint": _train(tmp_path, "inpaint", 32, 1)[0],
    }
    zoo = tmp_path / "checkpoints"
    assert export_zoo.main(["--runs", *(f"{m}={r}" for m, r in runs.items()),
                            "--out", str(zoo)]) == 0
    models = Models.build(ModelSpec(vunet_256=True), device="cpu")
    inpaint = InpaintModels(*edgeconnect.build_generators(device="cpu"))
    assert sorted(checkpoint.load_reference_model_zoo(zoo, models)
                  + checkpoint.load_reference_model_zoo(zoo, inpaint)) == sorted(runs)
    for name, run in runs.items():
        saved = torch.load(run / "checkpoint.pt", weights_only=True)
        if name == "edge":
            trained, _ = _trained_gen(run, name)
            want = {k: v for k, v in trained.state_dict().items()
                    if not k.endswith(("weight_u", "weight_v"))}
            for mname, m in trained.named_modules():
                if isinstance(m, (layers.SNConv2d, layers.SNConvTranspose2d)):
                    del want[f"{mname}.weight_orig"]
                    want[f"{mname}.weight"] = m.effective_weight().detach()
        else:
            want = saved["gen" if name in ("icn", "inpaint") else "module"]
        net = getattr(inpaint if name in ("edge", "inpaint") else models, name)
        got = net.state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-7, msg=f"{name} {k}")
