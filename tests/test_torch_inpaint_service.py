"""The inpaint branch of the PyTorch port's serving entry point (``cli.run_test
--inpaint`` -> ``SceneService._backgrounds``) against the JAX service, on the
CityFlow-shaped directory of tests/test_torch_service_cli.py.

The background stack the port builds (six future frames with the selected vehicle
erased: the background-difference segmenter, Canny, EdgeConnect's two generators at
their fixed 256^2 crop, 8 blocks) is compared with the JAX service's at the
``_scene_program(scene_args)`` seam, within the generators' 2e-3 of
tests/test_edgeconnect.py. Then the CLI end to end on the CPU with each segmenter:
the 12 PNGs, and Canny's ``SIGMA`` read from ``inpainting/config.yml`` (fault F3).
"""
import shutil

import numpy as np
import pytest
import torch
import yaml

from future_urban_scene_generation_tpu.models import convert as jconvert
from future_urban_scene_generation_tpu.models.edgeconnect import EDGECONNECT_CONVT_KEYS
from future_urban_scene_generation_tpu_torch.cli import run_test
from future_urban_scene_generation_tpu_torch.models import convert, edgeconnect
from future_urban_scene_generation_tpu_torch.models.maskrcnn import MaskRCNN
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, inpaint, runner, service
from future_urban_scene_generation_tpu_torch.utils.native import read_png, write_png
from test_torch_service_cli import H, W, _Captured, _configs, _JaxHostService, dataset  # noqa: F401
from torch_refs import _t_ec_generator

GEN_TOL = 2e-3  # tests/test_edgeconnect.py:30


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def inpaint_dataset(dataset, tmp_path_factory):  # noqa: F811
    """The dataset with vehicle 7's boxes one pixel wider and taller (61 x 41) and a
    ``background_frame.png``: where 0.3 x a side is an integer (60, 40) the JAX
    service's jitted erase puts the context window a pixel off the reference's
    (``inpaint.context_window``)."""
    root = tmp_path_factory.mktemp("inpaint_data")
    shutil.copytree(dataset.parents[2], root, dirs_exist_ok=True)
    video_dir = root / "train" / "S01" / "c001"
    mtsc = video_dir / "mtsc" / "mtsc_tc_ssd512.txt"
    rows = np.loadtxt(mtsc, delimiter=",")
    rows[rows[:, 1] == 7, 4:6] += 1
    np.savetxt(mtsc, rows, delimiter=",")
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    bg = np.stack([xx / W, yy / H, 0.4 + 0 * xx], -1)
    write_png(video_dir / "background_frame.png", (bg * 255.0).astype(np.uint8))
    return video_dir


@pytest.fixture(scope="module")
def reference_generators():
    """Seeded reference EdgeConnect generators (8 blocks, the edge one with spectral
    norm): their state dicts, the JAX package's params, the port's networks."""
    torch.manual_seed(5)
    edge_t = _t_ec_generator(3, 1, use_sn=True, blocks=8).eval()
    inpaint_t = _t_ec_generator(4, 3, use_sn=False, blocks=8).eval()
    sds = {"edge": edge_t.state_dict(), "inpaint": inpaint_t.state_dict()}
    params = tuple(jconvert.convert_state_dict(sds[k], convt_keys=EDGECONNECT_CONVT_KEYS)
                   for k in ("edge", "inpaint"))
    nets = service.InpaintModels(*edgeconnect.build_generators(device="cpu"))
    for name, net in zip(nets._fields, nets):
        net.load_state_dict(convert.fold_spectral_norm(sds[name]), strict=True)
    return sds, params, nets


def test_inpaint_backgrounds_match_jax_service(inpaint_dataset, tmp_path, reference_generators):
    """One vehicle, frame 1: the (6, H, W, 3) background stack of both services. The
    JAX service is handed only the real vehicle's row (its three padding rows have
    empty context windows: they write no pixel, and would cost three 256^2 erases a
    frame on the CPU); the port's service gets the padded request as it comes."""
    _, params, nets = reference_generators

    class JaxInpaint(_JaxHostService):
        def _load_models(self):
            self.models = None
            self.edge_params, self.inpaint_params = params

        def _backgrounds(self, frame, frame_id, bboxes):
            return super()._backgrounds(frame, frame_id, bboxes[np.any(bboxes != 0, axis=1)])

    class PortInpaint(service.SceneService):
        def _load_models(self):
            self.spec, self.models, self.inpaint_models = self.cfg.model_spec(), None, nets

        def _scene_program(self, scene_args):
            self.captured = scene_args
            raise _Captured

    cfg_j, cfg_t = _configs(inpaint_dataset, tmp_path, inpaint=True)
    sj, st = JaxInpaint(cfg_j), PortInpaint(cfg_t)
    assert cfg_j.edgeconnect.sigma == cfg_t.edgeconnect.sigma == 2.0
    for svc in (sj, st):
        with pytest.raises(_Captured):
            svc.run_request(1, [7])
    frame_j, bg_j, boxes_j = (np.asarray(a) for a in sj.captured[2:5])
    frame_t, bg_t, boxes_t = (a.numpy() for a in st.captured[2:5])
    np.testing.assert_array_equal(boxes_t, boxes_j)
    assert bg_t.shape == bg_j.shape == (6, H, W, 3) and bg_t.dtype == np.float32
    assert np.abs(bg_t - bg_j).max() < GEN_TOL
    # The vehicle was erased: its box changed at every step, and nothing changed
    # outside its context window.
    x0, y0, x1, y1 = boxes_t[0].astype(int)
    frames = [st.reader.read(1 + 2 * n) for n in range(6)]
    win = inpaint.context_window(torch.from_numpy(boxes_t[0]), (H, W))
    wx0, wy0 = int(win.x_start), int(win.y_start)
    outside = np.ones((H, W), bool)
    outside[wy0:wy0 + int(win.h), wx0:wx0 + int(win.w)] = False
    for n in range(6):
        np.testing.assert_array_equal(bg_t[n][outside], frames[n][outside])
        assert np.abs(bg_t[n, y0:y1, x0:x1] - frames[n][y0:y1, x0:x1]).max() > 0.05


def _small_maskrcnn_zoo(ckpt):
    """A seeded small Mask R-CNN (5 classes) with its sidecar: every class counts as a
    vehicle and any overlap qualifies, so random weights still give masks."""
    model = MaskRCNN.build(torch.Generator().manual_seed(2), device="cpu", num_classes=5,
                           layers=(1, 1, 1, 1), width=8, out_channels=16,
                           representation_size=32)
    path = checkpoint.zoo_path(ckpt, "maskrcnn")
    path.parent.mkdir(parents=True)
    torch.save({"model": model.state_dict()}, path)
    (path.parent / "config.yml").write_text(
        "# a reduced configuration\nnum_classes: 5\nlayers: [1, 1, 1, 1]\nwidth: 8\n"
        "out_channels: 16\nrepresentation_size: 32\ninput_hw: [128, 128]\n"
        "classes: [1, 2, 3, 4]\nmin_iou: 0.0\n")


@pytest.mark.parametrize("segmenter", ["background", "maskrcnn"])
def test_cli_inpaint_end_to_end(inpaint_dataset, tmp_path, monkeypatch, segmenter):
    """``cli.run_test --inpaint --device cpu`` answers one request from zoo files
    (one residual block to keep the CPU run short; the files say how many): the
    erased background stack reaches the scene and the 12 PNGs (the scene is replaced
    by one that returns its backgrounds: tests/test_torch_service_cli.py drives the
    real one through the CLI), and ``SIGMA: 3`` from ``inpainting/config.yml``
    reaches the erase (F3)."""
    ckpt = tmp_path / "ckpt"
    edge, inp = edgeconnect.build_generators(torch.Generator().manual_seed(1), device="cpu",
                                             residual_blocks=1)
    for name, net in (("edge", edge), ("inpaint", inp)):
        path = checkpoint.zoo_path(ckpt, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"iteration": 3, "generator": net.state_dict()}, path)
    (ckpt / "inpainting" / "config.yml").write_text(yaml.safe_dump({"SIGMA": 3, "MODE": 1}))
    if segmenter == "maskrcnn":
        _small_maskrcnn_zoo(ckpt)

    seen = {"sigma": [], "masks": []}
    real_erase = inpaint.erase_vehicles

    def erase(edge_gen, inpaint_gen, frames, bboxes, masks, sigma=2.0):
        seen["sigma"].append(sigma)
        seen["masks"].append(masks)
        return real_erase(edge_gen, inpaint_gen, frames, bboxes, masks, sigma)

    def program(self, scene_args):
        def run(*args):
            seen["args"] = args
            bg, n = args[3], len(args[4])
            seen["result"] = runner.SceneResult(bg, bg, torch.zeros(n),
                                                torch.zeros(n, dtype=torch.long))
            return seen["result"]
        return run

    monkeypatch.setattr(inpaint, "erase_vehicles", erase)
    monkeypatch.setattr(service.SceneService, "_scene_program", program)
    out_dir = tmp_path / "results"
    rc = run_test.main([
        str(inpaint_dataset), str(tmp_path / "no_kpoints"), str(ckpt), "--inpaint",
        "--segmenter", segmenter, "--select-ids", "7", "--frame-id", "1",
        "--output-dir", str(out_dir), "--frame-hw", "-1", "-1", "--device", "cpu",
    ])
    assert rc == 0
    assert seen["sigma"] == [3.0]
    masks = seen["masks"][0]
    assert masks.shape == (6, 1, H, W) and bool(masks.any())
    _, _, frame, background, bboxes, _, _ = seen["args"]
    assert background.shape == (6, H, W, 3) and bboxes.shape == (4, 4)
    x0, y0, x1, y1 = bboxes[0].numpy().astype(int)
    assert float((background[0, y0:y1, x0:x1] - frame[y0:y1, x0:x1]).abs().max()) > 0.05
    pngs = sorted(out_dir.rglob("*.png"))
    assert len(pngs) == 12
    want = np.clip(background.numpy() * 255.0, 0, 255).astype(np.uint8)
    for branch in ("warp&learn", "vunet"):
        for i, fid in enumerate(range(1, 12, 2)):
            got = read_png(out_dir / branch / "S01_c001" / f"{fid:04}.png")
            np.testing.assert_array_equal(got, want[i])
