"""The PyTorch port's serving entry point (``cli.run_test`` -> ``SceneService``) on
the synthetic CityFlow-shaped directory of tests/test_service_cli.py, against the
JAX package's service.

The host half of a request (future tracks, int-truncated boxes, float64 meters, the
6-step and 4-vehicle padding) is compared with the JAX service at its
``_scene_program(scene_args)`` seam, without running a scene: boxes exactly, meters
to 1e-6 (both cast float64 to float32 at the device boundary). The device half is
the port's own ``run_scene`` (held to JAX in test_torch_pipeline.py): the CLI's 12
PNGs must hold exactly its frames, converted on the device.
"""
import warnings

import numpy as np
import pytest
import torch
import yaml

from future_urban_scene_generation_tpu.config import PipelineConfig as JPipelineConfig
from future_urban_scene_generation_tpu.pipeline.service import SceneService as JSceneService
from future_urban_scene_generation_tpu_torch.cli import run_test
from future_urban_scene_generation_tpu_torch.config import PipelineConfig
from future_urban_scene_generation_tpu_torch.pipeline import aot, runner, service
from future_urban_scene_generation_tpu_torch.utils.native import read_png
import torch_threads  # noqa: F401

H, W = 240, 320


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """S01/c001/{frames/, calibration.txt, mtsc/...} with intrinsic.npy two levels
    up, as tests/test_service_cli.py:10-43, plus more vehicles: id 9 with
    fractional boxes near the frame's edge, id 5 with a short track (frames 10-12),
    id 4 with a single row."""
    root = tmp_path_factory.mktemp("data")
    video_dir = root / "train" / "S01" / "c001"
    (video_dir / "frames").mkdir(parents=True)
    (video_dir / "mtsc").mkdir()
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    bg = np.stack([xx / W, yy / H, 0.4 + 0 * xx], -1)
    for i in range(12):
        frame = bg.copy()
        frame[100:140, 60 + 6 * i: 120 + 6 * i] = [0.8, 0.2, 0.2]  # moving "vehicle"
        np.save(video_dir / "frames" / f"{i:04}.npy", frame)
    rows = []
    for i in range(12):
        rows.append([i + 1, 7, 60 + 6 * i, 100, 60, 40, 1, -1, -1, -1])
        rows.append([i + 1, 9, 250.7 + 5.3 * i, 180.9 - 2.2 * i, 70.6, 55.4, 1, -1, -1, -1])
        if i >= 9:
            rows.append([i + 1, 5, 20.5 + 3 * i, 30.2, 50.9, 35.1, 1, -1, -1, -1])
    rows.append([12, 4, 10, 10, 30, 30, 1, -1, -1, -1])
    np.savetxt(video_dir / "mtsc" / "mtsc_tc_ssd512.txt", np.asarray(rows), delimiter=",")
    hmat = np.array([[1e-5, 0, 45.0], [0, 1e-5, 11.0], [0, 0, 1.0]])
    matrix_str = ";".join(" ".join(str(v) for v in row) for row in hmat)
    (video_dir / "calibration.txt").write_text(
        yaml.safe_dump({"Homography matrix": matrix_str}))
    np.save(root / "intrinsic.npy",
            np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]], np.float32))
    return video_dir


class _Captured(Exception):
    pass


class _JaxHostService(JSceneService):
    """The JAX service without its networks: ``run_request`` runs its host half and
    stops at the scene-program seam."""

    def _load_models(self):
        self.models = self.edge_params = self.inpaint_params = None

    def _scene_program(self, scene_args):
        self.captured = scene_args
        raise _Captured


class _PortHostService(service.SceneService):
    def _load_models(self):
        self.spec, self.models = self.cfg.model_spec(), None

    def _scene_program(self, scene_args):
        self.captured = scene_args
        raise _Captured


def _configs(dataset, tmp_path, **kw):
    common = dict(video_dir=dataset, kpoints_dir=tmp_path / "nokp",
                  checkpoints_dir=tmp_path / "nockpt", output_dir=tmp_path / "out", **kw)
    cfg_j, cfg_t = JPipelineConfig(**common), PipelineConfig(device="cpu", **common)
    cfg_j.runtime.frame_hw = cfg_t.runtime.frame_hw = None
    return cfg_j, cfg_t


@pytest.mark.parametrize("frame_id,ids,bbox_scale,n_real", [
    (1, [7], 1.0, 1),
    (3, [7, 9], 1.0, 2),
    (2, [9, 4, 7], 1.3, 2),  # id 4 has no row yet usable: skipped
    (9, [5, 7, 9], 0.8, 3),  # short tracks: 2 rows each, padded to 6 steps
    (1, [7, 9, 7, 9, 7], 1.0, 5),  # second bucket: 5 -> 8 vehicles
])
def test_request_arguments_match_jax_service(dataset, tmp_path, frame_id, ids, bbox_scale,
                                             n_real):
    cfg_j, cfg_t = _configs(dataset, tmp_path, bbox_scale=bbox_scale)
    sj, st = _JaxHostService(cfg_j), _PortHostService(cfg_t)
    with pytest.raises(_Captured):
        sj.run_request(frame_id, ids)
    with pytest.raises(_Captured):
        st.run_request(frame_id, ids)
    _, bank_j, frame_j, bg_j, boxes_j, meters_j, k_j = sj.captured
    _, bank_t, frame_t, bg_t, boxes_t, meters_t, k_t = st.captured
    bucket = -(-n_real // 4) * 4
    assert boxes_t.shape == (bucket, 4) and meters_t.shape == (bucket, 6, 2)
    assert boxes_t.dtype == meters_t.dtype == frame_t.dtype == torch.float32
    np.testing.assert_array_equal(boxes_t.numpy(), np.asarray(boxes_j))
    assert not boxes_t[n_real:].any() and not meters_t[n_real:].any()
    # Meters: float64 on the host in both, float32 at the device boundary.
    np.testing.assert_allclose(meters_t.numpy(), np.asarray(meters_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(frame_t.numpy(), np.asarray(frame_j))
    np.testing.assert_array_equal(bg_t.numpy(), np.asarray(bg_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    assert st.frame_hw == sj.frame_hw == (H, W)
    np.testing.assert_allclose(bank_t.vertices.numpy(), np.asarray(bank_j.vertices), atol=0)
    np.testing.assert_array_equal(bank_t.triangles.numpy(), np.asarray(bank_j.triangles))


def test_request_errors_match_jax_service(dataset, tmp_path):
    cfg_j, cfg_t = _configs(dataset, tmp_path)
    sj, st = _JaxHostService(cfg_j), _PortHostService(cfg_t)
    for svc in (sj, st):
        with pytest.raises(ValueError, match="usable future track"):
            svc.run_request(12, [4, 7])  # one row each from frame 12 on
        with pytest.raises(ValueError, match="usable future track"):
            svc.run_request(1, [123])
        with pytest.raises(IOError):
            svc.run_request(40, [7])  # past the last frame


def test_static_background_png_is_used(dataset, tmp_path):
    """``background_frame.png`` beside the frames becomes the background (decoded by
    the port's own reader: no cv2), at the working resolution."""
    from future_urban_scene_generation_tpu_torch.utils.native import write_png

    rng = np.random.RandomState(0)
    bg_u8 = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    path = dataset / "background_frame.png"
    write_png(path, bg_u8)
    try:
        cfg_j, cfg_t = _configs(dataset, tmp_path)
        sj, st = _JaxHostService(cfg_j), _PortHostService(cfg_t)
        _, background, _, _ = st.request_arguments(1, [7])
        np.testing.assert_array_equal(background, bg_u8.astype(np.float32) / 255.0)
        np.testing.assert_array_equal(background, sj._static_background())
    finally:
        path.unlink()


def test_service_refuses_unported_parts_and_missing_card(dataset, tmp_path, monkeypatch):
    # The inpaint branch's weight files are missing: an error that names them, never
    # a request served without the erase.
    for kw, names in ((dict(inpaint=True), "EdgeModel_gen.pth and .*InpaintingModel_gen.pth"),
                      (dict(segmenter="maskrcnn"), "maskrcnn.pth")):
        with pytest.raises(FileNotFoundError, match=names):
            service.SceneService(_configs(dataset, tmp_path, **kw)[1])
    # An aot_dir without artifacts (pipeline/aot.py) is taken: every request misses and
    # is served by the live runner, without a warning.
    cfg = _configs(dataset, tmp_path)[1]
    cfg.runtime.aot_dir = tmp_path / "aot"
    svc = _PortHostService(cfg)
    stand_ins = (torch.zeros(0), torch.zeros(0))  # the networks and the CAD bank
    scene_args = (*stand_ins, *(torch.as_tensor(a) for a in svc.request_arguments(1, [7])),
                  torch.as_tensor(svc.intrinsic))
    live = []
    monkeypatch.setattr(runner, "run_scene", lambda *a, spec, vis_res: live.append(a) or "live")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        program = service.SceneService._scene_program(svc, scene_args)
        assert program(*scene_args) == "live"
    assert all(a is b for a, b in zip(live[0], scene_args))
    assert PipelineConfig().device == "cuda"
    if not torch.cuda.is_available():
        cfg = _configs(dataset, tmp_path)[1]
        cfg.device = "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            service.SceneService(cfg)


@pytest.mark.parametrize("flags,names", [
    ([], "--select-ids"),
    # The inpaint branch without its weight files raises, naming them (as the JAX CLI
    # does for maskrcnn.pth); it does not serve without the erase.
    (["--select-ids", "7", "--inpaint"], FileNotFoundError("y/inpainting/EdgeModel_gen.pth")),
    (["--select-ids", "7", "--segmenter", "maskrcnn"],
     FileNotFoundError("y/maskrcnn/maskrcnn.pth")),
    (["--select-ids", "7", "--gui"], "GUI unavailable"),  # no PyQt5 here: the JAX line
    (["--gui"], "use --select-ids for headless mode"),
])
def test_cli_exits_2(dataset, capsys, flags, names):
    argv = [str(dataset), "x", "y", "--device", "cpu", *flags]
    if isinstance(names, Exception):
        with pytest.raises(type(names), match=str(names)):
            run_test.main(argv)
        return
    assert run_test.main(argv) == 2
    assert names in capsys.readouterr().err


def test_cli_flags_match_jax_cli():
    """Every flag of the JAX CLI parses here too, apart from its compile-cache pair."""
    from future_urban_scene_generation_tpu.cli import run_test as jrun_test

    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings} | {
            a.dest for a in parser._actions if not a.option_strings}

    missing = flags(jrun_test.build_parser()) - flags(run_test.build_parser())
    assert missing == {"--jax-cache-dir", "--no-jax-cache"}
    assert run_test.build_parser().get_default("device") == "cuda"


def test_cli_headless_end_to_end(dataset, tmp_path, monkeypatch):
    """``cli.run_test --device cpu`` answers one request: 6 x 2 PNGs in the
    reference's layout whose pixels are ``run_scene``'s frames on the arguments the
    service built, converted to uint8 by clip and truncation."""
    seen = {}

    def program(self, scene_args):
        def run(*args):
            seen["args"] = args
            seen["result"] = runner.run_scene(*args, spec=self.spec)
            return seen["result"]
        return run

    monkeypatch.setattr(service.SceneService, "_scene_program", program)
    out_dir = tmp_path / "results"
    rc = run_test.main([
        str(dataset), str(tmp_path / "no_kpoints"), str(tmp_path / "no_ckpts"),
        "--select-ids", "7", "--frame-id", "1", "--output-dir", str(out_dir),
        "--frame-hw", "-1", "-1", "--device", "cpu",
    ])
    assert rc == 0
    pngs = sorted(out_dir.rglob("*.png"))
    assert len(pngs) == 12
    assert {p.parent.parent.name for p in pngs} == {"warp&learn", "vunet"}
    assert {p.parent.name for p in pngs} == {"S01_c001"}
    assert sorted({p.name for p in pngs}) == [f"{i:04}.png" for i in range(1, 12, 2)]
    models, bank, frame, background, bboxes, meters, _ = seen["args"]
    assert bboxes.shape == (4, 4) and meters.shape == (4, 6, 2) and bank.vertices.shape[0] == 1
    assert all(p.device.type == "cpu" for p in models.icn.parameters())
    for branch, frames in (("warp&learn", seen["result"].frames_icn),
                           ("vunet", seen["result"].frames_vunet)):
        assert frames.shape == (6, H, W, 3) and bool(torch.isfinite(frames).all())
        want = np.clip(frames.numpy() * 255.0, 0, 255).astype(np.uint8)
        for i, fid in enumerate(range(1, 12, 2)):
            got = read_png(out_dir / branch / "S01_c001" / f"{fid:04}.png")
            np.testing.assert_array_equal(got, want[i])
        # The vehicle is drawn: the frames differ from the background in its window.
        x0, y0, x1, y1 = (int(v) for v in bboxes[0])
        diff = (frames[0] - background).abs().amax(-1)[y0:y1, x0:x1]
        assert float(diff.max()) > 0.05


def test_cli_aot_dir_serves_the_request(dataset, tmp_path, monkeypatch):
    """``cli.run_test --aot-dir DIR --device cpu`` writes its 12 PNGs: from the live
    runner while DIR holds no artifact of the request (silently), then from the
    artifact of the request's shapes and spec once one is there. The scene is a
    stand-in on both paths (the whole scene's export and restore are
    test_torch_aot.py's and the card's), so the PNGs say which path served."""
    aot_dir = tmp_path / "aot"
    seen = []

    def live_scene(models, bank, frame, background, bboxes, meters, k, *, spec, vis_res):
        seen.append(((models, bank, frame, background, bboxes, meters, k), spec, vis_res))
        stack = background[None].expand(6, -1, -1, -1)
        return runner.SceneResult(stack, stack, torch.zeros(len(bboxes)),
                                  torch.zeros(len(bboxes), dtype=torch.long))

    def stored_scene(models, bank, frame, background, bboxes, meters, k):
        stack = (1.0 - background)[None].expand(6, -1, -1, -1)
        return runner.SceneResult(stack, stack * 0.5, bboxes[:, 0], bboxes[:, 1].long())

    monkeypatch.setattr(runner, "run_scene", live_scene)
    out_dir = tmp_path / "results"
    argv = [str(dataset), str(tmp_path / "no_kpoints"), str(tmp_path / "no_ckpts"),
            "--select-ids", "7", "--frame-id", "1", "--output-dir", str(out_dir),
            "--frame-hw", "-1", "-1", "--device", "cpu", "--aot-dir", str(aot_dir)]

    def pngs(branch):
        return [read_png(out_dir / branch / "S01_c001" / f"{fid:04}.png")
                for fid in range(1, 12, 2)]

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert run_test.main(argv) == 0
    assert len(sorted(out_dir.rglob("*.png"))) == 12 and len(seen) == 1
    args, spec, vis_res = seen[0]
    background = args[3].numpy()
    want = np.clip(background * 255.0, 0, 255).astype(np.uint8)
    assert all(np.array_equal(p, want) for p in pngs("warp&learn") + pngs("vunet"))

    path = aot.export_program(stored_scene, args, kind="run_scene",
                              static=aot._scene_static(spec, vis_res), directory=aot_dir)
    assert run_test.main(argv) == 0
    assert len(seen) == 1  # served by the artifact: the live runner was not called
    for branch, scale in (("warp&learn", 1.0), ("vunet", 0.5)):
        want = np.clip((1.0 - background) * scale * 255.0, 0, 255).astype(np.uint8)
        assert all(np.array_equal(p, want) for p in pngs(branch)), branch
    assert sorted(p.name for p in aot_dir.iterdir()) == [path.name]


def test_static_background_of_another_size_is_resized_bilinearly(dataset, tmp_path):
    """A ``background_frame.png`` whose size differs from the working resolution is
    decoded by the port's own reader and resized with ``resize_bilinear_np``, with
    or without cv2 (a standing decision: the JAX service needs cv2 for this and
    falls back to the frame without it)."""
    from future_urban_scene_generation_tpu_torch.utils import video as video_io
    from future_urban_scene_generation_tpu_torch.utils.native import write_png

    rng = np.random.RandomState(3)
    bg_u8 = rng.randint(0, 256, (H // 2 + 7, W // 2 + 3, 3)).astype(np.uint8)
    path = dataset / "background_frame.png"
    write_png(path, bg_u8)
    try:
        st = _PortHostService(_configs(dataset, tmp_path)[1])
        assert tuple(st.frame_hw) == (H, W)
        frame, background, _, _ = st.request_arguments(1, [7])
        want = video_io.resize_bilinear_np(read_png(path).astype(np.float32) / 255.0, (H, W))
        assert background.shape == frame.shape == (H, W, 3) and background.dtype == np.float32
        np.testing.assert_array_equal(background, want)
        assert 0.0 <= background.min() and background.max() <= 1.0
        # bilinear, not nearest: away from the source's grid points a value lies
        # strictly between its neighbours
        assert not np.isin(np.round(background * 255.0, 3), np.arange(256.0)).all()
    finally:
        path.unlink()


def test_cli_web_gui_and_gui_are_dispatched(dataset, tmp_path, monkeypatch):
    """``--web-gui`` hands the config, host and port to ``launch_web_gui``; ``--gui``
    hands the config to ``launch_gui``; neither needs ``--select-ids``."""
    from future_urban_scene_generation_tpu_torch.gui import app as gui_app
    from future_urban_scene_generation_tpu_torch.gui import web

    calls = []
    monkeypatch.setattr(web, "launch_web_gui",
                        lambda cfg, host, port: calls.append(("web", cfg, host, port)))
    monkeypatch.setattr(gui_app, "launch_gui", lambda cfg: calls.append(("qt", cfg)) or 0)
    base = [str(dataset), "x", "y", "--device", "cpu", "--frame-id", "3"]
    assert run_test.main([*base, "--web-gui", "--host", "0.0.0.0", "--port", "8123"]) is None
    assert run_test.main([*base, "--gui"]) == 0
    (kind, cfg, host, port), (kind2, cfg2) = calls
    assert (kind, host, port, kind2) == ("web", "0.0.0.0", 8123, "qt")
    assert cfg.frame_id == cfg2.frame_id == 3 and cfg.device == "cpu"
    assert str(cfg.video_dir) == str(dataset)


def test_web_gui_serves_a_real_service(dataset, tmp_path, monkeypatch):
    """``make_server`` over a real ``SceneService`` on the dataset: boxes from its
    tracking file, a frame from its reader, and RUN through ``run_request`` (the
    scene itself replaced by the background, as a fake program)."""
    import json
    import threading
    import urllib.request

    from future_urban_scene_generation_tpu_torch.gui import web
    from future_urban_scene_generation_tpu_torch.utils.native import decode_png

    def program(self, scene_args):
        def run(models, bank, frame, background, bboxes, meters, k):
            stack = background[None].expand(6, -1, -1, -1)
            return runner.SceneResult(stack, stack, torch.zeros(len(bboxes)),
                                      torch.zeros(len(bboxes), dtype=torch.long))
        return run

    monkeypatch.setattr(_PortHostService, "_scene_program", program)
    cfg = _configs(dataset, tmp_path)[1]
    svc = _PortHostService(cfg)
    srv = web.make_server(cfg, port=0, service=svc)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        boxes = json.loads(urllib.request.urlopen(base + "/boxes/1", timeout=10).read())
        assert {b["id"] for b in boxes} == {7, 9}
        png = urllib.request.urlopen(base + "/frame/1.png?preview=7&selected=7", timeout=10).read()
        assert decode_png(png).shape == (H, W, 3)
        req = urllib.request.Request(base + "/run", method="POST",
                                     data=json.dumps({"frame_id": 1, "ids": [7]}).encode())
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert len(out["outputs"]) == 12
        got = decode_png(urllib.request.urlopen(base + "/results/0.png", timeout=10).read())
        want = (svc.reader.read(1) * 255.0).clip(0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got, want)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
        svc.close()


def test_warmup_cli_on_cpu(capsys, tmp_path, monkeypatch):
    """``cli.warmup --device cpu`` at the tiny shape of tests/test_service_cli.py:147
    (96x128, V=1, 2 steps, f32, warp 64), in process: one line per bucket with a cold
    and a warm time; ``--cache-dir`` is ignored with a line; a missing card is
    refused. ``--export-aot DIR`` leaves one ``.pt2`` and prints the ``exported`` and
    ``restored`` lines; its scene is a stand-in ``run_scene`` here (the whole scene's
    export takes minutes on a CPU and is test_torch_aot.py's slow tier and the
    card's). (``--perception`` swaps in ``run_scene``, which the pipeline tests hold;
    the on-card script drives that flag.)"""
    from future_urban_scene_generation_tpu_torch.cli import warmup

    tiny = ["--frame-hw", "96", "128", "--vehicles", "1", "--steps", "2",
            "--generator-dtype", "float32", "--warp-plane-res", "64"]
    assert warmup.main([*tiny, "--device", "cpu", "--cache-dir", "somewhere"]) == 0
    out, err = capsys.readouterr()
    assert "--cache-dir is ignored" in err
    lines = [ln for ln in out.splitlines() if ln.startswith("warmed V=1 (96x128, steps=2, "
                                                            "float32, warp=64, synthesize_scene)")]
    assert len(lines) == 1 and " cold " in lines[0] and " warm " in lines[0]
    assert "BUILD_SECONDS" not in out  # nothing to build for the CPU

    def stand_in_scene(models, bank, frame, background, bboxes, meters, k, *, spec, vis_res):
        stack = (background * models.icn.stem.conv.bias.sum())[None].expand(
            meters.shape[1], -1, -1, -1)
        return runner.SceneResult(stack, stack, bboxes[:, 0], bboxes[:, 1].long())

    monkeypatch.setattr(runner, "run_scene", stand_in_scene)
    aot_dir = tmp_path / "aot"
    assert warmup.main([*tiny, "--device", "cpu", "--export-aot", str(aot_dir)]) == 0
    out = capsys.readouterr().out
    (artifact,) = aot_dir.iterdir()
    assert artifact.suffix == ".pt2"
    assert any(ln.startswith("warmed V=1 (96x128") and "run_scene" in ln
               for ln in out.splitlines())
    assert f"exported V=1 AOT artifact {artifact.name} (" in out
    assert f"restored V=1 AOT artifact {artifact.name} in " in out
    p = warmup.build_parser()
    assert (p.get_default("device"), p.get_default("generator_dtype"),
            p.get_default("warp_plane_res"), p.get_default("perception")) == (
                "cuda", "bfloat16", 128, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            warmup.main(tiny)
