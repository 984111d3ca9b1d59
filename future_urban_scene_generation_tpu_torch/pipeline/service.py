"""Host-side scene service: assets and models loaded once, then one call per request.

Counterpart of the JAX package's pipeline/service.py (``SceneService`` :23-268,
:338-373; the reference's GUI->traj_test glue, GUI/app_interface.py:218-242 +
trajectory_inference.py:39-475): selects the vehicles' future tracks, converts them
to meters (host float64), runs the scene on the device and writes the output PNGs
in the reference's layout, <out>/{warp&learn,vunet}/<scene>_<cam>/{frame_id:04}.png
(trajectory_inference.py:461-473).

The model fields of the config become one frozen ``ModelSpec`` that is handed to
the runner. The frames are converted to uint8 on the device (the same clip and
truncation the JAX service applies on the host) so that a quarter of the bytes
come back.

The inpaint branch (``cfg.inpaint``, JAX service.py:51-98, 270-339) erases the
selected vehicles from each of the six future frames on the device before they
become the backgrounds: a segmenter (``BackgroundDiffSegmenter`` against the static
background by default, Mask R-CNN with ``cfg.segmenter == "maskrcnn"``, or one the
caller passes) and EdgeConnect (``pipeline/inpaint.py``), batched over the six frames
a vehicle. Where the JAX service serves the static background when the EdgeConnect
files are missing, this one raises ``FileNotFoundError`` naming them, as both do for
a missing ``maskrcnn.pth``.

With ``cfg.runtime.aot_dir`` set, a request is served by the ahead-of-time program
of its argument shapes and spec under that directory where ``cli.warmup
--export-aot`` left one (pipeline/aot.py), and by the live runner otherwise.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.config import PipelineConfig
from future_urban_scene_generation_tpu_torch.geometry import gps
from future_urban_scene_generation_tpu_torch.models import edgeconnect, layers
from future_urban_scene_generation_tpu_torch.models.detector import BackgroundDiffSegmenter
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, inpaint, runner
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.utils import mesh as mesh_io
from future_urban_scene_generation_tpu_torch.utils import video as video_io
from future_urban_scene_generation_tpu_torch.utils.bbox import BoundingBox
from future_urban_scene_generation_tpu_torch.utils.native import AsyncPngWriter, read_png

FUTURE_STEPS = 6  # frames per branch (GUI/app_interface.py:230-233)
VEHICLE_BUCKET = 4  # the vehicle axis is padded to a multiple of this
MODEL_SEED = 0  # networks without a checkpoint are drawn from this seed


def resolve_device(name) -> torch.device:
    """``name`` as a torch device; a CUDA device that is not there is an error,
    never a silent move to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but no CUDA device is available "
                           "(name the CPU explicitly to run there)")
    return device


def frames_to_uint8(frames: torch.Tensor) -> torch.Tensor:
    """[0, 1] float frames -> uint8 by ``clip(x * 255, 0, 255)`` and truncation,
    on the frames' device."""
    return (frames.to(torch.float32) * 255.0).clamp(0.0, 255.0).to(torch.uint8)


class InpaintModels(NamedTuple):
    """EdgeConnect's two generators, named as their zoo files (checkpoint.ZOO_FILES)."""

    edge: edgeconnect.EdgeGenerator
    inpaint: edgeconnect.InpaintGenerator


class SceneService:
    def __init__(self, cfg: PipelineConfig, segmenter=None):
        self.cfg = cfg
        # The inpaint branch's vehicle segmenter (models/detector.py); None resolves
        # to cfg.segmenter: Mask R-CNN from the zoo, or BackgroundDiffSegmenter
        # against the static background at each request.
        self.segmenter = segmenter
        self.inpaint_models = None  # EdgeConnect's generators, loaded with cfg.inpaint
        self.device = resolve_device(cfg.device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.trajectories = video_io.parse_tracking_file(
            cfg.video_dir, cfg.track_mode, cfg.det_mode
        )
        homography = video_io.parse_calibration_file(Path(cfg.video_dir) / "calibration.txt")
        self.inv_homography = video_io.inverse_homography(homography, cfg.scale_calib)
        self.reader = video_io.VideoReader(self._video_source(), resize_hw=cfg.runtime.frame_hw)
        probe = self.reader.read(1)
        if probe is None:
            raise IOError("cannot read the first frame")
        self.frame_hw = probe.shape[:2]
        self.intrinsic = np.load(
            Path(cfg.video_dir).resolve().parents[2] / "intrinsic.npy"
        ).astype(np.float32)

        self._load_assets()
        self._load_models()
        self._build_segmenter()

    def _video_source(self):
        video_file = Path(self.cfg.video_dir) / "vdo.avi"
        if video_file.exists():
            return video_file
        frames_dir = Path(self.cfg.video_dir) / "frames"
        if frames_dir.exists():
            return frames_dir
        raise FileNotFoundError(f"no vdo.avi or frames/ under {self.cfg.video_dir}")

    def _load_assets(self):
        meshes, kps = [], []
        for idx in range(10):
            try:
                mesh, kp3d = mesh_io.load_cad_with_keypoints(self.cfg.kpoints_dir, idx)
            except FileNotFoundError:
                break
            meshes.append(mesh)
            kps.append(kp3d)
        if not meshes:
            # No CAD assets on disk: the procedural test car keeps the service
            # runnable end to end.
            mesh, kp3d = mesh_io.make_test_car(subdiv=3)
            meshes, kps = [mesh], [kp3d]
        self.cad_bank = runner.build_cad_bank(meshes, kps, scale=5.0, device=self.device)
        self.num_cads = len(meshes)

    def _load_models(self):
        self.spec = self.cfg.model_spec()
        self.models = Models.build(
            self.spec, torch.Generator().manual_seed(MODEL_SEED), device=self.device
        )
        ckpt = self.cfg.checkpoints_dir
        if ckpt is not None and Path(ckpt).exists():
            checkpoint.load_reference_model_zoo(ckpt, self.models)
        if self.cfg.inpaint:
            self.inpaint_models = self._load_inpaint_models()

    def _load_inpaint_models(self) -> InpaintModels:
        """EdgeConnect's generators from the zoo; both files are required."""
        ckpt = Path(self.cfg.checkpoints_dir or ".")
        paths = [checkpoint.zoo_path(ckpt, name) for name in InpaintModels._fields]
        missing = [str(p) for p in paths if not p.is_file()]
        if missing:
            raise FileNotFoundError(
                f"--inpaint needs EdgeConnect's generators {paths[0]} and {paths[1]} "
                f"(the reference's EdgeModel_gen.pth / InpaintingModel_gen.pth); missing: "
                f"{', '.join(missing)}")
        sds = {name: checkpoint.zoo_state_dict(ckpt, name) for name in InpaintModels._fields}
        # The reference's generators have 8 residual blocks; the files say how many.
        blocks = len({k.split(".")[1] for k in sds["edge"] if k.startswith("middle.")})
        nets = InpaintModels(*edgeconnect.build_generators(device=self.device,
                                                            residual_blocks=blocks))
        for name, net in zip(InpaintModels._fields, nets):
            net.load_state_dict(sds[name], strict=True)
        return nets

    def _build_segmenter(self):
        """Resolve cfg.segmenter when no segmenter was passed in (JAX service.py:51-98).

        "maskrcnn": ``maskrcnn/maskrcnn.pth`` of the checkpoints directory (a
        torchvision ``maskrcnn_resnet50_fpn`` state dict) with an optional
        ``config.yml`` sidecar overriding {num_classes, layers, width, out_channels,
        representation_size, input_hw, classes, min_iou} (read by
        ``utils.yamlite``). "background" resolves at each request."""
        if self.segmenter is not None or self.cfg.segmenter != "maskrcnn":
            return
        from future_urban_scene_generation_tpu_torch.models.detector import MaskRCNNSegmenter
        from future_urban_scene_generation_tpu_torch.models.maskrcnn import MaskRCNN
        from future_urban_scene_generation_tpu_torch.utils import yamlite

        ckpt = Path(self.cfg.checkpoints_dir or ".")
        path = checkpoint.zoo_path(ckpt, "maskrcnn")
        if not path.is_file():
            raise FileNotFoundError(
                f"--segmenter maskrcnn needs {path} (a torchvision maskrcnn_resnet50_fpn "
                "state dict; optional config.yml sidecar for reduced/fine-tuned configs)")
        sidecar = path.parent / "config.yml"
        conf = (yamlite.load(sidecar) or {}) if sidecar.is_file() else {}
        model = MaskRCNN.build(
            device=self.device,
            num_classes=int(conf.get("num_classes", 91)),
            layers=tuple(conf.get("layers", (3, 4, 6, 3))),
            width=int(conf.get("width", 64)),
            out_channels=int(conf.get("out_channels", 256)),
            representation_size=int(conf.get("representation_size", 1024)),
        )
        model.load_state_dict(checkpoint.zoo_state_dict(ckpt, "maskrcnn"), strict=True)
        self.segmenter = MaskRCNNSegmenter(
            model, classes=tuple(conf.get("classes", (3, 6, 8))),
            min_iou=float(conf.get("min_iou", 0.3)),
            input_hw=tuple(conf.get("input_hw", (512, 1024))), device=self.device)

    # ------------------------------------------------------------------
    def request_arguments(self, frame_id: int, vehicle_ids: List[int]) -> Tuple:
        """The arguments of a request's scene: (frame (H, W, 3) float32, background,
        bboxes (V, 4) float32 xyxy, meters (V, 6, 2) float32), V padded to the
        vehicle bucket. The background is the static one (or the frame), on the
        host, or in inpaint mode the (6, H, W, 3) stack of erased future frames on
        the service's device."""
        h, w = self.frame_hw
        frame = self.reader.read(frame_id)
        if frame is None:
            raise IOError(f"cannot read frame {frame_id}")

        def box(row):
            return BoundingBox(*row[2:6], bounds=(0, w - 1, 0, h - 1),
                               scale=self.cfg.bbox_scale)

        bboxes, meter_tracks = [], []
        for vid in vehicle_ids:
            rows = video_io.select_future_track(self.trajectories, vid, frame_id)
            if len(rows) < 2:
                continue  # fault barrier: skip vehicles without enough future track
            bboxes.append(box(rows[0]).xyxy)
            mid_bottoms = np.stack([box(r).mid_bottom for r in rows]).astype(np.float64)
            meters = gps.trajectory_to_meters(mid_bottoms, self.inv_homography)
            # Pad short tracks by repeating the last point (static continuation).
            if len(meters) < FUTURE_STEPS:
                meters = np.concatenate(
                    [meters, np.repeat(meters[-1:], FUTURE_STEPS - len(meters), axis=0)]
                )
            meter_tracks.append(meters[:FUTURE_STEPS])
        if not bboxes:
            raise ValueError("no selected vehicle has a usable future track")

        # Pad the vehicle axis to the bucket: requests for 1-4, 5-8, ... vehicles
        # run at the same shapes (what a captured CUDA graph of the scene needs).
        # Padding vehicles carry degenerate boxes and zero tracks; the runner's
        # fault barrier masks them out of the composite, so results are unchanged.
        n_real = len(bboxes)
        bucket = -(-n_real // VEHICLE_BUCKET) * VEHICLE_BUCKET
        for _ in range(bucket - n_real):
            bboxes.append(np.float32([0.0, 0.0, 0.0, 0.0]))
            meter_tracks.append(np.zeros((FUTURE_STEPS, 2), np.float64))

        bboxes = np.float32(bboxes)
        return frame, self._backgrounds(frame, frame_id, bboxes), bboxes, np.float32(
            np.stack(meter_tracks))

    def _backgrounds(self, frame: np.ndarray, frame_id: int, bboxes: np.ndarray):
        """The backgrounds the vehicles composite onto (JAX service.py:270-339).

        Without inpaint: ``background_frame.png`` (or the frame) for every step
        (trajectory_inference.py:42-53). With it: each future frame with the
        vehicles erased (trajectory_inference.py:107-145, 300-350), a (6, H, W, 3)
        tensor on the device. Masks come from one segmenter call a frame where the
        segmenter has one for all boxes (``masks`` / ``masks_for_bboxes``: one Mask
        R-CNN pass a frame, not one a vehicle), else one call a (frame, box).
        Padding rows are left out: their context window is empty."""
        static_bg = self._static_background()
        if self.inpaint_models is None:
            return static_bg if static_bg is not None else frame
        segmenter = self.segmenter or BackgroundDiffSegmenter(
            static_bg if static_bg is not None else frame, device=self.device)
        frames = [frame]
        for n in range(1, FUTURE_STEPS):
            cur = self.reader.read(frame_id + 2 * n)
            frames.append(frame if cur is None else cur)
        frames_d = torch.as_tensor(np.stack(frames)).to(self.device)
        hw = tuple(self.frame_hw)
        real = [v for v in range(len(bboxes)) if not inpaint.window_is_empty(bboxes[v], hw)]
        boxes_d = torch.as_tensor(bboxes[real]).to(self.device)
        # The spec's int8 tier reaches the segmenter's network and the erase, as the
        # JAX package's process-wide MODEL_SPEC does.
        with torch.no_grad(), layers.quantized_convs(self.spec.quantized_convs):
            if isinstance(segmenter, BackgroundDiffSegmenter):
                masks = segmenter.masks(frames_d, boxes_d)
            elif hasattr(segmenter, "masks_for_bboxes"):
                masks = torch.stack([segmenter.masks_for_bboxes(f, boxes_d) for f in frames_d])
            else:
                masks = torch.stack([torch.stack([segmenter(f, b) for b in boxes_d])
                                     for f in frames_d])
            nets = self.inpaint_models
            return inpaint.erase_vehicles(nets.edge, nets.inpaint, frames_d, bboxes[real],
                                          masks, sigma=float(self.cfg.edgeconnect.sigma))

    def run_request(self, frame_id: int, vehicle_ids: List[int]) -> List[Path]:
        """Synthesize the 6 future frames for the selected vehicles; write PNGs."""
        start = time.time()
        frame, background, bboxes, meters = self.request_arguments(frame_id, vehicle_ids)

        def up(a):
            return torch.as_tensor(a).to(self.device)

        frame_d = up(frame)
        scene_args = (
            self.models, self.cad_bank, frame_d,
            frame_d if background is frame else up(background),
            up(bboxes), up(meters), up(self.intrinsic),
        )
        result = self._scene_program(scene_args)(*scene_args)
        frames_icn = frames_to_uint8(result.frames_icn).cpu().numpy()
        frames_vunet = frames_to_uint8(result.frames_vunet).cpu().numpy()
        elapsed = time.time() - start
        print(
            f"Prediction of {len(bboxes)} vehicles over {frames_icn.shape[0]} future "
            f"frames took {elapsed:.2f} seconds"
        )
        return self._write_outputs(frame_id, frames_icn, frames_vunet)

    def _scene_program(self, scene_args):
        """The callable that serves this request's arguments (JAX service.py:251-267):
        with ``runtime.aot_dir`` set, the restored program of the artifact that
        matches the arguments' shapes, the spec and ``vis_res``; else, or on a miss
        (a bucket never warmed, another spec), the live runner with the service's
        spec: the same results, without the artifact."""
        spec, vis_res = self.spec, self.cfg.runtime.vis_res
        if self.cfg.runtime.aot_dir:
            from future_urban_scene_generation_tpu_torch.pipeline import aot

            run = aot.lookup_run_scene(*scene_args, spec=spec, vis_res=vis_res,
                                       directory=self.cfg.runtime.aot_dir)
            if run is not None:
                return run
        return lambda *a: runner.run_scene(*a, spec=spec, vis_res=vis_res)

    def _static_background(self):
        """``background_frame.png`` of the video directory at the working
        resolution (trajectory_inference.py:42-53), or None without one."""
        bg_path = Path(self.cfg.video_dir) / "background_frame.png"
        if not bg_path.exists():
            return None
        bg = read_png(bg_path).astype(np.float32) / 255.0
        return video_io.resize_bilinear_np(bg, tuple(self.frame_hw))

    def _write_outputs(self, frame_id, frames_icn_u8, frames_vunet_u8) -> List[Path]:
        video_dir = Path(self.cfg.video_dir).resolve()
        scene_cam = f"{video_dir.parts[-2]}_{video_dir.parts[-1]}"
        out = []
        with AsyncPngWriter(n_threads=4) as writer:
            for branch, frames in (("warp&learn", frames_icn_u8), ("vunet", frames_vunet_u8)):
                branch_dir = Path(self.cfg.output_dir) / branch / scene_cam
                branch_dir.mkdir(parents=True, exist_ok=True)
                for i, fid in enumerate(range(frame_id, frame_id + 2 * len(frames), 2)):
                    path = branch_dir / f"{fid:04}.png"
                    writer.submit(path, frames[i])
                    out.append(path)
            errors = writer.flush()
        if errors:
            raise IOError(f"{errors} PNG writes failed under {self.cfg.output_dir}")
        return out

    def close(self) -> None:
        self.reader.close()
