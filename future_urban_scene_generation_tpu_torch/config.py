"""One typed configuration tree for the whole framework.

Counterpart of the JAX package's config.py (:16-135), dataclass for dataclass;
``device`` defaults to ``"cuda"``; yaml files are read by ``utils.yamlite`` (the port
does not depend on PyYAML). The service turns the model fields into a frozen ``spec.ModelSpec``
(``PipelineConfig.model_spec``) and hands that down; nothing global is mutated.

Unifies the reference's three config systems (SURVEY §5): the 13 argparse CLI flags
(run_test.py:93-121), EdgeConnect's yaml-backed Config with DEFAULT_CONFIG fallback
(edgeconnect/config.py:6-66), and the VUNet ad-hoc Namespace (run_test.py:82-83).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

from future_urban_scene_generation_tpu_torch.spec import ModelSpec


@dataclass
class VunetConfig:
    """run_test.py:82-83."""

    up_mode: str = "subpixel"
    w_norm: bool = True
    drop_prob: float = 0.2
    vunet_256: bool = True


@dataclass
class EdgeConnectConfig:
    """edgeconnect/config.py:31-66 defaults; load_yaml overrides from config.yml."""

    mode: int = 2  # inference (utils/inpaint_utils.py:15)
    model: int = 3
    mask: int = 3
    edge: int = 1
    nms: int = 1
    seed: int = 10
    lr: float = 1e-4
    d2g_lr: float = 0.1
    beta1: float = 0.0
    beta2: float = 0.9
    batch_size: int = 8
    input_size: int = 0
    sigma: float = 2.0  # Canny gaussian sigma
    max_iters: float = 2e6
    edge_threshold: float = 0.5
    l1_loss_weight: float = 1.0
    fm_loss_weight: float = 10.0
    style_loss_weight: float = 1.0
    content_loss_weight: float = 1.0
    inpaint_adv_loss_weight: float = 0.01
    gan_loss: str = "nsgan"
    save_interval: int = 1000
    sample_interval: int = 1000
    eval_interval: int = 0
    log_interval: int = 10

    @staticmethod
    def from_yaml(path) -> "EdgeConnectConfig":
        """The defaults overridden by the flat ``KEY: value`` pairs of ``path``
        (read by ``utils.yamlite``: the port does not depend on PyYAML)."""
        from future_urban_scene_generation_tpu_torch.utils import yamlite

        cfg = EdgeConnectConfig()
        raw = yamlite.load(path) or {}
        for key, value in raw.items():
            attr = key.lower()
            if hasattr(cfg, attr):
                setattr(cfg, attr, value)
        return cfg


@dataclass
class RuntimeConfig:
    """Device-placement and resolution knobs (no referent in the reference)."""

    mesh_data: int = -1  # -1: all devices
    mesh_model: int = 1
    # Plane-visibility local-raster resolution (render/visibility.py:
    # compute_visibility_local — scale-free, area ratios are affine-invariant).
    vis_res: int = 192
    sketch_res: int = 256
    # Working frame resolution (reference: 1280x720, GUI/app_interface.py:181).
    # None = native resolution of the video/frames.
    frame_hw: Optional[Tuple[int, int]] = (720, 1280)
    # Directory of ahead-of-time scene-program artifacts (pipeline/aot.py): the service
    # serves a request from the artifact of its shapes and spec there, else live.
    aot_dir: Optional[Path] = None
    # The int8 serving tier (ModelSpec.quantized_convs), set by a library caller; the
    # JAX package's counterpart is configure_models(quantized_convs=True). No CLI flag.
    quantized_convs: bool = False


@dataclass
class PipelineConfig:
    """The CLI surface of run_test.py:93-121 plus framework-native options."""

    video_dir: Optional[Path] = None
    kpoints_dir: Optional[Path] = None
    checkpoints_dir: Optional[Path] = None
    scale_calib: bool = False
    det_mode: str = "ssd512"  # ssd512 | yolo3 | mask_rcnn
    track_mode: str = "tc"  # tc | deepsort | moana
    bbox_scale: float = 1.0
    video_fps: int = 10
    inpaint: bool = False
    inpaint_model: int = 4
    reso: int = 256
    batch: int = 1
    blocks: int = 1
    stacks: int = 2
    device: str = "cuda"
    # Reproduce the reference's channel conventions (BGR crops into the nets,
    # channel-reversed VUNet sketches — PARITY.md §6) when running its trained
    # checkpoints. Default False: clean RGB end-to-end.
    reference_channel_order: bool = False
    # Inpaint-branch vehicle segmenter: "background" (BackgroundDiffSegmenter) or
    # "maskrcnn" (native models/maskrcnn.py, loaded from
    # checkpoints_dir/maskrcnn/maskrcnn.pth with an optional config.yml sidecar).
    segmenter: str = "background"
    # Headless mode (replaces the mandatory GUI): vehicle ids + frame to synthesize.
    select_ids: List[int] = field(default_factory=list)
    frame_id: int = 1
    output_dir: Path = Path("./results")

    vunet: VunetConfig = field(default_factory=VunetConfig)
    edgeconnect: EdgeConnectConfig = field(default_factory=EdgeConnectConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def model_spec(self) -> ModelSpec:
        """The frozen spec of the networks this configuration serves with
        (the JAX service's ``configure_models`` call, service.py:142-147)."""
        return ModelSpec(
            num_stacks=self.stacks,
            num_blocks=self.blocks,
            vunet_256=self.reso == 256,
            reference_channel_order=self.reference_channel_order,
            quantized_convs=self.runtime.quantized_convs,
        )

    def load_edgeconnect_yaml(self):
        """config.yml under checkpoints/inpainting, with the inference-mode overrides
        of utils/inpaint_utils.py:10-19."""
        if self.checkpoints_dir is None:
            return
        path = Path(self.checkpoints_dir) / "inpainting" / "config.yml"
        if path.exists():
            self.edgeconnect = EdgeConnectConfig.from_yaml(path)
        self.edgeconnect.mode = 2
        self.edgeconnect.model = self.inpaint_model
        self.edgeconnect.input_size = 0
