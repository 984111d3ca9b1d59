"""The immutable model/serving spec the scene path reads.

Counterpart of the JAX package's mutable ``stages.MODEL_SPEC`` (stages.py:82-147).
A frozen dataclass is passed explicitly to every stage instead of being read from a
process-wide dict, so concurrent callers with different specs cannot race.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    num_stacks: int = 2
    num_blocks: int = 1
    num_keypoints: int = 12
    num_cads: int = 10
    icn_input_nc: int = 21
    vunet_256: bool = True
    # Plane-warp sampling grid: 256 (exact single resample at crop resolution) or
    # a smaller r: sample an r^2 grid over each plane's dst bbox and paste it into
    # the crop with an antialiased scale_and_translate (stages.warp_planes_to_crop).
    warp_plane_res: int = 256
    # Reference channel conventions for its trained checkpoints (PARITY.md §6).
    reference_channel_order: bool = False
    # Generator (ICN + VUNet) activation dtype: "float32" | "bfloat16". Params and
    # every normalization statistic stay float32.
    generator_dtype: str = "float32"
    # Closed-form 4-point homography for the roof/front/back planes.
    quad_homography: bool = True
    # The int8 serving tier (JAX stages.py:138-146): every conv with C_in, C_out >= 32
    # of the forwards the stages run with this spec goes through models.layers'
    # int8 path (kernel N2) — perception, ICN, and on the inpaint branch EdgeConnect
    # and Mask R-CNN; VUNet stays float (layers.suppress_quantization).
    quantized_convs: bool = False

    def __post_init__(self):
        if self.generator_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"generator_dtype must be 'float32' or 'bfloat16', got "
                f"{self.generator_dtype!r}"
            )

    def replace(self, **kwargs) -> "ModelSpec":
        return dataclasses.replace(self, **kwargs)

    @property
    def gen_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.generator_dtype == "bfloat16" else torch.float32


# The serving configuration the benchmark scene runs (bf16 generators, 96^2 warps).
SERVING_SPEC = ModelSpec(generator_dtype="bfloat16", warp_plane_res=96)
