"""The port's reader for the reference's YAML files (``utils/yamlite``) against
PyYAML, and the three loaders that use it, called in a process where PyYAML cannot
be imported (fault F7: the port must not depend on it).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from future_urban_scene_generation_tpu.config import EdgeConnectConfig as JEdgeConnectConfig
from future_urban_scene_generation_tpu.utils import mesh as jmesh
from future_urban_scene_generation_tpu_torch.config import EdgeConnectConfig
from future_urban_scene_generation_tpu_torch.utils import keypoints as kp
from future_urban_scene_generation_tpu_torch.utils import mesh
from future_urban_scene_generation_tpu_torch.utils import yamlite
import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

# edgeconnect/config.yml as the reference ships it (its keys, values and comments),
# without the exponent floats PyYAML reads as strings.
EDGECONNECT_YML = """\
MODE: 1             # 1: train, 2: test, 3: eval
MODEL: 1            # 1: edge model, 2: inpaint model, 3: edge-inpaint model, 4: joint model
MASK: 3             # 1: random block, 2: half, 3: external, 4: (external, random block)
EDGE: 1             # 1: canny, 2: external
NMS: 1              # 0: no non-max-suppression, 1: applies non-max-suppression on the external edges
SEED: 10            # random seed
GPU: [0]            # list of gpu ids
DEBUG: 0            # turns on debugging mode
VERBOSE: 0          # turns on verbose mode in the output console

TRAIN_FLIST: ./datasets/places2_train.flist

LR: 0.0001                    # learning rate
D2G_LR: 0.1                   # discriminator/generator learning rate ratio
BETA1: 0.0                    # adam optimizer beta1
BETA2: 0.9                    # adam optimizer beta2
BATCH_SIZE: 8                 # input batch size for training
INPUT_SIZE: 256               # input image size for training 0 for original size
SIGMA: 2                      # standard deviation of the Gaussian filter used in Canny edge detector (0: random, -1: no edge)
EDGE_THRESHOLD: 0.5           # edge detection threshold
GAN_LOSS: nsgan               # nsgan | lsgan | hinge
"""


def _kp_dict(rng):
    return {name: [float(v) for v in rng.randn(3)] for name in kp.KEYPOINT_NAMES}


@pytest.mark.parametrize("style", ["block", "flow_leaves", "unsorted", "quoted_strings"])
def test_reader_matches_pyyaml_on_what_it_writes(style):
    rng = np.random.RandomState(0)
    data = {"kpoints_3d": _kp_dict(rng), "num_classes": 91, "layers": [3, 4, 6, 3],
            "input_hw": [512, 1024], "min_iou": 0.3, "lr": 1e-4, "max_iters": 2e6,
            "tiny": -2.5e-20, "name": "it's: # not a comment", "numeric_str": "3",
            "flag": True, "none": None, "empty": [], "nested": {"a": {"b": [1.5, "x"]}}}
    kwargs = {"block": {}, "flow_leaves": {"default_flow_style": None},
              "unsorted": {"sort_keys": False}}.get(style, {})
    if style == "quoted_strings":
        data = {"Camera": "c001", "a b": "x: y", "n": "0.5"}
        kwargs = {"default_style": "'"}
    text = yaml.safe_dump(data, **kwargs)
    assert yamlite.loads(text) == yaml.safe_load(text)


def test_reader_on_the_reference_files():
    got = yamlite.loads(EDGECONNECT_YML)
    assert got == yaml.safe_load(EDGECONNECT_YML)
    assert got["GPU"] == [0] and got["SIGMA"] == 2 and got["GAN_LOSS"] == "nsgan"
    # YAML 1.2 floats: PyYAML keeps an exponent without a dot as a string.
    assert yamlite.loads("MAX_ITERS: 2e6\nLR: 1e-4\n") == {"MAX_ITERS": 2e6, "LR": 1e-4}
    assert yamlite.loads("") == {}
    for bad in ("a: &anchor 1\n", "a: [1, 2\n", "a: 1\n  b: 2\n", "- - 1\n  - 2\n"):
        with pytest.raises(ValueError):
            yamlite.loads(bad)


def test_edgeconnect_config_and_cad_keypoints_match_jax(tmp_path):
    path = tmp_path / "config.yml"
    path.write_text(EDGECONNECT_YML)
    assert vars(EdgeConnectConfig.from_yaml(path)) == vars(JEdgeConnectConfig.from_yaml(path))
    m, kp3d = mesh.make_test_car(subdiv=1)
    mesh.save_ply_ascii(tmp_path / "pascal_car_cad_000.ply", m)
    (tmp_path / "pascal_car_cad_000.yaml").write_text(
        yaml.safe_dump({"kpoints_3d": {n: [float(v) for v in kp3d[i]]
                                       for i, n in enumerate(kp.KEYPOINT_NAMES)}}))
    got_mesh, got_kp = mesh.load_cad_with_keypoints(tmp_path, 0)
    want_mesh, want_kp = jmesh.load_cad_with_keypoints(tmp_path, 0)
    np.testing.assert_array_equal(got_kp, want_kp)
    np.testing.assert_array_equal(got_mesh.vertices, want_mesh.vertices)


def test_loaders_run_with_pyyaml_blocked(tmp_path):
    """F7: the EdgeConnect config, the CAD keypoints and the Mask R-CNN sidecar load in
    a process where ``import yaml`` fails."""
    import torch

    from future_urban_scene_generation_tpu_torch.models.maskrcnn import MaskRCNN
    from future_urban_scene_generation_tpu_torch.pipeline import checkpoint

    (tmp_path / "ckpt" / "inpainting").mkdir(parents=True)
    (tmp_path / "ckpt" / "inpainting" / "config.yml").write_text(EDGECONNECT_YML.replace(
        "SIGMA: 2 ", "SIGMA: 3 "))
    m, kp3d = mesh.make_test_car(subdiv=1)
    mesh.save_ply_ascii(tmp_path / "pascal_car_cad_000.ply", m)
    (tmp_path / "pascal_car_cad_000.yaml").write_text(yaml.safe_dump(
        {"kpoints_3d": {n: [float(v) for v in kp3d[i]] for i, n in enumerate(kp.KEYPOINT_NAMES)}},
        default_flow_style=None))
    small = dict(num_classes=5, layers=(1, 1, 1, 1), width=8, out_channels=16,
                 representation_size=32)
    path = checkpoint.zoo_path(tmp_path / "ckpt", "maskrcnn")
    path.parent.mkdir(parents=True)
    torch.save({"model": MaskRCNN.build(torch.Generator().manual_seed(0), device="cpu",
                                        **small).state_dict()}, path)
    (path.parent / "config.yml").write_text(
        "num_classes: 5\nlayers: [1, 1, 1, 1]\nwidth: 8\nout_channels: 16\n"
        "representation_size: 32\ninput_hw: [128, 256]\nclasses: [3, 4]\nmin_iou: 0.25\n")
    code = f"""
import sys, types
sys.modules["yaml"] = None  # any import of PyYAML now raises ImportError
import torch
from pathlib import Path
from future_urban_scene_generation_tpu_torch.config import PipelineConfig
from future_urban_scene_generation_tpu_torch.pipeline.service import SceneService
from future_urban_scene_generation_tpu_torch.utils import mesh
root = Path({str(tmp_path)!r})
cfg = PipelineConfig(checkpoints_dir=root / "ckpt", segmenter="maskrcnn", device="cpu")
cfg.load_edgeconnect_yaml()
assert cfg.edgeconnect.sigma == 3 and cfg.edgeconnect.gan_loss == "nsgan", vars(cfg.edgeconnect)
_, kp3d = mesh.load_cad_with_keypoints(root, 0)
assert kp3d.shape == (12, 3)
svc = types.SimpleNamespace(segmenter=None, cfg=cfg, device=torch.device("cpu"))
SceneService._build_segmenter(svc)
seg = svc.segmenter
assert seg.input_hw == (128, 256) and seg.classes == (3, 4) and seg.min_iou == 0.25
assert seg.model.roi_heads.box_predictor.cls_score.out_features == 5
try:
    import yaml
except ImportError:
    print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=str(tmp_path),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
