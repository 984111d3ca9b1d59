"""Checkpoints: the trainer's state in one ``torch.save`` file, and the reference's
model zoo for serving (the scene's four networks, EdgeConnect's two generators and
Mask R-CNN).

Counterpart of the JAX package's pipeline/checkpoint.py: ``save`` / ``restore``
(:20-36), which write an Orbax tree, and ``load_reference_model_zoo`` (:71-151),
which converts the reference's ``.pth`` files to flax trees and caches them. The
port's modules carry the reference's state-dict names, so the zoo loads with
``load_state_dict(strict=True)`` and there is nothing to convert or cache.

``save`` / ``restore`` take any train state with ``state_dict()`` and
``load_state_dict()`` (``training.GANTrainState``, ``training.TrainState``). The ICN
trainer's file holds both networks' state dicts, both optimizers' and the
iteration; a single-network trainer's holds the network's, the optimizer's and the
iteration. The networks' keys are the reference's, so ``state_dict()["gen"]`` loads
``strict=True`` into the scene's ``Models.icn`` and ``["module"]`` into
``Models.vunet`` / ``.hourglass`` / ``.cad`` (the train -> serve chain of
docs/TRAINING.md).
"""
from __future__ import annotations

import os
from pathlib import Path

import torch


def save(path, state) -> None:
    """Write ``state`` to ``path`` (through a temporary file, so a crash mid-write
    leaves the previous checkpoint in place)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def restore(path, state):
    """Load the checkpoint at ``path`` into ``state`` (networks, optimizers and
    iteration, onto the networks' devices) and return it. A file written from
    another kind of state raises."""
    state.load_state_dict(torch.load(Path(path), map_location="cpu", weights_only=True))
    return state


# The reference's checkpoint layout (run_test.py:54-87, and the JAX package's
# maskrcnn/maskrcnn.pth): network name -> file under the checkpoints directory.
ZOO_FILES = {
    "cad": ("cads", "model.pth"),
    "hourglass": ("kpoints", "hourglass.pth"),
    "icn": ("icn", "256_synth", "gnet_00020.pth"),
    "vunet": ("vunet", "256", "vunet.pth"),
    "edge": ("inpainting", "EdgeModel_gen.pth"),
    "inpaint": ("inpainting", "InpaintingModel_gen.pth"),
    "maskrcnn": ("maskrcnn", "maskrcnn.pth"),
}


def zoo_path(checkpoints_dir, name: str) -> Path:
    return Path(checkpoints_dir).joinpath(*ZOO_FILES[name])


def zoo_state_dict(checkpoints_dir, name: str):
    """The state dict of zoo file ``name`` under the port's keys, or None when the
    file is absent. A file may hold the state dict itself or wrap it as
    ``{"iteration", "generator"}`` (EdgeConnect) or ``{"model"}`` (Mask R-CNN);
    spectral-norm triples are folded (the EdgeConnect edge generator,
    ``convert.fold_spectral_norm``) and torchvision's newer Mask R-CNN keys
    normalized (``maskrcnn.convert_maskrcnn``), as the JAX converter does."""
    from future_urban_scene_generation_tpu_torch.models.convert import fold_spectral_norm

    path = zoo_path(checkpoints_dir, name)
    if not path.is_file():
        return None
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "generator" in sd:
        sd = sd["generator"]
    elif isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    sd = fold_spectral_norm(sd)
    if name == "maskrcnn":
        from future_urban_scene_generation_tpu_torch.models.maskrcnn import convert_maskrcnn

        sd = convert_maskrcnn(sd)
    return sd


def load_reference_model_zoo(checkpoints_dir, models) -> list:
    """Load every file of the reference layout that is present under
    ``checkpoints_dir`` into the network of the same name in ``models`` (a named
    tuple of networks: ``stages.Models``, ``service.InpaintModels``), strictly, onto
    the network's device. Missing files are skipped, so a partial zoo leaves the
    other networks as they were. Returns the names loaded."""
    loaded = []
    for name in models._fields:
        sd = zoo_state_dict(checkpoints_dir, name)
        if sd is None:
            continue
        getattr(models, name).load_state_dict(sd, strict=True)
        loaded.append(name)
    return loaded
