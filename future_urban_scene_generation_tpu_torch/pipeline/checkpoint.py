"""Checkpoints: the trainer's state in one ``torch.save`` file, and the reference's
model zoo for serving.

Counterpart of the JAX package's pipeline/checkpoint.py: ``save`` / ``restore``
(:20-36), which write an Orbax tree, and ``load_reference_model_zoo`` (:71-151),
which converts the reference's ``.pth`` files to flax trees and caches them. The
port's modules carry the reference's state-dict names, so the zoo loads with
``load_state_dict(strict=True)`` and there is nothing to convert or cache.

The trainer's file holds both networks' state dicts, both optimizers' state dicts
and the iteration; the generator's keys are the reference's, so
``state_dict()["gen"]`` loads ``strict=True`` into the scene's ``Models.icn`` (the
train -> serve chain of docs/TRAINING.md).
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from future_urban_scene_generation_tpu_torch.pipeline.training import GANTrainState


def save(path, state: GANTrainState) -> None:
    """Write ``state`` to ``path`` (through a temporary file, so a crash mid-write
    leaves the previous checkpoint in place)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)


def restore(path, state: GANTrainState) -> GANTrainState:
    """Load the checkpoint at ``path`` into ``state`` (networks, optimizers and
    iteration, onto the networks' devices) and return it."""
    state.load_state_dict(torch.load(Path(path), map_location="cpu", weights_only=True))
    return state


# The reference's checkpoint layout (run_test.py:54-87): Models field -> file.
# ``inpainting/*`` and ``maskrcnn/*`` belong to the inpaint branch (not ported).
ZOO_FILES = {
    "cad": ("cads", "model.pth"),
    "hourglass": ("kpoints", "hourglass.pth"),
    "icn": ("icn", "256_synth", "gnet_00020.pth"),
    "vunet": ("vunet", "256", "vunet.pth"),
}


def load_reference_model_zoo(checkpoints_dir, models) -> list:
    """Load every file of the reference layout that is present under
    ``checkpoints_dir`` into the matching network of ``models`` (a
    ``stages.Models``), strictly, onto the network's device. A file may hold the
    state dict itself or wrap it as ``{"iteration", "generator"}``. Missing files
    are skipped, so a partial zoo leaves the other networks as they were. Returns
    the names loaded."""
    root = Path(checkpoints_dir)
    loaded = []
    for name, parts in ZOO_FILES.items():
        path = root.joinpath(*parts)
        if not path.is_file():
            continue
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "generator" in sd:
            sd = sd["generator"]
        getattr(models, name).load_state_dict(sd, strict=True)
        loaded.append(name)
    return loaded
