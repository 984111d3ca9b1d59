"""Trainer checkpoints: the whole train state in one ``torch.save`` file.

Counterpart of the JAX package's pipeline/checkpoint.py ``save`` / ``restore``
(:20-36), which write an Orbax tree. Here the file holds both networks' state
dicts, both optimizers' state dicts and the iteration; the generator's keys are
the reference's, so ``state_dict()["gen"]`` loads ``strict=True`` into the scene's
``Models.icn`` (the train -> serve chain of docs/TRAINING.md).
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
