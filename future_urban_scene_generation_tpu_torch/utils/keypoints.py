"""Canonical vehicle keypoint schema.

The pipeline localizes 12 semantic vehicle keypoints whose canonical ordering is the
contract between the hourglass head, the PnP solver, the texture-plane topology and the
CAD assets (reference: utils/keypoint_utils.py:9-42).

All functions here are host-side helpers operating on numpy; device code receives
keypoints as fixed-shape (12, 2) / (12, 3) arrays in this canonical order and never
touches dictionaries.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# Canonical ordering. Index into every (12, d) keypoint array used by the framework.
KEYPOINT_NAMES = (
    "left_back_trunk",
    "left_back_wheel",
    "left_front_light",
    "left_front_wheel",
    "right_back_trunk",
    "right_back_wheel",
    "right_front_light",
    "right_front_wheel",
    "upper_left_rearwindow",
    "upper_left_windshield",
    "upper_right_rearwindow",
    "upper_right_windshield",
)

NUM_KEYPOINTS = len(KEYPOINT_NAMES)

KEYPOINT_INDEX: Dict[str, int] = {n: i for i, n in enumerate(KEYPOINT_NAMES)}

# Fill value marking a keypoint missing from an annotation dictionary.
MISSING = -1.0


def dict_to_array(kpoints: Mapping[str, np.ndarray], dim: int = 2) -> np.ndarray:
    """Pack a name→coordinate mapping into a canonical (12, dim) float array.

    Missing keypoints are filled with ``MISSING`` (-1), matching the reference contract
    (utils/keypoint_utils.py:16-31).
    """
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    out = np.full((NUM_KEYPOINTS, dim), MISSING, dtype=np.float64)
    for name, idx in KEYPOINT_INDEX.items():
        if name in kpoints:
            out[idx] = np.asarray(kpoints[name], dtype=np.float64)
    return out


def array_to_dict(kpoints: np.ndarray) -> Dict[str, np.ndarray]:
    """Inverse of :func:`dict_to_array` (reference: utils/keypoint_utils.py:34-42)."""
    kpoints = np.asarray(kpoints)
    if kpoints.ndim != 2 or kpoints.shape[0] != NUM_KEYPOINTS:
        raise ValueError(f"expected ({NUM_KEYPOINTS}, d) array, got {kpoints.shape}")
    if not (2 <= kpoints.shape[1] <= 3):
        raise ValueError(f"keypoint dim must be 2 or 3, got {kpoints.shape[1]}")
    return {name: kpoints[idx] for name, idx in KEYPOINT_INDEX.items()}


def normalize(kpoints_2d: np.ndarray, max_x: float, max_y: float) -> np.ndarray:
    """Scale pixel keypoints into [0, 1] by image size (utils/keypoint_utils.py:130-145).

    Returns a new array (does not mutate the input, unlike the reference).
    """
    if max_x <= 0.0 or max_y <= 0.0:
        raise ValueError("max_x and max_y must be positive")
    out = np.array(kpoints_2d, dtype=np.float64, copy=True)
    out[:, 0] /= max_x
    out[:, 1] /= max_y
    return out
