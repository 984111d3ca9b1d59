"""The comparisons that decide ``correct``: what the timed path produced against the
plain reference (``perfbench/reference``), each number beside its limit from the
cell's file."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for float32 matmuls and convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def checks(readings: dict, limits: dict) -> list:
    """[(name, reading, limit)] of every reading that has a limit, in the limits' order
    (a number the judge could not read counts as infinite)."""
    return [(name, readings.get(name, float("inf")), limit) for name, limit in limits.items()]


def passed(checks_: list) -> bool:
    """All compared numbers within their limits, and at least one compared (a cell
    with no limit has shown nothing)."""
    return bool(checks_) and all(value <= limit for _, value, limit in checks_)
