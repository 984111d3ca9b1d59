"""The device record of a run: the card's name, the cards used, the peak memory and
the power limit, read on the card itself. A run that finds no card stops; there is
no fallback to the CPU."""
from __future__ import annotations

import subprocess


class NoDevice(RuntimeError):
    pass


def require_cuda(chips: int):
    """Raise :class:`NoDevice` unless CUDA is available with at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}")


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, or why it could not say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return (out.stdout.strip() or out.stderr.strip()).replace("\n", "; ")


def record(device, chips: int) -> dict:
    """The result line's ``device`` object for a run on ``chips`` cards."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit": power_limit()}
