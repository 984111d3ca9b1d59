"""Training metrics log (counterpart of the JAX package's utils/profiling.py
``MetricsLogger`` :52)."""
from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL metrics log: one ``{"step", "time", **metrics}`` per line."""

    def __init__(self, path):
        self.path = Path(path)

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec
