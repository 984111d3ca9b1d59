"""Random weights from the seed, made on the device in a few large calls.

Conv and linear weights are N(0, 1/fan_in), as the port's ``layers.seeded_init_``
draws them. Every other leaf is drawn too, so that the comparison sees each part of
the maths: biases, batch-norm running means and layer-norm betas N(0, 0.1^2);
batch-norm affine weights, running variances and weight-norm g U(0.5, 1.5); the ICN's
layer-norm gamma U(0, 1), as ``seeded_init_``. Only counters (a batch norm's
``num_batches_tracked``) are 0. Every normal draw of a network comes from one
``torch.randn`` and every uniform draw from one ``torch.rand`` on the card, with a
generator seeded from the run's seed and the network's name. The same state dict is
loaded into the port's network and into the reference's, so neither side draws its
own.
"""
from __future__ import annotations

import hashlib
import math

import torch

SHIFT_STD = 0.1


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "weight_v", "weight_orig") and len(shape) >= 2:
        return "normal"
    if leaf in ("bias", "beta", "running_mean"):
        return "shift"
    if leaf == "gamma":
        return "unit"
    if leaf in ("weight", "weight_g", "running_var"):
        return "scale"
    return "zero"


def seeded_state(module: torch.nn.Module, seed: int, tag: str, device) -> dict:
    """A state dict for ``module`` (names, shapes and dtypes of its own) drawn from
    ``seed`` on ``device``."""
    kinds = [(n, t, _kind(n, t.shape)) for n, t in module.state_dict().items()]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    n_normal = sum(t.numel() for _, t, k in kinds if k in ("normal", "shift"))
    n_uniform = sum(t.numel() for _, t, k in kinds if k in ("unit", "scale"))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, i, j = {}, 0, 0
    for n, t, k in kinds:
        if k in ("normal", "shift"):
            v = normal[i:i + t.numel()].view(t.shape)
            v = v / math.sqrt(t[0].numel()) if k == "normal" else v * SHIFT_STD
            i += t.numel()
        elif k in ("unit", "scale"):
            v = uniform[j:j + t.numel()].view(t.shape)
            v = v + 0.5 if k == "scale" else v
            j += t.numel()
        else:
            v = torch.zeros(t.shape, device=device)
        out[n] = v.to(t.dtype)
    return out
