"""Frozen copy of ``future_urban_scene_generation_tpu_torch/pipeline/training.py`` at commit
a2138eb, part of the benchmark's plain reference (see ``perfbench/reference/__init__.py``).

The ICN trainer (Warp&Learn): LSGAN over the multi-scale PatchGAN plus 10x L1, Adam
with betas (0.0, 0.9), the discriminator at 0.1x the generator's rate
(edgeconnect/config.py:42-45). The step order is the JAX package's: a discriminator
step on the detached fake, then a generator step against the updated discriminator.
Losses are taken in float32. Departures from the source: the other five trainers
are left out, and the optimizer is :class:`PlainAdam`, Adam written out, where the
source uses ``torch.optim.Adam``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.icn import (
    DNLayersMulti,
    GResnet,
    InstanceNorm,
    gan_loss,
)
from perfbench.reference.models.layers import seeded_init_


def _loss_dtype(t):
    """Losses are taken in float32 (float64 for float64 steps)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class PlainAdam:
    """Adam (Kingma and Ba, 2015) without weight decay, written out: per parameter
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, and
    p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2 + self.eps))


def make_optimizers(gen: nn.Module, dis: nn.Module, lr: float = 1e-4, d2g_lr: float = 0.1,
                    b1: float = 0.0, b2: float = 0.9):
    """Adam for the generator at ``lr`` and for the discriminator at ``lr * d2g_lr``."""
    return (PlainAdam(gen.parameters(), lr=lr, betas=(b1, b2)),
            PlainAdam(dis.parameters(), lr=lr * d2g_lr, betas=(b1, b2)))


@dataclasses.dataclass
class GANTrainState:
    """Both networks, both optimizers and the number of steps taken."""

    gen: nn.Module
    dis: nn.Module
    gen_opt: PlainAdam
    dis_opt: PlainAdam
    iteration: int = 0


class ICNTrainer:
    """LSGAN + L1 trainer for the 21 -> 3 generator with the multi-scale PatchGAN."""

    def __init__(self, input_nc: int = 21, ndf: int = 64, l1_weight: float = 10.0,
                 lr: float = 1e-4):
        self.input_nc, self.ndf = input_nc, ndf
        self.l1_weight = l1_weight
        self.lr = lr

    def init(self, generator: torch.Generator, *, device) -> GANTrainState:
        """Fresh networks, drawn from ``generator`` (layers.seeded_init_), on ``device``."""
        gen = seeded_init_(GResnet(input_nc=self.input_nc), generator).to(device)
        dis = seeded_init_(DNLayersMulti(input_nc=3, ndf=self.ndf), generator).to(device)
        return GANTrainState(gen, dis, *make_optimizers(gen, dis, self.lr))

    def dis_step(self, state: GANTrainState, fake, targets) -> torch.Tensor:
        """The discriminator's half of a step on a detached ``fake``: LSGAN loss,
        gradients, Adam update. Returns the loss."""
        d_real = [_loss_dtype(p) for p in state.dis(targets)]
        d_fake = [_loss_dtype(p) for p in state.dis(fake)]
        loss = 0.5 * (gan_loss(d_real, True) + gan_loss(d_fake, False))
        state.dis_opt.zero_grad(set_to_none=True)
        loss.backward(inputs=list(state.dis.parameters()))
        state.dis_opt.step()
        return loss.detach()

    def gen_step(self, state: GANTrainState, fake, targets):
        """The generator's half of a step: ``adv + l1_weight * L1`` against the
        current discriminator, back through ``fake``'s graph, Adam update. Returns
        (adv, l1)."""
        adv = gan_loss([_loss_dtype(p) for p in state.dis(fake)], True)
        l1 = torch.mean(torch.abs(_loss_dtype(fake) - _loss_dtype(targets)))
        state.gen_opt.zero_grad(set_to_none=True)
        (adv + self.l1_weight * l1).backward(inputs=list(state.gen.parameters()))
        state.gen_opt.step()
        return adv.detach(), l1.detach()

    def train_step(self, state: GANTrainState, inputs, targets
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """inputs (B, H, W, 21) signed LAB; targets (B, H, W, 3). Updates ``state``
        in place and returns it with the step's losses (0-d tensors, no host sync)."""
        fake = state.gen(inputs)
        dis_loss = self.dis_step(state, fake.detach(), targets)
        adv, l1 = self.gen_step(state, fake, targets)
        state.iteration += 1
        return state, {"l_d": dis_loss, "l_g": adv, "l_l1": l1}
