"""ICN (Warp&Learn) GAN training: optimizers, the train state and the trainer.

Counterpart of the JAX package's pipeline/training.py ``make_optimizers`` (:44),
``GANTrainState`` (:30) and ``ICNTrainer`` (:158): LSGAN over the multi-scale
PatchGAN plus 10x L1, Adam with betas (0.0, 0.9), the discriminator at 0.1x the
generator's rate (edgeconnect/config.py:42-45).

The step order is JAX's: a discriminator step on the detached fake, then a
generator step of ``adv + l1_weight * L1`` against the updated discriminator. The
generator's parameters do not change between the two, so one generator forward
whose graph is kept serves both. The input dtype sets the compute dtype, as in
the JAX package: bfloat16 inputs give bfloat16 convs (the ICN stem on kernel K3)
with float32 parameters, gradients and normalization statistics; the losses are
taken in float32 (float64 steps, used as a reference, stay float64 throughout).
After a step each parameter's ``.grad`` holds the gradient its optimizer used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn

from future_urban_scene_generation_tpu_torch.models.icn import (
    DNLayersMulti,
    GResnet,
    InstanceNorm,
    gan_loss,
)
from future_urban_scene_generation_tpu_torch.models.layers import seeded_init_


def _loss_dtype(t):
    """Losses are taken in float32 (float64 for float64 steps)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def make_optimizers(gen: nn.Module, dis: nn.Module, lr: float = 1e-4, d2g_lr: float = 0.1,
                    b1: float = 0.0, b2: float = 0.9):
    """Adam for the generator at ``lr`` and for the discriminator at ``lr * d2g_lr``."""
    return (torch.optim.Adam(gen.parameters(), lr=lr, betas=(b1, b2)),
            torch.optim.Adam(dis.parameters(), lr=lr * d2g_lr, betas=(b1, b2)))


@dataclasses.dataclass
class GANTrainState:
    """Both networks, both optimizers and the number of steps taken."""

    gen: nn.Module
    dis: nn.Module
    gen_opt: torch.optim.Optimizer
    dis_opt: torch.optim.Optimizer
    iteration: int = 0

    def state_dict(self) -> dict:
        return {"gen": self.gen.state_dict(), "dis": self.dis.state_dict(),
                "gen_opt": self.gen_opt.state_dict(), "dis_opt": self.dis_opt.state_dict(),
                "iteration": self.iteration}

    def load_state_dict(self, sd: dict) -> None:
        self.gen.load_state_dict(sd["gen"], strict=True)
        self.dis.load_state_dict(sd["dis"], strict=True)
        self.gen_opt.load_state_dict(sd["gen_opt"])
        self.dis_opt.load_state_dict(sd["dis_opt"])
        self.iteration = int(sd["iteration"])


def instance_norm_fed_biases(state: GANTrainState):
    """Names (``gen.*`` / ``dis.*``) of the conv biases that feed an affine-free
    instance norm. The norm subtracts them again, so their gradient is zero in
    exact arithmetic and its computed value is rounding noise: gradient
    comparisons hold these to being near zero instead of to each other."""
    names = set()
    for n, m in state.gen.named_modules():
        if getattr(m, "norm_type", None) == "inst":
            names.add(f"gen.{n}.conv.bias")
    for n, m in state.dis.named_modules():
        if isinstance(m, nn.Sequential):
            for i in range(len(m) - 1):
                if isinstance(m[i + 1], InstanceNorm):
                    names.add(f"dis.{n}.{i}.bias")
    return names


class ICNTrainer:
    """LSGAN + L1 trainer for the 21 -> 3 generator with the multi-scale PatchGAN."""

    def __init__(self, input_nc: int = 21, ndf: int = 64, l1_weight: float = 10.0,
                 lr: float = 1e-4):
        self.input_nc, self.ndf = input_nc, ndf
        self.l1_weight = l1_weight
        self.lr = lr

    def init(self, generator: torch.Generator, device="cpu") -> GANTrainState:
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
