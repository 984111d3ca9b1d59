"""Training: the ICN (Warp&Learn) GAN trainer and the three single-network trainers
(VUNet, hourglass, CAD classifier), with their train states.

Counterpart of the JAX package's pipeline/training.py ``make_optimizers`` (:44),
``GANTrainState`` (:30), ``ICNTrainer`` (:158), ``HourglassTrainer`` (:91),
``CadClassifierTrainer`` (:133) and ``VunetTrainer`` (:217). ICN: LSGAN over the
multi-scale PatchGAN plus 10x L1, Adam with betas (0.0, 0.9), the discriminator at
0.1x the generator's rate (edgeconnect/config.py:42-45).

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
import torch.nn.functional as F

from future_urban_scene_generation_tpu_torch.models.icn import (
    DNLayersMulti,
    GResnet,
    InstanceNorm,
    gan_loss,
)
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet
from future_urban_scene_generation_tpu_torch.models.layers import seeded_init_
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet


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


# ---------------------------------------------------------------------------
# Single-network trainers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """One network, its optimizer and the number of steps taken. ``state_dict()``
    holds the network's state dict under ``"module"``; its keys are the
    reference's, so it loads ``strict=True`` into the matching network of the
    scene's ``Models``."""

    module: nn.Module
    opt: torch.optim.Optimizer
    iteration: int = 0

    def state_dict(self) -> dict:
        return {"module": self.module.state_dict(), "opt": self.opt.state_dict(),
                "iteration": self.iteration}

    def load_state_dict(self, sd: dict) -> None:
        self.module.load_state_dict(sd["module"], strict=True)
        self.opt.load_state_dict(sd["opt"])
        self.iteration = int(sd["iteration"])


def _adam_step(state: TrainState, loss: torch.Tensor) -> None:
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.iteration += 1


class HourglassTrainer:
    """Keypoint-heatmap trainer with intermediate supervision: the sum over stacks
    of the MSE against the target heatmaps (the reference trained its hourglass
    elsewhere; this is the standard objective). The network runs in train mode:
    batch statistics in the forward, running statistics moved as
    ``models/hourglass.BatchNorm2d`` says."""

    def __init__(self, num_stacks: int = 2, num_blocks: int = 1, num_classes: int = 12,
                 lr: float = 2.5e-4):
        self.arch = (num_stacks, num_blocks, num_classes)
        self.lr = lr

    def init(self, generator: torch.Generator, *, device) -> TrainState:
        net = seeded_init_(HourglassNet(*self.arch), generator).to(device).train()
        return TrainState(net, torch.optim.Adam(net.parameters(), lr=self.lr))

    def train_step(self, state: TrainState, images, target_heatmaps
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """images (B, H, W, 3) ImageNet-normalized; target_heatmaps (B, H/4, W/4, K)."""
        loss = sum(torch.mean((hm - target_heatmaps) ** 2) for hm in state.module(images))
        _adam_step(state, loss)
        return state, {"loss": loss.detach()}


class CadClassifierTrainer:
    """Cross-entropy fine-tuning of the VGG19 CAD head (run_test.py:45-58's model; the
    reference froze it at inference). torchvision's classifier carries two
    ``nn.Dropout`` modules, and the port's keeps them for the state dict's indices,
    but its forward never calls them: the JAX classifier has no dropout, and the
    step is held against it."""

    def __init__(self, num_classes: int = 10, lr: float = 1e-4):
        self.num_classes = num_classes
        self.lr = lr

    def init(self, generator: torch.Generator, *, device) -> TrainState:
        net = seeded_init_(VGG19Classifier(self.num_classes), generator).to(device)
        return TrainState(net, torch.optim.Adam(net.parameters(), lr=self.lr))

    def train_step(self, state: TrainState, images, labels
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """images (B, H, W, 3); labels (B,) integer CAD-bank indices."""
        loss = F.cross_entropy(state.module(images), labels.to(torch.int64))
        _adam_step(state, loss)
        return state, {"loss": loss.detach()}


class VunetTrainer:
    """Appearance-transfer trainer for the VUNet.

    The reference ships no script that trains its VUNet; this follows the original
    VUNet objective (Esser et al., CVPR 2018, which vunet/models.py implements):
    reconstruction of the target view plus a KL-style alignment between the
    appearance posterior means and the shape decoder's autoregressive prior means,
    with unit-variance Gaussians, so that KL reduces to 0.5 * mean((mu_a - mu_s)^2)
    per level, the prior means held constant. Latents are sampled (``cov = 1``);
    Adam with betas (0.5, 0.9)."""

    def __init__(self, vunet_256: bool = False, recon_weight: float = 1.0,
                 kl_weight: float = 1.0, lr: float = 1e-4):
        self.vunet_256 = vunet_256
        self.recon_weight = recon_weight
        self.kl_weight = kl_weight
        self.lr = lr

    def init(self, generator: torch.Generator, *, device) -> TrainState:
        net = seeded_init_(Vunet(vunet_256=self.vunet_256), generator).to(device)
        return TrainState(net, torch.optim.Adam(net.parameters(), lr=self.lr, betas=(0.5, 0.9)))

    def train_step(self, state: TrainState, noise, y_tilde, x_app, target
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """y_tilde: dst sketch; x_app: appearance input (6 channels); target: dst
        view; all [-1, 1] NHWC. ``noise``: a ``torch.Generator`` on the batch's
        device, or the ten noise tensors themselves (``models/vunet.NoiseSource``)."""
        x_tilde, mu_app, mu_shape = state.module(y_tilde, x_app, cov=1.0, noise=noise)
        recon = torch.mean(torch.abs(x_tilde - target))
        kl = sum(0.5 * torch.mean((ma - ms.detach()) ** 2) for ma, ms in zip(mu_app, mu_shape))
        loss = self.recon_weight * recon + self.kl_weight * kl
        _adam_step(state, loss)
        return state, {"loss": loss.detach(), "recon": recon.detach(), "kl": kl.detach()}
