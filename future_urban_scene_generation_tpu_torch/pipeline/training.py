"""Training: the three GAN trainers (ICN / Warp&Learn, EdgeConnect's edge and
inpainting models) and the three single-network trainers (VUNet, hourglass, CAD
classifier), with their train states.

Counterpart of the JAX package's pipeline/training.py ``make_optimizers`` (:44),
``GANTrainState`` (:30), ``ICNTrainer`` (:158), ``HourglassTrainer`` (:91),
``CadClassifierTrainer`` (:133), ``VunetTrainer`` (:217), ``EdgeModelTrainer``
(:275) and ``InpaintingModelTrainer`` (:372). Every GAN trainer uses Adam with
betas (0.0, 0.9), the discriminator at 0.1x the generator's rate
(edgeconnect/config.py:42-45). ICN: LSGAN over the multi-scale PatchGAN plus 10x
L1. Edge: nsgan plus 10x feature matching (edgeconnect/models.py:87-128).
Inpainting: 0.01x nsgan plus L1 / mean(mask) plus the perceptual and style losses
on VGG19 taps (models.py:184-234).

The step order is JAX's: a discriminator step on the detached fake, then a
generator step against the updated discriminator. The generator's parameters do
not change between the two, so one generator forward whose graph is kept serves
both. The EdgeConnect networks carry training-mode spectral norm
(``layers.SNConv2d``): every forward of a step takes its power iteration from the
stored u, and the trainer advances u once, after both updates
(``layers.advance_spectral_norm_``; JAX training.py:357-362, PARITY.md §12); u and
v are module buffers, so a checkpoint carries them. The input dtype sets the
compute dtype, as in the JAX package: bfloat16 inputs give bfloat16 convs (the ICN stem on kernel K3)
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

from future_urban_scene_generation_tpu_torch.models import edgeconnect as ec
from future_urban_scene_generation_tpu_torch.models.icn import (
    DNLayersMulti,
    GResnet,
    InstanceNorm,
    gan_loss,
)
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet
from future_urban_scene_generation_tpu_torch.models.layers import (
    advance_spectral_norm_,
    seeded_init_,
)
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier, VGG19Features
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
    comparisons hold these to being near zero instead of to each other. (In the
    EdgeConnect generators every conv bias but the last conv's.)"""
    if isinstance(state.gen, (ec.EdgeGenerator, ec.InpaintGenerator)):
        return {f"gen.{n}" for n, _ in state.gen.named_parameters()
                if n.endswith(".bias") and not n.startswith("decoder.7.")}
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
# EdgeConnect
# ---------------------------------------------------------------------------


def _discriminator_step(state: GANTrainState, real, fake, kind: str) -> torch.Tensor:
    """The EdgeConnect discriminator's half of a step on a detached ``fake``: the
    mean of the real and fake adversarial losses, gradients, Adam update. Returns
    the loss."""
    d_real, _ = state.dis(real)
    d_fake, _ = state.dis(fake)
    loss = 0.5 * (ec.adversarial_loss(_loss_dtype(d_real), True, True, kind)
                  + ec.adversarial_loss(_loss_dtype(d_fake), False, True, kind))
    state.dis_opt.zero_grad(set_to_none=True)
    loss.backward(inputs=list(state.dis.parameters()))
    state.dis_opt.step()
    return loss.detach()


def _edgeconnect_state(gen: nn.Module, dis_channels: int, trainer, generator: torch.Generator,
                       device) -> GANTrainState:
    """``gen`` and a spectral-normed discriminator on ``dis_channels``, drawn from
    ``generator``, in training mode on ``device``, with their optimizers."""
    dis = ec.ECDiscriminator(dis_channels, use_sigmoid=trainer.gan_kind != "hinge")
    gen, dis = (seeded_init_(net, generator).to(device).train() for net in (gen, dis))
    return GANTrainState(gen, dis, *make_optimizers(gen, dis, trainer.lr))


def _generator_update(state: GANTrainState, loss: torch.Tensor) -> None:
    state.gen_opt.zero_grad(set_to_none=True)
    loss.backward(inputs=list(state.gen.parameters()))
    state.gen_opt.step()


class EdgeModelTrainer:
    """EdgeModel.process (edgeconnect/models.py:87-128): the spectral-normed edge
    generator against a spectral-normed discriminator on (gray, edges), nsgan plus
    ``fm_weight`` x feature matching against the real input's detached taps."""

    def __init__(self, fm_weight: float = 10.0, lr: float = 1e-4, gan_kind: str = "nsgan",
                 residual_blocks: int = ec.RESIDUAL_BLOCKS):
        self.fm_weight, self.lr, self.gan_kind = fm_weight, lr, gan_kind
        self.residual_blocks = residual_blocks

    def init(self, generator: torch.Generator, *, device) -> GANTrainState:
        """Fresh networks in training mode, drawn from ``generator``, on ``device``."""
        return _edgeconnect_state(ec.EdgeGenerator(self.residual_blocks, spectral=True), 2,
                                  self, generator, device)

    def train_step(self, state: GANTrainState, images_gray, edges, masks
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """(B, H, W, 1) gray image, edges and masks in [0, 1]. Updates ``state`` in
        place and returns it with the step's losses (0-d tensors, no host sync)."""
        outputs = ec.edge_model_forward(state.gen, images_gray, edges, masks)
        real_in = torch.cat([images_gray, edges], dim=-1)
        dis_loss = _discriminator_step(
            state, real_in, torch.cat([images_gray, outputs.detach()], dim=-1), self.gan_kind)
        d_fake, fake_feat = state.dis(torch.cat([images_gray, outputs], dim=-1))
        with torch.no_grad():
            _, real_feat = state.dis(real_in)
        adv = ec.adversarial_loss(_loss_dtype(d_fake), True, False, self.gan_kind)
        fm = sum(torch.mean(torch.abs(_loss_dtype(f) - _loss_dtype(r)))
                 for f, r in zip(fake_feat, real_feat))
        _generator_update(state, adv + self.fm_weight * fm)
        advance_spectral_norm_(state.dis)
        advance_spectral_norm_(state.gen)
        state.iteration += 1
        return state, {"l_d1": dis_loss, "l_g1": adv.detach(), "l_fm": fm.detach()}


class InpaintingModelTrainer:
    """InpaintingModel.process (edgeconnect/models.py:184-234): the inpaint
    generator against a spectral-normed discriminator on RGB, ``adv_weight`` x nsgan
    plus ``l1_weight`` x L1 / mean(mask) plus the perceptual and style losses on a
    frozen ``VGG19Features`` (handed to each step, as the JAX step takes its
    parameters)."""

    def __init__(self, adv_weight: float = 0.01, l1_weight: float = 1.0,
                 content_weight: float = 1.0, style_weight: float = 1.0, lr: float = 1e-4,
                 gan_kind: str = "nsgan", residual_blocks: int = ec.RESIDUAL_BLOCKS):
        self.weights = (adv_weight, l1_weight, content_weight, style_weight)
        self.lr, self.gan_kind = lr, gan_kind
        self.residual_blocks = residual_blocks

    def init(self, generator: torch.Generator, *, device) -> GANTrainState:
        """Fresh networks in training mode, drawn from ``generator``, on ``device``."""
        return _edgeconnect_state(ec.InpaintGenerator(self.residual_blocks), 3, self,
                                  generator, device)

    def train_step(self, state: GANTrainState, vgg: VGG19Features, images, edges, masks
                   ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """(B, H, W, 3) images, (B, H, W, 1) edges and masks, all in [0, 1]; ``vgg``
        frozen (``requires_grad`` off: the generator's backward goes through its
        input only). The targets' features are taken without a graph."""
        adv_w, l1_w, content_w, style_w = self.weights
        outputs = ec.inpaint_model_forward(state.gen, images, edges, masks)
        dis_loss = _discriminator_step(state, images, outputs.detach(), self.gan_kind)
        d_fake, _ = state.dis(outputs)
        out32, img32 = _loss_dtype(outputs), _loss_dtype(images)
        adv = ec.adversarial_loss(_loss_dtype(d_fake), True, False, self.gan_kind) * adv_w
        l1 = torch.mean(torch.abs(out32 - img32)) * l1_w / torch.mean(_loss_dtype(masks))

        def taps(x):
            return {k: _loss_dtype(v) for k, v in vgg(x).items()}

        with torch.no_grad():
            feats_y, feats_ym = taps(images), taps(images * masks)
        content = ec.perceptual_loss(taps(outputs), feats_y) * content_w
        style = ec.style_loss(taps(outputs * masks), feats_ym) * style_w
        _generator_update(state, adv + l1 + content + style)
        advance_spectral_norm_(state.dis)
        state.iteration += 1
        return state, {"l_d2": dis_loss, "l_g2": adv.detach(), "l_l1": l1.detach(),
                       "l_per": content.detach(), "l_sty": style.detach()}


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
