"""Model FLOPs of a scene and of a training step, counted from shapes.

``torch.utils.flop_counter.FlopCounterMode`` runs the plain reference's networks on
the meta device at the cell's shapes: no data, no kernel, and the same count
whatever implements the work. Only the networks' convolutions and matrix products
count (the geometry's small solves are far below them)."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def scene_flops(spec_fields: dict, vehicles: int, steps: int) -> float:
    """FLOPs of one scene's networks: the CAD classifier and the hourglass over V
    crops, the ICN over N = V * steps vehicle-steps (its stem included), VUNet's
    appearance encoder over V and its decoder over N."""
    from perfbench.reference.pipeline.stages import Models
    from perfbench.reference.spec import ModelSpec

    spec = ModelSpec(**spec_fields)
    n = vehicles * steps
    with torch.device("meta"):
        models = Models(*(m.eval().requires_grad_(False) for m in _networks(spec)))
        crops = torch.empty(vehicles, 256, 256, 3)
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            models.cad(crops)
            models.hourglass(crops)
            models.icn(torch.empty(n, 256, 256, spec.icn_input_nc))
            mu = models.vunet.encode_appearance(torch.empty(vehicles, 256, 256, 6))
            models.vunet.decode_shape(torch.empty(n, 256, 256, 3),
                                      [m.repeat_interleave(steps, dim=0) for m in mu])
    return float(counter.get_total_flops())


def _networks(spec):
    from perfbench.reference.models.hourglass import HourglassNet
    from perfbench.reference.models.icn import GResnet
    from perfbench.reference.models.vgg import VGG19Classifier
    from perfbench.reference.models.vunet import Vunet

    return (VGG19Classifier(num_classes=spec.num_cads),
            HourglassNet(spec.num_stacks, spec.num_blocks, spec.num_keypoints),
            GResnet(input_nc=spec.icn_input_nc), Vunet(vunet_256=spec.vunet_256))


def icn_train_step_flops(batch: int, size: int = 256) -> float:
    """FLOPs of one ICN training step at ``batch``: the generator's forward, the
    discriminator's step on real and fake, the generator's step through the
    discriminator, each backward included."""
    from perfbench.reference.models.icn import DNLayersMulti, GResnet
    from perfbench.reference.pipeline.training import GANTrainState, ICNTrainer, make_optimizers

    trainer = ICNTrainer()
    with torch.device("meta"):
        gen, dis = GResnet(input_nc=trainer.input_nc), DNLayersMulti(input_nc=3, ndf=trainer.ndf)
        state = GANTrainState(gen, dis, *make_optimizers(gen, dis, trainer.lr))
        inputs = torch.empty(batch, size, size, trainer.input_nc)
        targets = torch.empty(batch, size, size, 3)
        with FlopCounterMode(display=False) as counter:
            trainer.train_step(state, inputs, targets)
    return float(counter.get_total_flops())
