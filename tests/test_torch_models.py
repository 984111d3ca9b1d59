"""The PyTorch port's networks and perception stage against the JAX package.

JAX-initialized parameters cross into the port through
``models.convert.load_jax_params`` (``load_state_dict(strict=True)``); forward
passes then agree at atol 2e-3, the bar tests/test_icn.py holds the JAX networks to
against their torch mirrors (float32 convolutions summed in different orders).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.models.hourglass import (
    HourglassNet as JHourglass,
    decode_heatmaps as j_decode,
)
from future_urban_scene_generation_tpu.models.icn import GResnet as JGResnet
from future_urban_scene_generation_tpu.models.vgg import VGG19Classifier as JVGG
from future_urban_scene_generation_tpu.models.vunet import Vunet as JVunet
from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet, decode_heatmaps
from future_urban_scene_generation_tpu_torch.models.icn import GResnet
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier
from future_urban_scene_generation_tpu_torch.models.vunet import Vunet
from future_urban_scene_generation_tpu_torch.pipeline import stages
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

ATOL = 2e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    key = jax.random.PRNGKey(0)
    x3 = jnp.zeros((1, 64, 64, 3))
    params = {
        "vgg": JVGG(num_classes=10).init(key, x3),
        "hourglass": JHourglass().init(key, x3),
        "icn": JGResnet(input_nc=21).init(key, jnp.zeros((1, 64, 64, 21))),
        "vunet": JVunet().init({"params": key}, jnp.zeros((1, 128, 128, 3)),
                               jnp.zeros((1, 128, 128, 6)), cov=0.0),
    }
    ours = {
        "vgg": convert.load_vgg_classifier(VGG19Classifier(10).eval(), _np_tree(params["vgg"])),
        "hourglass": convert.load_jax_params(HourglassNet().eval(), _np_tree(params["hourglass"])),
        "icn": convert.load_jax_params(GResnet(21).eval(), _np_tree(params["icn"])),
        "vunet": convert.load_jax_params(Vunet().eval(), _np_tree(params["vunet"])),
    }
    return params, ours


def _t(a):
    return torch.as_tensor(np.array(a))


@torch.no_grad()
def _forward_pair(name, params, ours, rng):
    if name == "vgg":
        x = rng.randn(2, 64, 64, 3).astype(np.float32)
        return [JVGG(num_classes=10).apply(params, jnp.asarray(x))], [ours(_t(x))]
    if name == "hourglass":
        x = rng.randn(1, 64, 64, 3).astype(np.float32)
        return JHourglass().apply(params, jnp.asarray(x))["heatmaps"], ours(_t(x))
    if name == "icn":
        x = (rng.rand(1, 64, 64, 21) * 2 - 1).astype(np.float32)
        return [JGResnet(input_nc=21).apply(params, jnp.asarray(x))], [ours(_t(x))]
    x = (rng.rand(1, 128, 128, 6) * 2 - 1).astype(np.float32)
    y = (rng.rand(1, 128, 128, 3) * 2 - 1).astype(np.float32)
    jm = JVunet()
    mu = jm.apply(params, jnp.asarray(x), cov=0.0, method=JVunet.encode_appearance)
    out = jm.apply(params, jnp.asarray(y), mu, cov=0.0, method=JVunet.decode_shape)
    mu_t = ours.encode_appearance(_t(x))
    return list(mu) + [out], mu_t + [ours.decode_shape(_t(y), mu_t)]


@pytest.mark.parametrize("name", ["vgg", "hourglass", "icn", "vunet"])
def test_weight_bridge_forward_parity(nets, name):
    params, ours = nets
    refs, gots = _forward_pair(name, params[name], ours[name], np.random.RandomState(7))
    assert len(refs) == len(gots)
    for ref, got in zip(refs, gots):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_weight_bridge_reference_state_dict_names(nets):
    """The reference's key names (the contract its .pth files load under)."""
    _, ours = nets
    assert "enc_content.model.0.conv.weight" in ours["icn"].state_dict()
    assert "dec.model.2.norm.gamma" in ours["icn"].state_dict()
    assert "app_encoder_1.nin.layers.1.conv.weight_v" in ours["vunet"].state_dict()
    assert "hg.0.hg.3.0.0.conv1.weight" in ours["hourglass"].state_dict()
    assert "classifier.6.weight" in ours["vgg"].state_dict()


@torch.no_grad()
def test_perceive_matches_jax(nets):
    params, ours = nets
    rng = np.random.RandomState(3)
    frame = rng.rand(300, 400, 3).astype(np.float32)
    bboxes = np.float32([[40.5, 60.2, 180.7, 150.1], [250.3, 20.9, 395.0, 260.4]])
    jmodels = jstages.Models(params["vgg"], params["hourglass"], None, None)
    ref = jstages.perceive(jmodels, jnp.asarray(frame), jnp.asarray(bboxes))
    models = stages.Models(ours["vgg"], ours["hourglass"], ours["icn"], ours["vunet"])
    got = stages.perceive(models, ModelSpec(), _t(frame), _t(bboxes))

    for a, b in zip(got.window, ref.window):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got.crop.numpy(), np.asarray(ref.crop), atol=1e-5)
    np.testing.assert_array_equal(got.cad_idx.numpy(), np.asarray(ref.cad_idx))

    # Logits and heatmaps of the same crops.
    norm = (np.asarray(ref.crop) - np.float32(stages.IMAGENET_MEAN)) / np.float32(
        stages.IMAGENET_STD)
    logits_j = JVGG(num_classes=10).apply(params["vgg"], jnp.asarray(norm))
    heat_j = JHourglass().apply(params["hourglass"], jnp.asarray(norm))["heatmaps"][-1]
    np.testing.assert_allclose(ours["vgg"](_t(norm)).numpy(), np.asarray(logits_j), atol=ATOL)
    heat_t = ours["hourglass"](_t(norm))[-1]
    np.testing.assert_allclose(heat_t.numpy(), np.asarray(heat_j), atol=ATOL)
    # Decode is exact on the same heatmaps.
    np.testing.assert_array_equal(decode_heatmaps(_t(heat_j)).numpy(),
                                  np.asarray(j_decode(heat_j)))
    np.testing.assert_array_equal(
        stages.cr.crop_to_frame_coords(decode_heatmaps(_t(heat_j)), got.window).numpy(),
        np.asarray(jax.vmap(jcr.crop_to_frame_coords)(j_decode(heat_j), ref.window)),
    )
