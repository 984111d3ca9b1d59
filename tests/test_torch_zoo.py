"""The ``.pth`` round trip serving needs: JAX parameters -> ``convert.export_state_dict``
-> ``torch.save`` in the reference's checkpoint layout; the JAX package's
``load_reference_model_zoo`` and the port's then read the same files, and the
networks agree on seeded inputs at the tolerance of tests/test_torch_models.py
(atol 2e-3: float32 convolutions summed in different orders).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.models.hourglass import HourglassNet as JHourglass
from future_urban_scene_generation_tpu.models.icn import GResnet as JGResnet
from future_urban_scene_generation_tpu.models.vgg import VGG19Classifier as JVGG
from future_urban_scene_generation_tpu.models.vunet import Vunet as JVunet
from future_urban_scene_generation_tpu.pipeline import checkpoint as jcheckpoint
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from test_torch_models import ATOL, _forward_pair
import torch_threads  # noqa: F401


def _template(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def zoo_dir(tmp_path_factory):
    """Four JAX-initialized networks exported into cads/model.pth,
    kpoints/hourglass.pth, icn/256_synth/gnet_00020.pth (wrapped as
    {"iteration", "generator"}) and vunet/256/vunet.pth."""
    root = tmp_path_factory.mktemp("ckpts")
    key = jax.random.PRNGKey(1)
    x3 = jnp.zeros((1, 64, 64, 3))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    params = {
        "cad": np_tree(JVGG(num_classes=10).init(key, x3)),
        "hourglass": np_tree(JHourglass().init(key, x3)),
        "icn": np_tree(JGResnet(input_nc=21).init(key, jnp.zeros((1, 64, 64, 21)))),
        "vunet": np_tree(JVunet().init({"params": key}, jnp.zeros((1, 128, 128, 3)),
                                       jnp.zeros((1, 128, 128, 6)), cov=0.0)),
    }
    blank = Models.build(ModelSpec(), device="cpu")
    for name in Models._fields:  # the scene's four; tests/test_torch_edgeconnect.py the rest
        parts = checkpoint.ZOO_FILES[name]
        module = getattr(blank, name)
        if name == "cad":
            sd = convert.export_state_dict(
                convert.vgg_classifier_tree(params[name]), _template(module),
                flatten_linear_key="classifier.0.weight", flatten_linear_chw=(512, 7, 7))
        else:
            sd = convert.export_state_dict(params[name], _template(module))
        sd = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
        path = root.joinpath(*parts)
        path.parent.mkdir(parents=True)
        torch.save({"iteration": 20, "generator": sd} if name == "icn" else sd, path)
    return root


@pytest.fixture(scope="module")
def loaded(zoo_dir):
    zoo_j = jcheckpoint.load_reference_model_zoo(zoo_dir, cache=False)
    ours = Models.build(ModelSpec(), torch.Generator().manual_seed(5), device="cpu")
    names = checkpoint.load_reference_model_zoo(zoo_dir, ours)
    return zoo_j, ours, names


@pytest.mark.parametrize("name", ["cad", "hourglass", "icn", "vunet"])
def test_zoo_round_trip_forward_parity(loaded, name):
    zoo_j, ours, names = loaded
    assert sorted(names) == ["cad", "hourglass", "icn", "vunet"]
    assert not (zoo_j.keys() - set(names))  # no converted-tree cache, nothing extra
    refs, gots = _forward_pair("vgg" if name == "cad" else name, zoo_j[name],
                               getattr(ours, name), np.random.RandomState(7))
    assert len(refs) == len(gots)
    for ref, got in zip(refs, gots):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_partial_zoo_leaves_other_networks_seeded(zoo_dir, tmp_path):
    """Missing files are skipped; a file whose keys do not fit raises (strict)."""
    part = tmp_path / "ckpts"
    (part / "kpoints").mkdir(parents=True)
    (part / "kpoints" / "hourglass.pth").write_bytes(
        (zoo_dir / "kpoints" / "hourglass.pth").read_bytes())
    seeded = Models.build(ModelSpec(), torch.Generator().manual_seed(5), device="cpu")
    ours = Models.build(ModelSpec(), torch.Generator().manual_seed(5), device="cpu")
    before = {k: v.clone() for k, v in ours.hourglass.state_dict().items()}
    assert checkpoint.load_reference_model_zoo(part, ours) == ["hourglass"]
    for a, b in zip(ours.icn.parameters(), seeded.icn.parameters()):
        assert torch.equal(a, b)
    assert any(not torch.equal(v, before[k]) for k, v in ours.hourglass.state_dict().items())
    assert not (tmp_path / "ckpts" / ".converted_zoo").exists()

    (part / "icn" / "256_synth").mkdir(parents=True)
    torch.save({"enc.weight": torch.zeros(3)}, part / "icn" / "256_synth" / "gnet_00020.pth")
    with pytest.raises(RuntimeError):
        checkpoint.load_reference_model_zoo(part, ours)
    assert checkpoint.load_reference_model_zoo(tmp_path / "nowhere", ours) == []
