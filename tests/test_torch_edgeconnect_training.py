"""EdgeConnect training in the PyTorch port against the JAX package, on the CPU:
training-mode spectral norm, the VGG19 loss taps, the discriminator, the losses,
the pair maker, one step of each trainer, and fault F8 of the JAX exporter.

Sizes: 32^2, batch 2, one residual block. JAX-initialized weights cross into the
port through ``convert.load_jax_params`` (spectral-norm triples from the kernel and
the 'spectral' collection's u). Bars: spectral-norm layers and the discriminator
atol 1e-4 (tests/test_spectral_norm.py), VGG taps 1e-4 at ``relu1_1`` and 1e-3
deeper (tests/test_vgg.py), losses rtol 1e-5, a trainer step's losses rtol 1e-4,
each gradient its optimizer used atol 1e-4 * max|g| (the instance-norm-fed biases,
zero in exact arithmetic, held near zero instead), and the advanced u atol 1e-5.

The reference's edge generator leaves its last conv plain (``decoder.7.weight`` in
tests/fixtures/zoo_template.json); the JAX package's spectral generator normalizes
it too. The port follows the reference, and the step test builds the JAX
generator with that one layer a plain ``TorchConv`` (ROADMAP.md queue 3, F9).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu.models import convert as jconvert
from future_urban_scene_generation_tpu.models import edgeconnect as jec
from future_urban_scene_generation_tpu.models import layers as jlayers
from future_urban_scene_generation_tpu.models.vgg import VGG19Features as JVGG19Features
from future_urban_scene_generation_tpu.pipeline import datagen as jdatagen
from future_urban_scene_generation_tpu.pipeline import training as jtraining
from future_urban_scene_generation_tpu_torch.cli import export_zoo
from future_urban_scene_generation_tpu_torch.models import convert, edgeconnect, layers, vgg
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, datagen, training

HW, BATCH, BLOCKS = 32, 2, 1
CONVT = jec.EDGECONNECT_CONVT_KEYS
CANNY_BUDGET = 0.002  # tests/test_crop_canny_morph.py:166
TEMPLATE = json.loads((Path(__file__).parent / "fixtures" / "zoo_template.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier runs six workers on the machine's cores: cap torch's intra-op threads."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


# --- spectral norm ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv", "convt"])
def test_spectral_norm_layers_match_jax(kind):
    """A training-mode forward takes one power iteration from the stored u without
    writing it; ``advance_`` writes it (JAX's ``mutable=["spectral"]``); two steps in
    a row; eval mode is the fold of the state dict."""
    rng = np.random.RandomState(41)
    if kind == "conv":
        jmod = jlayers.SNConv(features=6, kernel_size=3, padding=2, dilation=2,
                              use_bias=False)
        ours = layers.SNConv2d(4, 6, 3, padding=2, dilation=2, bias=False)
        x = rng.randn(2, 9, 9, 4).astype(np.float32)
    else:
        jmod = jlayers.SNConvTranspose(features=4, kernel_size=4, stride=2, padding=1)
        ours = layers.SNConvTranspose2d(6, 4, 4, 2, 1)
        x = rng.randn(2, 8, 8, 6).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))
    params = {"params": dict(variables["params"])}
    if kind == "convt":  # a bias that is not zero
        params["params"]["bias"] = jnp.asarray(rng.randn(4).astype(np.float32))
    convert.load_jax_params(ours, _np(params), convt_keys=("weight",) if kind == "convt" else (),
                            spectral=_np(variables["spectral"]))
    assert list(ours.state_dict()) == [k for k in ("bias", "weight_orig", "weight_u", "weight_v")
                                       if k in ours.state_dict()]
    ours.train()
    xt = torch.as_tensor(x)
    spectral = variables["spectral"]
    u0 = ours.weight_u.clone()
    with torch.no_grad():
        got = ours(xt).numpy()
    want = jmod.apply({**params, "spectral": spectral}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert torch.equal(ours.weight_u, u0)  # a forward does not advance u
    for _ in range(2):
        want, state = jmod.apply({**params, "spectral": spectral}, jnp.asarray(x),
                                 mutable=["spectral"])
        spectral = state["spectral"]
        with torch.no_grad():
            got = ours(xt).numpy()
        ours.advance_()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(ours.weight_u.numpy(), np.asarray(spectral["u"]), atol=1e-4)
    # Eval mode: the stored (u, v), the weight fold_spectral_norm makes of the state dict.
    folded = convert.fold_spectral_norm(ours.state_dict())["weight"]
    ours.eval()
    np.testing.assert_allclose(ours.effective_weight().detach().numpy(), folded.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_the_edge_generator_keeps_the_reference_keys():
    """The spectral edge generator's state dict is the reference's
    EdgeModel_gen.pth: the 70 keys of the zoo template, in its order, its shapes."""
    net = layers.seeded_init_(edgeconnect.EdgeGenerator(spectral=True),
                              torch.Generator().manual_seed(0))
    want = TEMPLATE["edge"]["keys"]
    assert len(want) == 70
    assert [(k, list(v.shape)) for k, v in net.state_dict().items()] == list(want.items())
    u = {k: v for k, v in net.state_dict().items() if k.endswith(("weight_u", "weight_v"))}
    assert all(abs(float(v.norm()) - 1.0) < 1e-6 for v in u.values())


# --- VGG19 taps, the discriminator, the losses ---------------------------------------


def test_vgg19_features_match_jax_at_every_tap(tmp_path):
    jm = JVGG19Features()
    x = np.random.RandomState(2).rand(1, HW, HW, 3).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    ours = convert.load_jax_params(vgg.VGG19Features(), _np(params))
    with torch.no_grad():
        got = ours(torch.as_tensor(x))
    assert set(got) == set(want) == set(vgg.TAPS) | {"final"}
    for tap in want:
        np.testing.assert_allclose(got[tap].numpy(), np.asarray(want[tap]),
                                   atol=1e-4 if tap == "relu1_1" else 1e-3, err_msg=tap)
    # The loader: a torchvision-layout file, wrapped as {"state_dict"}, with a
    # classifier beside the trunk; frozen, on the named device.
    sd = {f"module.{k}": v for k, v in ours.state_dict().items()}
    sd["module.classifier.0.weight"] = torch.zeros(2, 3)
    torch.save({"state_dict": sd}, tmp_path / "vgg19.pth")
    loaded = vgg.load_vgg19_features(tmp_path / "vgg19.pth", device="cpu")
    assert not loaded.training and not any(p.requires_grad for p in loaded.parameters())
    for k, v in ours.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    torch.save({"classifier.0.weight": torch.zeros(2, 3)}, tmp_path / "head.pth")
    with pytest.raises(ValueError, match="not a VGG19 trunk"):
        vgg.load_vgg19_features(tmp_path / "head.pth", device="cpu")


@pytest.mark.parametrize("cin,sigmoid", [(2, True), (3, False)])
def test_discriminator_matches_jax(cin, sigmoid):
    jd = jec.ECDiscriminator(in_channels=cin, use_sigmoid=sigmoid, spectral=True)
    x = np.random.RandomState(cin).rand(BATCH, HW, HW, cin).astype(np.float32)
    variables = jd.init(jax.random.PRNGKey(cin), jnp.asarray(x))
    ours = edgeconnect.ECDiscriminator(cin, use_sigmoid=sigmoid).train()
    convert.load_jax_params(ours, _np({"params": variables["params"]}),
                            spectral=_np(variables["spectral"]))
    assert {k.rsplit(".", 1)[0] for k in ours.state_dict()} == {f"conv{i}.0" for i in range(1, 6)}
    out_j, feats_j = jd.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out, feats = ours(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=1e-4)
    assert len(feats) == len(feats_j) == 5
    for a, b in zip(feats, feats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    probs = rng.rand(2, 5, 5, 1).astype(np.float32)
    probs[0, 0, 0, 0], probs[1, 0, 0, 0] = 0.0, 1.0  # the clip at 1e-12
    logits = rng.randn(2, 5, 5, 1).astype(np.float32)
    for kind, out in (("nsgan", probs), ("lsgan", probs), ("hinge", logits)):
        for is_real in (True, False):
            for is_disc in (True, False):
                want = float(jec.adversarial_loss(jnp.asarray(out), is_real, is_disc, kind))
                got = float(edgeconnect.adversarial_loss(_t(out), is_real, is_disc, kind))
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           err_msg=f"{kind} real={is_real} disc={is_disc}")
    shapes = {"relu1_1": (2, 16, 16, 8), "relu2_1": (2, 8, 8, 16), "relu2_2": (2, 8, 8, 16),
              "relu3_1": (2, 4, 4, 32), "relu3_4": (2, 4, 4, 32), "relu4_1": (2, 2, 2, 64),
              "relu4_4": (2, 2, 2, 64), "relu5_1": (2, 1, 1, 64), "relu5_2": (2, 1, 1, 64)}
    fx = {k: rng.rand(*s).astype(np.float32) for k, s in shapes.items()}
    fy = {k: rng.rand(*s).astype(np.float32) for k, s in shapes.items()}
    tx, ty = ({k: _t(v) for k, v in f.items()} for f in (fx, fy))
    jx, jy = ({k: jnp.asarray(v) for k, v in f.items()} for f in (fx, fy))
    np.testing.assert_allclose(edgeconnect.gram_matrix(tx["relu3_1"]).numpy(),
                               np.asarray(jec.gram_matrix(jx["relu3_1"])), rtol=1e-5)
    np.testing.assert_allclose(float(edgeconnect.style_loss(tx, ty)),
                               float(jec.style_loss(jx, jy)), rtol=1e-5)
    np.testing.assert_allclose(float(edgeconnect.perceptual_loss(tx, ty)),
                               float(jec.perceptual_loss(jx, jy)), rtol=1e-5)
    w = (0.5, 1.0, 2.0, 1.0, 0.25)
    np.testing.assert_allclose(float(edgeconnect.perceptual_loss(tx, ty, w)),
                               float(jec.perceptual_loss(jx, jy, w)), rtol=1e-5)


# --- the pair maker -------------------------------------------------------------


def test_edgeconnect_pairs_match_jax_edgeconnect_batch():
    """The port's deterministic pair maker on the JAX key's own draws (the same
    ``split`` / ``randint`` calls as datagen.py:243-246)."""
    b, h, w = 3, 48, 40
    images = np.random.RandomState(9).rand(b, h, w, 3).astype(np.float32)
    key = jax.random.PRNGKey(12)
    gray_j, edges_j, masks_j = jdatagen.edgeconnect_batch(key, jnp.asarray(images))
    y0, x0 = [], []
    for k in jax.random.split(key, b):
        k1, k2 = jax.random.split(k)
        y0.append(int(jax.random.randint(k1, (), 0, h // 2)))
        x0.append(int(jax.random.randint(k2, (), 0, w // 2)))
    got = datagen.edgeconnect_pairs(torch.as_tensor(images), torch.as_tensor(y0),
                                    torch.as_tensor(x0))
    np.testing.assert_array_equal(got.masks.numpy(), np.asarray(masks_j))
    np.testing.assert_allclose(got.gray.numpy(), np.asarray(gray_j), atol=1e-6)
    differ = (got.edges.numpy() != np.asarray(edges_j)).mean()
    assert differ < CANNY_BUDGET, differ
    assert got.edges.sum() > 0 and got.masks.shape == (b, h, w, 1)
    assert all(float(m.sum()) == (h // 3) * (w // 3) for m in got.masks)
    draws = datagen.edgeconnect_draws(torch.Generator().manual_seed(0), 64, (h, w))
    assert 0 <= int(draws[0].min()) and int(draws[0].max()) < h // 2
    assert 0 <= int(draws[1].min()) and int(draws[1].max()) < w // 2


# --- one trainer step against the JAX trainer ------------------------------------------


def _plain_last_conv(*args, name=None, **kwargs):
    """``SNConv`` for every JAX EdgeConnect layer but the generator's last
    (``decoder_7``), a plain ``TorchConv`` as in the reference."""
    cls = jlayers.TorchConv if name == "decoder_7" else jlayers.SNConv
    return cls(*args, name=name, **kwargs)


def _batch():
    rng = np.random.RandomState(4)
    images = rng.rand(BATCH, HW, HW, 3).astype(np.float32)
    gray, edges, masks = jdatagen.edgeconnect_batch(jax.random.PRNGKey(4), jnp.asarray(images))
    return images, np.asarray(gray), np.asarray(edges), np.asarray(masks)


def _as(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating)
        else a, tree)


def _jax_init(branch):
    """The JAX trainer (one residual block) and its initial state, and the loss VGG's
    parameters for the inpainting model, in float32."""
    if branch == "edge":
        jt = jtraining.EdgeModelTrainer()
        jt.gen = jec.EdgeGenerator(residual_blocks=BLOCKS, spectral=True)
        return jt, jax.jit(jt.init, static_argnames="hw")(jax.random.PRNGKey(0), hw=(HW, HW)), None
    jt = jtraining.InpaintingModelTrainer()
    jt.gen = jec.InpaintGenerator(residual_blocks=BLOCKS)
    vgg_params = jax.jit(JVGG19Features().init)(jax.random.PRNGKey(1), jnp.zeros((1, HW, HW, 3)))
    state = jax.jit(jt.init, static_argnames="hw")(jax.random.PRNGKey(0), vgg_params, hw=(HW, HW))
    return jt, state, vgg_params


def _jax_step(branch, jt, state, vgg_params, dtype):
    """The JAX trainer's step from ``state`` in ``dtype`` and the gradients of its two
    loss closures (training.py:322-353 for the edge model, 414-438 for the
    inpainting model), in one program."""
    images, gray, edges, masks = (a.astype(dtype) for a in _batch())
    state = _as(state, dtype)
    if branch == "edge":
        batch, vgg_params = (gray, edges, masks), None
    else:
        batch, vgg_params = (images, edges, masks), _as(vgg_params, dtype)

    def edge_losses(state, new_state, g, e, m):
        outputs, _ = jt._gen_apply(state.gen_params, state.gen_state, g, e, m)
        real_in = jnp.concatenate([g, e], axis=-1)

        def gen_loss_fn(gp):
            out_g, _ = jt._gen_apply(gp, state.gen_state, g, e, m)
            (d_fake, fake_feat), _ = jt._dis_apply(new_state.dis_params, state.dis_state,
                                                   jnp.concatenate([g, out_g], axis=-1))
            (_, real_feat), _ = jt._dis_apply(new_state.dis_params, state.dis_state, real_in)
            fm = sum(jnp.mean(jnp.abs(f - jax.lax.stop_gradient(r)))
                     for f, r in zip(fake_feat, real_feat))
            return jec.adversarial_loss(d_fake, True, False) + jt.fm_weight * fm

        return real_in, jnp.concatenate([g, outputs], axis=-1), gen_loss_fn

    def inpaint_losses(state, new_state, x, e, m):
        adv_w, l1_w, content_w, style_w = jt.weights

        def gen_loss_fn(gp):
            out_g = jec.inpaint_model_forward(gp, x, e, m, generator=jt.gen)
            (d_fake, _), _ = jt._dis_apply(new_state.dis_params, state.dis_state, out_g)
            adv = jec.adversarial_loss(d_fake, True, False) * adv_w
            l1 = jnp.mean(jnp.abs(out_g - x)) * l1_w / jnp.mean(m)
            content = jec.perceptual_loss(jt.vgg.apply(vgg_params, out_g),
                                          jt.vgg.apply(vgg_params, x)) * content_w
            style = jec.style_loss(jt.vgg.apply(vgg_params, out_g * m),
                                   jt.vgg.apply(vgg_params, x * m)) * style_w
            return adv + l1 + content + style

        fake = jec.inpaint_model_forward(state.gen_params, x, e, m, generator=jt.gen)
        return x, fake, gen_loss_fn

    def step_and_grads(state, vgg_params, *batch):
        if branch == "edge":
            new_state, metrics = jt.train_step(state, *batch)
            real_in, fake_in, gen_loss_fn = edge_losses(state, new_state, *batch)
        else:
            new_state, metrics = jt.train_step(state, vgg_params, *batch)
            real_in, fake_in, gen_loss_fn = inpaint_losses(state, new_state, *batch)

        def dis_loss_fn(dp):
            (d_real, _), _ = jt._dis_apply(dp, state.dis_state, real_in)
            (d_fake, _), _ = jt._dis_apply(dp, state.dis_state, fake_in)
            return (jec.adversarial_loss(d_real, True, True)
                    + jec.adversarial_loss(d_fake, False, True)) / 2.0

        grads = {"dis": jax.grad(dis_loss_fn)(state.dis_params),
                 "gen": jax.grad(gen_loss_fn)(state.gen_params)}
        return new_state, metrics, grads

    new_state, metrics, grads = jax.jit(step_and_grads)(
        state, vgg_params, *(jnp.asarray(a) for a in batch))
    return state, new_state, metrics, grads, batch, vgg_params


def _spectral_of(state, net):
    return state.dis_state if net == "dis" else state.gen_state


def _port_step(branch, jstate, batch, vgg_params, dtype):
    """The port's trainer step in ``dtype`` from the JAX state's weights and u."""
    if branch == "edge":
        trainer = training.EdgeModelTrainer(residual_blocks=BLOCKS)
    else:
        trainer = training.InpaintingModelTrainer(residual_blocks=BLOCKS)
    state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(state.dis, _np(jstate.dis_params), spectral=_np(jstate.dis_state))
    convert.load_jax_params(state.gen, _np(jstate.gen_params), convt_keys=CONVT,
                            spectral=None if jstate.gen_state is None else _np(jstate.gen_state))
    state.gen.to(dtype)
    state.dis.to(dtype)
    state.gen_opt, state.dis_opt = training.make_optimizers(state.gen, state.dis)
    args = [_t(a).to(dtype) for a in batch]
    if branch == "inpaint":
        loss_vgg = convert.load_jax_params(vgg.VGG19Features(), _np(vgg_params))
        args = [loss_vgg.to(dtype).requires_grad_(False)] + args
    return trainer.train_step(state, *args)


@pytest.mark.parametrize("branch", ["edge", "inpaint"])
def test_trainer_step_matches_jax(branch, monkeypatch):
    """The JAX step runs in float64. The port's float32 step, the training dtype,
    gives its losses; its float64 step gives the gradients the optimizer used and
    the advanced u. (A float32 step at this size puts a discriminator
    pre-activation within rounding of 0 — 5.6e-9 in JAX's float32 step, -2.1e-9 in
    the port's — where the leaky ReLU's slope then differs, moving that conv's
    gradient by 4% of its max|g| between two float32 steps; chip_smoke.py's
    train_ec phase holds the card's float32 gradients to the CPU's by relative L2.)"""
    monkeypatch.setattr(jec, "SNConv", _plain_last_conv)
    jt, jstate0, vgg0 = _jax_init(branch)
    with jax.enable_x64(True):
        jstate, jnew, jmetrics, jgrads, batch, vgg_params = _jax_step(branch, jt, jstate0, vgg0,
                                                                      np.float64)
    for dtype in (torch.float32, torch.float64):
        state, metrics = _port_step(branch, jstate, batch, vgg_params, dtype)
        assert set(metrics) == ({"l_d1", "l_g1", "l_fm"} if branch == "edge"
                                else {"l_d2", "l_g2", "l_l1", "l_per", "l_sty"})
        for name in metrics:
            assert metrics[name].dtype == dtype
            np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-4,
                                       err_msg=f"{dtype} {name}")
    assert state.iteration == 1
    zero = training.instance_norm_fed_biases(state)
    for net in ("gen", "dis"):
        module = getattr(state, net)
        template = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        spectral = _spectral_of(jstate, net)
        want = convert.export_state_dict(
            _np(jgrads[net]), template, CONVT, spectral=None if spectral is None else _np(spectral))
        for name, p in module.named_parameters():
            g, w = p.grad.numpy(), want[name]
            if f"{net}.{name}" in zero:
                prefix = name[: -len("bias")]
                scale = np.abs(want.get(prefix + "weight_orig", want.get(prefix + "weight"))).max()
                assert np.abs(g).max() <= 1e-4 * scale and np.abs(w).max() <= 1e-4 * scale, name
                continue
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                       err_msg=f"{net}.{name}")
        # The power iterations advanced once, from the updated weights.
        spectral = _spectral_of(jnew, net)
        if spectral is None:
            continue
        want = convert.export_state_dict(_np(getattr(jnew, f"{net}_params")), template, CONVT,
                                         spectral=_np(spectral))
        us = [k for k in template if k.endswith("weight_u")]
        assert len(us) == (5 if net == "dis" else 5 + 2 * BLOCKS)
        for k in us:
            np.testing.assert_allclose(module.state_dict()[k].numpy(), want[k], atol=1e-5,
                                       err_msg=f"{net}.{k}")


def test_a_step_advances_u_once_and_backward_skips_the_loss_vgg():
    """Every u moves once a step (and not at the extra forwards of the step; the
    last conv's u has one entry, +-1, and stays); the inpaint step's backward builds
    no gradient of the frozen VGG."""
    trainer = training.InpaintingModelTrainer(residual_blocks=BLOCKS)
    state = trainer.init(torch.Generator().manual_seed(1), device="cpu")
    loss_vgg = layers.seeded_init_(vgg.VGG19Features(), torch.Generator().manual_seed(2))
    loss_vgg.requires_grad_(False)
    images, _, edges, masks = (_t(a) for a in _batch())
    u_before = {k: v.clone() for k, v in state.dis.state_dict().items() if k.endswith("weight_u")}
    assert len(u_before) == 5
    trainer.train_step(state, loss_vgg, images, edges, masks)
    assert all(p.grad is None for p in loss_vgg.parameters())
    for name, m in state.dis.named_modules():
        if not isinstance(m, layers.SNConv2d):
            continue
        before, after = u_before[name + ".weight_u"], m.weight_u
        assert torch.equal(after, before) == (after.numel() == 1), name
        # One power iteration from the step's u with the updated weights, no more.
        w = m._w_mat(m.weight_orig.detach())
        once = layers.l2_normalize(w @ layers.l2_normalize(w.T @ before))
        torch.testing.assert_close(after, once, rtol=0, atol=1e-6)
    # A forward alone leaves u where the step put it.
    snapshot = {k: v.clone() for k, v in state.dis.state_dict().items()}
    with torch.no_grad():
        state.dis(images)
    assert all(torch.equal(state.dis.state_dict()[k], v) for k, v in snapshot.items())


# --- F8: the JAX exporter serves the raw kernel of a trained spectral layer ----------


def _jax_sigma(kernel_hwio, u):
    """sigma of the JAX SNConv's training forward: one power iteration from u."""
    w = np.asarray(kernel_hwio, np.float64).transpose(3, 0, 1, 2).reshape(kernel_hwio.shape[3], -1)
    v = w.T @ np.asarray(u, np.float64)
    v /= np.linalg.norm(v) + 1e-12
    u1 = w @ v
    u1 /= np.linalg.norm(u1) + 1e-12
    return float(u1 @ (w @ v))


def test_f8_jax_export_serves_the_raw_kernel_and_the_port_export_does_not(tmp_path):
    """JAX: ``export_state_dict`` on ``EdgeModelTrainer().init`` with the zoo template,
    then ``fold_spectral_norm``, gives the raw kernel W although the trained layer
    computes with W / sigma, sigma far from 1. The port: a trained run through
    ``cli/export_zoo`` and ``checkpoint.zoo_state_dict`` gives W / sigma, the trained
    module's eval-mode weight, for every spectral layer."""
    jstate = jtraining.EdgeModelTrainer().init(jax.random.PRNGKey(0), hw=(HW, HW))
    entry = TEMPLATE["edge"]
    sd = jconvert.export_state_dict(jstate.gen_params, entry["keys"],
                                    convt_keys=entry["convt_keys"])
    served = jconvert.fold_spectral_norm(sd)["encoder.1.weight"]
    kernel = np.asarray(jstate.gen_params["params"]["encoder_1"]["kernel"])
    raw = kernel.transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(served, raw)  # the raw W is served
    sigma = _jax_sigma(kernel, jstate.gen_state["encoder_1"]["u"])
    assert abs(sigma - 1.0) > 0.1, sigma
    assert np.abs(served - raw / sigma).max() > 1e-2  # ... and not the trained W / sigma

    trainer = training.EdgeModelTrainer(residual_blocks=BLOCKS)
    state = trainer.init(torch.Generator().manual_seed(3), device="cpu")
    _, gray, edges, masks = (_t(a) for a in _batch())
    trainer.train_step(state, gray, edges, masks)
    run = tmp_path / "run"
    run.mkdir()
    checkpoint.save(run / "checkpoint.pt", state)
    dest = export_zoo.export_run("edge", run, tmp_path / "zoo")
    assert dest == checkpoint.zoo_path(tmp_path / "zoo", "edge")
    assert set(torch.load(dest, weights_only=True)) == {"iteration", "generator"}
    folded = checkpoint.zoo_state_dict(tmp_path / "zoo", "edge")
    state.gen.eval()
    n_sn = 0
    for name, m in state.gen.named_modules():
        if isinstance(m, (layers.SNConv2d, layers.SNConvTranspose2d)):
            n_sn += 1
            w_sigma = m.effective_weight().detach()
            np.testing.assert_allclose(folded[f"{name}.weight"].numpy(), w_sigma.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
            assert (w_sigma - m.weight_orig).abs().max() > 1e-3, name  # sigma != 1
    assert n_sn == 5 + 2 * BLOCKS
    served_net = edgeconnect.EdgeGenerator(BLOCKS)
    served_net.load_state_dict(folded, strict=True)
