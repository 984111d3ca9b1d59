"""The PyTorch port's VUNet, hourglass and CAD-classifier trainers against the JAX
package's, one train step each from the same parameters, batch and (VUNet) noise.

JAX-initialized parameters cross into the port through ``models.convert``. The bars
are those of tests/test_torch_training.py (the ICN step): losses rtol 1e-4, and the
gradients each optimizer used atol 1e-4 * max|g| per tensor (float32 convolutions
summed in different orders; a float32 step cannot do better). JAX's gradients are
read from its optimizer state after the step (Adam's first moment is (1 - b1) * g).
A parameter the step never reaches (the VUNet's ``app_skip_3_c``, whose skip the
appearance decoder drops) has a zero gradient in JAX and none in torch. A conv bias
that feeds a batch norm is subtracted again with the batch mean, so its gradient is
zero in exact arithmetic and rounding noise in either framework (in the hourglass
that is every conv bias but the score head's: each reader of the residual stream
starts with a batch norm): those are held to being near zero against their conv's
weight gradient. The updated parameters
are compared too, as far as one Adam step allows: its first update is about
lr * sign(g), so where a gradient is zero up to rounding its sign, and with it the
update, is arbitrary in either framework. Every entry must lie within 2 * lr of the
JAX one, and the entries whose gradient is clear of zero (|g| > 1e-2 * max|g| of its
tensor) within 2e-6. The hourglass's running statistics (momentum 0.1, biased batch
variance) agree at atol 5e-5 + rtol 2e-4 (the deep layers' float32 activations
differ by 1e-4 relative between the frameworks; the unbiased variance would be off
by 1/n, up to 12% at the innermost level). The hourglass step runs at 128x128: at the JAX test's
64x64 with a batch of 2 the innermost batch norm sees two values a channel, and the
train-mode forward is then ill-conditioned in either framework (the port's float32
and float64 forwards differ by 0.6 there, by 2e-4 at 128x128). Even so the
hourglass's float32 gradients cannot be held to one another: a randomly
initialized train-mode network of some sixty batch-normed layers amplifies float32
rounding, and the port's own float32 and float64 gradients of this very step differ
by up to 4.8e-2 of max|g| in one tensor (the JAX float32 step is 6e-2 by relative L2
from the port's in ``conv1.weight``). So the hourglass's gradients are held in
float64 instead, where both frameworks compute the same loss and its gradients
agree at 1e-6 * max|g| per tensor (measured 5e-8, the float32 export's rounding),
and the float32 step is held by its loss, its running statistics and its updated
parameters where |g| > 0.25 * max|g|. The classifier and the VUNet keep the
entry-by-entry float32 bar.

For the VUNet step the same ten noise arrays reach both samplers: they are made
from a seed with numpy, ``jax.random.normal`` is patched (in this process only) to
hand them out in call order while the JAX step is traced, and the port takes them as
its ``noise``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.models.vunet import Vunet as JVunet
from future_urban_scene_generation_tpu.ops import heatmap as jheatmap
from future_urban_scene_generation_tpu.pipeline import training as jtraining
from future_urban_scene_generation_tpu_torch.models import convert
from future_urban_scene_generation_tpu_torch.ops import heatmap
from future_urban_scene_generation_tpu_torch.ops.resize import resize_linear
from future_urban_scene_generation_tpu_torch.pipeline import training

LR = 1e-3
HG = 128


@pytest.fixture(scope="module", autouse=True)
def few_intra_op_threads():
    """The whole suite runs in several worker processes at once; a few threads an op
    keep this file's full-width networks from oversubscribing the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exported(module, jparams, classifier=False):
    """A JAX parameter tree as numpy arrays under the port module's state-dict keys."""
    template = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    tree = _np_tree(jparams)
    if classifier:
        return convert.export_state_dict(convert.vgg_classifier_tree(tree), template,
                                         flatten_linear_key="classifier.0.weight",
                                         flatten_linear_chw=(512, 7, 7))
    return convert.export_state_dict(tree, template)


def _adam_grads(opt_state, b1):
    """The gradients a first optax Adam step used: mu = (1 - b1) * g."""
    return jax.tree_util.tree_map(lambda m: m / (1.0 - b1), opt_state[0].mu)


def _hold_step(state, jparams_new, jgrads, metrics, jmetrics, classifier=False, lr=LR,
               noise_biases=(), grads_atol=1e-4, clear_frac=1e-2):
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-4, err_msg=k)
    new = _exported(state.module, jparams_new, classifier)
    grads = _exported(state.module, jgrads, classifier)
    named = dict(state.module.named_parameters())
    held = 0
    for name, p in named.items():
        g_j = grads[name]
        diff = np.abs(p.detach().numpy() - new[name])
        assert diff.max() <= 2 * lr * 1.001, name
        if p.grad is None:  # never reached: JAX's gradient is zero, nothing moved
            assert not g_j.any() and diff.max() == 0.0, name
            continue
        g_t = p.grad.numpy()
        if name in noise_biases:
            weight = np.abs(grads[name[: -len("bias")] + "weight"]).max()
            assert max(np.abs(g_t).max(), np.abs(g_j).max()) <= 1e-4 * weight, name
            continue
        scale = np.abs(g_j).max()
        if grads_atol is not None:
            np.testing.assert_allclose(g_t, g_j, atol=grads_atol * scale + 1e-12, rtol=0,
                                       err_msg=name)
        clear = np.abs(g_j) > clear_frac * scale
        assert clear.any(), name
        assert diff[clear].max() <= 2e-6, name
        held += 1
    assert held > len(named) // 2
    return new


def test_hourglass_step_matches_jax():
    """tests/test_hourglass_trainer.py's shapes (64x64, batch 2, lr 1e-3), one stack."""
    jt = jtraining.HourglassTrainer(num_stacks=1, lr=LR)
    key = jax.random.PRNGKey(0)
    jparams, jopt = jt.init(key, hw=(HG, HG))
    rng = np.random.RandomState(0)
    images = rng.rand(2, HG, HG, 3).astype(np.float32)
    kps = (rng.rand(2, 12, 2) * 0.8 + 0.1).astype(np.float32)
    target = heatmap.heatmaps_from_kpoints(torch.as_tensor(kps), (HG // 4, HG // 4), 1.5)

    jnew, jopt_new, jmetrics = jax.jit(jt.train_step)(jparams, jopt, jnp.asarray(images),
                                                      jnp.asarray(target.numpy()))
    jgrads = _adam_grads(jopt_new, 0.9)

    trainer = training.HourglassTrainer(num_stacks=1, lr=LR)
    state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(state.module, _np_tree(jparams))
    assert state.module.training
    state, metrics = trainer.train_step(state, torch.as_tensor(images), target)
    assert state.iteration == 1
    # Every conv but the score head feeds a batch norm, directly or through the
    # residual stream (whose every reader starts with one).
    named = dict(state.module.named_parameters())
    fed = {n for n in named if n.endswith(".bias") and not n.startswith("score.")
           and named[n[: -len("bias")] + "weight"].dim() == 4}
    assert len(fed) == 55 and "score.0.bias" in named
    new = _hold_step(state, jnew, jgrads, metrics, jmetrics, noise_biases=fed,
                     grads_atol=None, clear_frac=0.25)
    buffers = dict(state.module.named_buffers())
    moved = 0
    for name, b in buffers.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), new[name], atol=5e-5, rtol=2e-4, err_msg=name)
            moved += int(not np.allclose(b.numpy(), 1.0 if name.endswith("var") else 0.0))
    assert moved > 20  # the running statistics left their initial values
    # The same loss and its gradients in float64, from the same parameters.
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jparams)
        im64 = jnp.asarray(images, jnp.float64)
        tg64 = jnp.asarray(target.numpy(), jnp.float64)

        def loss_fn(p):
            out, _ = jt.model.apply({"params": p}, im64, mutable=["bn_stats"])
            return sum(jnp.mean((hm - tg64) ** 2) for hm in out["heatmaps"])

        loss64, g64 = jax.jit(jax.value_and_grad(loss_fn))(p64)
        loss64, g64 = float(loss64), _exported(state.module, g64)
    state64 = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(state64.module, _np_tree(jparams))
    state64.module.double()
    _, m64 = trainer.train_step(state64, torch.as_tensor(images).double(), target.double())
    assert abs(float(m64["loss"]) - loss64) <= 1e-9 * abs(loss64)
    for name, p in state64.module.named_parameters():
        g_t, g_j = p.grad.numpy(), g64[name]
        if name in fed:
            weight = np.abs(g64[name[: -len("bias")] + "weight"]).max()
            assert max(np.abs(g_t).max(), np.abs(g_j).max()) <= 1e-6 * weight, name
        else:
            np.testing.assert_allclose(g_t, g_j, atol=1e-6 * np.abs(g_j).max(), rtol=0,
                                       err_msg=name)
    # Eval mode reads the updated running statistics (JAX's updated tree in both: the
    # two updated trees differ by up to 2 * lr where a gradient's sign is noise).
    state.module.eval()
    convert.load_jax_params(state.module, _np_tree(jnew))
    with torch.no_grad():
        got = state.module(torch.as_tensor(images))[-1]
    want = jt.eval_model.apply({"params": jnew}, jnp.asarray(images))["heatmaps"][-1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_cad_classifier_step_matches_jax():
    """tests/test_hourglass_trainer.py's classifier case: 4 classes, 64x64, batch 2."""
    jt = jtraining.CadClassifierTrainer(num_classes=4, lr=LR)
    key = jax.random.PRNGKey(1)
    jparams, jopt = jt.init(key, hw=(64, 64))
    images = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    labels = np.asarray([1, 3])

    jnew, jopt_new, jmetrics = jax.jit(jt.train_step)(jparams, jopt, jnp.asarray(images),
                                                      jnp.asarray(labels))
    jgrads = _adam_grads(jopt_new, 0.9)
    trainer = training.CadClassifierTrainer(num_classes=4, lr=LR)
    state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_vgg_classifier(state.module, _np_tree(jparams))
    state.module.train()  # the two Dropout modules are never called: no effect
    state, metrics = trainer.train_step(state, torch.as_tensor(images), torch.as_tensor(labels))
    _hold_step(state, jnew, jgrads, metrics, jmetrics, classifier=True)


def test_vunet_step_matches_jax(monkeypatch):
    """tests/test_vunet_trainer.py's network (vunet_256=False) at 64x64, batch 1, with
    the same sampler noise in both."""
    hw = 64
    rng = np.random.RandomState(2)
    y = (rng.rand(1, hw, hw, 3) * 2 - 1).astype(np.float32)
    x_app = (rng.rand(1, hw, hw, 6) * 2 - 1).astype(np.float32)
    target = (rng.rand(1, hw, hw, 3) * 2 - 1).astype(np.float32)
    jt = jtraining.VunetTrainer(vunet=JVunet(vunet_256=False), lr=LR)
    key = jax.random.PRNGKey(0)
    jparams, jopt = jax.jit(jt.init)(key, jnp.asarray(y), jnp.asarray(x_app))

    handed = []
    noise_rng = np.random.RandomState(3)

    def given_normal(_key, shape, dtype=jnp.float32):
        handed.append(noise_rng.standard_normal(shape).astype(np.float32))
        return jnp.asarray(handed[-1], dtype)

    monkeypatch.setattr(jax.random, "normal", given_normal)
    jnew, jopt_new, jmetrics = jax.jit(jt.train_step)(jparams, jopt, key, jnp.asarray(y),
                                                      jnp.asarray(x_app), jnp.asarray(target))
    monkeypatch.undo()
    noise = list(handed)
    assert len(noise) == 10  # 2 appearance samplers + 2 blocks of 4
    jgrads = _adam_grads(jopt_new, 0.5)

    trainer = training.VunetTrainer(vunet_256=False, lr=LR)
    state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(state.module, _np_tree(jparams))
    assert state.opt.defaults["betas"] == (0.5, 0.9)
    state, metrics = trainer.train_step(
        state, [torch.as_tensor(n) for n in noise], torch.as_tensor(y),
        torch.as_tensor(x_app), torch.as_tensor(target))
    assert float(metrics["kl"]) > 0 and float(metrics["recon"]) > 0
    _hold_step(state, jnew, jgrads, metrics, jmetrics)


def test_vunet_sampling_with_a_generator():
    """cov = 1 from a ``torch.Generator``: seeded, different per seed, the means
    equal to the cov = 0 forward's up to the first sample, and serving (cov = 0)
    draws nothing."""
    from future_urban_scene_generation_tpu_torch.models.layers import seeded_init_
    from future_urban_scene_generation_tpu_torch.models.vunet import Vunet

    net = seeded_init_(Vunet(vunet_256=False), torch.Generator().manual_seed(0)).eval()
    rng = np.random.RandomState(0)
    y = torch.as_tensor((rng.rand(1, 64, 64, 3) * 2 - 1).astype(np.float32))
    x = torch.as_tensor((rng.rand(1, 64, 64, 6) * 2 - 1).astype(np.float32))
    with torch.no_grad():
        a = net(y, x, cov=1.0, noise=torch.Generator().manual_seed(1))
        b = net(y, x, cov=1.0, noise=torch.Generator().manual_seed(1))
        c = net(y, x, cov=1.0, noise=torch.Generator().manual_seed(2))
        mean = net(y, x, cov=0.0)
        served = net.decode_shape(y, net.encode_appearance(x))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    torch.testing.assert_close(a[1][0], mean[1][0], rtol=0, atol=0)  # mu_0: before any draw
    assert not torch.equal(a[1][1], mean[1][1])
    torch.testing.assert_close(served, mean[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="noise of shape"):
        net(y, x, cov=1.0, noise=[torch.zeros(1, 3, 3, 128)])


def test_batch_norm_train_mode_with_one_value_a_channel():
    """``cli.train --model hourglass --image-size 64 --batch 1`` reaches a 1x1 map:
    torch's batch norm refuses one value a channel, the JAX one computes a zero
    variance (output = beta, running statistics toward (x, 0))."""
    from future_urban_scene_generation_tpu_torch.models.hourglass import BatchNorm2d

    bn = BatchNorm2d(4).train()
    with torch.no_grad():
        bn.bias.copy_(torch.arange(4.0))
    x = torch.tensor([[[[1.0, -2.0, 3.0, 0.5]]]], requires_grad=True)
    y = bn(x)
    torch.testing.assert_close(y.detach(), torch.arange(4.0).reshape(1, 1, 1, 4))
    y.sum().backward()
    assert not x.grad.any() and bn.bias.grad.tolist() == [1.0] * 4
    torch.testing.assert_close(bn.running_mean, 0.1 * x.detach().reshape(4))
    torch.testing.assert_close(bn.running_var, torch.full((4,), 0.9))


@pytest.mark.parametrize("shape,sigma", [((32, 32), 4.0), ((16, 24), 1.5)])
def test_heatmaps_match_jax(shape, sigma):
    """tests/test_config_heatmap.py's bar (1e-5) against the JAX functions, batched,
    with a missing keypoint; and the host helpers."""
    rng = np.random.RandomState(0)
    kps = rng.rand(3, 12, 2).astype(np.float32)
    kps[0, 2] = [-1.0, 0.5]
    kps[1, 5] = [0.3, 0.0]
    got = heatmap.heatmaps_from_kpoints(torch.as_tensor(kps), shape, sigma)
    assert got.shape == (3,) + shape + (12,)
    for b in range(3):
        want = jheatmap.heatmaps_from_kpoints(jnp.asarray(kps[b]), shape, sigma)
        assert np.abs(got[b].numpy() - np.asarray(want)).max() < 1e-5
    assert got[0, ..., 2].sum() == 0.0 and got[1, ..., 5].sum() == 0.0
    assert float(got.max()) <= 1.0
    one = heatmap.kpoint_to_heatmap(torch.as_tensor(kps[2, 0]), shape, sigma)
    want = jheatmap.kpoint_to_heatmap(jnp.asarray(kps[2, 0]), shape, sigma)
    assert one.shape == shape and np.abs(one.numpy() - np.asarray(want)).max() < 1e-5
    rows = [[np.ones((2, 2, 3)), np.zeros((2, 2, 3))]]
    grid = heatmap.random_blend_grid(rows, rows)
    ref = jheatmap.random_blend_grid(rows, rows)
    assert len(grid) == 2 and all(np.array_equal(a, b) for a, b in zip(grid, ref))


def test_resize_linear_matches_jax_image_resize():
    """``--image-size``: ``jax.image.resize(..., "linear")`` down, up and ragged."""
    img = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    for out in ((16, 16), (48, 48), (20, 27), (32, 32)):
        want = jax.image.resize(jnp.asarray(img), (2,) + out + (3,), "linear")
        got = resize_linear(torch.as_tensor(img), out)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
