"""The PyTorch port's ICN training against the JAX package.

JAX-initialized parameters cross into the port through
``models.convert.load_jax_params``. The discriminator and the LSGAN loss agree at
atol 1e-4 (float32 convolutions summed in different orders); one ``ICNTrainer``
step (input_nc 21, ndf 8, 32x32, batch 2) gives the same losses (rtol 1e-4) and
the same gradients (atol 1e-4 * max|g| per tensor). For that step the port's
instance norm takes the reference's single-pass variance: the port's own two-pass
variance is the more accurate one (it holds float32 gradients to float64's, tested
below), and the reference's float32 error alone exceeds 1e-4 * max|g|. Gradients are compared rather
than post-Adam parameters: with betas (0.0, 0.9) the first Adam step is about
lr * sign(g), and the biases that feed an instance norm have gradients that are
zero up to rounding, so their sign is arbitrary in either framework; those biases
are held to being zero instead. Adam itself is held to optax on equal gradients.
"""
import json

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.models.icn import DNLayersMulti as JDNLayersMulti
from future_urban_scene_generation_tpu.models.icn import gan_loss as j_gan_loss
from future_urban_scene_generation_tpu.pipeline import training as jtraining
from future_urban_scene_generation_tpu_torch.cli import train as cli_train
from future_urban_scene_generation_tpu_torch.models import convert, icn
from future_urban_scene_generation_tpu_torch.models.icn import DNLayersMulti, gan_loss
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, training
from future_urban_scene_generation_tpu_torch.pipeline.stages import Models
from future_urban_scene_generation_tpu_torch.spec import ModelSpec

HW, NDF = 32, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    x = (rng.rand(b, HW, HW, 21) * 2 - 1).astype(np.float32)
    y = (rng.rand(b, HW, HW, 3) * 2 - 1).astype(np.float32)
    return x, y


def test_discriminator_and_gan_loss_match_jax():
    key = jax.random.PRNGKey(1)
    jd = JDNLayersMulti(input_nc=3, ndf=16)
    x = (np.random.RandomState(2).rand(2, 40, 40, 3) * 2 - 1).astype(np.float32)
    params = jax.jit(jd.init)(key, jnp.asarray(x))
    ours = convert.load_jax_params(DNLayersMulti(3, ndf=16), _np_tree(params))
    assert {k.rsplit(".", 1)[0] for k in ours.state_dict()} == {
        f"model_{i}.{s}" for i in range(2) for s in (0, 2, 5, 8)}
    ref = jd.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = ours(torch.as_tensor(x))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    mask = (np.random.RandomState(3).rand(2, 40, 40, 1) > 0.4).astype(np.float32)
    preds_t = [torch.as_tensor(np.array(p)) for p in ref]
    for real in (True, False):
        for noise, m in ((None, None), (0.15, None), (None, mask), (-0.2, mask)):
            want = j_gan_loss(ref, real, None if noise is None else jnp.float32(noise),
                              None if m is None else jnp.asarray(m))
            have = gan_loss(preds_t, real, noise, None if m is None else torch.as_tensor(m))
            np.testing.assert_allclose(float(have), float(want), rtol=1e-5, atol=1e-6)


def test_avg_pool_runs_on_an_nchw_contiguous_input(monkeypatch):
    """The discriminator's downsampler hands F.avg_pool2d an NCHW-contiguous
    tensor: on a channels_last input the CUDA backward returns a wrong gradient
    (layers.avg_pool_torch), which a CPU run cannot show, so the layout is pinned
    here and the gradient is held on the card by chip_smoke.py. The values are
    torch's AvgPool2d(3, 2, 1, count_include_pad=False)."""
    from future_urban_scene_generation_tpu_torch.models import layers

    seen = []
    real = torch.nn.functional.avg_pool2d
    monkeypatch.setattr(torch.nn.functional, "avg_pool2d",
                        lambda x, *a, **k: seen.append(x.is_contiguous()) or real(x, *a, **k))
    x = torch.rand(2, 9, 11, 5, generator=torch.Generator().manual_seed(0))
    got = layers.avg_pool_torch(x, 3, 2, 1)
    assert seen == [True]
    ref = torch.nn.AvgPool2d(3, 2, 1, count_include_pad=False)(x.permute(0, 3, 1, 2))
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=0, atol=0)


def _single_pass_instance_norm(x, eps=1e-5):
    """The JAX package's instance_norm (layers.py:865-876): variance E[x^2] - mean^2."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=(1, 2), keepdim=True) - mean * mean, min=0.0)
    return (x - mean.to(x.dtype)) * torch.rsqrt(var + eps).to(x.dtype)


@pytest.fixture(scope="module")
def one_step():
    """One JAX train_step and one port train_step from the same weights and batch,
    and JAX's gradients from the two loss closures of training.py:185-199."""
    jt = jtraining.ICNTrainer(input_nc=21, ndf=NDF, lr=1e-4)
    x, y = _batch()
    jstate = jax.jit(jt.init)(jax.random.PRNGKey(0), jnp.zeros((1, HW, HW, 21)),
                              jnp.zeros((1, HW, HW, 3)))
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    new_jstate, jmetrics = jax.jit(jt.train_step)(jstate, xj, yj)

    fake = jax.jit(jt.gen.apply)(jstate.gen_params, xj)

    def dis_loss_fn(dp):
        return 0.5 * (j_gan_loss(jt.dis.apply(dp, yj), True)
                      + j_gan_loss(jt.dis.apply(dp, jax.lax.stop_gradient(fake)), False))

    def gen_loss_fn(gp):
        fake_g = jt.gen.apply(gp, xj)
        adv = j_gan_loss(jt.dis.apply(new_jstate.dis_params, fake_g), True)
        return adv + jt.l1_weight * jnp.mean(jnp.abs(fake_g - yj))

    jgrads = {"dis": jax.jit(jax.grad(dis_loss_fn))(jstate.dis_params),
              "gen": jax.jit(jax.grad(gen_loss_fn))(jstate.gen_params)}

    trainer = training.ICNTrainer(input_nc=21, ndf=NDF, lr=1e-4)
    state = trainer.init(torch.Generator().manual_seed(0), device="cpu")
    convert.load_jax_params(state.gen, _np_tree(jstate.gen_params))
    convert.load_jax_params(state.dis, _np_tree(jstate.dis_params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(icn, "instance_norm", _single_pass_instance_norm)
        state, metrics = trainer.train_step(state, torch.as_tensor(x), torch.as_tensor(y))
    return jmetrics, jgrads, state, metrics


def test_train_step_losses_match_jax(one_step):
    jmetrics, _, state, metrics = one_step
    assert state.iteration == 1
    for name in ("l_d", "l_g", "l_l1"):
        np.testing.assert_allclose(float(metrics[name]), float(jmetrics[name]), rtol=1e-4)


@pytest.mark.parametrize("net", ["gen", "dis"])
def test_train_step_gradients_match_jax(one_step, net):
    _, jgrads, state, _ = one_step
    module = getattr(state, net)
    template = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    want = convert.export_state_dict(_np_tree(jgrads[net]), template)
    zero = training.instance_norm_fed_biases(state)
    for name, p in module.named_parameters():
        g, w = p.grad.numpy(), want[name]
        if f"{net}.{name}" in zero:
            # Zero up to float32 rounding of the norm's backward in both frameworks.
            scale = np.abs(want[name.replace(".bias", ".weight")]).max()
            assert np.abs(g).max() <= 1e-4 * scale and np.abs(w).max() <= 1e-4 * scale, name
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_instance_norm_keeps_a_large_mean_channel_exact():
    """A channel whose mean dwarfs its spread (mean 10, std 0.01 over 8x8): the
    single-pass variance E[x^2] - mean^2 is off by ~0.27 in float32 here, the
    two-pass one holds float32 to float64 on the same float32 input (~1e-4)."""
    from future_urban_scene_generation_tpu_torch.models.layers import instance_norm

    z = np.random.RandomState(8).randn(2, 8, 8, 3)
    x = torch.as_tensor(10.0 + 0.01 * z, dtype=torch.float32)
    ref = instance_norm(x.double()).numpy()
    np.testing.assert_allclose(instance_norm(x).numpy(), ref, atol=1e-3)


def test_generator_float32_gradients_match_float64():
    """The full-width generator's float32 gradients of adv + 10 * L1 (against the
    initial discriminator, ndf 64, 32x32, batch 2) equal float64's to 1e-3 * max|g|
    per tensor. With a single-pass instance-norm variance they stray by up to
    ~5e-3 on this input; the instance-norm-fed biases are rounding noise in both
    and are left out."""
    trainer = training.ICNTrainer()
    state = trainer.init(torch.Generator().manual_seed(6), device="cpu")
    zero = training.instance_norm_fed_biases(state)
    rng = np.random.RandomState(6)
    x = torch.as_tensor(rng.rand(2, HW, HW, 21) * 2 - 1)
    y = torch.as_tensor(rng.rand(2, HW, HW, 3) * 2 - 1)
    grads = {}
    for dtype in (torch.float64, torch.float32):
        gen, dis = state.gen.to(dtype), state.dis.to(dtype)
        fake = gen(x.to(dtype))
        loss = gan_loss(dis(fake), True) + 10.0 * torch.mean(torch.abs(fake - y.to(dtype)))
        grads[dtype] = dict(zip((n for n, _ in gen.named_parameters()),
                                torch.autograd.grad(loss, list(gen.parameters()))))
    for name, ref in grads[torch.float64].items():
        if f"gen.{name}" in zero:
            continue
        got = grads[torch.float32][name].double()
        assert (got - ref).abs().max() <= 1e-3 * ref.abs().max(), name


def test_adam_update_matches_optax():
    """torch.optim.Adam with the trainer's betas (0.0, 0.9) is optax.adam on the
    same gradients, over three steps."""
    rng = np.random.RandomState(5)
    p0 = rng.randn(4, 7).astype(np.float32)
    grads = [rng.randn(4, 7).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    # Copies on both sides: a zero-copy view of p0 would let torch's in-place
    # update reach the JAX array (XLA:CPU may alias a suitably aligned buffer).
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.Adam([p], lr=1e-4, betas=(0.0, 0.9))
    tx = optax.adam(1e-4, b1=0.0, b2=0.9)
    pj = jnp.array(p0, copy=True)
    st = tx.init(pj)
    for g in grads:
        p.grad = torch.tensor(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st)
        pj = optax.apply_updates(pj, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=1e-6)


def test_l1_falls_over_five_steps():
    trainer = training.ICNTrainer(input_nc=21, ndf=NDF, lr=1e-3)
    state = trainer.init(torch.Generator().manual_seed(3), device="cpu")
    x, y = (torch.as_tensor(a) for a in _batch(seed=1))
    l1 = [float(trainer.train_step(state, x, y)[1]["l_l1"]) for _ in range(5)]
    assert l1[-1] < l1[0], l1


def test_checkpoint_round_trip_and_serving_load(tmp_path):
    trainer = training.ICNTrainer(input_nc=21, ndf=NDF)
    state = trainer.init(torch.Generator().manual_seed(4), device="cpu")
    x, y = (torch.as_tensor(a) for a in _batch(seed=2))
    for _ in range(2):
        trainer.train_step(state, x, y)
    path = tmp_path / "checkpoint.pt"
    checkpoint.save(path, state)
    fresh = checkpoint.restore(path, trainer.init(torch.Generator().manual_seed(9),
                                                  device="cpu"))
    assert fresh.iteration == 2
    for a, b in ((state.gen, fresh.gen), (state.dis, fresh.dis)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    for a, b in ((state.gen_opt, fresh.gen_opt), (state.dis_opt, fresh.dis_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in sa[i]:
                assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    # Train -> serve: the trained generator loads strict into the scene's ICN.
    models = Models.build(ModelSpec(), device="cpu")
    models.icn.load_state_dict(torch.load(path, weights_only=True)["gen"], strict=True)
    for k, v in models.icn.state_dict().items():
        assert torch.equal(v, state.gen.state_dict()[k]), k
    # The saved and the restored state continue identically.
    _, m1 = trainer.train_step(state, x, y)
    _, m2 = trainer.train_step(fresh, x, y)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)


def test_cli_trains_resumes_and_refuses_unported(tmp_path, capsys):
    out = tmp_path / "run"
    common = ["--model", "icn", "--batch", "1", "--device", "cpu", "--out", str(out),
              "--log-interval", "1", "--save-interval", "1"]
    assert cli_train.main(common + ["--steps", "1"]) == 0
    assert (out / "checkpoint.pt").exists()
    assert cli_train.main(common + ["--steps", "2", "--resume"]) == 0
    steps = [json.loads(line)["step"] for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert steps == [0, 1]  # the resumed run picked up at iteration 1
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite([r["l_d"], r["l_g"], r["l_l1"]]).all() for r in recs)
    for argv in (["--model", "edge", "--device", "cpu"],
                 ["--model", "icn", "--device", "cpu", "--image-size", "128"]):
        with pytest.raises(SystemExit) as exc:
            cli_train.main(argv)
        assert exc.value.code != 0
    assert "not ported" in capsys.readouterr().err
