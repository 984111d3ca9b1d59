"""The int8 serving tier (``ModelSpec.quantized_convs``) against the JAX package's
(``stages.configure_models(quantized_convs=True)``), on the CPU.

* One conv: the port's codes equal the JAX ``_int8_conv`` / ``_int8_conv_transpose``
  codes, and the outputs agree to 1 ulp of the output dtype (float32, bfloat16), at
  stride 1 and 2, dilation 2, padding, and the 4x4 stride-2 transposed conv. The plain
  version of kernel N2 holds the exact int32 sum at full code range.
* The gate: narrow convs, the knob off, VUNet under the tier, the spectral-norm layers
  stay bit-exact with the float path; the scope is per thread; the gradient is the
  float conv's.
* Networks with the tier on, port against JAX: the VGG classifier and EdgeConnect's
  inpaint generator >= 45 dB (the same codes up to rounding of the float parts); the
  hourglass >= 35 dB: each of its convs agrees with JAX's to ~140 dB, but where a
  float part differs by an ulp a code rounds the other way (a layer then agrees to
  ~80 dB) and the deep random-weight hourglass amplifies that to 39-43 dB at the
  output (four inputs, 64^2 to 256^2); the ICN generator >= 40 dB: its float parts
  before the first int8 conv differ by rounding (140 dB: the port's two-pass instance
  norm, the conv's summation order), 4 codes of the first down conv round the other
  way, and each following int8 conv carries the flips on until the output sits near the
  tier's own noise (40.8 dB on this input); ``synthesize_scene`` with oracle perception
  >= 45 dB on the ICN branch's composited frames, >= 30 dB on the VUNet branch's. PSNR
  is taken against the reference's peak |value|. XLA's int8 convolution is slow on the
  CPU, so the networks are narrow and the scene's ICN has ngf 16.
* An ICN up stage (F10): the port quantizes the JAX package's phase-packed (3, 3, C,
  4 O) contraction at source resolution, the same operands and codes, the interior to
  1 ulp, the 2-pixel borders in float.
"""
import threading

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.models import convert as jconvert
from future_urban_scene_generation_tpu.models import layers as jl
from future_urban_scene_generation_tpu.models.edgeconnect import (
    EDGECONNECT_CONVT_KEYS,
    InpaintGenerator as JInpaintGenerator,
)
from future_urban_scene_generation_tpu.models.hourglass import HourglassNet as JHourglass
from future_urban_scene_generation_tpu.models.icn import GResnet as JGResnet
from future_urban_scene_generation_tpu.models.vgg import VGG19Classifier as JVGG
from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.pipeline import runner as jrunner
from future_urban_scene_generation_tpu.pipeline import stages as jstages
from future_urban_scene_generation_tpu_torch.models import convert, edgeconnect, layers
from future_urban_scene_generation_tpu_torch.models.hourglass import HourglassNet
from future_urban_scene_generation_tpu_torch.models.icn import GResnet
from future_urban_scene_generation_tpu_torch.models.vgg import VGG19Classifier
from future_urban_scene_generation_tpu_torch.ops import cuda_conv
from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, synthetic
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from torch_refs import _t_ec_generator

QUANT = ModelSpec(quantized_convs=True)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture()
def jax_quantized():
    jstages.configure_models(quantized_convs=True)
    try:
        yield
    finally:
        jstages.configure_models(quantized_convs=False)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture()
def int8_calls(monkeypatch):
    """The int8 tier's launches of kernel N2's wrapper (its plain version here), each
    as (output shape, C_in, transposed)."""
    calls = []
    inner = cuda_conv.conv_int8

    def counted(xq, *args, **kwargs):
        y = inner(xq, *args, **kwargs)
        calls.append((tuple(y.shape), xq.shape[-1], kwargs.get("in_dilation", 1) > 1))
        return y

    monkeypatch.setattr(cuda_conv, "conv_int8", counted)
    return calls


@pytest.fixture()
def jax_int8_calls(monkeypatch):
    """The JAX package's ``_int8_conv`` / ``_int8_conv_transpose`` calls while it traces,
    in the form of :func:`int8_calls` (an ICN up stage's is its phase-packed
    contraction, (N, h, w, 4 O), as the port's). ``_dispatch_conv``'s custom VJP traces
    its forward rule as well as the function: calls made inside the forward rule are
    the same convs again, and are not recorded."""
    calls, in_fwd = [], []
    conv, conv_t = jl._int8_conv, jl._int8_conv_transpose
    fwd = jl._dispatch_conv.fwd

    def record(call):
        if not in_fwd:
            calls.append(call)

    def counted_conv(x, *args, **kwargs):
        y = conv(x, *args, **kwargs)
        record((tuple(y.shape), x.shape[-1], False))
        return y

    def counted_conv_t(x, *args, **kwargs):
        y = conv_t(x, *args, **kwargs)
        record((tuple(y.shape), x.shape[-1], True))
        return y

    def tagged(flag, fn):
        def run(*args, **kwargs):
            flag.append(True)
            try:
                return fn(*args, **kwargs)
            finally:
                flag.pop()
        return run

    monkeypatch.setattr(jl, "_int8_conv", counted_conv)
    monkeypatch.setattr(jl, "_int8_conv_transpose", counted_conv_t)
    monkeypatch.setattr(jl._dispatch_conv, "fwd", tagged(in_fwd, fwd))
    return calls


def _psnr(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    peak = np.abs(ref).max()
    return float(10.0 * np.log10(peak * peak / max(np.mean((got - ref) ** 2), 1e-30)))


def _jax_codes(x, w):
    """The quantization of the JAX ``_int8_conv`` (layers.py:195-205), step by step."""
    sx = jnp.maximum(jnp.max(jnp.abs(x), axis=(0, 1, 2)).astype(jnp.float32), 1e-12) * (
        1.0 / 127.0)
    w_eff = w.astype(jnp.float32) * sx[None, None, :, None]
    sw = jnp.maximum(jnp.max(jnp.abs(w_eff), axis=(0, 1, 2)), 1e-12) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(x.astype(jnp.float32) / sx), -127, 127).astype(jnp.int8)
    wq = jnp.clip(jnp.round(w_eff / sw), -127, 127).astype(jnp.int8)
    return np.asarray(xq), np.asarray(wq), np.asarray(sw)


def _ulp(ref: np.ndarray, dtype) -> np.ndarray:
    """One unit in the last place of each reference value in ``dtype``."""
    if dtype == torch.float32:
        return np.spacing(np.abs(ref).astype(np.float32))
    exp = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return 2.0 ** (exp - 7)  # bfloat16: 8 significant bits


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
CONVS = [  # (kind, k, stride, padding, dilation)
    ("conv", 3, 1, 1, 1), ("conv", 3, 2, 1, 1), ("conv", 3, 1, 2, 2), ("conv", 4, 2, 1, 1),
    ("transpose", 4, 2, 1, 1),
]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("kind,k,stride,padding,dilation", CONVS)
def test_int8_conv_codes_and_output_match_jax(dtypes, kind, k, stride, padding, dilation):
    tdt, jdt = dtypes
    rng = np.random.RandomState(k * 10 + stride + dilation)
    x = (rng.randn(2, 11, 13, 40) * 3).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    if kind == "conv":
        w = (rng.randn(48, 40, k, k) * 0.05).astype(np.float32)  # OIHW
        wj = jnp.asarray(w.transpose(2, 3, 1, 0)).astype(jdt)  # HWIO, in x's dtype
        want = jl._int8_conv(xj, wj, stride, padding, dilation)
        with layers.quantized_convs():
            got = layers.conv_nhwc(xt, torch.from_numpy(w), None, stride, padding, dilation)
        w_port = torch.from_numpy(w).to(tdt).permute(2, 3, 1, 0)
    else:
        w = (rng.randn(40, 48, k, k) * 0.05).astype(np.float32)  # (in, out, kh, kw)
        wj = jnp.flip(jnp.asarray(w.transpose(2, 3, 0, 1)), axis=(0, 1)).astype(jdt)
        lo = k - 1 - padding
        want = jl._int8_conv_transpose(xj, wj, lo, lo, stride)
        with layers.quantized_convs():
            got = layers.conv_transpose_nhwc(xt, torch.from_numpy(w), None, stride, padding)
        w_port = torch.from_numpy(w).to(tdt).permute(2, 3, 0, 1).flip(0, 1)
    for a, b in zip(layers.quantize_int8(xt, w_port), _jax_codes(xj, wj)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    got32, want32 = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert (np.abs(got32 - want32) <= _ulp(want32, tdt)).all()


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_int8_up_stage_is_the_jax_phase_packed_stage(dtypes, jax_quantized, monkeypatch):
    """F10: an ICN up stage on the tier quantizes what the JAX
    ``upconv2x_nearest_reflect`` quantizes, the phase-packed (3, 3, C, 4 O) kernel on
    the source reflect-padded by 1: the same operands bit for bit, the same codes, the
    interior within 1 ulp; the 2-pixel borders are the float conv's: the port's plain
    composition bit for bit, JAX's float borders to float rounding."""
    tdt, jdt = dtypes
    rng = np.random.RandomState(21)
    x = (rng.randn(1, 8, 8, 32) * 2).astype(np.float32)
    k = (rng.randn(5, 5, 32, 16) * 0.05).astype(np.float32)  # HWIO, the flax param
    bias = (rng.randn(16) * 0.1).astype(np.float32)
    seen = []
    conv = jl._int8_conv

    def recorded(a, w, *args):
        seen.append((np.asarray(a.astype(jnp.float32)), np.asarray(w.astype(jnp.float32))))
        return conv(a, w, *args)

    monkeypatch.setattr(jl, "_int8_conv", recorded)
    xj = jnp.asarray(x).astype(jdt)
    want = jl.upconv2x_nearest_reflect(xj, jnp.asarray(k))
    want = np.asarray((want + jnp.asarray(bias).astype(want.dtype)).astype(jnp.float32))
    assert len(seen) == 1
    xt = torch.from_numpy(x).to(tdt)
    w_oihw = torch.from_numpy(k).permute(3, 2, 0, 1)
    kp = layers.upconv_phase_kernel(w_oihw.permute(2, 3, 1, 0)).to(tdt)
    xp = layers.reflect_pad(xt, 1)
    np.testing.assert_array_equal(kp.float().numpy(), seen[0][1])
    np.testing.assert_array_equal(xp.float().numpy(), seen[0][0])
    xp_j, kp_j = (jnp.asarray(a).astype(jdt) for a in seen[0])
    for a, b in zip(layers.quantize_int8(xp, kp), _jax_codes(xp_j, kp_j)):
        np.testing.assert_array_equal(a.numpy(), b)
    with layers.quantized_convs():
        got = layers.upconv2x_nearest_reflect(xt, w_oihw, torch.from_numpy(bias))
    assert got.dtype == tdt and tuple(got.shape) == (1, 16, 16, 16)
    got = got.float().numpy()
    inner = (slice(None), slice(2, -2), slice(2, -2))
    assert (np.abs(got[inner] - want[inner]) <= _ulp(want[inner], tdt)).all()
    with layers.suppress_quantization():
        plain = layers.upconv2x_nearest_reflect(xt, w_oihw, torch.from_numpy(bias)).float().numpy()
    border = np.ones(got.shape, bool)
    border[inner] = False
    np.testing.assert_array_equal(got[border], plain[border])
    # The float convs of the two frameworks sum their 800 products in another order.
    tol = 1e-5 if tdt == torch.float32 else 1e-2
    assert np.abs(got[border] - want[border]).max() <= tol * np.abs(want).max()
    assert not np.allclose(got[inner], plain[inner], rtol=1e-6, atol=0)


def test_int8_plain_version_is_the_exact_int32_sum():
    """All codes +127 at K = 5 * 5 * 64: every interior sum is 127^2 * 1,600 exactly."""
    xq = torch.full((1, 9, 9, 64), 127, dtype=torch.int8)
    wq = torch.full((5, 5, 64, 32), 127, dtype=torch.int8)
    out = cuda_conv.conv_int8_plain(xq, wq, torch.ones(32), torch.float32, pad_lo=2, pad_hi=2)
    assert out[0, 4, 4, 0].item() == 127 * 127 * 1600
    want = np.zeros((9, 9))
    for y in range(9):
        for x in range(9):
            want[y, x] = (min(y + 2, 8) - max(y - 2, 0) + 1) * (min(x + 2, 8) - max(x - 2, 0) + 1)
    np.testing.assert_array_equal(out[0, :, :, 5].numpy(), np.float32(want * 127 * 127 * 64))
    holes = cuda_conv.conv_int8_plain(xq, wq, torch.ones(32), torch.float32, pad_lo=4,
                                      pad_hi=4, in_dilation=2)
    assert tuple(holes.shape[1:3]) == cuda_conv.int8_out_hw(9, 9, 5, 1, 4, 4, 1, 2)


def test_int8_route_is_kernel_n2_on_the_codes():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 8, 8, 64).astype(np.float32))
    w = torch.from_numpy((rng.randn(64, 64, 3, 3) * 0.05).astype(np.float32))
    with layers.quantized_convs():
        got = layers.conv_nhwc(x, w, None, 1, 1)
    xq, wq, sw = layers.quantize_int8(x, w.permute(2, 3, 1, 0))
    want = cuda_conv.conv_int8_plain(xq, wq, sw, torch.float32, pad_lo=1, pad_hi=1)
    assert torch.equal(got, want)
    assert not torch.equal(got, layers.conv_nhwc(x, w, None, 1, 1))


@pytest.mark.parametrize("case", ["narrow_in", "narrow_out", "knob_off", "float64",
                                  "sn_conv", "sn_transpose"])
def test_gated_convs_stay_bit_exact(case):
    """Where the JAX gate says float (C_in or C_out below 32, the knob off, float64,
    the spectral-norm layers), the tier changes no bit."""
    rng = np.random.RandomState(5)
    cin, cout = {"narrow_in": (16, 64), "narrow_out": (64, 16)}.get(case, (64, 64))
    x = torch.from_numpy(rng.randn(1, 9, 9, cin).astype(np.float32))
    if case == "float64":
        x = x.double()
    torch.manual_seed(0)
    if case == "sn_conv":
        mod = layers.SNConv2d(cin, cout, 3, padding=1)
    elif case == "sn_transpose":
        mod = layers.SNConvTranspose2d(cin, cout, 4, 2, 1)
    else:
        mod = layers.Conv2d(cin, cout, 3, padding=1)
    layers.seeded_init_(mod, torch.Generator().manual_seed(1))
    mod = mod.to(x.dtype).eval()
    with torch.no_grad():
        want = mod(x)
        with layers.quantized_convs(case != "knob_off"):
            got = mod(x)
    assert torch.equal(got, want)
    if case in ("narrow_in", "narrow_out"):  # JAX routes them to its float conv too
        xj = jnp.asarray(x.numpy())
        wj = jnp.asarray(mod.weight.detach().numpy().transpose(2, 3, 1, 0))
        jstages.configure_models(quantized_convs=True)
        try:
            routed = jl._dispatch_conv(xj, wj, 1, 1)
        finally:
            jstages.configure_models(quantized_convs=False)
        np.testing.assert_array_equal(np.asarray(routed), np.asarray(jl._xla_conv(xj, wj, 1, 1)))


@torch.no_grad()
def test_vunet_is_float_under_the_tier():
    """JAX test_int8_vunet_suppressed: with float32 generators the knob is a bit-exact
    no-op on both VUNet forwards (stages wrap them in suppress_quantization)."""
    models = stages.Models.build(ModelSpec(), torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.RandomState(7)
    frame = torch.from_numpy(rng.rand(300, 400, 3).astype(np.float32))
    sketch = torch.from_numpy(rng.rand(1, 256, 256, 3).astype(np.float32))
    mask = torch.from_numpy(rng.rand(1, 256, 256) > 0.5)
    win = stages.cr.Window(*(torch.tensor([v]) for v in (60.0, 20.0, 256.0, 256.0)))
    out = {}
    for spec in (ModelSpec(), QUANT):
        mu = stages.vunet_encode_appearance_batch(models, spec, frame, sketch, mask, win)
        out[spec.quantized_convs] = (mu, stages.vunet_decode_batch(models, spec, sketch, mu))
    for a, b in zip(out[False][0] + [out[False][1]], out[True][0] + [out[True][1]]):
        assert torch.equal(a, b)


def test_scope_is_per_thread():
    """A worker inside the tier and one outside, interleaved: each sees its own."""
    seen = {}
    barrier = threading.Barrier(2)

    def worker(name, enabled):
        with layers.quantized_convs(enabled):
            barrier.wait()
            seen[name] = layers.quantization_active()
            with layers.suppress_quantization():
                barrier.wait()
                seen[name + "_suppressed"] = layers.quantization_active()
        seen[name + "_after"] = layers.quantization_active()

    threads = [threading.Thread(target=worker, args=a) for a in (("on", True), ("off", False))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"on": True, "off": False, "on_suppressed": False, "off_suppressed": False,
                    "on_after": False, "off_after": False}


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transpose"])
def test_int8_gradient_is_the_float_convs(transposed):
    rng = np.random.RandomState(9)
    x0 = torch.from_numpy(rng.randn(1, 6, 6, 32).astype(np.float32))
    shape = (32, 40, 4, 4) if transposed else (40, 32, 3, 3)
    w0 = torch.from_numpy((rng.randn(*shape) * 0.05).astype(np.float32))
    g = torch.from_numpy(rng.randn(1, 12, 12, 40) if transposed else rng.randn(1, 3, 3, 40)
                         ).float()
    grads = []
    for enabled in (True, False):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        with layers.quantized_convs(enabled):
            y = (layers.conv_transpose_nhwc(x, w, None, 2, 1) if transposed
                 else layers.conv_nhwc(x, w, None, 2, 1))
        y.backward(g)
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _hourglass():
    params = jax.jit(JHourglass().init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    return params, convert.load_jax_params(HourglassNet().eval(), _np_tree(params))


def _vgg():
    params = jax.jit(JVGG(num_classes=10).init)(jax.random.PRNGKey(1),
                                                jnp.zeros((1, 32, 32, 3)))
    return params, convert.load_vgg_classifier(VGG19Classifier(10).eval(), _np_tree(params))


def _inpaint_generator():
    torch.manual_seed(4)
    sd = _t_ec_generator(4, 3, use_sn=False, blocks=1).eval().state_dict()
    net = edgeconnect.InpaintGenerator(residual_blocks=1).eval()
    net.load_state_dict(sd, strict=True)
    return jconvert.convert_state_dict(sd, convt_keys=EDGECONNECT_CONVT_KEYS), net


def _icn():
    jnet = JGResnet(input_nc=21, n_res=1, ngf=32)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(2), jnp.zeros((1, 64, 64, 21)))
    return params, convert.load_jax_params(GResnet(21, n_res=1, ngf=32).eval(), _np_tree(params))


NETWORKS = {  # name: (make the pair, JAX module, input shape, PSNR bar)
    "hourglass": (_hourglass, JHourglass(), (1, 64, 64, 3), 35.0),
    "vgg": (_vgg, JVGG(num_classes=10), (2, 32, 32, 3), 45.0),
    "inpaint_generator": (_inpaint_generator, JInpaintGenerator(residual_blocks=1),
                          (1, 64, 64, 4), 45.0),
    "icn": (_icn, JGResnet(input_nc=21, n_res=1, ngf=32), (2, 64, 64, 21), 40.0),
}


@pytest.mark.parametrize("name", list(NETWORKS))
def test_network_on_the_tier_matches_jax(name, jax_quantized, int8_calls, jax_int8_calls):
    """The port takes the tier at exactly the convs the JAX package does (the same
    number of int8 convs, of the same shapes), and the outputs agree to the bar."""
    build, jnet, shape, bar = NETWORKS[name]
    params, net = build()
    jax_int8_calls.clear()  # the initialization's trace
    x = np.random.RandomState(11).rand(*shape).astype(np.float32) * 2 - 1
    # A new function, so that the knob-on trace (and its int8 calls) happens here.
    want = jax.jit(lambda p, v: jnet.apply(p, v))(params, jnp.asarray(x))
    with torch.no_grad(), layers.quantized_convs():
        got = net(torch.from_numpy(x))
    if name == "hourglass":
        want, got = want["heatmaps"][-1], got[-1]
    want = np.asarray(want)
    assert got.shape == want.shape
    assert _psnr(got.numpy(), want) >= bar
    assert int8_calls and sorted(int8_calls) == sorted(jax_int8_calls)


@torch.no_grad()
def test_synthesize_scene_on_the_tier_matches_jax(monkeypatch, jax_quantized, int8_calls,
                                                  jax_int8_calls):
    """The oracle scene of tests/test_pipeline.py with the knob on in both packages;
    the ICN has ngf 16 and one residual block a trunk (down stage 2, the trunks and up
    stage 1 on the tier) so that XLA's CPU int8 convolutions stay within seconds."""
    sc = synthetic.make_oracle_scene()
    key = jax.random.PRNGKey(0)
    cadm, hgm, _, vunm = jstages.Models.modules()
    icnm = JGResnet(input_nc=21, n_res=1, ngf=16)
    monkeypatch.setattr(jstages.Models, "modules", staticmethod(lambda: (cadm, hgm, icnm, vunm)))
    icn_p = jax.jit(icnm.init)(key, jnp.zeros((1, 64, 64, 21)))
    vun_p = jax.jit(lambda k: vunm.init({"params": k}, jnp.zeros((1, 128, 128, 3)),
                                        jnp.zeros((1, 128, 128, 6)), cov=0.0))(key)
    built = stages.Models.build(ModelSpec(), torch.Generator().manual_seed(0), device="cpu")
    ours = built._replace(icn=convert.load_jax_params(GResnet(21, n_res=1, ngf=16).eval(),
                                                      _np_tree(icn_p)))
    convert.load_jax_params(ours.vunet, _np_tree(vun_p))
    jax_int8_calls.clear()  # the initializations' traces

    bank_j = jrunner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0)
    window = jax.vmap(jcr.square_window_from_bbox)(jnp.asarray(sc["bboxes"]))
    per_j = jstages.Perception(cad_idx=jnp.zeros(2, jnp.int32), kp_frame=jnp.asarray(sc["kp2d"]),
                               window=window, crop=jnp.zeros((2, 256, 256, 3)))
    want = jrunner.synthesize_scene(jstages.Models(None, None, icn_p, vun_p), bank_j,
                                    jnp.asarray(sc["frame"]), jnp.asarray(sc["background"]),
                                    per_j, jnp.asarray(sc["meters"]), jnp.asarray(sc["intrinsic"]))
    bank = runner.build_cad_bank([sc["mesh"]] * 2, [sc["kp3d"]] * 2, scale=5.0, device="cpu")
    t = lambda k: torch.as_tensor(sc[k])  # noqa: E731
    got = runner.synthesize_scene(ours, bank, t("frame"), t("background"),
                                  synthetic.oracle_perception(sc, device="cpu"), t("meters"),
                                  t("intrinsic"), spec=QUANT)
    for name, bar in (("frames_icn", 45.0), ("frames_vunet", 30.0)):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _psnr(a, b) >= bar, name
    # Down stage 2, the encoder's and the decoder's residual block (two convs each),
    # both up stages: one launch each over the scene's 6 vehicle-steps, the convs the
    # JAX scene quantizes.
    assert len(int8_calls) == 7 and all(c[0][0] == 6 for c in int8_calls)
    assert sorted(int8_calls) == sorted(jax_int8_calls)


def test_the_service_spec_and_the_erase_take_the_tier(int8_calls):
    """A library caller sets the knob on the configuration the service reads (no CLI
    flag, as the JAX package); inside the tier's scope (the service's around its erase)
    the erase runs both EdgeConnect generators on it: encoder.4, encoder.7, the block's
    two convs and the two transposed convs each."""
    from future_urban_scene_generation_tpu_torch.config import PipelineConfig, RuntimeConfig
    from future_urban_scene_generation_tpu_torch.pipeline import inpaint

    assert PipelineConfig().model_spec().quantized_convs is False
    assert PipelineConfig(runtime=RuntimeConfig(quantized_convs=True)).model_spec() == QUANT
    edge, inp = edgeconnect.build_generators(torch.Generator().manual_seed(3), device="cpu",
                                             residual_blocks=1)
    rng = np.random.RandomState(4)
    frames = torch.from_numpy(rng.rand(1, 80, 96, 3).astype(np.float32))
    mask = torch.zeros(1, 80, 96, dtype=torch.bool)
    mask[:, 30:50, 30:70] = True
    bbox = torch.tensor([28.0, 28.0, 72.0, 52.0])
    plain = inpaint.erase_vehicle(edge, inp, frames, bbox, mask)
    assert not int8_calls
    with layers.quantized_convs():
        tier = inpaint.erase_vehicle(edge, inp, frames, bbox, mask)
    assert len(int8_calls) == 12
    assert not torch.equal(tier, plain)


@pytest.mark.parametrize("overlap", [True, False], ids=["dispatch", "call"])
@pytest.mark.parametrize("spec", [ModelSpec(), QUANT], ids=["float", "int8"])
def test_tracking_stream_runs_its_detector_on_the_spec_tier(spec, overlap):
    """The JAX knob is process-wide, so its jitted ``MaskRCNNDetector`` traces on the
    tier too; the port's ``TrackingStreamRunner`` opens its spec's scope around the
    detector's forward (split or whole), and the caller's thread is left as it was."""
    from types import SimpleNamespace

    from future_urban_scene_generation_tpu_torch.pipeline import streaming

    seen = []

    class Detector:
        def dispatch(self, frame):
            seen.append(layers.quantization_active())
            return frame

        def finalize(self, handle):
            return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)

        def __call__(self, frame):
            return self.finalize(self.dispatch(frame))

    bank = SimpleNamespace(vertices=torch.zeros(1, 3))
    stream = streaming.TrackingStreamRunner(
        None, bank, np.eye(3, dtype=np.float32), (8, 8), 1, spec=spec, detector=Detector(),
        overlap_detect=overlap)
    for _ in range(2):
        assert stream.submit_frame(np.zeros((8, 8, 3), np.float32))[0] is None
    assert seen == [spec.quantized_convs] * 2
    assert not layers.quantization_active()
