"""EdgeConnect in the PyTorch port (spectral-norm folding, the two generators, the
vehicle erase and the zoo files) against the JAX package's, on the CPU.

Tolerances: the fold is exact (both fold in float64 with numpy); the generators are
held to tests/test_edgeconnect.py's 2e-3 at 64^2 with 8 blocks (the port's instance
norm is two-pass, the JAX one single-pass). The erase runs at its fixed 256^2 crop:
Canny maps may disagree on under 0.2% of the pixels (tests/test_crop_canny_morph.py's
budget), the frame is held to 2e-3 with the same edge map handed to both, and pixels
outside the context window are equal.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from future_urban_scene_generation_tpu.models import convert as jconvert
from future_urban_scene_generation_tpu.models.edgeconnect import (
    EDGECONNECT_CONVT_KEYS,
    EdgeGenerator as JEdgeGenerator,
    InpaintGenerator as JInpaintGenerator,
)
from future_urban_scene_generation_tpu.ops import canny as jcn
from future_urban_scene_generation_tpu.ops import colorspace as jcs
from future_urban_scene_generation_tpu.ops import crop as jcr
from future_urban_scene_generation_tpu.ops import morphology as jmo
from future_urban_scene_generation_tpu.pipeline import inpaint as jinpaint
from future_urban_scene_generation_tpu_torch.models import convert, edgeconnect, layers
from future_urban_scene_generation_tpu_torch.models.maskrcnn import MaskRCNN
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint, inpaint
from torch_refs import _t_ec_generator

GEN_TOL = 2e-3  # tests/test_edgeconnect.py:30
CANNY_BUDGET = 0.002  # tests/test_crop_canny_morph.py:166


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Full-width 256^2 generators: cap torch's intra-op threads (the tier runs six
    workers on the machine's cores)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def reference_pair():
    """The reference's two generators (torch_refs mirror, 8 blocks), the edge one
    with spectral norm, after one train-mode call so that u and v are not their
    initial values; their state dicts and the JAX package's conversion of them."""
    torch.manual_seed(3)
    edge_t = _t_ec_generator(3, 1, use_sn=True, blocks=8)
    with torch.no_grad():
        edge_t(torch.rand(1, 3, 32, 32))
    edge_t.eval()
    inpaint_t = _t_ec_generator(4, 3, use_sn=False, blocks=8).eval()
    sds = {"edge": edge_t.state_dict(), "inpaint": inpaint_t.state_dict()}
    params = {k: jconvert.convert_state_dict(v, convt_keys=EDGECONNECT_CONVT_KEYS)
              for k, v in sds.items()}
    ours = edgeconnect.build_generators(device="cpu")
    for net, name in zip(ours, ("edge", "inpaint")):
        net.load_state_dict(convert.fold_spectral_norm(sds[name]), strict=True)
    return sds, params, ours


def test_fold_spectral_norm_matches_jax_exactly(reference_pair):
    sds, _, _ = reference_pair
    sd = sds["edge"]
    assert any(k.endswith("weight_orig") for k in sd)
    got = convert.fold_spectral_norm(sd)
    want = jconvert.fold_spectral_norm({k: v.numpy() for k, v in sd.items()})
    assert got.keys() == want.keys()
    assert not any(k.endswith(("weight_orig", "weight_u", "weight_v")) for k in got)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    # The transposed convs are normalized along dim 1.
    assert sd["decoder.0.weight_u"].numel() == sd["decoder.0.weight_orig"].shape[1]


@pytest.mark.parametrize("name", ["edge", "inpaint"])
def test_generator_matches_jax(reference_pair, name):
    _, params, (edge, inp) = reference_pair
    net, jnet, cin = (edge, JEdgeGenerator(), 3) if name == "edge" else (
        inp, JInpaintGenerator(), 4)
    x = np.random.RandomState(11).rand(1, 64, 64, cin).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jnet.apply(params[name], jnp.asarray(x)))
    assert got.shape == want.shape == (1, 64, 64, 1 if name == "edge" else 3)
    assert np.abs(got - want).max() < GEN_TOL


def test_no_inpaint_branch_conv_takes_the_small_cin_kernel():
    """No conv of EdgeConnect's generators or of the full-width Mask R-CNN passes
    ``small_cin_gate`` (the JAX gate, layers.py:274-290, is false for all of them)."""
    nets = [*edgeconnect.build_generators(device="meta"), MaskRCNN.build(device="meta")]
    n = 0
    for net in nets:
        for m in net.modules():
            if isinstance(m, layers.Conv2d):
                cin, k = m.weight.shape[1], m.weight.shape[-1]
                for dtype in (torch.float32, torch.bfloat16):
                    assert not (m.dilation == 1 and layers.small_cin_gate(
                        cin, k, m.stride, dtype)), (type(net).__name__, tuple(m.weight.shape))
                n += 1
    assert n > 2 * 21 + 60  # every conv of the three networks was seen


def _jax_inputs(frame, bbox, mask, sigma):
    """The JAX erase's intermediates (inpaint.py:68-84)."""
    h, w = frame.shape[:2]
    win = jinpaint.context_window(jnp.asarray(bbox), (h, w))
    mask_d = jmo.dilate(jnp.asarray(mask), jinpaint._DILATE_SE)
    white = jnp.where(mask_d[..., None], 1.0, jnp.asarray(frame))
    img = jcr.crop_resize(white, win, 256)
    mask_c = jinpaint._mask_crop_nearest(mask_d, win, 256)
    gray = jcs.rgb_to_gray(img)
    edge = jcn.canny(gray[..., 0], sigma=sigma, mask=jnp.logical_not(mask_c))
    return win, np.asarray(img), np.asarray(mask_c), np.asarray(edge)


def test_erase_vehicle_matches_jax(reference_pair):
    _, params, (edge, inp) = reference_pair
    rng = np.random.RandomState(17)
    yy, xx = np.mgrid[:120, :160].astype(np.float32)
    frame = np.stack([xx / 160, yy / 120, 0.5 + 0.3 * np.sin(xx / 7)], -1)
    frame = (frame + 0.05 * rng.rand(120, 160, 3)).astype(np.float32)
    frame[52:78, 62:98] = [0.8, 0.2, 0.2]
    mask = np.zeros((120, 160), bool)
    mask[50:80, 60:100] = True
    # 41 x 31: 0.3 * side is no integer, so the JAX package's jitted window (which
    # contracts bw * 1.3 - bw into an FMA) is the reference's here; see
    # test_context_window_is_the_references for the sides where it is not.
    bbox = np.float32([60.0, 50.0, 101.0, 81.0])
    sigma = 2.0

    want = np.asarray(jinpaint.erase_vehicle(params["edge"], params["inpaint"],
                                             jnp.asarray(frame), jnp.asarray(bbox),
                                             jnp.asarray(mask), sigma=sigma))
    win_j, img_j, mask_j, edge_j = _jax_inputs(frame, bbox, mask, sigma)
    frame_t = torch.from_numpy(frame)[None]
    ins = inpaint.erase_inputs(frame_t, torch.from_numpy(bbox), torch.from_numpy(mask)[None],
                               sigma)
    assert [float(f) for f in ins.window] == [float(f) for f in win_j]
    np.testing.assert_array_equal(ins.mask[0].numpy(), mask_j)
    np.testing.assert_allclose(ins.img[0].numpy(), img_j, rtol=0, atol=1e-5)
    assert (ins.edge[0].numpy() != edge_j).mean() < CANNY_BUDGET
    assert edge_j.any()

    # The generators on the same edge map: within the generators' tolerance.
    same_edges = ins._replace(edge=torch.from_numpy(edge_j.copy())[None])
    got = inpaint.erase_from_inputs(edge, inp, frame_t, same_edges)[0].numpy()
    assert np.abs(got - want).max() < GEN_TOL
    x0, y0 = int(win_j.x_start), int(win_j.y_start)
    x1, y1 = x0 + int(win_j.w), y0 + int(win_j.h)
    outside = np.ones((120, 160), bool)
    outside[y0:y1, x0:x1] = False
    np.testing.assert_array_equal(got[outside], frame[outside])
    assert np.abs(got[60:70, 70:90] - frame[60:70, 70:90]).mean() > 1e-3  # erased
    # The port's own path (its own edge map) on a single frame.
    direct = inpaint.erase_vehicle(edge, inp, torch.from_numpy(frame), torch.from_numpy(bbox),
                                   torch.from_numpy(mask), sigma=sigma).numpy()
    if np.array_equal(ins.edge[0].numpy(), edge_j):
        np.testing.assert_array_equal(direct, got)
    np.testing.assert_array_equal(direct[outside], frame[outside])


def test_context_window_is_the_references():
    """The 1.3x context box of the reference's BoundingBox (float64 Python), which the
    JAX function gives when it runs eagerly (tests/test_inpaint_detector.py:30), on
    sides where 0.3 * side is an integer (40, 30, 60) and where it is not."""
    from future_urban_scene_generation_tpu.utils.bbox import BoundingBox

    for x, y, bw, bh in ((60, 100, 60, 40), (60, 50, 40, 30), (10.7, 3.2, 41.5, 31.9),
                         (300, 200, 25, 25), (0, 0, 0, 0)):
        win = inpaint.context_window(torch.tensor([x, y, x + bw, y + bh]), (240, 320))
        ref = BoundingBox(x, y, bw, bh, bounds=(0, 319, 0, 239), scale=1.3).xyxy
        got = [float(win.x_start), float(win.y_start), float(win.x_start + win.w),
               float(win.y_start + win.h)]
        assert got == [float(v) for v in ref], (x, y, bw, bh)
        assert win.w.dtype == torch.float32
        jwin = jinpaint.context_window(jnp.asarray([x, y, x + bw, y + bh], jnp.float32),
                                       (240, 320))
        assert got[:2] == [float(jwin.x_start), float(jwin.y_start)]


def test_erase_vehicles_is_sequential_and_batched():
    """Two overlapping vehicles: the second erase reads the first one's output (as
    the reference accumulates into one frame); the erase over a batch of frames equals
    the erase of each frame alone; a padding row (bbox 0) changes nothing. One
    residual block keeps this CPU test short: the ordering is the point."""
    edge, inp = edgeconnect.build_generators(torch.Generator().manual_seed(4), device="cpu",
                                             residual_blocks=1)
    rng = np.random.RandomState(5)
    frames = torch.from_numpy(rng.rand(2, 96, 128, 3).astype(np.float32))
    bboxes = np.float32([[30, 30, 80, 70], [60, 40, 110, 80], [0, 0, 0, 0]])
    masks = torch.zeros(2, 3, 96, 128, dtype=torch.bool)
    masks[:, 0, 35:65, 35:75] = True
    masks[:, 1, 45:75, 65:105] = True
    out = inpaint.erase_vehicles(edge, inp, frames, bboxes, masks, sigma=2.0)
    first = inpaint.erase_vehicle(edge, inp, frames, torch.from_numpy(bboxes[0]), masks[:, 0])
    second = inpaint.erase_vehicle(edge, inp, first, torch.from_numpy(bboxes[1]), masks[:, 1])
    np.testing.assert_array_equal(out.numpy(), second.numpy())
    alone = inpaint.erase_vehicle(edge, inp, frames, torch.from_numpy(bboxes[1]), masks[:, 1])
    assert not torch.equal(second, alone)  # the order matters where the windows overlap
    one = inpaint.erase_vehicles(edge, inp, frames[1], bboxes, masks[1])
    np.testing.assert_allclose(one.numpy(), out[1].numpy(), rtol=0, atol=1e-5)
    assert inpaint.window_is_empty(bboxes[2], (96, 128))
    assert not inpaint.window_is_empty(bboxes[0], (96, 128))


def test_zoo_files_load_into_the_generators(reference_pair, tmp_path):
    """``inpainting/EdgeModel_gen.pth`` (spectral-norm triples) and
    ``InpaintingModel_gen.pth``, both wrapped as {"iteration", "generator"} as the
    reference saves them, load strictly through the zoo, as the JAX zoo reads them."""
    from future_urban_scene_generation_tpu.pipeline import checkpoint as jcheckpoint

    sds, params, ours = reference_pair
    for name, sd in sds.items():
        path = checkpoint.zoo_path(tmp_path, name)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"iteration": 7, "generator": sd}, path)
    zoo_j = jcheckpoint.load_reference_model_zoo(tmp_path, cache=False)
    assert zoo_j["edge_iteration"] == zoo_j["inpaint_iteration"] == 7
    for name, net in zip(("edge", "inpaint"), ours):
        got = checkpoint.zoo_state_dict(tmp_path, name)
        assert got.keys() == net.state_dict().keys()
        for k, v in net.state_dict().items():
            assert torch.equal(got[k], v), k
        # the same weights as the JAX zoo's (HWIO kernels there)
        k = "encoder.1.weight"
        np.testing.assert_array_equal(
            got[k].permute(2, 3, 1, 0).numpy(),
            np.asarray(zoo_j[name]["params"]["encoder_1"]["kernel"]))
    assert checkpoint.zoo_state_dict(tmp_path, "maskrcnn") is None
