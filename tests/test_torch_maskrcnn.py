"""Mask R-CNN in the PyTorch port against the JAX package's models/maskrcnn.py, on the
CPU at a small width: layers (1, 1, 1, 1), width 8, 16 FPN channels, representation
32, 5 classes, 128x128 images (tests/test_maskrcnn.py's reduced configuration, built
there as a torch mirror under torchvision's key names).

Tensors of the backbone, RPN and heads are held to tests/test_maskrcnn.py's 2e-4;
the anchor and box-coding math to float32 rounding; ``maskrcnn_infer``'s detections
(valid flags and labels exactly, boxes, scores and masks to 1e-4) at
pre_nms_top_n=50, post_nms_top_n=20, detections_per_img=8; the segmenter's masks and
the detector's boxes through ``TrackingStreamRunner``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from future_urban_scene_generation_tpu.models import maskrcnn as jmr
from future_urban_scene_generation_tpu.models.detector import (
    MaskRCNNSegmenter as JMaskRCNNSegmenter,
)
from future_urban_scene_generation_tpu_torch.models import maskrcnn as mr
from future_urban_scene_generation_tpu_torch.models.detector import MaskRCNNSegmenter
from future_urban_scene_generation_tpu_torch.pipeline import checkpoint
from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk
from test_maskrcnn import TMaskRCNN

SMALL = dict(num_classes=5, layers=(1, 1, 1, 1), width=8, out_channels=16,
             representation_size=32)
TOL = 2e-4  # tests/test_maskrcnn.py:210
INFER = dict(pre_nms_top_n=50, post_nms_top_n=20, detections_per_img=8)


def _newer_keys(sd):
    """Half of the FPN convs, the RPN head's conv and the mask head under newer
    torchvision's Conv2dNormActivation / Sequential names."""
    out = {}
    for k, v in sd.items():
        for i in (0, 2):
            for blk in ("inner_blocks", "layer_blocks"):
                k = k.replace(f"fpn.{blk}.{i}.", f"fpn.{blk}.{i}.0.")
        k = k.replace("rpn.head.conv.", "rpn.head.conv.0.0.")
        for i in (1, 3):
            k = k.replace(f"mask_head.mask_fcn{i}.", f"mask_head.{i - 1}.0.")
        out[k] = v
    return out


@pytest.fixture(scope="module")
def nets():
    """The torchvision-named mirror with seeded values (batch-norm variances
    positive), the port's network loaded from it through ``convert_maskrcnn`` (newer
    key forms included) and the JAX package's conversion of it."""
    rng = np.random.RandomState(7)
    tmodel = TMaskRCNN().eval()
    sd = {}
    for k, v in tmodel.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        x = rng.randn(*v.shape).astype(np.float32)
        if k.endswith("running_var"):
            x = rng.rand(*v.shape).astype(np.float32) * 0.5 + 0.5
        elif v.dim() > 1:
            x = x / np.sqrt(v[0].numel())
        else:
            x = x * 0.1
        sd[k] = torch.from_numpy(x.astype(np.float32))
    newer = _newer_keys(sd)
    assert "backbone.fpn.inner_blocks.0.0.weight" in newer
    assert "roi_heads.mask_head.0.0.weight" in newer
    model = mr.MaskRCNN.build(device="cpu", **SMALL)
    model.load_state_dict(mr.convert_maskrcnn(newer), strict=True)
    params = jmr.convert_maskrcnn({k: v.numpy() for k, v in sd.items()})
    return model, jmr.MaskRCNN(**SMALL), params, sd


def test_backbone_rpn_and_heads_match_jax(nets):
    model, jmodel, params, _ = nets
    x = np.random.RandomState(8).rand(1, 128, 128, 3).astype(np.float32)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(x))
        logits, deltas = model.rpn_head(feats)
    jfeats = jmodel.apply(params, jnp.asarray(x), method=jmr.MaskRCNN.features)
    jlogits, jdeltas = jmodel.apply(params, jfeats, method=jmr.MaskRCNN.rpn_head)
    assert len(feats) == len(jfeats) == 5
    for got, want in zip([*feats, *logits, *deltas], [*jfeats, *jlogits, *jdeltas]):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL

    rng = np.random.RandomState(9)
    pooled = rng.rand(6, 7, 7, 16).astype(np.float32)
    mpooled = rng.rand(4, 14, 14, 16).astype(np.float32)
    with torch.no_grad():
        scores, boxes = model.box_heads(torch.from_numpy(pooled))
        masks = model.mask_heads(torch.from_numpy(mpooled))
    jscores, jboxes = jmodel.apply(params, jnp.asarray(pooled), method=jmr.MaskRCNN.box_heads)
    jmasks = jmodel.apply(params, jnp.asarray(mpooled), method=jmr.MaskRCNN.mask_heads)
    for got, want in ((scores, jscores), (boxes, jboxes), (masks, jmasks)):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL


def test_anchor_and_box_math_matches_jax():
    for size in mr.ANCHOR_SIZES:
        np.testing.assert_array_equal(mr.cell_anchors(size).numpy(),
                                      np.asarray(jmr.cell_anchors(size)))
    np.testing.assert_array_equal(mr.grid_anchors(3, 5, 16, 64.0).numpy(),
                                  np.asarray(jmr.grid_anchors(3, 5, 16, 64.0)))
    rng = np.random.RandomState(10)
    anchors = np.abs(rng.randn(50, 4).astype(np.float32)) * 40
    anchors[:, 2:] += anchors[:, :2] + 1
    deltas = rng.randn(50, 4).astype(np.float32)
    deltas[0, 2] = 50.0  # the dw clamp
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        got = mr.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors), weights)
        want = jmr.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), weights)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(mr.clip_boxes(got, 100, 120).numpy(),
                                      np.asarray(jmr.clip_boxes(jnp.asarray(got.numpy()),
                                                                100, 120)))
    np.testing.assert_array_equal(mr.fpn_level(torch.from_numpy(anchors * 5)).numpy(),
                                  np.asarray(jmr.fpn_level(jnp.asarray(anchors * 5))))


@pytest.fixture(scope="module")
def detections(nets):
    model, jmodel, params, _ = nets
    img = np.random.RandomState(11).rand(128, 128, 3).astype(np.float32)
    got = mr.maskrcnn_infer(model, torch.from_numpy(img), **INFER)
    want = jmr.maskrcnn_infer(params, jnp.asarray(img), model=jmodel, **INFER)
    return got, want


def test_maskrcnn_infer_matches_jax(detections):
    got, want = detections
    assert got.boxes.shape == (8, 4) and got.masks.shape == (8, 28, 28)
    assert bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    for field in ("boxes", "scores", "masks"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-4, err_msg=field)


def test_segmenter_matches_jax_and_one_pass_serves_every_box(nets):
    model, jmodel, params, _ = nets
    frame = np.random.RandomState(12).rand(96, 160, 3).astype(np.float32)
    boxes = np.float32([[0, 0, 160, 96], [10, 5, 90, 70], [60, 30, 150, 90]])
    kw = dict(classes=(1, 2, 3, 4), min_iou=0.1, input_hw=(128, 128), mask_threshold=0.5)
    seg = MaskRCNNSegmenter(model, device="cpu", **kw)
    jseg = JMaskRCNNSegmenter(params, model=jmodel, **kw)
    frame_t = torch.from_numpy(frame)
    all_at_once = seg.masks_for_bboxes(frame_t, torch.from_numpy(boxes))
    assert all_at_once.shape == (3, 96, 160) and all_at_once.dtype == torch.bool
    assert bool(all_at_once.any())
    want = np.asarray(jseg.masks_for_bboxes(jnp.asarray(frame), jnp.asarray(boxes)))
    assert (all_at_once.numpy() != want).mean() < 1e-3
    for v, box in enumerate(boxes):
        np.testing.assert_array_equal(seg(frame_t, torch.from_numpy(box)).numpy(),
                                      all_at_once[v].numpy())
    none = MaskRCNNSegmenter(model, classes=(1,), min_iou=1.1, input_hw=(128, 128),
                             device="cpu")
    assert not bool(none(frame_t, torch.from_numpy(boxes[0])).any())


def test_first_argmax_takes_the_first_of_ties():
    from future_urban_scene_generation_tpu_torch.models.detector import first_argmax

    x = torch.tensor([[1.0, -1.0], [3.0, -1.0], [3.0, -1.0]])
    assert first_argmax(x, 0).tolist() == [1, 0]


def test_maskrcnn_zoo_file_and_sidecar(nets, tmp_path):
    """``maskrcnn/maskrcnn.pth`` as {"model": state dict} with newer key names loads
    through the zoo; ``--segmenter maskrcnn``'s sidecar is read without PyYAML."""
    model, _, _, sd = nets
    path = checkpoint.zoo_path(tmp_path, "maskrcnn")
    path.parent.mkdir(parents=True)
    torch.save({"model": _newer_keys(sd)}, path)
    loaded = checkpoint.zoo_state_dict(tmp_path, "maskrcnn")
    assert loaded.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(loaded[k], v), k


class _FakeEvent:
    def __init__(self):
        self.waited = 0

    def record(self):
        pass

    def synchronize(self):
        self.waited += 1


def test_detector_matches_infer_and_drives_the_tracking_runner(nets, monkeypatch):
    """``MaskRCNNDetector``: the finalized boxes are ``maskrcnn_infer``'s kept ones
    scaled to the frame, the staged (pinned, event) handle reads the same values as the
    CPU handle, and ``TrackingStreamRunner`` runs on it."""
    from future_urban_scene_generation_tpu_torch.ops.resize import resize_bilinear
    from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, streaming
    from future_urban_scene_generation_tpu_torch.spec import ModelSpec
    from future_urban_scene_generation_tpu_torch.utils import mesh as mu

    model = nets[0]
    h, w = 96, 128
    detector = trk.MaskRCNNDetector(model, classes=(1, 2, 3, 4), score_threshold=0.2,
                                    input_hw=(128, 128), device="cpu")
    rng = np.random.RandomState(13)
    frame = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32))
    boxes, scores = detector(frame)
    det = mr.maskrcnn_infer(model, resize_bilinear(frame, (128, 128)))
    keep = det.valid & (det.scores >= 0.2) & (det.labels >= 1) & (det.labels <= 4)
    want = det.boxes[keep] * torch.tensor([w / 128, h / 128, w / 128, h / 128])
    assert len(boxes) == int(keep.sum()) > 0
    np.testing.assert_allclose(boxes, want.numpy(), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(scores, det.scores[keep].numpy())

    packed = detector.dispatch(frame)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    handle = detector._slots.stage(packed)
    staged = detector.finalize(handle)
    assert handle.event.waited == 1
    monkeypatch.undo()
    np.testing.assert_array_equal(staged[0], boxes)

    spec = ModelSpec(warp_plane_res=96)
    mesh, kp3d = mu.make_test_car(subdiv=1)
    bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device="cpu")
    models = stages.Models.build(spec, torch.Generator().manual_seed(0), device="cpu")
    k = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]], np.float32)
    stream = streaming.TrackingStreamRunner(models, bank, k, (h, w), 1, n_steps=2, depth=1,
                                            spec=spec, detector=detector, min_track_frames=1)
    seen = 0
    for t in range(3):
        out, tracks = stream.submit_frame(rng.rand(h, w, 3).astype(np.float32))
        seen += len(tracks)
        if out is not None:
            assert bool(torch.isfinite(out.frames_icn).all())
    stream.flush()
    assert seen > 0 and len(stream.tracker.tracks) > 0
