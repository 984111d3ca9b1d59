"""Detection primitives of the PyTorch port (pairwise IoU, greedy NMS, RoIAlign)
against the JAX package's ops/detection.py on the CPU, where ``nms_static`` runs
its plain version (kernel N1's reference; chip_smoke.py holds N1 against it on the
card).

NMS indices are exact, ties included: both order by a stable descending sort. IoU is
the same float32 arithmetic (1e-6); RoIAlign averages its samples in another order
(1e-5, tests/test_detection.py's bar). The presorted, segmented entry
(``nms_sorted_segments``, which Mask R-CNN calls without a second sort) is held to one
JAX ``nms_static`` call a segment, which sorts: on the RPN's scores (sigmoid of
stable-sorted logits, ties among them, -1 for tiny boxes wherever they fall) the kept
indices are the same.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from future_urban_scene_generation_tpu.models import maskrcnn as jmr
from future_urban_scene_generation_tpu.ops import detection as jdet
from future_urban_scene_generation_tpu_torch.models import maskrcnn as mr
from future_urban_scene_generation_tpu_torch.ops import detection as det
import torch_threads  # noqa: F401


def _boxes(rng, n, extent=100.0):
    centers = rng.rand(n, 2) * extent
    sizes = rng.rand(n, 2) * 30 + 5
    return np.concatenate([centers - sizes / 2, centers + sizes / 2], 1).astype(np.float32)


def _greedy(boxes, scores, iou_thr, score_thr):
    """tests/test_detection.py's greedy reference, with a stable order."""
    order = np.argsort(-scores, kind="stable")
    iou = np.asarray(jdet.batched_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    kept, suppressed = [], np.zeros(len(boxes), bool)
    for rank, i in enumerate(order):
        if suppressed[i] or scores[i] <= score_thr:
            continue
        kept.append(int(i))
        for j in order[rank + 1:]:
            if iou[i, j] > iou_thr:
                suppressed[j] = True
    return kept


def test_batched_iou_matches_jax():
    rng = np.random.RandomState(60)
    a, b = _boxes(rng, 37), _boxes(rng, 23)
    a[3] = a[4]  # identical boxes
    b[0] = [5, 5, 5, 9]  # zero area
    got = det.batched_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jdet.batched_iou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,iou_thr,score_thr,max_out,ties", [
    (40, 0.4, 0.0, 40, False),
    (200, 0.7, -0.5, 50, True),   # the RPN's thresholds; scores with many ties
    (300, 0.5, 0.2, 8, True),     # the class NMS's cut at a few detections
    (64, 0.5, 0.0, 100, True),    # more outputs than boxes: -1 padding
])
def test_nms_matches_jax_and_greedy(n, iou_thr, score_thr, max_out, ties):
    rng = np.random.RandomState(n)
    boxes = _boxes(rng, n)
    scores = rng.rand(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8  # few distinct values
        scores[rng.rand(n) < 0.2] = -1.0  # the invalid entries of maskrcnn_infer
        boxes[1::7] = boxes[0::7][: len(boxes[1::7])]  # duplicates with tied scores
    idx, valid = det.nms_static(torch.from_numpy(boxes), torch.from_numpy(scores), iou_thr,
                                score_thr, max_out)
    jidx, jvalid = jdet.nms_static(jnp.asarray(boxes), jnp.asarray(scores),
                                   iou_threshold=iou_thr, score_threshold=score_thr,
                                   max_outputs=max_out)
    assert idx.dtype == torch.int64 and idx.shape == (max_out,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    kept = _greedy(boxes, scores, iou_thr, score_thr)[:max_out]
    assert idx[valid].tolist() == kept
    assert (idx[~valid] == -1).all()


def _rpn_scores(rng, n):
    """An RPN level's scores as ``maskrcnn._rpn_proposals`` makes them: the sigmoid of
    logits in stable descending order (repeated logits, and logits past 17 whose
    sigmoid rounds to 1: ties), -1 for the tiny boxes, which fall anywhere."""
    logits = np.float32(np.round(rng.randn(n) * 4, 1))
    logits[rng.rand(n) < 0.1] = 20.0 + rng.rand() * 5
    logits = np.sort(logits, kind="stable")[::-1].copy()
    scores = torch.sigmoid(torch.from_numpy(logits))
    scores[torch.from_numpy(rng.rand(n) < 0.25)] = -1.0
    return scores.numpy()


@pytest.mark.parametrize("lens,iou_thr,score_thr,max_outs", [
    ((300,), 0.7, -0.5, (300,)),               # one RPN level: the -1 claim
    ((150, 0, 1, 64, 65), 0.7, -0.5, (150, 0, 1, 40, 65)),  # levels of unequal length
    ((260,), 0.5, -0.5, (8,)),                 # the class NMS: fewer outputs than kept
])
def test_nms_sorted_segments_match_jax_per_segment(lens, iou_thr, score_thr, max_outs):
    rng = np.random.RandomState(sum(lens))
    boxes = _boxes(rng, sum(lens))
    boxes[1::9] = boxes[0::9][: len(boxes[1::9])]  # duplicates
    scores = np.concatenate([_rpn_scores(rng, n) if n != 1 else np.float32([0.9])
                             for n in lens])
    got = det.nms_sorted_segments(torch.from_numpy(boxes), torch.from_numpy(scores), lens,
                                  iou_thr, score_thr, max_outs)
    assert len(got) == len(lens)
    start = 0
    for n, m, idx in zip(lens, max_outs, got):
        b, sc = boxes[start:start + n], scores[start:start + n]
        start += n
        assert idx.dtype == torch.int64 and idx.shape == (m,)
        if n == 0:
            assert (idx == -1).all()
            continue
        ok = sc > score_thr  # the valid boxes already stand in JAX's sorted order
        assert (np.argsort(-sc, kind="stable")[: ok.sum()] == np.flatnonzero(ok)).all()
        jidx, _ = jdet.nms_static(jnp.asarray(b), jnp.asarray(sc), iou_threshold=iou_thr,
                                  score_threshold=score_thr, max_outputs=m)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert sum(int((i >= 0).sum()) for i in got) > len([n for n in lens if n])


def test_topk_stable_is_lax_top_k():
    import jax

    x = np.float32([0.5, -1, 0.5, 2, -1, -1, 0.5, 2])
    vals, idx = det.topk_stable(torch.from_numpy(x), 6)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_roi_align_matches_jax():
    rng = np.random.RandomState(61)
    feat = rng.rand(40, 52, 5).astype(np.float32)
    rois = np.concatenate([_boxes(rng, 9, 180.0), [[-10, -8, 30, 20], [150, 120, 230, 200]]])
    for out, scale in ((7, 0.25), (14, 0.125), (4, 1.0)):
        got = det.roi_align(torch.from_numpy(feat), torch.from_numpy(rois.astype(np.float32)),
                            output_size=out, spatial_scale=scale).numpy()
        want = np.asarray(jdet.roi_align(jnp.asarray(feat), jnp.asarray(rois, jnp.float32),
                                         output_size=out, spatial_scale=scale))
        assert got.shape == (len(rois), out, out, 5)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_roi_align_on_each_boxs_own_level_matches_jax():
    """The port pools each box at its FPN level only; the JAX ``maskrcnn_infer`` pools
    every box at every level and selects (maskrcnn.py:368-394). Same values, boxes of
    all four levels."""
    rng = np.random.RandomState(62)
    shapes = [(64, 96), (32, 48), (16, 24), (8, 12), (4, 6)]
    feats = [rng.rand(1, h, w, 6).astype(np.float32) for h, w in shapes]
    boxes = np.float32([[10, 10, 40, 50], [0, 0, 120, 110], [30, 20, 300, 250],
                        [5, 5, 380, 250], [100, 60, 104, 66], [200, 100, 260, 190],
                        [0, 0, 470, 460]])
    got = mr.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                  torch.from_numpy(boxes), 7).numpy()
    want = np.asarray(jmr.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                               jnp.asarray(boxes), 7))
    assert sorted(set(mr.fpn_level(torch.from_numpy(boxes)).tolist())) == [0, 1, 2, 3]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
