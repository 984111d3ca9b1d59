"""The PyTorch port's detect -> track -> predict front-end (``pipeline/tracking.py``)
against the JAX package's on the same inputs: the cases of tests/test_tracking.py
:23-142. The tracker and the predictor are host numpy in both packages, so boxes,
ids, confirmations and predicted meters are compared exactly (meters: 1e-9, float64
arithmetic cast to float32); the detector's grid is device work and its boxes agree
exactly on these clear-cut frames.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from future_urban_scene_generation_tpu.pipeline import tracking as jtrk
from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk
import torch_threads  # noqa: F401


def _frame_with_boxes(h, w, boxes, value=1.0):
    f = np.zeros((h, w, 3), np.float32)
    for x0, y0, x1, y1 in boxes:
        f[int(y0):int(y1), int(x0):int(x1)] = value
    return f


def test_connected_components_boxes():
    grid = np.zeros((12, 16), bool)
    grid[2:5, 3:7] = True  # component A: 12 cells
    grid[8:11, 10:14] = True  # component B: 12 cells
    grid[0, 15] = True  # 1-cell noise
    out = trk._connected_component_boxes(grid, min_cells=4)
    assert sorted(out) == sorted(jtrk._connected_component_boxes(grid, min_cells=4))
    assert sorted((x0, y0, x1, y1) for x0, y0, x1, y1, _ in out) == [
        (3, 2, 6, 4), (10, 8, 13, 10)]
    diag = np.zeros((6, 6), bool)
    diag[1, 1] = diag[2, 2] = True  # touch only diagonally: 8-connectivity joins them
    assert len(trk._connected_component_boxes(diag, min_cells=2)) == 1
    rng = np.random.RandomState(0)
    noise = rng.rand(30, 40) > 0.6
    assert sorted(trk._connected_component_boxes(noise, 3)) == sorted(
        jtrk._connected_component_boxes(noise, 3))


@pytest.mark.parametrize("hw,scale", [((160, 240), 8), ((150, 235), 8), ((96, 128), 4)])
def test_background_diff_detector_matches_jax(hw, scale):
    h, w = hw
    bg = np.zeros((h, w, 3), np.float32) + 0.05
    gt = np.asarray([[40, 60, 90, 100], [150, 30, 200, 70]], np.float32) * (h / 160.0)
    frame = bg + _frame_with_boxes(h, w, gt, value=0.9)
    frame[5, 7] = 1.0  # a single noisy pixel: blurred away
    det = trk.BackgroundDiffDetector(torch.as_tensor(bg), scale=scale, min_area_px=100)
    jdet = jtrk.BackgroundDiffDetector(jnp.asarray(bg), scale=scale, min_area_px=100)
    handle = det.dispatch(torch.as_tensor(frame))
    assert handle.dtype == torch.bool and handle.shape == (h // scale, w // scale)
    np.testing.assert_array_equal(handle.numpy(), np.asarray(jdet.dispatch(jnp.asarray(frame))))
    boxes, scores = det.finalize(handle)
    jboxes, jscores = jdet(jnp.asarray(frame))
    assert boxes.shape == (2, 4) and boxes.dtype == np.float32
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(scores, jscores)
    assert (trk.iou_xyxy(boxes, gt).max(axis=1) > 0.5).all()
    b2, _ = det(torch.as_tensor(frame))
    np.testing.assert_array_equal(b2, boxes)
    none, _ = det(torch.as_tensor(bg))
    assert none.shape == (0, 4)


def test_iou_matches_jax_package():
    rng = np.random.RandomState(1)
    a = np.sort(rng.rand(5, 2, 2) * 100, axis=1).reshape(5, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    b = np.sort(rng.rand(7, 2, 2) * 100, axis=1).reshape(7, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    np.testing.assert_array_equal(trk.iou_xyxy(a, b), jtrk.iou_xyxy(a, b))


def _same_tracks(ours, theirs):
    assert [t.track_id for t in ours] == [t.track_id for t in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.bbox, b.bbox)
        np.testing.assert_array_equal(a.velocity, b.velocity)
        assert (a.hits, a.misses) == (b.hits, b.misses)
        np.testing.assert_array_equal(np.asarray(a.history), np.asarray(b.history))
        np.testing.assert_array_equal(a.predicted_bbox(), b.predicted_bbox())


def test_iou_tracker_stable_ids_and_confirmation():
    tracker, jtracker = (m.IouTracker(min_hits=3, max_misses=2) for m in (trk, jtrk))
    ids_seen = []
    for t in range(6):
        boxes = np.asarray(
            [[10 + 5 * t, 20, 50 + 5 * t, 60], [200, 100 + 4 * t, 260, 160 + 4 * t]], np.float32)
        confirmed = tracker.update(boxes)
        _same_tracks(confirmed, jtracker.update(boxes))
        _same_tracks(tracker.tracks, jtracker.tracks)
        if t < 2:
            assert confirmed == []
        else:
            assert len(confirmed) == 2
            ids_seen.append(tuple(sorted(c.track_id for c in confirmed)))
    assert len(set(ids_seen)) == 1  # ids are stable across the whole sequence
    assert all(len(c.history) == 6 for c in tracker.confirmed())


def test_iou_tracker_coasts_and_dies():
    tracker, jtracker = (m.IouTracker(min_hits=2, max_misses=2) for m in (trk, jtrk))
    box = np.asarray([[10, 10, 50, 50]], np.float32)
    empty = np.zeros((0, 4), np.float32)
    for boxes in (box, box + 4, empty, empty, empty):
        out = tracker.update(boxes)
        _same_tracks(out, jtracker.update(boxes))
        _same_tracks(tracker.tracks, jtracker.tracks)
    assert tracker.tracks == []


def test_iou_tracker_velocity_assists_matching():
    tracker, jtracker = (m.IouTracker(min_hits=2, max_misses=1, min_iou=0.3) for m in (trk, jtrk))
    # By the end the box shifts 30 px/frame on a 40 px box: raw IoU 10/70 = 0.14 <
    # min_iou, so only the learned velocity prediction keeps the association alive.
    x = 100.0
    for speed in (5, 10, 15, 20, 25, 30, 30):
        x += speed
        boxes = np.asarray([[x, 50, x + 40, 90]], np.float32)
        tracker.update(boxes)
        jtracker.update(boxes)
    assert len(tracker.tracks) == 1 and tracker.tracks[0].hits == 7
    _same_tracks(tracker.tracks, jtracker.tracks)


def test_predict_future_meters_matches_jax_package():
    history = [np.asarray([10.0 + 3 * i, 5.0 + 1 * i]) for i in range(8)]
    out = trk.predict_future_meters(history, None, n_points=4, stride=2)
    assert out.shape == (4, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out[0], [31.0, 12.0], atol=1e-5)
    np.testing.assert_allclose(out[1], [37.0, 14.0], atol=1e-5)  # 2 frames * (3, 1)
    np.testing.assert_allclose(out[3], [49.0, 18.0], atol=1e-5)
    np.testing.assert_array_equal(out, jtrk.predict_future_meters(history, None, 4, stride=2))
    assert trk.predict_future_meters([np.zeros(2)], None, 3) is None

    # Through a homography: pixel -> GPS -> meters in float64 on the host.
    hist = [np.asarray([100.0 + 5 * i, 200.0 + 2 * i]) for i in range(25)]
    h = np.linalg.inv(np.array([[1e-5, 0, 45.0], [0, 1e-5, 11.0], [0, 0, 1.0]]))
    got = trk.predict_future_meters(hist, h, n_points=5, stride=2)
    ref = jtrk.predict_future_meters(hist, h, n_points=5, stride=2)
    assert got.shape == (5, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    assert (np.linalg.norm(np.diff(got, axis=0), axis=1) > 0).all()


class _FakeEvent:
    """Stands in for torch.cuda.Event on the CPU: counts what is asked of it."""

    made = []

    def __init__(self):
        self.recorded = 0
        self.waited = 0
        _FakeEvent.made.append(self)

    def record(self):
        self.recorded += 1

    def synchronize(self):
        self.waited += 1


def test_finalize_waits_on_its_own_event_only(monkeypatch):
    """On a CUDA frame ``dispatch`` stages the grid into host memory behind an event
    (``_stage``; driven here on a CPU grid with a fake event), and ``finalize`` waits
    on that handle's event and on nothing else: no device-wide sync, no ``.cpu()``
    copy enqueued behind later work, no wait on another detection's event."""
    h, w, s = 96, 128, 4
    bg = np.zeros((h, w, 3), np.float32) + 0.05
    frame = bg + _frame_with_boxes(h, w, [[20, 30, 60, 70]], value=0.9)
    det = trk.BackgroundDiffDetector(torch.as_tensor(bg), scale=s, min_area_px=100)
    grid = det.dispatch(torch.as_tensor(frame))
    assert isinstance(grid, torch.Tensor)  # CPU handles are the grid, as before

    _FakeEvent.made.clear()
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)

    def no_device_sync(*a, **k):
        raise AssertionError("finalize drained the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    monkeypatch.setattr(torch.Tensor, "cpu", no_device_sync)
    first = det._stage(grid)
    second = det._stage(torch.zeros_like(grid))
    assert isinstance(first, trk.PendingGrid) and first.event is not second.event
    assert [e.recorded for e in _FakeEvent.made] == [1, 1]
    boxes, scores = det.finalize(first)
    assert (first.event.waited, second.event.waited) == (1, 0)
    monkeypatch.undo()
    ref_boxes, ref_scores = det.finalize(grid)
    np.testing.assert_array_equal(boxes, ref_boxes)
    np.testing.assert_array_equal(scores, ref_scores)
    assert len(boxes) == 1

    # Two host buffers alternate: the third detection reuses the first one's.
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    third = det._stage(grid)
    assert third.host.data_ptr() == first.host.data_ptr() != second.host.data_ptr()
    assert len(det.finalize(second)[0]) == 0
