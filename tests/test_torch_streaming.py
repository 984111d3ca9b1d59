"""The PyTorch port's stream runners (``pipeline/streaming.py``) on the CPU.

The scene itself is held to the JAX package in test_torch_pipeline.py; here the
runner's bookkeeping is held to direct ``run_scene`` calls (exact: the same code on
the same tensors), its upload to tests/test_streaming.py:55, and its gate to the
release-on-failure rule. On the CPU nothing is asynchronous, so depth only changes
when a result is handed back.
"""
import threading

import numpy as np
import pytest
import torch

from future_urban_scene_generation_tpu_torch.pipeline import runner, stages, streaming
from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import mesh as mu

H, W = 120, 160
K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]], dtype=np.float32)
SPEC = ModelSpec(warp_plane_res=96)


@pytest.fixture(scope="module")
def assets():
    mesh, kp3d = mu.make_test_car(subdiv=1)
    bank = runner.build_cad_bank([mesh], [kp3d], scale=5.0, device="cpu")
    models = stages.Models.build(SPEC, torch.Generator().manual_seed(0), device="cpu")
    return models, bank


def _stream(assets, cls=streaming.StreamRunner, **kw):
    models, bank = assets
    kw = {"n_vehicles": 1, "n_steps": 2, "depth": 2, **kw}
    return cls(models, bank, K, (H, W), spec=SPEC, **kw)


def test_stream_runner_returns_direct_results_in_order(assets):
    models, bank = assets
    stream = _stream(assets)
    rng = np.random.RandomState(0)
    frames = rng.rand(3, H, W, 3).astype(np.float32)
    bboxes = [[50.0, 40.0, 90.0, 70.0]]
    meters = np.stack([np.stack([np.linspace(0, 2, 2), np.zeros(2)], -1)])

    results, handed_back = [], []
    for f in frames:
        out = stream.submit(f, bboxes, meters)
        handed_back.append(out is not None)
        if out is not None:
            results.append(out)
    assert handed_back == [False, True, True]  # depth 2: one scene stays in flight
    results.extend(stream.flush())
    assert len(results) == 3 and len(stream.latencies) == 3
    assert stream.throughput_fps > 0.0
    for f, got in zip(frames, results):
        ft = torch.as_tensor(f)
        ref = runner.run_scene(models, bank, ft, ft, torch.as_tensor(np.float32(bboxes)),
                               torch.as_tensor(np.float32(meters)), torch.as_tensor(K),
                               spec=SPEC)
        assert got.frames_icn.shape == (2, H, W, 3)
        assert bool(torch.isfinite(got.frames_icn).all())
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_pad_truncates_and_pads(assets):
    stream = _stream(assets, n_vehicles=3, n_steps=4)
    b, m = stream._pad(np.ones((5, 4)), np.ones((5, 6, 2)))
    assert b.shape == (3, 4) and m.shape == (3, 4, 2) and b.all() and m.all()
    b, m = stream._pad(np.ones((1, 4)), np.ones((1, 4, 2)))
    assert b[0].all() and not b[1:].any() and not m[1:].any()


def test_uint8_upload_matches_float():
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (32, 48, 3), np.uint8)
    a = streaming.StreamRunner._upload(u8, "cpu")
    b = streaming.StreamRunner._upload(u8.astype(np.float32) / 255.0, "cpu")
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    c = streaming.StreamRunner._upload(u8.astype(np.float64) / 255.0, "cpu")
    assert c.dtype == torch.float32


class _CountingGate:
    """A semaphore that records its permits in use."""

    def __init__(self, permits):
        self._sem = threading.BoundedSemaphore(permits)
        self.in_use = 0
        self.peak = 0

    def acquire(self):
        assert self._sem.acquire(timeout=30), "gate starved"
        self.in_use += 1
        self.peak = max(self.peak, self.in_use)

    def release(self):
        self.in_use -= 1
        self._sem.release()  # BoundedSemaphore raises on a release too many


def test_gate_permits_released_after_flush_and_after_failed_dispatch(assets, monkeypatch):
    gate = _CountingGate(2)
    stream = _stream(assets, inflight_gate=gate)
    rng = np.random.RandomState(2)
    bboxes = [[50.0, 40.0, 90.0, 70.0]]
    meters = np.zeros((1, 2, 2), np.float32)
    outs = [stream.submit(rng.rand(H, W, 3).astype(np.float32), bboxes, meters)
            for _ in range(3)]
    # Gated: a full pipeline drains BEFORE it dispatches, so 2 permits suffice.
    assert [o is not None for o in outs] == [False, False, True]
    assert gate.in_use == 2 and gate.peak == 2
    assert len(stream.flush()) == 2
    assert gate.in_use == 0

    def boom(*a, **k):
        raise RuntimeError("dispatch failed")

    monkeypatch.setattr(streaming._runner, "run_scene", boom)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        stream.submit(rng.rand(H, W, 3).astype(np.float32), bboxes, meters)
    assert gate.in_use == 0 and not stream._inflight  # the permit came back
    assert stream.flush() == []


def test_tracking_stream_runner_moving_box(assets):
    bg = np.zeros((H, W, 3), np.float32) + 0.1
    detector = trk.BackgroundDiffDetector(torch.as_tensor(bg), scale=4, min_area_px=100)
    stream = _stream(assets, cls=streaming.TrackingStreamRunner, depth=1, detector=detector,
                     inv_homography=None, min_track_frames=2)
    results, ids, first = [], set(), None
    n_frames = 6
    for t in range(n_frames):
        x0 = 30 + 6 * t
        frame = bg.copy()
        frame[60:85, x0:x0 + 35] = 0.9
        out, tracks = stream.submit_frame(frame)
        if t == 0:
            first = (out, tracks)
        ids.update(tr.track_id for tr in tracks)
        if out is not None:
            results.append(out)
    assert first == (None, [])  # overlapped detection: nothing to finalize yet
    assert len(ids) == 1  # one stable track
    track = stream.tracker.tracks[0]
    assert len(track.history) == n_frames - 1  # the last detection is still pending
    results.extend(stream.flush())
    assert len(track.history) == n_frames  # flush folded it in
    assert stream._pending_detect is None
    assert len(results) >= 3
    for r in results:
        assert r.frames_icn.shape == (2, H, W, 3)
        assert bool(torch.isfinite(r.frames_icn).all())

    # Frame-aligned mode: the first call already detects.
    aligned = _stream(assets, cls=streaming.TrackingStreamRunner, depth=1, detector=detector,
                      min_track_frames=1, overlap_detect=False)
    frame = bg.copy()
    frame[60:85, 30:65] = 0.9
    out, tracks = aligned.submit_frame(frame)
    assert len(tracks) == 1 and out is None  # one point of history: no trajectory yet
