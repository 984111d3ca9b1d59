"""The PyTorch port's ``MultiStreamRunner`` (``pipeline/streaming.py``) on the CPU:
the case of tests/test_tracking.py:192 (two cameras with separate backgrounds and
trackers over one model set), threaded and not. Every camera must give exactly the
scenes of its own separate ``TrackingStreamRunner`` (the same code on the same
tensors: atol 0); the threaded mode's queue, gate, ``on_result``, error and ``close``
rules and both aggregate rates are held beside it.
"""
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


@pytest.fixture(scope="module", autouse=True)
def few_intra_op_threads():
    """Two Python threads that each fan every op out over all cores oversubscribe
    the machine (OpenMP teams spin against each other); two threads an op suffice
    at these sizes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


N_FRAMES = 3  # a track is confirmed at its second frame: two scenes a camera
BGS = [np.zeros((H, W, 3), np.float32) + 0.1, np.zeros((H, W, 3), np.float32) + 0.2]


def _camera_frame(i, t):
    """Camera 0's vehicle moves right, camera 1's moves down."""
    frame = BGS[i].copy()
    if i == 0:
        x0 = 30 + 6 * t
        frame[60:85, x0:x0 + 35] = 0.9
    else:
        y0 = 20 + 5 * t
        frame[y0:y0 + 25, 60:95] = 0.9
    return frame


def _make_detector(i):
    return trk.BackgroundDiffDetector(torch.as_tensor(BGS[i]), scale=4, min_area_px=100)


def _multi(assets, **kw):
    models, bank = assets
    kw = {"n_vehicles": 1, "n_streams": 2, "make_detector": _make_detector, "n_steps": 2,
          "depth": 1, "min_track_frames": 2, "overlap_detect": False, **kw}
    return streaming.MultiStreamRunner(models, bank, K, (H, W), spec=SPEC, **kw)


@pytest.fixture(scope="module")
def separate_runs(assets):
    """The same two cameras through two separate TrackingStreamRunners."""
    out = []
    for i in range(2):
        s = _stream(assets, cls=streaming.TrackingStreamRunner, n_steps=2, depth=1,
                    detector=_make_detector(i), min_track_frames=2, overlap_detect=False)
        res = []
        for t in range(N_FRAMES):
            r, _ = s.submit_frame(_camera_frame(i, t))
            if r is not None:
                res.append(r)
        res.extend(s.flush())
        out.append(res)
    return out


@pytest.mark.parametrize("threaded", [False, True])
def test_multi_stream_runner_two_cameras(assets, separate_runs, threaded):
    """The case of tests/test_tracking.py:192 (two cameras, separate backgrounds and
    trackers, one model set), threaded and not: per-stream trackers stay isolated
    and every stream gives exactly the scenes of its own separate runner (the same
    code on the same tensors: atol 0)."""
    consumed = [[], []]
    multi = _multi(assets, threaded=threaded,
                   on_result=(lambda i, r: consumed[i].append(r)) if threaded else None)
    results, tracked = [[], []], [0, 0]
    for t in range(N_FRAMES):
        for i in range(2):
            out, tracks = multi.submit_frame(i, _camera_frame(i, t))
            if threaded:
                assert (out, tracks) == (None, [])
            else:
                tracked[i] = max(tracked[i], len(tracks))
            if out is not None:
                results[i].append(out)
    for i, extra in enumerate(multi.flush()):
        assert not (threaded and extra)  # on_result consumed the tail too
        results[i].extend(extra)
    if threaded:
        for i in range(2):
            results[i].extend(consumed[i])
        tracked = [len(s.tracker.confirmed()) for s in multi.streams]
        multi.close()
        multi.close()  # idempotent
        assert not any(w.is_alive() for w in multi._workers)
    assert tracked == [1, 1]
    assert multi.streams[0].tracker is not multi.streams[1].tracker
    for i in range(2):
        assert len(results[i]) == len(separate_runs[i]) == N_FRAMES - 1
        for got, ref in zip(results[i], separate_runs[i]):
            assert got.frames_icn.shape == (2, H, W, 3)
            assert bool(torch.isfinite(got.frames_icn).all())
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # Both aggregates: the strict one divides all frames by one wall clock that
    # contains every stream's window, so it cannot exceed the sum over windows.
    strict, summed = multi.aggregate_fps, multi.aggregate_fps_per_stream_windows
    assert 0.0 < strict <= summed * (1 + 1e-9)
    frames = sum(len(r) for r in results) * 2 * 2
    wall = (max(s._t_last_drain for s in multi.streams)
            - min(s._t_first_submit for s in multi.streams))
    assert strict == pytest.approx(frames / wall)
    assert summed == pytest.approx(sum(s.throughput_fps for s in multi.streams))


def test_multi_stream_runner_threaded_accumulates_without_on_result(assets, separate_runs):
    multi = _multi(assets, threaded=True)
    for t in range(2):
        for i in range(2):
            multi.submit_frame(i, _camera_frame(i, t))
    out = multi.flush()
    multi.close()
    assert [len(o) for o in out] == [1, 1]
    for i in range(2):
        for a, b in zip(out[i][0], separate_runs[i][0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert multi.results == [[], []]
    assert _multi(assets).aggregate_fps == 0.0  # nothing drained yet


def test_multi_stream_runner_depth_clamp_and_gate(assets):
    """depth is clamped to max_inflight // n_streams (at least 1) in threaded mode,
    all streams share one gate, and unthreaded runners keep their depth ungated."""
    for n, depth, permits, want in [(2, 2, None, 2), (4, 2, None, 1), (2, 5, 4, 2),
                                    (3, 2, 2, 1)]:
        multi = _multi(assets, n_streams=n, make_detector=lambda i: None, threaded=True,
                       depth=depth, max_inflight=permits)
        assert [s.depth for s in multi.streams] == [want] * n
        assert len({id(s._gate) for s in multi.streams}) == 1
        assert multi.streams[0]._gate._initial_value == (permits or 6)
        multi.close()
    plain = _multi(assets, depth=3)
    assert [s.depth for s in plain.streams] == [3, 3] and plain.streams[0]._gate is None


def test_multi_stream_runner_worker_error_is_raised_at_submit_and_flush(assets):
    class Boom:
        def __call__(self, frame):
            raise RuntimeError("camera 1 lost")

    multi = _multi(assets, threaded=True,
                   make_detector=lambda i: Boom() if i == 1 else _make_detector(0))
    multi.submit_frame(1, _camera_frame(1, 0))
    multi._queues[1].join()
    with pytest.raises(RuntimeError, match="camera 1 lost"):
        multi.submit_frame(1, _camera_frame(1, 1))
    multi.submit_frame(0, _camera_frame(0, 0))  # the other camera goes on
    with pytest.raises(RuntimeError, match="camera 1 lost"):
        multi.flush()
    multi.close()
    multi.close()
