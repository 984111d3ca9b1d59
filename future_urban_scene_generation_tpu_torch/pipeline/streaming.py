"""Streaming scene synthesis: models and assets stay on the device, frames stream in.

Counterpart of the JAX package's pipeline/streaming.py (``StreamRunner`` :32-163,
``TrackingStreamRunner`` :166-267, ``MultiStreamRunner`` :270-447). The
reference is strictly request-per-click through its GUI; for sustained serving this
runner keeps up to ``depth`` scenes in flight: a frame is uploaded from pinned host
memory without blocking (uint8 frames convert to float on the device), the scene is
enqueued on the current CUDA stream, and an event recorded behind it is waited on
only when the result is drained.

    stream = StreamRunner(models, cad_bank, intrinsic, frame_hw, n_vehicles=4, spec=spec)
    for frame, bboxes, meters in source:
        result = stream.submit(frame, bboxes, meters)  # the oldest finished scene, or None

The runner works on the device its ``cad_bank`` lies on; the caller chose it when
building the bank and the models. With a ``mesh`` (``parallel.mesh.make_mesh``) every
rank of the mesh runs the same runner on the same frames, and each scene shards its
vehicles over the mesh's 'data' axis (``runner.run_scene_sharded``).
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
import time
from typing import Deque, Optional, Tuple

import numpy as np
import torch

from future_urban_scene_generation_tpu_torch.models import layers
from future_urban_scene_generation_tpu_torch.parallel import mesh as pmesh
from future_urban_scene_generation_tpu_torch.pipeline import runner as _runner
from future_urban_scene_generation_tpu_torch.pipeline import tracking as trk
from future_urban_scene_generation_tpu_torch.spec import ModelSpec
from future_urban_scene_generation_tpu_torch.utils import profiling


class StreamRunner:
    def __init__(
        self,
        models,
        cad_bank,
        intrinsic,
        frame_hw: Tuple[int, int],
        n_vehicles: int,
        *,
        spec: ModelSpec,
        n_steps: int = 6,
        vis_res: int = _runner.VIS_RES,
        depth: int = 2,
        mesh=None,
        inflight_gate=None,
    ):
        # None: one device; else the vehicle axis shards over the mesh's 'data' axis,
        # and the fixed vehicle count the runner pads to must split evenly over it.
        if mesh is not None:
            pmesh.axis_rows(n_vehicles, mesh, "data")
        self.mesh = mesh
        self.models = models
        self.cad_bank = cad_bank
        self.device = cad_bank.vertices.device
        self.intrinsic = torch.as_tensor(np.asarray(intrinsic, np.float32)).to(self.device)
        self.frame_hw = frame_hw
        self.n_vehicles = n_vehicles
        self.spec = spec
        self.n_steps = n_steps
        self.vis_res = vis_res
        # Optional shared threading.BoundedSemaphore: each in-flight scene holds one
        # permit from dispatch to drain, bounding the scenes in flight across
        # several runners that share a device.
        self._gate = inflight_gate
        self._inflight: Deque = collections.deque()
        self._scene_ids = itertools.count()  # each scene's request id in the span record
        self.depth = depth
        self.latencies: list = []
        self._t_first_submit: Optional[float] = None
        self._t_last_drain: Optional[float] = None
        self._drained = 0

    def _pad(self, bboxes, meters):
        """Pad/truncate to the fixed vehicle count (fixed shapes are what a captured
        graph of the scene needs). Padding vehicles get degenerate boxes; the fault
        barrier masks them out."""
        v = self.n_vehicles
        b = np.zeros((v, 4), np.float32)
        m = np.zeros((v, self.n_steps, 2), np.float32)
        n = min(len(bboxes), v)
        b[:n] = np.asarray(bboxes, np.float32)[:n]
        m[:n] = np.asarray(meters, np.float32)[:n, : self.n_steps]
        return b, m

    @staticmethod
    def _upload(img, device) -> torch.Tensor:
        """Host -> device image upload as float32 [0, 1]. uint8 inputs ship a
        quarter of the bytes and convert on the device. To a CUDA device the copy
        goes through pinned host memory and does not block the host."""
        device = torch.device(device)
        t = torch.from_numpy(np.ascontiguousarray(img))
        if t.dtype not in (torch.uint8, torch.float32):
            t = t.to(torch.float32)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        if t.dtype == torch.uint8:
            return t.to(torch.float32) / 255.0
        return t

    def _run_scene(self, scene_id, frame, background, bboxes, meters):
        """Enqueue one scene; returns (result, event recorded behind it or None).
        ``frame`` is a host image or already on the device; ``background`` a host
        image or None (the frame). The ``fusg.stream.dispatch`` span covers the
        uploads, the scene's enqueue and the event, and starts once a gate's permit is
        held, so that no wait on another stream counts as dispatch."""
        if self._gate is not None:
            self._gate.acquire()  # released by _drain_one, or here if dispatch fails
        try:
            with profiling.request(scene_id), profiling.trace("fusg.stream.dispatch"):
                frame_d = (frame if isinstance(frame, torch.Tensor)
                           else self._upload(frame, self.device))
                bg_d = (self._upload(background, self.device) if background is not None
                        else frame_d)
                b, m = self._pad(bboxes, meters)
                args = (self.models, self.cad_bank, frame_d, bg_d, self._upload(b, self.device),
                        self._upload(m, self.device), self.intrinsic)
                if self.mesh is not None:
                    result = _runner.run_scene_sharded(*args, self.mesh, spec=self.spec,
                                                       vis_res=self.vis_res)
                else:
                    result = _runner.run_scene(*args, spec=self.spec, vis_res=self.vis_res)
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record()
        except BaseException:
            if self._gate is not None:
                self._gate.release()
            raise
        return result, event

    def _submit_scene(self, t0, frame, background, bboxes, meters):
        """Dispatch one scene into the pipeline; returns a drained result or None
        while the pipeline fills. With a gate, a full pipeline drains (releasing a
        permit) BEFORE it dispatches (acquiring one): a worker must never block in
        acquire while it sits on a full depth's permits, or several workers can
        starve each other. Without a gate the order is dispatch, then drain
        (steady state: depth - 1 in flight)."""
        out = None
        if self._gate is not None and len(self._inflight) >= self.depth:
            out = self._drain_one()
        scene_id = next(self._scene_ids)
        result, event = self._run_scene(scene_id, frame, background, bboxes, meters)
        self._inflight.append((t0, scene_id, result, event))
        if out is None and self._gate is None and len(self._inflight) >= self.depth:
            out = self._drain_one()
        return out

    def submit(self, frame: np.ndarray, bboxes, meters, background: Optional[np.ndarray] = None):
        """Enqueue one scene; returns the OLDEST completed result once the pipeline
        depth is reached (None while filling). ``frame`` / ``background`` may be
        uint8 (preferred: a quarter of the upload) or float [0, 1]."""
        t0 = time.perf_counter()
        return self._submit_scene(t0, frame, background, bboxes, meters)

    def _drain_one(self):
        t0, scene_id, result, event = self._inflight.popleft()
        if self._t_first_submit is None:
            self._t_first_submit = t0
        self._t_first_submit = min(self._t_first_submit, t0)
        try:
            with profiling.request(scene_id), profiling.trace("fusg.stream.wait"):
                if event is not None:
                    event.synchronize()
        finally:
            if self._gate is not None:
                self._gate.release()
        now = time.perf_counter()
        self.latencies.append(now - t0)
        self._t_last_drain = now
        self._drained += 1
        return result

    def flush(self):
        """Drain all in-flight scenes."""
        out = []
        while self._inflight:
            out.append(self._drain_one())
        return out

    @property
    def throughput_fps(self) -> float:
        """Composited frames/s over the drained scenes (both branches), by WALL
        CLOCK from the first submission to the last drain."""
        if not self._drained or self._t_last_drain is None:
            return 0.0
        frames = self._drained * 2 * self.n_steps
        wall = max(self._t_last_drain - (self._t_first_submit or 0.0), 1e-9)
        return frames / wall


class TrackingStreamRunner(StreamRunner):
    """The full loop with NO caller-supplied boxes or trajectories:
    detect -> track -> predict future -> (keypoint -> PnP -> NVS -> composite).

    The reference assumes precomputed tracking files and a GUI selection
    (utils/video_info_utils.py:7-21); this runner replaces that front-end with a
    frame-level detector (pipeline/tracking.py) and a greedy-IoU
    constant-velocity tracker, predicting each confirmed track's future
    ground-plane trajectory from its own history.

    detector: callable frame -> (boxes (N, 4) xyxy, scores (N,)), e.g.
        tracking.BackgroundDiffDetector. When it exposes split ``dispatch(frame)``
        / ``finalize(handle)`` methods and ``overlap_detect`` is on, the runner
        enqueues frame t's detection and reads frame t-1's instead: a read right
        after the dispatch would wait behind the previous scene on the stream.
        Tracks then update one frame late and the scene uses each track's
        constant-velocity PREDICTED box, the same prediction the tracker already
        coasts with on a missed detection.
    inv_homography: pixel -> GPS matrix (utils/video.py calibration), or None to
        treat the pixel plane as the ground plane (synthetic scenes).
    """

    def __init__(self, models, cad_bank, intrinsic, frame_hw, n_vehicles, *,
                 detector=None, inv_homography=None, stride: int = 2,
                 min_track_frames: int = 3, tracker=None,
                 overlap_detect: bool = True, **kwargs):
        super().__init__(models, cad_bank, intrinsic, frame_hw, n_vehicles, **kwargs)
        self.detector = detector
        self.tracker = tracker or trk.IouTracker(min_hits=min_track_frames)
        self.inv_homography = inv_homography
        self.stride = stride
        self.overlap_detect = bool(overlap_detect)
        self._pending_detect = None

    def _confirmed(self):
        conf = getattr(self.tracker, "confirmed", None)
        return conf() if callable(conf) else []

    def flush(self):
        # Fold the in-flight detection into the tracker (its frame was never
        # synthesized, which is inherent to overlap mode, but callers that
        # inspect tracks after flush see every submitted frame's detections).
        if self._pending_detect is not None:
            boxes, _ = self.detector.finalize(self._pending_detect)
            self._pending_detect = None
            self.tracker.update(boxes)
        return super().flush()

    def submit_frame(self, frame: np.ndarray, background: Optional[np.ndarray] = None):
        """One streaming step from a raw frame. Returns (result-or-None, tracks).

        With ``overlap_detect=True`` (the default) detection is pipelined one
        frame deep: the first call always returns ``(None, [])``, every synthesis
        consumes the PREVIOUS frame's detections with tracks coasted one frame
        forward, and the last submitted frame's detections are folded into the
        tracker only by ``flush()``. Callers that need frame-aligned detections
        construct the runner with ``overlap_detect=False``."""
        frame_d = self._upload(frame, self.device)  # for detect + scene, uploaded once
        overlapped = self.overlap_detect and hasattr(self.detector, "dispatch")
        # The detector's forward runs on the stream's int8 tier as the scene does: the
        # JAX package's process-wide knob reaches its jitted MaskRCNNDetector too.
        if overlapped:
            with layers.quantized_convs(self.spec.quantized_convs):
                handle = self.detector.dispatch(frame_d)
            prev = self._pending_detect
            self._pending_detect = handle
            if prev is None:  # first frame: nothing to finalize yet
                return None, self._confirmed()
            boxes, _scores = self.detector.finalize(prev)
        else:
            with layers.quantized_convs(self.spec.quantized_convs):
                boxes, _scores = self.detector(frame_d)
        confirmed = self.tracker.update(boxes)

        sel_boxes, sel_meters = [], []
        for t in confirmed:
            meters = trk.predict_future_meters(
                t.history, self.inv_homography, self.n_steps, stride=self.stride
            )
            if meters is None:
                continue
            # Overlapped mode: tracks are current through frame t-1; coast one
            # frame forward so the crop follows the vehicle in frame t.
            sel_boxes.append(t.predicted_bbox() if overlapped else t.bbox)
            sel_meters.append(meters)
            if len(sel_boxes) == self.n_vehicles:
                break
        if not sel_boxes:
            return None, confirmed

        t0 = time.perf_counter()
        return self._submit_scene(t0, frame_d, background, np.stack(sel_boxes),
                                  np.stack(sel_meters)), confirmed


class MultiStreamRunner:
    """N camera streams through ONE set of models and one CAD bank.

    The reference is single-camera by contract (one ``vdo.avi`` per run); serving
    multiplexes several cameras onto one device. Per-stream STATE is isolated: each
    stream owns its tracker, its detector (and that camera's background model), its
    pending detection and its latency statistics. Weights and CAD bank are shared
    and read-only, and every stream submits the same fixed (frame_hw, n_vehicles,
    n_steps) shapes.

    make_detector: stream_idx -> detector (each stream needs its own).

    ``threaded=True`` gives each stream a worker thread that owns exactly that stream
    (no locks on per-stream state) and a queue of 8 frames: ``submit_frame`` becomes
    enqueue-and-return ``(None, [])``, and drained results go to
    ``on_result(stream_idx, result)`` in the worker thread if given, else accumulate
    in ``results[stream_idx]`` until ``flush()``. Pass ``on_result`` (consume and
    release) for long runs: each retained SceneResult keeps two (S, H, W, 3) float32
    stacks on the device (133 MB at 720x1280 and S = 6). Threads did NOT raise the
    aggregate while the scene's PnP was ~20,000 host launches that held the
    interpreter lock (and serialized its Jacobian, ``geometry/pnp.py``): measured on an
    NVIDIA H100 80GB HBM3 at 700 W, 720x1280, V = 4 (``chip_smoke.py --phases multi``;
    PERF.md section 6), 2 cameras 12.85 composited frames/s from one thread against
    9.71 threaded, 4 cameras 5.57-6.18 threaded. On the card the solve is one kernel
    launch now (P1); the threaded rates have not been measured since. The mode is for
    callers that must not block in ``submit_frame``.

    One shared ``BoundedSemaphore`` of ``max_inflight`` permits bounds the scenes in
    flight across all streams in threaded mode (a scene holds a permit from dispatch
    to drain), and ``depth`` is clamped to ``max_inflight // n_streams``: a worker
    that holds a full depth's permits releases one (drains) BEFORE it acquires the
    next, so a blocked worker holds no permit it could not give back and the permit
    holders can always reach their own drain. The default of 6 permits is the JAX
    package's; at 4 cameras on the card 4, 6 and 8 permits gave the same aggregate
    (5.76, 5.57-6.18, 5.94 frames/s) and 8 (depth 2) doubled the latency, so 6 stays
    as a bound on device memory.

    All workers enqueue on the device's default CUDA stream, so scenes of different
    cameras run on the device in the order their workers dispatched them, as on the
    JAX package's single device queue. (The current stream and the grad mode are
    thread-local in torch: ``run_scene`` is ``torch.no_grad`` by decoration, and a
    worker that never sets a stream uses the default one.) A CUDA stream per worker
    measured slower in the same run (2 cameras 8.34 against 9.71, 4 cameras 5.10
    against 5.57-6.18): the device idles most of a scene either way.

    An exception in one worker is kept and raised by that stream's next
    ``submit_frame`` and by ``flush``; frames queued behind it are dropped.

    ``meshes`` (optional, one per stream, each ``parallel.mesh.make_mesh``'s): stream
    i shards its scenes' vehicles over ``meshes[i]`` (``runner.run_scene_sharded``);
    disjoint meshes put the streams on disjoint devices. In threaded mode the meshes
    must be disjoint (``ValueError`` otherwise): each worker runs its stream's
    collectives from its own thread, so two streams on one rank would reach their
    shared ranks' collectives in an order each rank's thread scheduling picks, and
    could pair one stream's gather with another's. The JAX package is
    single-controller, one process sees every stream; under torch's one process per
    device a rank builds only the streams whose mesh holds it (a None mesh: every
    rank, unsharded), ``streams[i]`` is None for the others, and ``submit_frame`` to
    such a stream raises ``ValueError``. Every rank of a stream's mesh submits that
    stream's frames.
    """

    def __init__(self, models, cad_bank, intrinsic, frame_hw, n_vehicles, *,
                 n_streams: int, make_detector, inv_homographies=None,
                 threaded: bool = False, meshes=None, max_inflight: Optional[int] = None,
                 on_result=None, **kwargs):
        if inv_homographies is None:
            inv_homographies = [None] * n_streams
        if meshes is None:
            meshes = [None] * n_streams
        here = [i for i in range(n_streams) if meshes[i] is None or pmesh.holds_rank(meshes[i])]
        gate = None
        if threaded:
            owner = {}
            for i, m in enumerate(meshes):
                for r in ([] if m is None else m.mesh.flatten().tolist()):
                    if owner.setdefault(r, i) != i:
                        raise ValueError(f"threaded streams {owner[r]} and {i} share rank "
                                         f"{r}: their collectives could pair up across "
                                         "streams; give them disjoint meshes or threaded=False")
            max_inflight = 6 if max_inflight is None else int(max_inflight)
            gate = threading.BoundedSemaphore(max_inflight)
            kwargs["depth"] = max(1, min(int(kwargs.pop("depth", 2)),
                                         max_inflight // max(len(here), 1)))
        self.streams = [
            TrackingStreamRunner(
                models, cad_bank, intrinsic, frame_hw, n_vehicles,
                detector=make_detector(i), inv_homography=inv_homographies[i],
                mesh=meshes[i], inflight_gate=gate, **kwargs,
            ) if i in here else None
            for i in range(n_streams)
        ]
        self.threaded = bool(threaded)
        self.on_result = on_result
        self.results = [[] for _ in range(n_streams)]
        if self.threaded:
            self._queues = [queue.Queue(maxsize=8) if i in here else None
                            for i in range(n_streams)]
            self._errors: list = [None] * n_streams
            self._workers = []
            for i in here:
                w = threading.Thread(target=self._worker, args=(i,), daemon=True,
                                     name=f"fusg-stream-{i}")
                w.start()
                self._workers.append(w)

    def _worker(self, i: int):
        q = self._queues[i]
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            try:
                if self._errors[i] is None:  # fail-fast: skip after the first error
                    out, _tracks = self.streams[i].submit_frame(*item)
                    if out is not None:
                        if self.on_result is not None:
                            self.on_result(i, out)  # consumed: its tensors can go
                        else:
                            self.results[i].append(out)
            except Exception as e:  # raised by the next submit_frame / flush
                self._errors[i] = e
            finally:
                q.task_done()

    def submit_frame(self, stream_idx: int, frame, background=None):
        """One streaming step for camera ``stream_idx``; the contract of
        ``TrackingStreamRunner.submit_frame``. Threaded mode: enqueue and return
        ``(None, [])`` (results as the class docstring says)."""
        if self.streams[stream_idx] is None:
            raise ValueError(f"stream {stream_idx} is not on rank "
                             f"{torch.distributed.get_rank()}: its mesh does not hold it")
        if not self.threaded:
            return self.streams[stream_idx].submit_frame(frame, background)
        if self._errors[stream_idx] is not None:
            raise self._errors[stream_idx]
        self._queues[stream_idx].put((frame, background))
        return None, []

    def flush(self):
        """Drain every stream; returns a list of per-stream result lists (threaded
        mode: what the workers accumulated plus the final drain; with ``on_result``
        the final drain goes there too and the lists are empty). The workers stay
        alive for further submissions. A stream not on this rank gives []."""
        if not self.threaded:
            return [s.flush() if s is not None else [] for s in self.streams]
        for q in self._queues:
            if q is not None:
                q.join()  # barrier: every enqueued frame has been submitted
        for err in self._errors:
            if err is not None:
                raise err
        out = []
        for i, s in enumerate(self.streams):
            drained, self.results[i] = self.results[i], []
            tail = s.flush() if s is not None else []
            if self.on_result is not None:
                for r in tail:
                    self.on_result(i, r)
                out.append(drained)
            else:
                out.append(drained + tail)
        return out

    def close(self):
        """Stop the worker threads (threaded mode; idempotent)."""
        if not self.threaded:
            return
        for q in self._queues:
            if q is not None:
                q.put(None)
        for w in self._workers:
            w.join(timeout=30)
        self.threaded = False

    @property
    def aggregate_fps(self) -> float:
        """Composited frames/s of all streams over ONE wall clock: the drained
        scenes of every stream, from the earliest first submission to the latest
        drain of any stream. This is what a user of the device gets."""
        live = [s for s in self.streams
                if s is not None and s._drained and s._t_last_drain is not None]
        if not live:
            return 0.0
        frames = sum(s._drained * 2 * s.n_steps for s in live)
        wall = max(s._t_last_drain for s in live) - min(s._t_first_submit or 0.0 for s in live)
        return frames / max(wall, 1e-9)
