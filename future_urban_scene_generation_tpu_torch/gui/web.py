"""Zero-dependency web GUI with the reference's interaction model.

Counterpart of the JAX package's gui/web.py (:40-312). Parity target:
GUI/app_interface.py:23-341. The reference drives selection through a PyQt5 window:
arrow keys navigate frames (:298-341), a single click previews the clicked vehicle's
future trajectory as a mid-bottom polyline (:244-273), a double click selects the
vehicle (:275-279), Backspace resets the selection (:285-296), and RUN dispatches
synthesis for the selected ids (:218-242).

GPU serving hosts are headless, so the primary GUI is a browser app served by the
standard library (``http.server``): the same ``SceneService`` that backs the Qt GUI
and the headless CLI renders annotated frames on the server, and a small JS page
holds the interaction state (frame id / preview id / selected ids) and mirrors the
Qt key and mouse bindings. PNGs are encoded by the package's own codec
(``utils/native.encode_png``: zlib and struct).

Endpoints (all JSON/PNG, stateless: the client owns the UI state):
  GET  /                      the single-page app
  GET  /frame/<id>.png        annotated frame; ?preview=<vid>&selected=a,b
  GET  /boxes/<id>            per-frame vehicle boxes for client-side hit tests
  POST /run                   {"frame_id": N, "ids": [...]} -> {"outputs": [...]}
  GET  /results/<i>.png       the i-th output of the last run
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from future_urban_scene_generation_tpu_torch.utils import video as vio
from future_urban_scene_generation_tpu_torch.utils.bbox import BoundingBox
from future_urban_scene_generation_tpu_torch.utils.native import encode_png

PREVIEW_STEPS = 60  # the reference previews the full track


def _draw_rect(img: np.ndarray, xyxy, color, thickness: int = 2) -> None:
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in xyxy)
    x0, x1 = max(0, min(x0, w - 1)), max(0, min(x1, w - 1))
    y0, y1 = max(0, min(y0, h - 1)), max(0, min(y1, h - 1))
    t = thickness
    img[y0:y0 + t, x0:x1 + 1] = color
    img[max(0, y1 - t + 1):y1 + 1, x0:x1 + 1] = color
    img[y0:y1 + 1, x0:x0 + t] = color
    img[y0:y1 + 1, max(0, x1 - t + 1):x1 + 1] = color


def _draw_polyline(img: np.ndarray, pts, color) -> None:
    h, w = img.shape[:2]
    for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
        n = int(max(abs(bx - ax), abs(by - ay))) + 1
        xs = np.clip(np.linspace(ax, bx, n).round().astype(int), 0, w - 1)
        ys = np.clip(np.linspace(ay, by, n).round().astype(int), 0, h - 1)
        for dy in (-1, 0, 1):
            img[np.clip(ys + dy, 0, h - 1), xs] = color


def frame_boxes(service, frame_id: int, bbox_scale) -> dict:
    """{vehicle id: BoundingBox} of one frame's tracking rows, clipped to the frame."""
    rows = service.trajectories[service.trajectories[:, 0] == frame_id]
    h, w = service.frame_hw
    return {
        int(r[1]): BoundingBox(*r[2:6], bounds=(0, w - 1, 0, h - 1), scale=bbox_scale)
        for r in rows
    }


def annotate_frame(service, frame, frame_id: int, bbox_scale, preview_id=None,
                   selected=()) -> np.ndarray:
    """The frame as uint8 with every vehicle's box drawn (green when selected, else
    red) and the previewed vehicle's future mid-bottom track as a yellow polyline.
    Both GUIs draw with this."""
    img = (np.asarray(frame) * 255).astype(np.uint8).copy()
    selected = set(int(v) for v in selected)
    for vid, bbox in frame_boxes(service, frame_id, bbox_scale).items():
        _draw_rect(img, bbox.xyxy, (0, 255, 0) if vid in selected else (255, 0, 0))
    if preview_id is not None:
        h, w = service.frame_hw
        rows = vio.select_future_track(service.trajectories, int(preview_id), frame_id,
                                       stride=1, steps=PREVIEW_STEPS)
        pts = [BoundingBox(*r[2:6], bounds=(0, w - 1, 0, h - 1), scale=bbox_scale).mid_bottom
               for r in rows]
        if len(pts) >= 2:
            _draw_polyline(img, pts, (255, 255, 0))
    return img


class WebGUI:
    """Presentation logic shared by the HTTP handler and the tests.

    Pure over ``SceneService``: every method takes the full UI state, so the
    server stays stateless (concurrent browser tabs cannot corrupt each other,
    unlike the Qt window whose state lives in widget attributes). Handler threads
    run concurrently: a directory of frames reads safely from several threads, but
    the video readers keep a decoder position, so every ``reader.read`` is taken
    under the GUI's lock.
    """

    def __init__(self, cfg, service=None):
        if service is None:
            from future_urban_scene_generation_tpu_torch.pipeline.service import SceneService

            service = SceneService(cfg)
        self.cfg = cfg
        self.service = service
        self._results: list = []
        self._lock = threading.Lock()

    def bboxes_for_frame(self, frame_id: int) -> dict:
        return frame_boxes(self.service, frame_id, self.cfg.bbox_scale)

    def hit_test(self, frame_id: int, x: float, y: float):
        """First vehicle whose (scaled) box contains the point, else None
        (GUI/app_interface.py:244-279 iterates boxes the same way)."""
        for vid, bbox in self.bboxes_for_frame(frame_id).items():
            if bbox.contains((x, y)):
                return vid
        return None

    def frame_png(self, frame_id: int, preview_id=None, selected=()) -> bytes:
        with self._lock:
            frame = self.service.reader.read(frame_id)
        if frame is None:
            raise KeyError(f"frame {frame_id} out of range")
        return encode_png(annotate_frame(self.service, frame, frame_id, self.cfg.bbox_scale,
                                         preview_id, selected))

    def run(self, frame_id: int, vehicle_ids) -> list:
        """RUN button: one synthesis request over the selected ids
        (GUI/app_interface.py:218-242 -> traj_test)."""
        paths = self.service.run_request(int(frame_id), [int(v) for v in vehicle_ids])
        with self._lock:
            self._results = list(paths)
        return [str(p) for p in self._results]

    def result_png(self, index: int) -> bytes:
        with self._lock:
            path = self._results[index]
        with open(path, "rb") as fh:
            return fh.read()


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Future scene synthesis</title>
<style>
 body { font-family: sans-serif; margin: 1rem; background: #111; color: #ddd; }
 #frame { cursor: crosshair; max-width: 100%; border: 1px solid #444; }
 #bar { margin: .5rem 0; display: flex; gap: .75rem; align-items: center; }
 button { font-size: 1rem; padding: .3rem 1rem; }
 #results img { max-width: 24%; margin: 2px; border: 1px solid #333; }
 .hint { color: #888; font-size: .85rem; }
</style></head><body>
<div id="bar">
 <button id="prev">&#8592;</button><span id="fid"></span><button id="next">&#8594;</button>
 <button id="run">RUN</button><span id="sel"></span><span id="status"></span>
</div>
<img id="frame" draggable="false">
<div class="hint">click: preview trajectory &middot; double-click: select vehicle &middot;
 Backspace: reset selection &middot; &#8592;/&#8594;: navigate frames</div>
<div id="results"></div>
<script>
let frameId = __FRAME_ID__, selected = [], preview = null, boxes = [];
const img = document.getElementById('frame');
function refresh() {
  const q = new URLSearchParams();
  if (preview !== null) q.set('preview', preview);
  if (selected.length) q.set('selected', selected.join(','));
  img.src = `/frame/${frameId}.png?` + q;
  document.getElementById('fid').textContent = 'frame ' + frameId;
  document.getElementById('sel').textContent =
    selected.length ? 'selected: ' + selected.join(', ') : 'no selection';
  fetch(`/boxes/${frameId}`).then(r => r.json()).then(b => { boxes = b; });
}
function hit(ev) {
  const r = img.getBoundingClientRect();
  const x = (ev.clientX - r.left) * img.naturalWidth / r.width;
  const y = (ev.clientY - r.top) * img.naturalHeight / r.height;
  for (const b of boxes)
    if (x >= b.x0 && x <= b.x1 && y >= b.y0 && y <= b.y1) return b.id;
  return null;
}
img.addEventListener('click', ev => { preview = hit(ev); refresh(); });
img.addEventListener('dblclick', ev => {
  const v = hit(ev);
  if (v !== null && !selected.includes(v)) selected.push(v);
  refresh();
});
document.addEventListener('keydown', ev => {
  if (ev.key === 'Backspace') { selected = []; preview = null; }
  else if (ev.key === 'ArrowRight') frameId += 1;
  else if (ev.key === 'ArrowLeft') frameId = Math.max(1, frameId - 1);
  else return;
  ev.preventDefault(); refresh();
});
document.getElementById('prev').onclick = () => { frameId = Math.max(1, frameId - 1); refresh(); };
document.getElementById('next').onclick = () => { frameId += 1; refresh(); };
document.getElementById('run').onclick = () => {
  if (!selected.length) return;
  document.getElementById('status').textContent = 'synthesizing…';
  fetch('/run', {method: 'POST', headers: {'Content-Type': 'application/json'},
                 body: JSON.stringify({frame_id: frameId, ids: selected})})
    .then(r => r.json()).then(out => {
      document.getElementById('status').textContent =
        out.outputs.length + ' frames written';
      document.getElementById('results').innerHTML = out.outputs
        .map((_, i) => `<img src="/results/${i}.png?t=${Date.now()}">`).join('');
    }).catch(() => { document.getElementById('status').textContent = 'failed'; });
};
refresh();
</script></body></html>
"""


def make_server(cfg, host: str = "127.0.0.1", port: int = 0,
                service=None) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; ``port=0`` picks a free port."""
    gui = WebGUI(cfg, service=service)
    start_frame = max(1, int(getattr(cfg, "frame_id", 1) or 1))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; tests assert responses
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            try:
                if not parts:
                    page = _PAGE.replace("__FRAME_ID__", str(start_frame))
                    self._send(200, page.encode(), "text/html; charset=utf-8")
                elif parts[0] == "frame" and len(parts) == 2:
                    frame_id = int(parts[1].removesuffix(".png"))
                    q = parse_qs(url.query)
                    preview = q.get("preview", [None])[0]
                    selected = [s for s in
                                q.get("selected", [""])[0].split(",") if s]
                    png = gui.frame_png(frame_id,
                                        preview_id=None if preview is None
                                        else int(preview),
                                        selected=selected)
                    self._send(200, png, "image/png")
                elif parts[0] == "boxes" and len(parts) == 2:
                    boxes = [
                        {"id": vid, "x0": b.xyxy[0], "y0": b.xyxy[1],
                         "x1": b.xyxy[2], "y1": b.xyxy[3]}
                        for vid, b in gui.bboxes_for_frame(int(parts[1])).items()
                    ]
                    self._json(boxes)
                elif parts[0] == "results" and len(parts) == 2:
                    idx = int(parts[1].removesuffix(".png"))
                    self._send(200, gui.result_png(idx), "image/png")
                else:
                    self._json({"error": "not found"}, 404)
            except (KeyError, IndexError, ValueError) as exc:
                self._json({"error": str(exc)}, 404)

        def do_POST(self):
            if urlparse(self.path).path != "/run":
                return self._json({"error": "not found"}, 404)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                outputs = gui.run(req["frame_id"], req.get("ids", []))
                self._json({"outputs": outputs})
            except Exception as exc:  # surface synthesis errors to the page
                self._json({"error": str(exc)}, 500)

    server = ThreadingHTTPServer((host, port), Handler)
    server.gui = gui  # tests reach the logic object through the server
    return server


def launch_web_gui(cfg, host: str = "127.0.0.1", port: int = 8000,
                   service=None) -> None:
    server = make_server(cfg, host=host, port=port, service=service)
    print(f"web GUI listening on http://{host}:{server.server_address[1]}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
