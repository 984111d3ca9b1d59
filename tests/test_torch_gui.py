"""The PyTorch port's GUIs on the CPU: ``gui/web`` over real sockets with a fake
service (the cases of tests/test_web_gui.py) and ``gui/app`` through a stub Qt (the
cases of tests/test_gui.py).

The annotated frame is decoded back and compared pixel for pixel with what the JAX
package's ``WebGUI.frame_png`` draws on the same fake service (exact: the same
integer drawing on uint8; only the PNG encoders differ, and both are lossless).
"""
import json
import sys
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from future_urban_scene_generation_tpu.gui import web as jweb
from future_urban_scene_generation_tpu_torch.gui import app as gui_app
from future_urban_scene_generation_tpu_torch.gui import web
from future_urban_scene_generation_tpu_torch.pipeline import service as service_mod
from future_urban_scene_generation_tpu_torch.utils.native import decode_png, encode_png
import torch_threads  # noqa: F401

FRAME_HW = (120, 160)


class _FakeReader:
    def __init__(self):
        self.reading = 0
        self.overlapped = False

    def read(self, frame_id):
        self.reading += 1
        self.overlapped |= self.reading > 1
        try:
            if frame_id > 20:
                return None
            yy, xx = np.mgrid[:FRAME_HW[0], :FRAME_HW[1]].astype(np.float32)
            return np.stack([xx / 200.0, yy / 150.0, 0.3 + 0 * xx], -1)
        finally:
            self.reading -= 1


class _FakeService:
    """The attribute surface of SceneService that the GUI layer touches."""

    last = None

    def __init__(self, cfg=None, tmp_path=None):
        _FakeService.last = self
        self.frame_hw = FRAME_HW
        rows = []
        for f in range(1, 21):
            rows.append([f, 7, 10 + f, 20, 40, 30])
            rows.append([f, 9, 100, 60, 30, 25])
        self.trajectories = np.asarray(rows, np.float64)
        self.reader = _FakeReader()
        self.requests = []
        self._tmp = tmp_path

    def run_request(self, frame_id, ids):
        self.requests.append((frame_id, list(ids)))
        if self._tmp is None:
            return [f"out_{frame_id}_{i}.png" for i in ids]
        paths = []
        for i in ids:
            p = self._tmp / f"out_{frame_id}_{i}.png"
            p.write_bytes(encode_png(np.full((8, 8, 3), i, np.uint8)))
            paths.append(p)
        return paths


class _Cfg:
    frame_id = 1
    bbox_scale = 1.0


@pytest.fixture
def server(tmp_path):
    svc = _FakeService(tmp_path=tmp_path)
    srv = web.make_server(_Cfg(), port=0, service=svc)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv, svc, base
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_index_serves_page(server):
    _srv, _svc, base = server
    status, ctype, body = _get(base + "/")
    assert status == 200 and ctype.startswith("text/html")
    page = body.decode()
    assert "RUN" in page and "dblclick" in page and "Backspace" in page
    assert "let frameId = 1," in page  # cfg.frame_id threaded into the page
    assert "TPU" not in page


def test_boxes_json(server):
    _srv, _svc, base = server
    status, ctype, body = _get(base + "/boxes/3")
    assert status == 200 and ctype == "application/json"
    boxes = {b["id"]: b for b in json.loads(body)}
    assert set(boxes) == {7, 9}
    assert boxes[7]["x0"] == 13 and boxes[7]["y0"] == 20  # x_min = 10 + f


@pytest.mark.parametrize("query,preview,selected", [
    ("", None, ()), ("?preview=7&selected=9", 7, (9,)), ("?preview=9", 9, ()),
    ("?selected=7,9", None, (7, 9)),
])
def test_frame_png_matches_jax_gui(server, query, preview, selected):
    _srv, svc, base = server
    status, ctype, body = _get(base + "/frame/2.png" + query)
    assert status == 200 and ctype == "image/png"
    assert body.startswith(b"\x89PNG\r\n\x1a\n")
    got = decode_png(body)
    want = decode_png(jweb.WebGUI(_Cfg(), service=svc).frame_png(2, preview, selected))
    assert got.shape == FRAME_HW + (3,)
    np.testing.assert_array_equal(got, want)
    plain = (svc.reader.read(2) * 255).astype(np.uint8)
    assert (got != plain).any()  # boxes are drawn on every frame
    yellow = (got == (255, 255, 0)).all(-1).sum()
    assert (yellow > 0) == (preview is not None)  # the previewed track is drawn


def test_out_of_range_frame_is_404(server):
    _srv, _svc, base = server
    for path in ("/frame/999.png", "/nonsense", "/frame/abc.png"):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(base + path)
        assert exc.value.code == 404


def test_run_roundtrip_and_results(server):
    _srv, svc, base = server
    req = urllib.request.Request(
        base + "/run", method="POST",
        data=json.dumps({"frame_id": 4, "ids": [7, 9]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        out = json.loads(resp.read())
    assert svc.requests == [(4, [7, 9])]
    assert len(out["outputs"]) == 2
    status, ctype, body = _get(base + "/results/1.png")
    assert status == 200 and ctype == "image/png"
    np.testing.assert_array_equal(decode_png(body), np.full((8, 8, 3), 9, np.uint8))
    with pytest.raises(urllib.error.HTTPError) as exc:  # bounded by the last run
        _get(base + "/results/5.png")
    assert exc.value.code == 404
    bad = urllib.request.Request(base + "/run", method="POST", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as exc:  # no frame_id: surfaced as 500
        urllib.request.urlopen(bad, timeout=30)
    assert exc.value.code == 500


def test_concurrent_frame_requests_read_one_at_a_time(server):
    """Handler threads share one reader, and the video readers keep a decoder
    position: the GUI takes its lock around every read."""
    _srv, svc, base = server
    real_read = svc.reader.read

    def slow_read(frame_id):
        svc.reader.reading += 1
        svc.reader.overlapped |= svc.reader.reading > 1
        threading.Event().wait(0.05)
        svc.reader.reading -= 1
        return real_read(frame_id)

    svc.reader.read = slow_read
    threads = [threading.Thread(target=_get, args=(f"{base}/frame/{i}.png",))
               for i in range(1, 5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not svc.reader.overlapped


def test_hit_test_matches_reference_iteration():
    gui = web.WebGUI(_Cfg(), service=_FakeService())
    assert gui.hit_test(1, 15, 25) == 7  # inside vehicle 7's box at frame 1
    assert gui.hit_test(1, 110, 70) == 9
    assert gui.hit_test(1, 1, 1) is None


def test_draw_helpers_clip_to_bounds_and_match_jax():
    img, jimg = np.zeros((10, 10, 3), np.uint8), np.zeros((10, 10, 3), np.uint8)
    for mod, im in ((web, img), (jweb, jimg)):
        mod._draw_rect(im, (-5, -5, 20, 20), (255, 0, 0))
        mod._draw_polyline(im, [(-3, 5), (15, 5)], (0, 255, 0))
    assert img[5, 5, 1] == 255  # the polyline passes through the middle
    np.testing.assert_array_equal(img, jimg)


# ---------------------------------------------------------------------------
# gui/app.py through a stub Qt (PyQt5 is not installed here)
# ---------------------------------------------------------------------------


class _Signal:
    def __init__(self):
        self._slots = []

    def connect(self, fn):
        self._slots.append(fn)

    def emit(self):
        for fn in self._slots:
            fn()


class _QWidgetBase:
    def __init__(self, *a, **k):
        pass

    def setWindowTitle(self, title):
        self.title = title

    def setCentralWidget(self, *a):
        pass

    def show(self):
        pass


class _QLabel(_QWidgetBase):
    def __init__(self):
        self.pixmaps = []

    def setPixmap(self, p):
        self.pixmaps.append(p)

    def mapFrom(self, _w, pos):
        return pos


class _QPushButton(_QWidgetBase):
    def __init__(self, *_):
        self.clicked = _Signal()


class _QVBoxLayout:
    def __init__(self, *_):
        pass

    def addWidget(self, *_):
        pass


class _QMessageBox:
    infos = []

    @classmethod
    def information(cls, *a):
        cls.infos.append(a)


class _QApplication:
    def __init__(self, *_):
        pass

    def exec_(self):
        return 0


class _Pos:
    def __init__(self, x, y):
        self._x, self._y = x, y

    def x(self):
        return self._x

    def y(self):
        return self._y


class _Event:
    def __init__(self, x=0, y=0, key=None):
        self._pos = _Pos(x, y)
        self._key = key

    def pos(self):
        return self._pos

    def key(self):
        return self._key


@pytest.fixture
def window(monkeypatch):
    qtcore = types.ModuleType("PyQt5.QtCore")
    qtcore.Qt = types.SimpleNamespace(Key_Backspace=1, Key_Right=2, Key_Left=3)
    qtgui = types.ModuleType("PyQt5.QtGui")

    class _QImage:
        Format_RGB888 = 0

        def __init__(self, data, w, h, stride, fmt):
            self.shape = (h, w, stride // w)
            assert len(data) == h * stride

    qtgui.QImage = _QImage
    qtgui.QPixmap = types.SimpleNamespace(fromImage=lambda img: img)
    qtw = types.ModuleType("PyQt5.QtWidgets")
    qtw.QMainWindow = _QWidgetBase
    qtw.QLabel = _QLabel
    qtw.QPushButton = _QPushButton
    qtw.QWidget = _QWidgetBase
    qtw.QVBoxLayout = _QVBoxLayout
    qtw.QMessageBox = _QMessageBox
    qtw.QApplication = _QApplication
    pyqt5 = types.ModuleType("PyQt5")
    pyqt5.QtCore, pyqt5.QtGui, pyqt5.QtWidgets = qtcore, qtgui, qtw
    for name, mod in (("PyQt5", pyqt5), ("PyQt5.QtCore", qtcore),
                      ("PyQt5.QtGui", qtgui), ("PyQt5.QtWidgets", qtw)):
        monkeypatch.setitem(sys.modules, name, mod)
    _QMessageBox.infos = []
    monkeypatch.setattr(service_mod, "SceneService", _FakeService)
    cfg = types.SimpleNamespace(frame_id=1, bbox_scale=1.0)
    _app, win = gui_app.launch_gui(cfg, exec_loop=False)
    return win


def test_click_previews_trajectory_and_draws_it(window):
    assert window.preview_id is None and "TPU" not in window.title
    red = (window.image == (255, 0, 0)).all(-1).sum()
    assert red > 0  # boxes are drawn without cv2
    window.mousePressEvent(_Event(x=15, y=25))  # inside vehicle 7's bbox
    assert window.preview_id == 7
    assert (window.image == (255, 255, 0)).all(-1).sum() > 0  # and so is the track
    want = web.annotate_frame(_FakeService.last, _FakeService.last.reader.read(1), 1, 1.0,
                              preview_id=7)
    np.testing.assert_array_equal(window.image, want)
    window.mousePressEvent(_Event(x=5, y=5))  # empty space clears the preview
    assert window.preview_id is None
    assert (window.image == (255, 255, 0)).all(-1).sum() == 0


def test_double_click_selects_and_backspace_resets(window):
    window.mouseDoubleClickEvent(_Event(x=15, y=25))
    window.mouseDoubleClickEvent(_Event(x=110, y=70))
    assert window.selected_ids == [7, 9]
    assert (window.image == (0, 255, 0)).all(-1).sum() > 0  # selected boxes turn green
    window.mouseDoubleClickEvent(_Event(x=15, y=25))  # no duplicate selection
    assert window.selected_ids == [7, 9]
    window.keyPressEvent(_Event(key=1))  # Backspace
    assert window.selected_ids == []


def test_arrow_keys_navigate_frames(window):
    assert window.frame_id == 1
    window.keyPressEvent(_Event(key=2))  # Right
    window.keyPressEvent(_Event(key=2))
    assert window.frame_id == 3
    window.keyPressEvent(_Event(key=3))  # Left
    assert window.frame_id == 2
    window.keyPressEvent(_Event(key=3))
    window.keyPressEvent(_Event(key=3))  # clamps at 1
    assert window.frame_id == 1


def test_run_dispatches_selected_ids(window):
    svc = _FakeService.last
    window.perform_test()  # nothing selected: no request
    assert svc.requests == []
    window.mouseDoubleClickEvent(_Event(x=15, y=25))
    window.keyPressEvent(_Event(key=2))  # advance to frame 2
    window.run_btn.clicked.emit()
    # RUN sends the CURRENT frame and selection to the service once, then shows the
    # result paths (GUI/app_interface.py:218-242).
    assert svc.requests == [(2, [7])]
    assert len(_QMessageBox.infos) == 1
    assert len(window.label.pixmaps) > 0 and window.label.pixmaps[-1].shape == FRAME_HW + (3,)
