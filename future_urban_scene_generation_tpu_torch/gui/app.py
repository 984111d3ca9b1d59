"""Optional Qt GUI mirroring the reference's interaction model.

Counterpart of the JAX package's gui/app.py (:19-137). Parity target:
GUI/app_interface.py:23-341: frame navigation with arrow keys, click to preview a
vehicle's future trajectory, double-click to select vehicles, Backspace to reset the
selection, RUN to synthesize. The pipeline behind the RUN button is the same
``SceneService`` the headless CLI uses; the GUI is pure presentation and never
touches device code directly.

The preview is drawn by the web GUI's numpy helpers (``gui/web.annotate_frame``), so
boxes and the trajectory polyline appear without OpenCV. (The JAX window asks each
box to draw itself, which no box can, and draws the polyline only with cv2: without
it neither shows.)

PyQt5 is an optional dependency, imported inside ``launch_gui``; without it the call
raises ImportError and the CLI says so and exits 2.
"""
from __future__ import annotations


def launch_gui(cfg, exec_loop: bool = True):
    """Build and run the GUI. ``exec_loop=False`` returns the (app, window) pair
    without entering the Qt event loop, so that handler tests can drive events on
    the window directly (with a stub Qt where PyQt5 is absent)."""
    import sys

    from PyQt5 import QtCore, QtGui, QtWidgets

    from future_urban_scene_generation_tpu_torch.gui import web
    from future_urban_scene_generation_tpu_torch.pipeline import service as service_mod

    service = service_mod.SceneService(cfg)

    class MainWindow(QtWidgets.QMainWindow):
        def __init__(self):
            super().__init__()
            self.setWindowTitle("Future scene synthesis")
            self.frame_id = max(1, cfg.frame_id)
            self.selected_ids = []
            self.preview_id = None
            self.label = QtWidgets.QLabel()
            self.run_btn = QtWidgets.QPushButton("RUN")
            self.run_btn.clicked.connect(self.perform_test)
            central = QtWidgets.QWidget()
            layout = QtWidgets.QVBoxLayout(central)
            layout.addWidget(self.label)
            layout.addWidget(self.run_btn)
            self.setCentralWidget(central)
            self.refresh()

        def current_bboxes(self):
            return web.frame_boxes(service, self.frame_id, cfg.bbox_scale)

        def refresh(self):
            frame = service.reader.read(self.frame_id)
            if frame is None:
                return
            img = web.annotate_frame(service, frame, self.frame_id, cfg.bbox_scale,
                                     self.preview_id, self.selected_ids)
            self.image = img  # what the label shows, for callers without a display
            h, w, _ = img.shape
            qimg = QtGui.QImage(img.tobytes(), w, h, 3 * w, QtGui.QImage.Format_RGB888)
            self.label.setPixmap(QtGui.QPixmap.fromImage(qimg))

        def _vehicle_at(self, event):
            pos = self.label.mapFrom(self, event.pos())
            point = (pos.x(), pos.y())
            for vid, bbox in self.current_bboxes().items():
                if bbox.contains(point):
                    return vid
            return None

        def mousePressEvent(self, event):
            # Single click previews the clicked vehicle's future trajectory as a
            # mid-bottom polyline (GUI/app_interface.py:244-273).
            self.preview_id = self._vehicle_at(event)
            self.refresh()

        def mouseDoubleClickEvent(self, event):  # select vehicle
            vid = self._vehicle_at(event)
            if vid is not None and vid not in self.selected_ids:
                self.selected_ids.append(vid)
            self.refresh()

        def keyPressEvent(self, event):
            if event.key() == QtCore.Qt.Key_Backspace:
                self.selected_ids = []
            elif event.key() == QtCore.Qt.Key_Right:
                self.frame_id += 1
            elif event.key() == QtCore.Qt.Key_Left:
                self.frame_id = max(1, self.frame_id - 1)
            self.refresh()

        def perform_test(self):
            if not self.selected_ids:
                return
            paths = service.run_request(self.frame_id, self.selected_ids)
            QtWidgets.QMessageBox.information(
                self, "Done", "\n".join(str(p) for p in paths[:6])
            )

    app = QtWidgets.QApplication(sys.argv)
    window = MainWindow()
    window.show()
    if not exec_loop:
        return app, window
    return app.exec_()
