"""Live viewer: a real-time render loop over the headless renderers.

Counterpart of ``orbslam2_tpu/viewer/live.py``, the functional re-design of
the reference's Pangolin viewer thread (Viewer.cc:54-196: a loop of about
30 Hz drawing FrameDrawer::DrawFrame into one window and MapDrawer into
another). Where a display and OpenCV's HighGUI exist, it shows two cv2
windows; without them (a headless host, the card's machine, CI) the loop
publishes the latest renders to disk, ``latest_frame.jpg`` and
``latest_map.jpg``, each written to a temporary file and renamed into place
so that a dashboard polling them never reads half a file. The JPEG files
come from the port's own encoder (``io/jpeg.py``); the drawing is
``viewer/headless.py``'s. The render cadence and the thread's life (start,
request finish, join; Viewer.cc:198-230) are the same in both modes.

The viewer never blocks tracking: it samples the latest pushed frame and
reads tracker and map state under the tracker's map lock.
"""
from __future__ import annotations

import importlib.util
import os
import threading
import time
from typing import Optional

import numpy as np

from orbslam2_tpu_torch.io import jpeg
from orbslam2_tpu_torch.viewer.headless import ViewNav, draw_frame, draw_map_3d, draw_map_topdown


class LiveViewer:
    """Background render loop. Usage:

    >>> viewer = LiveViewer(system)            # starts the thread
    >>> for gray, depth, ts in frames:
    ...     system.track_rgbd(gray, depth, ts)
    ...     viewer.push_frame(gray)
    >>> viewer.close()
    """

    def __init__(self, system, fps: float = 30.0, map_every: int = 10,
                 window: str = "orbslam2-tpu", out_dir: Optional[str] = None,
                 use_gui: Optional[bool] = None, map_3d: bool = True):
        self.system = system
        self.fps = fps
        self.map_every = map_every
        self.map_3d = map_3d  # perspective frusta view vs top-down 2D
        self.window = window
        self.out_dir = out_dir or "."
        self._latest: Optional[np.ndarray] = None
        self._latest_id = -1
        self._drawn_id = -1
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rendered = threading.Condition()
        self.n_rendered = 0
        self.last_frame_img: Optional[np.ndarray] = None
        self.last_map_img: Optional[np.ndarray] = None
        self.render_ms: list = []   # host time of each render and its publication
        if use_gui is None:
            # a window needs a display and OpenCV's HighGUI; otherwise publish
            use_gui = bool(os.environ.get("DISPLAY")) and \
                importlib.util.find_spec("cv2") is not None
        self._gui = use_gui
        # interactive navigation state (Viewer.cc:116-196 analogue):
        # mouse-drag orbit, wheel zoom, right-drag pan; keys f=follow
        # camera, t=top-down, r=reset, arrows orbit, +/- zoom
        self.nav = ViewNav(topdown=not map_3d)
        self._mouse_state = None
        self._windows_ready = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="live-viewer")
        self._thread.start()

    # ------------------------------------------------------------------
    def push_frame(self, gray: np.ndarray) -> None:
        """Hand the viewer the latest input image (cheap; copies once)."""
        with self._lock:
            self._latest = np.asarray(gray, np.float32).copy()
            self._latest_id += 1

    def wait_rendered(self, count: int, timeout: float) -> bool:
        """Wait until ``count`` frames have been rendered, at most
        ``timeout`` seconds. -> whether they have."""
        with self._rendered:
            return self._rendered.wait_for(lambda: self.n_rendered >= count, timeout)

    def close(self) -> None:
        """Viewer::RequestFinish + join (Viewer.cc:198-216)."""
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._gui:
            try:
                import cv2
                cv2.destroyWindow(self.window)
                cv2.destroyWindow(self.window + " map")
            except Exception:
                pass

    # ------------------------------------------------------------------
    def _run(self) -> None:
        period = 1.0 / max(self.fps, 1.0)
        while not self._stop.is_set():
            t0 = time.time()
            with self._lock:
                gray = self._latest
                fid = self._latest_id
            if gray is None or fid == self._drawn_id:
                time.sleep(period)
                continue
            self._drawn_id = fid
            try:
                self._render_once(gray)
                self.render_ms.append((time.time() - t0) * 1e3)
            except Exception:  # never kill the app from the viewer
                import traceback
                traceback.print_exc()
                time.sleep(period)
            dt = time.time() - t0
            if dt < period:
                time.sleep(period - dt)

    def _render_once(self, gray: np.ndarray) -> None:
        tr = self.system.tracker
        with tr.map_lock:
            img = draw_frame(gray, tr.last_frame, tr.state.name,
                             self.system.map.n_keyframes(),
                             self.system.map.n_points())
            map_img = None
            if self.n_rendered % self.map_every == 0:
                traj = tr.full_trajectory_twc(wait=False) \
                    if tr.trajectory else None
                if not self.nav.topdown:
                    cur = tr.last_frame.tcw if tr.last_frame is not None \
                        else None
                    map_img = draw_map_3d(self.system.map, traj, cur_tcw=cur,
                                          covis_w=tr._covis_w, nav=self.nav)
                else:
                    map_img = draw_map_topdown(self.system.map, traj)
        self.last_frame_img = img
        if map_img is not None:
            self.last_map_img = map_img
        if self._gui:
            self._show(img, map_img)
        else:
            self._publish(img, map_img)
        with self._rendered:
            self.n_rendered += 1
            self._rendered.notify_all()

    def _on_mouse(self, event, x, y, flags, _param) -> None:
        """Pangolin-style orbit/pan/zoom on the map window."""
        import cv2
        if event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN):
            self._mouse_state = (event, x, y)
        elif event in (cv2.EVENT_LBUTTONUP, cv2.EVENT_RBUTTONUP):
            self._mouse_state = None
        elif event == cv2.EVENT_MOUSEMOVE and self._mouse_state is not None:
            btn, x0, y0 = self._mouse_state
            dx, dy = x - x0, y - y0
            if btn == cv2.EVENT_LBUTTONDOWN:   # drag: orbit
                self.nav.azim_deg = (self.nav.azim_deg + 0.4 * dx) % 360
                self.nav.elev_deg = float(
                    np.clip(self.nav.elev_deg + 0.4 * dy, -89, 89))
            else:                               # right-drag: pan
                px, py = self.nav.pan
                self.nav.pan = (px - 0.003 * dx, py - 0.003 * dy)
            self._mouse_state = (btn, x, y)
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.nav.zoom = float(np.clip(
                self.nav.zoom * (0.9 if flags > 0 else 1.1), 0.05, 20.0))

    def _handle_key(self, key: int) -> None:
        """Key map — nav keys plus the reference viewer's menu surface
        (Viewer.cc:69-75,139-148): l = Localization
        Mode toggle (ActivateLocalizationMode / Deactivate), c = Reset
        the SLAM system, p/k/g = Show Points / KeyFrames / Graph."""
        nav = self.nav
        if key in (ord("f"), ord("F")):
            nav.follow = not nav.follow           # Follow Camera toggle
        elif key in (ord("t"), ord("T")):
            nav.topdown = not nav.topdown
        elif key in (ord("l"), ord("L")):         # menuLocalizationMode
            if self.system.cfg.localization_only:
                self.system.deactivate_localization_mode()
            else:
                self.system.activate_localization_mode()
        elif key in (ord("c"), ord("C")):         # menuReset (Viewer.cc:139)
            self.system.reset()
        elif key in (ord("p"), ord("P")):         # menuShowPoints
            nav.show_points = not nav.show_points
        elif key in (ord("k"), ord("K")):         # menuShowKeyFrames
            nav.show_keyframes = not nav.show_keyframes
        elif key in (ord("g"), ord("G")):         # menuShowGraph
            nav.show_graph = not nav.show_graph
        elif key in (ord("r"), ord("R")):
            nav.reset()
        elif key in (ord("+"), ord("=")):
            nav.zoom = max(nav.zoom * 0.8, 0.05)
        elif key in (ord("-"), ord("_")):
            nav.zoom = min(nav.zoom * 1.25, 20.0)
        elif key == 81:   # left arrow
            nav.azim_deg -= 10
        elif key == 83:   # right arrow
            nav.azim_deg += 10
        elif key == 82:   # up arrow
            nav.elev_deg = min(nav.elev_deg + 8, 89)
        elif key == 84:   # down arrow
            nav.elev_deg = max(nav.elev_deg - 8, -89)

    def _show(self, img, map_img) -> None:
        import cv2
        try:
            if not self._windows_ready:
                cv2.namedWindow(self.window)
                cv2.namedWindow(self.window + " map")
                cv2.setMouseCallback(self.window + " map", self._on_mouse)
                self._windows_ready = True
            cv2.imshow(self.window, img)
            if map_img is not None:
                cv2.imshow(self.window + " map", map_img)
            key = cv2.waitKey(1)
            if key >= 0:
                self._handle_key(key & 0xFF)
        except cv2.error:
            # display went away: degrade to file publishing
            self._gui = False
            self._publish(img, map_img)

    def _publish(self, img, map_img) -> None:
        jpeg.imwrite_atomic(os.path.join(self.out_dir, "latest_frame.jpg"), img)
        if map_img is not None:
            jpeg.imwrite_atomic(os.path.join(self.out_dir, "latest_map.jpg"), map_img)
