"""The port's viewers against the JAX package's, on the CPU.

- ``viewer/headless.py``'s frame overlay, top-down and perspective map views
  on the same map (``test_viewer_live.py``'s, copied into the port with
  ``convert.map_state_from_numpy``) and the same trajectory, held to the JAX
  package's cv2 drawings pixel by pixel outside the status bar's text;
- ``io/jpeg.py`` decoded by ``cv2.imdecode`` against a PSNR bound, and
  ``io/png.py``'s files decoded exactly;
- ``LiveViewer`` (publishing JPEG) and ``HeadlessViewer`` (writing PNG) during
  one short port drive at ``test_viewer_live.py``'s 320x240, then the
  viewer's menu keys.
"""
import copy
import os
import types

import cv2
import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)
from orbslam2_tpu.viewer import headless as jheadless
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import jpeg, png
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
from orbslam2_tpu_torch.viewer import headless, raster
from orbslam2_tpu_torch.viewer.live import LiveViewer
from test_mapstate import make_map

CAM = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
# one-pixel lines, filled circles and rectangles are cv2's pixels exactly;
# two-pixel strokes (loop edges, the current camera's frustum) differ on
# their rims (viewer/raster.py), so a view with them is held to the share of
# the pixels drawn by either package that both draw alike
THICK_AGREE_MIN = 0.9
JPEG_PSNR_MIN_DB = 35.0        # quality 95, 4:4:4 (cv2's own 4:2:0: about 36 dB)
JPEG_DECODE_DIFF_MAX = 8       # grey levels between io/jpeg.py's reader and cv2's
RENDER_WAIT_S = 10.0           # a frame's render by the live viewer, at most
BAR = headless.STATUS_BAR_ROWS


def _share(a: np.ndarray, b: np.ndarray, background: int) -> float:
    """Of the pixels either image draws (not ``background``), the share
    where both images hold the same colour."""
    drawn = (a != background).any(axis=2) | (b != background).any(axis=2)
    return float((a == b).all(axis=2)[drawn].mean()) if drawn.any() else 1.0


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def maps():
    """test_viewer_live.py's map: six keyframes on a line, spanning-tree
    parents, 60 points seen by them; with and without a loop edge."""
    m, kfs, pts = make_map(n_kf=6, n_pts=60)
    rng = np.random.default_rng(0)
    for i, k in enumerate(kfs):
        m.kf_pose[k, :3, 3] = [0.4 * i, 0.0, 0.2 * (i % 2)]
        m.kf_parent[k] = kfs[i - 1] if i else -1
    for j, p in enumerate(pts):
        m.pt_pos[p] = rng.normal(size=3) + [1.0, 0.0, 3.0]
        m.kf_pt[kfs[j % len(kfs)], j % m.cap.n_features] = p
    m.touch_obs()
    traj = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    traj[:, 0, 3] = np.linspace(0, 2.4, 8)
    plain = convert.map_state_from_numpy(vars(m))
    m.kf_loop_edges[kfs[0]].add(kfs[-1])
    m.kf_loop_edges[kfs[-1]].add(kfs[0])
    return m, plain, convert.map_state_from_numpy(vars(m)), kfs, traj


def _hold(a: np.ndarray, b: np.ndarray, thick: bool) -> None:
    assert b.shape == a.shape == (640, 640, 3)
    assert (b != 255).any(axis=2).sum() > 30
    if thick:
        assert _share(a, b, 255) >= THICK_AGREE_MIN
    else:
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("loop", [False, True])
def test_topdown_matches_jax(maps, loop):
    jm, plain, pm, kfs, traj = maps
    if not loop:
        jm = copy.deepcopy(jm)
        jm.kf_loop_edges[kfs[0]].clear()
        jm.kf_loop_edges[kfs[-1]].clear()
    _hold(jheadless.draw_map_topdown(jm, traj),
          headless.draw_map_topdown(pm if loop else plain, traj), loop)


@pytest.mark.parametrize("nav", [None, dict(follow=True), dict(azim_deg=40.0, elev_deg=10.0),
                                 dict(zoom=0.4), dict(pan=(0.3, -0.2)),
                                 dict(show_points=False, show_graph=False)])
def test_map_3d_matches_jax(maps, nav):
    """With the loop edge and the current camera (two-pixel strokes), and
    without either (the JAX map's loop edge left out of the plain copy)."""
    jm, plain, pm, kfs, traj = maps
    cur = jm.kf_pose[kfs[-1]]
    jnav = None if nav is None else jheadless.ViewNav(**nav)
    pnav = None if nav is None else headless.ViewNav(**nav)
    _hold(jheadless.draw_map_3d(jm, traj, cur_tcw=cur, nav=jnav),
          headless.draw_map_3d(pm, traj, cur_tcw=cur, nav=pnav), True)
    if nav is None or not nav.get("follow"):
        bare = copy.deepcopy(jm)
        bare.kf_loop_edges[kfs[0]].clear()
        bare.kf_loop_edges[kfs[-1]].clear()
        _hold(jheadless.draw_map_3d(bare, traj, nav=jnav),
              headless.draw_map_3d(plain, traj, nav=pnav), False)


def test_map_3d_frusta_and_loop_edge(maps):
    """test_viewer_live.py's checks on the port: blue keyframe frusta, and
    red strokes where the loop edge is."""
    _, plain, pm, kfs, traj = maps
    img = headless.draw_map_3d(plain, traj, cur_tcw=plain.kf_pose[kfs[-1]])
    blue = (img[:, :, 0] == 200) & (img[:, :, 1] == 80) & (img[:, :, 2] == 0)
    assert blue.sum() > 50
    red = lambda x: ((x[:, :, 2] == 255) & (x[:, :, 0] == 0)).sum()
    assert red(img) == 0 and red(headless.draw_map_3d(pm, traj)) > 10


def test_frame_overlay_matches_jax():
    rng = np.random.default_rng(3)
    n = 400
    xy = rng.uniform(-5, 330, (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.9
    pt_ids = np.where(rng.random(n) < 0.6, np.arange(n), -1).astype(np.int32)
    outlier = rng.random(n) < 0.1
    gray = rng.uniform(-10, 270, (240, 320)).astype(np.float32)
    jframe = types.SimpleNamespace(kp=types.SimpleNamespace(xy=xy, valid=valid),
                                   pt_ids=pt_ids, is_outlier=outlier)
    host = types.SimpleNamespace(xy=xy, valid=valid)
    pframe = types.SimpleNamespace(host_kp=lambda: host, pt_ids=pt_ids, is_outlier=outlier)
    a = jheadless.draw_frame(gray, jframe, "OK", 4, 1234)
    b = headless.draw_frame(gray, pframe, "OK", 4, 1234)
    assert b.shape == a.shape == (240 + BAR, 320, 3)
    np.testing.assert_array_equal(b[:240], a[:240])     # primitives: cv2's pixels
    bar = b[240:]
    assert (bar > 0).any() and bar[:, :3].max() == 0    # text, left margin empty
    assert headless.draw_frame(gray, None, "NO_IMAGES_YET").shape == (240, 320, 3)


@pytest.mark.parametrize("shape", [(240, 320, 3), (260, 320, 3), (37, 29, 3), (45, 70)])
def test_jpeg_decodes(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    smooth = (np.sin(xx / 9.0) * 60 + np.cos(yy / 7.0) * 50 + 128).astype(np.uint8)
    img = np.stack([smooth, smooth[::-1], smooth[:, ::-1]], -1) if len(shape) == 3 else smooth
    raster.line(img, (2, 3), (shape[1] - 1, shape[0] - 2), (0, 0, 255) if img.ndim == 3 else 0)
    data = jpeg.encode(img)
    dec = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    assert dec.shape == img.shape
    assert _psnr(img, dec) >= JPEG_PSNR_MIN_DB
    # the port's own reader (chip_smoke.py's check where no OpenCV is): libjpeg's
    # fixed-point inverse DCT and colour conversion round otherwise
    mine = jpeg.decode(data)
    assert mine.shape == img.shape
    assert np.abs(mine.astype(np.int64) - dec).max() <= JPEG_DECODE_DIFF_MAX
    assert _psnr(img, mine) >= JPEG_PSNR_MIN_DB
    noise = rng.integers(0, 256, shape).astype(np.uint8)   # every AC coefficient busy
    dec = cv2.imdecode(np.frombuffer(jpeg.encode(noise), np.uint8), cv2.IMREAD_UNCHANGED)
    assert dec.shape == noise.shape and _psnr(noise, dec) >= 30.0


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """Ten frames of test_viewer_live.py's drive on the port, with a live
    viewer publishing JPEG and a headless one writing PNG."""
    out = tmp_path_factory.mktemp("viewer")
    cfg = SLAMConfig(cam=CAM, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                     max_keyframes=32, max_points=4096, local_point_cap=1024,
                     min_init_features=300)
    system = SLAMSystem(cfg, Sensor.RGBD, device="cpu")
    live = LiveViewer(system, fps=60, map_every=2, out_dir=str(out), use_gui=False)
    offline = headless.HeadlessViewer(system, out_dir=str(out / "viz"), map_every=2)
    seq = SyntheticSequence(CAM, n_frames=10, trajectory="lateral", seed=2)
    frames = []
    for i in range(seq.n_frames):
        gray, depth = seq.render(i)
        system.track_rgbd(gray, depth, i / seq.fps)
        live.push_frame(gray)
        frames.append(offline.update(gray))
        # the render thread draws the frame pushed last; each frame waits for
        # its render (it draws at 60 Hz, far inside the bound)
        assert live.wait_rendered(i + 1, RENDER_WAIT_S), (i, live.n_rendered)
    live.close()
    yield system, live, frames, out
    system.shutdown()


def test_live_viewer_publishes_jpeg(drive):
    _, live, _, out = drive
    assert live.n_rendered >= 3, live.n_rendered
    assert not live._thread.is_alive()
    assert live.last_frame_img.shape == (CAM.height + BAR, CAM.width, 3)
    assert live.last_map_img.shape == (640, 640, 3)
    assert len(live.render_ms) == live.n_rendered
    frame = cv2.imread(str(out / "latest_frame.jpg"), cv2.IMREAD_COLOR)
    assert frame.shape == live.last_frame_img.shape
    assert _psnr(frame, live.last_frame_img) >= JPEG_PSNR_MIN_DB
    assert cv2.imread(str(out / "latest_map.jpg")).shape == (640, 640, 3)
    assert not [f for f in os.listdir(out) if f.endswith(".tmp")]


def test_headless_viewer_writes_png(drive):
    system, _, frames, out = drive
    assert frames[-1].shape == (CAM.height + BAR, CAM.width, 3)
    tracked = (system.tracker.last_frame.pt_ids >= 0).sum()
    assert (frames[-1][:CAM.height] == (0, 255, 0)).all(axis=2).sum() > 8 * min(tracked, 50)
    np.testing.assert_array_equal(cv2.imread(str(out / "viz" / "frame_000009.png")), frames[-1])
    np.testing.assert_array_equal(png.imread(str(out / "viz" / "frame_000009.png")), frames[-1])
    top = cv2.imread(str(out / "viz" / "map_000008.png"))
    assert top.shape == (640, 640, 3) and (top < 250).any()


def test_viewer_menu_keys(drive):
    """The reference GUI's menu (Viewer.cc:69-75, 139-148) through the key
    handler: localization mode on and off, the three show toggles, reset."""
    system, live, _, _ = drive
    assert not system.cfg.localization_only
    live._handle_key(ord("l"))
    assert system.cfg.localization_only and system.tracker.cfg.localization_only
    live._handle_key(ord("l"))
    assert not system.cfg.localization_only
    full = headless.draw_map_3d(system.map)
    for key, attr in (("p", "show_points"), ("k", "show_keyframes"), ("g", "show_graph")):
        assert getattr(live.nav, attr)
        live._handle_key(ord(key))
        assert not getattr(live.nav, attr)
    bare = headless.draw_map_3d(system.map, nav=live.nav)
    assert (full != 255).any(axis=2).sum() > (bare != 255).any(axis=2).sum()
    assert system.map.n_keyframes() > 0
    live._handle_key(ord("c"))
    assert system.map.n_keyframes() == 0
