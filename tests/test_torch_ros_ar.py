"""The port's ROS-style nodes, AR overlay and the live, ROS and AR drivers
on the CPU.

- ``ApproxTimeSync``'s pairings and ``detect_plane``'s plane and inliers,
  held exactly to the JAX package's on the same inputs (both are numpy);
- ``RGBDNode`` publishing, through a ``LocalTopicBus``, the poses that
  ``track_rgbd`` called directly gives on the same frames;
- the mains of ``examples/ros_demo.py``, ``ar_demo.py`` and
  ``live_camera.py`` at small size; the webcam is a stand-in ``cv2`` module
  whose capture yields rendered frames.
"""
import os
import sys
import types

import cv2
import numpy as np
import pytest

from torch_port_helpers import beside
from orbslam2_tpu.io import ros_nodes as jros
from orbslam2_tpu.viewer import ar as jar
from orbslam2_tpu_torch.examples import ar_demo, live_camera, ros_demo
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import ros_nodes
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
from orbslam2_tpu_torch.viewer import ar
from test_io_drivers import SETTINGS_YAML

CAM = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
POSE_ERR_MAX = 0.05            # test_ros_ar.py's


def _pairs(module, events, slop):
    """Publish ``events`` ((topic, stamp), ...) through ``module``'s bus and
    synchroniser. -> the (a, b) stamp pairs in the order they were made."""
    bus = module.LocalTopicBus()
    out = []
    module.ApproxTimeSync(bus, "/a", "/b", lambda a, b: out.append((a.stamp, b.stamp)),
                          slop=slop, queue=4)
    for topic, stamp in events:
        bus.publish(topic, module.ImageMsg(np.zeros((2, 2)), stamp))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_approx_time_sync_matches_jax(seed):
    rng = np.random.default_rng(seed)
    events = [("/a" if rng.random() < 0.5 else "/b", float(t))
              for t in np.round(np.cumsum(rng.uniform(0, 0.04, 60)), 4)]
    pairs = _pairs(ros_nodes, events, 0.02)
    assert pairs and pairs == _pairs(jros, events, 0.02)
    # test_ros_ar.py's scenario
    script = [("/a", 0.00), ("/b", 0.20), ("/b", 0.03), ("/a", 0.21)]
    assert _pairs(ros_nodes, script, 0.05) == [(0.00, 0.03), (0.21, 0.20)]


def _floor(seed, n=200, outliers=60):
    """test_ros_ar.py's plane z = 2 + 0.1x - 0.2y with noise and outliers."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)
    pts = np.stack([x, y, 2 + 0.1 * x - 0.2 * y + rng.normal(0, 0.003, n)], axis=1)
    pts[:outliers] += rng.uniform(0.3, 1.0, (outliers, 3))
    return pts


@pytest.mark.parametrize("seed,min_inliers", [(0, 50), (1, 50), (2, 30), (3, 190)])
def test_detect_plane_matches_jax(seed, min_inliers):
    pts = _floor(seed)
    got = ar.detect_plane(pts, threshold=0.02, min_inliers=min_inliers, seed=seed)
    want = jar.detect_plane(pts, threshold=0.02, min_inliers=min_inliers, seed=seed)
    if want is None:
        assert got is None
        return
    for f in ("normal", "origin", "t_pw", "inliers"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.n_inliers == want.n_inliers >= 120
    expected = np.array([0.1, -0.2, -1.0]) / np.linalg.norm([0.1, -0.2, -1.0])
    assert abs(float(got.normal @ expected)) > 0.999


def test_draw_cube_matches_jax():
    plane = ar.detect_plane(_floor(0), threshold=0.02, min_inliers=50, seed=1)
    jplane = jar.detect_plane(_floor(0), threshold=0.02, min_inliers=50, seed=1)
    gray = np.random.default_rng(0).uniform(0, 255, (240, 320)).astype(np.float32)
    tcw = np.eye(4, dtype=np.float32)
    tcw[:3, 3] = [0.1, -0.2, 0.5]
    from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
    a = jar.draw_cube(gray, tcw, JCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320,
                                         height=240, bf=26.0), jplane, size=0.3)
    b = ar.draw_cube(gray, tcw, CAM, plane, size=0.3)
    base = np.repeat(gray.astype(np.uint8)[:, :, None], 3, axis=2)
    drawn = (a != base).any(axis=2) | (b != base).any(axis=2)
    assert drawn.sum() > 100
    # two-pixel strokes: viewer/raster.py covers most of cv2's pixels
    assert (a == b).all(axis=2)[drawn].mean() > 0.8


def _rgbd_config():
    return SLAMConfig(cam=CAM, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                      min_init_features=300, pipelined_fetch=False, async_mapping=False)


def test_rgbd_node_publishes_the_direct_poses():
    seq = SyntheticSequence(CAM, n_frames=8, trajectory="lateral", seed=3)
    frames = [seq.render(i) for i in range(seq.n_frames)]
    direct = SLAMSystem(_rgbd_config(), Sensor.RGBD, device="cpu")
    system = SLAMSystem(_rgbd_config(), Sensor.RGBD, device="cpu")
    want, (node, poses) = beside(
        lambda: [direct.track_rgbd(g, d, i / seq.fps) for i, (g, d) in enumerate(frames)],
        lambda: ros_demo.replay(system, frames, seq.fps))
    direct.shutdown()
    system.shutdown()
    assert node.frames == node.tracked == len(poses) == seq.n_frames
    assert [p.stamp for p in poses] == [i / seq.fps for i in range(seq.n_frames)]
    for p, w in zip(poses, want):
        np.testing.assert_array_equal(p.tcw, w)
    assert np.linalg.norm(poses[-1].tcw[:3, 3] - seq.poses[-1][:3, 3]) < POSE_ERR_MAX


def test_ros_demo_main():
    system, node, poses = ros_demo.main(["--frames", "5", "--device", "cpu"])
    assert node.frames == 5 and node.tracked >= 4 and len(poses) == node.tracked
    assert system.vocabulary is not None and poses[-1].tcw.shape == (4, 4)


def test_ar_demo_main(tmp_path):
    system, viewer = ar_demo.main(["--frames", "5", "--out", str(tmp_path), "--device", "cpu"])
    assert viewer.plane is not None and viewer.plane.n_inliers >= 30
    files = sorted(os.listdir(tmp_path))
    assert files == [f"ar_{i:04d}.png" for i in range(5)]
    last = cv2.imread(str(tmp_path / files[-1]))
    assert last.shape == (240, 320, 3)
    assert (last == (0, 255, 0)).all(axis=2).sum() > 50     # the cube's green strokes


class _FakeCapture:
    """cv2.VideoCapture of the first 12 frames of test_e2e_mono.py's
    lateral drive (BGR uint8)."""

    def __init__(self, index):
        self.index = index
        self.seq = SyntheticSequence(CAM, n_frames=40, trajectory="lateral", seed=5)
        self.seq.n_frames = 12
        self.i = 0
        self.released = False

    def isOpened(self):
        return self.index == 0

    def read(self):
        if self.i >= self.seq.n_frames:
            return False, None
        gray = np.clip(np.round(self.seq.render(self.i)[0]), 0, 255).astype(np.uint8)
        self.i += 1
        return True, np.repeat(gray[:, :, None], 3, axis=2)

    def release(self):
        self.released = True


def test_live_camera_main(tmp_path, monkeypatch):
    captures = []

    def video_capture(index):
        captures.append(_FakeCapture(index))
        return captures[-1]

    monkeypatch.setitem(sys.modules, "cv2", types.SimpleNamespace(VideoCapture=video_capture))
    settings = tmp_path / "settings.yaml"
    settings.write_text(SETTINGS_YAML)
    out = ["--trajectory-out", str(tmp_path / "t.txt"),
           "--kf-trajectory-out", str(tmp_path / "k.txt")]
    system, _ = live_camera.main([str(settings), "--camera-index", "0", "--device", "cpu",
                                  "--no-loop-closing", *out])
    assert captures[0].released and captures[0].i == 12
    assert system.tracker.frame_counter == 12
    assert (~system.tracker.trajectory_lost_mask()).sum() >= 4     # initialised
    assert os.path.getsize(tmp_path / "t.txt") > 0
    with pytest.raises(RuntimeError, match="camera 3"):
        live_camera.main([str(settings), "--camera-index", "3", "--device", "cpu",
                          "--no-loop-closing", *out])
