"""The port's ROS-style nodes and the live and ROS drivers on the CPU (the
AR overlay and its driver are in test_torch_ar.py).

- ``ApproxTimeSync``'s pairings held exactly to the JAX package's on the
  same inputs (both are numpy);
- ``RGBDNode`` publishing, through a ``LocalTopicBus``, the poses that
  ``track_rgbd`` called directly gives on the same frames;
- the mains of ``examples/ros_demo.py`` and ``live_camera.py`` at small
  size; the webcam is a stand-in ``cv2`` module
  whose capture yields rendered frames.
"""
import os
import sys
import types

import numpy as np
import pytest

from torch_port_helpers import beside
from orbslam2_tpu.io import ros_nodes as jros
from orbslam2_tpu_torch.examples import live_camera, ros_demo
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import ros_nodes
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
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
