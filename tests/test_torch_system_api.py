"""The rest of the port's SLAMSystem API against the JAX package, on the CPU:
a twin of tests/test_io_drivers.py::TestSystemAPI::test_global_ba_and_calibration
(global_bundle_adjust, change_calibration, get_tracked_keypoints). The
host-staged local map is tests/test_torch_host_staged.py.

The sequence (320x240, 800 features, 4 levels) is rendered once with the
JAX package's renderer and the identical arrays go to both packages.

Tolerances, and why: the first keyframe is the gauge of the global BA and
moves by less than 1e-6 in both packages (the JAX test's limit); the
packages' maps differ by float32 noise, so their keyframe centres after the
global BA agree within 1 cm, as tracked poses do (tests/test_torch_slice.py).
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, camera_centres

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=32, max_points=8192, local_point_cap=2048,
              min_init_features=300)


def _jax(**kw):
    return JSystem(jtracking.SLAMConfig(
        cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        JSensor.RGBD)


def _port(**kw):
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW, **kw),
        Sensor.RGBD, device="cpu")


@pytest.fixture(scope="module")
def gba():
    """TestSystemAPI's drive: 12 frames of the forward drive (seed 6), a
    keyframe every 4th frame, then a global BA in each package."""
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=13, trajectory="forward", seed=6)
    frames = [seq.render(i) for i in range(13)]
    out = {"frames": frames, "seq": seq}

    def run(name, system):
        for i in range(12):
            system.track_rgbd(*frames[i], i / seq.fps)
        system.wait_mapping_idle()
        m = system.map
        before = m.kf_pose.copy()
        change = m.change_index
        system.global_bundle_adjust()
        ids = m.keyframe_ids()
        out[name] = dict(system=system, before=before, ids=ids, after=m.kf_pose.copy(),
                         moved_index=m.change_index > change)

    beside(lambda: run("jax", _jax(max_frames_between_kf=5, force_kf_every=4)),
           lambda: run("torch", _port(max_frames_between_kf=5, force_kf_every=4)))
    yield out
    for name in ("jax", "torch"):
        out[name]["system"].shutdown()


def test_global_ba_keeps_the_gauge(gba):
    p = gba["torch"]
    assert len(p["ids"]) >= 3
    first = p["ids"][0]
    np.testing.assert_allclose(p["after"][first], p["before"][first], atol=1e-6)
    assert p["moved_index"]
    assert np.isfinite(p["after"][p["ids"]]).all()
    xy, tracked = p["system"].get_tracked_keypoints()
    assert xy.shape[1] == 2 and tracked.dtype == bool


def test_global_ba_matches_jax(gba):
    j, p = gba["jax"], gba["torch"]
    assert list(p["ids"]) == list(j["ids"])
    gap = np.linalg.norm(camera_centres(p["after"][p["ids"]])
                         - camera_centres(j["after"][j["ids"]]), axis=1)
    assert gap.max() < 0.01, gap


def test_change_calibration_reaches_every_part(gba):
    system = gba["torch"]["system"]
    frames, seq = gba["frames"], gba["seq"]
    cam = TCamera(**{**CAM_KW, "fx": 261.0})
    extractor = system.tracker.extractor
    system.change_calibration(cam)
    assert system.tracker.cam is cam and system.local_mapper.cam is cam
    assert system.cfg.cam is cam and system.tracker.cfg.cam is cam
    assert system.tracker.extractor is extractor       # same image size
    system.change_calibration(TCamera(**CAM_KW))
    system.track_rgbd(*frames[12], 12 / seq.fps)
    assert not system.tracker.trajectory_lost_mask()[-1]
    # a new image size builds an extractor for it
    system.change_calibration(TCamera(**{**CAM_KW, "width": 256, "cx": 128.0}))
    assert system.tracker.extractor.w == 256
