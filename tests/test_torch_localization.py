"""Localization mode in the port against the JAX package, on the CPU: twins
of tests/test_localization_vo.py::TestLocalizationVO and
tests/test_io_drivers.py::TestMapPersistence::test_save_load_and_relocalize.

The sequences (320x240, 800 features, 4 levels) are rendered with the JAX
package's renderer; the odometry drive's identical arrays go to both
packages. Both run with the JAX tests' settings (every other SLAMConfig field at its
default: the pipelined fetch and the mapping worker on).

Tolerances, and why: the JAX tests' own limits hold for the port (the map
frozen, at least 22 of 24 frames tracked, an RPE under 0.05 m a frame; the
relocalized pose within 0.05 m of the truth). Between the packages, on the
odometry drive: the same frames lost, and camera positions within 1 cm frame
by frame, since float32
noise in a pose moves a handful of associations at window and chi-square
edges (tests/test_torch_slice.py); odometry on temporal points integrates
that noise over the 24 frames.
"""
import dataclasses

import numpy as np
import pytest

from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import rpe
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_points=8192, local_point_cap=2048, min_init_features=300)
MAPPED, LOCALIZED = 6, 24


def _both(**kw):
    """-> {"jax": system, "torch": system} with the same settings."""
    return {
        "jax": JSystem(jtracking.SLAMConfig(
            cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4),
            **CFG_KW, **kw), JSensor.RGBD),
        "torch": SLAMSystem(ttracking.SLAMConfig(
            cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4),
            **CFG_KW, **kw), Sensor.RGBD, device="cpu")}


@pytest.fixture(scope="module")
def vo():
    """TestLocalizationVO: map 6 frames of the shuttle (cluttered world,
    seed 9), then 24 frames in localization mode beyond the mapped region."""
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=60, trajectory="shuttle",
                            seed=9, world="cluttered")
    frames = [seq.render(i) for i in range(MAPPED + LOCALIZED)]
    out = {"gt": np.stack([np.linalg.inv(seq.poses[i])
                           for i in range(MAPPED, MAPPED + LOCALIZED)])}
    def run(name, system):
        for i in range(MAPPED):
            system.track_rgbd(*frames[i], i / seq.fps)
        system.activate_localization_mode()
        m = system.map
        before = (m.n_points(), m.n_keyframes(), m.pt_pos.copy(), m.kf_pose.copy())
        vo_frames = 0
        for i in range(MAPPED, MAPPED + LOCALIZED):
            system.track_rgbd(*frames[i], i / seq.fps)
            vo_frames += system.tracker.mb_vo
        out[name] = dict(
            before=before, after=(m.n_points(), m.n_keyframes(), m.pt_pos.copy(),
                                  m.kf_pose.copy()),
            lost=system.tracker.trajectory_lost_mask()[MAPPED:],
            est=system.tracker.full_trajectory_twc()[MAPPED:], vo_frames=vo_frames)
        system.shutdown()

    systems = _both(max_keyframes=64, max_frames_between_kf=10)
    beside(lambda: run("jax", systems["jax"]), lambda: run("torch", systems["torch"]))
    return out


def test_localization_mode_freezes_the_map(vo):
    b, a = vo["torch"]["before"], vo["torch"]["after"]
    assert a[:2] == b[:2]
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])


def test_visual_odometry_beyond_the_mapped_region(vo):
    p = vo["torch"]
    assert int((~p["lost"]).sum()) >= 22, p["lost"]
    assert p["vo_frames"] > 0          # some frames ran on temporal points only
    t_rpe, _ = rpe(p["est"], vo["gt"])
    assert t_rpe < 0.05


def test_visual_odometry_matches_jax(vo):
    j, p = vo["jax"], vo["torch"]
    np.testing.assert_array_equal(p["lost"], j["lost"])
    gap = np.linalg.norm(p["est"][:, :3, 3] - j["est"][:, :3, 3], axis=1)
    assert gap.max() < 0.01, gap


def test_save_load_and_relocalize(tmp_path):
    """TestMapPersistence in the port, with its limits: map 10 frames of the
    lateral drive (seed 4), save the map, load it into a new system and, in
    localization mode, localize frame 2 through the reference keyframe."""
    seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=10, trajectory="lateral", seed=4)
    system = _both(max_keyframes=32)["torch"]
    for i in range(10):
        system.track_rgbd(*seq.render(i), i / seq.fps)
    path = str(tmp_path / "map.npz")
    system.save_map(path)
    other = SLAMSystem(dataclasses.replace(system.cfg), Sensor.RGBD, device="cpu")
    other.load_map(path)
    try:
        assert other.map.n_keyframes() == system.map.n_keyframes()
        assert other.map.n_points() == system.map.n_points()
        np.testing.assert_array_equal(other.map.kf_pose, system.map.kf_pose)
        other.activate_localization_mode()
        other.tracker.ref_kf = int(other.map.keyframe_ids()[0])
        tcw = other.track_rgbd(*seq.render(2), 99.0)
        assert tcw is not None and other.tracking_state().name == "OK"
        assert np.linalg.norm(tcw[:3, 3] - seq.poses[2][:3, 3]) < 0.05
        assert other.map.n_points() == system.map.n_points()   # frozen
    finally:
        other.shutdown()
        system.shutdown()
