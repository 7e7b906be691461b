"""The slice as a whole: RGB-D tracking through the port's SLAMSystem against
the JAX package's Tracker, on the CPU.

Each sequence (320x240, 800 features, 4 levels, 25 frames, as
tests/test_e2e_rgbd.py) is rendered once with the JAX package's renderer and
the identical arrays go to both systems. Both are SLAMSystems with local
mapping run inline at each keyframe (async_mapping=False), no vocabulary and
a synchronous fetch. One system of each package serves both sequences, with
a reset between them, so the reset path is part of what is compared.

Tolerances: float32 noise in a pose moves a handful of associations at window
and chi-square edges, and the keyframe decision compares inlier counts with
thresholds, so per-frame camera positions must agree within 1 cm (measured:
under 2 mm), keyframe counts within 1, and each ATE must be under 0.05 m.
"""
import numpy as np
import pytest

from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.evaluate import ate_rmse as jate
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io import evaluate as tevaluate
from orbslam2_tpu_torch.io.trajectory import load_tum
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

import torch_port_helpers  # noqa: F401  (caps torch's intra-op threads)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=64, max_points=8192, local_point_cap=2048,
              max_frames_between_kf=10, min_init_features=300,
              async_mapping=False, pipelined_fetch=False)
N_FRAMES = 25
SEQUENCES = ("lateral", "forward")


def _drive(track, frames):
    return [track(g, d, i / 30.0) for i, (g, d) in enumerate(frames)]


@pytest.fixture(scope="module")
def runs():
    jcam, tcam = JCamera(**CAM_KW), TCamera(**CAM_KW)
    jsystem = JSystem(jtracking.SLAMConfig(
        cam=jcam, orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW), JSensor.RGBD)
    jtr = jsystem.tracker
    system = SLAMSystem(ttracking.SLAMConfig(
        cam=tcam, orb=TORBConfig(n_features=800, n_levels=4), **CFG_KW),
        Sensor.RGBD, device="cpu")
    out = {"system": system}
    for k, name in enumerate(SEQUENCES):
        seq = SyntheticSequence(jcam, n_frames=N_FRAMES, trajectory=name, seed=1)
        frames = [seq.render(i) for i in range(N_FRAMES)]
        if k:
            jsystem.reset()
            system.reset()
            assert system.map.n_keyframes() == 0
            assert system.tracking_state() == ttracking.TrackingState.NOT_INITIALIZED
        ret_j = _drive(jtr.track_rgbd, frames)
        ret_t = _drive(system.track_rgbd, frames)
        sl = slice(k * N_FRAMES, (k + 1) * N_FRAMES)
        out[name] = dict(
            gt=np.stack([np.linalg.inv(p) for p in seq.poses]),
            ret_j=ret_j, ret_t=ret_t,
            est_j=jtr.full_trajectory_twc()[sl], est_t=system.tracker.full_trajectory_twc()[sl],
            lost_j=jtr.trajectory_lost_mask()[sl], lost_t=system.tracker.trajectory_lost_mask()[sl],
            kf_j=jtr.map.n_keyframes(), kf_t=system.map.n_keyframes(),
            pts_j=jtr.map.n_points(), pts_t=system.map.n_points(),
            mapped=system.local_mapper.counts.copy())
    return out


@pytest.mark.parametrize("name", SEQUENCES)
def test_no_frame_is_lost_in_either(runs, name):
    r = runs[name]
    assert all(x is not None for x in r["ret_j"])
    assert all(x is not None for x in r["ret_t"])
    assert not r["lost_j"].any() and not r["lost_t"].any()
    assert r["ret_t"][-1].shape == (4, 4) and r["ret_t"][-1].dtype == np.float32


@pytest.mark.parametrize("name", SEQUENCES)
def test_same_keyframes_and_map_size(runs, name):
    r = runs[name]
    assert r["kf_t"] >= 1 and abs(r["kf_t"] - r["kf_j"]) <= 1
    if r["kf_t"] >= 2:   # a keyframe after the first was mapped
        done = r["mapped"]
        assert done["points_created"] + done["obs_fused"] + done["points_merged"] > 0, done
    if r["kf_t"] == r["kf_j"]:
        assert abs(r["pts_t"] - r["pts_j"]) <= 0.02 * r["pts_j"]


@pytest.mark.parametrize("name", SEQUENCES)
def test_per_frame_position_matches_jax(runs, name):
    r = runs[name]
    gap = np.linalg.norm(r["est_t"][:, :3, 3] - r["est_j"][:, :3, 3], axis=1)
    assert gap.max() < 0.01, gap
    # and per returned pose (Tcw), frame by frame
    for a, b in zip(r["ret_t"], r["ret_j"]):
        assert np.abs(a - b).max() < 0.01


@pytest.mark.parametrize("name", SEQUENCES)
def test_ate_against_ground_truth(runs, name):
    r = runs[name]
    assert jate(r["est_j"], r["gt"]) < 0.05
    ate = tevaluate.ate_rmse(r["est_t"], r["gt"])
    assert ate < 0.05
    assert ate == pytest.approx(jate(r["est_t"], r["gt"]))     # the port's own copy
    t_rpe, r_rpe = tevaluate.rpe(r["est_t"], r["gt"])
    assert t_rpe < 0.03 and r_rpe < 0.02


def test_trajectory_savers(runs, tmp_path):
    system = runs["system"]
    tum, kitti, kf = (str(tmp_path / f) for f in ("t.txt", "k.txt", "kf.txt"))
    system.save_trajectory_tum(tum)
    system.save_trajectory_kitti(kitti)
    system.save_keyframe_trajectory_tum(kf)
    ts, twc = load_tum(tum)
    n_all = len(SEQUENCES) * N_FRAMES
    assert len(ts) == n_all and twc.shape == (n_all, 4, 4)
    np.testing.assert_allclose(twc[-N_FRAMES:, :3, 3], runs["forward"]["est_t"][:, :3, 3],
                               atol=1e-5)
    np.testing.assert_allclose(twc[-1, :3, :3], runs["forward"]["est_t"][-1, :3, :3],
                               atol=1e-4)
    assert np.loadtxt(kitti).shape == (n_all, 12)
    assert np.loadtxt(kf).reshape(-1, 8).shape[0] == system.map.n_keyframes()


def test_system_accessors_and_map_roundtrip(runs, tmp_path):
    system = runs["system"]
    assert system.tracking_state() == ttracking.TrackingState.OK
    ids = system.get_tracked_points()
    xy, tracked = system.get_tracked_keypoints()
    assert len(ids) >= 30 and xy.shape == (800, 2) and tracked.sum() == len(ids)
    assert system.map.pt_valid[ids].all()
    path = str(tmp_path / "map.npz")
    system.save_map(path)
    other = SLAMSystem(system.cfg, Sensor.RGBD, device="cpu")
    other.load_map(path)
    assert other.map.n_points() == system.map.n_points()
    assert other.tracking_state() == ttracking.TrackingState.LOST
    system.shutdown()


def test_unported_sensors_and_modes_are_refused():
    """Every sensor is ported: a vocabulary builds the database and the loop
    closer (fixed scale for RGB-D and stereo, Sim3 with scale for mono), a
    monocular system has a monocular local mapper and a worker that maps
    each keyframe inline. What is still refused is a track call of another
    sensor's images."""
    import dataclasses
    cfg = ttracking.SLAMConfig(cam=TCamera(**CAM_KW), **CFG_KW)
    voc = get_default_vocabulary()
    systems = [SLAMSystem(cfg, sensor, vocabulary=voc, device="cpu")
               for sensor in (Sensor.RGBD, Sensor.STEREO)]
    mono = SLAMSystem(dataclasses.replace(cfg, async_mapping=True), Sensor.MONOCULAR,
                      vocabulary=voc, device="cpu")
    system = SLAMSystem(cfg, Sensor.RGBD, device="cpu")
    systems += [mono, system]
    try:
        for with_voc in systems[:2]:
            assert with_voc.kfdb is not None and with_voc.loop_closer is not None
            assert with_voc.loop_closer.cfg.fix_scale
            assert not with_voc.local_mapper.cfg.monocular
        assert mono.loop_closer.cfg.fix_scale is False
        assert mono.local_mapper.cfg.monocular
        assert mono.mapping_worker.sync_mapping and mono.mapping_worker.idle()
        # localization mode is ported: the switch goes both ways
        system.activate_localization_mode()
        assert system.tracker.cfg.localization_only
        system.deactivate_localization_mode()
        assert not system.tracker.cfg.localization_only
        # each sensor takes its own images only
        with pytest.raises(ValueError, match="RGBD"):
            system.track_monocular(None, 0.0)
        with pytest.raises(ValueError, match="RGBD"):
            system.track_stereo(None, None, 0.0)
        with pytest.raises(ValueError, match="STEREO"):
            systems[1].track_rgbd(None, None, 0.0)
        with pytest.raises(ValueError, match="MONOCULAR"):
            mono.track_stereo(None, None, 0.0)
    finally:
        for s in systems:
            s.shutdown()


def test_config_defaults_are_the_jax_package_defaults():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(jtracking.SLAMConfig)
          if f.name not in ("cam", "orb")}
    tf = {f.name: f.default for f in dataclasses.fields(ttracking.SLAMConfig)
          if f.name not in ("cam", "orb")}
    assert jf == tf
    assert [s.name for s in Sensor] == ["MONOCULAR", "STEREO", "RGBD"]
