"""Localization mode in the port against the JAX package, on the CPU: twins
of tests/test_localization_vo.py::TestLocalizationVO and
tests/test_io_drivers.py::TestMapPersistence::test_save_load_and_relocalize.

The sequences (320x240, 800 features, 4 levels) are rendered with the JAX
package's renderer; the odometry drive's identical arrays go to both
packages. Both run with the JAX tests' settings (every other SLAMConfig field at its
default: the pipelined fetch and the mapping worker on).

Tolerances, and why: the JAX tests' own limits hold for the port (the map
frozen, at least 22 of 24 frames tracked, an RPE under 0.05 m a frame; the
relocalized pose within 0.05 m of the truth).

After the measured 24 frames the drive goes on to frame 44, where the
camera comes back into view of the map; copies of both trackers
(torch_port_helpers.fork_tracker) after frame 14 and after frame 44 show
where a relocalization supplies a frame's associations: the port stages no
temporal point of the motion model in the local-map stage then, as
ORB-SLAM2 does; the JAX package does (a divergence, ROADMAP.md). Between the packages, on the
odometry drive: the same frames lost, and camera positions within 1 cm frame
by frame, since float32
noise in a pose moves a handful of associations at window and chi-square
edges (tests/test_torch_slice.py); odometry on temporal points integrates
that noise over the 24 frames.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jkernels, tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import SLAMSystem as JSystem, Sensor as JSensor
from orbslam2_tpu_torch.frontend import kernels as tkernels, tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import rpe
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, fork_tracker, n

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_points=8192, local_point_cap=2048, min_init_features=300)
MAPPED, LOCALIZED = 6, 24
FORK_VO, FORK_BACK = 14, 44   # last frames before the relocalization cases


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
    frames = [seq.render(i) for i in range(FORK_BACK + 2)]
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
            if i == FORK_VO:
                fork_vo = fork_tracker(system.tracker)
        out[name] = dict(
            before=before, after=(m.n_points(), m.n_keyframes(), m.pt_pos.copy(),
                                  m.kf_pose.copy()),
            lost=system.tracker.trajectory_lost_mask()[MAPPED:],
            est=system.tracker.full_trajectory_twc()[MAPPED:], vo_frames=vo_frames)
        for i in range(MAPPED + LOCALIZED, FORK_BACK + 1):
            system.track_rgbd(*frames[i], i / seq.fps)
        out[name].update(fork_vo=fork_vo, fork_back=fork_tracker(system.tracker))
        system.shutdown()

    systems = _both(max_keyframes=64, max_frames_between_kf=10)
    beside(lambda: run("jax", systems["jax"]), lambda: run("torch", systems["torch"]))
    out["frames"] = frames
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


def _track_staging(tracker, frame, ts):
    """One frame on `tracker` (a fork) with its local-map stage watched:
    -> (ok, the relocalization's and the motion model's outcomes, the slots
    the frame itself associated when the stage began, and the prior mask and
    positions the stage staged for the device)."""
    kernels = jkernels if type(tracker) is jtracking.Tracker else tkernels
    step, sig = kernels.local_map_step, inspect.signature(kernels.local_map_step)
    seen = dict(reloc=None, mm=None)
    stage, reloc, mm = tracker._track_local_map, tracker._relocalize, \
        tracker._track_with_motion_model

    def spy_stage(fr):
        seen["own"] = fr.pt_ids >= 0
        return stage(fr)

    def spy_step(*a, **k):
        args = sig.bind(*a, **k).arguments
        seen.update(mask=n(args["prior_mask"]).copy(), pos=n(args["prior_pos"]).copy())
        return step(*a, **k)

    def spy_reloc(fr):
        seen["reloc"] = reloc(fr)
        return seen["reloc"]

    def spy_mm(fr):
        seen["mm"] = mm(fr)
        return seen["mm"]
    tracker._track_local_map, tracker._relocalize = spy_stage, spy_reloc
    tracker._track_with_motion_model = spy_mm
    kernels.local_map_step = spy_step
    try:
        ok = tracker.track_rgbd(*frame, ts) is not None
    finally:
        kernels.local_map_step = step
    assert "mask" in seen, "the local-map stage did not run"
    return ok, seen


def test_a_lost_frame_stages_no_temporal_point_of_the_last_frame(vo):
    """After frame 14 (map tracking, its motion model matched temporal
    points: _aux_* set), the tracker is LOST and relocalizes on mapped frame
    3 through the reference keyframe. The JAX package's local-map stage
    stages frame 14's temporal-point positions at frame 3's keypoint slots;
    the port's stages only the relocalization's own associations."""
    for pkg in ("jax", "torch"):
        fork = vo[pkg]["fork_vo"]
        aux_mask, aux_pos = fork._aux_mask.copy(), fork._aux_pos.copy()
        assert aux_mask.sum() > 50 and not fork.mb_vo
        fork.state, fork.velocity = type(fork.state).LOST, None
        ok, seen = _track_staging(fork, vo["frames"][3], 99.0)
        assert seen["reloc"] and seen["mm"] is None and ok
        extra = seen["mask"] & ~seen["own"]
        print(f"{pkg}: {int(extra.sum())} temporal priors of frame {FORK_VO} staged "
              f"({int(aux_mask.sum())} were set)")
        if pkg == "torch":
            assert not extra.any()
        else:
            np.testing.assert_array_equal(extra, aux_mask & ~seen["own"])
            assert extra.sum() > 20
            np.testing.assert_array_equal(seen["pos"][extra], aux_pos[extra])


def test_a_relocalization_in_vo_mode_drops_the_motion_models_temporal_matches(vo):
    """Frame 45, from the state after frame 44 (visual odometry, mb_vo): the
    motion model tracks on temporal points and the relocalization through
    the reference keyframe succeeds in the same frame. The reference keeps
    the relocalization's associations and drops the motion model's
    (vpMPsMM): the port's local-map stage stages no temporal point; the JAX
    package's stages the motion model's."""
    frame = vo["frames"][FORK_BACK + 1]
    for pkg in ("jax", "torch"):
        fork = vo[pkg]["fork_back"]
        assert fork.mb_vo and fork.state.name == "OK"
        aux = {}
        mm = fork._track_with_motion_model

        def keep_aux(fr):
            ok = mm(fr)
            aux.update(mask=fork._aux_mask.copy(), pos=fork._aux_pos.copy())
            return ok
        fork._track_with_motion_model = keep_aux
        _, seen = _track_staging(fork, frame, (FORK_BACK + 1) / 30.0)
        assert seen["mm"] and seen["reloc"]
        extra = seen["mask"] & ~seen["own"]
        print(f"{pkg}: {int(extra.sum())} of the motion model's {int(aux['mask'].sum())} "
              "temporal matches staged")
        if pkg == "torch":
            assert not extra.any()
        else:
            np.testing.assert_array_equal(extra, aux["mask"] & ~seen["own"])
            assert extra.sum() > 20
            np.testing.assert_array_equal(seen["pos"][extra], aux["pos"][extra])


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
