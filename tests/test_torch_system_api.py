"""The port's RGB-D SLAMSystem against the JAX package's, on the CPU: the
slice as a whole (tracking, the savers, the accessors, a reset), the global
BA and change_calibration, and localization mode. The pipelined and batched
fetch are in tests/test_torch_pipelined.py, the host-staged local map in
tests/test_torch_local_mapping.py.

Every part runs JAX systems of one configuration (320x240, 800 features, 4
levels, 8192 points, a local map of 2048), built by
``torch_port_helpers.jax_system``, so that the drives after the first run
the frame programs the first one compiled. The JAX package's drives run one
after another on a thread of their own, beside the port's
(``torch_port_helpers.beside``). Each sequence is rendered once with the
JAX package's renderer and the identical arrays go to both packages.

What is compared, with which tolerance, and why:

- The slice as a whole: two 25-frame sequences (as tests/test_e2e_rgbd.py)
  through one SLAMSystem of each package, with a reset between them, so
  the reset path is part of what is compared; local mapping inline at each
  keyframe (async_mapping=False), no vocabulary, a synchronous fetch.
  Float32 noise in a pose moves a handful of associations at window and
  chi-square edges, and the keyframe decision compares inlier counts with
  thresholds, so per-frame camera positions must agree within 1 cm
  (measured: under 2 mm), keyframe counts within 1, and each ATE must be
  under 0.05 m.
- The twin of tests/test_io_drivers.py::TestSystemAPI::test_global_ba_and_calibration
  (global_bundle_adjust, change_calibration, get_tracked_keypoints): the
  first keyframe is the gauge of the global BA and moves by less than 1e-6
  in both packages (the JAX test's limit); the packages' maps differ by
  float32 noise, so their keyframe centres after the global BA agree within
  1 cm, as tracked poses do.
- Localization mode, twins of tests/test_localization_vo.py::TestLocalizationVO
  and tests/test_io_drivers.py::TestMapPersistence::test_save_load_and_relocalize,
  with the JAX tests' settings (every other SLAMConfig field at its default:
  the pipelined fetch and the mapping worker on): the JAX tests' own limits
  hold for the port (the map frozen, at least 22 of 24 frames tracked, an
  RPE under 0.05 m a frame; the relocalized pose within 0.05 m of the
  truth). After the measured 24 frames the drive goes on to frame 44, where
  the camera comes back into view of the map; copies of both trackers
  (torch_port_helpers.fork_tracker) after frame 14 and after frame 44 show
  where a relocalization supplies a frame's associations: the port stages
  no temporal point of the motion model in the local-map stage then, as
  ORB-SLAM2 does; the JAX package does (a divergence, ROADMAP.md). Between
  the packages, on the odometry drive: the same frames lost, and camera
  positions within 1 cm frame by frame, as in the slice; odometry on
  temporal points integrates that noise over the 24 frames.
"""
import dataclasses
import inspect

import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jkernels, tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.evaluate import ate_rmse as jate
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.system import Sensor as JSensor
from orbslam2_tpu_torch.frontend import kernels as tkernels, tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io import evaluate as tevaluate
from orbslam2_tpu_torch.io.evaluate import rpe
from orbslam2_tpu_torch.io.trajectory import load_tum
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import beside, camera_centres, fork_tracker, jax_system, n

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
CFG_KW = dict(th_depth=4.0, max_keyframes=32, max_points=8192, local_point_cap=2048,
              min_init_features=300)
# the slice: mapping inline at each keyframe, a synchronous fetch
SLICE_KW = dict(max_keyframes=64, max_frames_between_kf=10, async_mapping=False,
                pipelined_fetch=False)
N_FRAMES = 25
SEQUENCES = ("lateral", "forward")


def _jax(**kw):
    """The JAX package's system with CFG_KW, updated by ``kw``."""
    return jax_system(jtracking.SLAMConfig(
        cam=JCamera(**CAM_KW), orb=JORBConfig(n_features=800, n_levels=4),
        **{**CFG_KW, **kw}), JSensor.RGBD)


def _port(**kw):
    """The port's system with CFG_KW, updated by ``kw``."""
    return SLAMSystem(ttracking.SLAMConfig(
        cam=TCamera(**CAM_KW), orb=TORBConfig(n_features=800, n_levels=4),
        **{**CFG_KW, **kw}), Sensor.RGBD, device="cpu")


@pytest.fixture(scope="module")
def drives():
    """Every drive of this file: the slice's, the global BA's and the
    localization drive, the JAX package's one after another on a thread of
    their own beside the port's (torch_port_helpers.beside)."""
    slice_out, slice_run = _slice_drive()
    gba_out, gba_run = _gba_drive()
    vo_out, vo_run = _vo_drive()
    gba_kw = dict(max_frames_between_kf=5, force_kf_every=4)
    vo_kw = dict(max_keyframes=64, max_frames_between_kf=10)
    systems = {"jax": _jax(**SLICE_KW), "torch": _port(**SLICE_KW)}
    slice_out["system"] = systems["torch"]

    def drives_of(pkg, build):
        slice_run(pkg, systems[pkg])
        gba_run(pkg, build(**gba_kw))
        vo_run(pkg, build(**vo_kw))

    beside(lambda: drives_of("jax", _jax), lambda: drives_of("torch", _port))
    yield dict(slice=slice_out, gba=gba_out, vo=vo_out)
    systems["jax"].shutdown()
    for name in ("jax", "torch"):
        gba_out[name]["system"].shutdown()


@pytest.fixture(scope="module")
def runs(drives):
    return drives["slice"]


def _slice_drive():
    """Each sequence of SEQUENCES, rendered once, through one system of a
    package, with a reset between them; the JAX package's through its
    Tracker. -> (out, run) as ``_gba_drive``: ``out[sequence]`` holds both
    packages' results, the JAX package's under keys ending in ``_j``."""
    renders = []
    for name in SEQUENCES:
        seq = SyntheticSequence(JCamera(**CAM_KW), n_frames=N_FRAMES, trajectory=name, seed=1)
        renders.append((name, seq, [seq.render(i) for i in range(N_FRAMES)]))
    out = {name: dict(gt=np.stack([np.linalg.inv(p) for p in seq.poses]))
           for name, seq, _ in renders}

    def run(pkg, system):
        tr = system.tracker
        track = tr.track_rgbd if pkg == "jax" else system.track_rgbd
        sfx = "_j" if pkg == "jax" else "_t"
        for k, (name, _, frames) in enumerate(renders):
            if k:
                system.reset()
                if pkg == "torch":
                    assert system.map.n_keyframes() == 0
                    assert system.tracking_state() == ttracking.TrackingState.NOT_INITIALIZED
            ret = [track(g, d, i / 30.0) for i, (g, d) in enumerate(frames)]
            sl = slice(k * N_FRAMES, (k + 1) * N_FRAMES)
            r = out[name]
            r["ret" + sfx] = ret
            r["est" + sfx] = tr.full_trajectory_twc()[sl]
            r["lost" + sfx] = tr.trajectory_lost_mask()[sl]
            r["kf" + sfx], r["pts" + sfx] = tr.map.n_keyframes(), tr.map.n_points()
            if pkg == "torch":
                r["mapped"] = system.local_mapper.counts.copy()

    return out, run


@pytest.fixture(scope="module")
def gba(drives):
    return drives["gba"]


def _gba_drive():
    """TestSystemAPI's drive: 12 frames of the forward drive (seed 6), a
    keyframe every 4th frame, then a global BA. -> (out, run): ``run(name,
    system)`` drives one package's system and writes ``out[name]``."""
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

    return out, run


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
    cfg = ttracking.SLAMConfig(cam=TCamera(**CAM_KW), **{**CFG_KW, **SLICE_KW})
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


# ----------------------------------------------------------------------
# Localization mode
# ----------------------------------------------------------------------
MAPPED, LOCALIZED = 6, 24
FORK_VO, FORK_BACK = 14, 44   # last frames before the relocalization cases


@pytest.fixture(scope="module")
def vo(drives):
    return drives["vo"]


def _vo_drive():
    """TestLocalizationVO: map 6 frames of the shuttle (cluttered world,
    seed 9), then 24 frames in localization mode beyond the mapped region.
    -> (out, run) as ``_gba_drive``."""
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

    out["frames"] = frames
    return out, run


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
    system = _port()
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

