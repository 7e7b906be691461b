"""Relocalization of the port: the tracker's keyframe-database branch, on
the CPU (EPnP and its RANSAC against the JAX package are in
test_torch_epnp.py).

The tracker tests map 16 frames of the lateral sequence with a vocabulary
(a keyframe every third frame). One sets the tracker LOST without a motion
model and tracks a mapped frame again: it must come back through the
keyframe database (EPnP runs), within 0.1 m of the true pose. The other
hands copies of that map and keyframe database, and one LOST frame, to the
JAX tracker's ``_relocalize`` and to the port's, the port drawing the EPnP
sets JAX draws: the same candidates, the same escalation steps, the same
outcome and keyframe, inlier counts within 3 and poses within 1e-3 m. Its
frames are thinned (a seeded share of keypoints marked invalid in both
copies) so that one is accepted at once, one only after the widened
projection search, one is rejected after it, and one after the narrow pass
too.
"""
import copy

import numpy as np
import pytest

from orbslam2_tpu.frontend import frame as jframe
from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.place import vocabulary as jvoc
from orbslam2_tpu.slammap import mapstate as jmapstate
from orbslam2_tpu.slammap.keyframe_db import KeyFrameDatabase as JKFDB
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import tracking
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker, TrackingState
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.solvers import horn
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import camera_centres as centres
from torch_port_helpers import beside, desc_np, j, jax_keypoints, jax_sample_sets, n

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), PinholeCamera(**CAM_KW)
N_MAPPED = 16


CFG_KW = dict(th_depth=4.0, max_keyframes=96, local_point_cap=2048, max_frames_between_kf=5,
              min_init_features=300, force_kf_every=3, async_mapping=False)


@pytest.fixture(scope="module")
def mapped():
    out = _map_drive()
    yield out
    out[0].shutdown()


def _map_drive():
    """16 frames of the lateral sequence through the port with a vocabulary,
    a keyframe every third frame."""
    cfg = SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=800, n_levels=4),
                     pipelined_fetch=False, **CFG_KW)
    seq = SyntheticSequence(TCAM, n_frames=30, trajectory="lateral", seed=1)
    frames = [seq.render(i) for i in range(N_MAPPED)]
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=get_default_vocabulary(), device="cpu")
    for i in range(N_MAPPED):
        system.track_rgbd(*frames[i], i / 30.0)
    # the map and keyframe database as mapped, before a test tracks more
    staged = dict(map={k: copy.deepcopy(v) for k, v in vars(system.map).items()
                       if k not in ("_device_mirror", "_device_kf_store")},
                  kfdb=(system.kfdb.wids.copy(), system.kfdb.wts.copy(),
                        system.kfdb.valid.copy()))
    return system, seq, frames, staged


@pytest.mark.parametrize("name", ["kfdb", "no_vocabulary"])
def test_lost_tracker_relocalizes(mapped, name, monkeypatch):
    """Through the keyframe database, and without one (the tracker's hook
    unset) through the reference keyframe."""
    system, seq, frames, _ = mapped
    tr = system.tracker
    # every live keyframe is in the database
    assert system.kfdb.valid[system.map.kf_valid].all()
    if name == "no_vocabulary":
        monkeypatch.setattr(tr, "kfdb", None)
    calls = []
    solve = tracking.epnp.epnp_ransac

    def spy(*a, **k):
        res = solve(*a, **k)
        calls.append(int(res.n_inliers))
        return res

    monkeypatch.setattr(tracking.epnp, "epnp_ransac", spy)
    tr.state = TrackingState.LOST
    tr.velocity = None
    i = 8
    tcw = system.track_rgbd(*frames[i], N_MAPPED / 30.0)
    assert tcw is not None and tr.state == TrackingState.OK
    err = np.linalg.norm(np.linalg.inv(tcw)[:3, 3] - np.linalg.inv(seq.poses[i])[:3, 3])
    assert err < 0.1, err
    assert tr.last_reloc_frame_id == tr.frame_counter - 1
    if name == "kfdb":
        assert calls and max(calls) >= 10            # through EPnP
        assert tr.matches_inliers >= 50              # the escalation's gate
    else:
        assert not calls                             # the reference-keyframe fallback


def _trackers(cfg, staged, voc):
    """The JAX tracker and the port's on copies of the staged map and
    keyframe database."""
    fields = staged["map"]
    cap = fields["cap"]
    jm = jmapstate.MapState(jmapstate.MapCapacity(cap.max_keyframes, cap.max_points,
                                                  cap.n_features))
    for name in vars(jm):
        if name in fields and name != "cap":
            setattr(jm, name, copy.deepcopy(fields[name]))
    jtr = jtracking.Tracker(jtracking.SLAMConfig(
        cam=JCAM, orb=JORBConfig(n_features=800, n_levels=4), **CFG_KW), map_state=jm)
    jtr.vocabulary = jvoc.Vocabulary(k=voc.k, levels=voc.levels, centers=voc.centers,
                                     word_weights=voc.word_weights, n_words=voc.n_words)
    jtr.kfdb = JKFDB(jtr.vocabulary, cap.max_keyframes)
    jtr.kfdb.wids[:], jtr.kfdb.wts[:], jtr.kfdb.valid[:] = staged["kfdb"]
    ttr = Tracker(cfg, map_state=convert.map_state_from_numpy(fields), device="cpu")
    ttr.vocabulary = voc
    ttr.kfdb = convert.keyframe_db_from_numpy(voc, *staged["kfdb"])
    return jtr, ttr


def _lost_frames(ttr, gray_depth, frame_id, keep, seed):
    """One frame built by the port's extractor, a share `keep` of its
    keypoints (drawn from `seed`) left valid, as the port's Frame and as the
    JAX package's."""
    ttr.frame_counter = frame_id
    tfr = ttr._build_frame("rgbd", gray_depth, frame_id / 30.0)
    kp = tfr.kp
    fields = dict(xy=n(kp.xy), response=n(kp.response), angle=n(kp.angle),
                  octave=n(kp.octave), size=n(kp.size), desc=desc_np(kp.desc),
                  valid=n(kp.valid))
    fields["valid"] &= np.random.default_rng(seed).uniform(size=tfr.n) < keep
    tfr.kp = convert.keypoints_from_numpy(*(fields[f] for f in (
        "xy", "response", "angle", "octave", "size", "desc", "valid")))
    jfr = jframe.Frame(frame_id=frame_id, timestamp=tfr.timestamp,
                       kp=jax_keypoints(fields), ur=j(n(tfr.ur)), depth=j(n(tfr.depth)),
                       tcw=np.eye(4, dtype=np.float32),
                       pt_ids=np.full(tfr.n, -1, np.int32),
                       is_outlier=np.zeros(tfr.n, bool))
    return jfr, tfr


@pytest.mark.parametrize("frame,keep,accepted,passes", [
    (8, 1.0, True, 0),       # accepted at once
    (8, 0.14, True, 1),      # accepted after the widened projection search
    (8, 0.12, False, 1),     # rejected after it
    (8, 0.11, False, 2)])    # rejected after the narrow pass too
def test_relocalize_matches_jax(mapped, monkeypatch, frame, keep, accepted, passes):
    system, _, frames, staged = mapped
    jtr, ttr = _trackers(system.cfg, staged, system.vocabulary)
    jfr, tfr = _lost_frames(ttr, frames[frame], 40, keep, seed=frame)
    monkeypatch.setattr(horn, "draw_sample_sets", jax_sample_sets)
    steps = {}
    for name, tr in (("jax", jtr), ("port", ttr)):
        project = tr._reloc_project_candidate
        steps[name] = []

        def spy(fr, cand, radius_mult, max_hamming, project=project, log=steps[name]):
            added = project(fr, cand, radius_mult, max_hamming)
            log.append((int(cand), radius_mult, max_hamming, added))
            return added

        monkeypatch.setattr(tr, "_reloc_project_candidate", spy)
    cands = [tr.kfdb.detect_reloc_candidates(tr._word_ids(fr), tracking.covisibility
                                             .weight_matrix(tr.map))
             for tr, fr in ((jtr, jfr), (ttr, tfr))]
    assert cands[0] == cands[1] and cands[0]
    ok = beside(lambda: jtr._relocalize(jfr), lambda: ttr._relocalize(tfr))
    assert ok == (accepted, accepted)
    assert abs(jtr.matches_inliers - ttr.matches_inliers) <= 3
    assert [s[:3] for s in steps["jax"]] == [s[:3] for s in steps["port"]]
    assert all(abs(a[3] - b[3]) <= 3 for a, b in zip(steps["jax"], steps["port"]))
    assert len(steps["port"]) == passes
    if accepted:
        assert jtr.ref_kf == ttr.ref_kf
        assert jtr.last_reloc_frame_id == ttr.last_reloc_frame_id == 40
        assert np.linalg.norm(centres(jfr.tcw) - centres(tfr.tcw)) < 1e-3


def test_reset_clears_the_database(mapped):
    system = SLAMSystem(mapped[0].cfg, Sensor.RGBD,
                        vocabulary=get_default_vocabulary(), device="cpu")
    system.kfdb.add(3, np.arange(50))
    system.loop_closer.last_loop_kf_order = 7
    system.loop_closer._consistent_groups = [({1, 2}, 1)]
    system.reset()
    assert not system.kfdb.valid.any()
    assert system.loop_closer.last_loop_kf_order < 0
    assert system.loop_closer._consistent_groups == []
    system.shutdown()
