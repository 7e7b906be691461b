"""The classic tracking path's programs against the JAX package's jitted
counterparts, at the test geometry (320x240 / 800 / 4).

The classic path (initialization, relocalization, every frame in
localization mode, the motion-model fallback) runs the standalone frame
build of its sensor, then ``motion_model_step`` and ``local_map_step``. The
JAX package jits each as one XLA program (``frame._rgbd_program``,
``_stereo_program``, ``_mono_program``, ``kernels.motion_model_step``,
``local_map_step``); the port runs each as one program
(``frame.BuildProgram``, ``kernels.MotionModelProgram``,
``kernels.LocalMapProgram``): one CUDA graph on a card, the eager step on
the CPU. Here each program's capture form (the form a graph holds) runs
under ``torch_port_helpers.no_host_reads`` on the same seeded numpy inputs as
the JAX program, and gives the eager form's outputs bit for bit.

Tolerances, and why:

- The builds run each package's own extractor: the keypoint tolerances of
  ``tests/test_torch_orb.py::test_extractor_matches_jax`` (the same valid
  slots and octaves, xy within 1e-4 px, angle within 1e-3 rad, descriptor
  Hamming median <= 4, max <= 40, 90 % of them exact). RGB-D depth is read
  at the rounded keypoint: equal at every slot; uR within 1e-3 px (the
  matcher's ``UR_TOL``). Stereo: ``tests/test_torch_stereo_drive.py``'s
  frame-build tolerance, at most 1 % of the matches may differ, uR and
  depth within 1e-3 on the rest.
- The steps take the same keypoints and map: their searches, at the given
  pose, must agree exactly (associations, match counts, visibility); after
  the pose LM the tolerances of ``tests/test_torch_fused_step.py`` (inlier
  flags on 98 % of the slots, inlier counts within 3 for the motion model
  and 5 for the local map, the pose within 1e-3 in twist norm).
"""
import copy
import functools

import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import frame as jframe, kernels as jk
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops import orb as jorb
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import frame as tframe, kernels as tk
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig, Tracker
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import Sensor, SLAMSystem
from orbslam2_tpu_torch.utils import graph_capture

from test_torch_stereo import UR_TOL, _assert_stereo_close
from torch_port_helpers import (angle_diff, desc_np, hamming_rows, j, jax_keypoints, n,
                                no_host_reads, t)

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
NF, NL, SF = 800, 4, 1.2
JORB = jorb.ORBConfig(n_features=NF, n_levels=NL)
LOC_MAPPED, LOC_FRAMES = 8, 4   # the drive: frames mapped, then in localization mode


def _cfg(**kw):
    return SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=NF, n_levels=NL), th_depth=4.0,
                      max_keyframes=16, max_points=4096, local_point_cap=1024,
                      min_init_features=300, async_mapping=False, pipelined_fetch=False, **kw)


@pytest.fixture(scope="module")
def staged():
    """A port tracker (device "cpu") after frames 0 and 1 of the lateral
    drive, and frame 2's images: the motion-model step's inputs as
    ``Tracker._track_with_motion_model`` stages them, the local-map step's
    as ``_track_local_map`` stages them after it (the motion model's
    associations as the prior), and a stereo pair."""
    seq = SyntheticSequence(JCAM, n_frames=25, trajectory="lateral", seed=1)
    tr = Tracker(_cfg(), device="cpu")
    for i in range(2):
        assert tr.track_rgbd(*seq.render(i), i / 30.0) is not None
    gray, depth = (x.astype(np.float32) for x in seq.render(2))
    left, right, _ = seq.render_stereo(2)
    kp, ur, _ = tframe._rgbd_build(tr.extractor, TCAM, t(gray), t(depth))
    last, m = tr.last_frame, tr.map
    has_pt = (last.pt_ids >= 0) & m.pt_valid[np.maximum(last.pt_ids, 0)]
    pos = np.where(has_pt[:, None], m.pt_pos[np.maximum(last.pt_ids, 0)], 0.0)
    tcw_pred = (tr.velocity @ last.tcw).astype(np.float32)
    lk = convert.keypoints_to_numpy(last.kp)
    mm = dict(tcw_pred=tcw_pred, pos=pos.astype(np.float32), has_pt=has_pt, last_desc=lk["desc"],
              last_octave=lk["octave"], last_angle=lk["angle"])
    step = tk.motion_model_step(t(tcw_pred), t(mm["pos"]), t(has_pt), last.kp.desc,
                                last.kp.octave, last.kp.angle, kp, ur, TCAM, SF, NL)
    assoc = n(step.assoc)
    prior_mask = (assoc >= 0) & (last.pt_ids[np.maximum(assoc, 0)] >= 0)
    prior_pos = np.where(prior_mask[:, None], pos[np.maximum(assoc, 0)], 0.0).astype(np.float32)
    lm = dict(tcw=n(step.tcw), ids=tr._local_ids.astype(np.int64), sel=tr._local_sel,
              pt=[m.pt_pos, m.pt_desc, m.pt_valid, m.pt_normal, m.pt_min_dist, m.pt_max_dist],
              prior_pos=prior_pos, prior_mask=prior_mask)
    assert has_pt.sum() > 100 and prior_mask.sum() > 100 and tr._local_sel.sum() > 100
    return dict(extractor=tr.extractor, kp=convert.keypoints_to_numpy(kp), tkp=kp,
                ur=n(ur), mm=mm, lm=lm, last_kp=last.kp,
                images={"rgbd": (gray, depth), "stereo": (left.astype(np.float32),
                                                         right.astype(np.float32)),
                        "mono": (gray,)})


def _assert_same(a, b):
    """Two programs' outputs (tuples of tensors, keypoints by field) equal
    bit for bit."""
    flat = lambda out: [x for y in out for x in (tk._kp_tensors(y) if isinstance(
        y, tk.Keypoints) else [y])]  # noqa: E731
    for x, y in zip(flat(a), flat(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_keypoints_close(kt, kj):
    v = n(kj.valid)
    np.testing.assert_array_equal(n(kt.valid), v)
    assert v.sum() > 0.5 * NF
    np.testing.assert_allclose(n(kt.xy), n(kj.xy), atol=1e-4)
    np.testing.assert_array_equal(n(kt.octave), n(kj.octave))
    assert angle_diff(n(kt.angle)[v], n(kj.angle)[v]).max() < 1e-3
    ham = hamming_rows(desc_np(kt.desc)[v], desc_np(kj.desc)[v])
    assert np.median(ham) <= 4 and ham.max() <= 40 and (ham == 0).mean() >= 0.9, ham


@pytest.mark.parametrize("kind", ["rgbd", "stereo", "mono"])
def test_build_program_matches_jax(staged, kind):
    """The sensor's build program, in its capture form under the host-read
    guard, against the JAX package's jitted build program; its eager form
    and ``build_frame_*`` through the program give the same bits."""
    images = staged["images"][kind]
    jex = jorb.get_extractor(JORB, (240, 320))
    if kind == "rgbd":
        kp_j, ur_j, d_j = jframe._rgbd_program(jex, JCAM)(*map(j, images))
    elif kind == "stereo":
        kp_j, _, ur_j, d_j = jframe._stereo_program(jex, JCAM, SF)(*map(j, images))
    else:
        kp_j = jframe._mono_program(jex, JCAM)(*map(j, images))
    prog = tframe.BuildProgram(kind, staged["extractor"], TCAM)
    with no_host_reads():
        captured = prog._step([t(im) for im in images], ())
    kp_t, ur_t, d_t = captured
    _assert_keypoints_close(kp_t, kp_j)
    ur_t, d_t = n(ur_t), n(d_t)
    if kind == "rgbd":
        np.testing.assert_array_equal(d_t, n(d_j))
        has = d_t > 0
        assert has.sum() > 0.5 * NF
        np.testing.assert_allclose(ur_t[has], n(ur_j)[has], atol=UR_TOL)
        assert (ur_t[~has] == -1).all()
    elif kind == "stereo":
        ur_j = n(ur_j)
        assert (ur_j >= 0).sum() > 0.3 * NF
        _assert_stereo_close(ur_t, d_t, ur_j, n(d_j), int(0.01 * (ur_j >= 0).sum()))
    else:
        assert (ur_t == -1).all() and (d_t == -1).all()
    _assert_same(captured, prog.run(*(t(im) for im in images)))
    build = getattr(tframe, f"build_frame_{kind}")
    fr = build(7, 0.25, *images, staged["extractor"], TCAM, program=prog)
    _assert_same(captured, (fr.kp, fr.ur, fr.depth))
    assert fr.frame_id == 7 and (fr.pt_ids == -1).all() and prog.captures == 0


def _twist_gap(tcw_t, tcw_j) -> float:
    return float(np.linalg.norm(n(jse3.log(j(n(tcw_t)) @ jse3.inverse(tcw_j)))))


def _assert_step_close(out_t, out_j, inliers_within, min_matches=100):
    """A port step's TrackStepResult against the JAX step's."""
    np.testing.assert_array_equal(n(out_t.assoc), n(out_j.assoc))
    np.testing.assert_array_equal(n(out_t.visible), n(out_j.visible))
    assert int(out_t.n_matches) == int(out_j.n_matches) > min_matches
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= inliers_within
    assert (n(out_t.inlier) == n(out_j.inlier)).mean() >= 0.98
    assert _twist_gap(out_t.tcw, out_j.tcw) < 1e-3


@pytest.mark.parametrize("widened", [False, True])
def test_motion_model_program_matches_jax(staged, widened):
    """``MotionModelProgram``'s capture form (the widening selected on the
    device, every LM step run) under the host-read guard against the JAX
    package's jitted ``motion_model_step``, and bit for bit against its
    eager form (the count read on the host, the LM stopped early). Widened:
    the prediction moved 0.4 m along the camera's y axis and two of every
    three last-frame points dropped, so that radius 15 finds under 20
    matches and the step searches again at 30
    (test_torch_fused_step.py's widening case)."""
    mm, s = dict(staged["mm"]), staged
    if widened:
        mm["tcw_pred"] = mm["tcw_pred"].copy()
        mm["tcw_pred"][1, 3] += 0.4
        mm["has_pt"] = mm["has_pt"] & (np.arange(len(mm["has_pt"])) % 3 == 0)
    out_j = jk.motion_model_step(
        j(mm["tcw_pred"]), j(mm["pos"]), j(mm["has_pt"]), j(mm["last_desc"]),
        j(mm["last_octave"]), j(mm["last_angle"]), jax_keypoints(s["kp"]), j(s["ur"]),
        JCAM, SF, NL)
    lk = s["last_kp"]
    args = (t(mm["tcw_pred"]), t(mm["pos"]), t(mm["has_pt"]), lk.desc, lk.octave, lk.angle,
            s["tkp"], t(s["ur"]))
    prog = tk.MotionModelProgram(TCAM, SF, NL)
    with no_host_reads():
        captured = prog._step(prog._flatten(args), ())
    r15 = tk.search_by_projection_last(*args[:7], 15.0, TCAM, SF, NL)
    assert (int((r15.assoc >= 0).sum()) < 20) == widened
    # 14 matches at radius 15 and 56 at 30 when widened; 291 at 15 unmoved
    _assert_step_close(captured, out_j, inliers_within=3, min_matches=40 if widened else 100)
    _assert_same(captured, prog(*args))


def test_local_map_program_matches_jax(staged):
    """``LocalMapProgram``'s capture form (every LM step run, the radius a
    0-d tensor) under the host-read guard against the JAX package's jitted
    ``local_map_step``, and bit for bit against its eager form, at radius
    multipliers 1 and 3 (the frame after a relocalization)."""
    s, lm = staged, staged["lm"]
    pos, desc, valid, normal, dmin, dmax = lm["pt"]
    mirror = [t(pos), convert.desc_from_numpy(desc), t(valid), t(normal), t(dmin), t(dmax)]
    prog = tk.LocalMapProgram(TCAM, SF, NL)
    for radius in (1.0, 3.0):
        out_j, _, _ = jk.local_map_step(
            j(lm["tcw"]), j(lm["ids"].astype(np.int32)), j(lm["sel"]), *map(j, lm["pt"]),
            jax_keypoints(s["kp"]), j(s["ur"]), j(s["ur"]), j(lm["prior_pos"]),
            j(lm["prior_mask"]), radius, JCAM, SF, NL)
        args = (t(lm["tcw"]), t(lm["ids"]), t(lm["sel"]), *mirror, s["tkp"], t(s["ur"]),
                t(lm["prior_pos"]), t(lm["prior_mask"]), radius)
        flat = prog._flatten(args)
        assert flat[-6:] == mirror and flat[-7].shape == () and float(flat[-7]) == radius
        with no_host_reads():
            captured = prog._step(flat, ())
        _assert_step_close(captured, out_j, inliers_within=5)
        assert int(captured.n_matches) > int(lm["prior_mask"].sum())
        _assert_same(captured, prog(*args))


def _spy(monkeypatch, owner, name, calls, key):
    """``owner.name`` counted under ``calls[key]`` at each call."""
    fn = getattr(owner, name)

    @functools.wraps(fn)
    def counted(*a, **k):
        calls[key] = calls.get(key, 0) + 1
        return fn(*a, **k)
    monkeypatch.setattr(owner, name, counted)


def test_localization_drive_runs_the_tracker_programs(monkeypatch):
    """A SLAMSystem maps the first frames of the lateral drive, then tracks
    on in localization mode: every classic-path frame goes through the
    tracker's programs (the build at initialization, on the frame after it
    and on every localization frame, the motion-model and local-map steps on
    every localization frame, and no step outside them); ``programs()`` lists
    them; a calibration changed to the same camera keeps them, a changed
    camera replaces them, each old one released, and the frame after it is
    tracked through the new ones."""
    calls, released = {}, []
    for cls in (tframe.BuildProgram, tk.MotionModelProgram, tk.LocalMapProgram):
        _spy(monkeypatch, cls, "run", calls, cls.__name__)
    for fn in ("motion_model_step", "local_map_step"):
        _spy(monkeypatch, tk, fn, calls, fn)
    release = tk.StepProgram.release
    monkeypatch.setattr(tk.StepProgram, "release",
                        lambda self: (released.append(self), release(self))[1])

    seq = SyntheticSequence(JCAM, n_frames=LOC_MAPPED + LOC_FRAMES + 1, trajectory="lateral",
                            seed=1)
    system = SLAMSystem(_cfg(force_kf_every=3), Sensor.RGBD, device="cpu")
    tracker = system.tracker
    for i in range(LOC_MAPPED):
        assert system.track_rgbd(*seq.render(i), i / 30.0) is not None
    # frame 0 initializes; frame 1, with no velocity yet, tracks the reference
    # keyframe and the local map on the classic path; the rest are fused
    assert calls == {"BuildProgram": 2, "LocalMapProgram": 1, "local_map_step": 1}, calls
    system.activate_localization_mode()
    calls.clear()
    for i in range(LOC_MAPPED, LOC_MAPPED + LOC_FRAMES):
        if i == LOC_MAPPED + 1:
            system.change_calibration(TCamera(**CAM_KW))   # the same camera
        assert system.track_rgbd(*seq.render(i), i / 30.0) is not None
        assert not tracker.mb_vo
    each = {"BuildProgram": LOC_FRAMES, "MotionModelProgram": LOC_FRAMES,
            "LocalMapProgram": LOC_FRAMES, "motion_model_step": LOC_FRAMES,
            "local_map_step": LOC_FRAMES}
    assert calls == each and released == []
    progs = dict(tracker.classic_programs)
    assert set(progs) == {"rgbd", "motion_model_step", "local_map_step"}
    assert isinstance(progs["rgbd"], tframe.BuildProgram)
    assert all(p.made_for[-3] == TCAM for p in progs.values() if p is not progs["rgbd"])
    listed = [id(p) for p in system.programs()]
    assert all(listed.count(id(p)) == 1 for p in progs.values())

    other = TCamera(**dict(CAM_KW, fx=262.0, fy=262.0))
    system.change_calibration(other)
    i = LOC_MAPPED + LOC_FRAMES
    assert system.track_rgbd(*seq.render(i), i / 30.0) is not None
    assert sorted(map(id, released)) == sorted(map(id, progs.values()))
    new = tracker.classic_programs
    assert set(new) == set(progs) and not set(map(id, new.values())) & set(map(id, released))
    assert new["rgbd"].made_for == ("rgbd", tracker.extractor, other)
    assert new["local_map_step"].made_for == (other, SF, NL)
    assert calls["LocalMapProgram"] == LOC_FRAMES + 1
    fork = copy.deepcopy(new["local_map_step"])
    assert fork.made_for == new["local_map_step"].made_for and fork._graphs == {}
    system.shutdown()
    assert all(p._graphs == {} for p in new.values()) and graph_capture._open == 0
