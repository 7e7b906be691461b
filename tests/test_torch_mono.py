"""Monocular SLAM of the port against the JAX package, on the CPU.

One module fixture drives both packages' SLAMSystem.track_monocular over the
first 30 frames of tests/test_e2e_mono.py's drive (320x240, 800 features, 4
levels, the lateral sequence, seed 5), rendered once with the JAX package's
renderer, both with that test's config and every other SLAMConfig field at
its default: the pipelined fetch and the worker with mapping inline at
keyframe insertion, no vocabulary. The port draws the initializer's sample
sets as the JAX package does (torch_port_helpers.jax_sample_sets, handed in
through horn.draw_sample_sets), so both solve the same two-view problem.

Tolerances: the initialization is one frame and one model in both, the
initial map the same points within 1e-3 (the scene's median depth is 1).
After it, float32 noise moves a few associations at window and chi-square
edges, and the keyframe decision compares counts with thresholds:
keyframes within 1, points within 10 %, each ATE under test_e2e_mono.py's
0.06 m and within 0.01 m of the other, per-frame camera centres within
0.01. These comparisons after the initialization hold only where the JAX
package's native map-graph library was loaded: its numpy fallback counts a
point a frame lists twice once, the engine (and the port) twice, which
changes its mono drive (ROADMAP.md, Queue 3, "Watch"). On that path each
package is held to test_e2e_mono.py's own limits only.

The cases beside the drive: the monocular keyframe decision on staged
counts, the frame in flight dispatched again once after an inline-mapped
keyframe, mono_async_mapping, one monocular triangulation of the local
mapper, and the "mono" kind of the fused frame step (the module holding the
describe kernel, whose plain version runs here).
"""
import concurrent.futures
import copy
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from orbslam2_tpu.frontend import kernels as jk, local_mapping as jlm
from orbslam2_tpu.frontend import tracking as jtracking
from orbslam2_tpu.geometry import se3 as jse3
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.io.synthetic import SyntheticSequence
from orbslam2_tpu.ops.orb import ORBConfig as JORBConfig
from orbslam2_tpu.slammap import covisibility as jcovis, mapstate as jms, native as jnative
from orbslam2_tpu.solvers import initializer as jinit
from orbslam2_tpu.system import Sensor as JSensor
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.frontend import kernels as tk, local_mapping as tlm
from orbslam2_tpu_torch.frontend import tracking as ttracking
from orbslam2_tpu_torch.geometry.camera import PinholeCamera as TCamera
from orbslam2_tpu_torch.io.evaluate import ate_rmse, umeyama_alignment
from orbslam2_tpu_torch.ops.orb import ORBConfig as TORBConfig
from orbslam2_tpu_torch.slammap import covisibility as tcovis
from orbslam2_tpu_torch.solvers import horn, initializer as tinit
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import fork_tracker, j, jax_keypoints, jax_sample_sets, jax_system, n, t

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), TCamera(**CAM_KW)
CFG_KW = dict(max_keyframes=64, max_points=8192, local_point_cap=2048, max_frames_between_kf=10)
SF, NL = 1.2, 4
N_FRAMES = 30


def _watch(module, log):
    """Record every two-view solve through the module attribute the
    tracker calls."""
    solve = module.initialize_two_view

    def wrapped(*a, **k):
        res = solve(*a, **k)
        log.append((bool(res.success), bool(res.used_homography)))
        return res
    module.initialize_two_view = wrapped
    return solve


def _snapshot(m):
    return {k: copy.deepcopy(v) for k, v in vars(m).items()
            if k not in ("_device_mirror", "_device_kf_store")}


def _initial_map(tracker, out):
    """Wrap _monocular_initialization: the map right after it succeeds."""
    init = tracker._monocular_initialization

    def wrapped(fr):
        ok = init(fr)
        if ok:
            m = tracker.map
            out.update(frame=int(fr.frame_id), n_kf=int(m.n_keyframes()),
                       pts=m.pt_pos[m.pt_valid].copy(), ids=np.flatnonzero(m.pt_valid),
                       tcw=m.kf_pose[np.flatnonzero(m.kf_valid)].copy())
        return ok
    tracker._monocular_initialization = wrapped


def _result(system, seq_gt):
    tr = system.tracker
    est = tr.full_trajectory_twc()      # applies the frames in flight
    lost = tr.trajectory_lost_mask()
    first = int(np.flatnonzero(~lost)[0])
    return dict(est=est, lost=lost, first=first, kf=system.map.n_keyframes(),
                pts=system.map.n_points(),
                ate=ate_rmse(est[first:], seq_gt[first:], with_scale=True))


@pytest.fixture(scope="module")
def runs():
    seq = SyntheticSequence(JCAM, n_frames=N_FRAMES + 1, trajectory="lateral", seed=5)
    frames = [seq.render(i)[0] for i in range(N_FRAMES + 1)]
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])[:N_FRAMES]

    # the JAX package, with the map before its last inline mapping kept
    def run_jax():
        jsys = jax_system(jtracking.SLAMConfig(
            cam=JCAM, orb=JORBConfig(n_features=800, n_levels=NL), **CFG_KW),
            JSensor.MONOCULAR)
        jsolves, jinit_map, before_last = [], {}, {}
        solve_j = _watch(jinit, jsolves)
        _initial_map(jsys.tracker, jinit_map)
        process = jsys.local_mapper.process_keyframe

        def keep_then_process(kf, backlog=False):
            before_last.update(kf=int(kf), map=_snapshot(jsys.map))
            return process(kf, backlog)
        jsys.local_mapper.process_keyframe = keep_then_process
        try:
            for i in range(N_FRAMES):
                jsys.track_monocular(frames[i], i / 30.0)
            jres = _result(jsys, gt)
        finally:
            jinit.initialize_two_view = solve_j
        jres.update(native=jnative.available(), solves=jsolves, init=jinit_map,
                    sync=jsys.mapping_worker.sync_mapping)
        return jsys, jres, before_last

    # both drives at once, the JAX one on a thread of its own: each is
    # deterministic (mapping inline, a fetch without a thread), and the
    # patched module attributes are each package's own
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(run_jax)
        # the port, with JAX's sample sets
        system = SLAMSystem(ttracking.SLAMConfig(cam=TCAM, orb=TORBConfig(n_features=800,
                                                                           n_levels=NL),
                                                 **CFG_KW),
                            Sensor.MONOCULAR, device="cpu")
        tr = system.tracker
        tsolves, tinit_map = [], {}
        solve_t = _watch(tinit, tsolves)
        _initial_map(tr, tinit_map)
        draw = horn.draw_sample_sets
        horn.draw_sample_sets = jax_sample_sets
        dispatched, fused_applied, kf_frames, rescued = [], set(), [], []
        dispatch, apply_, create = tr._fused_dispatch, tr._fused_apply, tr._create_new_keyframe

        def log_dispatch(kind, imgs_d, timestamp, frame_id=None, chain_off_pipe=True):
            rec = dispatch(kind, imgs_d, timestamp, frame_id, chain_off_pipe)
            dispatched.append(rec["frame_id"])
            return rec

        def log_apply(rec, fetched):
            fused_applied.add(rec["frame_id"])
            ret = apply_(rec, fetched)
            if ret is ttracking._MISSED_KEYFRAME:
                rescued.append(rec["frame_id"])
            return ret

        def log_create(fr):
            kf_frames.append(int(fr.frame_id))
            return create(fr)
        tr._fused_dispatch, tr._fused_apply, tr._create_new_keyframe = \
            log_dispatch, log_apply, log_create
        try:
            for i in range(N_FRAMES):
                system.track_monocular(frames[i], i / 30.0)
            tres = _result(system, gt)
        finally:
            tinit.initialize_two_view = solve_t
            horn.draw_sample_sets = draw
        # still beside the JAX drive, and with nothing patched any more:
        # test_mono_async_mapping_queues_keyframes's drive
        queued = _async_mapping_drive()
        jsys, jres, before_last = jax_run.result()
    tres.update(solves=tsolves, init=tinit_map, dispatched=dispatched, rescued=rescued,
                kf_fused=[f for f in kf_frames if f in fused_applied],
                retracked=tr.retracked_frames, rebuilt=tr.rebuilt_frames,
                sync=system.mapping_worker.sync_mapping)
    print(f"JAX native library loaded: {jres['native']}; the port tracked again "
          f"after a missed keyframe: {rescued}")
    yield dict(jax=jres, torch=tres, jsys=jsys, system=system, frames=frames,
               before_last=before_last, queued=queued)
    jsys.shutdown()
    system.shutdown()


def test_same_initialization(runs):
    jr, tr_ = runs["jax"], runs["torch"]
    assert jr["sync"] and tr_["sync"]
    assert tr_["solves"] == jr["solves"]
    assert jr["solves"][-1][0] and 0 < jr["first"] < 15
    assert tr_["first"] == jr["first"] == jr["init"]["frame"] == tr_["init"]["frame"]
    ij, it = jr["init"], tr_["init"]
    assert ij["n_kf"] == it["n_kf"] == 2
    np.testing.assert_array_equal(it["ids"], ij["ids"])
    assert len(ij["ids"]) >= 50
    np.testing.assert_allclose(it["pts"], ij["pts"], atol=1e-3)
    np.testing.assert_allclose(it["tcw"], ij["tcw"], atol=1e-3)


def _jax_native(runs) -> bool:
    if not runs["jax"]["native"]:
        print("the JAX package ran its numpy fallback: held to its own limits only")
    return runs["jax"]["native"]


def test_same_frames_tracked(runs):
    lj, lt = runs["jax"]["lost"], runs["torch"]["lost"]
    for lost, first in ((lj, runs["jax"]["first"]), (lt, runs["torch"]["first"])):
        assert lost[first:].sum() <= 2
    if not _jax_native(runs):
        return
    rescued = runs["torch"]["rescued"]
    differ = np.flatnonzero(lj != lt)
    # where the port's missed-keyframe rescue fired it may track a frame the
    # JAX package loses, and only there
    assert set(differ) <= set(rescued), (differ, rescued)
    assert not (lt & ~lj).any()


def test_map_and_ate_match_jax(runs):
    jr, tr_ = runs["jax"], runs["torch"]
    for r in (jr, tr_):
        assert r["kf"] >= 3 and r["pts"] > 150 and r["ate"] < 0.06
    if not _jax_native(runs):
        return
    assert abs(tr_["kf"] - jr["kf"]) <= 1
    assert abs(tr_["pts"] - jr["pts"]) <= 0.1 * jr["pts"]
    assert abs(tr_["ate"] - jr["ate"]) < 0.01


def test_camera_centres_match_jax_on_its_native_path(runs):
    jr, tr_ = runs["jax"], runs["torch"]
    if not _jax_native(runs):
        return
    first = jr["first"]
    cj = jr["est"][first:, :3, 3].astype(np.float64)
    ct = tr_["est"][first:, :3, 3].astype(np.float64)
    s, r, tt = umeyama_alignment(ct, cj, True)
    aligned = (s * (r @ ct.T)).T + tt
    assert np.linalg.norm(aligned - cj, axis=1).max() < 0.01


def test_inline_mapped_keyframe_redispatches_the_frame_in_flight_once(runs):
    """Each keyframe a pipelined frame creates is mapped inline; the frame
    dispatched before it (chained off the map without the new points) is
    dispatched again, once, and no frame a third time."""
    tr_ = runs["torch"]
    counts = np.bincount(tr_["dispatched"])
    again = set(np.flatnonzero(counts == 2).tolist())
    assert counts.max() <= 2
    expect = {f + 1 for f in tr_["kf_fused"] if f + 1 < N_FRAMES}
    assert expect, "no keyframe was created on the pipelined path"
    assert again == expect
    assert tr_["retracked"] == len(again) and tr_["rebuilt"] == 0


class _Worker:
    def __init__(self, idle):
        self._idle = idle

    def idle(self):
        return self._idle

    def queue_size(self):
        return 1

    def accept_keyframes(self):
        return True


def _decide(tracker_cls, mapstate, cfg, inliers, since, idle):
    """One Tracker._need_new_keyframe of a monocular tracker on staged
    counts. -> (decision, interrupt_ba)."""
    tr = object.__new__(tracker_cls)
    tr.map, tr.cfg, tr.is_mono = mapstate, cfg, True
    tr.mapping_worker = _Worker(idle)
    tr.local_mapper = SimpleNamespace(interrupt_ba=False)
    tr.ref_kf = int(np.flatnonzero(mapstate.kf_valid)[-1])
    tr.last_kf_frame_id, tr.matches_inliers = 100, inliers
    nkp = mapstate.cap.n_features
    neg = np.full(nkp, -1.0, np.float32)
    fr = SimpleNamespace(frame_id=100 + since, host_depth_ur=lambda: (neg, neg),
                         pt_ids=np.full(nkp, -1, np.int32), is_outlier=np.zeros(nkp, bool))
    return bool(tr._need_new_keyframe(fr)), tr.local_mapper.interrupt_ba


def test_mono_keyframe_decision_matches_jax(runs):
    """th_ref 0.9, no c1c (a frame far under a quarter of the reference's
    points does not force a keyframe while the mapper is busy), and a busy
    mapper never queues a monocular keyframe: False, with interrupt_ba."""
    fields = runs["before_last"]["map"]
    jm = jms.MapState(fields["cap"])
    for name in vars(jm):
        if name in fields and name != "cap":
            setattr(jm, name, copy.deepcopy(fields[name]))
    tm = convert.map_state_from_numpy(fields)
    jcfg = jtracking.SLAMConfig(cam=JCAM, **CFG_KW)
    tcfg = ttracking.SLAMConfig(cam=TCAM, **CFG_KW)
    ref = int(np.flatnonzero(jm.kf_valid)[-1])
    obs = jm.point_obs_count()
    pts = jm.kf_pt[ref]
    min_obs = 3 if jm.n_keyframes() > 2 else 2
    ref_tracked = int(((pts >= 0) & (obs[np.maximum(pts, 0)] >= min_obs)).sum())
    assert ref_tracked > 50
    for inliers in (5, 16, ref_tracked // 4 - 1, int(0.75 * ref_tracked),
                    int(0.9 * ref_tracked) - 1, int(0.9 * ref_tracked) + 1, ref_tracked):
        for since in (1, 10):
            for idle in (True, False):
                # the monocular rule: c1a (max_frames_between_kf) or c1b
                # (mapper idle), no c1c, and c2 with th_ref 0.9; a busy
                # mapper gets interrupt_ba and no keyframe
                due = (since >= 10 or idle) and 15 < inliers < 0.9 * ref_tracked
                want = (due and idle, due and not idle)
                got_j = _decide(jtracking.Tracker, jm, jcfg, inliers, since, idle)
                got_t = _decide(ttracking.Tracker, tm, tcfg, inliers, since, idle)
                assert got_t == got_j == want, (inliers, since, idle)


def _async_mapping_drive():
    """14 frames of the lateral drive (seed 5) through the port with
    mono_async_mapping: keyframes are queued to the worker."""
    seq = SyntheticSequence(JCAM, n_frames=14, trajectory="lateral", seed=5)
    system = SLAMSystem(ttracking.SLAMConfig(
        cam=TCAM, orb=TORBConfig(n_features=800, n_levels=NL), mono_async_mapping=True,
        **CFG_KW), Sensor.MONOCULAR, device="cpu")
    try:
        sync, monocular = system.mapping_worker.sync_mapping, system.local_mapper.cfg.monocular
        for i in range(seq.n_frames):
            system.track_monocular(seq.render(i)[0], i / 30.0)
        lost = system.tracker.trajectory_lost_mask()
        system.wait_mapping_idle()
        return dict(sync=sync, monocular=monocular, lost=lost, pts=system.map.n_points())
    finally:
        system.shutdown()


def test_mono_async_mapping_queues_keyframes(runs):
    jcfg = jtracking.SLAMConfig(cam=JCAM, orb=JORBConfig(n_features=800, n_levels=NL),
                                mono_async_mapping=True, **CFG_KW)
    jsys = jax_system(jcfg, JSensor.MONOCULAR)
    try:
        assert jsys.mapping_worker.sync_mapping is False
    finally:
        jsys.shutdown()
    # the port's drive ran in the module fixture, beside the JAX drive
    q = runs["queued"]
    assert q["sync"] is False
    assert q["monocular"]
    first = int(np.flatnonzero(~q["lost"])[0])
    assert first < 10 and not q["lost"][first:].any()
    assert q["pts"] > 50


def test_monocular_triangulation_matches_jax(runs):
    """One _create_new_map_points of a monocular local mapper (20
    neighbours, the baseline over the median depth) on copies of the JAX
    drive's map before its last keyframe was mapped."""
    staged = runs["before_last"]
    fields, kf = staged["map"], staged["kf"]
    jm = jms.MapState(fields["cap"])
    for name in vars(jm):
        if name in fields and name != "cap":
            setattr(jm, name, copy.deepcopy(fields[name]))
    tm = convert.map_state_from_numpy(fields)
    cfg_kw = dict(scale_factor=SF, n_levels=NL, monocular=True)
    jmapper = jlm.LocalMapper(jm, JCAM, jlm.LocalMapperConfig(**cfg_kw))
    tmapper = tlm.LocalMapper(tm, TCAM, tlm.LocalMapperConfig(**cfg_kw), device="cpu")
    before = jm._pt_counter
    jmapper._create_new_map_points(kf, jcovis.weight_matrix(jm))
    tmapper._create_new_map_points(kf, tcovis.weight_matrix(tm))
    made_j, made_t = jm._pt_counter - before, tm._pt_counter - before
    assert made_j > 20
    assert abs(made_t - made_j) <= max(3, 0.05 * made_j)
    # the points are compared by the keyframe slot they were made for (the
    # order of equally covisible neighbours may differ, and with it the ids)
    slots_j = np.flatnonzero(jm.kf_pt[kf] >= before)
    slots_t = np.flatnonzero(tm.kf_pt[kf] >= before)
    both = np.intersect1d(slots_j, slots_t)
    assert len(both) >= 0.9 * max(len(slots_j), len(slots_t))
    d = np.linalg.norm(tm.pt_pos[tm.kf_pt[kf, both]] - jm.pt_pos[jm.kf_pt[kf, both]], axis=1)
    assert np.median(d) < 1e-3


def test_fused_mono_step_matches_jax(runs):
    """fused_frame_step(("mono", ...)) against _fused_mono_program on the
    port's state after the drive, predicting frame 30: the limits of
    tests/test_torch_fused_step.py, each frame built by its own package's
    extractor."""
    tr = runs["system"].tracker
    jtr = runs["jsys"].tracker
    m = tr.map
    last = tr.last_frame
    gray = runs["frames"][N_FRAMES]
    vel = np.asarray(tr.velocity, np.float32)
    tcw = np.asarray(last.tcw, np.float32)
    pt = [m.pt_pos, m.pt_desc, m.pt_valid, m.pt_normal, m.pt_min_dist, m.pt_max_dist]
    pid = last.pt_ids.astype(np.int32)
    out_j = jk._fused_mono_program(jtr.extractor, jtr.cam, SF, NL)(
        j(gray), (vel, tcw), jax_keypoints(convert.keypoints_to_numpy(last.kp)), pid,
        tr._local_ids, tr._local_sel, np.float32(1.0), *[jax.numpy.asarray(a) for a in pt])
    out_t = tk.fused_frame_step(
        ("mono", (t(gray),)), tr.extractor, TCAM, SF, NL, (t(vel), t(tcw)), last.kp,
        t(pid), t(tr._local_ids), t(tr._local_sel), 1.0, t(m.pt_pos),
        convert.desc_from_numpy(m.pt_desc), t(m.pt_valid), t(m.pt_normal),
        t(m.pt_min_dist), t(m.pt_max_dist))
    assert (n(out_t.ur) == -1).all() and (n(out_t.depth) == -1).all()
    assert abs(int(out_t.mm_matches) - int(out_j.mm_matches)) <= 3
    assert int(out_j.mm_matches) > 100
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 5
    assert (n(out_t.pt_ids) == n(out_j.pt_ids)).mean() >= 0.98
    gap = np.linalg.norm(n(jse3.log(j(n(out_t.tcw)) @ jse3.inverse(out_j.tcw))))
    assert gap < 1e-3


def _duplicates(replace):
    """chip_smoke.py phase 17e's change to the map, for _track_frame: a
    duplicate (same position, descriptor, normal and scale band) of every
    other point the last frame tracked that is still in the map and, with
    `replace`, each old point replaced by its duplicate under the map lock.
    The run without the replacement adds the same duplicates, so that both
    runs hand out the same free slots. -> prepare(tracker) -> (old ids,
    duplicate ids, the last frame's slots holding an old id)."""
    def prepare(tracker):
        m, ids = tracker.map, tracker.last_frame.pt_ids
        live = np.flatnonzero((ids >= 0) & m.pt_valid[np.maximum(ids, 0)])
        old = np.unique(ids[live[::2]])
        with tracker.map_lock:
            dup = np.array([m.add_point(
                m.pt_pos[p].copy(), m.pt_desc[p].copy(), int(m.pt_ref_kf[p]),
                int(m.pt_first_frame[p]), normal=m.pt_normal[p].copy(),
                min_dist=float(m.pt_min_dist[p]), max_dist=float(m.pt_max_dist[p]))
                for p in old])
            if replace:
                m.replace_points(list(zip(old.tolist(), dup.tolist())))
        return old, dup, np.flatnonzero(np.isin(ids, old))
    return prepare


def _track_frame(tracker, gray, prepare=None):
    """On a fork of `tracker`: `prepare(fork)`, then one frame through
    track_mono, applied. -> (the fork, the fused apply's motion-model
    matches and inliers and final inliers, the fused step's last-frame ids,
    the device carry right after the dispatch, what `prepare` returned)."""
    fork = fork_tracker(tracker)
    assert fork.state.name == "OK" and fork.velocity is not None
    out = prepare(fork) if prepare else None
    counts, staged = {}, {}
    apply_ = fork._fused_apply
    mod = jk if type(fork) is jtracking.Tracker else tk
    step = mod.fused_frame_step

    def spy_apply(rec, fetched):
        counts.update(mm=int(fetched[4]), mm_in=int(fetched[5]), n_in=int(fetched[6]))
        return apply_(rec, fetched)

    def spy_step(*a, **kw):
        staged["last_pid"] = n(a[7]).copy()
        return step(*a, **kw)
    fork._fused_apply = spy_apply
    mod.fused_frame_step = spy_step
    try:
        fork.track_mono(gray, N_FRAMES / 30.0)
        carry = fork._last_pid_dev
        fork.flush_frames()
    finally:
        mod.fused_frame_step = step
    assert counts, "the frame did not take the fused path"
    return fork, counts, staged["last_pid"], carry, out


def test_replaced_points_in_the_last_frame_are_remapped(runs):
    """chip_smoke.py phase 17e at 320x240 on the drive's last frame: half of
    the points it tracked merged into duplicates before the next frame.
    The port (Tracking::CheckReplacedInLastFrame) tracks that frame as
    without the merge, the device carry set aside for the remapped ids; the
    JAX package, without the lookup, loses the merged points' motion-model
    matches."""
    gray = runs["frames"][N_FRAMES]
    tr, jtr = runs["system"].tracker, runs["jsys"].tracker
    base, c0, pid0, _, _ = _track_frame(tr, gray, _duplicates(False))
    rep, c1, pid1, carry1, (old, dup, slots) = _track_frame(tr, gray, _duplicates(True))
    ids = tr.last_frame.pt_ids
    assert len(slots) * 2 >= ((ids >= 0) & tr.map.pt_valid[np.maximum(ids, 0)]).sum() - 1
    assert len(old) > 30
    assert rep.remapped_ids - base.remapped_ids == len(slots)
    remap = dict(zip(old.tolist(), dup.tolist()))
    # the step read the host's remapped ids, not the device carry
    assert carry1 is None
    np.testing.assert_array_equal(pid1, [remap.get(int(p), int(p)) for p in pid0])
    assert c1 == c0 and c0["mm"] > 100
    np.testing.assert_allclose(rep.last_frame.tcw, base.last_frame.tcw, atol=1e-5)
    np.testing.assert_array_equal(
        rep.last_frame.pt_ids, [remap.get(int(p), int(p)) for p in base.last_frame.pt_ids])
    # the JAX package: the merged points are invalid to its motion model
    _, j0, _, _, _ = _track_frame(jtr, gray, _duplicates(False))
    _, j1, jpid1, _, (jold, _, jslots) = _track_frame(jtr, gray, _duplicates(True))
    assert np.isin(jpid1[jslots], jold).all()
    print(f"motion-model matches: port {c0['mm']} -> {c1['mm']}, JAX {j0['mm']} -> "
          f"{j1['mm']} with {len(jslots)} of the last frame's points merged")
    assert j1["mm"] < j0["mm"] - len(jslots) // 2


def test_a_slot_handed_out_again_is_not_the_last_frames_point(runs):
    """A point the last frame tracked is merged and its slot handed out
    again to a new point before the next frame: the port follows the slot's
    previous life to the replacement and stages it as the last frame's
    point, counting the ids it resolved so (the last frame's and the local
    selection's) and losing none; the JAX package stages the new, unrelated
    point as the last frame's."""
    gray = runs["frames"][N_FRAMES]

    def reuse(fork):
        m, ids = fork.map, fork.last_frame.pt_ids
        p = int(ids[ids >= 0][0])
        with fork.map_lock:
            d = m.add_point(m.pt_pos[p].copy(), m.pt_desc[p].copy(), int(m.pt_ref_kf[p]), 0)
            m.replace_points([(p, d)])
            q = m.add_point(m.pt_pos[p] + 1.0, ~m.pt_desc[p], int(m.pt_ref_kf[p]), 0)
        assert q == p                      # the slot free list hands it out first
        counts = None
        if type(fork) is ttracking.Tracker:
            in_sel = 0 if fork._local_pts is None else int((fork._local_pts == p).sum())
            counts = (fork.reused_slot_ids, fork.replacements_lost, in_sel)
        return p, d, np.flatnonzero(ids == p), counts

    for system, pkg in ((runs["system"], "torch"), (runs["jsys"], "jax")):
        fork, _, pid, _, (p, d, slots, counts) = _track_frame(system.tracker, gray, reuse)
        if pkg == "torch":
            assert (pid[slots] == d).all()
            assert p not in fork.last_frame.pt_ids
            reused, lost, in_sel = counts
            assert fork.reused_slot_ids - reused == len(slots) + in_sel
            assert fork.replacements_lost == lost
        else:
            assert (pid[slots] == p).all()


def test_a_frame_in_flight_keeps_the_replacement_of_a_reused_slot(runs):
    """The pipelined apply: a point the frame in flight matched is merged,
    and its slot handed out again, before the frame is applied. The apply
    resolves the id to the replacement through the slot's previous life,
    counts it, and drops the device carry."""
    gray = runs["frames"][N_FRAMES]
    seen = {}

    def hook(fork):
        apply_ = fork._fused_apply

        def reuse_then_apply(rec, fetched):
            m, pid, outl = fork.map, np.asarray(fetched[1]), np.asarray(fetched[2])
            ok = (pid >= 0) & ~outl
            p = int(pid[ok][0])
            with fork.map_lock:
                d = m.add_point(m.pt_pos[p].copy(), m.pt_desc[p].copy(),
                                int(m.pt_ref_kf[p]), 0)
                m.replace_points([(p, d)])
                assert m.add_point(m.pt_pos[p] + 1.0, ~m.pt_desc[p], int(m.pt_ref_kf[p]), 0) == p
            held = (int((fork.last_frame.pt_ids == p).sum())
                    + int((fork._local_pts == p).sum()) + int((pid == p).sum()))
            seen.update(p=p, d=d, at=np.flatnonzero(pid == p), held=held,
                        before=(fork.reused_slot_ids, fork.replacements_lost))
            return apply_(rec, fetched)

        fork._fused_apply = reuse_then_apply

    fork, _, _, _, _ = _track_frame(runs["system"].tracker, gray, hook)
    assert (fork.last_frame.pt_ids[seen["at"]] == seen["d"]).all()
    assert seen["p"] not in fork.last_frame.pt_ids
    reused, lost = seen["before"]
    assert fork.reused_slot_ids - reused == seen["held"] and fork.replacements_lost == lost
    assert fork._last_pid_dev is None
