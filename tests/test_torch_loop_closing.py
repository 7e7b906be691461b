"""Loop closing of the port against the JAX package, on the CPU: the loop
correction's edge measurements, a second loop beside a GBA waiting to
apply, and the slice as a whole, with the essential graph of its loop.
(The GBA bookkeeping and the worker's failure rule are in
test_torch_loop_bookkeeping.py; SearchBySim3 and the essential graph on a
ring are in test_torch_sim3.py, the global BA's PCG solve there too.)

The whole-slice test drives the port along the panorama at the verify
geometry (320x240, 800 features, 4 levels, consistency threshold 2; a cut of
50 frames instead of 100, a keyframe every third frame, so that the loop
closes at about frame 42 instead of 76), keeps the map, the keyframe
database and the loop closer's state just before the keyframe that closes
the loop, and hands copies of them to the JAX LoopCloser and to the port's,
the port drawing the RANSAC sets JAX draws. Both must close the loop on the
same keyframe and correct every keyframe pose to within 1e-3 m.

Tolerances: the essential graph of that loop, solved by the port in float32
on the JAX package's input, within 1e-3 m on camera centres (the conjugate
gradients sum in another order and the LM steps compound the difference);
edge measurements 1e-5.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from orbslam2_tpu.frontend import loop_closing as jlc
from orbslam2_tpu.geometry.camera import PinholeCamera as JCamera
from orbslam2_tpu.place import vocabulary as jvoc
from orbslam2_tpu.slammap import mapstate as jmapstate
from orbslam2_tpu.slammap.keyframe_db import KeyFrameDatabase as JKFDB
from orbslam2_tpu_torch import convert
from orbslam2_tpu_torch.backend import pose_graph
from orbslam2_tpu_torch.frontend import local_mapping
from orbslam2_tpu_torch.frontend import loop_closing as lc
from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.slammap import covisibility
from orbslam2_tpu_torch.slammap.mapstate import MapCapacity, MapState
from orbslam2_tpu_torch.solvers import horn
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

from torch_port_helpers import camera_centres as centres
from torch_port_helpers import beside, jax_sample_sets, n, t

CAM_KW = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=26.0)
JCAM, TCAM = JCamera(**CAM_KW), PinholeCamera(**CAM_KW)


# ----------------------------------------------------------------------
# Loop correction's edge measurements (tests/test_loop_semantics.py)
# ----------------------------------------------------------------------
def _line_map(n_kf=6, pts_per_kf=40):
    """tests/test_loop_semantics.py's map on the port's MapState: keyframes
    along +x, each observing its own points and half of the previous
    keyframe's."""
    rng = np.random.default_rng(0)
    m = MapState(MapCapacity(max_keyframes=8, max_points=512, n_features=64))
    for k in range(n_kf):
        m.kf_valid[k] = True
        m.kf_order[k] = k
        m.kf_pose[k] = np.eye(4, dtype=np.float32)
        m.kf_pose[k][0, 3] = -k * 0.5
        m.kf_kp_valid[k] = True
        m.kf_kp_xy[k] = rng.uniform([0, 0], [320, 240], (64, 2))
    m._kf_counter = n_kf
    m.kf_parent[1:n_kf] = np.arange(n_kf - 1)
    pid = 0
    for k in range(n_kf):
        for jj in range(pts_per_kf):
            m.pt_valid[pid] = True
            m.pt_pos[pid] = [k * 0.5 + rng.uniform(-0.2, 0.2), rng.uniform(-1, 1),
                             rng.uniform(3, 6)]
            m.pt_ref_kf[pid] = k
            m.pt_stamp[pid] = pid
            m.kf_pt[k, jj] = pid
            pid += 1
    m._pt_counter = pid
    for k in range(n_kf - 1):
        base = k * pts_per_kf
        m.kf_pt[k + 1, 40:60] = np.arange(base, base + 20)
    m.touch_obs()
    return m


@pytest.fixture
def stubbed(monkeypatch):
    """Capture what loop correction hands the essential graph (which returns
    its input) and fuse nothing."""
    captured = {}

    def fake_opt(poses, valid, fixed, e_i, e_j, meas, e_valid, fix_scale):
        captured.update(e_i=n(e_i), e_j=n(e_j), meas=n(meas), init=n(poses))
        return poses, None

    def fake_fuse(target_ids, pose, xy, *rest, **kw):
        return torch.full((len(target_ids), xy.shape[1]), -1, dtype=torch.int32)

    monkeypatch.setattr(lc.pose_graph, "optimize_essential_graph", fake_opt)
    monkeypatch.setattr(local_mapping.kernels, "fuse_targets", fake_fuse)
    return captured


def _closer(m, **cfg):
    closer = lc.LoopCloser(m, TCAM, None, lc.LoopCloserConfig(run_global_ba=False, **cfg),
                           device="cpu")
    return closer


def _edge_meas(cap, a, b):
    sel = (cap["e_i"] == a) & (cap["e_j"] == b)
    assert sel.any(), f"edge ({a},{b}) missing from the graph"
    return cap["meas"][np.where(sel)[0][0]]


def test_loop_edges_measure_pre_and_post_correction(stubbed):
    m = _line_map()
    pre = m.kf_pose.copy()
    w = covisibility.weight_matrix(m)
    kf, loop_kf = 5, 0
    assert w[kf, kf - 1] >= covisibility.COVIS_THRESHOLD
    s_cw = pre[loop_kf].copy()
    s_cw[0, 3] -= 0.12
    _closer(m)._correct_loop(kf, loop_kf, s_cw, w)
    cap = stubbed
    # a spanning-tree edge outside the window: the pre-correction relative
    np.testing.assert_allclose(_edge_meas(cap, 0, 1), pre[1] @ np.linalg.inv(pre[0]),
                               atol=1e-5)
    # the boundary edge (3,4): KF4 was corrected in the map, but the edge
    # existed before the loop and measures KF4's pre-correction pose
    np.testing.assert_allclose(_edge_meas(cap, 3, 4), pre[4] @ np.linalg.inv(pre[3]),
                               atol=1e-5)
    assert not np.allclose(m.kf_pose[4], pre[4], atol=1e-4)
    # the loop edge measures the corrected relative S5_corr S0^-1
    s5_corr = pre[kf] @ np.linalg.inv(pre[kf]) @ s_cw
    np.testing.assert_allclose(_edge_meas(cap, 0, kf), s5_corr @ np.linalg.inv(pre[0]),
                               atol=1e-5)
    np.testing.assert_allclose(cap["init"][kf], s5_corr, atol=1e-5)
    assert cap["meas"].dtype == np.float64      # staged in float64
    assert m.correction_gen == 1 and 0 in m.kf_loop_edges[5] and 5 in m.kf_loop_edges[0]


def test_window_points_remap_through_first_observer(stubbed):
    m = _line_map()
    pre_pts = m.pt_pos.copy()
    w = covisibility.weight_matrix(m)
    kf, loop_kf = 5, 0
    s_cw = m.kf_pose[loop_kf].copy()
    s_cw[0, 3] -= 0.12
    _closer(m)._correct_loop(kf, loop_kf, s_cw, w)
    win = [kf, *map(int, covisibility.covisible_neighbors(w, kf))]
    only_window = [p for p in range(m.cap.max_points) if m.pt_valid[p]
                   and all(k in win for k, _ in m.point_observations(p))]
    moved = [p for p in only_window
             if not np.allclose(m.pt_pos[p], pre_pts[p], atol=1e-5)]
    assert len(moved) > 0
    far = [p for p in range(40) if m.pt_valid[p]
           and all(k not in win for k, _ in m.point_observations(p))]
    for p in far[:10]:
        np.testing.assert_allclose(m.pt_pos[p], pre_pts[p], atol=1e-5)


# ----------------------------------------------------------------------
# Global BA bookkeeping: propagation, supersession, a failing thread
# ----------------------------------------------------------------------
def _snap(m, idx):
    return {"idx": idx, "fixed_kf": 0, "problem": None, "pt_fixed": None,
            "kf_in": m.kf_valid.copy(), "kf_order": m.kf_order.copy(),
            "pt_in": m.pt_valid.copy(), "pt_stamp": m.pt_stamp.copy()}


def _grow(m):
    """A keyframe (child of keyframe 5) and a point created after a
    snapshot, in the port's map and, through the same calls, in JAX's."""
    n_feat = m.cap.n_features
    kf = m.add_keyframe(
        pose=np.eye(4, dtype=np.float32), timestamp=9.0, frame_id=9,
        kp_xy=np.zeros((n_feat, 2), np.float32), kp_octave=np.zeros(n_feat, np.int32),
        kp_angle=np.zeros(n_feat, np.float32), kp_response=np.ones(n_feat, np.float32),
        kp_desc=np.zeros((n_feat, 8), np.uint32), kp_valid=np.ones(n_feat, bool),
        kp_ur=np.full(n_feat, -1, np.float32), kp_depth=np.full(n_feat, -1, np.float32))
    m.kf_parent[kf] = 5
    m.kf_pose[kf, 0, 3] = -2.9
    pt = m.add_point(np.array([1.0, 2.0, 3.0], np.float32), np.zeros(8, np.uint32), 5, 9)
    return kf, pt


def test_a_second_loop_does_not_wait_for_a_gba_waiting_to_apply(stubbed, monkeypatch):
    """Loop correction runs under the worker's map lock, and a GBA whose
    solve is done waits for that lock to apply. A second loop closed
    meanwhile starts its own GBA at once instead of joining the first under
    the lock; the first, superseded, discards its result."""
    m = _line_map()
    closer = _closer(m, async_gba=True)
    closer.cfg.run_global_ba = True
    solved = threading.Semaphore(0)

    class Res:
        def __init__(self, problem):
            self.poses, self.points = problem.poses, problem.points

    def solve(problem, cam, **kw):
        solved.release()
        return Res(problem)

    monkeypatch.setattr(lc.ba, "bundle_adjust_pcg", solve)
    s_cw = m.kf_pose[0].copy()
    s_cw[0, 3] -= 0.12
    finished, errors = threading.Event(), []

    def worker():
        try:
            with closer.map_lock:
                closer._correct_loop(5, 0, s_cw, covisibility.weight_matrix(m))
                assert solved.acquire(timeout=30)    # the first GBA waits to apply
                closer._correct_loop(5, 0, s_cw, covisibility.weight_matrix(m))
                finished.set()
        except Exception as e:
            errors.append(e)
            finished.set()

    threading.Thread(target=worker, daemon=True).start()
    assert finished.wait(30), "the second loop waited for the first GBA under the lock"
    assert not errors, errors
    assert closer.wait_gba(30)
    assert len(closer._gba_threads) == 2
    assert not any(th.is_alive() for th in closer._gba_threads)
    assert (closer.n_gba_applied, closer.n_gba_superseded) == (1, 1)
    assert closer.full_ba_idx == 2


# ----------------------------------------------------------------------
# The slice as a whole
# ----------------------------------------------------------------------
N_FRAMES = 50


@pytest.fixture(scope="module")
def drive():
    """The port on the panorama, mapping inline, until the loop closes; the
    map, keyframe database and loop-closer state just before the keyframe
    that closed it."""
    cfg = SLAMConfig(cam=TCAM, orb=ORBConfig(n_features=800, n_levels=4), th_depth=4.0,
                     max_keyframes=96, local_point_cap=2048, max_frames_between_kf=5,
                     min_init_features=300, force_kf_every=3, async_mapping=False,
                     pipelined_fetch=False)
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=get_default_vocabulary(), device="cpu")
    closer = system.loop_closer
    closer.cfg.consistency_threshold = 2
    closer.cfg.run_global_ba = False
    staged = {}
    process = closer.process_keyframe

    def staging(kf, wids):
        before = dict(
            map={k: copy.deepcopy(v) for k, v in vars(system.map).items()
                 if k not in ("_device_mirror", "_device_kf_store")},
            kfdb=(system.kfdb.wids.copy(), system.kfdb.wts.copy(), system.kfdb.valid.copy()),
            groups=copy.deepcopy(closer._consistent_groups),
            last_order=closer.last_loop_kf_order, kf=kf, wids=wids.copy())
        closed = process(kf, wids)
        if closed and "loop" not in staged:
            staged["loop"] = before
        return closed

    closer.process_keyframe = staging
    seq = SyntheticSequence(TCAM, n_frames=N_FRAMES, trajectory="panorama", seed=7,
                            world="room")
    returns = []
    for i in range(N_FRAMES):
        returns.append(system.track_rgbd(*seq.render(i), i / seq.fps))
        if "loop" in staged:
            break
    system.shutdown()
    return dict(staged=staged.get("loop"), returns=returns, system=system)


def test_the_drive_closes_the_loop(drive):
    assert drive["staged"] is not None, "no loop closed in the panorama cut"
    assert all(r is not None for r in drive["returns"])
    assert drive["system"].loop_closer.n_loops_closed == 1


@pytest.fixture(scope="module")
def closers(drive):
    """The JAX LoopCloser and the port's on copies of the staged state, the
    port drawing the RANSAC sets JAX draws; JAX's essential-graph problem
    and solution are recorded."""
    snap = drive["staged"]
    assert snap is not None, "no loop closed in the panorama cut"
    voc = get_default_vocabulary()
    cfg_kw = dict(scale_factor=1.2, n_levels=4, consistency_threshold=2,
                  run_global_ba=False, async_gba=False)
    cap = snap["map"]["cap"]
    jm = jmapstate.MapState(jmapstate.MapCapacity(cap.max_keyframes, cap.max_points,
                                                  cap.n_features))
    for name in vars(jm):
        if name in snap["map"] and name != "cap":
            setattr(jm, name, copy.deepcopy(snap["map"][name]))
    jdb = JKFDB(jvoc.Vocabulary(k=voc.k, levels=voc.levels, centers=voc.centers,
                                word_weights=voc.word_weights, n_words=voc.n_words),
                cap.max_keyframes)
    jdb.wids[:], jdb.wts[:], jdb.valid[:] = snap["kfdb"]
    jcloser = jlc.LoopCloser(jm, JCAM, jdb, jlc.LoopCloserConfig(**cfg_kw))
    tm = convert.map_state_from_numpy(snap["map"])
    tdb = convert.keyframe_db_from_numpy(voc, *snap["kfdb"])
    tcloser = lc.LoopCloser(tm, TCAM, tdb, lc.LoopCloserConfig(**cfg_kw), device="cpu")
    for closer in (jcloser, tcloser):
        closer._consistent_groups = copy.deepcopy(snap["groups"])
        closer.last_loop_kf_order = snap["last_order"]

    eg = {}
    solve_eg = jlc.pose_graph.optimize_essential_graph

    def recording(*args, **kw):
        out = solve_eg(*args, **kw)
        eg.update(args=[n(a) for a in args], kw=kw, out=n(out[0]))
        return out

    draw = horn.draw_sample_sets
    horn.draw_sample_sets = jax_sample_sets
    jlc.pose_graph.optimize_essential_graph = recording
    try:
        kf, wids = snap["kf"], snap["wids"]
        # each closer on its own map copy, the port's beside JAX's
        closed = beside(lambda: jcloser.process_keyframe(kf, wids),
                        lambda: tcloser.process_keyframe(kf, wids))
    finally:
        horn.draw_sample_sets = draw
        jlc.pose_graph.optimize_essential_graph = solve_eg
    return dict(snap=snap, closed=closed, jm=jm, tm=tm, eg=eg)


def test_loop_closer_matches_jax_on_the_staged_map(closers):
    snap, jm, tm = closers["snap"], closers["jm"], closers["tm"]
    kf = snap["kf"]
    assert closers["closed"] == (True, True)
    assert tm.kf_loop_edges[kf] == jm.kf_loop_edges[kf] and len(tm.kf_loop_edges[kf]) == 1
    live = tm.kf_valid
    np.testing.assert_array_equal(live, jm.kf_valid)
    diff = np.linalg.norm(centres(tm.kf_pose[live]) - centres(jm.kf_pose[live]), axis=-1)
    assert diff.max() < 1e-3, diff
    # the correction moved the keyframe that closed the loop
    assert np.linalg.norm(centres(tm.kf_pose[kf]) - centres(snap["map"]["kf_pose"][kf])) > 1e-3
    assert tm.correction_gen == jm.correction_gen


def test_essential_graph_matches_jax_on_the_loop(closers):
    """The loop's own essential graph (every keyframe slot, the loop edges
    and the essential edges), solved by the port in float32 on JAX's input."""
    eg = closers["eg"]
    args = eg["args"]
    p_t, _ = pose_graph.optimize_essential_graph(*map(t, args), **eg["kw"])
    live = args[1]
    assert live.sum() >= 10 and len(args[3]) >= live.sum()
    diff = np.linalg.norm(centres(n(p_t)[live]) - centres(eg["out"][live]), axis=-1)
    assert diff.max() < 1e-3, diff
