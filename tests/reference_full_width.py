#!/usr/bin/env python3
"""The JAX package, and the port beside it, on the CPU over two of
chip_smoke.py's full-width drives, so that what the port does on the card
can be read against the reference on the same frames. Not a test (pytest
does not collect it): one drive takes minutes at 640x480.

    python3 tests/reference_full_width.py localization jax
    python3 tests/reference_full_width.py localization torch
    python3 tests/reference_full_width.py defaults jax --fetch-batch 4
    python3 tests/reference_full_width.py defaults torch --no-rescue
    python3 tests/reference_full_width.py mono jax
    python3 tests/reference_full_width.py mono-loop jax

Drives, at phase 5's geometry (640x480, fx=fy=520, bf=40, 2000 features,
8 levels, 16 384 points, a local map of 4 096, 64 keyframes, th_depth 6):

- ``localization``: phase 15's full-width drive, tests/test_localization_vo.py's
  scenario (the shuttle in the cluttered world, seed 9, no vocabulary,
  max_frames_between_kf 10, min_init_features 300): 6 frames mapped, 24 in
  localization mode, with change_calibration to the same camera before
  frame 12.
- ``defaults``: phase 14's drive, 60 frames of the shuttle in the cluttered
  world, seed 3, back to back with every other SLAMConfig field at its
  default (the pipelined fetch, the mapping worker) and ``--fetch-batch``.
- ``mono``: phase 17a's drive, tests/test_e2e_mono.py's at full width: 60
  frames of the lateral sequence, seed 5, through SLAMSystem.track_monocular
  back to back, no vocabulary, 64 keyframes, max_frames_between_kf 10, every
  other field at its default (the pipelined fetch, mapping inline at
  keyframe insertion).
- ``mono-loop``: phase 17c's drive,
  tests/test_mono_extra.py::test_circuit_loop_fix_scale_false at full width:
  200 frames of circuit3 in the room world, seed 9, exposure 0.35, the
  10 000-word vocabulary, loop consistency 2, kf_cull_redundancy 2.0, 96
  keyframes, max_frames_between_kf 8, the worker waited for before each
  frame. Takes many minutes.

The JAX package's mono outcome depends on whether its native map-graph
library loaded (ROADMAP.md, Queue 3, "Watch"): its mono drives print
``jax_native``.

Tracked frames come from the lost mask, read after the frames in flight are
applied (in the JAX package the mask does not apply them itself). The last
line is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CAM_KW = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
CAP_KW = dict(max_points=16384, local_point_cap=4096, max_keyframes=64, th_depth=6.0)
LOC_MAPPED, LOC_FRAMES = 6, 24
LOC_CALIB = 12
N_DEFAULTS = 60
N_MONO, N_MONO_LOOP = 60, 200


def packages(pkg: str):
    """(PinholeCamera, ORBConfig, SLAMConfig, SLAMSystem, Sensor, SyntheticSequence,
    ate_rmse, rpe, extra SLAMSystem keywords) of one package."""
    if pkg == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from orbslam2_tpu.frontend.tracking import SLAMConfig
        from orbslam2_tpu.geometry.camera import PinholeCamera
        from orbslam2_tpu.io.evaluate import ate_rmse, rpe
        from orbslam2_tpu.io.synthetic import SyntheticSequence
        from orbslam2_tpu.ops.orb import ORBConfig
        from orbslam2_tpu.system import SLAMSystem, Sensor
        return (PinholeCamera, ORBConfig, SLAMConfig, SLAMSystem, Sensor,
                SyntheticSequence, ate_rmse, rpe, {})
    import torch
    torch.set_num_threads(4)
    from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
    from orbslam2_tpu_torch.geometry.camera import PinholeCamera
    from orbslam2_tpu_torch.io.evaluate import ate_rmse, rpe
    from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam2_tpu_torch.ops.orb import ORBConfig
    from orbslam2_tpu_torch.system import SLAMSystem, Sensor
    return (PinholeCamera, ORBConfig, SLAMConfig, SLAMSystem, Sensor,
            SyntheticSequence, ate_rmse, rpe, {"device": "cpu"})


def localization(pkg: str) -> dict:
    Cam, ORB, Cfg, System, Sensor, Seq, _, rpe, kw = packages(pkg)
    cam = Cam(**CAM_KW)
    cfg = Cfg(cam=cam, orb=ORB(n_features=2000, n_levels=8), max_frames_between_kf=10,
              min_init_features=300, **CAP_KW)
    n_all = LOC_MAPPED + LOC_FRAMES
    seq = Seq(cam, n_frames=60, trajectory="shuttle", seed=9, world="cluttered")
    system = System(cfg, Sensor.RGBD, **kw)
    tracker = system.tracker
    for i in range(LOC_MAPPED):
        system.track_rgbd(*seq.render(i), i / seq.fps)
    system.activate_localization_mode()
    m = system.map
    frozen = (m.n_points(), m.n_keyframes(), m.pt_pos.copy(), m.kf_pose.copy())
    vo = []
    for i in range(LOC_MAPPED, n_all):
        if i == LOC_CALIB:
            system.change_calibration(Cam(**dataclasses.asdict(cam)))
        system.track_rgbd(*seq.render(i), i / seq.fps)
        vo.append(bool(tracker.mb_vo))
    est = tracker.full_trajectory_twc()[LOC_MAPPED:n_all]   # applies the frames in flight
    lost = tracker.trajectory_lost_mask()[LOC_MAPPED:n_all]
    gt = np.stack([np.linalg.inv(seq.poses[i]) for i in range(LOC_MAPPED, n_all)])
    t_rpe, r_rpe = rpe(est, gt)
    ok = ~lost
    t_rpe_tracked = float("nan")
    if ok.sum() >= 2:
        t_rpe_tracked = float(rpe(est[ok], gt[ok])[0])
    unchanged = (m.n_points() == frozen[0] and m.n_keyframes() == frozen[1]
                 and np.array_equal(m.pt_pos, frozen[2]) and np.array_equal(m.kf_pose, frozen[3]))
    calib_ok = not bool(lost[LOC_CALIB - LOC_MAPPED])
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    system.shutdown()
    return dict(tracked=int(ok.sum()), lost=(np.flatnonzero(lost) + LOC_MAPPED).tolist(),
                vo_frames=[LOC_MAPPED + i for i, v in enumerate(vo) if v],
                rpe_m=float(t_rpe), rpe_rad=float(r_rpe), rpe_tracked_m=t_rpe_tracked,
                map_frozen=bool(unchanged), keyframes=int(frozen[1]), points=int(frozen[0]),
                position_error_m=[round(float(e), 4) for e in err],
                tracked_after_change_calibration=calib_ok)


def defaults(pkg: str, k: int) -> dict:
    Cam, ORB, Cfg, System, Sensor, Seq, ate_rmse, _, kw = packages(pkg)
    cam = Cam(**CAM_KW)
    cfg = Cfg(cam=cam, orb=ORB(n_features=2000, n_levels=8), fetch_batch=k, **CAP_KW)
    seq = Seq(cam, n_frames=N_DEFAULTS, trajectory="shuttle", seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(N_DEFAULTS)]
    system = System(cfg, Sensor.RGBD, **kw)
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(frames):
        system.track_rgbd(g, d, i / seq.fps)
    tracker = system.tracker
    tracker.full_trajectory_twc()   # applies the frames in flight
    system.wait_mapping_idle()
    s = time.perf_counter() - t0
    est = tracker.full_trajectory_twc()
    lost = tracker.trajectory_lost_mask()
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    ate = ate_rmse(est, gt)
    out = dict(tracked=int((~lost).sum()), n=int(len(lost)),
               lost=np.flatnonzero(lost).tolist(), ate_m=float(ate),
               keyframes=int(system.map.n_keyframes()), seconds=s)
    system.shutdown()
    return out


def watch_initializer(pkg: str) -> list:
    """Record every two-view solve of the package's tracker: -> a list that
    fills with (success, used_homography, n_good)."""
    if pkg == "jax":
        from orbslam2_tpu.solvers import initializer
    else:
        from orbslam2_tpu_torch.solvers import initializer
    solve, seen = initializer.initialize_two_view, []

    def wrapped(*a, **k):
        res = solve(*a, **k)
        seen.append((bool(res.success), bool(res.used_homography), int(res.n_good)))
        return res

    initializer.initialize_two_view = wrapped
    return seen


def jax_native(pkg: str):
    if pkg != "jax":
        return None
    from orbslam2_tpu.slammap import native
    return bool(native.available())


def mono(pkg: str) -> dict:
    Cam, ORB, Cfg, System, Sensor, Seq, ate_rmse, _, kw = packages(pkg)
    cam = Cam(**CAM_KW)
    cfg = Cfg(cam=cam, orb=ORB(n_features=2000, n_levels=8), max_keyframes=64,
              max_points=16384, local_point_cap=4096, max_frames_between_kf=10)
    seq = Seq(cam, n_frames=N_MONO, trajectory="lateral", seed=5)
    frames = [seq.render(i)[0] for i in range(N_MONO)]
    solves = watch_initializer(pkg)
    system = System(cfg, Sensor.MONOCULAR, **kw)
    t0 = time.perf_counter()
    for i, g in enumerate(frames):
        system.track_monocular(g, i / seq.fps)
    tracker = system.tracker
    est = tracker.full_trajectory_twc()   # applies the frames in flight
    s = time.perf_counter() - t0
    lost = tracker.trajectory_lost_mask()
    ok_at = np.flatnonzero(~lost)
    first = int(ok_at[0]) if len(ok_at) else None
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    out = dict(first_ok=first, tracked=int(len(ok_at)), n=int(len(lost)),
               lost_after_init=[] if first is None else
               (np.flatnonzero(lost[first:]) + first).tolist(),
               keyframes=int(system.map.n_keyframes()), points=int(system.map.n_points()),
               ate_sim3_m=None if first is None else
               float(ate_rmse(est[first:], gt[first:], with_scale=True)),
               two_view_solves=solves, seconds=s, jax_native=jax_native(pkg))
    system.shutdown()
    return out


def seg_scale_error(est_twc, gt_twc) -> float:
    """tests/test_mono_extra.py's scale error: the median |log| of the
    per-step translation ratio, normalised by its early median."""
    e = np.diff(est_twc[:, :3, 3], axis=0)
    g = np.diff(gt_twc[:, :3, 3], axis=0)
    en, gn = np.linalg.norm(e, axis=1), np.linalg.norm(g, axis=1)
    keep = (gn > 1e-4) & (en > 1e-9)
    r = en[keep] / gn[keep]
    r = r / np.median(r[: max(5, len(r) // 10)])
    return float(np.median(np.abs(np.log(r))))


def mono_loop(pkg: str) -> dict:
    Cam, ORB, Cfg, System, Sensor, Seq, ate_rmse, _, kw = packages(pkg)
    if pkg == "jax":
        from orbslam2_tpu.place.pretrained import get_large_vocabulary
    else:
        from orbslam2_tpu_torch.place.pretrained import get_large_vocabulary
    cam = Cam(**CAM_KW)
    cfg = Cfg(cam=cam, orb=ORB(n_features=2000, n_levels=8), max_keyframes=96,
              max_points=16384, local_point_cap=4096, max_frames_between_kf=8)
    seq = Seq(cam, n_frames=N_MONO_LOOP, trajectory="circuit3", seed=9, world="room",
              exposure=0.35)
    system = System(cfg, Sensor.MONOCULAR, vocabulary=get_large_vocabulary(), **kw)
    closer = system.loop_closer
    closer.cfg.consistency_threshold = 2
    system.local_mapper.cfg.kf_cull_redundancy = 2.0
    tracker = system.tracker
    pre, t0 = None, time.perf_counter()
    for i in range(N_MONO_LOOP):
        system.track_monocular(seq.render(i)[0], i / seq.fps)
        system.wait_mapping_idle(timeout=30.0)
        if closer.n_loops_closed == 0 and i % 10 == 9:
            pre = tracker.full_trajectory_twc(wait=False)
    system.wait_mapping_idle()
    s = time.perf_counter() - t0
    post = tracker.full_trajectory_twc()
    lost = tracker.trajectory_lost_mask()
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    out = dict(fix_scale=bool(closer.cfg.fix_scale), loops=int(closer.n_loops_closed),
               tracked=int((~lost).sum()), n=int(len(lost)),
               keyframes=int(system.map.n_keyframes()), points=int(system.map.n_points()),
               seconds=s, jax_native=jax_native(pkg))
    if pre is not None and closer.n_loops_closed:
        n_pre = len(pre)
        keep_pre = ~lost[:n_pre]
        out.update(pre_frames=n_pre,
                   pre_scale=seg_scale_error(pre[keep_pre], gt[:n_pre][keep_pre]),
                   window_scale=seg_scale_error(post[:n_pre][keep_pre], gt[:n_pre][keep_pre]),
                   full_scale=seg_scale_error(post[~lost], gt[~lost]))
    out["ate_sim3_m"] = float(ate_rmse(post[~lost], gt[~lost], with_scale=True))
    system.shutdown()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("drive", choices=["localization", "defaults", "mono", "mono-loop"])
    ap.add_argument("package", choices=["jax", "torch"])
    ap.add_argument("--fetch-batch", type=int, default=1)
    ap.add_argument("--no-rescue", action="store_true",
                    help="the port only: lose a pipelined frame that failed after chaining "
                         "across a keyframe, as the JAX package does, instead of dispatching "
                         "it again (ROADMAP.md, deliberate divergences)")
    a = ap.parse_args()
    if a.no_rescue:
        from orbslam2_tpu_torch.frontend.tracking import Tracker
        Tracker._missed_keyframe = lambda self, rec: False
    t0 = time.perf_counter()
    drives = {"localization": localization, "mono": mono, "mono-loop": mono_loop,
              "defaults": lambda pkg: defaults(pkg, a.fetch_batch)}
    res = drives[a.drive](a.package)
    res.update(drive=a.drive, package=a.package, fetch_batch=a.fetch_batch,
               no_rescue=a.no_rescue, device="cpu", wall_s=time.perf_counter() - t0)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
