#!/usr/bin/env python3
"""The JAX package, and the port beside it, on the CPU over two of
chip_smoke.py's full-width drives, so that what the port does on the card
can be read against the reference on the same frames. Not a test (pytest
does not collect it): one drive takes minutes at 640x480.

    python3 tests/reference_full_width.py localization jax
    python3 tests/reference_full_width.py localization torch
    python3 tests/reference_full_width.py defaults jax --fetch-batch 4
    python3 tests/reference_full_width.py defaults torch --no-rescue

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("drive", choices=["localization", "defaults"])
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
    res = localization(a.package) if a.drive == "localization" else \
        defaults(a.package, a.fetch_batch)
    res.update(drive=a.drive, package=a.package, fetch_batch=a.fetch_batch,
               no_rescue=a.no_rescue, device="cpu", wall_s=time.perf_counter() - t0)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
