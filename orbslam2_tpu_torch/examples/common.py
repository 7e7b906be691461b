"""Shared driver plumbing for the example mains.

Counterpart of the JAX package's ``examples/common.py``, and of what every
reference example binary does around the System calls (e.g.
Examples/RGB-D/rgbd_tum.cc:61-124): construct the system from (vocabulary,
settings), loop over the frames with timing statistics, save the
trajectories, print the median/mean track time (stereo_kitti.cc:131-141)
and, with ``--eval``, ATE and RPE against a ground-truth file.

The flags are the JAX drivers', with ``--device`` (``cuda`` unless ``cpu``
is asked for: without a card a driver raises, it never falls back to the
CPU). ``--viewer`` starts the live viewer (``viewer/live.py``) beside the
run, in every driver (the JAX package's ``rgbd_tum`` alone takes it): cv2
windows where a display and OpenCV exist, else ``latest_frame.jpg`` and
``latest_map.jpg`` published into ``--viewer-dir``. Images are read by the
port's own PNG reader: no OpenCV is needed.
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Iterable

import numpy as np

from orbslam2_tpu_torch.io.settings import load_settings
from orbslam2_tpu_torch.system import SLAMSystem, Sensor


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("settings", help="reference-format settings YAML")
    p.add_argument("--vocabulary", default=None,
                   help="vocabulary .npz (default: the largest packaged vocabulary)")
    p.add_argument("--no-loop-closing", action="store_true")
    p.add_argument("--localization", action="store_true",
                   help="localization-only mode (no mapping)")
    p.add_argument("--trajectory-out", default="CameraTrajectory.txt")
    p.add_argument("--kf-trajectory-out", default="KeyFrameTrajectory.txt")
    p.add_argument("--kitti-trajectory-out", default=None)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--profile-stages", action="store_true",
                   help="print per-stage timing statistics at the end")
    p.add_argument("--device-trace", default=None,
                   help="directory for a torch.profiler trace of the run (Chrome format)")
    p.add_argument("--viewer", action="store_true",
                   help="live viewer (cv2 windows with a display; "
                        "latest_frame.jpg/latest_map.jpg without one)")
    p.add_argument("--viewer-dir", default=".",
                   help="publish directory for the headless live viewer")
    p.add_argument("--device", default="cuda",
                   help="where the system runs: cuda (the default; raises without a "
                        "card) or cpu")
    p.add_argument("--eval", default=None, metavar="GT_FILE",
                   help="ground-truth trajectory; prints ATE-RMSE and RPE "
                        "after the run (TUM format: 'ts tx ty tz qx qy qz "
                        "qw' with nearest-timestamp association, or KITTI "
                        "format: per-frame 3x4 rows, index-associated)")
    p.add_argument("--eval-format", default="auto",
                   choices=("auto", "tum", "kitti"),
                   help="ground-truth file format (auto: sniff column count)")
    p.add_argument("--eval-scale", action="store_true",
                   help="Sim(3) alignment for the ATE (monocular: scale is "
                        "unobservable, the TUM tools' --scale analogue)")
    return p


def make_viewer(system, args):
    """-> LiveViewer or None (the reference gates its viewer thread on
    bUseViewer, System.cc:105-112)."""
    if not getattr(args, "viewer", False):
        return None
    from orbslam2_tpu_torch.viewer.live import LiveViewer
    return LiveViewer(system, out_dir=args.viewer_dir)


def make_system(args, sensor: Sensor, image_size=None,
                capacity_hint=None) -> SLAMSystem:
    """capacity_hint: (max_keyframes, max_points) dataset-scale default,
    applied only where the settings YAML does not set Map.MaxKeyFrames /
    Map.MaxPoints (long outdoor sequences need far more than the indoor
    defaults; KITTI 00 peaks at about 1400 keyframes / 150k points)."""
    cfg = load_settings(args.settings, image_size=image_size)
    if capacity_hint is not None:
        if cfg.max_keyframes == 256:
            cfg.max_keyframes = capacity_hint[0]
        if cfg.max_points == 16384:
            cfg.max_points = capacity_hint[1]
    voc = None
    if not args.no_loop_closing:
        if args.vocabulary:
            from orbslam2_tpu_torch.place.vocabulary import load_vocabulary
            voc = load_vocabulary(args.vocabulary)
        else:
            # the largest shipped vocabulary, as the reference mains always
            # load the full ORBvoc.txt
            from orbslam2_tpu_torch.place.pretrained import get_best_vocabulary
            voc = get_best_vocabulary()
    system = SLAMSystem(cfg, sensor, vocabulary=voc, device=args.device)
    if args.profile_stages:
        system.tracker.stats.enabled = True
    if args.localization:
        system.activate_localization_mode()
    return system


def run_loop(system: SLAMSystem, frames: Iterable, track: Callable,
             max_frames=None, trace_dir=None, viewer=None) -> None:
    """Track every item of ``frames`` with ``track(system, item)``; each
    item's (left) image goes to ``viewer`` after its frame, and the viewer
    is closed at the end."""
    from orbslam2_tpu_torch.utils.profiling import device_trace
    ctx = device_trace(trace_dir) if trace_dir else contextlib.nullcontext()
    times = []
    n = 0
    with ctx:
        for item in frames:
            # sustainable offline cadence: the reference mains sleep to the
            # dataset timestamps (mono_tum.cc:84-96), which lets the mapping
            # thread keep pace; offline, a frame waits instead while two
            # keyframes are queued for the worker: full speed while mapping
            # keeps up, and the map never starved of keyframes
            if system.mapping_worker is not None:
                t0 = time.perf_counter()
                while (system.mapping_worker.queue_size() >= 2
                       and time.perf_counter() - t0 < 10.0):
                    time.sleep(0.005)
            t0 = time.perf_counter()
            track(system, item)
            times.append(time.perf_counter() - t0)
            if viewer is not None:
                viewer.push_frame(item.gray if hasattr(item, "gray") else item.left)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    if viewer is not None:
        viewer.close()
    if times:
        times = np.array(times)
        print(f"tracked {n} frames: median {np.median(times)*1e3:.1f} ms, "
              f"mean {times.mean()*1e3:.1f} ms")
    if system.tracker.stats.enabled:
        print(system.tracker.stats.report())


def load_gt_trajectory(path: str, fmt: str = "auto"):
    """-> (timestamps or None, [N, 4, 4] Twc). TUM rows are
    't tx ty tz qx qy qz qw'; KITTI rows are 12 values of a 3x4 Twc (no
    timestamps: association is by frame index, as the KITTI devkit does)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.replace(",", " ").split()])
    arr = np.asarray(rows, np.float64)
    if fmt == "auto":
        fmt = "kitti" if arr.shape[1] == 12 else "tum"
    if fmt == "kitti":
        twc = np.tile(np.eye(4), (len(arr), 1, 1))
        twc[:, :3, :4] = arr.reshape(-1, 3, 4)
        return None, twc
    ts = arr[:, 0]
    t = arr[:, 1:4]
    x, y, z, w = arr[:, 4:8].T   # qx qy qz qw (TUM order)
    r = np.empty((len(arr), 3, 3))
    r[:, 0, 0] = 1 - 2 * (y * y + z * z)
    r[:, 0, 1] = 2 * (x * y - z * w)
    r[:, 0, 2] = 2 * (x * z + y * w)
    r[:, 1, 0] = 2 * (x * y + z * w)
    r[:, 1, 1] = 1 - 2 * (x * x + z * z)
    r[:, 1, 2] = 2 * (y * z - x * w)
    r[:, 2, 0] = 2 * (x * z - y * w)
    r[:, 2, 1] = 2 * (y * z + x * w)
    r[:, 2, 2] = 1 - 2 * (x * x + y * y)
    twc = np.tile(np.eye(4), (len(arr), 1, 1))
    twc[:, :3, :3] = r
    twc[:, :3, 3] = t
    return ts, twc


def evaluate_trajectory(system: SLAMSystem, args) -> dict | None:
    """--eval: associate the estimated trajectory with the ground-truth file
    and print ATE-RMSE and RPE, the in-process equivalent of the TUM
    benchmark's evaluate_ate/evaluate_rpe scripts. Frames are kept by the
    tracker's lost mask (the pipelined fetch returns a frame's result a
    frame late, so return values do not say which frames were tracked)."""
    if not args.eval:
        return None
    from orbslam2_tpu_torch.io.evaluate import ate_rmse, rpe
    gt_ts, gt_twc = load_gt_trajectory(args.eval, args.eval_format)
    est_twc = system.tracker.full_trajectory_twc()      # applies the frames in flight
    est_ts = np.array([e.timestamp for e in system.tracker.trajectory])
    tracked = np.flatnonzero(~system.tracker.trajectory_lost_mask())
    est_twc, est_ts = est_twc[tracked], est_ts[tracked]
    if gt_ts is None:
        # KITTI: index association, frame i with ground-truth row i (the JAX
        # driver pairs the tracked frames with the first rows instead, which
        # shifts them where frames before initialisation are lost)
        ok = tracked < len(gt_twc)
        est_a, gt_a = est_twc[ok], gt_twc[tracked[ok]]
        n_assoc = int(ok.sum())
    else:
        # TUM: nearest-timestamp association, 20 ms window (the TUM tools'
        # max_difference default)
        idx = np.searchsorted(gt_ts, est_ts)
        idx = np.clip(idx, 1, len(gt_ts) - 1)
        left = np.abs(gt_ts[idx - 1] - est_ts) < np.abs(gt_ts[idx] - est_ts)
        idx = np.where(left, idx - 1, idx)
        ok = np.abs(gt_ts[idx] - est_ts) <= 0.02
        est_a, gt_a = est_twc[ok], gt_twc[idx[ok]]
        n_assoc = int(ok.sum())
    if n_assoc < 3:
        print(f"eval: only {n_assoc} associated poses — skipping")
        return None
    ate = ate_rmse(est_a, gt_a, with_scale=args.eval_scale)
    rpe_t, rpe_r = rpe(est_a, gt_a)
    out = {"ate_rmse_m": round(float(ate), 4),
           "rpe_trans_m": round(float(rpe_t), 4),
           "rpe_rot_deg": round(float(np.degrees(rpe_r)), 4),
           "n_associated": n_assoc,
           "scale_aligned": bool(args.eval_scale)}
    print("eval:", out)
    return out


def save_outputs(system: SLAMSystem, args) -> dict | None:
    """Write the trajectories, evaluate (--eval) and shut the system down.
    -> the evaluation, or None."""
    system.save_trajectory_tum(args.trajectory_out)
    system.save_keyframe_trajectory_tum(args.kf_trajectory_out)
    if args.kitti_trajectory_out:
        system.save_trajectory_kitti(args.kitti_trajectory_out)
    evaluation = evaluate_trajectory(system, args)
    system.shutdown()
    return evaluation
