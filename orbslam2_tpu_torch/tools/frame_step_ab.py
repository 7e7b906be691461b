#!/usr/bin/env python3
"""The frame step of one tree of the port on the card: chip_smoke.py's
phases 5, 12 and 14 driven again with per-frame readings.

    python3 orbslam2_tpu_torch/tools/frame_step_ab.py [--root DIR]
        [--stereo-frames 420] [--out FILE]

Drives, with the package found under DIR (default: this checkout):

- ``p5``: phase 5, 60 frames of the 640x480 / 2000-feature / 8-level RGB-D
  shuttle drive through SLAMSystem.track_rgbd with the mapping worker and
  the synchronous fetch, back to back;
- ``p14_k1`` and ``p14_k4``: phase 14, the same frames with SLAMConfig's
  defaults (the pipelined fetch), fetch_batch 1 and 4;
- ``p12``: phase 12, KITTI stereo at bench_kitti_full's geometry and
  capacity (1241x376, 1536 keyframes x 150 000 points), the 10 000-word
  vocabulary, loop consistency 2, circuit2 cut to ``--stereo-frames``,
  paced while a keyframe is queued.

For each drive one JSON line: frames tracked, ATE, median and p95 ms per
frame (host clock around each track call, frames from the 5th on, outside
the profiled window, without pacing waits), the fetch wait (the tracker's
``fused_dev`` stage), and over a window of 10 steady frames under
torch.profiler (``window_counts``): device operations and kernels per frame
(the tracker's and the mapping worker's), kernel launches and CUDA graph
launches the host made per frame, the kernels run inside graph replays,
describe kernels the card ran per frame and the card's busy share (device
time over the window's wall time less pacing waits);
then the peak ``torch.cuda.max_memory_allocated`` of the drive and the
graphs its tracker captured. The card's name and power limit are on every
line.

Run on a ``git archive`` of a parent commit and on this tree in one call, in
turns (parent, change, change, parent), it compares the two on one card;
chip_smoke.py's phase 21 calls ``drive`` on this tree. Needs a GPU.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np

WARM_FRAMES = 5
WINDOW = 10
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241,
                 height=376, bf=386.1448)


def device_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def window_counts(prof) -> dict:
    """Sums over a torch.profiler window: the operations the card ran
    (kernels, copies, fills) and their device ms; of them the kernels; the
    kernels the host launched one by one (``cudaLaunchKernel``), the CUDA
    graphs it launched and, their difference, the kernels the card ran
    inside graph replays; the describe kernels the card ran."""
    ops = kernels = launches = graphs = describe = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CPU":
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                         "cuLaunchKernelEx"):
                launches += e.count
            elif e.key in ("cudaGraphLaunch", "cuGraphLaunch"):
                graphs += e.count
        else:
            ops += e.count
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
            if not e.key.startswith(("Memcpy", "Memset")):
                kernels += e.count
            if "orient_describe_kernel" in e.key:
                describe += e.count
    return dict(ops=ops, kernels=kernels, launches=launches, graphs=graphs,
                graph_kernels=max(kernels - launches, 0), describe=describe,
                device_ms=device_us / 1e3)


def drive(name, system, track, frames, gt_twc, pace=None, window_at=20) -> dict:
    """Track `frames` (tuples of images) through `track`, frames back to back
    or after `pace()`, with frames ``window_at .. window_at + 9`` under
    torch.profiler; then apply the frames in flight, wait for the mapping
    worker and read the drive. `gt_twc`: the true camera-to-world poses."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from orbslam2_tpu_torch.io.evaluate import ate_rmse

    tracker = system.tracker
    tracker.stats.enabled = True
    t_drive = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    prof = None
    win_wall = win_wait = 0.0
    for i, images in enumerate(frames):
        t_wait = time.perf_counter()
        if pace is not None:
            pace()
        wait = time.perf_counter() - t_wait
        if i == window_at:
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t_win = time.perf_counter()
        elif window_at < i < window_at + WINDOW:
            win_wait += wait
        t0 = time.perf_counter()
        track(*images, i / 30.0)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        if i == window_at + WINDOW - 1:
            torch.cuda.synchronize()
            win_wall = time.perf_counter() - t_win
            prof.__exit__(None, None, None)
    tracker.flush_frames()
    if not system.wait_mapping_idle(600):
        raise RuntimeError(f"{name}: the mapping worker did not become idle")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    lost = tracker.trajectory_lost_mask()
    ok = np.flatnonzero(~lost)
    est = tracker.full_trajectory_twc()
    first = int(ok[0]) if len(ok) else len(lost)
    ate = float(ate_rmse(est[first:], gt_twc[first:len(lost)])) if len(ok) else float("nan")
    steady = [ms for i, ms in enumerate(frame_ms) if i >= WARM_FRAMES
              and not window_at <= i < window_at + WINDOW]
    c = window_counts(prof)
    stages = tracker.stats.summary()
    programs = list(getattr(tracker, "frame_programs", {}).values())
    busy_wall = win_wall - win_wait
    system.shutdown()
    return dict(
        name=name, frames=len(frames), tracked=int(len(ok)), first_ok=first,
        lost_after_first=int(lost[first:].sum()), ate_m=ate,
        median_ms=float(np.median(steady)), p95_ms=float(np.percentile(steady, 95)),
        fused_dev_ms=stages.get("fused_dev", {}),
        fused_step_median_ms=stages.get("fused_step", {}).get("median_ms"),
        window=dict(first=window_at, frames=WINDOW, wall_ms_per_frame=busy_wall / WINDOW * 1e3,
                    pacing_wait_s=win_wait,
                    device_ops_per_frame=c["ops"] / WINDOW,
                    device_kernels_per_frame=c["kernels"] / WINDOW,
                    kernel_launches_per_frame=c["launches"] / WINDOW,
                    graph_launches_per_frame=c["graphs"] / WINDOW,
                    graph_kernels_per_frame=c["graph_kernels"] / WINDOW,
                    describe_kernels_per_frame=c["describe"] / WINDOW,
                    device_busy_ms_per_frame=c["device_ms"] / WINDOW,
                    busy_share=c["device_ms"] / 1e3 / busy_wall),
        peak_memory_bytes=int(peak),
        graphs_captured=sum(p.captures for p in programs),
        graph_replays=sum(p.replays for p in programs),
        seconds=time.perf_counter() - t_drive)


def rgbd_drives(frames, seq):
    """Phases 5 and 14 (K = 1, K = 4) on the rendered RGB-D frames, one
    drive after the other as the caller iterates."""
    from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
    from orbslam2_tpu_torch.ops.orb import ORBConfig
    from orbslam2_tpu_torch.system import SLAMSystem, Sensor

    cam = seq.cam
    orb_cfg = ORBConfig(n_features=2000, n_levels=8)
    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    p5 = SLAMConfig(cam=cam, orb=orb_cfg, th_depth=6.0, max_keyframes=64, max_points=16384,
                    local_point_cap=4096, max_frames_between_kf=30, min_init_features=400,
                    pipelined_fetch=False, profile_stages=True)
    defaults = dict(cam=cam, orb=orb_cfg, max_points=16384, local_point_cap=4096,
                    max_keyframes=64, th_depth=6.0)
    for name, cfg in (("p5", p5), ("p14_k1", SLAMConfig(**defaults)),
                      ("p14_k4", SLAMConfig(**defaults, fetch_batch=4))):
        system = SLAMSystem(cfg, Sensor.RGBD)
        yield drive(name, system, system.track_rgbd, frames, gt)


def stereo_drive(frames, seq):
    """Phase 12 on the rendered stereo pairs (as many as given)."""
    from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
    from orbslam2_tpu_torch.ops.orb import ORBConfig
    from orbslam2_tpu_torch.place.pretrained import get_large_vocabulary
    from orbslam2_tpu_torch.system import SLAMSystem, Sensor

    cam = seq.cam
    cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=2000, n_levels=8),
                     th_depth=cam.bf / cam.fx * 40.0, max_keyframes=1536, max_points=150_000,
                     local_point_cap=4096, max_frames_between_kf=10, min_init_features=400,
                     async_mapping=True, pipelined_fetch=False, profile_stages=True)
    system = SLAMSystem(cfg, Sensor.STEREO, vocabulary=get_large_vocabulary())
    system.loop_closer.cfg.consistency_threshold = 2
    worker = system.mapping_worker

    def pace():
        t0 = time.perf_counter()
        while worker.queue_size() >= 1 and time.perf_counter() - t0 < 30:
            time.sleep(0.002)

    gt = np.stack([np.linalg.inv(p) for p in seq.poses])
    return drive("p12", system, system.track_stereo, frames, gt, pace=pace, window_at=60)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the tree whose orbslam2_tpu_torch is driven")
    ap.add_argument("--stereo-frames", type=int, default=420)
    ap.add_argument("--out", help="also append the JSON lines to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    import orbslam2_tpu_torch
    from orbslam2_tpu_torch.geometry.camera import PinholeCamera
    from orbslam2_tpu_torch.io.synthetic import SyntheticSequence

    smi = device_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(orbslam2_tpu_torch.__file__)))
    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0, width=640, height=480, bf=40.0)
    seq = SyntheticSequence(cam, n_frames=60, trajectory="shuttle", seed=3, world="cluttered")
    frames = [seq.render(i) for i in range(60)]
    kitti = PinholeCamera(**KITTI_CAM)
    n = args.stereo_frames
    stereo_seq = SyntheticSequence(kitti, n_frames=420, trajectory="circuit2", seed=9,
                                   world="room")
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        stereo = [(l, r) for l, r, _ in pool.map(stereo_seq.render_stereo, range(n))]

    def emit(d):
        line = json.dumps({"tree": tree, "device": smi, "torch": torch.__version__, **d})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for d in rgbd_drives(frames, seq):
        emit(d)
    emit(stereo_drive(stereo, stereo_seq))


if __name__ == "__main__":
    main()
