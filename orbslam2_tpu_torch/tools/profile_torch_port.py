#!/usr/bin/env python3
"""Where one tracked frame of the PyTorch/CUDA port spends its time.

Runs the chip_smoke.py drive (640x480, 2000 features, 8 levels, shuttle /
cluttered) on the GPU twice: synchronously, with mapping inline
(``pipelined_fetch=False``, ``async_mapping=False``), and with SLAMConfig's
defaults (the pipelined fetch with ``fetch_batch=1``, the mapping worker).
Each drive profiles a window of steady-state frames with torch.profiler and
prints: host ms per frame, device-busy ms per frame (sum of the card's
operation times) and its share of the wall clock, the kernels the card ran
per frame and, of them, those inside CUDA graph replays (a fused frame is
one replay of its program's graph, kernels.FrameProgram; the host launched
the rest one by one), the graph launches per frame, the heaviest kernels and
host operators, and the tracker's stage timer (``fused_dev`` is the wait for
a frame's fetch). Inside a graph both pose optimisations of a frame run
their 4 rounds x 10 LM steps.

    python3 orbslam2_tpu_torch/tools/profile_torch_port.py [--frames 20] [--warm 12]

One JSON line at the end carries the numbers of both drives. Needs a GPU; no
CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))  # the repository root


def profile_drive(name, cfg, frames, warm, fps) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from orbslam2_tpu_torch.system import SLAMSystem, Sensor
    from orbslam2_tpu_torch.tools.frame_step_ab import window_counts

    system = SLAMSystem(cfg, Sensor.RGBD)
    tracker = system.tracker
    tracker.stats.enabled = True
    for i in range(warm):
        system.track_rgbd(*frames[i], i / fps)
    tracker.stats.reset()
    torch.cuda.synchronize()
    kf_before = system.map.n_keyframes()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(warm, len(frames)):
            system.track_rgbd(*frames[i], i / fps)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    tracker.flush_frames()
    lost = tracker.trajectory_lost_mask()[warm:]
    if lost.any():
        sys.exit(f"{name}: frames lost in the window: {(lost.nonzero()[0] + warm).tolist()}")
    system.shutdown()

    f = len(frames) - warm
    c = window_counts(prof)
    events = prof.key_averages()
    dev_attr = "self_device_time_total" if hasattr(events[0], "self_device_time_total") \
        else "self_cuda_time_total"
    kernels = [e for e in events if getattr(e, dev_attr) > 0 and e.device_type.name != "CPU"]
    print(f"[{name}] frames {warm}..{len(frames) - 1}: host {host_s / f * 1e3:.2f} ms/frame, "
          f"device busy {c['device_ms'] / f:.3f} ms/frame ({c['device_ms'] / 1e3 / host_s:.1%} "
          f"of the wall clock), {c['kernels'] / f:.0f} kernels/frame on the card, of them "
          f"{c['graph_kernels'] / f:.0f} inside graph replays ({c['graphs'] / f:.2f} graph "
          f"launches/frame) and {c['launches'] / f:.0f} launched one by one, "
          f"{c['describe'] / f:.2f} describe kernels/frame, keyframes inserted in the window "
          f"{system.map.n_keyframes() - kf_before}", flush=True)
    if c["device_ms"] == 0:
        print("the profiler recorded no device time on this machine", flush=True)
    print("[kernels by device time]", flush=True)
    for e in sorted(kernels, key=lambda e: -getattr(e, dev_attr))[:15]:
        print(f"  {getattr(e, dev_attr) / f / 1e3:8.3f} ms/frame {e.count / f:8.1f}/frame  "
              f"{e.key[:90]}", flush=True)
    print("[host operators by self CPU time]", flush=True)
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:15]:
        print(f"  {e.self_cpu_time_total / f / 1e3:8.3f} ms/frame {e.count / f:8.1f}/frame  "
              f"{e.key[:90]}", flush=True)
    print(tracker.stats.report(), flush=True)
    return {"frames": f, "host_ms_per_frame": host_s / f * 1e3,
            "device_busy_ms_per_frame": c["device_ms"] / f,
            "device_busy_share": c["device_ms"] / 1e3 / host_s,
            "device_kernels_per_frame": c["kernels"] / f,
            "graph_kernels_per_frame": c["graph_kernels"] / f,
            "graph_launches_per_frame": c["graphs"] / f,
            "kernel_launches_per_frame": c["launches"] / f,
            "describe_kernels_per_frame": c["describe"] / f,
            "fused_dev_ms": tracker.stats.summary().get("fused_dev", {}),
            "keyframes_in_window": system.map.n_keyframes() - kf_before}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=20, help="profiled frames")
    ap.add_argument("--warm", type=int, default=12, help="frames before the window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[device] {smi} | torch {torch.__version__}", flush=True)

    from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
    from orbslam2_tpu_torch.geometry.camera import PinholeCamera
    from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
    from orbslam2_tpu_torch.ops.orb import ORBConfig

    cam = PinholeCamera(fx=520.0, fy=520.0, cx=320.0, cy=240.0,
                        width=640, height=480, bf=40.0)
    n = args.warm + args.frames
    seq = SyntheticSequence(cam, n_frames=60, trajectory="shuttle", seed=3,
                            world="cluttered")
    frames = [seq.render(i) for i in range(n)]
    common = dict(cam=cam, orb=ORBConfig(n_features=2000, n_levels=8), th_depth=6.0,
                  max_keyframes=64, max_points=16384, local_point_cap=4096)
    out = {"device": smi}
    out["synchronous"] = profile_drive(
        "synchronous", SLAMConfig(**common, max_frames_between_kf=30, min_init_features=400,
                                  async_mapping=False, pipelined_fetch=False),
        frames, args.warm, seq.fps)
    out["defaults"] = profile_drive("defaults", SLAMConfig(**common), frames, args.warm,
                                    seq.fps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
