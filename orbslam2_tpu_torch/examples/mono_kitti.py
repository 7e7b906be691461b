"""Monocular driver for KITTI odometry (reference: Examples/Monocular/mono_kitti.cc).

    python -m orbslam2_tpu_torch.examples.mono_kitti KITTI00-02.yaml \\
        <dataset>/sequences/00 [--eval poses/00.txt --eval-scale] [--device cpu]
"""
from __future__ import annotations

from orbslam2_tpu_torch.examples.common import (build_parser, make_system, make_viewer,
                                                run_loop, save_outputs)
from orbslam2_tpu_torch.io.datasets import kitti_mono_frames
from orbslam2_tpu_torch.system import Sensor


def main(argv=None):
    """-> (the SLAMSystem, shut down; the --eval result or None)."""
    p = build_parser("Monocular SLAM on a KITTI odometry sequence")
    p.add_argument("sequence_dir")
    args = p.parse_args(argv)
    system = make_system(args, Sensor.MONOCULAR, capacity_hint=(2048, 200_000))
    run_loop(system, kitti_mono_frames(args.sequence_dir),
             lambda s, it: s.track_monocular(it.gray, it.timestamp),
             args.max_frames, trace_dir=args.device_trace,
             viewer=make_viewer(system, args))
    return system, save_outputs(system, args)


if __name__ == "__main__":
    main()
