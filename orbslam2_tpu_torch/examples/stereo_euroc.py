"""Stereo driver for EuRoC MAV with online rectification
(reference: Examples/Stereo/stereo_euroc.cc).

    python -m orbslam2_tpu_torch.examples.stereo_euroc EuRoC.yaml <mav0 dir> \\
        <timestamps.txt> [--device cpu]

The settings file carries the rectification (LEFT./RIGHT. K, D, R, P); the
pairs are rectified on the system's device.
"""
from __future__ import annotations

from orbslam2_tpu_torch.examples.common import (build_parser, make_system, make_viewer,
                                                run_loop, save_outputs)
from orbslam2_tpu_torch.io.datasets import EurocRectifier, euroc_stereo_frames
from orbslam2_tpu_torch.system import Sensor


def main(argv=None):
    """-> (the SLAMSystem, shut down; the --eval result or None)."""
    p = build_parser("Stereo SLAM on a EuRoC MAV sequence")
    p.add_argument("data_dir", help=".../mav0 directory")
    p.add_argument("timestamps", help="EuRoC timestamps txt")
    args = p.parse_args(argv)
    system = make_system(args, Sensor.STEREO, capacity_hint=(1024, 100_000))
    rectifier = EurocRectifier(args.settings, device=system.device)
    run_loop(system, euroc_stereo_frames(args.data_dir, args.timestamps, rectifier),
             lambda s, it: s.track_stereo(it.left, it.right, it.timestamp),
             args.max_frames, trace_dir=args.device_trace,
             viewer=make_viewer(system, args))
    return system, save_outputs(system, args)


if __name__ == "__main__":
    main()
