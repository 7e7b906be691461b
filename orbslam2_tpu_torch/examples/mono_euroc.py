"""Monocular driver for EuRoC MAV (reference: Examples/Monocular/mono_euroc.cc).

    python -m orbslam2_tpu_torch.examples.mono_euroc EuRoC.yaml <mav0 dir> \\
        <timestamps.txt> [--device cpu]
"""
from __future__ import annotations

from orbslam2_tpu_torch.examples.common import (build_parser, make_system, make_viewer,
                                                run_loop, save_outputs)
from orbslam2_tpu_torch.io.datasets import euroc_mono_frames
from orbslam2_tpu_torch.system import Sensor


def main(argv=None):
    """-> (the SLAMSystem, shut down; the --eval result or None)."""
    p = build_parser("Monocular SLAM on a EuRoC MAV sequence")
    p.add_argument("data_dir")
    p.add_argument("timestamps")
    args = p.parse_args(argv)
    system = make_system(args, Sensor.MONOCULAR, capacity_hint=(1024, 100_000))
    run_loop(system, euroc_mono_frames(args.data_dir, args.timestamps),
             lambda s, it: s.track_monocular(it.gray, it.timestamp),
             args.max_frames, trace_dir=args.device_trace,
             viewer=make_viewer(system, args))
    return system, save_outputs(system, args)


if __name__ == "__main__":
    main()
