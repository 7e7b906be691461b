"""RGB-D driver for TUM sequences (reference: Examples/RGB-D/rgbd_tum.cc).

    python -m orbslam2_tpu_torch.examples.rgbd_tum TUM1.yaml <sequence dir> \\
        <associations.txt> [--eval <sequence dir>/groundtruth.txt] [--device cpu]
"""
from __future__ import annotations

from orbslam2_tpu_torch.examples.common import (build_parser, make_system, make_viewer,
                                                run_loop, save_outputs)
from orbslam2_tpu_torch.io.datasets import tum_rgbd_frames
from orbslam2_tpu_torch.system import Sensor


def main(argv=None):
    """-> (the SLAMSystem, shut down; the --eval result or None)."""
    p = build_parser("RGB-D SLAM on a TUM sequence")
    p.add_argument("dataset_dir")
    p.add_argument("associations")
    args = p.parse_args(argv)
    system = make_system(args, Sensor.RGBD)
    factor = getattr(system.cfg, "depth_map_factor", 5000.0)
    frames = tum_rgbd_frames(args.dataset_dir, args.associations, factor)
    run_loop(system, frames, lambda s, it: s.track_rgbd(it.gray, it.depth, it.timestamp),
             args.max_frames, trace_dir=args.device_trace,
             viewer=make_viewer(system, args))
    return system, save_outputs(system, args)


if __name__ == "__main__":
    main()
