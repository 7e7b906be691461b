"""Live monocular SLAM from a webcam (the reference fork's myslam.cc).

    python -m orbslam2_tpu_torch.examples.live_camera SETTINGS.yaml \\
        [--camera-index 0] [--viewer] [--max-frames N] [--device cpu]

The camera is read through OpenCV's ``cv2.VideoCapture``, imported when the
driver starts (a webcam needs OpenCV; nothing else of the port does). The
camera's index is ``--camera-index``: the JAX driver's ``--device`` names the
index there, and is the port's CUDA-or-CPU choice here.
"""
from __future__ import annotations

import time

from orbslam2_tpu_torch.examples.common import (build_parser, make_system, make_viewer,
                                                save_outputs)
from orbslam2_tpu_torch.io.datasets import _to_gray
from orbslam2_tpu_torch.system import Sensor


def main(argv=None):
    """-> (the SLAMSystem, shut down; the --eval result or None)."""
    import cv2
    p = build_parser("Live monocular SLAM from a webcam")
    p.add_argument("--camera-index", type=int, default=0,
                   help="index of the camera for cv2.VideoCapture")
    args = p.parse_args(argv)
    system = make_system(args, Sensor.MONOCULAR)
    viewer = make_viewer(system, args)
    cap = cv2.VideoCapture(args.camera_index)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open camera {args.camera_index}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            gray = _to_gray(frame, rgb_order=False)      # VideoCapture gives BGR
            system.track_monocular(gray, time.time())
            if viewer is not None:
                viewer.push_frame(gray)
            if args.max_frames and system.tracker.frame_counter >= args.max_frames:
                break
    finally:
        cap.release()
        if viewer is not None:
            viewer.close()
    return system, save_outputs(system, args)


if __name__ == "__main__":
    main()
