"""RGB-D AR demo (reference MonoAR: Examples/ROS/ORB_SLAM2/src/AR).

    python -m orbslam2_tpu_torch.examples.ar_demo [--frames 40] [--out ar_frames] \\
        [--device cpu]

Tracks a synthetic sequence, RANSACs a dominant plane through the tracked
map points, and writes PNG frames with a virtual cube anchored to that plane
(the headless equivalent of ViewerAR's insert-cube GL overlay).
"""
from __future__ import annotations

import argparse
import os

from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io import png
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.system import SLAMSystem, Sensor
from orbslam2_tpu_torch.viewer.ar import ARViewer


def main(argv=None):
    """-> (the SLAMSystem, shut down; the ARViewer)."""
    p = argparse.ArgumentParser(description="AR cube on a synthetic RGB-D sequence")
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--out", default="ar_frames")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                        width=320, height=240, bf=26.0)
    cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=800, n_levels=4),
                     th_depth=4.0, min_init_features=300)
    system = SLAMSystem(cfg, Sensor.RGBD, device=args.device)
    ar = ARViewer(system, cube_size=0.3, plane_threshold=0.05)

    os.makedirs(args.out, exist_ok=True)
    seq = SyntheticSequence(cam, n_frames=args.frames, trajectory="lateral", seed=3)
    for i in range(seq.n_frames):
        gray, depth = seq.render(i)
        system.track_rgbd(gray, depth, i / seq.fps)
        png.imwrite(os.path.join(args.out, f"ar_{i:04d}.png"), ar.update(gray))
    print(f"plane={'found' if ar.plane is not None else 'none'} "
          f"inliers={ar.plane.n_inliers if ar.plane else 0} "
          f"frames_written={seq.n_frames} -> {args.out}/")
    system.shutdown()
    return system, ar


if __name__ == "__main__":
    main()
