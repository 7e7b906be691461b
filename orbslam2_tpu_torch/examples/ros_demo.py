"""ROS-node-style live pipeline (reference: Examples/ROS/ORB_SLAM2).

    python -m orbslam2_tpu_torch.examples.ros_demo [--frames 60] [--device cpu]
    python -m orbslam2_tpu_torch.examples.ros_demo --rospy

With ROS installed, ``--rospy`` binds the node classes to live topics (the
ros_rgbd.cc equivalent). Without it, an in-process topic bus replays a
synthetic RGB-D sequence through the same subscriber architecture:
publisher -> approximate-time sync -> track_rgbd -> pose topic.
"""
from __future__ import annotations

import argparse

from orbslam2_tpu_torch.frontend.tracking import SLAMConfig
from orbslam2_tpu_torch.geometry.camera import PinholeCamera
from orbslam2_tpu_torch.io.ros_nodes import ImageMsg, LocalTopicBus, RGBDNode
from orbslam2_tpu_torch.io.synthetic import SyntheticSequence
from orbslam2_tpu_torch.ops.orb import ORBConfig
from orbslam2_tpu_torch.place.pretrained import get_default_vocabulary
from orbslam2_tpu_torch.system import SLAMSystem, Sensor

POSE_TOPIC = "/orbslam2/pose"


def replay(system, frames, fps: float, on_frame=None):
    """Publish rendered (gray, depth) frames on a LocalTopicBus into an
    RGBDNode, stamped i / fps; ``on_frame(gray)`` runs after each frame is
    tracked. -> (the node, flushed; the PoseMsgs published on the pose
    topic)."""
    bus = LocalTopicBus()
    poses = []
    bus.subscribe(POSE_TOPIC, poses.append)
    node = RGBDNode(system, bus, pose_topic=POSE_TOPIC)
    for i, (gray, depth) in enumerate(frames):
        stamp = i / fps
        bus.publish("/camera/rgb/image_raw", ImageMsg(gray, stamp))
        bus.publish("/camera/depth/image_raw", ImageMsg(depth, stamp))
        if on_frame is not None:
            on_frame(gray)
    node.flush()  # publish the last in-flight frame's solved pose
    return node, poses


def main(argv=None):
    """-> (the SLAMSystem, the node, the published PoseMsgs)."""
    p = argparse.ArgumentParser(description="ROS-style RGB-D node on a synthetic sequence")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--rospy", action="store_true",
                   help="bind to live ROS topics instead of the local bus")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    cam = PinholeCamera(fx=260.0, fy=260.0, cx=160.0, cy=120.0,
                        width=320, height=240, bf=26.0)
    cfg = SLAMConfig(cam=cam, orb=ORBConfig(n_features=800, n_levels=4),
                     th_depth=4.0, min_init_features=300)
    system = SLAMSystem(cfg, Sensor.RGBD, vocabulary=get_default_vocabulary(),
                        device=args.device)

    if args.rospy:
        import rospy
        from orbslam2_tpu_torch.io.ros_nodes import make_rospy_bus
        rospy.init_node("orbslam2_tpu_rgbd")
        node = RGBDNode(system, make_rospy_bus())
        rospy.spin()
        return system, node, []

    seq = SyntheticSequence(cam, n_frames=args.frames, trajectory="lateral", seed=3)
    node, poses = replay(system, (seq.render(i) for i in range(seq.n_frames)), seq.fps)
    print(f"frames={node.frames} tracked={node.tracked} "
          f"poses_published={len(poses)} keyframes={system.map.n_keyframes()}")
    system.shutdown()
    return system, node, poses


if __name__ == "__main__":
    main()
